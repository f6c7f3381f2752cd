"""The comparison that decides `correct`, on the CPU at 16^3: the reference
agrees with the port's CPU path in float64 and in float32; the TF32 control
fails it; and a run with the timed path broken underneath comes out not
correct, for each fault a one-chip cell of one member can have."""

import pytest
import torch

from portbench import cells
from portbench import control as control_script
from portbench.reference import control, judge, mpm
from portbench.tests.small import run_small, small_cell

CELLS = [w["name"] for w in cells.load_benchmark()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_port_in_fp64(cell):
    out = run_small(cell)
    checks = out["checks"]
    assert out["correct"], checks
    assert checks["p2g"]["value"] <= 1e-12
    assert checks["g2p"]["value"] <= 1e-12
    assert 0.0 < checks["cn"]["value"] <= 1e-2
    assert checks["missing"]["value"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_port_in_fp32(cell):
    out = run_small(cell, dtype="float32", seed=12)
    assert out["correct"], out["checks"]
    assert out["checks"]["g2p"]["value"] <= 1e-5


def _control(arith, res=16):
    r = small_cell("bar128-bj.twist", res=res, dtype="float32")
    return control_script.readings(r["config"], r["traffic"], 13, torch.device("cpu"), arith)


def test_control_in_tf32_fails_and_in_fp32_passes():
    limits = cells.load_config("bar128-bj")["check"]
    tf32 = _control("tf32")["numbers"]
    fp32 = _control("fp32")["numbers"]
    assert judge.verdict(fp32, limits)["correct"], fp32
    assert not judge.verdict(tf32, limits)["correct"], tf32
    assert tf32["g2p"] > 30 * fp32["g2p"] and tf32["p2g"] > 30 * fp32["p2g"]


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, -1.0 - 2.0 ** -12, 3.0e-3])
    got = mpm.tf32_round(x)
    assert got[0] == 1.0 and got[1] == 1.0          # a tie rounds to even
    assert got[2] == 1.0 + 2 * 2.0 ** -10           # the other tie, up to even
    assert got[3] == -1.0
    assert abs(float(got[4]) - 3.0e-3) <= 3.0e-3 * 2.0 ** -11


def test_rotation_is_the_polar_factor():
    g = torch.Generator().manual_seed(0)
    F = torch.eye(3, dtype=torch.float64) + 0.2 * torch.randn(64, 3, 3, generator=g,
                                                              dtype=torch.float64)
    R = mpm.rotation(F)
    eye = torch.eye(3, dtype=torch.float64)
    assert torch.allclose(R.transpose(1, 2) @ R, eye.expand_as(R), atol=1e-12)
    S = R.transpose(1, 2) @ F
    assert torch.allclose(S, S.transpose(1, 2), atol=1e-12)


def _break(monkeypatch, fault):
    from hot_tpu_torch.sim import simulation as sim_mod

    if fault == "state_unchanged":
        orig = sim_mod.advance_one_step

        def advance_one_step(state, *a, **kw):
            return state, orig(state, *a, **kw)[1]

        monkeypatch.setattr(sim_mod, "advance_one_step", advance_one_step)
    elif fault == "solve_answer_altered":
        orig = sim_mod._newton_update

        def _newton_update(model, objective, cfg, *a):
            res = orig(model, objective, cfg, *a)
            shift = 0.1 * cfg.dx / objective.dt
            return res._replace(v=res.v + shift * objective.active[..., None])

        monkeypatch.setattr(sim_mod, "_newton_update", _newton_update)
    elif fault == "particle_answer_altered":
        orig = sim_mod.update_particles

        def update_particles(*a):
            out = orig(*a)
            x = out.x.clone()
            x[0, 0] += 0.5 * a[5].dx
            return out.replace(x=x)

        monkeypatch.setattr(sim_mod, "update_particles", update_particles)


@pytest.mark.parametrize("fault,caught_by", [("state_unchanged", "p2g"),
                                             ("solve_answer_altered", "cn"),
                                             ("particle_answer_altered", "g2p")])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault, caught_by):
    _break(monkeypatch, fault)
    out = run_small("bar128-bj.twist", dtype="float32", seed=14)
    assert not out["correct"], out["checks"]
    check = out["checks"][caught_by]
    assert check["value"] > check["limit"], out["checks"]


def test_control_step_matches_its_own_judge_in_fp64():
    r = small_cell("bar128-bj.twist")
    state, material = control_script.inputs(r["config"], 15, torch.device("cpu"))
    sc = mpm.scene_from(r["config"]["scene"], material, "cpu", torch.float64)
    rec, stats = control.control_step(sc, state, 2e-3, {"max_newton": 10, "cn_eps": 1e-2,
                                                        "cg_tol": 1e-3, "max_cg": 200},
                                      mpm.Arith(torch.float64))
    p2g, cn, g2p = judge.judge_step(sc, state, rec, "cpu")
    assert p2g == 0.0 and g2p == 0.0
    assert abs(cn - stats["cn"]) <= 1e-9 * max(cn, 1e-30)
