"""The port's implicit step against hot_tpu and the dense numpy reference,
from states carried across as numpy (fp64, CPU: the plain kernel versions).

  * golden (tests/test_golden.py's invariant): block_drop_2d at res 32,
    Jacobi PCG, one step from hot_tpu's impact state: the same Newton count,
    CG within +-1 (reduction order can move a CG stop across its threshold),
    positions within 1e-10 of both tests/reference_mpm.py and hot_tpu.
  * twisting_bar_3d at 16^3 ppc=2, block-Jacobi PCG, 3 steps: identical
    Newton and CG counts per step, positions within 1e-9 of hot_tpu.
  * one CLI run on the CPU (bgeo frames and a checkpoint by default).
"""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hot_tpu.scenes import build_scene as jbuild
from hot_tpu.sim import Simulation as JSimulation
from hot_tpu.sim.simulation import advance_one_step as j_advance
from hot_tpu_torch import cli
from hot_tpu_torch.io.frames import read_bgeo
from hot_tpu_torch.scenes import build_scene as tbuild
from hot_tpu_torch.sim import Simulation as TSimulation
from hot_tpu_torch.sim.simulation import advance_one_step as t_advance

from reference_mpm import advance_one_step_ref
from test_torch_ref import carry_state, one_torch_thread, t2n  # noqa: F401


def _impact_state(scene, dt):
    """Run hot_tpu until the implicit solve engages; return that state."""
    sim = JSimulation(scene["cfg"], scene["state"], scene["model"], scene["colliders"])
    for _ in range(300):
        if int(sim.step(dt).newton_iters) >= 2:
            return sim.state
    raise AssertionError("impact never engaged the Newton solve")


def test_golden_block_drop_matches_hot_tpu_and_reference():
    res, dt = 32, 4e-3
    scene = jbuild("block_drop_2d", res=res, dtype=jnp.float64)
    cfg = dataclasses.replace(scene["cfg"], solver=dataclasses.replace(
        scene["cfg"].solver, preconditioner="jacobi"))
    scene["cfg"] = cfg
    js = _impact_state(scene, dt)

    step = jax.jit(functools.partial(j_advance, cfg=cfg, model=scene["model"],
                                     colliders=scene["colliders"], plasticity=None))
    j_new, j_stats = step(js, jnp.float64(dt), jnp.float64(0.0))
    ref = advance_one_step_ref(
        np.asarray(js.x), np.asarray(js.v), np.asarray(js.C), np.asarray(js.F),
        np.asarray(js.m), np.asarray(js.V0), np.asarray(js.mu), np.asarray(js.lam),
        dx=cfg.dx, res=cfg.grid_res[:2], dt=dt, gravity=cfg.gravity[:2], floor_y=0.15,
        cn_eps=cfg.solver.cn_eps, cg_tol=cfg.solver.cg_tol,
        max_newton=cfg.solver.max_newton, max_cg=cfg.solver.max_cg)

    tscene = tbuild("block_drop_2d", device="cpu", res=res, dtype=torch.float64)
    t_new, t_stats = t_advance(carry_state(js), dt, 0.0, cfg=cfg, model=tscene["model"],
                               colliders=tscene["colliders"])

    assert t_stats.newton_iters == ref.newton_iters == int(j_stats.newton_iters) >= 2
    assert abs(t_stats.cg_iters - sum(ref.cg_iters)) <= 1
    assert abs(t_stats.cg_iters - int(j_stats.cg_iters)) <= 1
    np.testing.assert_allclose(t2n(t_new.x), ref.x, rtol=0, atol=1e-10)
    np.testing.assert_allclose(t2n(t_new.x), np.asarray(j_new.x), rtol=0, atol=1e-10)
    np.testing.assert_allclose(t2n(t_new.v), ref.v, rtol=0, atol=1e-8)
    np.testing.assert_allclose(t2n(t_new.F), ref.F, rtol=0, atol=1e-8)


def test_twisting_bar_three_steps_match_hot_tpu():
    dt = 2e-3
    scene = jbuild("twisting_bar_3d", res=16, ppc=2, dtype=jnp.float64)
    assert scene["cfg"].solver.preconditioner == "block_jacobi"
    tscene = tbuild("twisting_bar_3d", device="cpu", res=16, ppc=2, dtype=torch.float64)
    jsim = JSimulation(scene["cfg"], scene["state"], scene["model"], scene["colliders"])
    tsim = TSimulation(scene["cfg"], carry_state(scene["state"]), tscene["model"],
                       tscene["colliders"])
    counts = []
    for _ in range(3):
        js, ts = jsim.step(dt), tsim.step(dt)
        counts.append((ts.newton_iters, ts.cg_iters))
        assert (ts.newton_iters, ts.cg_iters) == (int(js.newton_iters), int(js.cg_iters))
        assert ts.converged and bool(js.converged)
        np.testing.assert_allclose(t2n(tsim.state.x), np.asarray(jsim.state.x), rtol=0, atol=1e-9)
    assert sum(c[0] for c in counts) > 0, counts
    np.testing.assert_allclose(tsim.t, jsim.t)


def test_cli_runs_on_cpu(tmp_path):
    out = tmp_path / "run"
    rc = cli.main(["--scene", "block_drop_2d", "--device", "cpu", "--max-steps", "2",
                   "--scene-arg", "res=16", "--frames", "3", "-o", str(out), "--quiet"])
    assert rc == 0
    records = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    steps = [r for r in records if "step" in r]
    # --max-steps stops after the whole frame in which the count reaches 2
    assert [r["step"] for r in steps] == list(range(1, len(steps) + 1)) and len(steps) > 2
    assert abs(steps[-1]["t"] - 1.0 / 24.0) <= 1e-7
    assert json.loads((out / "config.json").read_text())["grid_res"] == [16, 16]
    # frames default to bgeo (2D padded to 3D), a checkpoint after every frame
    x, v = read_bgeo(str(out / "frame_00000.bgeo"))
    assert x.shape[1] == 3 and np.isfinite(x).all() and (x[:, 2] == 0).all()
    np.testing.assert_array_equal(x[:, :2], np.load(out / "ckpt_00000.npz")["x"])
    assert sorted(os.listdir(out)) == ["ckpt_00000.npz", "config.json", "frame_00000.bgeo",
                                       "metrics.jsonl", "timers.txt"]


def test_cli_refuses_missing_gpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(["--scene", "block_drop_2d", "--frames", "1", "-o", str(tmp_path)])
