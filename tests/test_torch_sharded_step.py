"""The port's sharded step (hot_tpu_torch.parallel.sharded_step, sharded_mg)
on gloo ranks against hot_tpu's sharded step and the port's one-grid step,
fp64.

The ranks are spawned once for the file (tests/torch_parallel_worker.py: 4
processes over gloo, file:// rendezvous, one torch thread, no jax); every
case runs there and hands back numpy. hot_tpu runs here on 2 CPU devices,
while the ranks run: each test computes its hot_tpu reference before it
reads the ranks' results. The port's one-grid runs that several cases
compare with are made once per worker.
From tests/test_torch_sparse.py's stressed block_drop_2d (every step
engages Newton, as an impact does):

  * against hot_tpu's make_sharded_step at D = 2: block-Jacobi at 24^2
    (equal counts, x within 1e-9) and 2-level quadrature multigrid,
    assembled, direct coarse solve (Newton equal, CG within 2; x within
    1e-9 of hot_tpu's one-grid step, which hot_tpu's sharded step parts
    from: see the test), 4 steps; one twisting-bar step at 16^3, ppc 2;
  * the migrating step with +0.35 x drift (tests/test_sharded_step.py:246)
    against hot_tpu's ShardedSimulation: x equal in id order, particles
    migrated; sharded checkpoints written by one package and read by the
    other, and the port's restore continuing as the uninterrupted run;
  * the port's sharded step at D = 1, 2 and 4 against its one-grid step
    (exact counts, x within 1e-10): block-Jacobi, the overlapped halo,
    2-level quadrature MG and config 3 (3 levels, Galerkin, direct; D = 1
    and 2, a 32^2 grid's coarsest slab is thinner than its halo at D = 4);
  * the refusals of the settings hot_tpu's sharded step does not read;
  * the CLI with --set mesh.shape="(-1,)" on 4 spawned ranks writes the
    one-grid CLI's frame.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hot_tpu.parallel import sharded_step as jss
from hot_tpu.parallel.mesh import make_mesh
from hot_tpu.sim.state import ParticleState as JState
from hot_tpu_torch.cli import main as tmain
from hot_tpu_torch.parallel import distributed
from hot_tpu_torch.parallel.mesh import Mesh
from hot_tpu_torch.parallel.sharded_step import (ShardedSimulation, check_sharded,
                                                 load_sharded_checkpoint)
from hot_tpu_torch.scenes import build_scene as tbuild
from hot_tpu_torch.scenes import stress_state
from hot_tpu_torch.sim import Simulation as TSimulation
from hot_tpu_torch.sim.state import FIELDS, state_from_numpy, stack_states
from hot_tpu_torch.utils.config import config_from_overrides as t_overrides

import torch_parallel_worker as worker
from test_torch_ref import (carry_state, hot_tpu_scene, one_torch_thread,  # noqa: F401
                            shared, t2n)

DT = 2e-3
STEPS = 4
BJ = {}
QMG = {"solver.preconditioner": "multigrid", "solver.multigrid.levels": 2,
       "solver.multigrid.assembled": True, "solver.multigrid.coarse_solver": "direct",
       "solver.multigrid.coarsening": "quadrature"}
CONFIG3 = {"solver.preconditioner": "multigrid", "solver.multigrid.levels": 3,
           "solver.multigrid.assembled": True, "solver.multigrid.coarse_solver": "direct"}
DRIFT = [0.35, 0.0]
CLI = ["--scene", "block_drop_2d", "--frames", "1", "--quiet", "--device", "cpu", "--f64",
       "--set", "frame_dt=0.008", "--set", "max_dt=0.004", "--scene-arg", "res=24",
       "--frame-format", "npz", "--checkpoint-every", "0"]


def _stressed(name, **kw):
    """hot_tpu's particles of the scene with the port's stress_state
    velocities, as numpy fields."""
    scene = hot_tpu_scene(name, dtype=jnp.float64, **kw)
    ts = carry_state(scene["state"])
    return stress_state(ts, tbuild(name, device="cpu", res=kw.get("res", 16))["cfg"]).to_numpy()


@shared
def _inputs():
    drift = hot_tpu_scene("block_drop_2d", res=32, dtype=jnp.float64)["state"]
    return dict(drop=_stressed("block_drop_2d", res=24), drop32=_stressed("block_drop_2d", res=32),
                bar=_stressed("twisting_bar_3d", res=16, ppc=2),
                drift=carry_state(drift).to_numpy())


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


def _case(world, scene, fields, over=None, steps=STEPS, **kw):
    return ("steps", world, dict(scene=scene, fields=fields, over=over, steps=steps, **kw))


@pytest.fixture(scope="module")
def results(tmp_path_factory, inputs):
    tmp = tmp_path_factory.mktemp("ranks")
    drop, drop32 = inputs["drop"], inputs["drop32"]
    cases = {
        "bj2": _case(2, "block_drop_2d", drop, BJ, kw=dict(res=24)),
        "qmg2": _case(2, "block_drop_2d", drop, QMG, kw=dict(res=24)),
        "bar2": _case(2, "twisting_bar_3d", inputs["bar"], steps=1, dt=1e-3,
                      kw=dict(res=16, ppc=2)),
        "drift2": _case(2, "block_drop_2d", inputs["drift"], steps=STEPS, dt=4e-3, drift=DRIFT,
                        kw=dict(res=32), checkpoint=str(tmp / "port_ckpt")),
        "bj1": _case(1, "block_drop_2d", drop, BJ, kw=dict(res=24)),
        "bj4": _case(4, "block_drop_2d", drop, BJ, kw=dict(res=24)),
        "overlap4": _case(4, "block_drop_2d", drop, {"solver.overlap_halo": True},
                          kw=dict(res=24)),
        "qmg4": _case(4, "block_drop_2d", drop, QMG, kw=dict(res=24)),
        "c3_1": _case(1, "block_drop_2d", drop32, CONFIG3, kw=dict(res=32)),
        "c3_2": _case(2, "block_drop_2d", drop32, CONFIG3, kw=dict(res=32)),
        "cli4": ("cli", 4, dict(argv=CLI + ["-o", str(tmp / "cli4"), "--set",
                                            "mesh.shape=(-1,)"])),
    }
    ranks = worker.start(list(cases.values()), 4, tmp)
    yield RankResults(list(cases), ranks), tmp
    ranks.close()


class RankResults:
    """The ranks' results by case; the first read waits for the ranks."""

    def __init__(self, names, ranks):
        self.names, self.ranks = names, ranks

    def __getitem__(self, name):
        return dict(zip(self.names, self.ranks.join()))[name]


@shared
def _port_single_of(which, over, res):
    """_port_single from the inputs named `which`, once per worker."""
    return _port_single(_inputs()[which], dict(over), res)


def _port_single(fields, over, res, steps=STEPS, dt=DT):
    scene = tbuild("block_drop_2d", device="cpu", dtype=torch.float64, res=res)
    sim = TSimulation(t_overrides(scene["cfg"], over), state_from_numpy(fields, "cpu",
                                                                        torch.float64),
                      scene["model"], scene["colliders"])
    counts = [(s.newton_iters, s.cg_iters) for s in (sim.step(dt) for _ in range(steps))]
    return counts, t2n(sim.state.x)


def _hot_tpu_sharded(name, fields, over, steps, dt, **kw):
    scene = hot_tpu_scene(name, dtype=jnp.float64, **kw)
    cfg = scene["cfg"]
    sol = cfg.solver
    if over:
        mgc = dataclasses.replace(sol.multigrid, levels=2, assembled=True,
                                  coarse_solver="direct", coarsening="quadrature")
        cfg = dataclasses.replace(cfg, solver=dataclasses.replace(
            sol, preconditioner="multigrid", multigrid=mgc))
    state = JState(**{f: jnp.asarray(fields[f]) for f in FIELDS})
    step = jss.make_sharded_step(make_mesh((2,), ("x",)), cfg, scene["model"],
                                 scene["colliders"], n_max=state.n)
    counts, t = [], 0.0
    for _ in range(steps):
        state, st = step(state, jnp.float64(dt), jnp.float64(t))
        counts.append((int(st.newton_iters), int(st.cg_iters)))
        t += dt
    return counts, np.asarray(state.x)


def _hot_tpu_one_grid(fields, steps, dt):
    """hot_tpu's one-grid step under the 2-level quadrature multigrid."""
    from hot_tpu.sim import Simulation as JSimulation

    scene = hot_tpu_scene("block_drop_2d", dtype=jnp.float64, res=24)
    sol = scene["cfg"].solver
    mgc = dataclasses.replace(sol.multigrid, levels=2, assembled=True, coarse_solver="direct",
                              coarsening="quadrature")
    cfg = dataclasses.replace(scene["cfg"], solver=dataclasses.replace(
        sol, preconditioner="multigrid", multigrid=mgc))
    sim = JSimulation(cfg, JState(**{f: jnp.asarray(fields[f]) for f in FIELDS}),
                      scene["model"], scene["colliders"])
    for _ in range(steps):
        sim.step(dt)
    return np.asarray(sim.state.x)


@pytest.mark.parametrize("case,over", [("bj2", BJ), ("qmg2", QMG)])
def test_sharded_step_matches_hot_tpu(results, inputs, case, over):
    """Counts against hot_tpu's sharded step. Under the multigrid, x against
    hot_tpu's one-grid step: hot_tpu's sharded hierarchy marks a coarse node
    constrained from the active fine nodes' embedding weights alone
    (hot_tpu/parallel/sharded_mg.py:250), its one-grid hierarchy from every
    fine node's, so its sharded step parts from its one-grid step (by 8e-6
    in x here); the port's sharded hierarchy takes the one-grid rule."""
    counts, x = _hot_tpu_sharded("block_drop_2d", inputs["drop"], over, STEPS, DT, res=24)
    got = results[0][case]
    assert [c[0] for c in got["counts"]] == [c[0] for c in counts]
    cg_slack = 0 if case == "bj2" else 2
    assert abs(sum(c[1] for c in got["counts"]) - sum(c[1] for c in counts)) <= cg_slack
    assert sum(c[0] for c in counts) >= STEPS
    if case == "qmg2":
        x = _hot_tpu_one_grid(inputs["drop"], STEPS, DT)
    np.testing.assert_allclose(got["state"]["x"], x, rtol=0, atol=1e-9)


def test_twisting_bar_step_matches_hot_tpu(results, inputs):
    counts, x = _hot_tpu_sharded("twisting_bar_3d", inputs["bar"], None, 1, 1e-3, res=16,
                                 ppc=2)
    got = results[0]["bar2"]
    assert got["counts"] == counts and counts[0][0] > 0
    np.testing.assert_allclose(got["state"]["x"], x, rtol=0, atol=1e-9)


def _hot_tpu_migrating(fields):
    scene = hot_tpu_scene("block_drop_2d", res=32, dtype=jnp.float64)
    state = JState(**{f: jnp.asarray(fields[f]) for f in FIELDS})
    state = state.replace(v=state.v + jnp.asarray(DRIFT)[None, :])
    sim = jss.ShardedSimulation(make_mesh((2,), ("x",)), scene["cfg"], state, scene["model"],
                                scene["colliders"])
    for _ in range(STEPS):
        sim.step(4e-3)
    return sim


def test_migrating_step_and_checkpoints_match_hot_tpu(results, inputs, tmp_path):
    sim = _hot_tpu_migrating(inputs["drift"])
    got, tmp = results[0]["drift2"], results[1]
    assert got["migrated"] > 0 and sim.repartitions == 0
    np.testing.assert_allclose(got["state"]["x"], np.asarray(sim.state.x), rtol=0, atol=1e-9)
    # the port's shards, read by hot_tpu; hot_tpu's, read by the port
    blocks, ids, t, step_count = jss.load_sharded_checkpoint(str(tmp / "port_ckpt"), sim.mesh)
    assert (t, step_count) == (got["t"], STEPS)
    back = jss.gather_with_ids(blocks, ids, sim.n)
    np.testing.assert_array_equal(np.asarray(back.x), got["state"]["x"])
    sim.save_checkpoint(str(tmp_path / "jax_ckpt"))
    state, ids, t, _ = load_sharded_checkpoint(str(tmp_path / "jax_ckpt"), device="cpu")
    assert t == pytest.approx(sim.t) and int(ids[-1]) == sim.n - 1
    for f in FIELDS:
        np.testing.assert_array_equal(t2n(getattr(state, f)), np.asarray(getattr(sim.state, f)))
    # the port's restore continues as the uninterrupted run
    np.testing.assert_array_equal(got["resumed"]["x"], got["after"]["x"])


@pytest.mark.parametrize("case,over,res", [
    ("bj1", BJ, 24), ("bj2", BJ, 24), ("bj4", BJ, 24), ("overlap4", BJ, 24),
    ("qmg2", QMG, 24), ("qmg4", QMG, 24), ("c3_1", CONFIG3, 32), ("c3_2", CONFIG3, 32)])
def test_sharded_step_matches_one_grid_step(results, inputs, case, over, res):
    counts, x = _port_single_of("drop" if res == 24 else "drop32", tuple(over.items()), res)
    got = results[0][case]
    assert [tuple(c) for c in got["counts"]] == counts and sum(c[0] for c in counts) >= STEPS
    np.testing.assert_allclose(got["state"]["x"], x, rtol=0, atol=1e-10)
    assert sum(got["ranks_particles"]) == x.shape[0]


@pytest.mark.parametrize("over", [
    {"grid_backend": "sparse"}, {"transfer_kernel": "cubic"},
    {"solver.integrator": "explicit"}, {"solver.nonlinear": "lbfgs"},
    {"solver.linear_solver": "minres"}, {"solver.matrix_free": False},
    {"solver.line_search": True}, {"transfer": "flip"},
    {"solver.preconditioner": "multigrid", "solver.multigrid.smoother": "colored_gs"},
    {"solver.preconditioner": "multigrid", "solver.multigrid.assembled": True,
     "solver.multigrid.assembled_from_level": 1}])
def test_sharded_refusals(over):
    scene = tbuild("block_drop_2d", device="cpu", res=16)
    with pytest.raises(NotImplementedError, match="sharded"):
        ShardedSimulation(Mesh(1, 0), t_overrides(scene["cfg"], over), scene["state"],
                          scene["model"], scene["colliders"])


def test_mesh_refusals(monkeypatch):
    """A batch under a mesh, a one-grid Simulation given a mesh, and more
    local ranks than GPUs (before any step, without switching backend)."""
    scene = tbuild("block_drop_2d", device="cpu", res=16)
    with pytest.raises(NotImplementedError, match="batch"):
        check_sharded(scene["cfg"], batched=True)
    with pytest.raises(NotImplementedError, match="batch"):
        ShardedSimulation(Mesh(1, 0), scene["cfg"], stack_states([scene["state"]] * 2),
                          scene["model"], scene["colliders"])
    cfg = t_overrides(scene["cfg"], {"mesh.shape": (-1,)})
    with pytest.raises(ValueError, match="ShardedSimulation"):
        TSimulation(cfg, scene["state"], scene["model"], scene["colliders"])
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: False)
    with pytest.raises(RuntimeError, match="one rank per GPU"):
        distributed.initialize("cuda")


def test_cli_on_a_mesh_writes_the_one_grid_frame(results, tmp_path):
    got, tmp = results[0]["cli4"], results[1]
    assert got["rc"] == 0
    assert tmain(CLI + ["-o", str(tmp_path / "one")]) == 0
    sharded = np.load(tmp / "cli4" / "frame_00000.npz")
    one = np.load(tmp_path / "one" / "frame_00000.npz")
    np.testing.assert_allclose(sharded["x"], one["x"], rtol=0, atol=1e-10)
    assert len(open(tmp / "cli4" / "metrics.jsonl").readlines()) == len(
        open(tmp_path / "one" / "metrics.jsonl").readlines())
