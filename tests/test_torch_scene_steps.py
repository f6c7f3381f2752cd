"""Plastic scenes stepped by the port and by hot_tpu from one state (fp64,
CPU), and the port's finite-difference check of the objective.

  * sand_column_2d at 32^2 (Drucker-Prager, a slip floor with friction 0.4)
    and snowball_drop_2d at 32^2 (snow, Jp): 3 steps at dt 2e-3 from
    hot_tpu's state after stress_state (twice the default magnitude for the
    snow ball), each with the same Newton and CG counts, and x, F and Jp
    within 1e-9 (the solves stop on tolerances far above fp64 rounding, so
    the counts agree exactly); the return map must change F for some
    particles in every step. The von Mises bar is stepped in
    tests/test_torch_solver.py, with line search and without SPD
    projection.
  * run_difftest on block_drop_2d at 24^2: the orders of the energy ->
    residual and residual -> Hessian differences approach 2, as
    tests/test_baselines.py checks hot_tpu's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hot_tpu.scenes import stress_state as j_stress
from hot_tpu.sim import Simulation as JSimulation
from hot_tpu.utils.config import config_from_overrides as j_over
from hot_tpu_torch.ops import transfer
from hot_tpu_torch.scenes import build_scene as tbuild
from hot_tpu_torch.sim import Simulation as TSimulation
from hot_tpu_torch.sim import objective as obj_mod
from hot_tpu_torch.sim import simulation as tsim_mod
from hot_tpu_torch.sim.difftest import run_difftest
from hot_tpu_torch.utils.config import config_from_overrides as t_over

from test_torch_ref import carry_state, hot_tpu_scene, one_torch_thread, t2n  # noqa: F401

DT = 2e-3


class PlasticShare:
    """The share of particles whose F the port's return map changed (by
    more than 1e-12 relative), per step."""

    def __init__(self, monkeypatch):
        self.shares = []
        orig = tsim_mod.return_map

        def recorded(plasticity, F, state):
            F_new, Jp = orig(plasticity, F, state)
            changed = (F_new - F).abs().amax((1, 2)) > 1e-12 * F.abs().amax((1, 2))
            self.shares.append(float(changed.double().mean()))
            return F_new, Jp

        monkeypatch.setattr(tsim_mod, "return_map", recorded)


def step_pair(name, steps, monkeypatch, scene_kw, overrides=None, mag=8.0, dt=DT):
    """Step hot_tpu and the port from hot_tpu's stress_state; check counts
    and x, F, Jp after every step. Returns the per-step (newton, cg) and the
    plastic shares."""
    js = hot_tpu_scene(name, dtype=jnp.float64, **scene_kw)
    ts = tbuild(name, device="cpu", dtype=torch.float64, **scene_kw)
    start = j_stress(js["state"], js["cfg"], mag)
    overrides = overrides or {}
    jsim = JSimulation(j_over(js["cfg"], overrides), start, js["model"], js["colliders"],
                       plasticity=js["plasticity"])
    tsim = TSimulation(t_over(ts["cfg"], overrides), carry_state(start), ts["model"],
                       ts["colliders"], plasticity=ts["plasticity"])
    share = PlasticShare(monkeypatch)
    counts = []
    for _ in range(steps):
        j, t = jsim.step(dt), tsim.step(dt)
        counts.append((t.newton_iters, t.cg_iters))
        assert counts[-1] == (int(j.newton_iters), int(j.cg_iters))
        assert t.converged and bool(j.converged)
        for f in ("x", "F", "Jp"):
            np.testing.assert_allclose(t2n(getattr(tsim.state, f)),
                                       np.asarray(getattr(jsim.state, f)), rtol=0, atol=1e-9)
    assert tsim.retry_count == jsim.retry_count == 0
    assert sum(c[0] for c in counts) > 0, counts
    assert len(share.shares) == steps and min(share.shares) > 0, share.shares
    return counts, share.shares, tsim


# stress_state's magnitude: 8 compresses the snow ball only to sigma ~ 0.981
# in 3 steps, short of snow's critical compression 1 - 2.5e-2; 16 crosses it
@pytest.mark.parametrize("name,mag", [("sand_column_2d", 8.0), ("snowball_drop_2d", 16.0)])
def test_plastic_2d_scene_matches_hot_tpu(name, mag, monkeypatch):
    _, _, tsim = step_pair(name, 3, monkeypatch, dict(res=32), mag=mag)
    if name == "snowball_drop_2d":
        assert float((tsim.state.Jp - 1.0).abs().max()) > 1e-6


def test_difftest_orders():
    scene = tbuild("block_drop_2d", device="cpu", res=24, E=1e5, dtype=torch.float64)
    cfg, state = scene["cfg"], scene["state"]
    rng = np.random.default_rng(5)
    state = state.replace(F=state.F + 0.05 * torch.from_numpy(rng.standard_normal(state.F.shape)))
    res, dx, dt = tuple(cfg.grid_res[:2]), cfg.dx, 3e-3
    n_nodes = transfer.n_nodes_of(res)
    st = transfer.particle_stencil(state.x, dx, res)
    gm, gmv = transfer.p2g_mass_momentum(st, state.v, state.C, state.m, n_nodes)
    vg = gmv * torch.where(gm > 0, 1.0 / torch.clamp(gm, min=1e-30), 0.0)[:, None]
    proj = torch.eye(2, dtype=torch.float64).expand(n_nodes, 2, 2)
    obj = obj_mod.make_objective(scene["model"], st, state.F, state.V0, state.mu, state.lam,
                                 gm, vg, proj, dt, dx, state.x, res)
    out = run_difftest(scene["model"], obj, vg, verbose=False)
    og = [o for o in out["order_grad"][:4] if np.isfinite(o)]
    oh = [o for o in out["order_hess"][:4] if np.isfinite(o)]
    assert np.mean(og) > 1.7, out["order_grad"]
    assert np.mean(oh) > 1.7, out["order_hess"]
