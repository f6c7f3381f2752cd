"""The port's batched step under HOT's multigrid, on the CPU in fp64 (the
kernels' plain versions), one torch thread; the other solver options are
in tests/test_torch_batch_options.py, which shares this file's set-up.

  * Against hot_tpu's jax.jit(jax.vmap(advance_one_step, in_axes=(0, None,
    None))): block_drop_2d at 32^2 from stress_state (hot_tpu's particles,
    the port's stress_state), E in {1e4, 1e7}, 3 steps at dt 2e-3, hot_tpu's
    static capacities planned as its Simulation plans them, under the
    default matrix-free multigrid, config 3 (assembled Galerkin, Chebyshev,
    direct coarse solve), the composed level (assembled_from_level=1) and
    config 3 on the sparse grid. Per step and member the single path's
    tolerances: equal Newton counts, CG equal (within 2 where the single
    path's compact-hierarchy and composed tests allow 2), x within 1e-9.
  * Against the port's own members stepped alone: the 16^3 twisting bar on
    the sparse grid under config 3 and under the composed level, the
    members on tile sets that differ (one shifted by a tile and 0.3 of a
    cell), exact counts and x within 1e-12.
  * One member's multigrid data (lambda_max per level, coarse factor) does
    not change when a stiffer member joins the batch.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hot_tpu.sim import capacity as jcapacity
from hot_tpu.sim.simulation import advance_one_step as j_advance
from hot_tpu.sim.state import ParticleState as JState
from hot_tpu.utils.config import config_from_overrides as j_overrides
from hot_tpu_torch.grid import sparse
from hot_tpu_torch.scenes import build_scene as tbuild
from hot_tpu_torch.scenes import stress_state
from hot_tpu_torch.sim import objective as obj_mod
from hot_tpu_torch.sim.simulation import advance_one_step as t_advance
from hot_tpu_torch.sim.state import FIELDS, stack_states
from hot_tpu_torch.solver import multigrid as mg
from hot_tpu_torch.utils.config import config_from_overrides as t_overrides

from test_torch_batch import _batch_against_singles, _with_E
from test_torch_ref import carry_state, hot_tpu_scene, one_torch_thread, t2n  # noqa: F401

CONFIG3 = {"solver.preconditioner": "multigrid", "solver.multigrid.levels": 3,
           "solver.multigrid.assembled": True, "solver.multigrid.coarse_solver": "direct"}
COMPOSED = dict(CONFIG3, **{"solver.multigrid.assembled_from_level": 1})
SPARSE = {"grid_backend": "sparse", "tile_capacity": 64}
VMAP_E = (1e4, 1e7)
# case: (overrides, hot_tpu's extra overrides, CG difference allowed, E)
VMAP_CASES = {
    "mf_multigrid": ({"solver.preconditioner": "multigrid"}, {}, 0, VMAP_E),
    "config3": (CONFIG3, {}, 0, VMAP_E),
    "composed": (COMPOSED, {"transfer_impl": "binned"}, 2, VMAP_E),
    "sparse_config3": (dict(SPARSE, **CONFIG3), {"transfer_impl": "binned"}, 2, VMAP_E),
    "sparse_block_jacobi": (SPARSE, {}, 0, VMAP_E),
    "explicit_bsr": ({"solver.matrix_free": False}, {}, 0, VMAP_E),
    "lbfgs": ({"solver.nonlinear": "lbfgs"}, {}, 0, VMAP_E),
    # unpreconditioned, the stiff member takes hundreds of iterations a
    # solve and runs into the Newton cap, which amplifies the two packages'
    # rounding past 1e-9 (x apart by 2.3e-9 at E 1e7): E up to 1e5
    "minres": ({"solver.linear_solver": "minres", "solver.preconditioner": "none"}, {}, 0,
               (1e4, 1e5)),
}
MG_CASES = ("mf_multigrid", "config3", "composed", "sparse_config3")
# at 24^2 one state alone already parts from hot_tpu on the sparse grid
# under config 3 (x by 2.2e-5 at E 1e7 with equal counts; ROADMAP queue C);
# at 32^2, where tests/test_torch_sparse.py runs its compact hierarchies,
# every case here agrees to 1e-16
VMAP_RES = 32
STEPS, DT = 3, 2e-3
X_TOL = 1e-9


def _drop_members(overrides, Es=VMAP_E, res=24):
    """hot_tpu's res^2 block drop carried into the port, the port's config
    and stress_state, one member per E."""
    scene = hot_tpu_scene("block_drop_2d", res=res, dtype=jnp.float64)
    tscene = tbuild("block_drop_2d", device="cpu", res=res, dtype=torch.float64)
    cfg = t_overrides(tscene["cfg"], overrides)
    base = stress_state(carry_state(scene["state"]), cfg)
    return scene, tscene, cfg, [_with_E(base, E) for E in Es]


def check_against_hot_tpu_vmap(case):
    """The case's batch stepped beside hot_tpu's jit(vmap(advance_one_step))
    (see the module doc)."""
    overrides, j_extra, cg_diff, Es = VMAP_CASES[case]
    scene, tscene, cfg, members = _drop_members(overrides, Es, res=VMAP_RES)
    tstate = stack_states(members)
    jstate = JState(**{f: jnp.asarray(t2n(getattr(tstate, f))) for f in FIELDS})
    jcfg = j_overrides(scene["cfg"], dict(overrides, **j_extra))
    # hot_tpu's static tables sized as its Simulation sizes them, over every
    # member's particles, with headroom (capacities only pad)
    plan = jcapacity.plan_capacities(jcfg, t2n(tstate.x).reshape(-1, cfg.dim), grow=2.0)
    vstep = jax.jit(jax.vmap(functools.partial(
        j_advance, cfg=jcfg, model=scene["model"], colliders=scene["colliders"],
        plasticity=None, **{f.name: getattr(plan, f.name) for f in dataclasses.fields(plan)}),
        in_axes=(0, None, None)))
    newton_total = [0] * len(members)
    for k in range(STEPS):
        jstate, js = vstep(jstate, jnp.float64(DT), jnp.float64(k * DT))
        assert not np.asarray(js.grid_overflow).any()
        tstate, ts = t_advance(tstate, DT, k * DT, cfg=cfg, model=tscene["model"],
                               colliders=tscene["colliders"])
        want = [np.asarray(a).tolist() for a in (js.newton_iters, js.cg_iters, js.converged)]
        assert ts.newton_iters == want[0], (k, ts, want)
        assert all(abs(a - b) <= cg_diff for a, b in zip(ts.cg_iters, want[1])), (k, ts, want)
        assert ts.converged == want[2], (k, ts, want)
        if cfg.grid_backend == "sparse":
            assert ts.active_tiles == np.asarray(js.active_tiles).tolist()
        np.testing.assert_allclose(t2n(tstate.x), np.asarray(jstate.x), rtol=0, atol=X_TOL)
        newton_total = [a + b for a, b in zip(newton_total, ts.newton_iters)]
    assert min(newton_total) > 0, newton_total


@pytest.mark.parametrize("case", MG_CASES)
def test_batch_matches_hot_tpu_vmap(case):
    check_against_hot_tpu_vmap(case)


def _shifted(state, cells, dx):
    """The state moved by `cells` cells along y (another tile set)."""
    shift = torch.zeros(state.dim, dtype=state.x.dtype)
    shift[1] = cells * dx
    return state.replace(x=state.x + shift)


@pytest.mark.parametrize("case", ["sparse_config3", "sparse_composed"])
def test_bar_sparse_multigrid_batch_matches_singles(case):
    """The 16^3 bar on the sparse grid, two stiffnesses on tile sets that
    differ, 2 steps from stress_state: exact counts, x and F within 1e-12."""
    scene = tbuild("twisting_bar_3d", device="cpu", res=16, ppc=2, dtype=torch.float64)
    over = dict(SPARSE, **(CONFIG3 if case == "sparse_config3" else COMPOSED))
    cfg = t_overrides(scene["cfg"], over)
    base = stress_state(scene["state"], cfg)
    members = [_with_E(base, 1e6), _shifted(_with_E(base, 4e6), sparse.TILE + 0.3, cfg.dx)]
    tiles = sparse.build_tile_grid(torch.stack([m.x for m in members]), cfg.dx,
                                   tuple(cfg.grid_res), cfg.tile_capacity)
    assert not torch.equal(tiles.tile_ids[0], tiles.tile_ids[1])
    stats = _batch_against_singles(scene, members, 2, 2e-3, cfg)
    assert sum(sum(s.newton_iters) for s in stats) > 0


def _mg_data(members, cfg, scene):
    """The multigrid data of the first Newton iterate of a batch of
    `members`: (MGStatic, MGPrecond), through the step's own objective."""
    from hot_tpu_torch.ops import transfer
    from hot_tpu_torch.sim import collision

    state = stack_states(members)
    dim, res, dx = cfg.dim, tuple(cfg.grid_res[:cfg.dim]), cfg.dx
    st = transfer.particle_stencil(state.x, dx, res)
    grid_m, grid_mv = transfer.p2g_mass_momentum(st, state.v, state.C, state.m,
                                                 transfer.n_nodes_of(res))
    v = grid_mv / torch.clamp(grid_m, min=1e-30)[..., None]
    proj, _, constrained = collision.grid_boundary_conditions(
        transfer.node_positions(res, dx, torch.float64), 0.0, scene["colliders"], grid_v=v,
        boundary_margin=2, res=res, dx=dx)
    obj = obj_mod.make_objective(scene["model"], st, state.F, state.V0, state.mu, state.lam,
                                 grid_m, v, proj.expand(v.shape + (dim,)).contiguous(), DT, dx,
                                 state.x, res)
    _, hess = obj_mod.linearize(scene["model"], obj, v)
    mgc = cfg.solver.multigrid
    static = mg.build_static(state.x, state.m, res, dx, mgc.levels, constrained, torch.float64,
                             assembled_from=mgc.assembled_from_level)
    return mg.build_precond(static, state.F, hess, state.V0, DT, mgc, dim)


def test_member_hierarchy_does_not_change_when_a_stiffer_member_joins():
    """Config 3 on the 24^2 block drop: member 0's lambda_max on every
    smoothed level and its coarse Cholesky factor are the same alone and
    beside a member 1000 times stiffer (1e-12 relative), and the stiffer
    member's own differ (so neither is shared)."""
    scene = tbuild("block_drop_2d", device="cpu", res=24, dtype=torch.float64)
    cfg = t_overrides(scene["cfg"], CONFIG3)
    base = stress_state(scene["state"], cfg)
    soft, stiff = _with_E(base, 1e4), _with_E(base, 1e7)
    alone = _mg_data([soft], cfg, scene)
    pair = _mg_data([soft, stiff], cfg, scene)
    for l in range(len(alone.lmax) - 1):
        a, p = float(alone.lmax[l][0]), pair.lmax[l].tolist()
        assert abs(p[0] - a) <= 1e-12 * a, (l, a, p)
        assert abs(p[1] - p[0]) > 1e-6 * a, (l, p)
    La, Lp = alone.coarse_chol[0][0], pair.coarse_chol[0]
    n = La.shape[-1]
    assert float((Lp[0, :n, :n] - La).abs().max()) <= 1e-12 * float(La.abs().max())
    assert float((Lp[1, :n, :n] - Lp[0, :n, :n]).abs().max()) > 1e-6 * float(La.abs().max())
