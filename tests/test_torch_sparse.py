"""The sparse tile grid of hot_tpu_torch (grid/sparse.py, the sparse branch
of the step, compact multigrid levels) against hot_tpu's, in fp64.

  * activation takes every tile of every particle's stencil; with hot_tpu
    given capacity = the port's active tiles, the lookup, compact ids, node
    positions and compact_to_dense are bitwise equal; sparse P2G equals
    dense P2G; more active tiles than the capacity raise;
  * both particle kernels' plain versions on the tile grid (compact ids)
    equal hot_tpu's XLA chain through its sparse_stencil (1e-10);
  * whole steps on the sparse grid against hot_tpu's sparse steps from one
    stressed state: block_drop_2d at 32^2 under mass Jacobi and 2-level
    multigrid (15 steps), the 16^3 twisting bar under block-Jacobi (3
    steps): x within 1e-9, equal Newton counts, equal CG counts;
  * the compact hierarchies of tests/test_sparse_grid.py's assembled
    Galerkin case (compact level 0 and a dense tail, all levels compact,
    and a matrix-free compact finest level under the composed Galerkin
    level 1) against hot_tpu's own run of each: equal Newton counts, CG
    within 2, x within 1e-9, over 2 steps (hot_tpu's test runs 70).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hot_tpu.grid import sparse as jsp
from hot_tpu.models import constitutive as jcm
from hot_tpu.ops import transfer as jtr
from hot_tpu.sim import capacity as jcapacity
from hot_tpu.sim import Simulation as JSimulation
from hot_tpu.sim import objective as jobj
from hot_tpu.sim.state import ParticleState as JState
from hot_tpu.utils.config import config_from_overrides as j_overrides
from hot_tpu_torch.grid import sparse as tsp
from hot_tpu_torch.models import constitutive as tcm
from hot_tpu_torch.ops import transfer as ttr
from hot_tpu_torch.scenes import build_scene as tbuild
from hot_tpu_torch.scenes import stress_state
from hot_tpu_torch.sim import Simulation as TSimulation
from hot_tpu_torch.sim import objective as tobj
from hot_tpu_torch.sim.state import FIELDS
from hot_tpu_torch.utils.config import config_from_overrides as t_overrides

from test_torch_ref import (DT, SMALL, assert_close, carry_state, hot_tpu_scene,  # noqa: F401
                            one_torch_thread, t2n)

TOL = 1e-10
X_TOL = 1e-9
SCENES = {2: "block_drop_2d", 3: "twisting_bar_3d"}


def _cloud(rng, d):
    res_n = 48 if d == 2 else 16
    dx = 1.0 / res_n
    x = rng.uniform(3 * dx, (res_n - 4) * dx, (300, d))
    return x, dx, (res_n,) * d


def _grids(x, dx, res):
    tg = tsp.build_tile_grid(torch.from_numpy(np.array(x)), dx, res, capacity=10 ** 6)
    jg = jax.jit(functools.partial(jsp.build_tile_grid, dx=dx, res=res,
                                   capacity=tg.n_active))(jnp.asarray(x))
    assert not bool(jg.overflow)
    return tg, jg


@pytest.mark.parametrize("d", [2, 3])
def test_activation_covers_every_stencil_tile(rng, d):
    x, dx, res = _cloud(rng, d)
    tg = tsp.build_tile_grid(torch.from_numpy(x), dx, res, capacity=10 ** 6)
    st = tsp.sparse_stencil(torch.from_numpy(x), dx, tg)
    assert int(st.node_ids.max()) < tg.dump and tg.n_active <= tg.n_tiles_logical
    assert tg.lookup.dtype == torch.int32 and tg.lookup.shape == (tg.n_tiles_logical,)


@pytest.mark.parametrize("d", [2, 3])
def test_tile_grid_matches_hot_tpu(rng, d):
    """Slots, compact ids, node positions and compact_to_dense are hot_tpu's
    bit for bit when hot_tpu's capacity is the port's active tile count."""
    x, dx, res = _cloud(rng, d)
    tg, jg = _grids(x, dx, res)
    np.testing.assert_array_equal(t2n(tg.lookup), np.asarray(jg.lookup))
    np.testing.assert_array_equal(t2n(tg.tile_ids), np.asarray(jg.tile_ids))
    v = rng.standard_normal((tg.n_cnodes, d))
    coords = rng.integers(0, res[0], (500, d))

    @jax.jit
    def reference(x, v, coords):
        st = jsp.sparse_stencil(x, dx, jg)
        return (st, jsp.node_positions(jg, dx, jnp.float64), jsp.compact_to_dense(jg, v),
                jsp.compact_node_id(jg, coords))

    jst, jpos, jdense, jids = reference(jnp.asarray(x), jnp.asarray(v), jnp.asarray(coords))
    tst = tsp.sparse_stencil(torch.from_numpy(x), dx, tg)
    np.testing.assert_array_equal(t2n(tst.node_ids), np.asarray(jst.node_ids))
    for field in ("wn", "gwn", "rel"):     # jit reassociates the weights' products
        assert_close(getattr(tst, field), getattr(jst, field), 1e-12)
    np.testing.assert_array_equal(t2n(tsp.node_positions(tg, dx, torch.float64)),
                                  np.asarray(jpos))
    np.testing.assert_array_equal(t2n(tsp.compact_to_dense(tg, torch.from_numpy(v))),
                                  np.asarray(jdense))
    np.testing.assert_array_equal(t2n(tsp.compact_node_id(tg, torch.from_numpy(coords))),
                                  np.asarray(jids))


@pytest.mark.parametrize("d", [2, 3])
def test_sparse_p2g_equals_dense(rng, d):
    x, dx, res = _cloud(rng, d)
    n = x.shape[0]
    xt = torch.from_numpy(x)
    v, C = torch.as_tensor(rng.standard_normal((n, d))), torch.as_tensor(
        rng.standard_normal((n, d, d)))
    m = torch.as_tensor(rng.uniform(0.5, 2.0, n))
    gm, gmv = ttr.p2g_mass_momentum(ttr.particle_stencil(xt, dx, res), v, C, m,
                                    ttr.n_nodes_of(res))
    tg = tsp.build_tile_grid(xt, dx, res, capacity=10 ** 6)
    sm, smv = ttr.p2g_mass_momentum(tsp.sparse_stencil(xt, dx, tg), v, C, m, tg.n_cnodes)
    assert float(sm[tg.dump]) == 0.0
    assert_close(tsp.compact_to_dense(tg, sm), gm, 1e-12)
    assert_close(tsp.compact_to_dense(tg, smv), gmv, 1e-12)


def test_tile_capacity_exceeded_raises(rng):
    x, dx, res = _cloud(rng, 2)
    with pytest.raises(RuntimeError, match="sparse tile capacity exceeded"):
        tsp.build_tile_grid(torch.from_numpy(x), dx, res, capacity=4)
    scene = tbuild("block_drop_2d", device="cpu", res=32)
    cfg = t_overrides(scene["cfg"], {"grid_backend": "sparse", "tile_capacity": 4})
    sim = TSimulation(cfg, scene["state"], scene["model"], scene["colliders"])
    with pytest.raises(RuntimeError, match="raise cfg.tile_capacity"):
        sim.step(DT)


@pytest.mark.parametrize("d", [2, 3])
def test_plain_kernels_on_tile_grid_match_hot_tpu(rng, d):
    """The objective on compact ids (the linearize and apply's plain
    versions with the tile grid) against hot_tpu's XLA chain through its
    sparse_stencil."""
    js = hot_tpu_scene(SCENES[d], dtype=jnp.float64, **SMALL[SCENES[d]])["state"]
    cfg = hot_tpu_scene(SCENES[d], dtype=jnp.float64, **SMALL[SCENES[d]])["cfg"]
    res, dx = tuple(cfg.grid_res[:d]), cfg.dx
    F = np.asarray(js.F) + 0.1 * rng.standard_normal(js.F.shape)
    ts = carry_state(js.replace(F=jnp.asarray(F)))
    tg, jg = _grids(np.asarray(js.x), dx, res)
    n_c = tg.n_cnodes
    v_star = 0.3 * rng.standard_normal((n_c, d))
    v = v_star + 0.3 * rng.standard_normal((n_c, d))
    w = rng.standard_normal(v.shape)
    proj = np.broadcast_to(np.eye(d), (n_c, d, d))
    model = "fixed_corotated"
    jmodel = jcm.MODEL_REGISTRY[model]

    @jax.jit
    def reference(v, w):
        jst = jsp.sparse_stencil(js.x, dx, jg)
        jgm, _ = jtr.p2g_mass_momentum(jst, js.v, js.C, js.m, n_c)
        jo = jobj.make_objective(jmodel, jst, jnp.asarray(F), js.V0, js.mu, js.lam, jgm,
                                 jnp.asarray(v_star), jnp.asarray(proj), DT, dx)
        jr, jh = jobj.linearize(jmodel, jo, v)
        return jr, jh.ctx, jobj.multiply(jo, jh, w)

    jr, jctx, jHw = reference(jnp.asarray(v), jnp.asarray(w))
    tst = tsp.sparse_stencil(ts.x, dx, tg)
    tgm, _ = ttr.p2g_mass_momentum(tst, ts.v, ts.C, ts.m, n_c)
    to = tobj.make_objective(tcm.MODEL_REGISTRY[model], tst, ts.F, ts.V0, ts.mu, ts.lam, tgm,
                             torch.from_numpy(v_star), torch.from_numpy(proj.copy()), DT, dx,
                             ts.x, res, tgrid=tg)
    tr, th = tobj.linearize(tcm.MODEL_REGISTRY[model], to, torch.from_numpy(v))
    assert_close(tr, jr, TOL)
    ctx = th.context(d)
    for field in ("A", "b_plus", "b_minus"):
        assert_close(getattr(ctx, field), getattr(jctx, field), TOL)
    assert_close(tobj.multiply(to, th, torch.from_numpy(w)), jHw, TOL)


def sparse_pair(name, overrides, j_extra=None, **kw):
    """hot_tpu and port Simulations from one stressed fp64 state (the port's
    stress_state of hot_tpu's particles) under the same overrides (hot_tpu
    also under j_extra). hot_tpu plans its static capacities with headroom
    (grow 2), so its step compiles once instead of again after a regrow;
    capacities only pad."""
    scene = hot_tpu_scene(name, dtype=jnp.float64, **kw)
    tscene = tbuild(name, device="cpu", dtype=torch.float64, **kw)
    ts = stress_state(carry_state(scene["state"]), tscene["cfg"])
    js = JState(**{f: jnp.asarray(t2n(getattr(ts, f))) for f in FIELDS})
    jsim = JSimulation(j_overrides(scene["cfg"], dict(overrides, **(j_extra or {}))), js,
                       scene["model"], scene["colliders"])
    tsim = TSimulation(t_overrides(tscene["cfg"], overrides), ts, tscene["model"],
                       tscene["colliders"])
    return jsim, tsim


def run_pair(jsim, tsim, steps, dt, cg_diff=0, tiles=True):
    """Steps both: equal Newton counts, CG within cg_diff, equal active
    tiles (with `tiles`), x within X_TOL; returns the port's (newton, cg)
    per step."""
    counts = []
    for _ in range(steps):
        js, ts = jsim.step(dt), tsim.step(dt)
        counts.append((ts.newton_iters, ts.cg_iters))
        assert ts.newton_iters == int(js.newton_iters), counts
        assert abs(ts.cg_iters - int(js.cg_iters)) <= cg_diff, (counts, int(js.cg_iters))
        assert ts.converged and bool(js.converged)
        assert ts.active_tiles == int(js.active_tiles) and (ts.active_tiles > 0) == tiles
        assert tsim.metrics.records[-1]["active_tiles"] == ts.active_tiles
        np.testing.assert_allclose(t2n(tsim.state.x), np.asarray(jsim.state.x), rtol=0,
                                   atol=X_TOL)
    assert sum(c[0] for c in counts) > 0, counts
    return counts


SPARSE = {"grid_backend": "sparse", "tile_capacity": 128}


@pytest.mark.parametrize("case", ["jacobi", "multigrid_2_levels", "bar_block_jacobi"])
def test_sparse_steps_match_hot_tpu(monkeypatch, case):
    monkeypatch.setattr(jcapacity, "plan_capacities",
                        functools.partial(jcapacity.plan_capacities, grow=2.0))
    if case == "bar_block_jacobi":
        jsim, tsim = sparse_pair("twisting_bar_3d", dict(SPARSE, tile_capacity=512),
                                 **SMALL["twisting_bar_3d"])
        run_pair(jsim, tsim, 3, DT)
        return
    over = {"solver.preconditioner": "jacobi"} if case == "jacobi" else {
        "solver.preconditioner": "multigrid", "solver.multigrid.levels": 2}
    jsim, tsim = sparse_pair("block_drop_2d", dict(SPARSE, **over), res=32)
    run_pair(jsim, tsim, 15, 4e-3)


HIERARCHIES = {
    "sparse_tail": {},
    "sparse_all_compact": {"solver.multigrid.sparse_dense_switch": 1,
                           "solver.multigrid.coarse_solver": "smoother"},
    "sparse_mf_finest": {"solver.multigrid.assembled_from_level": 1},
}


@pytest.mark.parametrize("name", list(HIERARCHIES))
def test_compact_hierarchies_match_hot_tpu(monkeypatch, name):
    """tests/test_sparse_grid.py::test_sparse_assembled_galerkin_mg_trajectory's
    three sparse hierarchies (3 levels, assembled Galerkin), each against
    hot_tpu's run of the same case (hot_tpu's compact assembly needs its
    binned transfers)."""
    over = dict(SPARSE, **{"solver.preconditioner": "multigrid", "solver.multigrid.levels": 3,
                           "solver.multigrid.assembled": True}, **HIERARCHIES[name])
    monkeypatch.setattr(jcapacity, "plan_capacities",
                        functools.partial(jcapacity.plan_capacities, grow=2.0))
    jsim, tsim = sparse_pair("block_drop_2d", over, {"transfer_impl": "binned"}, res=32)
    run_pair(jsim, tsim, 2, 4e-3, cg_diff=2)
