"""ROADMAP C4: the port's sparse-grid multigrid against hot_tpu's at 24^2
and 28^2, fp64, from tests/test_torch_sparse.py's stressed block_drop_2d.

hot_tpu's steps part from the port's there (config 3 by 2e-5 after one
step at E 1e7, the matrix-free multigrid in its counts) but not at 32^2.
The cause is in hot_tpu's node embedding (the prolongation P and the
restriction R of its multigrid), in two faults of the reference:

  * compiled, hot_tpu's quadratic weights take base = floor(x/dx - 0.5)
    and the weights u = x/dx - base from differently rounded values of
    x/dx (x/dx with dx a trace-time constant is not always the same
    division in every fusion). A fine node whose coarse coordinate is a
    half-cell (an odd node, x/dx - 0.5 an integer) rounds to opposite
    sides when 1/dx is inexact (24, 28; never 32 = 2^5), so its compact
    embedding's node ids are one coarse node from its weights;
  * the binned restriction (transfer_impl="binned", which hot_tpu's
    assembled sparse levels need) bins the fine nodes by coarse cell with
    2^dim slots per cell; the same rounding puts 3 nodes per axis in one
    cell, the bins overflow and drop nodes, and the flag is never read,
    so R is not P^T.

The port builds every stencil eagerly from one x/dx, and restricts with
P^T. These tests show both faults in hot_tpu and hold the port's MG
hierarchy and one V-cycle to hot_tpu's with the two faults taken out
(hot_tpu's hierarchy built eagerly, its plain restriction), at 24^2 (E
1e4 and 1e7, config 3 and the matrix-free multigrid) and 28^2 (config 3,
E 1e7).
"""

import dataclasses
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
from hot_tpu.solver import multigrid as jmg
from hot_tpu.utils.config import config_from_overrides as j_overrides
from hot_tpu_torch.grid import sparse as tsp
from hot_tpu_torch.ops import transfer as ttr
from hot_tpu_torch.scenes import build_scene as tbuild
from hot_tpu_torch.scenes import stress_state
from hot_tpu_torch.sim import collision as tcol
from hot_tpu_torch.sim import objective as tobj
from hot_tpu_torch.solver import multigrid as tmg
from hot_tpu_torch.utils.config import config_from_overrides as t_overrides

from test_torch_ref import DT, assert_close, one_torch_thread, t2n  # noqa: F401

CONFIG3 = {"solver.multigrid.assembled": True, "solver.multigrid.coarse_solver": "direct"}
MATRIX_FREE = {"solver.multigrid.assembled": False}
BASE = {"grid_backend": "sparse", "tile_capacity": 64, "solver.preconditioner": "multigrid",
        "solver.multigrid.levels": 3}


def _exact_prolongation(fine_coords, e_coarse, res_c):
    """P e at fine nodes of integer coords (n, d), from integer arithmetic:
    a fine node at coord c sits at c / 2 coarse cells, its coarse base is
    floor((c - 1) / 2) and its per-axis offsets u = c / 2 - base."""
    base = np.floor_divide(fine_coords - 1, 2)
    u = fine_coords / 2.0 - base
    w = np.stack([0.5 * (1.5 - u) ** 2, 0.75 - (u - 1.0) ** 2, 0.5 * (u - 0.5) ** 2], -1)
    out = np.zeros((fine_coords.shape[0], e_coarse.shape[-1]))
    d = fine_coords.shape[1]
    for offs in np.ndindex(*(3,) * d):
        c = np.clip(base + np.array(offs), 0, np.array(res_c) - 1)
        wk = np.prod([w[:, a, offs[a]] for a in range(d)], axis=0)
        out += wk[:, None] * e_coarse[np.ravel_multi_index(c.T, res_c)]
    return out


@pytest.mark.parametrize("res", [24, 28, 32])
def test_embedding_of_compact_level(res):
    """The level-0 (compact) to level-1 embedding: the port's prolongation
    is the exact one, and so is hot_tpu's run eagerly; hot_tpu's compiled
    one is not at 24^2 and 28^2 (its fault), and is at 32^2."""
    rng = np.random.default_rng(0)
    dx = 1.0 / res
    x = rng.uniform(0.3, 0.7, (400, 2))
    res_f, res_c = (res, res), ((res + 1) // 2,) * 2
    tg = tsp.build_tile_grid(torch.from_numpy(x), dx, res_f, capacity=10 ** 6)
    jg = jsp.build_tile_grid(jnp.asarray(x), dx, res_f, tg.n_active)
    coords = t2n(tsp.compact_node_coords(tg, torch.arange(tg.dump)))
    inside = np.all(coords < res, -1)
    e = rng.standard_normal((res_c[0] * res_c[1], 2))
    want = _exact_prolongation(coords[inside], e, res_c)

    pos_t = tsp.node_positions(tg, dx, torch.float64)
    embed_t = ttr.particle_stencil(pos_t, 2 * dx, res_c)
    got_t = t2n(tmg.prolong(embed_t, torch.from_numpy(e)))[:tg.dump][inside]
    assert_close(got_t, want, 1e-13)

    def hot_tpu_prolong(e):
        pos = jsp.node_positions(jg, dx, jnp.float64)
        embed = jtr.particle_stencil(pos, 2 * dx, res_c, weights_impl="flat")
        return jmg.prolong(embed, e)

    with jax.disable_jit():
        assert_close(np.asarray(hot_tpu_prolong(jnp.asarray(e)))[:tg.dump][inside], want, 1e-13)
    compiled = np.asarray(jax.jit(hot_tpu_prolong)(jnp.asarray(e)))[:tg.dump][inside]
    err = float(np.abs(compiled - want).max())
    if res == 32:
        assert err < 1e-13
    else:
        assert err > 1e-2, err      # hot_tpu's fault: weights on the wrong coarse nodes


def _pair(res, E, over):
    """The port's and hot_tpu's configs and the port's stressed fp64 state."""
    scene = tbuild("block_drop_2d", device="cpu", dtype=torch.float64, res=res, E=E)
    cfg = t_overrides(scene["cfg"], dict(BASE, **over))
    from hot_tpu.scenes import build_scene as jbuild

    jscene = jbuild("block_drop_2d", dtype=jnp.float64, res=res, E=E)
    jcfg = j_overrides(jscene["cfg"], dict(BASE, transfer_impl="binned", **over))
    return cfg, jcfg, stress_state(scene["state"], cfg), scene


def _port_first_iterate(cfg, state, scene):
    """The implicit step's set-up, as advance_one_step makes it, up to the
    first Newton iterate: the tile grid, the constrained mask, the residual
    and Hessian at v0, the MG hierarchy and its preconditioner."""
    dim, dx, res = cfg.dim, cfg.dx, tuple(cfg.grid_res[:2])
    tg = tsp.build_tile_grid(state.x, dx, res, cfg.tile_capacity)
    st = tsp.sparse_stencil(state.x, dx, tg)
    grid_m, grid_mv = ttr.p2g_mass_momentum(st, state.v, state.C, state.m, tg.n_cnodes)
    active = grid_m > 0
    v_grid = grid_mv * torch.where(active, 1.0 / grid_m.clamp(min=1e-30), 0.0)[:, None]
    v_star = v_grid + DT * torch.tensor(cfg.gravity[:dim], dtype=torch.float64)
    proj, v_bc, constrained = tcol.grid_boundary_conditions(
        tsp.node_positions(tg, dx, torch.float64), 0.0, scene["colliders"], grid_v=v_star,
        boundary_margin=2, res=res, dx=dx)
    obj = tobj.make_objective(scene["model"], st, state.F, state.V0, state.mu, state.lam,
                              grid_m, v_star, proj, DT, dx, state.x, res, tgrid=tg)
    r, hess = tobj.linearize(scene["model"], obj, tcol.apply_bc_to_velocity(v_star, proj, v_bc))
    mgc = cfg.solver.multigrid
    mg = tmg.build_static(state.x, state.m, res, dx, mgc.levels, constrained, torch.float64,
                          assembled_from=mgc.assembled_from_level if mgc.assembled else None,
                          tgrid=tg, tile_capacity=cfg.tile_capacity,
                          dense_switch=mgc.sparse_dense_switch,
                          composed=mgc.coarsening == "galerkin")
    pre = tmg.build_precond(mg, state.F, hess, state.V0, DT, mgc, dim)
    return tg, constrained, r, hess, mg, pre


@functools.partial(jax.jit, static_argnames=("res", "dx", "n_levels", "tile_capacity", "bin_caps",
                                              "mg_tile_caps", "mg_bin_caps", "dense_switch"))
def _hot_tpu_static(x, m, constrained, *, res, dx, n_levels, tile_capacity, bin_caps,
                    mg_tile_caps, mg_bin_caps, dense_switch):
    return jmg.build_static(x, m, res, dx, n_levels, constrained, jnp.float64,
                            tile_capacity=tile_capacity, bin_caps=bin_caps,
                            mg_tile_caps=mg_tile_caps, mg_bin_caps=mg_bin_caps,
                            dense_switch=dense_switch)


def _eager_embeds(mg):
    """hot_tpu's node embeddings (build_static's compact-to-dense and
    dense-to-dense stencils, an inactive compact node's weights zeroed)
    computed eagerly: fault 1 taken out."""
    embeds = []
    with jax.disable_jit():
        for fine, coarse in zip(mg.levels[:-1], mg.levels[1:]):
            assert not coarse.compact
            pos = (jsp.node_positions(fine.tgrid, fine.dx, jnp.float64) if fine.compact
                   else jtr.node_positions(fine.res, fine.dx, jnp.float64))
            embed = jtr.particle_stencil(pos, coarse.dx, coarse.res, weights_impl="flat")
            if fine.compact:
                embed = embed._replace(wn=jnp.where(fine.active[:, None], embed.wn, 0.0))
            embeds.append(embed)
    return tuple(embeds)


@functools.partial(jax.jit, static_argnames=("cfg",))
def _hot_tpu_v_cycle(mg, F, ctx, V0, r, *, cfg):
    pre = jmg.build_precond(mg, F, ctx, V0, DT, cfg, 2)
    return jmg.mg_precondition(mg, pre, F, V0, DT, cfg, r)


CASES = [(24, 1e4, "config3"), (24, 1e7, "config3"), (24, 1e4, "matrix_free"),
         (24, 1e7, "matrix_free"), (28, 1e7, "config3")]


@pytest.mark.parametrize("res,E,name", CASES)
def test_v_cycle_matches_hot_tpu_without_its_faults(monkeypatch, res, E, name):
    """One V-cycle on the first Newton residual: the port's hierarchy against
    hot_tpu's built from the same particles, constrained nodes and Hessian
    context, its node embeddings computed eagerly (fault 1 out) and its plain
    restriction (fault 2 out), on the same compact layout (hot_tpu's tile capacity = the port's
    active tiles). With its binned restriction hot_tpu's V-cycle is another
    one (config 3)."""
    over = CONFIG3 if name == "config3" else MATRIX_FREE
    cfg, jcfg, state, scene = _pair(res, E, over)
    tg, constrained, r, hess, mg, pre = _port_first_iterate(cfg, state, scene)
    z_port = t2n(tmg.mg_precondition(mg, pre, DT, cfg.solver.multigrid, r))

    x = jnp.asarray(t2n(state.x))
    plan = jcapacity.plan_capacities(jcfg, np.asarray(x), grow=2.0)
    mgc = cfg.solver.multigrid
    jmgc = dataclasses.replace(jcfg.solver.multigrid, coarse_capacity=plan.mg_coarse_cap)
    jmg_static = _hot_tpu_static(
        x, jnp.asarray(t2n(state.m)), jnp.asarray(t2n(constrained)), res=tuple(cfg.grid_res[:2]),
        dx=cfg.dx, n_levels=mgc.levels, tile_capacity=tg.n_active, bin_caps=plan.bin_caps,
        mg_tile_caps=plan.mg_tile_caps, mg_bin_caps=plan.mg_bin_caps,
        dense_switch=mgc.sparse_dense_switch or 2 * cfg.tile_capacity * 16)
    jmg_static = jmg_static._replace(embeds=_eager_embeds(jmg_static))
    ctx = jcm.HessianContext(*(jnp.asarray(t2n(a)) for a in hess.context(2)))
    F, V0 = jnp.asarray(t2n(state.F)), jnp.asarray(t2n(state.V0))

    def v_cycle(binned, r):
        mg = jmg_static if binned else jmg_static._replace(
            embed_bins=(None,) * len(jmg_static.embed_bins))
        return _hot_tpu_v_cycle(mg, F, ctx, V0, r, cfg=jmgc)

    r_j = jnp.asarray(t2n(r))
    assert_close(z_port, v_cycle(False, r_j), 1e-10)
    if (res, name) == (24, "config3"):
        err = float(np.abs(np.asarray(v_cycle(True, r_j)) - z_port).max())
        assert err > 1e-6 * float(np.abs(z_port).max()), err
