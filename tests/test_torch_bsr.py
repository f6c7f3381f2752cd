"""The port's BSR operators (ops.bsr, ops.bsr_spmv) against hot_tpu.ops.bsr
and the Pallas SpMV hot_tpu/ops/bsr_tiled.py:spmv_T, on the same particles
and the same per-particle Hessian context (fp64, CPU: the plain SpMV).

The port keeps compressed rows of the active nodes for every operator;
hot_tpu's `structure` pads rows to a capacity and `structure_tiled` lays
rows out by tile. Matrices are compared over node ids, vectors on the grid.
Tolerances: 1e-12 relative to the reference's largest entry (the same sums
in another order); steps as tests/test_torch_step.py holds them.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hot_tpu.grid import sparse as jsparse
from hot_tpu.ops import bsr as jbsr
from hot_tpu.ops import bsr_tiled
from hot_tpu.ops import transfer as jtr
from hot_tpu.scenes import build_scene as jbuild
from hot_tpu.sim import Simulation as JSimulation
from hot_tpu.sim import objective as jobj
from hot_tpu.utils.config import config_from_overrides as j_overrides
from hot_tpu_torch.models import constitutive as tcm
from hot_tpu_torch.ops import bsr as tbsr
from hot_tpu_torch.ops import transfer as ttr
from hot_tpu_torch.ops.bsr_spmv import bsr_spmv_plain
from hot_tpu_torch.scenes import build_scene as tbuild
from hot_tpu_torch.sim import Simulation as TSimulation
from hot_tpu_torch.utils.config import config_from_overrides as t_overrides

from test_torch_ref import assert_close, carry_state, one_torch_thread, t2n  # noqa: F401

TOL = 1e-12
DT = 2e-3
CASES = {2: ("block_drop_2d", dict(res=24, E=1e6)), 3: ("twisting_bar_3d", dict(res=16, ppc=2))}


def torch_ctx(jctx):
    """hot_tpu's per-particle HessianContext as the port's (n, ...) tensors."""
    return tcm.HessianContext(*(torch.from_numpy(np.array(t)) for t in jctx))


@functools.lru_cache(maxsize=None)
def operator_pair(d, seed=3):
    """The quadrature Hessian M + dt^2 K of one perturbed state, assembled by
    hot_tpu (padded compressed rows, jitted) and by the port, from one
    per-particle context."""
    name, kw = CASES[d]
    scene = jbuild(name, dtype=jnp.float64, **kw)
    cfg, js, model = scene["cfg"], scene["state"], scene["model"]
    rng = np.random.default_rng(seed)
    js = js.replace(F=js.F + 0.05 * jnp.asarray(rng.standard_normal(js.F.shape)))
    res = tuple(cfg.grid_res[:d])
    n_nodes = jtr.n_nodes_of(res)

    @jax.jit
    def linearize(js):
        jst = jtr.particle_stencil(js.x, cfg.dx, res)
        jgm, _ = jtr.p2g_mass_momentum(jst, js.v, js.C, js.m, n_nodes)
        obj = jobj.make_objective(model, jst, js.F, js.V0, js.mu, js.lam, jgm,
                                  jnp.zeros((n_nodes, d)),
                                  jnp.broadcast_to(jnp.eye(d), (n_nodes, d, d)), DT, cfg.dx)
        return jst, jgm, jobj.build_hessian(model, obj, jnp.zeros((n_nodes, d))).ctx

    jst, jgm, jctx = linearize(js)
    active = np.asarray(jgm) > 0
    jmat = jax.jit(lambda a, *args: jbsr.assemble_hessian(
        jbsr.structure(a, res, capacity=int(active.sum()) + 8), *args, DT, jgm))(
        jnp.asarray(active), jst, js.F, jctx, js.V0)

    ts = carry_state(js)
    tst = ttr.particle_stencil(ts.x, cfg.dx, res)
    tmat = tbsr.structure(torch.from_numpy(active), res, dtype=torch.float64)
    tmat = tbsr.assemble_hessian(tmat, tst, ts.F, torch_ctx(jctx), ts.V0, DT,
                                 torch.from_numpy(np.array(jgm)))
    return dict(jmat=jmat, tmat=tmat, js=js, jst=jst, jctx=jctx, jgm=jgm, cfg=cfg, res=res,
                n_nodes=n_nodes, active=active)


@pytest.mark.parametrize("d", [2, 3])
def test_structure_and_assembly_match_hot_tpu(d):
    p = operator_pair(d)
    jmat, tmat = p["jmat"], p["tmat"]
    R = tmat.n_rows
    assert R == int(p["active"].sum())
    np.testing.assert_array_equal(t2n(tmat.node_of), np.asarray(jmat.node_of)[:R])
    np.testing.assert_array_equal(t2n(tmat.col_row), np.asarray(jmat.col_row)[:R])
    A_j = jbsr.to_scipy(jmat)[: R * d, : R * d]
    A_t = tbsr.to_scipy(tmat)
    assert np.abs(A_t).max() > 0
    assert_close(A_t, A_j, TOL)
    np.testing.assert_allclose(A_t, A_t.T, rtol=0, atol=TOL * np.abs(A_t).max())


@pytest.mark.parametrize("d", [2, 3])
def test_spmv_matches_pallas_spmv_T(d):
    """The port's SpMV against hot_tpu's Pallas kernel spmv_T in interpret
    mode (through spmv_tiled_pallas, on hot_tpu's own tile-row matrix over
    the same particles), compared as grid vectors on the active nodes."""
    p = operator_pair(d)
    js, cfg, res, n_nodes = p["js"], p["cfg"], p["res"], p["n_nodes"]
    x_grid = np.random.default_rng(5).standard_normal((n_nodes, d))

    @jax.jit
    def tiled_spmv(js, jst, jctx, jgm, x_grid):
        tgrid = jsparse.build_tile_grid(js.x, cfg.dx, res, capacity=64)
        jtile = jbsr.assemble_hessian(bsr_tiled.structure_tiled(tgrid), jst, js.F, jctx,
                                      js.V0, DT, jgm)
        y_rows = bsr_tiled.spmv_tiled_pallas(jtile, tgrid, bsr_tiled.tile_neighbors(tgrid),
                                             jbsr.grid_vector_to_rows(jtile, x_grid),
                                             interpret=True)
        return jbsr.rows_to_grid_vector(jtile, y_rows, n_nodes), tgrid.overflow

    y_grid, overflow = tiled_spmv(js, p["jst"], p["jctx"], p["jgm"], jnp.asarray(x_grid))
    assert not bool(overflow)
    want = np.asarray(y_grid)[p["active"]]
    tmat = p["tmat"]
    got = tbsr.rows_to_grid_vector(
        tmat, tbsr.spmv(tmat, tbsr.grid_vector_to_rows(tmat, torch.from_numpy(x_grid))),
        n_nodes)
    assert_close(t2n(got)[p["active"]], want, TOL)


def test_spmv_plain_skips_absent_columns(rng):
    """col_row < 0 contributes nothing, whatever its block holds."""
    vals = torch.from_numpy(rng.standard_normal((7, 27, 3, 3)))
    col = torch.from_numpy(rng.integers(-3, 7, (7, 27)).astype(np.int32))
    x = torch.from_numpy(rng.standard_normal((7, 3)))
    want = np.zeros((7, 3))
    for r in range(7):
        for k in range(27):
            if col[r, k] >= 0:
                want[r] += t2n(vals[r, k]) @ t2n(x[col[r, k]])
    assert_close(bsr_spmv_plain(vals, col, x), want, TOL)


@pytest.mark.parametrize("d", [2, 3])
def test_block_diag_matches_hot_tpu(d):
    p = operator_pair(d)
    R = p["tmat"].n_rows
    assert_close(tbsr.block_diag(p["tmat"]), np.asarray(jbsr.block_diag(p["jmat"]))[:R], TOL)


def test_explicit_bsr_steps_match_hot_tpu():
    """matrix_free=False (the outer Hessian assembled per Newton iteration
    and applied by the SpMV): two steps of the 16^3 bar with hot_tpu's
    Newton and CG counts and positions within 1e-9."""
    overrides = {"solver.matrix_free": False}
    scene = jbuild("twisting_bar_3d", res=16, ppc=2, dtype=jnp.float64)
    tscene = tbuild("twisting_bar_3d", device="cpu", res=16, ppc=2, dtype=torch.float64)
    jsim = JSimulation(j_overrides(scene["cfg"], overrides), scene["state"], scene["model"],
                       scene["colliders"])
    tsim = TSimulation(t_overrides(tscene["cfg"], overrides), carry_state(scene["state"]),
                       tscene["model"], tscene["colliders"])
    newton = 0
    for _ in range(2):
        js, ts = jsim.step(4e-3), tsim.step(4e-3)
        assert (ts.newton_iters, ts.cg_iters) == (int(js.newton_iters), int(js.cg_iters))
        assert ts.converged
        newton += ts.newton_iters
        np.testing.assert_allclose(t2n(tsim.state.x), np.asarray(jsim.state.x), rtol=0,
                                   atol=1e-9)
    assert newton > 0
