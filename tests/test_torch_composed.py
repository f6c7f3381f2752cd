"""The composed Galerkin level of hot_tpu_torch (ops/composed.py) against
hot_tpu's (hot_tpu/ops/composed.py) and against the port's own RAP, in fp64.

  * composed per-axis weights of particles and fine nodes at levels 1-3
    equal hot_tpu's (1e-14);
  * assemble_composed_galerkin equals spgemm.rap of the explicitly assembled
    fine operator, and hot_tpu's composed operator, as
    tests/test_spgemm.py::test_composed_galerkin_equals_rap builds them (2D
    at 16^2, 3D at 8^3; 1e-10 relative to the largest entry); at level 2
    (5-wide stencil) it equals two RAPs; with the fine nodes of a tile grid
    (compact ids) it equals the dense fine grid's;
  * two steps of block_drop_2d on the dense grid with the composed level 1
    under a matrix-free finest level equal hot_tpu's (Newton equal, CG
    within 2, x within 1e-9).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hot_tpu.models import constitutive as jcm
from hot_tpu.ops import bsr as jbsr
from hot_tpu.ops import composed as jcomp
from hot_tpu.ops import transfer as jtr
from hot_tpu.sim import capacity as jcapacity
from hot_tpu_torch.grid import sparse as tsp
from hot_tpu_torch.models import constitutive as tcm
from hot_tpu_torch.ops import bsr as tbsr
from hot_tpu_torch.ops import composed as tcomp
from hot_tpu_torch.ops import spgemm as tspg
from hot_tpu_torch.ops import transfer as ttr

from test_torch_ref import assert_close, one_torch_thread, t2n  # noqa: F401
from test_torch_sparse import run_pair, sparse_pair

TOL = 1e-10
DT = 1e-2


def _system(rng, dim, res_n, n):
    """test_spgemm.py's composed case: particles inside the grid, F
    perturbed, the port's context and fine mass."""
    res = (res_n,) * dim
    dx = 1.0 / res_n
    x = rng.uniform(2.5 * dx, (res_n - 3.5) * dx, (n, dim))
    F = np.eye(dim)[None] + 0.1 * rng.standard_normal((n, dim, dim))
    V0, m = rng.uniform(0.5, 1.5, n), rng.uniform(0.5, 2.0, n)
    mu, lam = np.full(n, 30.0), np.full(n, 50.0)
    T = torch.from_numpy
    ctx = tcm.hessian_context(tcm.FixedCorotated(), T(F), T(mu), T(lam))
    st = ttr.particle_stencil(T(x), dx, res)
    grid_m = ttr.scatter_sum(st.node_ids, st.wn * T(m)[:, None], ttr.n_nodes_of(res))
    return dict(x=x, F=F, V0=V0, m=m, mu=mu, lam=lam, ctx=ctx, st=st, grid_m=grid_m, res=res,
                dx=dx)


def _composed(s, L, node_coords=None, node_m=None):
    """The port's level-L composed operator over every level-L node."""
    res_L = tuple(r >> L for r in s["res"])
    n_f = ttr.n_nodes_of(s["res"])
    if node_coords is None:
        node_coords, node_m = ttr.unravel(torch.arange(n_f), s["res"]), s["grid_m"]
    base, w, dw = tcomp.composed_particle_weights(torch.from_numpy(s["x"]), s["dx"], L)
    mat = tbsr.structure(torch.ones(ttr.n_nodes_of(res_L), dtype=torch.bool), res_L,
                         half=tcomp.structure_half(L), dtype=torch.float64)
    return tcomp.assemble_composed_galerkin(mat, L, torch.from_numpy(s["F"]), s["ctx"],
                                            torch.from_numpy(s["V0"]), DT, node_coords, node_m,
                                            base, w, dw)


def _rap_chain(s, L):
    n_f = ttr.n_nodes_of(s["res"])
    A = tbsr.structure(torch.ones(n_f, dtype=torch.bool), s["res"], dtype=torch.float64)
    A = tbsr.assemble_hessian(A, s["st"], torch.from_numpy(s["F"]), s["ctx"],
                              torch.from_numpy(s["V0"]), DT, s["grid_m"])
    res_c = s["res"]
    for _ in range(L):
        res_c = tuple(r // 2 for r in res_c)
        A = tspg.rap(A, res_c, torch.ones(ttr.n_nodes_of(res_c), dtype=torch.bool))
    return A


@pytest.mark.parametrize("L", [1, 2, 3])
@pytest.mark.parametrize("dim", [2, 3])
def test_composed_weights_match_hot_tpu(rng, dim, L):
    x = rng.uniform(0.1, 0.9, (200, dim))
    base, w, dw = tcomp.composed_particle_weights(torch.from_numpy(x), 1.0 / 32, L)
    jb, jw, jdw = jcomp.composed_particle_weights(jnp.asarray(x), 1.0 / 32, L)
    np.testing.assert_array_equal(t2n(base), np.asarray(jb))
    assert w.shape[-1] == (4 if L == 1 else 5)
    assert_close(w, jw, 1e-14)
    assert_close(dw, jdw, 1e-14)
    coords = rng.integers(0, 32, (200, dim))
    nb, nw = tcomp.composed_node_weights(torch.from_numpy(coords), L, torch.float64)
    jnb, jnw = jcomp.composed_node_weights(jnp.asarray(coords), L, jnp.float64)
    np.testing.assert_array_equal(t2n(nb), np.asarray(jnb))
    assert_close(nw, jnw, 1e-14)
    keys = tcomp.ext_key(base, (16,) * dim)
    np.testing.assert_array_equal(t2n(keys), np.asarray(jcomp.ext_key(jb, (16,) * dim)))


@pytest.mark.parametrize("dim,res_n,n", [(2, 16, 250), (3, 8, 120)])
def test_composed_galerkin_equals_rap_and_hot_tpu(rng, dim, res_n, n):
    s = _system(rng, dim, res_n, n)
    got = _composed(s, 1)
    want = _rap_chain(s, 1)
    np.testing.assert_array_equal(t2n(got.col_row), t2n(want.col_row))
    assert_close(got.vals, want.vals, TOL, scale=float(want.vals.abs().max()))
    assert float(got.vals.abs().max()) > 0

    res, res_c = s["res"], tuple(r // 2 for r in s["res"])
    n_f, n_c = ttr.n_nodes_of(res), ttr.n_nodes_of(res_c)
    model = jcm.FixedCorotated()

    @jax.jit
    def reference(x, F, V0, mu, lam, m):
        ctx = jax.vmap(lambda f, m_, l_: jcm.hessian_context(model, f, m_, l_))(F, mu, lam)
        st = jtr.particle_stencil(x, s["dx"], res)
        grid_m = jtr.scatter_sum(st.node_ids, st.wn * m[:, None], n_f)
        cb, cw, cdw = jcomp.composed_particle_weights(x, s["dx"], 1)
        p_bins = jtr.bin_by_ids(jcomp.ext_key(cb, res_c), jcomp.n_ext(res_c), *caps)
        node_coords = jtr.unravel(jnp.arange(n_f, dtype=jnp.int32), res)
        n_bins = jtr.bin_by_ids(jcomp.ext_key(jnp.floor_divide(node_coords - 1, 2), res_c),
                                jcomp.n_ext(res_c), min(n_f, jcomp.n_ext(res_c)), 2 ** dim,
                                valid=grid_m > 0)
        A = jbsr.structure(jnp.ones((n_c,), bool), res=res_c, capacity=n_c, half=3)
        return jcomp.assemble_composed_galerkin(A, 1, res_c, F, ctx, V0, DT, node_coords,
                                                grid_m, p_bins, n_bins, cw, cdw).vals

    caps = jcomp.composed_bin_caps_host(jnp.asarray(s["x"]), s["dx"], 1, res_c, dim)
    jvals = reference(*(jnp.asarray(s[k]) for k in ("x", "F", "V0", "mu", "lam", "m")))
    assert_close(got.vals.reshape(got.n_rows, -1), np.asarray(jvals).reshape(got.n_rows, -1),
                 TOL, scale=float(np.abs(np.asarray(jvals)).max()))


def test_composed_level_two_equals_two_raps(rng):
    """Level 2: 5-wide composed particle stencils and 4-wide node
    embeddings into the 9-wide (half 4) structure of P^T P^T A P P."""
    s = _system(rng, 2, 32, 600)
    got, want = _composed(s, 2), _rap_chain(s, 2)
    assert got.half == want.half == 4
    np.testing.assert_array_equal(t2n(got.col_row), t2n(want.col_row))
    assert_close(got.vals, want.vals, TOL, scale=float(want.vals.abs().max()))


def test_composed_from_compact_fine_nodes(rng):
    """The fine level on a tile grid (compact node coords and masses, as
    level 0 of the sparse backend gives them) gives the dense fine grid's
    operator."""
    s = _system(rng, 2, 32, 300)
    tg = tsp.build_tile_grid(torch.from_numpy(s["x"]), s["dx"], s["res"], capacity=10 ** 6)
    cst = tsp.sparse_stencil(torch.from_numpy(s["x"]), s["dx"], tg)
    cm_ = ttr.scatter_sum(cst.node_ids, cst.wn * torch.from_numpy(s["m"])[:, None], tg.n_cnodes)
    coords = tsp.compact_node_coords(tg, torch.arange(tg.dump))
    got = _composed(s, 1, coords, cm_[:-1])
    want = _composed(s, 1)
    assert_close(got.vals, want.vals, TOL, scale=float(want.vals.abs().max()))


def test_composed_level_steps_match_hot_tpu(monkeypatch):
    """The dense grid, 3 levels with the composed Galerkin level 1 below a
    matrix-free finest level (assembled_from_level=1), 2 steps."""
    monkeypatch.setattr(jcapacity, "plan_capacities",
                        functools.partial(jcapacity.plan_capacities, grow=2.0))
    over = {"solver.preconditioner": "multigrid", "solver.multigrid.levels": 3,
            "solver.multigrid.assembled": True, "solver.multigrid.assembled_from_level": 1,
            "solver.multigrid.coarse_solver": "direct"}
    jsim, tsim = sparse_pair("block_drop_2d", over, {"transfer_impl": "binned"}, res=32)
    run_pair(jsim, tsim, 2, 4e-3, cg_diff=2, tiles=False)
