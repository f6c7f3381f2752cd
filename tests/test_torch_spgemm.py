"""The port's Galerkin RAP (ops.spgemm.rap) against hot_tpu.ops.spgemm.rap
on the same fine operator (the 16^3 bar's, fp64, CPU): two levels down (stencil half
2 -> 3 -> 4) and with the output half capped (max_half=3), compared over
node ids to 1e-12 relative to the reference's largest entry; and symmetry.
Coarse levels are the active nodes of the particles' mass at 2 dx and 4 dx,
as the multigrid hierarchy builds them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hot_tpu.ops import bsr as jbsr
from hot_tpu.ops import spgemm as jspgemm
from hot_tpu_torch.ops import bsr as tbsr
from hot_tpu_torch.ops import spgemm as tspgemm
from hot_tpu_torch.ops import transfer as ttr

from test_torch_bsr import operator_pair
from test_torch_ref import assert_close, carry_state, one_torch_thread, t2n  # noqa: F401

TOL = 1e-12


def _coarse_active(p, level):
    """Nodes with particle mass at spacing 2^level dx."""
    ts = carry_state(p["js"])
    res = p["res"]
    for _ in range(level):
        res = tuple((r + 1) // 2 for r in res)
    st = ttr.particle_stencil(ts.x, p["cfg"].dx * 2 ** level, res)
    return res, ttr.scatter_sum(st.node_ids, st.wn * ts.m[:, None], ttr.n_nodes_of(res)) > 0


def _check(jmat, tmat, d):
    R = tmat.n_rows
    np.testing.assert_array_equal(t2n(tmat.node_of), np.asarray(jmat.node_of)[:R])
    A_t = tbsr.to_scipy(tmat)
    assert np.abs(A_t).max() > 0
    assert_close(A_t, jbsr.to_scipy(jmat)[: R * d, : R * d], TOL)
    np.testing.assert_allclose(A_t, A_t.T, rtol=0, atol=TOL * np.abs(A_t).max())


@pytest.mark.parametrize("max_half", [None, 3])
def test_rap_two_levels_match_hot_tpu(max_half):
    d = 3
    p = operator_pair(d)
    jmat, tmat = p["jmat"], p["tmat"]
    halves = []
    for level in (1, 2):
        res_c, active_c = _coarse_active(p, level)
        cap = int(active_c.sum()) + 8
        jmat = jax.jit(lambda A, a: jspgemm.rap(A, res_c, a, cap, max_half=max_half))(
            jmat, jnp.asarray(t2n(active_c)))
        tmat = tspgemm.rap(tmat, res_c, active_c, max_half=max_half)
        assert tmat.half == jmat.half and tmat.K == jmat.K
        assert tmat.n_rows == int(active_c.sum())
        _check(jmat, tmat, d)
        halves.append(tmat.half)
    assert halves == ([3, 4] if max_half is None else [3, 3])


def test_embedding_weights_match_hot_tpu():
    coords = np.stack(np.meshgrid(np.arange(9), np.arange(7), np.arange(5), indexing="ij"),
                      -1).reshape(-1, 3)
    jb, jw = jspgemm.embedding_weights(jnp.asarray(coords, jnp.int32), jnp.float64)
    tb, tw = tspgemm.embedding_weights(torch.from_numpy(coords), torch.float64)
    np.testing.assert_array_equal(t2n(tb), np.asarray(jb))
    assert_close(tw, np.asarray(jw), TOL)
    assert [tspgemm.rap_half_out(h) for h in (2, 3, 4)] == [3, 4, 4]
