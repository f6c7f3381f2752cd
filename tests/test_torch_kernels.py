"""The port's two kernel modules against hot_tpu's Pallas kernels and XLA
chains, on the same fp64 inputs.

  * fused_apply (ops/fused_apply.py)         <-> pallas_apply.fused_contrib(_cl)
  * fused_linearize (ops/fused_linearize.py) <-> pallas_linearize.fused_linearize

On the CPU the port's dispatchers run their plain PyTorch versions; these
are held against the Pallas kernels run in interpret mode in 2D, and against
the Pallas kernel bodies run eagerly on component arrays in 3D (interpret
mode takes minutes for the 3D kernels). The port's side takes the particle
positions x with dx and res, from which it builds the stencil; the Pallas
side takes hot_tpu's own stencil. test_torch_objective.py holds the
same modules against hot_tpu's unfused XLA chains. The CUDA kernels
against the plain versions need a card (marker `cuda`; they skip here).

Tolerances: 1e-10 relative to the reference's largest entry where both sides
compute in fp64 (they differ only in summation order); U and V are compared
through sign-invariant products u_i v_i^T, because the Pallas kernel takes
the algebraic Jacobi angle and may flip column pairs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hot_tpu.models import constitutive as jcm
from hot_tpu.ops import pallas_apply, pallas_linearize
from hot_tpu.ops import transfer as jtr
from hot_tpu.sim import objective as jobj
from hot_tpu_torch.ops import fused_apply as tfa
from hot_tpu_torch.ops import fused_linearize as tfl
from hot_tpu_torch.sim import objective as tobj
from hot_tpu_torch.utils.timing import TRACER

from test_torch_ref import DT, assert_close, objective_pair, one_torch_thread, t2n  # noqa: F401

TOL = 1e-10
SCENES = {2: "block_drop_2d", 3: "twisting_bar_3d"}


def _hess(p):
    """The port's HessianState at p.v and the same context as hot_tpu arrays
    (the two packages' contexts agree: test_kernel_modules_match_xla_chain)."""
    _, th = tobj.linearize(p.tmodel, p.to, torch.from_numpy(p.v))
    ctx = th.context(p.v.shape[1])
    return jcm.HessianContext(*(jnp.asarray(t2n(t)) for t in ctx)), th


def _pair_products(U, V):
    """u_i v_i^T per particle and column: invariant to paired column signs."""
    return np.einsum("pai,pbi->piab", U, V)


def _aos(M, d):
    return t2n(M).T.reshape(-1, d, d)


def _eager_apply_body(vi, gwn, F, ctx, V0, dt, d):
    """pallas_apply._kernel on (C, n) component arrays, outside pallas_call."""
    n, s = vi.shape[:2]
    comp = lambda x: jnp.asarray(x).reshape(n, -1).T  # noqa: E731
    out = [None] * (s * d)
    pallas_apply._kernel(jnp.full((1, 1), dt), comp(vi), comp(gwn), comp(F),
                         comp(ctx.U), comp(ctx.V), comp(ctx.A), comp(ctx.b_plus),
                         comp(ctx.b_minus), comp(V0), out, s=s, dim=d)
    return jnp.stack(out, -1).reshape(n, s, d)


def _eager_linearize_body(vi, gwn, F, mu, lam, V0, dt, d, model_name):
    """pallas_linearize._kernel on (C, n) component arrays."""
    n, s = vi.shape[:2]
    comp = lambda x: jnp.asarray(x).reshape(n, -1).T  # noqa: E731
    n_pairs = 1 if d == 2 else 3
    outs = [[None] * (s * d), [None] * (d * d), [None] * (d * d), [None] * (d * d),
            [None] * n_pairs, [None] * n_pairs]
    pallas_linearize._kernel(jnp.full((1, 1), dt), comp(vi), comp(gwn), comp(F),
                             comp(mu), comp(lam), comp(V0), *outs, s=s, d=d,
                             model_name=model_name, sweeps=6, project=True)
    contrib, U, V, A, bp, bm = (jnp.stack(o, -1) for o in outs)
    return (contrib.reshape(n, s, d), U.reshape(n, d, d), V.reshape(n, d, d),
            A.reshape(n, d, d), bp, bm)


@pytest.mark.parametrize("d", [2, 3])
def test_fused_apply_plain_matches_pallas(rng, d):
    """Plain fused_apply == Pallas fused_contrib + scatter (interpret mode in
    2D, the kernel body in 3D)."""
    p = objective_pair(SCENES[d], rng)
    jo, to, v = p.jo, p.to, p.v
    jctx, th = _hess(p)
    w = rng.standard_normal(v.shape)
    vi = jtr.gather(jnp.asarray(w), jo.stencil.node_ids)
    if d == 2:
        contrib = pallas_apply.fused_contrib(
            vi, jo.stencil.gwn, jo.F_n, jctx.U, jctx.V, jctx.A, jctx.b_plus,
            jctx.b_minus, jo.V0, DT, interpret=True)
    else:
        contrib = _eager_apply_body(vi, jo.stencil.gwn, jo.F_n, jctx, jo.V0, DT, d)
    want = jtr.scatter_sum(jo.stencil.node_ids, contrib, w.shape[0])
    got = tfa.fused_apply(torch.from_numpy(w), to.x_soa, to.dx, to.res, to.F_soa,
                          th.U, th.V, th.A, th.b_plus, th.b_minus, to.V0, DT)
    assert_close(got, want, TOL)


def test_multiply_matches_pallas_multiply_cl(rng):
    """The port's objective.multiply == hot_tpu's component-leading Pallas
    apply path (objective.multiply_cl, interpret mode), 2D."""
    p = objective_pair("block_drop_2d", rng)
    jctx, th = _hess(p)
    w = rng.standard_normal(p.v.shape)
    bins = jtr.bin_particles(jnp.asarray(p.x), p.dx, p.res, max(64, p.x.shape[0]), 16)
    assert not bool(bins.overflow)
    params = jobj.hessian_params_cl(p.jo, jctx)
    want = jobj.multiply_cl(p.jo, params, jnp.asarray(w), bins, p.res, interpret=True)
    assert_close(tobj.multiply(p.to, th, torch.from_numpy(w)), want, TOL)


@pytest.mark.parametrize("model_name", ["fixed_corotated", "stvk_hencky"])
@pytest.mark.parametrize("d", [2, 3])
def test_fused_linearize_plain_matches_pallas(rng, d, model_name):
    """Plain fused_linearize == Pallas fused_linearize + scatter (interpret
    mode in 2D, the kernel body in 3D): force, A, b+/-, and U, V up to
    paired column signs."""
    p = objective_pair(SCENES[d], rng, model_name)
    jo, to, v = p.jo, p.to, p.v
    vi = jtr.gather(jnp.asarray(v), jo.stencil.node_ids)
    args = (vi, jo.stencil.gwn, jo.F_n, jo.mu, jo.lam, jo.V0, DT)
    if d == 2:
        contrib, U, V, A, bp, bm = pallas_linearize.fused_linearize(
            *args, model_name=model_name, interpret=True)
    else:
        contrib, U, V, A, bp, bm = _eager_linearize_body(*args, d, model_name)
    f = jtr.scatter_sum(jo.stencil.node_ids, contrib, v.shape[0])
    got = tfl.fused_linearize(torch.from_numpy(v), to.x_soa, to.dx, to.res, to.F_soa,
                              to.mu, to.lam, to.V0, DT, p.tmodel)
    assert_close(got[0], f, TOL)
    assert_close(_aos(got[3], d), A, TOL)
    assert_close(t2n(got[4]).T, bp, TOL)
    assert_close(t2n(got[5]).T, bm, TOL)
    assert_close(_pair_products(_aos(got[1], d), _aos(got[2], d)),
                 _pair_products(np.asarray(U), np.asarray(V)), 1e-8)


def _launches():
    """The three kernels' launch counters (the tracer's)."""
    return tuple(TRACER.counts["launches." + k]
                 for k in ("fused_apply", "fused_linearize", "bsr_spmv"))


def test_dispatch_is_by_device(rng):
    """CPU tensors run the plain versions without counting a launch."""
    p = objective_pair("block_drop_2d", rng)
    to, v = p.to, p.v
    before = _launches()
    _, th = tobj.linearize(p.tmodel, to, torch.from_numpy(v))
    tobj.multiply(to, th, torch.from_numpy(v))
    assert _launches() == before
    with pytest.raises(ValueError):
        tfa.fused_apply(torch.from_numpy(v).to("meta"), to.x_soa, to.dx, to.res,
                        to.F_soa, th.U, th.V, th.A, th.b_plus, th.b_minus, to.V0, DT)


@pytest.mark.parametrize("n", [0, 5])
def test_launches_count_only_real_launches(monkeypatch, n):
    """A wrapper counts a launch only where its C entry launches one: not
    for a call with no particle or no row (a rank holding no particle),
    for which the C entries launch nothing. The library is a stand-in that
    launches nothing, so this runs on the CPU."""
    from types import SimpleNamespace

    from hot_tpu_torch.ops import bsr_spmv as tsp
    from hot_tpu_torch.ops import cuda_lib

    fake = SimpleNamespace(hot_fused_apply=lambda *a: 0, hot_fused_linearize=lambda *a: 0,
                           hot_bsr_spmv=lambda *a: 0)
    monkeypatch.setattr(cuda_lib, "load", lambda: fake)
    monkeypatch.setattr(cuda_lib, "stream_ptr", lambda device: 0)
    f64, res = torch.float64, (8, 8)
    x = torch.full((2, n), 0.5, dtype=f64)
    F = torch.eye(2, dtype=f64).reshape(4, 1).repeat(1, n)
    ctx = [torch.zeros((4, n), dtype=f64) for _ in range(3)]
    pairs = [torch.zeros((1, n), dtype=f64) for _ in range(2)]
    per_particle = [torch.ones(n, dtype=f64) for _ in range(3)]
    grid = torch.zeros((64, 2), dtype=f64)
    before = _launches()
    tfa.fused_apply_cuda(grid, x, 0.125, res, F, *ctx, *pairs, per_particle[0], DT)
    tfl.fused_linearize_cuda(grid, x, 0.125, res, F, *per_particle, DT,
                             SimpleNamespace(name="fixed_corotated"))
    tsp.bsr_spmv_cuda(torch.zeros((n, 3, 2, 2), dtype=f64),
                      torch.zeros((n, 3), dtype=torch.int32), grid)
    after = _launches()
    assert [b - a for a, b in zip(before, after)] == [int(n > 0)] * 3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10), (torch.float32, 2e-5)])
@pytest.mark.parametrize("model_name", ["fixed_corotated", "stvk_hencky"])
@pytest.mark.parametrize("d", [2, 3])
def test_cuda_kernels_match_plain(rng, cuda_device, d, model_name, dtype, tol):
    """The CUDA kernels == their plain versions on the card (fp32: atomics
    and FMA contraction change rounding), at chip_smoke.py's tolerances."""
    p = objective_pair(SCENES[d], rng, model_name)
    to, tmodel, v = p.to, p.tmodel, p.v
    dev = lambda t: t.to(cuda_device, dtype if t.is_floating_point() else t.dtype)  # noqa: E731
    v_, x, F, mu, lam, V0 = (dev(t) for t in (torch.from_numpy(v), to.x_soa, to.F_soa,
                                               to.mu, to.lam, to.V0))
    args = (v_, x, to.dx, to.res, F, mu, lam, V0, DT, tmodel)
    got = tfl.fused_linearize_cuda(*args)
    want = tfl.fused_linearize_plain(*args)
    for g, w_ in zip([got[0], got[3], got[4], got[5]], [want[0], want[3], want[4], want[5]]):
        assert_close(g, t2n(w_), tol)
    w = dev(torch.from_numpy(rng.standard_normal(v.shape)))
    params = (x, to.dx, to.res, F, *want[1:], V0, DT)
    df = tfa.fused_apply_cuda(w, *params)
    assert_close(df, t2n(tfa.fused_apply_plain(w, *params)), tol)
