"""hot_tpu_torch numerics against hot_tpu: SVD, polar decomposition,
symmetric eigen, B-splines and the four constitutive models, on the same
fp64 inputs (made with numpy).

Tolerance 1e-10, relative to the largest entry of the reference: both
packages run the same algorithm in fp64, and differ only in the rounding of
reductions and of analytic versus autodiff derivatives (~1e-15). The
Neo-Hookean and linear-corotated models and polar are held to 1e-12.

hot_tpu's svd and eigh_sym run jitted (test_torch_ref.jitted_hot_tpu_svd):
compiled once per worker and shape, every case reuses them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hot_tpu.models import constitutive as jcm
from hot_tpu.ops import bspline as jbs
from hot_tpu.ops.svd import polar as j_polar
from hot_tpu_torch.models import constitutive as tcm
from hot_tpu_torch.ops import bspline as tbs
from hot_tpu_torch.ops import svd as tsvd

from test_torch_ref import (JIT_EIGH_SYM, JIT_SVD, jitted_hot_tpu_svd,  # noqa: F401
                            one_torch_thread)

TOL = 1e-10
pytestmark = pytest.mark.usefixtures("jitted_hot_tpu_svd")


def close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def matrices(rng, n, d):
    """Random, near-identity, inverted and exactly degenerate matrices."""
    F = [rng.standard_normal((n, d, d)),
         np.eye(d) + 0.2 * rng.standard_normal((n, d, d))]
    inv = np.eye(d) + 0.2 * rng.standard_normal((n // 4, d, d))
    inv[:, :, 0] *= -1.0
    F += [inv, np.broadcast_to(np.eye(d), (2, d, d)),
          np.broadcast_to(np.diag(np.arange(d, 0, -1.0)), (2, d, d))]
    return np.concatenate(F, axis=0)


@pytest.mark.parametrize("d", [2, 3])
def test_svd_matches_hot_tpu(rng, d):
    F = matrices(rng, 64, d)
    U, s, V = jax.vmap(JIT_SVD)(jnp.asarray(F))
    tU, ts, tV = tsvd.svd(torch.from_numpy(F))
    close(ts, s)
    close(tU, U)
    close(tV, V)


@pytest.mark.parametrize("d", [2, 3])
def test_polar_matches_hot_tpu(rng, d):
    """R proper and orthogonal, S symmetric (indefinite for the inverted
    matrices), A = R S."""
    F = matrices(rng, 64, d)
    R, S = j_polar(jnp.asarray(F))
    tR, tS = tsvd.polar(torch.from_numpy(F))
    close(tR, R, 1e-12)
    close(tS, S, 1e-12)
    close(tR @ tS, F, 1e-12)
    close(tS - tS.transpose(1, 2), np.zeros_like(F), 1e-12)
    close(torch.linalg.det(tR), np.ones(F.shape[0]), 1e-12)
    inverted = np.linalg.det(F) < 0
    assert inverted.any() and bool((torch.linalg.eigvalsh(tS[inverted]).min(1).values < 0).all())


@pytest.mark.parametrize("d", [2, 3])
def test_eigh_sym_matches_hot_tpu(rng, d):
    M = rng.standard_normal((64, d, d))
    S = np.concatenate([M + M.transpose(0, 2, 1), np.broadcast_to(np.eye(d), (2, d, d))])
    w, Q = jax.vmap(JIT_EIGH_SYM)(jnp.asarray(S))
    tw, tQ = tsvd.eigh_sym(torch.from_numpy(S))
    close(tw, w)
    close(tQ, Q)


@pytest.mark.parametrize("d", [2, 3])
def test_bspline_matches_hot_tpu(rng, d):
    dx = 1.0 / 24
    x = rng.uniform(3 * dx, 20 * dx, (50, d))
    base, w, dw = jbs.quadratic_bspline_weights(jnp.asarray(x), dx)
    wn, gwn = jbs.tensor_weights(w, dw)
    tbase, tw, tdw = tbs.quadratic_bspline_weights(torch.from_numpy(x), dx)
    twn, tgwn = tbs.tensor_weights(tw, tdw)
    np.testing.assert_array_equal(tbase.numpy(), np.asarray(base))
    close(tw, w)
    close(tdw, dw)
    close(twn, wn)
    close(tgwn, gwn)
    np.testing.assert_array_equal(tbs.stencil_offsets(d).numpy(),
                                  np.asarray(jbs.stencil_offsets(d)))


@pytest.mark.parametrize("name", ["fixed_corotated", "stvk_hencky", "neo_hookean",
                                  "linear_corotated"])
@pytest.mark.parametrize("d", [2, 3])
def test_models_match_hot_tpu(rng, name, d):
    jmodel, tmodel = jcm.MODEL_REGISTRY[name], tcm.MODEL_REGISTRY[name]
    tol = 1e-12 if name in ("neo_hookean", "linear_corotated") else TOL
    F = matrices(rng, 48, d)
    n = F.shape[0]
    mu_s, lam_s = jcm.lame_parameters(1e6, 0.3)
    mu = np.full(n, mu_s) * rng.uniform(0.5, 1.5, n)
    lam = np.full(n, lam_s)
    dF = rng.standard_normal((n, d, d))
    jF, jmu, jlam = jnp.asarray(F), jnp.asarray(mu), jnp.asarray(lam)
    tF, tmu, tlam = torch.from_numpy(F), torch.from_numpy(mu), torch.from_numpy(lam)

    for project in (True, False):
        P, ctx = jax.vmap(lambda f, m, l: jcm.stress_and_hessian(
            jmodel, f, m, l, project=project))(jF, jmu, jlam)
        tP, tctx = tcm.stress_and_hessian(tmodel, tF, tmu, tlam, project=project)
        close(tP, P, tol)
        for field in ("U", "V", "A", "b_plus", "b_minus"):
            close(getattr(tctx, field), getattr(ctx, field), tol)
        dP = jax.vmap(jcm.apply_hessian)(ctx, jnp.asarray(dF))
        close(tcm.apply_hessian(tctx, torch.from_numpy(dF)), dP, tol)
        hctx = jax.vmap(lambda f, m, l: jcm.hessian_context(
            jmodel, f, m, l, project=project))(jF, jmu, jlam)
        tA = tcm.hessian_context(tmodel, tF, tmu, tlam, project=project).A
        close(tA, hctx.A, tol)

    psi = jax.vmap(lambda f, m, l: jcm.psi_from_F(jmodel, f, m, l))(jF, jmu, jlam)
    close(tcm.psi_from_F(tmodel, tF, tmu, tlam), psi, tol)
    P1 = jax.vmap(lambda f, m, l: jcm.first_piola(jmodel, f, m, l))(jF, jmu, jlam)
    close(tcm.first_piola(tmodel, tF, tmu, tlam), P1, tol)


def test_lame_parameters_match():
    assert tcm.lame_parameters(1e6, 0.3) == jcm.lame_parameters(1e6, 0.3)
