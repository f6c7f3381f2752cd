"""Isotropic hyperelastic models in diagonal (singular-value) space.

Counterpart of ``hot_tpu.models.constitutive``: fixed corotated,
Neo-Hookean, StVK-Hencky and linear corotated, each a model of the
linearization kernel too. Each model is one energy
``psi_hat(sigma, mu, lam)`` of the singular values plus its analytic
derivatives (where a model clamps sigma, the clamp's derivative is 0 below
it, as jax differentiates ``jnp.maximum``); everything else is derived
uniformly:

  * P(F) = U diag(g) V^T with g = dpsi_hat/dsigma;
  * dP/dF acts through the diagonal-space Hessian: the (d, d) block
    A = d2psi_hat/dsigma2 and, per off-diagonal pair (i, j), the
    eigenvalues b- = (g_i - g_j)/(s_i - s_j) (shear stretch) and
    b+ = (g_i + g_j)/(s_i + s_j) (rotation);
  * SPD projection clamps the eigenvalues of A and b+/- at 0.

b- is 0/0 at repeated singular values, which is every particle at rest, so
each model gives it in a closed form with no division by s_i - s_j.

All functions are batched over leading dimensions: F (..., d, d),
sigma (..., d), mu and lam (...).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from hot_tpu_torch.ops.svd import eigh_sym, svd


def lame_parameters(E, nu):
    """(mu, lambda) from Young's modulus and Poisson ratio."""
    mu = E / (2.0 * (1.0 + nu))
    lam = E * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))
    return mu, lam


def _pairs(d: int):
    return [(0, 1)] if d == 2 else [(0, 1), (0, 2), (1, 2)]


def _hybrid_bm(sigma, g, closed):
    """Per pair: the direct quotient (g_i - g_j)/(s_i - s_j) where the
    singular values are well separated (also the only branch that is right
    where an energy clamp is active), the model's closed form where they
    nearly repeat, and 0 where they nearly repeat below the clamp."""
    out = []
    for k, (i, j) in enumerate(_pairs(sigma.shape[-1])):
        si, sj = sigma[..., i], sigma[..., j]
        delta = si - sj
        scale = si.abs() + sj.abs() + 1.0
        well_sep = delta.abs() > 1e-3 * scale
        delta_safe = torch.where(well_sep, delta, torch.ones_like(delta))
        direct = (g[..., i] - g[..., j]) / delta_safe
        smooth = torch.minimum(si, sj) > 2e-6
        out.append(torch.where(well_sep, direct,
                               torch.where(smooth, closed[..., k],
                                           torch.zeros_like(direct))))
    return torch.stack(out, dim=-1)


def _others_product(sigma):
    """(d J / d sigma_i) = product of the other singular values, and the
    second derivatives d2J/(ds_i ds_j) for i != j."""
    if sigma.shape[-1] == 2:
        s0, s1 = sigma[..., 0], sigma[..., 1]
        return torch.stack([s1, s0], -1), {(0, 1): torch.ones_like(s0)}
    s0, s1, s2 = sigma[..., 0], sigma[..., 1], sigma[..., 2]
    Jp = torch.stack([s1 * s2, s0 * s2, s0 * s1], -1)
    return Jp, {(0, 1): s2, (0, 2): s1, (1, 2): s0}


class FixedCorotated:
    """Psi = mu sum((s_i - 1)^2) + lam/2 (J - 1)^2 (Stomakhin et al. 2012)."""

    name = "fixed_corotated"

    @staticmethod
    def psi_hat(sigma, mu, lam):
        J = torch.prod(sigma, dim=-1)
        return mu * torch.sum((sigma - 1.0) ** 2, dim=-1) + 0.5 * lam * (J - 1.0) ** 2

    @staticmethod
    def derivatives(sigma, mu, lam):
        """(g (..., d), A (..., d, d)) = first and second sigma-derivatives."""
        d = sigma.shape[-1]
        J = torch.prod(sigma, dim=-1)
        Jp, d2J = _others_product(sigma)
        mu_, lam_, Jm1 = mu[..., None], lam[..., None], (J - 1.0)[..., None]
        g = 2.0 * mu_ * (sigma - 1.0) + lam_ * Jm1 * Jp
        A = lam[..., None, None] * Jp[..., :, None] * Jp[..., None, :]
        A = A + torch.diag_embed(2.0 * mu_.expand_as(sigma))
        for (i, j), v in d2J.items():
            off = lam * (J - 1.0) * v
            A[..., i, j] = A[..., i, j] + off
            A[..., j, i] = A[..., j, i] + off
        return g, A

    @staticmethod
    def bm_hat(sigma, g, mu, lam):
        """Exact (g_i - g_j)/(s_i - s_j): 2 mu - lam (J - 1) s_k in 3D (k the
        third axis), 2 mu - lam (J - 1) in 2D. Valid for every sigma."""
        J = torch.prod(sigma, dim=-1)
        if sigma.shape[-1] == 2:
            return (2.0 * mu - lam * (J - 1.0))[..., None]
        return torch.stack([2.0 * mu - lam * (J - 1.0) * sigma[..., 2],
                            2.0 * mu - lam * (J - 1.0) * sigma[..., 1],
                            2.0 * mu - lam * (J - 1.0) * sigma[..., 0]], -1)


class StvkHencky:
    """Psi = mu ||log S||^2 + lam/2 tr(log S)^2, with sigma clamped at 1e-6."""

    name = "stvk_hencky"

    @staticmethod
    def psi_hat(sigma, mu, lam):
        eps = torch.log(torch.clamp(sigma, min=1e-6))
        return mu * torch.sum(eps * eps, dim=-1) + 0.5 * lam * torch.sum(eps, dim=-1) ** 2

    @staticmethod
    def derivatives(sigma, mu, lam):
        """(g, A); the derivative of the clamp is 0 below it."""
        free = (sigma > 1e-6).to(sigma.dtype)
        s = torch.clamp(sigma, min=1e-6)
        eps = torch.log(s)
        tr = eps.sum(-1, keepdim=True)
        mu_, lam_ = mu[..., None], lam[..., None]
        t = 2.0 * mu_ * eps + lam_ * tr
        g = free * t / s
        diag = free * ((2.0 * mu_ + lam_) - t) / (s * s)
        A = (lam[..., None, None] * (free / s)[..., :, None] * (free / s)[..., None, :])
        A = A - torch.diag_embed(torch.diagonal(A, dim1=-2, dim2=-1)) + torch.diag_embed(diag)
        return g, A

    @staticmethod
    def bm_hat(sigma, g, mu, lam):
        """Closed form through the log difference quotient
        L = (log s_i - log s_j)/(s_i - s_j) = 2 atanh(z)/(s_i + s_j),
        z = (s_i - s_j)/(s_i + s_j), atanh(z)/z by series for small z and
        through log1p otherwise (log((1+z)/(1-z)) loses ~eps/z in fp32):
          (g_i - g_j)/(s_i - s_j) = (2 mu (s_j L - log s_j) - lam tr)/(s_i s_j);
        near inversion _hybrid_bm takes the direct quotient instead."""
        s = torch.clamp(sigma, min=1e-6)
        tr = torch.log(s).sum(-1)
        out = []
        for i, j in _pairs(s.shape[-1]):
            si, sj = s[..., i], s[..., j]
            z = (si - sj) / (si + sj)
            small = z.abs() < 1e-4
            z_safe = torch.where(small, torch.ones_like(z), z)
            atz = torch.where(small, 1.0 + z * z / 3.0,
                              (torch.log1p(z_safe) - torch.log1p(-z_safe)) / (2.0 * z_safe))
            L = 2.0 / (si + sj) * atz
            out.append((2.0 * mu * (sj * L - torch.log(sj)) - lam * tr) / (si * sj))
        return _hybrid_bm(sigma, g, torch.stack(out, -1))


class NeoHookean:
    """Psi = mu/2 (sum s^2 - d) - mu log J + lam/2 log^2 J, with sigma
    clamped at 1e-6 so log J stays finite through inversion."""

    name = "neo_hookean"

    @staticmethod
    def psi_hat(sigma, mu, lam):
        s = torch.clamp(sigma, min=1e-6)
        logJ = torch.log(s).sum(-1)
        return 0.5 * mu * (torch.sum(s * s, dim=-1) - s.shape[-1]) - mu * logJ \
            + 0.5 * lam * logJ ** 2

    @staticmethod
    def derivatives(sigma, mu, lam):
        """g_i = mu s_i + (lam log J - mu)/s_i; A_ii = mu + (mu + lam -
        lam log J)/s_i^2, A_ij = lam/(s_i s_j); the clamp's derivative is 0
        below it."""
        free = (sigma > 1e-6).to(sigma.dtype)
        s = torch.clamp(sigma, min=1e-6)
        logJ = torch.log(s).sum(-1, keepdim=True)
        mu_, lam_ = mu[..., None], lam[..., None]
        g = free * (mu_ * s + (lam_ * logJ - mu_) / s)
        diag = free * (mu_ + (mu_ + lam_ - lam_ * logJ) / (s * s))
        A = (lam[..., None, None] * (free / s)[..., :, None] * (free / s)[..., None, :])
        A = A - torch.diag_embed(torch.diagonal(A, dim1=-2, dim2=-1)) + torch.diag_embed(diag)
        return g, A

    @staticmethod
    def bm_hat(sigma, g, mu, lam):
        """Closed form mu + (mu - lam log J)/(s_i s_j) in the unclamped
        branch, through _hybrid_bm."""
        s = torch.clamp(sigma, min=1e-6)
        logJ = torch.log(s).sum(-1)
        closed = torch.stack([mu + (mu - lam * logJ) / (s[..., i] * s[..., j])
                              for i, j in _pairs(s.shape[-1])], -1)
        return _hybrid_bm(sigma, g, closed)


class LinearCorotated:
    """Psi = mu ||S - I||^2 + lam/2 tr(S - I)^2 (small-strain, corotated)."""

    name = "linear_corotated"

    @staticmethod
    def psi_hat(sigma, mu, lam):
        e = sigma - 1.0
        return mu * torch.sum(e * e, dim=-1) + 0.5 * lam * torch.sum(e, dim=-1) ** 2

    @staticmethod
    def derivatives(sigma, mu, lam):
        """g = 2 mu (s - 1) + lam tr(s - 1); A = 2 mu I + lam 1 1^T."""
        e = sigma - 1.0
        mu_, lam_ = mu[..., None], lam[..., None]
        g = 2.0 * mu_ * e + lam_ * e.sum(-1, keepdim=True)
        A = lam[..., None, None] * torch.ones(sigma.shape + sigma.shape[-1:], dtype=sigma.dtype,
                                              device=sigma.device)
        return g, A + torch.diag_embed(2.0 * mu_.expand_as(sigma))

    @staticmethod
    def bm_hat(sigma, g, mu, lam):
        """(g_i - g_j)/(s_i - s_j) = 2 mu for every pair."""
        return torch.stack([2.0 * mu] * len(_pairs(sigma.shape[-1])), -1).to(sigma.dtype)


MODEL_REGISTRY = {m.name: m for m in (FixedCorotated, NeoHookean, StvkHencky, LinearCorotated)}


class HessianContext(NamedTuple):
    """Cached per-particle diagonal-space Hessian (possibly SPD-projected)."""

    U: torch.Tensor        # (..., d, d)
    V: torch.Tensor        # (..., d, d)
    A: torch.Tensor        # (..., d, d) normal block
    b_plus: torch.Tensor   # (..., n_pairs) rotation-mode eigenvalue per pair
    b_minus: torch.Tensor  # (..., n_pairs) shear-stretch eigenvalue per pair


def _pair_eigenvalues(model, sigma, g, mu, lam):
    """(b_plus, b_minus); b_plus's denominator s_i + s_j only vanishes under
    total collapse, where a sign-preserving clamped division suffices."""
    eps = 1e-10 if sigma.dtype == torch.float64 else 1e-6
    b_plus = []
    for i, j in _pairs(sigma.shape[-1]):
        den = sigma[..., i] + sigma[..., j]
        sign = torch.where(den >= 0, 1.0, -1.0).to(sigma.dtype)
        b_plus.append((g[..., i] + g[..., j]) * sign / torch.clamp(den.abs(), min=eps))
    return torch.stack(b_plus, -1), model.bm_hat(sigma, g, mu, lam)


def psi_from_F(model, F, mu, lam):
    """Energy density Psi(F)."""
    _, sigma, _ = svd(F)
    return model.psi_hat(sigma, mu, lam)


def first_piola(model, F, mu, lam):
    """P(F) = U diag(g) V^T."""
    U, sigma, V = svd(F)
    g, _ = model.derivatives(sigma, mu, lam)
    return (U * g.unsqueeze(-2)) @ V.transpose(-1, -2)


def _context(model, U, sigma, V, mu, lam, project):
    g, A = model.derivatives(sigma, mu, lam)
    A = 0.5 * (A + A.transpose(-1, -2))
    b_plus, b_minus = _pair_eigenvalues(model, sigma, g, mu, lam)
    if project:
        w, Q = eigh_sym(A)
        A = (Q * torch.clamp(w, min=0.0).unsqueeze(-2)) @ Q.transpose(-1, -2)
        b_plus = torch.clamp(b_plus, min=0.0)
        b_minus = torch.clamp(b_minus, min=0.0)
    return g, HessianContext(U=U, V=V, A=A, b_plus=b_plus, b_minus=b_minus)


def hessian_context(model, F, mu, lam, project: bool = True) -> HessianContext:
    """The diagonal-space Hessian context; project=True gives the
    SPD-projected dP/dF Newton uses."""
    U, sigma, V = svd(F)
    return _context(model, U, sigma, V, mu, lam, project)[1]


def stress_and_hessian(model, F, mu, lam, project: bool = True):
    """(P(F), HessianContext) sharing one SVD."""
    U, sigma, V = svd(F)
    g, ctx = _context(model, U, sigma, V, mu, lam, project)
    P = (U * g.unsqueeze(-2)) @ V.transpose(-1, -2)
    return P, ctx


def apply_hessian(ctx: HessianContext, dF):
    """delta_P = (dP/dF) : dF through the cached diagonal-space context."""
    d = dF.shape[-1]
    W = ctx.U.transpose(-1, -2) @ dF @ ctx.V
    Wd = torch.diagonal(W, dim1=-2, dim2=-1)
    dP_hat = torch.diag_embed((ctx.A @ Wd.unsqueeze(-1)).squeeze(-1))
    for k, (i, j) in enumerate(_pairs(d)):
        b11 = 0.5 * (ctx.b_plus[..., k] + ctx.b_minus[..., k])
        b12 = 0.5 * (ctx.b_minus[..., k] - ctx.b_plus[..., k])
        dP_hat[..., i, j] = b11 * W[..., i, j] + b12 * W[..., j, i]
        dP_hat[..., j, i] = b12 * W[..., i, j] + b11 * W[..., j, i]
    return ctx.U @ dP_hat @ ctx.V.transpose(-1, -2)
