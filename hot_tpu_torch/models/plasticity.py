"""Plasticity return maps applied to the trial deformation gradient.

Counterpart of ``hot_tpu.models.plasticity``: von Mises on Hencky strain,
Stomakhin snow and Drucker-Prager sand, each a branch-free function
F_trial -> F_projected, batched over leading dimensions: F (..., d, d),
the per-particle parameters (...). The step applies them after the F
update (``sim.simulation``).

The singular values come from ``ops.svd.svd`` with hot_tpu's signed-sigma
convention. Von Mises and Drucker-Prager work on log(max(|sigma|, 1e-6))
and rebuild with exp, so an inverted trial F comes back with positive
singular values, as in hot_tpu.
"""

from __future__ import annotations

import math

import torch

from hot_tpu_torch.ops.svd import svd


def _rebuild(U, sigma, V):
    return (U * sigma.unsqueeze(-2)) @ V.transpose(-1, -2)


def _hencky(F):
    """(U, V, eps, tr, dev, dev_norm) of the Hencky strain eps = log|sigma|."""
    d = F.shape[-1]
    U, sigma, V = svd(F)
    eps = torch.log(torch.clamp(sigma.abs(), min=1e-6))
    tr = eps.sum(-1)
    dev = eps - (tr / d).unsqueeze(-1)
    dev_norm = torch.sqrt(torch.sum(dev * dev, dim=-1))
    return U, V, eps, tr, dev, dev_norm


def _flow(eps, dev, dev_norm, dg):
    """eps - max(dg, 0) dev / max(|dev|, 1e-12); 0 where dg = -inf."""
    return eps - torch.clamp(dg, min=0.0).unsqueeze(-1) * dev \
        / torch.clamp(dev_norm, min=1e-12).unsqueeze(-1)


class VonMisesHencky:
    """Von Mises yield on Hencky strain: f = |dev(eps)| - yield / (2 mu) <= 0."""

    name = "von_mises_hencky"

    @staticmethod
    def project(F, mu, lam, yield_stress):
        U, V, eps, _, dev, dev_norm = _hencky(F)
        dg = dev_norm - yield_stress / (2.0 * mu)
        return _rebuild(U, torch.exp(_flow(eps, dev, dev_norm, dg)), V)


class SnowPlasticity:
    """Stomakhin et al. 2013 snow: singular values clamped to
    [1 - theta_c, 1 + theta_s]. Returns (F_new, jp_ratio), the factor the
    caller multiplies Jp by."""

    name = "snow"

    @staticmethod
    def project(F, theta_c=2.5e-2, theta_s=7.5e-3):
        U, sigma, V = svd(F)
        clamped = torch.clamp(sigma, 1.0 - theta_c, 1.0 + theta_s)
        # |det|: an inverted trial F has prod(sigma) < 0 (signed sigma)
        jp_ratio = torch.prod(sigma, dim=-1).abs() / torch.clamp(
            torch.prod(clamped, dim=-1), min=1e-12)
        return _rebuild(U, clamped, V), jp_ratio


class DruckerPrager:
    """Drucker-Prager sand (Klar et al. 2016) on Hencky strain; expansion
    (tr eps > 0) projects to the cone tip eps = 0."""

    name = "drucker_prager"

    @staticmethod
    def alpha_from_friction_angle(phi_degrees: float) -> float:
        s = math.sin(math.radians(phi_degrees))
        return math.sqrt(2.0 / 3.0) * 2.0 * s / (3.0 - s)

    @staticmethod
    def project(F, mu, lam, alpha):
        d = F.shape[-1]
        U, V, eps, tr, dev, dev_norm = _hencky(F)
        dg = dev_norm + alpha * tr * (d * lam + 2.0 * mu) / (2.0 * mu)
        eps_cone = _flow(eps, dev, dev_norm, dg)
        eps_proj = torch.where((tr > 0.0).unsqueeze(-1), torch.zeros_like(eps), eps_cone)
        return _rebuild(U, torch.exp(eps_proj), V)


PLASTICITY_REGISTRY = {p.name: p for p in (VonMisesHencky, SnowPlasticity, DruckerPrager)}
