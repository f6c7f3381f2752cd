"""Particle state: named per-particle tensors.

Counterpart of ``hot_tpu.sim.state``: the same fields, with the per-particle
matrices C and F stored flat (n, d*d) row-major and viewed as (n, d, d)
through the ``C``/``F`` properties.

A batch of B members of equal particle count (``stack_states``; hot_tpu's
``jax.vmap`` over ``ParticleState``) carries a leading member dimension on
every field: x (B, n, d), mu (B, n), and so on.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional

import numpy as np
import torch

FIELDS = ("x", "v", "Cf", "Ff", "m", "V0", "mu", "lam", "yield_stress", "Jp")


@dataclasses.dataclass
class ParticleState:
    """All per-particle tensors. Shapes: n particles, d spatial dims, and a
    leading member dimension B in a batch."""

    x: torch.Tensor             # (n, d) positions
    v: torch.Tensor             # (n, d) velocities
    Cf: torch.Tensor            # (n, d*d) APIC affine velocity field, row-major
    Ff: torch.Tensor            # (n, d*d) elastic deformation gradient, row-major
    m: torch.Tensor             # (n,) mass
    V0: torch.Tensor            # (n,) initial volume
    mu: torch.Tensor            # (n,) Lame mu
    lam: torch.Tensor           # (n,) Lame lambda
    yield_stress: torch.Tensor  # (n,) plasticity parameter
    Jp: torch.Tensor            # (n,) plastic volume ratio

    @property
    def n(self) -> int:
        return self.x.shape[-2]

    @property
    def batch(self) -> Optional[int]:
        """The number of members of a batch, None for one state."""
        return self.x.shape[0] if self.x.ndim == 3 else None

    @property
    def dim(self) -> int:
        return self.x.shape[-1]

    @property
    def C(self) -> torch.Tensor:
        return self.Cf.reshape(self.Cf.shape[:-1] + (self.dim, self.dim))

    @property
    def F(self) -> torch.Tensor:
        return self.Ff.reshape(self.Ff.shape[:-1] + (self.dim, self.dim))

    def replace(self, **kw) -> "ParticleState":
        """dataclasses.replace that also takes C=(n, d, d) or F=(n, d, d)."""
        for mat, flat in (("C", "Cf"), ("F", "Ff")):
            if mat in kw:
                M = kw.pop(mat)
                kw[flat] = M.reshape(M.shape[:-2] + (M.shape[-2] * M.shape[-1],))
        return dataclasses.replace(self, **kw)

    def to_numpy(self) -> dict:
        return {f: getattr(self, f).detach().cpu().numpy() for f in FIELDS}


def make_particle_state(x, *, velocity=None, density: float = 1000.0,
                        particle_volume: Optional[float] = None, mu=None, lam=None,
                        E: float = 1e5, nu: float = 0.3, yield_stress: float = math.inf,
                        dtype=torch.float32, device="cuda") -> ParticleState:
    """A rest-state particle set at positions x with a shared volume."""
    x = torch.as_tensor(x, dtype=dtype, device=device)
    n, d = x.shape
    if particle_volume is None:
        raise ValueError("particle_volume is required (V0 per particle)")
    if mu is None or lam is None:
        from hot_tpu_torch.models.constitutive import lame_parameters

        mu, lam = lame_parameters(E, nu)

    def full(value):
        return torch.as_tensor(value, dtype=dtype, device=device).expand(n).clone()

    v = torch.zeros((n, d), dtype=dtype, device=device)
    if velocity is not None:
        v = torch.as_tensor(velocity, dtype=dtype, device=device).expand(n, d).clone()
    eye = torch.eye(d, dtype=dtype, device=device).reshape(1, d * d)
    return ParticleState(
        x=x, v=v, Cf=torch.zeros((n, d * d), dtype=dtype, device=device),
        Ff=eye.expand(n, d * d).clone(), m=full(density * particle_volume),
        V0=full(particle_volume), mu=full(mu), lam=full(lam),
        yield_stress=full(yield_stress), Jp=full(1.0),
    )


def concatenate_states(states) -> ParticleState:
    """The particle sets of `states` as one (multi-object scenes)."""
    return ParticleState(**{f: torch.cat([getattr(s, f) for s in states]) for f in FIELDS})


def stack_states(states) -> ParticleState:
    """The batch of `states` (each of the same particle count), stacked
    along a leading member dimension."""
    counts = {s.n for s in states}
    if len(counts) != 1 or any(s.batch is not None for s in states):
        raise ValueError(f"a batch stacks single states of one particle count, got {counts}")
    return ParticleState(**{f: torch.stack([getattr(s, f) for s in states]) for f in FIELDS})


def unstack_states(state: ParticleState):
    """The members of a batch, as single states (views)."""
    if state.batch is None:
        raise ValueError("unstack_states takes a batch (a leading member dimension)")
    return [ParticleState(**{f: getattr(state, f)[b] for f in FIELDS})
            for b in range(state.batch)]


def state_from_numpy(arrays: Mapping[str, np.ndarray], device, dtype) -> ParticleState:
    """A ParticleState from numpy arrays of every field (the field names of
    ``hot_tpu.sim.state.ParticleState``), e.g. to carry a state across; with
    a leading member dimension on every field (hot_tpu's vmapped state), a
    batch."""
    return ParticleState(**{
        f: torch.tensor(np.asarray(arrays[f]), dtype=dtype, device=device)
        for f in FIELDS})
