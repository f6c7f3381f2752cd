"""Conservation queries on a particle state: momentum, mass, energies and
the centre of mass.

Counterpart of ``hot_tpu.sim.analysis``; each returns a tensor on the
state's device.
"""

from __future__ import annotations

import torch

from hot_tpu_torch.models import constitutive as cm
from hot_tpu_torch.sim.state import ParticleState


def total_momentum(state: ParticleState):
    """(d,) total linear momentum."""
    return torch.sum(state.m[:, None] * state.v, dim=0)


def total_mass(state: ParticleState):
    return torch.sum(state.m)


def kinetic_energy(state: ParticleState):
    return 0.5 * torch.sum(state.m * torch.sum(state.v * state.v, dim=-1))


def potential_energy(state: ParticleState, model):
    return torch.sum(state.V0 * cm.psi_from_F(model, state.F, state.mu, state.lam))


def gravitational_energy(state: ParticleState, gravity):
    g = torch.as_tensor(gravity, dtype=state.x.dtype, device=state.x.device)
    return -torch.sum(state.m[:, None] * state.x * g[None, :])


def center_of_mass(state: ParticleState):
    return torch.sum(state.m[:, None] * state.x, dim=0) / torch.clamp(torch.sum(state.m),
                                                                      min=1e-30)
