"""Scenes: the 2D block drop and the 3D twisting bar.

Counterpart of the first two builders of ``hot_tpu.scenes.registry``. Each
returns a dict with cfg (SimConfig), state (ParticleState on `device`),
model, colliders and plasticity. The jitter of the seeded lattice comes
from a torch.Generator seeded with the JAX scene's key, so positions differ
from the JAX package's; to compare the two, carry a state across with
``sim.state.state_from_numpy``.
"""

from __future__ import annotations

import math

import torch

from hot_tpu_torch.models.constitutive import MODEL_REGISTRY, lame_parameters
from hot_tpu_torch.sim.collision import STICKY, AxisBox, HalfSpace
from hot_tpu_torch.sim.seeding import sample_box
from hot_tpu_torch.sim.state import make_particle_state
from hot_tpu_torch.utils.config import SimConfig


def _dtype(dtype) -> torch.dtype:
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


def _generator(seed: int) -> torch.Generator:
    g = torch.Generator(device="cpu")
    g.manual_seed(seed)
    return g


def block_drop_2d(*, device, res: int = 64, E: float = 1e5, dtype=torch.float32):
    """2D elastic block dropped on a sticky floor (config 1)."""
    dtype = _dtype(dtype)
    dx = 1.0 / res
    cfg = SimConfig(dim=2, dx=dx, grid_res=(res, res), gravity=(0.0, -9.81),
                    dtype=str(dtype).replace("torch.", ""))
    x, vol = sample_box(_generator(0), (0.3, 0.45), (0.7, 0.65), dx,
                        particles_per_cell=4, dtype=dtype, device=device)
    mu, lam = lame_parameters(E, 0.3)
    state = make_particle_state(x, particle_volume=vol, density=1000.0, mu=mu, lam=lam,
                                dtype=dtype, device=device)
    colliders = (HalfSpace(kind=STICKY, origin=(0.0, 0.15), n=(0.0, 1.0)),)
    return dict(cfg=cfg, state=state, model=MODEL_REGISTRY["fixed_corotated"],
                colliders=colliders, plasticity=None)


def _spin(sign: float, omega: float, center):
    def motion(t):
        f64 = torch.float64
        return (torch.zeros(3, dtype=f64), torch.tensor([sign * omega, 0.0, 0.0], dtype=f64),
                torch.tensor(center, dtype=f64))

    return motion


def twisting_bar_3d(*, device, res: int = 64, E: float = 1e6, omega: float = 4.0 * math.pi,
                    ppc: int = 8, dtype=torch.float32):
    """3D fixed-corotated bar twisted by counter-rotating sticky end clamps
    (HOT's "twist", configs 2/3)."""
    dtype = _dtype(dtype)
    dx = 1.0 / res
    cfg = SimConfig(dim=3, dx=dx, grid_res=(res, res, res), gravity=(0.0, 0.0, 0.0),
                    dtype=str(dtype).replace("torch.", ""))
    x, vol = sample_box(_generator(1), (0.2, 0.4, 0.4), (0.8, 0.6, 0.6), dx,
                        particles_per_cell=ppc, dtype=dtype, device=device)
    mu, lam = lame_parameters(E, 0.3)
    state = make_particle_state(x, particle_volume=vol, density=1000.0, mu=mu, lam=lam,
                                dtype=dtype, device=device)
    center = (0.5, 0.5, 0.5)
    colliders = (
        AxisBox(kind=STICKY, lo=(0.0, 0.3, 0.3), hi=(0.25, 0.7, 0.7),
                motion=_spin(+1.0, omega, center)),
        AxisBox(kind=STICKY, lo=(0.75, 0.3, 0.3), hi=(1.0, 0.7, 0.7),
                motion=_spin(-1.0, omega, center)),
    )
    return dict(cfg=cfg, state=state, model=MODEL_REGISTRY["fixed_corotated"],
                colliders=colliders, plasticity=None)


SCENES = {"block_drop_2d": block_drop_2d, "twisting_bar_3d": twisting_bar_3d}


def build_scene(name: str, *, device, **kwargs):
    if name not in SCENES:
        raise KeyError(f"unknown scene '{name}'; have {sorted(SCENES)}")
    return SCENES[name](device=device, **kwargs)
