"""Scenes: the eleven builders of ``hot_tpu.scenes.registry``.

Each returns a dict with cfg (SimConfig), state (ParticleState on
`device`), model, colliders and plasticity, with hot_tpu's defaults, seeds,
materials, initial velocities and colliders. The jitter of the seeded
lattice comes from a torch.Generator seeded with the JAX scene's key, so
positions differ from the JAX package's (and level-set and mesh scenes keep
a slightly different count); to compare the two, carry a state across with
``sim.state.state_from_numpy``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from hot_tpu_torch.models.constitutive import MODEL_REGISTRY, lame_parameters
from hot_tpu_torch.sim.collision import SLIP, STICKY, AxisBox, HalfSpace
from hot_tpu_torch.sim.seeding import sample_box, sample_cylinder, sample_level_set
from hot_tpu_torch.sim.state import concatenate_states, make_particle_state
from hot_tpu_torch.utils.config import SimConfig


def _dtype(dtype) -> torch.dtype:
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


def _generator(seed: int) -> torch.Generator:
    g = torch.Generator(device="cpu")
    g.manual_seed(seed)
    return g


def _config(dim: int, res: int, gravity, dtype) -> SimConfig:
    return SimConfig(dim=dim, dx=1.0 / res, grid_res=(res,) * dim, gravity=gravity,
                     dtype=str(dtype).replace("torch.", ""))


def _full(state, value):
    return torch.full((state.n,), value, dtype=state.x.dtype, device=state.x.device)


def stress_state(state, cfg, mag: float = 8.0):
    """An impact-velocity field (radial compression toward the centre of
    the particles, plus a twist about z in 3D), so that a scene at rest
    makes Newton work from its first step."""
    c = torch.mean(state.x, dim=0)
    r = state.x - c
    v = -mag * r
    if cfg.dim == 3:
        v = v + mag * torch.stack([-r[:, 1], r[:, 0], torch.zeros_like(r[:, 2])], dim=-1)
    return state.replace(v=v.to(state.v.dtype))


def block_drop_2d(*, device, res: int = 64, E: float = 1e5, dtype=torch.float32):
    """2D elastic block dropped on a sticky floor (config 1)."""
    dtype = _dtype(dtype)
    cfg = _config(2, res, (0.0, -9.81), dtype)
    x, vol = sample_box(_generator(0), (0.3, 0.45), (0.7, 0.65), cfg.dx,
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
    cfg = _config(3, res, (0.0, 0.0, 0.0), dtype)
    x, vol = sample_box(_generator(1), (0.2, 0.4, 0.4), (0.8, 0.6, 0.6), cfg.dx,
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


def stacked_boxes_3d(*, device, res: int = 64, ppc: int = 8, dtype=torch.float32):
    """Config 4: three boxes of E = 1e4, 1e6, 1e8 stacked on a sticky floor
    (per-particle Lame parameters; the conditioning stress test)."""
    dtype = _dtype(dtype)
    cfg = _config(3, res, (0.0, -9.81, 0.0), dtype)
    states = []
    for i, E in enumerate((1e4, 1e6, 1e8)):
        y0 = 0.2 + i * 0.18
        x, vol = sample_box(_generator(10 + i), (0.35, y0, 0.35), (0.65, y0 + 0.14, 0.65),
                            cfg.dx, particles_per_cell=ppc, dtype=dtype, device=device)
        mu, lam = lame_parameters(E, 0.3)
        states.append(make_particle_state(x, particle_volume=vol, density=1000.0, mu=mu,
                                          lam=lam, dtype=dtype, device=device))
    colliders = (HalfSpace(kind=STICKY, origin=(0.0, 0.12, 0.0), n=(0.0, 1.0, 0.0)),)
    return dict(cfg=cfg, state=concatenate_states(states),
                model=MODEL_REGISTRY["fixed_corotated"], colliders=colliders, plasticity=None)


def _box_phi(x, lo, hi):
    lo = torch.as_tensor(lo, dtype=x.dtype, device=x.device)
    hi = torch.as_tensor(hi, dtype=x.dtype, device=x.device)
    q = torch.maximum(lo[None, :] - x, x - hi[None, :])
    outside = torch.linalg.norm(torch.clamp(q, min=0.0), dim=-1)
    inside = torch.clamp(q.amax(-1), max=0.0)
    return outside + inside


def _faceless_phi(x):
    """Head sphere, torso, two legs and two arms."""
    head = torch.linalg.norm(
        x - torch.tensor([0.5, 0.62, 0.5], dtype=x.dtype, device=x.device), dim=-1) - 0.08
    torso = _box_phi(x, (0.42, 0.38, 0.44), (0.58, 0.58, 0.56))
    leg1 = _box_phi(x, (0.43, 0.22, 0.45), (0.49, 0.40, 0.55))
    leg2 = _box_phi(x, (0.51, 0.22, 0.45), (0.57, 0.40, 0.55))
    arm1 = _box_phi(x, (0.34, 0.46, 0.46), (0.44, 0.54, 0.54))
    arm2 = _box_phi(x, (0.56, 0.46, 0.46), (0.66, 0.54, 0.54))
    return torch.minimum(torch.minimum(torch.minimum(head, torso), torch.minimum(leg1, leg2)),
                         torch.minimum(arm1, arm2))


def _soft_body_drop(x, vol, dtype, device, res, E):
    """The faceless scenes' material and floor."""
    mu, lam = lame_parameters(E, 0.35)
    state = make_particle_state(x, particle_volume=vol, density=1000.0, mu=mu, lam=lam,
                                dtype=dtype, device=device)
    colliders = (HalfSpace(kind=STICKY, origin=(0.0, 0.08, 0.0), n=(0.0, 1.0, 0.0)),)
    return dict(cfg=_config(3, res, (0.0, -9.81, 0.0), dtype), state=state,
                model=MODEL_REGISTRY["fixed_corotated"], colliders=colliders, plasticity=None)


def faceless_3d(*, device, res: int = 128, ppc: int = 8, E: float = 5e5, dtype=torch.float32):
    """Config 5-class soft character drop, the character an analytic union
    (see faceless_mesh_3d for the mesh-sampled variant)."""
    dtype = _dtype(dtype)
    x, vol = sample_level_set(_generator(7), _faceless_phi, (0.3, 0.2, 0.4), (0.7, 0.72, 0.6),
                              1.0 / res, particles_per_cell=ppc, dtype=dtype, device=device)
    return _soft_body_drop(x, vol, dtype, device, res, E)


def faceless_mesh_3d(*, device, res: int = 128, ppc: int = 8, E: float = 5e5,
                     obj_path: str = None, dtype=torch.float32):
    """The faceless drop with particles sampled inside a character triangle
    mesh (io.mesh.sample_mesh): the procedural OBJ of scenes.assets unless
    obj_path names another, lifted 0.1 above its own placement."""
    from hot_tpu_torch.io.mesh import sample_mesh
    from hot_tpu_torch.scenes.assets import faceless_obj_path

    dtype = _dtype(dtype)
    x, vol = sample_mesh(_generator(7), obj_path or faceless_obj_path(), 1.0 / res,
                         particles_per_cell=ppc, translate=(0.0, 0.1, 0.0), dtype=dtype,
                         device=device)
    return _soft_body_drop(x, vol, dtype, device, res, E)


def boards_3d(*, device, res: int = 64, ppc: int = 8, dtype=torch.float32):
    """Three thin stiff StVK-Hencky boards with von Mises yield dropped flat
    on a frictional slip floor (bending-dominated)."""
    dtype = _dtype(dtype)
    cfg = _config(3, res, (0.0, -9.81, 0.0), dtype)
    thick = max(3.0 * cfg.dx, 0.04)
    states = []
    for i in range(3):
        y0 = 0.3 + i * (thick + 0.08)
        x, vol = sample_box(_generator(20 + i), (0.25 + 0.04 * i, y0, 0.35),
                            (0.75 - 0.04 * i, y0 + thick, 0.65), cfg.dx, particles_per_cell=ppc,
                            dtype=dtype, device=device)
        mu, lam = lame_parameters(2e7, 0.35)
        states.append(make_particle_state(x, particle_volume=vol, density=800.0, mu=mu,
                                          lam=lam, dtype=dtype, device=device))
    state = concatenate_states(states)
    state = state.replace(yield_stress=_full(state, 5e4))
    colliders = (HalfSpace(kind=SLIP, friction=0.3, origin=(0.0, 0.2, 0.0), n=(0.0, 1.0, 0.0)),)
    return dict(cfg=cfg, state=state, model=MODEL_REGISTRY["stvk_hencky"], colliders=colliders,
                plasticity="von_mises")


def chain_2d(*, device, res: int = 96, E: float = 5e6, dtype=torch.float32):
    """Three stiff elastic rings (2D annuli) falling onto each other and a
    sticky floor: large rotations and ring-on-ring contact."""
    dtype = _dtype(dtype)
    cfg = _config(2, res, (0.0, -9.81), dtype)
    dx = cfg.dx
    r_out, r_in = 0.085, 0.055
    states = []
    for i, c in enumerate([(0.5, 0.75), (0.46, 0.55), (0.54, 0.35)]):
        def phi(p, c=c):
            d = torch.linalg.norm(p - torch.tensor(c, dtype=p.dtype, device=p.device)[None, :],
                                  dim=-1)
            return torch.maximum(d - r_out, r_in - d)

        lo = (c[0] - r_out - 2 * dx, c[1] - r_out - 2 * dx)
        hi = (c[0] + r_out + 2 * dx, c[1] + r_out + 2 * dx)
        x, vol = sample_level_set(_generator(30 + i), phi, lo, hi, dx, particles_per_cell=4,
                                  dtype=dtype, device=device)
        mu, lam = lame_parameters(E, 0.3)
        states.append(make_particle_state(x, particle_volume=vol, density=1200.0, mu=mu,
                                          lam=lam, dtype=dtype, device=device))
    colliders = (HalfSpace(kind=STICKY, origin=(0.0, 0.1), n=(0.0, 1.0)),)
    return dict(cfg=cfg, state=concatenate_states(states),
                model=MODEL_REGISTRY["fixed_corotated"], colliders=colliders, plasticity=None)


def sand_column_2d(*, device, res: int = 64, E: float = 3.5e5, dtype=torch.float32):
    """Drucker-Prager sand column collapsing on a frictional slip floor
    (StVK-Hencky elasticity)."""
    dtype = _dtype(dtype)
    cfg = _config(2, res, (0.0, -9.81), dtype)
    x, vol = sample_box(_generator(3), (0.42, 0.16), (0.58, 0.56), cfg.dx, particles_per_cell=4,
                        dtype=dtype, device=device)
    mu, lam = lame_parameters(E, 0.3)
    state = make_particle_state(x, particle_volume=vol, density=1600.0, mu=mu, lam=lam,
                                dtype=dtype, device=device)
    colliders = (HalfSpace(kind=SLIP, friction=0.4, origin=(0.0, 0.15), n=(0.0, 1.0)),)
    return dict(cfg=cfg, state=state, model=MODEL_REGISTRY["stvk_hencky"], colliders=colliders,
                plasticity="drucker_prager")


def snowball_drop_2d(*, device, res: int = 64, E: float = 1.4e5, dtype=torch.float32):
    """A snow ball (Stomakhin snow, Jp tracked) thrown down onto a sticky
    floor."""
    dtype = _dtype(dtype)
    cfg = _config(2, res, (0.0, -9.81), dtype)

    def phi(p):
        return torch.linalg.norm(
            p - torch.tensor([0.5, 0.6], dtype=p.dtype, device=p.device)[None, :], dim=-1) - 0.1

    x, vol = sample_level_set(_generator(4), phi, (0.38, 0.48), (0.62, 0.72), cfg.dx,
                              particles_per_cell=4, dtype=dtype, device=device)
    mu, lam = lame_parameters(E, 0.2)
    state = make_particle_state(x, particle_volume=vol, density=400.0, mu=mu, lam=lam,
                                velocity=[0.0, -2.0], dtype=dtype, device=device)
    colliders = (HalfSpace(kind=STICKY, origin=(0.0, 0.15), n=(0.0, 1.0)),)
    return dict(cfg=cfg, state=state, model=MODEL_REGISTRY["fixed_corotated"],
                colliders=colliders, plasticity="snow")


def twisting_bar_vonmises_3d(*, device, res: int = 64, E: float = 1e6, ppc: int = 8,
                             yield_stress: float = 2e4, dtype=torch.float32):
    """The twisting bar in StVK-Hencky with von Mises yield."""
    out = twisting_bar_3d(device=device, res=res, E=E, ppc=ppc, dtype=dtype)
    out["state"] = out["state"].replace(yield_stress=_full(out["state"], yield_stress))
    out["model"] = MODEL_REGISTRY["stvk_hencky"]
    out["plasticity"] = "von_mises"
    return out


def wheel_3d(*, device, res: int = 64, E: float = 1e6, ppc: int = 8,
             yield_stress: float = 1.5e4, omega: float = 8.0 * math.pi, dtype=torch.float32):
    """A spinning StVK-Hencky wheel with von Mises yield (a cylinder-sampled
    disc in rigid spin about its axis) dropped on a frictional slip floor."""
    dtype = _dtype(dtype)
    cfg = _config(3, res, (0.0, -9.81, 0.0), dtype)
    center = np.asarray([0.5, 0.42, 0.5])
    axis = np.asarray([0.0, 0.0, 1.0])
    x, vol = sample_cylinder(_generator(12), center, axis, radius=0.16, half_height=0.05,
                             dx=cfg.dx, particles_per_cell=ppc, dtype=dtype, device=device)
    mu, lam = lame_parameters(E, 0.3)
    state = make_particle_state(x, particle_volume=vol, density=1200.0, mu=mu, lam=lam,
                                dtype=dtype, device=device)
    # rigid spin about the wheel's axis: v = omega x r
    rel = state.x - torch.as_tensor(center, dtype=dtype, device=state.x.device)[None, :]
    w = torch.as_tensor(axis * omega, dtype=dtype, device=state.x.device)
    v0 = torch.linalg.cross(w.expand_as(rel), rel, dim=-1)
    state = state.replace(v=v0, yield_stress=_full(state, yield_stress))
    colliders = (HalfSpace(kind=SLIP, friction=0.5, origin=(0.0, 0.2, 0.0), n=(0.0, 1.0, 0.0)),)
    return dict(cfg=cfg, state=state, model=MODEL_REGISTRY["stvk_hencky"], colliders=colliders,
                plasticity="von_mises")


SCENES = {
    "block_drop_2d": block_drop_2d,
    "wheel_3d": wheel_3d,
    "twisting_bar_3d": twisting_bar_3d,
    "twisting_bar_vonmises_3d": twisting_bar_vonmises_3d,
    "stacked_boxes_3d": stacked_boxes_3d,
    "boards_3d": boards_3d,
    "chain_2d": chain_2d,
    "faceless_3d": faceless_3d,
    "faceless_mesh_3d": faceless_mesh_3d,
    "sand_column_2d": sand_column_2d,
    "snowball_drop_2d": snowball_drop_2d,
}


def build_scene(name: str, *, device, **kwargs):
    if name not in SCENES:
        raise KeyError(f"unknown scene '{name}'; have {sorted(SCENES)}")
    return SCENES[name](device=device, **kwargs)
