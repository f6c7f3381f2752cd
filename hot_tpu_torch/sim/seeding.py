"""Particle seeding: jittered lattices filling a box, a level set, a
sphere or a capped cylinder.

Counterpart of ``hot_tpu.sim.seeding``. The lattice is the same; the jitter
comes from a ``torch.Generator``, so positions differ from the JAX
package's (which draws them from ``jax.random``) for the same seed. A level
set keeps the lattice points where phi < 0 (``level_set_mask``), evaluated
in the points' dtype on their device.
"""

from __future__ import annotations

import numpy as np
import torch

from hot_tpu_torch.sim.collision import Cylinder


def sample_box(generator: torch.Generator, lo, hi, dx: float,
               particles_per_cell: int, dtype=torch.float32, device="cuda"):
    """Jittered-lattice samples filling [lo, hi]: (positions (n, dim), the
    per-particle volume dx^dim / particles_per_cell). Each dx-cell is cut
    into per-axis sub-cells (counts factor particles_per_cell greedily) with
    one sample each, jittered by up to 0.45 sub-cell per axis."""
    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)
    dim = lo.shape[0]
    k_axes = []
    rem = max(int(particles_per_cell), 1)
    for i in range(dim):
        k = int(np.ceil(rem ** (1.0 / (dim - i))))
        k_axes.append(k)
        rem = max(1, rem // k)
    sub_dx = dx / np.asarray(k_axes)
    counts = np.maximum(((hi - lo) / sub_dx).round().astype(int), 1)
    axes = [np.arange(c) * sub_dx[i] + lo[i] + 0.5 * sub_dx[i] for i, c in enumerate(counts)]
    mesh = np.meshgrid(*axes, indexing="ij")
    centers = np.stack([m.reshape(-1) for m in mesh], axis=-1)
    u = torch.rand(centers.shape, generator=generator, dtype=torch.float32,
                   device=generator.device)
    jitter = (u * 0.9 - 0.45) * torch.as_tensor(sub_dx, dtype=torch.float32,
                                                 device=generator.device)
    x = torch.as_tensor(centers, dtype=dtype, device=device) + jitter.to(device=device, dtype=dtype)
    return x, float(np.prod(sub_dx))


def level_set_mask(phi, x):
    """The points of x (n, d) inside the level set: phi(x) < 0."""
    return phi(x) < 0.0


def sample_level_set(generator: torch.Generator, phi, lo, hi, dx: float,
                     particles_per_cell: int, dtype=torch.float32, device="cuda"):
    """The samples of the box [lo, hi] inside phi: (positions, volume)."""
    x, volume = sample_box(generator, lo, hi, dx, particles_per_cell, dtype, device)
    return x[level_set_mask(phi, x)], volume


def sample_sphere(generator: torch.Generator, center, radius: float, dx: float,
                  particles_per_cell: int, dtype=torch.float32, device="cuda"):
    """Samples inside a sphere."""
    center = np.asarray(center, np.float64)

    def phi(x):
        return torch.linalg.norm(x - torch.as_tensor(center, dtype=x.dtype, device=x.device),
                                 dim=-1) - radius

    return sample_level_set(generator, phi, center - radius, center + radius, dx,
                            particles_per_cell, dtype, device)


def sample_cylinder(generator: torch.Generator, center, axis, radius: float,
                    half_height: float, dx: float, particles_per_cell: int,
                    dtype=torch.float32, device="cuda"):
    """Samples inside a finite capped cylinder (``collision.Cylinder``)."""
    cyl = Cylinder(center=tuple(center), axis=tuple(axis), radius=radius,
                   half_height=half_height)
    center = np.asarray(center, np.float64)
    reach = float(np.sqrt(radius ** 2 + half_height ** 2))
    return sample_level_set(generator, lambda x: cyl.phi(x, 0.0), center - reach,
                            center + reach, dx, particles_per_cell, dtype, device)
