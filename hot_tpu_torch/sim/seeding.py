"""Particle seeding: jittered lattices filling a box.

Counterpart of ``hot_tpu.sim.seeding.sample_box``. The lattice is the same;
the jitter comes from a ``torch.Generator``, so positions differ from the
JAX package's (which draws them from ``jax.random``) for the same seed.
"""

from __future__ import annotations

import numpy as np
import torch


def sample_box(generator: torch.Generator, lo, hi, dx: float,
               particles_per_cell: int, dtype=torch.float32, device="cpu"):
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
