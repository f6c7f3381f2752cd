"""Quadratic B-spline interpolation kernels for particle <-> grid transfers.

Counterpart of ``hot_tpu.ops.bspline`` (quadratic family only; the cubic
family is not ported yet).

Conventions:
  * Grid nodes sit at integer multiples of dx (node i at position i*dx).
  * A particle at x has base node b = floor(x/dx - 0.5); its stencil is
    nodes b, b+1, b+2 per axis.
  * Per-axis weights w[..., dim, 3] and derivative weights dw[..., dim, 3]
    (already divided by dx).
"""

from __future__ import annotations

import itertools

import torch


def quadratic_kernel_1d(u):
    """N(t) at the 3 stencil offsets for u = x/dx - base in [0.5, 1.5)."""
    t1 = u - 1.0
    w0 = 0.5 * (1.5 - u) ** 2
    w1 = 0.75 - t1 * t1
    w2 = 0.5 * (1.5 + (u - 2.0)) ** 2
    return torch.stack([w0, w1, w2], dim=-1)


def quadratic_kernel_grad_1d(u):
    """dN/dt at the 3 stencil offsets."""
    return torch.stack([u - 1.5, -2.0 * (u - 1.0), (u - 2.0) + 1.5], dim=-1)


def quadratic_bspline_weights(x, dx: float):
    """(base (..., dim) int64, w (..., dim, 3), dw (..., dim, 3))."""
    xs = x / dx
    base = torch.floor(xs - 0.5)
    u = xs - base
    return base.long(), quadratic_kernel_1d(u), quadratic_kernel_grad_1d(u) / dx


def kernel_width(kernel: str = "quadratic") -> int:
    if kernel != "quadratic":
        raise NotImplementedError(f"{kernel} B-splines are not ported yet")
    return 3


def apic_d_inv_factor(kernel: str = "quadratic") -> float:
    """APIC inertia-tensor inverse factor: D = dx^2/4 I for quadratic."""
    kernel_width(kernel)
    return 4.0


def stencil_offsets(dim: int, width: int = 3, device="cpu"):
    """All width^dim integer offsets of the stencil, row-major, (width^dim, dim)."""
    offs = list(itertools.product(range(width), repeat=dim))
    return torch.tensor(offs, dtype=torch.long, device=device)


def tensor_weights(w, dw):
    """Per-axis weights -> per-stencil-node weight (..., S^dim) and gradient
    (..., S^dim, dim), with the multiply association ((wx*wy)*wz)."""
    dim, s = w.shape[-2], w.shape[-1]
    lead = w.shape[:-2]
    if dim == 2:
        wi = w[..., 0, :, None]
        wj = w[..., 1, None, :]
        wn = (wi * wj).reshape(lead + (s * s,))
        gx = (dw[..., 0, :, None] * wj).reshape(lead + (s * s,))
        gy = (wi * dw[..., 1, None, :]).reshape(lead + (s * s,))
        return wn, torch.stack([gx, gy], dim=-1)
    if dim == 3:
        wi = w[..., 0, :, None, None]
        wj = w[..., 1, None, :, None]
        wk = w[..., 2, None, None, :]
        shape = lead + (s ** 3,)
        wn = (wi * wj * wk).reshape(shape)
        gx = (dw[..., 0, :, None, None] * wj * wk).reshape(shape)
        gy = (wi * dw[..., 1, None, :, None] * wk).reshape(shape)
        gz = (wi * wj * dw[..., 2, None, None, :]).reshape(shape)
        return wn, torch.stack([gx, gy, gz], dim=-1)
    raise ValueError(f"dim must be 2 or 3, got {dim}")
