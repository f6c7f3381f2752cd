"""Quadratic and cubic B-spline interpolation kernels for particle <-> grid
transfers.

Counterpart of ``hot_tpu.ops.bspline``.

Conventions:
  * Grid nodes sit at integer multiples of dx (node i at position i*dx).
  * Quadratic: a particle at x has base node b = floor(x/dx - 0.5); its
    stencil is nodes b, b+1, b+2 per axis.
  * Cubic: base node b = floor(x/dx) - 1; stencil nodes b .. b+3 per axis.
  * Per-axis weights w[..., dim, W] and derivative weights dw[..., dim, W]
    (already divided by dx), W = 3 (quadratic) or 4 (cubic).
"""

from __future__ import annotations

import itertools

import torch

from hot_tpu_torch.utils.timing import h2d


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


def cubic_kernel_1d(u):
    """N(t) at the 4 stencil offsets for u = x/dx - base in [1, 2):
      N(t) = 1/2|t|^3 - t^2 + 2/3          for |t| < 1
           = -1/6|t|^3 + t^2 - 2|t| + 4/3  for 1 <= |t| < 2
    with t = u, u - 1, u - 2, u - 3."""
    def outer(t):
        a = t.abs()
        return -a ** 3 / 6.0 + a * a - 2.0 * a + 4.0 / 3.0

    def inner(t):
        a = t.abs()
        return 0.5 * a ** 3 - t * t + 2.0 / 3.0

    return torch.stack([outer(u), inner(u - 1.0), inner(u - 2.0), outer(u - 3.0)], dim=-1)


def cubic_kernel_grad_1d(u):
    """dN/dt at the 4 stencil offsets."""
    def outer(t):
        a = t.abs()
        return torch.sign(t) * (-0.5 * a * a + 2.0 * a - 2.0)

    def inner(t):
        a = t.abs()
        return torch.sign(t) * (1.5 * a * a) - 2.0 * t

    return torch.stack([outer(u), inner(u - 1.0), inner(u - 2.0), outer(u - 3.0)], dim=-1)


def quadratic_bspline_weights(x, dx: float):
    """(base (..., dim) int64, w (..., dim, 3), dw (..., dim, 3))."""
    xs = x / dx
    base = torch.floor(xs - 0.5)
    u = xs - base
    return base.long(), quadratic_kernel_1d(u), quadratic_kernel_grad_1d(u) / dx


def cubic_bspline_weights(x, dx: float):
    """(base (..., dim) int64, w (..., dim, 4), dw (..., dim, 4))."""
    xs = x / dx
    base = torch.floor(xs) - 1.0
    u = xs - base
    return base.long(), cubic_kernel_1d(u), cubic_kernel_grad_1d(u) / dx


KERNEL_WIDTHS = {"quadratic": 3, "cubic": 4}


def kernel_width(kernel: str = "quadratic") -> int:
    if kernel not in KERNEL_WIDTHS:
        raise ValueError(f"unknown transfer kernel '{kernel}'; have {tuple(KERNEL_WIDTHS)}")
    return KERNEL_WIDTHS[kernel]


def bspline_weights(x, dx: float, kernel: str = "quadratic"):
    """(base, w, dw) of the kernel family."""
    if kernel_width(kernel) == 4:
        return cubic_bspline_weights(x, dx)
    return quadratic_bspline_weights(x, dx)


def apic_d_inv_factor(kernel: str = "quadratic") -> float:
    """APIC inertia-tensor inverse factor: D = dx^2/4 I (quadratic), dx^2/3 I
    (cubic); the factor multiplies 1/dx^2."""
    return 3.0 if kernel_width(kernel) == 4 else 4.0


def stencil_offsets(dim: int, width: int = 3, device="cpu"):
    """All width^dim integer offsets of the stencil, row-major, (width^dim, dim)."""
    offs = list(itertools.product(range(width), repeat=dim))
    return h2d(torch.tensor(offs, dtype=torch.long, device=device))


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
