"""Particle <-> grid transfers over a dense, flattened grid.

Counterpart of the plain forms of ``hot_tpu.ops.transfer``. Every operator
takes a flattened dense grid (n_nodes, ...) and a per-particle ``Stencil``
(node ids, tensor weights, node - particle offsets), so 2D and 3D share one
code path and the implicit solver reuses the step's stencil for its force
and Hessian scatters. Scatters are ``index_add_`` (atomic adds on a GPU, so
fp32 sums change order from run to run).

Out-of-domain stencil nodes are clipped to the boundary; the step keeps
particles at least two cells inside the domain.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from hot_tpu_torch.ops.bspline import (
    kernel_width,
    quadratic_bspline_weights,
    stencil_offsets,
    tensor_weights,
)


class Stencil(NamedTuple):
    """Per-particle quadratic-B-spline stencil against a dense flat grid."""

    node_ids: torch.Tensor  # (n, 3^dim) int64 flat node indices (row-major)
    wn: torch.Tensor        # (n, 3^dim) interpolation weights
    gwn: torch.Tensor       # (n, 3^dim, dim) weight gradients (1/dx units)
    rel: torch.Tensor       # (n, 3^dim, dim) node_pos - particle_pos


def _row_major_strides(res, device):
    strides, s = [], 1
    for r in reversed(res):
        strides.append(s)
        s *= int(r)
    return torch.tensor(strides[::-1], dtype=torch.long, device=device)


def particle_stencil(x, dx: float, res: Tuple[int, ...],
                     kernel: str = "quadratic") -> Stencil:
    """Transfer stencil for particle positions x (n, dim)."""
    dim = x.shape[-1]
    width = kernel_width(kernel)
    base, w, dw = quadratic_bspline_weights(x, dx)
    wn, gwn = tensor_weights(w, dw)
    offs = stencil_offsets(dim, width, device=x.device)
    coords = base[:, None, :] + offs[None, :, :]
    hi = torch.tensor(res, dtype=torch.long, device=x.device) - 1
    coords = torch.minimum(torch.clamp(coords, min=0), hi)
    node_ids = (coords * _row_major_strides(res, x.device)).sum(-1)
    rel = coords.to(x.dtype) * dx - x[:, None, :]
    return Stencil(node_ids=node_ids, wn=wn, gwn=gwn, rel=rel)


def n_nodes_of(res) -> int:
    n = 1
    for r in res:
        n *= int(r)
    return n


def node_positions(res, dx: float, dtype=torch.float32, device="cpu"):
    """(n_nodes, dim) physical positions of all grid nodes (node i at i*dx)."""
    axes = [torch.arange(int(r), device=device) for r in res]
    mesh = torch.meshgrid(*axes, indexing="ij")
    return torch.stack([m.reshape(-1) for m in mesh], -1).to(dtype) * dx


def scatter_sum(node_ids, values, n_nodes: int):
    """Sum (n, s[, c]) per-(particle, node) values onto (n_nodes[, c])."""
    flat_ids = node_ids.reshape(-1)
    flat_vals = values.reshape((flat_ids.shape[0],) + values.shape[node_ids.ndim:])
    out = torch.zeros((n_nodes,) + flat_vals.shape[1:], dtype=values.dtype,
                      device=values.device)
    return out.index_add_(0, flat_ids, flat_vals)


def gather(grid_vals, node_ids):
    """(n_nodes, ...) -> (n, 3^dim, ...)."""
    return grid_vals[node_ids]


def apic_momentum_vals(st: Stencil, v, C, m):
    """(m w (n, s), momentum values (n, s, d)) of APIC P2G:
    w_ip m_p (v_p + C_p (x_i - x_p))."""
    mw = m[:, None] * st.wn
    affine = torch.einsum("pij,pkj->pki", C, st.rel)
    return mw, mw[..., None] * (v[:, None, :] + affine)


def p2g_mass_momentum(st: Stencil, v, C, m, n_nodes: int):
    """APIC P2G: grid mass (n_nodes,) and momentum (n_nodes, d)."""
    mw, mv = apic_momentum_vals(st, v, C, m)
    return scatter_sum(st.node_ids, mw, n_nodes), scatter_sum(st.node_ids, mv, n_nodes)


def grad_from_vi(st: Stencil, vi):
    """grad[p, i, j] = sum_k vi[p, k, i] gwn[p, k, j]."""
    return torch.einsum("pki,pkj->pij", vi, st.gwn)


def g2p(st: Stencil, grid_v, dx: float, d_inv_factor: float = 4.0):
    """(v_p, grad_v, C): particle velocity, velocity gradient and the APIC
    affine matrix C = (d_inv_factor / dx^2) sum_i w_ip v_i (x_i - x_p)^T."""
    vi = gather(grid_v, st.node_ids)
    v_p = torch.einsum("pk,pki->pi", st.wn, vi)
    grad_v = grad_from_vi(st, vi)
    C = (d_inv_factor / (dx * dx)) * torch.einsum("pk,pki,pkj->pij", st.wn, vi, st.rel)
    return v_p, grad_v, C


def velocity_gradient(st: Stencil, grid_v):
    """grad_v_p = sum_i v_i (grad w_ip)^T."""
    return grad_from_vi(st, gather(grid_v, st.node_ids))


def force_contrib(st: Stencil, PFt, V0):
    """contrib[p, k, i] = -V0_p sum_j PFt[p, i, j] gwn[p, k, j]."""
    return -V0[:, None, None] * torch.einsum("pij,pkj->pki", PFt, st.gwn)


def scatter_force(st: Stencil, PFt, V0, n_nodes: int):
    """f_i = -sum_p V0_p (P F_n^T)_p grad_w_ip."""
    return scatter_sum(st.node_ids, force_contrib(st, PFt, V0), n_nodes)
