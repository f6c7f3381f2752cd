"""Structured SpGEMM: the Galerkin triple product A_c = P^T A P on BSR
stencil matrices.

Counterpart of ``hot_tpu.ops.spgemm`` on compressed rows (``ops.bsr``). The
prolongation P is the node-embedding quadratic B-spline interpolation:
every fine node embeds in 3^dim coarse nodes with weights that depend only
on the parity of its coordinates. With a (2h+1)-wide fine operator, P^T A P
has a (2 h_c + 1)-wide coarse stencil, h_c = ceil(h/2) + 2 (5 -> 7 -> 9 ->
9 ...).

Both products are dense tensor algebra in plain PyTorch: step 1, W = A P, is
one matrix product per parity class of the fine rows; step 2, P^T W, is
3^dim ``index_add_`` scatters into the coarse rows. The result depends only
on the fine operator's node_of, col_row and vals, not on its row order.
Either operator may live on a level of the sparse tile grid (compact node
ids, ``ops.bsr``): coarse couplings that land outside the coarse tile
grid's active tiles are dropped (subspace Galerkin, as in hot_tpu; the
restriction drops the same rows).

A batch's block-diagonal operator (``ops.bsr``) gives the batch's coarse
operator: P is block diagonal too, so member b's coarse rows take only
member b's fine rows, on member-offset coarse ids.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from hot_tpu_torch.ops import bsr as bsr_mod
from hot_tpu_torch.ops.bspline import quadratic_kernel_1d, stencil_offsets
from hot_tpu_torch.utils.timing import h2d, synced


def embedding_weights(coords_f, dtype):
    """Node-embedding interpolation of fine node coords into the coarse grid:
    (base (n, dim) int64, w (n, 3^dim)), coarse stencil nodes base + offsets."""
    dim = coords_f.shape[-1]
    xs = coords_f.to(dtype) * 0.5                   # coarse-cell coordinates
    base = torch.floor(xs - 0.5)
    w_axes = quadratic_kernel_1d(xs - base)         # (n, dim, 3)
    w = w_axes[:, 0]
    for a in range(1, dim):
        w = (w[:, :, None] * w_axes[:, a, None, :]).reshape(w.shape[0], 3 ** (a + 1))
    return base.long(), w


def rap_half_out(half_in: int) -> int:
    """Output stencil half of P^T A P: ceil(h/2) + 2 (fixed point 4)."""
    return (half_in + 1) // 2 + 2


def _parity_pattern(h: int, wm: int, w1d: int):
    """(2, 2h+1, W1d): per (parity, axis offset) the 3 embedding weights of
    the neighbour placed at their window positions."""
    pat = np.zeros((2, 2 * h + 1, w1d))
    wtab = {0: np.array([0.125, 0.75, 0.125]),     # even coord: u = 1
            1: np.array([0.5, 0.5, 0.0])}          # odd coord:  u = 1/2
    for par in (0, 1):
        eb0 = (par - 1) >> 1
        for oi, off in enumerate(range(-h, h + 1)):
            delta = ((par + off - 1) >> 1) - eb0
            for e in range(3):
                pat[par, oi, delta + wm + e] += wtab[(par + off) & 1][e]
    return pat


def rap(A: bsr_mod.BsrMatrix, coarse_res: Tuple[int, ...], coarse_active,
        max_half: Optional[int] = None, coarse_tgrid=None, fine_origin: int = 0,
        coarse_origin: int = 0) -> bsr_mod.BsrMatrix:
    """A_c = P^T A P over the active coarse nodes (compact nodes of
    `coarse_tgrid` if given); for a batch's A, coarse_active is (B, n_c).

    max_half caps the output stencil half (MultigridConfig.rap_max_half):
    the |offset| > max_half couplings are dropped symmetrically.

    fine_origin / coarse_origin: the global plane (axis 0) of the first
    plane of A's grid and of the coarse grid, when both are slabs of
    global grids (``parallel.sharded_mg``: the embedding's parities and
    weights are those of the global coordinates)."""
    dim, h, Kf = A.dim, A.half, A.K
    dd = dim * dim
    dtype, device = A.vals.dtype, A.vals.device
    R = A.n_rows
    coords = bsr_mod.row_coords(A)
    if fine_origin:
        coords = coords.clone()
        coords[:, 0] += fine_origin

    # ---- step 1: W = A P (fine rows x coarse window), per parity class
    wm = (h + 1) // 2
    w1d = 2 * wm + 3
    KW = w1d ** dim
    pat_ax = _parity_pattern(h, wm, w1d)
    PAT = np.ones((1, 1, 1))
    for _ in range(dim):
        n_cls, kf_c, kw_c = PAT.shape
        PAT = np.einsum("ckw,pov->cpkowv", PAT, pat_ax).reshape(
            n_cls * 2, kf_c * (2 * h + 1), kw_c * w1d)
    PAT = h2d(torch.as_tensor(PAT, dtype=dtype, device=device))      # (2^dim, Kf, KW)
    cls = torch.zeros((R,), dtype=torch.long, device=device)
    for a in range(dim):
        cls = cls * 2 + (coords[:, a] & 1)
    vals = torch.where((A.col_row >= 0)[:, :, None], A.vals.reshape(R, Kf, dd),
                       torch.zeros((), dtype=dtype, device=device))
    W = torch.zeros((R, KW, dd), dtype=dtype, device=device)
    for p in range(2 ** dim):
        rows = synced(torch.nonzero(cls == p)).reshape(-1)
        W[rows] = torch.einsum("rkc,kw->rwc", vals[rows], PAT[p])

    # ---- step 2: A_c = P^T W (scatter into the coarse stencil)
    h_c = rap_half_out(h) if max_half is None else min(rap_half_out(h), int(max_half))
    A_c = bsr_mod.structure(coarse_active, coarse_res, half=h_c, dtype=dtype,
                            tgrid=coarse_tgrid)
    Kc = A_c.K
    base_j, w_j = embedding_weights(coords, dtype)
    if coarse_origin:
        base_j[:, 0] -= coarse_origin
    emb_offs = stencil_offsets(dim, device=device)                 # (3^d, dim)
    member = A.row_member()
    Jc_node = bsr_mod.coords_to_nodes(coarse_res, coarse_tgrid,
                                      base_j[:, None, :] + emb_offs[None],
                                      None if member is None else member[:, None])  # (R, 3^d)
    ids = A_c.node_ids(None if member is None else member[:, None], Jc_node.clamp(min=0))
    Jc_row = torch.where(Jc_node >= 0, A_c.row_of[ids], -1)
    if member is not None:
        # a padding row's W is zero; it embeds nowhere
        Jc_row = torch.where((A.node_of < A.row_of.shape[0])[:, None], Jc_row, -1)

    offs_c = np.stack(np.meshgrid(*([np.arange(-h_c, h_c + 1)] * dim), indexing="ij"),
                      -1).reshape(-1, dim)
    e0s = np.stack(np.meshgrid(*([np.arange(3)] * dim), indexing="ij"), -1).reshape(-1, dim)
    Wp = torch.cat([W, torch.zeros((R, 1, dd), dtype=dtype, device=device)], dim=1)
    out = torch.zeros((A_c.n_rows, Kc * dd), dtype=dtype, device=device)
    for e0 in range(e0s.shape[0]):
        # the window column of output offset kc is static per e0 (out of
        # window -> the zero pad column)
        kwc = offs_c + wm + e0s[e0][None, :]
        inside = np.all((kwc >= 0) & (kwc < w1d), axis=-1)
        kw_flat = np.zeros(len(offs_c), np.int64)
        for a in range(dim):
            kw_flat = kw_flat * w1d + np.clip(kwc[:, a], 0, w1d - 1)
        kw_flat = h2d(torch.as_tensor(np.where(inside, kw_flat, KW), device=device))
        ok = synced(torch.nonzero(Jc_row[:, e0] >= 0)).reshape(-1)
        Y = w_j[ok, e0, None, None] * Wp[ok[:, None], kw_flat[None, :]]   # (r, Kc, dd)
        out.index_add_(0, Jc_row[ok, e0], Y.reshape(-1, Kc * dd))
    vals_c = out.reshape(A_c.n_rows, Kc, dim, dim)
    vals_c = torch.where((A_c.col_row >= 0)[:, :, None, None], vals_c,
                         torch.zeros((), dtype=dtype, device=device))
    return A_c.replace(vals=vals_c)
