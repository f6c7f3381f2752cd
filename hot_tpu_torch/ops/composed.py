"""Composed-stencil Galerkin assembly: the exact coarse operator P^T A_0 P
without an explicit fine matrix.

Counterpart of ``hot_tpu.ops.composed``. The coarse basis function of a
level-L node is the node-embedding interpolation of fine basis functions,
so its value at a particle is the composition of the particle's quadratic
fine weights with L embeddings, per axis (tensor-product kernels compose
axis-wise):

    w^L_a = E^L ... E^1 w^0_a,        E = the 3-point node embedding,

4 wide at L = 1 and 5 wide from L = 2 on (a fixed point). With composed
weights and gradients the particle-quadrature elastic operator at level L is
exactly P^T (dt^2 K_0) P, and the fine lumped mass embeds as
(P^T M P)[i, j] = sum_f m_f w_f,i w_f,j: together the exact Galerkin
operator of the matrix-free fine level, from the particles and the fine node
masses. ``spgemm.rap`` needs the explicit fine matrix instead (about 8.7 GB
at 256^3 in hot_tpu's layout); the deeper levels RAP from this one.

Assembly follows hot_tpu's rank-1 mode form (``hot_tpu/ops/bsr.py``
``cell_mode_blocks_scatter``), not a per-particle scatter of s^2 blocks
(3.19 M particles x 4,096 blocks x 9 values at 256^3): the dP/dF of a
particle is d + 2 n_pairs rank-1 modes, so a particle contributes
dt^2 V0 sum_m lam_m z_m z_m^T with z_m a vector over its s d stencil
unknowns. Particles with the same composed base (one composed cell) share
their stencil, so a cell's s d x s d block is one Gram product Z^T diag(lam)
Z over its particles' modes, batched over a chunk of cells (``torch.bmm``,
fp32 without TF32 on the card) and added into the compressed-row BSR values.
Cells go in chunks ordered by size, each chunk's working set under
``CHUNK_BYTES``. The mass part is the same Gram form over the fine nodes'
scalar embedding weights, added on the blocks' diagonals.

A batch's operator (``ops.bsr``'s block-diagonal layout) takes the
members' particles and fine nodes as one set whose cell keys hold the
member, so a cell, its Gram product and its rows belong to one member.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from hot_tpu_torch.models import constitutive as cm
from hot_tpu_torch.ops import bsr as bsr_mod
from hot_tpu_torch.ops.bspline import quadratic_bspline_weights, quadratic_kernel_1d, tensor_weights
from hot_tpu_torch.ops.svd import eigh_sym
from hot_tpu_torch.utils.timing import h2d, synced

# working set of one chunk of composed cells (mode vectors, Gram blocks and
# their scatter indices), in bytes
CHUNK_BYTES = 2 ** 30


def _width_out(S: int) -> int:
    """Per-axis support after one composition: 1 -> 3 -> 4 -> 5 -> 5."""
    return S // 2 + 3


def compose_axis(base, w, dw=None):
    """One node-embedding composition of per-axis weights.

    base (n, dim) int64 node index at the current level; w, dw (n, dim, S).
    Returns (base', w'[, dw']) at twice the spacing, S' = _width_out(S). dw
    composes with the same embedding weights (the embedding interpolates
    values; gradients are taken in the particle's position), so its units
    stay 1 / fine-level length."""
    S = w.shape[-1]
    S2 = _width_out(S)
    n, dim = base.shape
    c = base[..., None] + torch.arange(S, device=base.device)          # (n, dim, S)
    eb = torch.div(c - 1, 2, rounding_mode="floor")
    ew = quadratic_kernel_1d(0.5 * c.to(w.dtype) - eb.to(w.dtype))    # (n, dim, S, 3)
    b2 = torch.div(base - 1, 2, rounding_mode="floor")
    pos = (eb - b2[..., None])[..., None] + torch.arange(3, device=base.device)
    pos = pos.reshape(n, dim, S * 3)

    def compose(v):
        return torch.zeros((n, dim, S2), dtype=w.dtype, device=w.device).scatter_add_(
            -1, pos, (v[..., None] * ew).reshape(n, dim, S * 3))

    if dw is None:
        return b2, compose(w)
    return b2, compose(w), compose(dw)


def composed_particle_weights(x, dx: float, L: int):
    """Level-L composed weights of particles at x (dx = the fine spacing):
    (base_L (n, dim) in level-L node coords, w, dw (n, dim, width)), width 4
    at L = 1 and 5 below; dw in 1 / fine-level length."""
    base, w, dw = quadratic_bspline_weights(x, dx)
    for _ in range(L):
        base, w, dw = compose_axis(base, w, dw)
    return base, w, dw


def composed_node_weights(coords, L: int, dtype):
    """Level-L composed embedding weights of fine nodes at integer coords:
    (base_L, w (nf, dim, width)), width 3 (L = 1), 4 (L = 2), 5 (L >= 3)."""
    base = coords.long()
    w = torch.ones(base.shape + (1,), dtype=dtype, device=base.device)
    for _ in range(L):
        base, w = compose_axis(base, w)
    return base, w


def ext_key(base, res_L: Tuple[int, ...]):
    """Injective flat key of a composed base over the extended range
    base + 1 in [0, res + 2) per axis: composed bases reach -1 at the domain
    edge, and clipping would merge distinct cells."""
    key = torch.zeros(base.shape[:-1], dtype=torch.long, device=base.device)
    for a in range(base.shape[-1]):
        key = key * (int(res_L[a]) + 2) + torch.clamp(base[..., a] + 1, 0, int(res_L[a]) + 1)
    return key


def _unext(keys, res_L):
    """Inverse of ext_key: keys (C,) -> level coords (C, dim)."""
    coords = []
    rem = keys
    for a in reversed(range(len(res_L))):
        m = int(res_L[a]) + 2
        coords.append(rem % m - 1)
        rem = torch.div(rem, m, rounding_mode="floor")
    return torch.stack(coords[::-1], dim=-1)


def _cell_chunks(keys, cell_bytes, budget: int = CHUNK_BYTES):
    """Items grouped by key, in chunks of cells: yields (cell keys (C,),
    items (C, cap) int64, -1 past each cell's count). Cells come largest
    first, and each chunk holds as many cells as keep cell_bytes(cap) x
    cells under `budget`."""
    n = keys.shape[0]
    if n == 0:
        return
    order = torch.argsort(keys, stable=True)
    cell_keys, counts = synced(torch.unique_consecutive(keys[order], return_counts=True))
    starts = torch.cumsum(counts, 0) - counts
    by_size = torch.argsort(counts, descending=True, stable=True)
    sizes = synced(counts[by_size].tolist())
    i = 0
    while i < len(sizes):
        cap = sizes[i]
        m = max(1, budget // cell_bytes(cap))
        cells = by_size[i:i + m]
        slot = torch.arange(cap, device=keys.device)
        idx = starts[cells][:, None] + slot
        items = torch.where(slot < counts[cells][:, None], order[idx.clamp(max=n - 1)], -1)
        yield cell_keys[cells], items
        i += m


def _offset_ids(dim: int, width: int, half: int, device):
    """(offs (s, dim), off_id (s, s)): a width-wide stencil's node offsets and
    the column of node i relative to node j in the (2 half + 1)-wide
    structure."""
    offs = np.stack(np.meshgrid(*([np.arange(width)] * dim), indexing="ij"), -1).reshape(-1, dim)
    rel = offs[None, :, :] - offs[:, None, :] + half
    off_id = np.zeros(rel.shape[:2], np.int64)
    for a in range(dim):
        off_id = off_id * (2 * half + 1) + rel[:, :, a]
    return (h2d(torch.as_tensor(offs, device=device)),
            h2d(torch.as_tensor(off_id, device=device)))


def _ext_size(res_L) -> int:
    return int(np.prod([int(r) + 2 for r in res_L]))


def _member_keys(keys, member, res_L):
    """Cell keys of a batch's members apart: member * (ext_key range) + key."""
    return keys if member is None else member * _ext_size(res_L) + keys


def _cell_rows(mat: bsr_mod.BsrMatrix, res_L, cell_keys, offs):
    """(C, s) row of each cell's stencil node, -1 where it is no row."""
    member = None
    if mat.batch is not None:
        member = torch.div(cell_keys, _ext_size(res_L), rounding_mode="floor")
        cell_keys = cell_keys - member * _ext_size(res_L)
        member = member[:, None]
    coords = _unext(cell_keys, res_L)[:, None, :] + offs[None]
    nodes = bsr_mod.coords_to_nodes(res_L, mat.tgrid, coords, member)
    return torch.where(nodes >= 0, mat.row_of[mat.node_ids(member, nodes.clamp(min=0))], -1)


def _scatter_cells(out, mat: bsr_mod.BsrMatrix, rows, off_id, blocks):
    """Add per-cell blocks (C, s_j, s_i, ...) into out (n_rows * K, ...) at
    (row of node j, column of node i relative to j)."""
    flat = rows[:, :, None] * mat.K + off_id[None]
    ok = (rows >= 0)[:, :, None].expand_as(flat)
    out.index_add_(0, synced(flat[ok]), synced(blocks[ok]))


def mode_vectors(gwn, F_n, ctx: cm.HessianContext, V0, dt: float):
    """Rank-1 mode factorisation of particles' quadrature blocks:
    (Z (n, M, s, d), lam (n, M)), M = d + 2 n_pairs, with the particle's
    block between stencil nodes j and i equal to sum_m lam_m z_m(j) z_m(i)^T:
      z_m(k) = U (Q e_m o y_k), y_k = V^T F^T gw_k, lam_m = eig_m(A)
      z(k)   = (U_i y_kj +- U_j y_ki) / sqrt2,  lam = b- / b+   (shear pairs),
    each lam scaled by dt^2 V0 (hot_tpu/ops/bsr.py:_mode_vectors)."""
    g = torch.einsum("pkb,pba->pka", gwn, F_n)
    y = torch.einsum("pka,pac->pkc", g, ctx.V)
    w_eig, Q = eigh_sym(ctx.A)
    zs = [torch.einsum("pec,pcm,pkc->pmke", ctx.U, Q, y)]
    lams = [w_eig]
    inv_sqrt2 = 0.7071067811865476
    for k_p, (i, j) in enumerate(cm._pairs(gwn.shape[-1])):
        Ui, Uj = ctx.U[:, None, None, :, i], ctx.U[:, None, None, :, j]
        yi, yj = y[:, None, :, i, None], y[:, None, :, j, None]
        zs += [(Ui * yj + Uj * yi) * inv_sqrt2, (Ui * yj - Uj * yi) * inv_sqrt2]
        lams += [ctx.b_minus[:, k_p, None], ctx.b_plus[:, k_p, None]]
    return torch.cat(zs, dim=1), torch.cat(lams, dim=1) * ((dt * dt) * V0)[:, None]


def assemble_composed_galerkin(mat: bsr_mod.BsrMatrix, L: int, F_n, ctx: cm.HessianContext,
                               V0, dt: float, node_coords, node_m, comp_base, comp_w,
                               comp_dw) -> bsr_mod.BsrMatrix:
    """The exact Galerkin level-L operator P^T (M + dt^2 K) P from the
    particles and the fine node masses, into `mat`'s structure (half =
    width - 1, the level's res and node ids).

    comp_base, comp_w, comp_dw: composed_particle_weights(x, dx, L).
    node_coords (nf, dim) and node_m (nf,): the fine level's node coords and
    lumped masses (zero-mass nodes are left out). A batch's operator takes
    every array with a leading member dimension."""
    res_L = mat.res
    member = node_member = None
    if mat.batch is not None:
        def members(t):
            return torch.arange(mat.batch, device=t.device).repeat_interleave(t.shape[1])

        member, node_member = members(F_n), members(node_m)
        F_n, V0, comp_base, comp_w, comp_dw, node_coords, node_m = (
            t.flatten(0, 1) for t in (F_n, V0, comp_base, comp_w, comp_dw, node_coords, node_m))
        ctx = cm.HessianContext(*(t.flatten(0, 1) for t in ctx))
    dim = len(res_L)
    width = comp_w.shape[-1]
    assert mat.half == width - 1, (mat.half, width)
    dtype, device = F_n.dtype, F_n.device
    item = torch.finfo(dtype).bits // 8
    K, dd = mat.K, dim * dim

    # ---- elastic part: per composed cell, the Gram product of its
    # particles' mode vectors
    s = width ** dim
    sd = s * dim
    modes = dim + 2 * len(cm._pairs(dim))
    offs, off_id = _offset_ids(dim, width, mat.half, device)
    vals = torch.zeros((mat.n_rows * K, dim, dim), dtype=dtype, device=device)

    def particle_cell_bytes(cap):
        # mode vectors and their intermediates, the Gram block, its permuted
        # copy and the scatter indices
        return item * (4 * cap * modes * sd + 3 * sd * sd) + 16 * s * s

    for cell_keys, items in _cell_chunks(_member_keys(ext_key(comp_base, res_L), member, res_L),
                                         particle_cell_bytes):
        C, cap = items.shape
        p = items.reshape(-1).clamp(min=0)
        _, gwn = tensor_weights(comp_w[p], comp_dw[p])
        Z, lam = mode_vectors(gwn, F_n[p], cm.HessianContext(*(t[p] for t in ctx)), V0[p], dt)
        lam = torch.where((items >= 0).reshape(-1, 1), lam, torch.zeros((), dtype=dtype,
                                                                          device=device))
        Z = Z.reshape(C, cap * modes, sd)
        G = torch.bmm((Z * lam.reshape(C, cap * modes, 1)).transpose(1, 2), Z)
        blocks = G.reshape(C, s, dim, s, dim).permute(0, 1, 3, 2, 4)
        _scatter_cells(vals, mat, _cell_rows(mat, res_L, cell_keys, offs), off_id, blocks)

    # ---- inertia part: P^T diag(m_fine) P, the same Gram form over the fine
    # nodes' scalar composed embedding weights
    live = node_m > 0
    nb, nw = composed_node_weights(node_coords[live], L, dtype)
    m_width = nw.shape[-1]
    wn_n, _ = tensor_weights(nw, torch.zeros_like(nw))
    rows_w = torch.sqrt(node_m[live])[:, None] * wn_n                    # (nf, sm)
    sm = rows_w.shape[1]
    m_offs, m_off_id = _offset_ids(dim, m_width, mat.half, device)
    scal = torch.zeros((mat.n_rows * K,), dtype=dtype, device=device)
    live_member = None if node_member is None else node_member[live]
    for cell_keys, items in _cell_chunks(_member_keys(ext_key(nb, res_L), live_member, res_L),
                                         lambda cap: item * (cap * sm + 2 * sm * sm)):
        W = torch.where((items >= 0)[..., None], rows_w[items.clamp(min=0)],
                        torch.zeros((), dtype=dtype, device=device))
        B = torch.bmm(W.transpose(1, 2), W)                               # (C, sm, sm)
        _scatter_cells(scal, mat, _cell_rows(mat, res_L, cell_keys, m_offs), m_off_id, B)

    vals = vals.reshape(mat.n_rows, K, dim, dim)
    vals = vals + scal.reshape(mat.n_rows, K)[:, :, None, None] * torch.eye(
        dim, dtype=dtype, device=device)
    vals = torch.where((mat.col_row >= 0)[:, :, None, None], vals,
                       torch.zeros((), dtype=dtype, device=device))
    return mat.replace(vals=vals)


def structure_half(L: int) -> int:
    """Stencil half of the composed level-L structure: width - 1 (3 at
    L = 1, 4 below)."""
    return 3 if L == 1 else 4
