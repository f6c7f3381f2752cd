"""Block-sparse (d x d node blocks) Hessian assembly and SpMV: the
explicit-operator path.

Counterpart of ``hot_tpu.ops.bsr`` in its compressed-row form. A quadratic
B-spline couples nodes at per-axis offsets in [-half, half], so every row
has at most K = (2 half + 1)^dim neighbour blocks at known geometric
offsets. Rows are the active nodes, in node order, and their count is
exact (eager PyTorch needs no static capacity):

  vals:     (n_rows, K, d, d)  block values, zero where absent
  col_row:  (n_rows, K) int32  neighbour's row index, -1 if absent/inactive
  node_of:  (n_rows,) int64    node id per row
  row_of:   (n_nodes,) int64   inverse map, -1 for inactive nodes

Node ids are the dense grid's row-major ids, or, on a level of the sparse
tile grid (``tgrid``), its compact ids (``grid.sparse``; n_nodes is then
n_cnodes, and a neighbour in an inactive tile is absent). Either way rows
are built from the nodes' integer coordinates, so an assembled compact level
has the same compressed-row layout.

A batch of B members (hot_tpu's ``jax.vmap`` over the step) is one
block-diagonal operator: the member is the outermost index of every node
id and row. Node ids are member-offset (b * n_nodes + local id, as
``ops.transfer`` offsets a batch's stencil), and every member has R rows,
the most active nodes of any member: member b's rows are b R .. b R + R - 1,
its own active nodes in node order first, then padding rows (no column,
zero values, ``node_of`` = B n_nodes, past every node). ``col_row`` points
only into the member's own rows, so ``ops.bsr_spmv`` runs once over all
members' rows, and a row vector is (B, R, d), reduced per member over its
own rows. ``col_row`` stays int32: B R must stay under 2^31.

Every assembled operator of the port (the outer Hessian with
``matrix_free=False``, the quadrature-assembled and the Galerkin multigrid
levels) uses this one layout; ``hot_tpu``'s tile-row layout existed for the
TPU's supertile SpMV and is not ported. The SpMV is ``ops.bsr_spmv`` (the
CUDA kernel on the card).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from hot_tpu_torch.models import constitutive as cm
from hot_tpu_torch.ops import transfer
from hot_tpu_torch.ops.bsr_spmv import bsr_spmv
from hot_tpu_torch.utils.timing import h2d, synced

# particles per assembly chunk: bounds the (chunk, 3^d, 3^d, d, d) block
# tensor at 2^26 values (the unchunked one is 10.5 GB in fp32 at 128^3)
_ASSEMBLY_BUDGET = 2 ** 26


@dataclasses.dataclass
class BsrMatrix:
    vals: torch.Tensor      # (n_rows, K, d, d)
    col_row: torch.Tensor   # (n_rows, K) int32, -1 = absent
    node_of: torch.Tensor   # (n_rows,) int64
    row_of: torch.Tensor    # (n_nodes,) int64, -1 = inactive
    res: Tuple[int, ...]
    half: int               # 2 for quadrature operators, 3/4 for Galerkin RAP
    tgrid: object = None    # grid.sparse.TileGrid of compact node ids, None = dense
    batch: Optional[int] = None     # a batch's members (n_rows = batch * member_rows)

    def replace(self, **kw) -> "BsrMatrix":
        return dataclasses.replace(self, **kw)

    @property
    def dim(self) -> int:
        return len(self.res)

    @property
    def K(self) -> int:
        return (2 * self.half + 1) ** self.dim

    @property
    def n_rows(self) -> int:
        return self.col_row.shape[0]

    @property
    def member_rows(self) -> int:
        """Rows per member (all rows for one operator)."""
        return self.n_rows // (self.batch or 1)

    @property
    def n_nodes(self) -> int:
        """Grid nodes per member."""
        return self.row_of.shape[0] // (self.batch or 1)

    def row_member(self):
        """(n_rows,) member of each row; None for one operator."""
        if self.batch is None:
            return None
        return torch.arange(self.batch, device=self.col_row.device).repeat_interleave(
            self.member_rows)

    def row_nodes(self):
        """(n_nodes,) bool of the nodes that are rows, a batch's (B, n_nodes)."""
        mask = self.row_of >= 0
        return mask if self.batch is None else mask.reshape(self.batch, -1)

    def node_ids(self, member, local):
        """Member-offset node ids of member-local ids (local ids for one
        operator)."""
        return local if member is None else member * self.n_nodes + local


def _offsets(dim: int, half: int, device):
    """All (2h+1)^dim per-axis offsets in [-h, h], row-major, (K, dim)."""
    rng = torch.arange(-half, half + 1, device=device)
    grids = torch.meshgrid(*([rng] * dim), indexing="ij")
    return torch.stack([g.reshape(-1) for g in grids], dim=-1)


def node_coords(res, tgrid, ids, member=None):
    """Integer coords (..., dim) of node ids on the dense grid of size res or
    the tile grid `tgrid`; on a batch's tile grid, of member-local ids (of
    the members `member`, else of the leading dimension's)."""
    if tgrid is None:
        return transfer.unravel(ids, res)
    from hot_tpu_torch.grid import sparse

    return sparse.compact_node_coords(tgrid, ids, member)


def coords_to_nodes(res, tgrid, coords, member=None):
    """Node ids of integer coords (..., dim): -1 outside the grid and, on a
    tile grid, in an inactive tile (member-local ids on a batch's tile grid,
    as node_coords)."""
    res_t = h2d(torch.tensor(res, dtype=torch.long, device=coords.device))
    inside = ((coords >= 0) & (coords < res_t)).all(-1)
    clipped = torch.minimum(coords.clamp(min=0), res_t - 1)
    if tgrid is None:
        ids = (clipped * transfer._row_major_strides(res, coords.device)).sum(-1)
    else:
        from hot_tpu_torch.grid import sparse

        ids = sparse.compact_node_id(tgrid, clipped, member)
        inside = inside & (ids != tgrid.dump)
    return torch.where(inside, ids, -1)


def structure(active, res: Tuple[int, ...], half: int = 2, dtype=torch.float32,
              tgrid=None) -> BsrMatrix:
    """Symbolic structure: rows for active nodes (of the tile grid `tgrid`
    if given), columns for active neighbours; vals are zero. A batch's
    active (B, n_nodes) gives the block-diagonal operator of the module doc."""
    dim = len(res)
    device = active.device
    batch = active.shape[0] if active.ndim == 2 else None
    act = active.reshape(batch or 1, -1)
    B, n = act.shape
    counts = act.sum(1)
    R = synced(int(counts.max())) if B else 0
    if B * R >= 2 ** 31:
        raise ValueError(f"{B} members of {R} rows overflow the int32 column index")
    flat = synced(torch.nonzero(act.reshape(-1))).reshape(-1)
    member = torch.div(flat, n, rounding_mode="floor")
    prow = member * R + torch.arange(flat.shape[0], device=device) - (
        torch.cumsum(counts, 0) - counts)[member]
    node_of = torch.full((B * R,), B * n, dtype=torch.long, device=device)
    node_of[prow] = flat
    row_of = torch.full((B * n,), -1, dtype=torch.long, device=device)
    row_of[flat] = prow
    m = None if batch is None else member
    coords = node_coords(res, tgrid, flat - member * n, m)
    nids = coords_to_nodes(res, tgrid, coords[:, None, :] + _offsets(dim, half, device)[None],
                           None if m is None else m[:, None])
    col = torch.where(nids >= 0, row_of[(member * n)[:, None] + nids.clamp(min=0)], -1)
    col_row = torch.full((B * R, col.shape[1]), -1, dtype=torch.int32, device=device)
    col_row[prow] = col.to(torch.int32)
    vals = torch.zeros((B * R, col.shape[1], dim, dim), dtype=dtype, device=device)
    return BsrMatrix(vals=vals, col_row=col_row, node_of=node_of, row_of=row_of,
                     res=tuple(res), half=half, tgrid=tgrid, batch=batch)


def _ids_coords(mat: BsrMatrix, ids):
    """Integer coords of (member-offset) node ids of `mat`'s grid."""
    if mat.batch is None:
        return node_coords(mat.res, mat.tgrid, ids)
    member = torch.div(ids, mat.n_nodes, rounding_mode="floor")
    return node_coords(mat.res, mat.tgrid, ids - member * mat.n_nodes, member)


def row_coords(mat: BsrMatrix):
    """(n_rows, dim) integer coords of the rows' nodes (a padding row's are
    those of its member's first node)."""
    if mat.batch is None:
        return node_coords(mat.res, mat.tgrid, mat.node_of)
    member = mat.row_member()
    local = mat.node_of - member * mat.n_nodes
    return node_coords(mat.res, mat.tgrid, torch.where(local < mat.n_nodes, local, 0), member)


def assemble_hessian(mat: BsrMatrix, stencil: transfer.Stencil, F_n, ctx: cm.HessianContext,
                     V0, dt: float, grid_m) -> BsrMatrix:
    """Fill vals with M + dt^2 K from particle quadrature.

    Per particle: g_k = F^T gw_k at its 3^d stencil nodes, dP_(k,a) =
    dPdF : (dt e_a g_k^T), and block (kj <- ki)[b, a] = dt V0 (dP_(ki,a)
    g_kj)_b, added at (row of kj, offset of ki - kj). Chunked over particles
    so the block tensor stays bounded. A batch's arrays (leading member
    dimension, member-offset stencil) fill the batch's operator."""
    assert mat.half == 2, "quadrature assembly fills the 5-wide structure"
    if F_n.ndim == 4:
        stencil = transfer.Stencil(*(t.flatten(0, 1) for t in stencil))
        F_n, V0 = F_n.flatten(0, 1), V0.flatten(0, 1)
        ctx = cm.HessianContext(*(t.flatten(0, 1) for t in ctx))
    dim, K = mat.dim, mat.K
    n, s = stencil.wn.shape
    dtype, device = F_n.dtype, F_n.device
    vals = torch.zeros((mat.n_rows * K, dim, dim), dtype=dtype, device=device)
    eye = torch.eye(dim, dtype=dtype, device=device)
    unit = eye[:, :, None]                                    # e_a as (d_a, d, 1)
    chunk = max(1, _ASSEMBLY_BUDGET // (s * s * dim * dim))
    for lo in range(0, n, chunk):
        sl = slice(lo, min(n, lo + chunk))
        g = torch.einsum("pkb,pbc->pkc", stencil.gwn[sl], F_n[sl])   # (c, s, d)
        dF = dt * unit[None, None] * g[:, :, None, None, :]           # (c, s, d_a, d, d)
        ctx_b = cm.HessianContext(*(t[sl][:, None, None] for t in ctx))
        dPs = cm.apply_hessian(ctx_b, dF)                             # (c, s, d_a, d, d)
        blocks = (dt * V0[sl])[:, None, None, None, None] * torch.einsum(
            "piabc,pjc->pjiba", dPs, g)                               # (c, s_j, s_i, d, d)
        coords = _ids_coords(mat, stencil.node_ids[sl])                # (c, s, dim)
        off5 = coords[:, None, :, :] - coords[:, :, None, :] + 2      # (c, s_j, s_i, dim)
        off_id = torch.zeros(off5.shape[:-1], dtype=torch.long, device=device)
        for a in range(dim):
            off_id = off_id * 5 + off5[..., a]
        rows = mat.row_of[stencil.node_ids[sl]]                       # (c, s_j)
        flat_id = rows[:, :, None] * K + off_id
        ok = (rows >= 0)[:, :, None].expand_as(flat_id)
        vals.index_add_(0, synced(flat_id[ok]), synced(blocks[ok]))
    return mat.replace(vals=_finalize_vals(mat, vals.reshape(mat.n_rows, K, dim, dim), grid_m))


def _finalize_vals(mat: BsrMatrix, vals, grid_m):
    """Add the centre-offset inertia m_i I and zero absent neighbours."""
    dim = mat.dim
    center = (mat.K - 1) // 2
    eye = torch.eye(dim, dtype=vals.dtype, device=vals.device)
    vals[:, center] += node_rows(mat, grid_m)[:, None, None] * eye
    return torch.where((mat.col_row >= 0)[:, :, None, None], vals, torch.zeros_like(vals))


def spmv(mat: BsrMatrix, x):
    """y = A x on row vectors x (n_rows, d), a batch's (B, R, d), through
    ``ops.bsr_spmv`` (one launch for all members)."""
    y = bsr_spmv(mat.vals, mat.col_row, x.reshape(-1, x.shape[-1]).contiguous())
    return y.reshape(x.shape)


def _rows(mat: BsrMatrix, t):
    """Flat (n_rows, ...) -> a batch's (B, R, ...)."""
    return t if mat.batch is None else t.reshape((mat.batch, -1) + t.shape[1:])


def block_diag(mat: BsrMatrix):
    """(n_rows, d, d) diagonal blocks (block-Jacobi), a batch's (B, R, d, d)."""
    return _rows(mat, mat.vals[:, (mat.K - 1) // 2])


def node_rows(mat: BsrMatrix, t):
    """Per-node values (n_nodes, ...), a batch's (B, n_nodes, ...), at the
    rows: flat (n_rows, ...), zero (False) on a batch's padding rows."""
    if mat.batch is None:
        return t[mat.node_of]
    flat = t.flatten(0, 1)
    return torch.cat([flat, flat.new_zeros((1,) + flat.shape[1:])])[mat.node_of]


def grid_vector_to_rows(mat: BsrMatrix, v):
    """(n_nodes, d) -> (n_rows, d); a batch's (B, n_nodes, ...) -> (B, R, ...)."""
    return _rows(mat, node_rows(mat, v))


def rows_to_grid_vector(mat: BsrMatrix, y, n_nodes: int):
    """(n_rows, d) -> (n_nodes, d), zero at inactive nodes; a batch's
    (B, R, d) -> (B, n_nodes, d)."""
    d = y.shape[-1]
    lead = (mat.batch,) if mat.batch is not None else ()
    out = torch.zeros((math.prod(lead) * n_nodes + len(lead), d), dtype=y.dtype,
                      device=y.device)
    out[mat.node_of] = y.reshape(-1, d)
    return out[:math.prod(lead) * n_nodes].reshape(lead + (n_nodes, d))


def to_scipy(mat: BsrMatrix):
    """Dense numpy matrix over row DoFs (tests only); a batch's is block
    diagonal over its members' rows, zero on the padding rows."""
    import numpy as np

    d, n = mat.dim, mat.n_rows
    A = np.zeros((n, d, n, d))
    col = mat.col_row.cpu().numpy()
    r, k = np.nonzero(col >= 0)
    # the columns of one row are distinct nodes, so (r, col) pairs are unique
    A[r, :, col[r, k], :] = mat.vals.detach().cpu().numpy()[r, k]
    return A.reshape(n * d, n * d)
