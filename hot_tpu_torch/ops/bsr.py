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

Every assembled operator of the port (the outer Hessian with
``matrix_free=False``, the quadrature-assembled and the Galerkin multigrid
levels) uses this one layout; ``hot_tpu``'s tile-row layout existed for the
TPU's supertile SpMV and is not ported. The SpMV is ``ops.bsr_spmv`` (the
CUDA kernel on the card).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from hot_tpu_torch.models import constitutive as cm
from hot_tpu_torch.ops import transfer
from hot_tpu_torch.ops.bsr_spmv import bsr_spmv

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


def _offsets(dim: int, half: int, device):
    """All (2h+1)^dim per-axis offsets in [-h, h], row-major, (K, dim)."""
    rng = torch.arange(-half, half + 1, device=device)
    grids = torch.meshgrid(*([rng] * dim), indexing="ij")
    return torch.stack([g.reshape(-1) for g in grids], dim=-1)


def node_coords(res, tgrid, ids):
    """Integer coords (..., dim) of node ids on the dense grid of size res or
    the tile grid `tgrid`."""
    if tgrid is None:
        return transfer.unravel(ids, res)
    from hot_tpu_torch.grid import sparse

    return sparse.compact_node_coords(tgrid, ids)


def coords_to_nodes(res, tgrid, coords):
    """Node ids of integer coords (..., dim): -1 outside the grid and, on a
    tile grid, in an inactive tile."""
    res_t = torch.tensor(res, dtype=torch.long, device=coords.device)
    inside = ((coords >= 0) & (coords < res_t)).all(-1)
    clipped = torch.minimum(coords.clamp(min=0), res_t - 1)
    if tgrid is None:
        ids = (clipped * transfer._row_major_strides(res, coords.device)).sum(-1)
    else:
        from hot_tpu_torch.grid import sparse

        ids = sparse.compact_node_id(tgrid, clipped)
        inside = inside & (ids != tgrid.dump)
    return torch.where(inside, ids, -1)


def active_rows(active):
    """(node_of (n_rows,), row_of (n_nodes,)) of an active-node mask."""
    node_of = torch.nonzero(active).reshape(-1)
    row_of = torch.full(active.shape, -1, dtype=torch.long, device=active.device)
    row_of[node_of] = torch.arange(node_of.shape[0], device=active.device)
    return node_of, row_of


def structure(active, res: Tuple[int, ...], half: int = 2, dtype=torch.float32,
              tgrid=None) -> BsrMatrix:
    """Symbolic structure: rows for active nodes (of the tile grid `tgrid`
    if given), columns for active neighbours; vals are zero."""
    dim = len(res)
    device = active.device
    node_of, row_of = active_rows(active)
    coords = node_coords(res, tgrid, node_of)
    nids = coords_to_nodes(res, tgrid, coords[:, None, :] + _offsets(dim, half, device)[None])
    col_row = torch.where(nids >= 0, row_of[nids.clamp(min=0)], -1).to(torch.int32)
    K = col_row.shape[1]
    vals = torch.zeros((node_of.shape[0], K, dim, dim), dtype=dtype, device=device)
    return BsrMatrix(vals=vals, col_row=col_row, node_of=node_of, row_of=row_of,
                     res=tuple(res), half=half, tgrid=tgrid)


def row_coords(mat: BsrMatrix):
    """(n_rows, dim) integer coords of the rows' nodes."""
    return node_coords(mat.res, mat.tgrid, mat.node_of)


def assemble_hessian(mat: BsrMatrix, stencil: transfer.Stencil, F_n, ctx: cm.HessianContext,
                     V0, dt: float, grid_m) -> BsrMatrix:
    """Fill vals with M + dt^2 K from particle quadrature.

    Per particle: g_k = F^T gw_k at its 3^d stencil nodes, dP_(k,a) =
    dPdF : (dt e_a g_k^T), and block (kj <- ki)[b, a] = dt V0 (dP_(ki,a)
    g_kj)_b, added at (row of kj, offset of ki - kj). Chunked over particles
    so the block tensor stays bounded."""
    assert mat.half == 2, "quadrature assembly fills the 5-wide structure"
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
        coords = node_coords(mat.res, mat.tgrid, stencil.node_ids[sl])  # (c, s, dim)
        off5 = coords[:, None, :, :] - coords[:, :, None, :] + 2      # (c, s_j, s_i, dim)
        off_id = torch.zeros(off5.shape[:-1], dtype=torch.long, device=device)
        for a in range(dim):
            off_id = off_id * 5 + off5[..., a]
        rows = mat.row_of[stencil.node_ids[sl]]                       # (c, s_j)
        flat_id = rows[:, :, None] * K + off_id
        ok = (rows >= 0)[:, :, None].expand_as(flat_id)
        vals.index_add_(0, flat_id[ok], blocks[ok])
    return mat.replace(vals=_finalize_vals(mat, vals.reshape(mat.n_rows, K, dim, dim), grid_m))


def _finalize_vals(mat: BsrMatrix, vals, grid_m):
    """Add the centre-offset inertia m_i I and zero absent neighbours."""
    dim = mat.dim
    center = (mat.K - 1) // 2
    eye = torch.eye(dim, dtype=vals.dtype, device=vals.device)
    vals[:, center] += grid_m[mat.node_of][:, None, None] * eye
    return torch.where((mat.col_row >= 0)[:, :, None, None], vals, torch.zeros_like(vals))


def spmv(mat: BsrMatrix, x):
    """y = A x on row vectors x (n_rows, d), through ``ops.bsr_spmv``."""
    return bsr_spmv(mat.vals, mat.col_row, x.contiguous())


def block_diag(mat: BsrMatrix):
    """(n_rows, d, d) diagonal blocks (block-Jacobi)."""
    return mat.vals[:, (mat.K - 1) // 2]


def grid_vector_to_rows(mat: BsrMatrix, v):
    """(n_nodes, d) -> (n_rows, d)."""
    return v[mat.node_of]


def rows_to_grid_vector(mat: BsrMatrix, y, n_nodes: int):
    """(n_rows, d) -> (n_nodes, d), zero at inactive nodes."""
    out = torch.zeros((n_nodes, y.shape[1]), dtype=y.dtype, device=y.device)
    out[mat.node_of] = y
    return out


def to_scipy(mat: BsrMatrix):
    """Dense numpy matrix over row DoFs (tests only)."""
    import numpy as np

    d, n = mat.dim, mat.n_rows
    A = np.zeros((n, d, n, d))
    col = mat.col_row.cpu().numpy()
    r, k = np.nonzero(col >= 0)
    # the columns of one row are distinct nodes, so (r, col) pairs are unique
    A[r, :, col[r, k], :] = mat.vals.detach().cpu().numpy()[r, k]
    return A.reshape(n * d, n * d)
