"""Block-sparse tile grid: the active-tile table and compact node arrays.

Counterpart of ``hot_tpu.grid.sparse``. The uniform background grid is
stored in tiles of tile^dim nodes (4^3 = 64 in 3D, 4^2 = 16 in 2D), and
only the tiles that particle stencils touch exist:

  * ``tile_ids`` (T,): the active tiles' flat logical ids, sorted; a tile's
    slot is its position there;
  * ``lookup`` (n_tiles,) int32: logical tile -> slot, -1 if inactive;
  * node data lives in flat (T * tile^dim + 1, ...) arrays: the compact
    node id is slot * tile^dim + local id, the last axis contiguous inside a
    tile, and the final row is a dump slot that nothing active maps to, so
    the ``index_add_`` scatters of ``ops.transfer`` work unchanged on
    compact ids.

A particle's quadratic stencil spans at most two tiles per axis (tile >= 3
nodes), so activation takes the tiles of the stencil's 2^dim corners.

hot_tpu sizes the table to a static capacity for jit and flags an overflow
for a host-side regrow. Eager PyTorch sizes it to the active tiles (T =
n_active, ``torch.unique``); ``capacity`` stays a hard limit, and more
active tiles than it raise. With hot_tpu given capacity = n_active, the
slots, compact ids and node positions are the same.

A batch of B members (x (B, n, d), hot_tpu's ``jax.vmap`` over the step)
gets one tile set per member, as under ``vmap``: ``tile_ids`` (B, T) and
``lookup`` (B, n_tiles), every member padded to the most active tiles of
any member (T; ``counts`` holds each member's own). Per-node arrays keep
the batch's (B, n_cnodes, ...) layout, each member with its own trailing
dump row; a padding slot holds no particle, its nodes have no mass and
sit, like the dump row, far outside the domain, so a member's result does
not depend on how much padding the batch gives it. ``capacity`` is a limit
per member. Functions that take node coords or ids take a member
dimension in front (or ``member``, each entry's member, for flat arrays)
and return member-local compact ids.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from hot_tpu_torch.ops import transfer
from hot_tpu_torch.ops.bspline import quadratic_bspline_weights, stencil_offsets, tensor_weights
from hot_tpu_torch.utils.timing import h2d, synced

TILE = 4
# node position of the dump row (and of nothing else): far outside the
# domain, so colliders never constrain it
FAR = 1e9


@dataclasses.dataclass
class TileGrid:
    tile_ids: torch.Tensor  # (T,) int64 flat logical tile ids, sorted; a batch's (B, T)
    lookup: torch.Tensor    # (n_tiles,) int32 logical tile -> slot, -1 inactive; (B, n_tiles)
    res: Tuple[int, ...]
    tile: int = TILE
    counts: Optional[Tuple[int, ...]] = None    # a batch: each member's active tiles

    @property
    def batch(self) -> Optional[int]:
        """The members of a batch's tile grid, None for one."""
        return None if self.counts is None else len(self.counts)

    @property
    def member_tiles(self) -> list:
        """Each member's active tiles (one entry for one grid)."""
        return [self.n_active] if self.counts is None else list(self.counts)

    def member(self, b: int) -> "TileGrid":
        """Member b's own tile grid (its unpadded slots)."""
        return TileGrid(tile_ids=self.tile_ids[b, :self.counts[b]], lookup=self.lookup[b],
                        res=self.res, tile=self.tile)

    @property
    def dim(self) -> int:
        return len(self.res)

    @property
    def tile_res(self) -> Tuple[int, ...]:
        return tuple(-(-int(r) // self.tile) for r in self.res)

    @property
    def n_tiles_logical(self) -> int:
        return transfer.n_nodes_of(self.tile_res)

    @property
    def n_active(self) -> int:
        """Tile slots per member (a batch's: the most active tiles of any member)."""
        return int(self.tile_ids.shape[-1])

    @property
    def tile_nodes(self) -> int:
        return self.tile ** self.dim

    @property
    def n_cnodes(self) -> int:
        """Compact node-array length, the trailing dump row included."""
        return self.n_active * self.tile_nodes + 1

    @property
    def dump(self) -> int:
        return self.n_active * self.tile_nodes


def _tile_strides(tile_res, device):
    return transfer._row_major_strides(tile_res, device)


def _local_strides(dim: int, tile: int, device):
    return h2d(torch.tensor([tile ** (dim - 1 - a) for a in range(dim)], dtype=torch.long,
                            device=device))


def build_tile_grid(x, dx: float, res: Tuple[int, ...], capacity: int,
                    tile: int = TILE) -> TileGrid:
    """Activate the tiles that the particles' quadratic stencils touch, per
    member for a batch's x (B, n, d). Raises RuntimeError if more than
    `capacity` tiles are active (in any member)."""
    if x.ndim == 3:
        grids = [build_tile_grid(xb, dx, res, capacity, tile) for xb in x]
        T = max(g.n_active for g in grids)
        # padding slots take logical tile 0; nothing maps to them
        tile_ids = torch.stack([torch.cat([g.tile_ids, g.tile_ids.new_zeros(T - g.n_active)])
                                for g in grids])
        return TileGrid(tile_ids=tile_ids, lookup=torch.stack([g.lookup for g in grids]),
                        res=grids[0].res, tile=tile, counts=tuple(g.n_active for g in grids))
    dim = x.shape[-1]
    res = tuple(int(r) for r in res)
    device = x.device
    tile_res = tuple(-(-r // tile) for r in res)
    hi = h2d(torch.tensor(res, dtype=torch.long, device=device)) - 1
    base, _, _ = quadratic_bspline_weights(x, dx)
    base = torch.minimum(base.clamp(min=0), hi)
    corners = (base, torch.minimum(base + 2, hi))
    strides = _tile_strides(tile_res, device)
    cand = []
    for mask in range(2 ** dim):
        corner = torch.stack([corners[(mask >> a) & 1][:, a] for a in range(dim)], dim=-1)
        cand.append(((corner // tile) * strides).sum(-1))
    tile_ids = synced(torch.unique(torch.cat(cand)))
    n_active = int(tile_ids.shape[0])
    if n_active > capacity:
        raise RuntimeError(f"sparse tile capacity exceeded ({n_active} of {capacity} tiles); "
                           "raise cfg.tile_capacity")
    lookup = torch.full((transfer.n_nodes_of(tile_res),), -1, dtype=torch.int32, device=device)
    lookup[tile_ids] = torch.arange(n_active, dtype=torch.int32, device=device)
    return TileGrid(tile_ids=tile_ids, lookup=lookup, res=res, tile=tile)


def _member_index(grid: TileGrid, like, member):
    """The member of each entry of `like` (..., ): `member` if given, else
    the leading (member) dimension of a batch's array; None for one grid."""
    if grid.batch is None:
        return None
    if member is not None:
        return member
    return torch.arange(grid.batch, device=like.device).reshape((-1,) + (1,) * (like.ndim - 1))


def compact_node_id(grid: TileGrid, coords, member=None):
    """Integer node coords (..., dim) -> compact node ids (int64; the dump
    row where the tile is inactive). A batch's coords (B, ..., dim), or flat
    ones with `member`, give each member's own (member-local) ids."""
    tile = grid.tile
    tcoord = torch.div(coords, tile, rounding_mode="floor")
    tid = (tcoord * _tile_strides(grid.tile_res, coords.device)).sum(-1)
    tid = tid.clamp(0, grid.n_tiles_logical - 1)
    b = _member_index(grid, tid, member)
    slot = (grid.lookup[tid] if b is None else grid.lookup[b, tid]).long()
    lid = ((coords - tcoord * tile) * _local_strides(grid.dim, tile, coords.device)).sum(-1)
    return torch.where(slot >= 0, slot * grid.tile_nodes + lid,
                       torch.full_like(lid, grid.dump))


def compact_node_coords(grid: TileGrid, ids, member=None):
    """Compact node ids (...,) below the dump row -> integer coords (..., dim);
    member-local ids of a batch as in compact_node_id."""
    tn = grid.tile_nodes
    slot = torch.div(ids, tn, rounding_mode="floor")
    b = _member_index(grid, slot, member)
    tiles = grid.tile_ids[slot] if b is None else grid.tile_ids[b, slot]
    tcoord = transfer.unravel(tiles, grid.tile_res)
    local = transfer.unravel(ids - slot * tn, (grid.tile,) * grid.dim)
    return tcoord * grid.tile + local


def sparse_stencil(x, dx: float, grid: TileGrid) -> transfer.Stencil:
    """The quadratic particle stencil with compact node ids: the same
    weights, gradients and offsets as ``transfer.particle_stencil``; a
    batch's x (B, n, d) on its tile grid gives member ids offset by
    b * n_cnodes, as ``transfer.particle_stencil`` offsets a batch's."""
    dim = x.shape[-1]
    base, w, dw = quadratic_bspline_weights(x, dx)
    wn, gwn = tensor_weights(w, dw)
    offs = stencil_offsets(dim, 3, device=x.device)
    hi = h2d(torch.tensor(grid.res, dtype=torch.long, device=x.device)) - 1
    coords = torch.minimum((base[..., None, :] + offs).clamp(min=0), hi)
    rel = coords.to(x.dtype) * dx - x[..., None, :]
    node_ids = compact_node_id(grid, coords)
    if grid.batch is not None:
        node_ids = node_ids + transfer.member_offsets(grid.batch, grid.n_cnodes, x.device)
    return transfer.Stencil(node_ids=node_ids, wn=wn, gwn=gwn, rel=rel)


def slot_nodes(grid: TileGrid):
    """(n_cnodes,) bool, a batch's (B, n_cnodes): the nodes of a member's
    own active tiles (neither padding nor the dump row)."""
    ids = torch.arange(grid.n_cnodes, device=grid.lookup.device)
    counts = h2d(torch.tensor(grid.member_tiles, device=ids.device))[:, None]
    mask = ids < counts * grid.tile_nodes
    return mask if grid.batch is not None else mask[0]


def node_positions(grid: TileGrid, dx: float, dtype=torch.float32):
    """(n_cnodes, dim) physical positions of the compact nodes, a batch's
    (B, n_cnodes, dim); the dump row and a batch's padding nodes sit far
    outside the domain."""
    ids = torch.arange(grid.dump, device=grid.lookup.device)
    if grid.batch is not None:
        ids = ids.expand(grid.batch, -1)
    pos = compact_node_coords(grid, ids).to(dtype) * dx
    far = torch.full(pos.shape[:-2] + (1, grid.dim), FAR, dtype=dtype, device=pos.device)
    pos = torch.cat([pos, far], dim=-2)
    if grid.batch is not None:
        pos = torch.where(slot_nodes(grid)[..., None], pos, far)
    return pos


def compact_to_dense(grid: TileGrid, v, fill=0.0):
    """Scatter compact node values (n_cnodes, ...) onto the dense logical
    grid (n_nodes, ...); nodes outside active tiles get `fill`. A batch's
    (B, n_cnodes, ...) gives (B, n_nodes, ...)."""
    if grid.batch is not None:
        return torch.stack([compact_to_dense(grid.member(b), v[b], fill)
                            for b in range(grid.batch)])
    ids = torch.arange(grid.dump, device=v.device)
    coords = compact_node_coords(grid, ids)
    hi = h2d(torch.tensor(grid.res, dtype=torch.long, device=v.device))
    inside = synced(((coords < hi).all(-1)).nonzero()).reshape(-1)   # tiles overhang the grid
    dense = (coords[inside] * transfer._row_major_strides(grid.res, v.device)).sum(-1)
    out = torch.full((transfer.n_nodes_of(grid.res),) + tuple(v.shape[1:]), fill,
                     dtype=v.dtype, device=v.device)
    out[dense] = v[inside]
    return out

