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
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from hot_tpu_torch.ops import transfer
from hot_tpu_torch.ops.bspline import quadratic_bspline_weights, stencil_offsets, tensor_weights

TILE = 4
# node position of the dump row (and of nothing else): far outside the
# domain, so colliders never constrain it
FAR = 1e9


@dataclasses.dataclass
class TileGrid:
    tile_ids: torch.Tensor  # (T,) int64 flat logical tile ids, sorted
    lookup: torch.Tensor    # (n_tiles,) int32 logical tile -> slot, -1 inactive
    res: Tuple[int, ...]
    tile: int = TILE

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
        return int(self.tile_ids.shape[0])

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
    return torch.tensor([tile ** (dim - 1 - a) for a in range(dim)], dtype=torch.long,
                        device=device)


def build_tile_grid(x, dx: float, res: Tuple[int, ...], capacity: int,
                    tile: int = TILE) -> TileGrid:
    """Activate the tiles that the particles' quadratic stencils touch.
    Raises RuntimeError if more than `capacity` tiles are active."""
    dim = x.shape[-1]
    res = tuple(int(r) for r in res)
    device = x.device
    tile_res = tuple(-(-r // tile) for r in res)
    hi = torch.tensor(res, dtype=torch.long, device=device) - 1
    base, _, _ = quadratic_bspline_weights(x, dx)
    base = torch.minimum(base.clamp(min=0), hi)
    corners = (base, torch.minimum(base + 2, hi))
    strides = _tile_strides(tile_res, device)
    cand = []
    for mask in range(2 ** dim):
        corner = torch.stack([corners[(mask >> a) & 1][:, a] for a in range(dim)], dim=-1)
        cand.append(((corner // tile) * strides).sum(-1))
    tile_ids = torch.unique(torch.cat(cand))
    n_active = int(tile_ids.shape[0])
    if n_active > capacity:
        raise RuntimeError(f"sparse tile capacity exceeded ({n_active} of {capacity} tiles); "
                           "raise cfg.tile_capacity")
    lookup = torch.full((transfer.n_nodes_of(tile_res),), -1, dtype=torch.int32, device=device)
    lookup[tile_ids] = torch.arange(n_active, dtype=torch.int32, device=device)
    return TileGrid(tile_ids=tile_ids, lookup=lookup, res=res, tile=tile)


def compact_node_id(grid: TileGrid, coords):
    """Integer node coords (..., dim) -> compact node ids (int64; the dump
    row where the tile is inactive)."""
    tile = grid.tile
    tcoord = torch.div(coords, tile, rounding_mode="floor")
    tid = (tcoord * _tile_strides(grid.tile_res, coords.device)).sum(-1)
    slot = grid.lookup[tid.clamp(0, grid.n_tiles_logical - 1)].long()
    lid = ((coords - tcoord * tile) * _local_strides(grid.dim, tile, coords.device)).sum(-1)
    return torch.where(slot >= 0, slot * grid.tile_nodes + lid,
                       torch.full_like(lid, grid.dump))


def compact_node_coords(grid: TileGrid, ids):
    """Compact node ids (...,) below the dump row -> integer coords (..., dim)."""
    tn = grid.tile_nodes
    slot = torch.div(ids, tn, rounding_mode="floor")
    tcoord = transfer.unravel(grid.tile_ids[slot], grid.tile_res)
    local = transfer.unravel(ids - slot * tn, (grid.tile,) * grid.dim)
    return tcoord * grid.tile + local


def sparse_stencil(x, dx: float, grid: TileGrid) -> transfer.Stencil:
    """The quadratic particle stencil with compact node ids: the same
    weights, gradients and offsets as ``transfer.particle_stencil``."""
    dim = x.shape[-1]
    base, w, dw = quadratic_bspline_weights(x, dx)
    wn, gwn = tensor_weights(w, dw)
    offs = stencil_offsets(dim, 3, device=x.device)
    hi = torch.tensor(grid.res, dtype=torch.long, device=x.device) - 1
    coords = torch.minimum((base[:, None, :] + offs[None, :, :]).clamp(min=0), hi)
    rel = coords.to(x.dtype) * dx - x[:, None, :]
    return transfer.Stencil(node_ids=compact_node_id(grid, coords), wn=wn, gwn=gwn, rel=rel)


def node_positions(grid: TileGrid, dx: float, dtype=torch.float32):
    """(n_cnodes, dim) physical positions of the compact nodes; the dump row
    sits far outside the domain."""
    ids = torch.arange(grid.dump, device=grid.lookup.device)
    pos = compact_node_coords(grid, ids).to(dtype) * dx
    far = torch.full((1, grid.dim), FAR, dtype=dtype, device=pos.device)
    return torch.cat([pos, far], dim=0)


def compact_to_dense(grid: TileGrid, v, fill=0.0):
    """Scatter compact node values (n_cnodes, ...) onto the dense logical
    grid (n_nodes, ...); nodes outside active tiles get `fill`."""
    ids = torch.arange(grid.dump, device=v.device)
    coords = compact_node_coords(grid, ids)
    hi = torch.tensor(grid.res, dtype=torch.long, device=v.device)
    inside = ((coords < hi).all(-1)).nonzero().reshape(-1)   # tiles may overhang the grid
    dense = (coords[inside] * transfer._row_major_strides(grid.res, v.device)).sum(-1)
    out = torch.full((transfer.n_nodes_of(grid.res),) + tuple(v.shape[1:]), fill,
                     dtype=v.dtype, device=v.device)
    out[dense] = v[inside]
    return out

