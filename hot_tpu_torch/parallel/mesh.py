"""The rank mesh: one axis of D ranks, one process each.

Counterpart of ``hot_tpu.parallel.mesh.make_mesh``. The grid's x-planes
(mesh axis "x") are split into D contiguous slabs, one per rank; a Mesh
names the ranks and this process's place among them, and carries the
process group that every collective of ``parallel.halo`` runs on. hot_tpu's
``replicated``/``shard_leading`` shardings and ``loop_mesh_width`` (a
workaround for XLA:CPU's collective rendezvous) have no counterpart: each
rank holds its own tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Mesh:
    size: int                        # D, the ranks of the axis
    rank: int                        # this process's slab, 0 .. D - 1
    group: object = None             # torch.distributed process group; None for D = 1
    ranks: Optional[Tuple[int, ...]] = None   # global rank of each slab (None: 0 .. D - 1)

    def global_rank(self, slab: int) -> int:
        return slab if self.ranks is None else self.ranks[slab]

    @property
    def backend(self) -> Optional[str]:
        if self.group is None:
            return None
        import torch.distributed as dist

        return dist.get_backend(self.group)


def make_mesh(group=None) -> Mesh:
    """The mesh over `group`'s ranks (the default group when None and
    torch.distributed is initialised; one rank otherwise)."""
    import torch.distributed as dist

    if group is None and not (dist.is_available() and dist.is_initialized()):
        return Mesh(size=1, rank=0)
    if group is None:
        group = dist.group.WORLD
    size = dist.get_world_size(group)
    ranks = tuple(dist.get_global_rank(group, r) for r in range(size))
    return Mesh(size=size, rank=dist.get_rank(group), group=group, ranks=ranks)
