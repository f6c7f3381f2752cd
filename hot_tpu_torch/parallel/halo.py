"""Halo exchange, its adjoint and the reductions of the slab decomposition.

Counterpart of ``hot_tpu.parallel.halo``. A quadratic B-spline stencil
reaches 2 planes, so each rank's vectors extend over ghost planes on each
side that has a neighbour (rank 0 has none below, rank D - 1 none above:
the grid ends there, and a stencil clamped to the grid never reaches past
it):

  exchange_halo: fill the ghosts from the neighbours' boundary planes;
  fold_halo: send the ghost planes' partial sums back to their owners and
    add them there. It is the transpose of exchange_halo, so a scatter
    through fold and a gather through exchange stay adjoint across ranks
    and the distributed operator stays symmetric for CG.

``ppermute`` becomes ``torch.distributed.batch_isend_irecv`` to the two
neighbours and ``psum`` ``all_reduce``. Every collective runs on the mesh's
process group. The one place that moves data through host memory is
``_comm``: a gloo group given CUDA tensors (several ranks sharing one card,
where NCCL refuses two ranks on one device) sends host copies.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from hot_tpu_torch.parallel.mesh import Mesh


def _comm(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The tensor a collective of the mesh's group takes for t: a host copy
    when the group is gloo and t lives on a GPU."""
    if t.is_cuda and mesh.backend == "gloo":
        return t.detach().cpu()
    return t.contiguous()


def all_reduce_sum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of t over the ranks (psum); t itself for one rank."""
    if mesh.size == 1:
        return t
    import torch.distributed as dist

    buf = _comm(mesh, t).clone()
    dist.all_reduce(buf, group=mesh.group)
    return buf.to(t.device)


def all_reduce_max(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    if mesh.size == 1:
        return t
    import torch.distributed as dist

    buf = _comm(mesh, t).clone()
    dist.all_reduce(buf, op=dist.ReduceOp.MAX, group=mesh.group)
    return buf.to(t.device)


def barrier(mesh: Mesh):
    if mesh.size > 1:
        import torch.distributed as dist

        dist.barrier(group=mesh.group)


def all_gather(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's t (equal shapes) stacked along a new leading axis."""
    if mesh.size == 1:
        return t[None]
    import torch.distributed as dist

    src = _comm(mesh, t)
    bufs = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(bufs, src, group=mesh.group)
    return torch.stack(bufs).to(t.device)


def neighbour_exchange(mesh: Mesh, to_lo: Optional[torch.Tensor], to_hi: Optional[torch.Tensor],
                       from_lo_like: Optional[torch.Tensor],
                       from_hi_like: Optional[torch.Tensor]):
    """Send to_lo to rank - 1 and to_hi to rank + 1; receive tensors shaped
    like from_lo_like from rank - 1 and from_hi_like from rank + 1 (None
    where there is no neighbour). Returns (from_lo, from_hi)."""
    import torch.distributed as dist

    ops, recv = [], {}
    for side, peer, send, like in (("lo", mesh.rank - 1, to_lo, from_lo_like),
                                   ("hi", mesh.rank + 1, to_hi, from_hi_like)):
        if not 0 <= peer < mesh.size:
            continue
        g = mesh.global_rank(peer)
        ops.append(dist.P2POp(dist.isend, _comm(mesh, send), g, mesh.group))
        recv[side] = _comm(mesh, torch.empty_like(like))
        ops.append(dist.P2POp(dist.irecv, recv[side], g, mesh.group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    ref = from_lo_like if from_lo_like is not None else from_hi_like
    out = [recv[s].to(ref.device) if s in recv else None for s in ("lo", "hi")]
    return out[0], out[1]


def exchange_halo(v_planes: torch.Tensor, mesh: Mesh, lo: int, hi: int) -> torch.Tensor:
    """(P, ...) owned planes -> (lo + P + hi, ...): ghost planes [0, lo)
    from the rank below's top lo planes, the last hi from the rank above's
    bottom hi planes (lo = 0 on rank 0, hi = 0 on the last rank)."""
    if lo == 0 and hi == 0:
        return v_planes
    # the rank below receives my bottom planes as its top ghosts, and so on
    my_lo = v_planes[:lo] if lo else None
    my_hi = v_planes[v_planes.shape[0] - hi:] if hi else None
    ghost_lo, ghost_hi = neighbour_exchange(mesh, my_lo, my_hi, my_lo, my_hi)
    parts = [p for p in (ghost_lo, v_planes, ghost_hi) if p is not None]
    return torch.cat(parts, 0)


def fold_halo(acc: torch.Tensor, mesh: Mesh, lo: int, hi: int) -> torch.Tensor:
    """(lo + P + hi, ...) accumulated over the extended slab -> (P, ...)
    owned sums: each ghost block is added onto its owner's boundary planes.
    The adjoint of exchange_halo."""
    if lo == 0 and hi == 0:
        return acc
    P = acc.shape[0] - lo - hi
    send_lo = acc[:lo] if lo else None
    send_hi = acc[lo + P:] if hi else None
    from_lo, from_hi = neighbour_exchange(mesh, send_lo, send_hi, send_lo, send_hi)
    owned = acc[lo:lo + P].clone()
    if from_lo is not None:
        owned[:lo] += from_lo
    if from_hi is not None:
        owned[P - hi:] += from_hi
    return owned


def all_to_all(chunks: Sequence[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    """chunks[j] (n_j, ...) to rank j; returns what every rank sent here, in
    rank order. Counts go first, then the payload (all_to_all_single)."""
    if mesh.size == 1:
        return [chunks[0]]
    import torch.distributed as dist

    ref = chunks[0]
    counts = torch.tensor([c.shape[0] for c in chunks], dtype=torch.int64)
    dev_counts = _comm(mesh, counts.to(ref.device))
    got_buf = _comm(mesh, torch.empty_like(dev_counts))
    dist.all_to_all_single(got_buf, dev_counts, group=mesh.group)
    got = got_buf.cpu()
    send = _comm(mesh, torch.cat(list(chunks), 0))
    recv = torch.empty((int(got.sum()),) + tuple(ref.shape[1:]), dtype=send.dtype,
                       device=send.device)
    dist.all_to_all_single(recv, send, output_split_sizes=got.tolist(),
                           input_split_sizes=counts.tolist(), group=mesh.group)
    return list(torch.split(recv.to(ref.device), got.tolist()))
