"""The slab decomposition of a grid level and its one operator, and one
Newton system solved by CG over it.

Counterpart of ``hot_tpu.parallel.sharded`` (``ShardedSystem``,
``partition_system``, ``sharded_cg_solve``). The grid's x-planes are split
into D contiguous slabs of P planes; rank r owns planes [r P, (r + 1) P)
and keeps every grid vector over them, and its particles are those whose
base plane it owns. A ``Slab`` adds HALO ghost planes on each side that has
a neighbour (none beyond the grid: rank 0 has none below, rank D - 1 none
above); ``exchange`` fills them from the neighbours and ``fold`` sends the
partial sums scattered into them back to their owners.

``slab_apply`` is the matrix-free operator (M + dt^2 K) on a slab: the
rank's particles' Hessian applied over the extended slab
(``ops.fused_apply``), the ghosts exchanged in before and the partial
forces folded out after. The sharded step's CG, the matrix-free levels of
the sharded multigrid and ``sharded_cg_solve`` all run it. The
preconditioner of ``sharded_cg_solve`` is the inverse lumped mass, as
hot_tpu's, and every dot product is summed over the ranks, so each rank
takes the same iterations as one grid would.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Tuple

import torch

from hot_tpu_torch.ops import transfer
from hot_tpu_torch.ops.fused_apply import fused_apply, soa
from hot_tpu_torch.parallel import halo as halo_mod
from hot_tpu_torch.parallel.mesh import Mesh
from hot_tpu_torch.sim import objective as obj_mod
from hot_tpu_torch.solver.cg import CGResult, cg_solve

HALO = 2   # quadratic B-spline reach in planes


@dataclasses.dataclass(frozen=True)
class Slab:
    """One rank's slab of a grid level: owned planes [rank P, (rank + 1) P)
    and lo / hi ghost planes below / above (none beyond the grid)."""

    res: Tuple[int, ...]    # the level's global res
    planes: int             # P, owned planes
    rank: int
    lo: int
    hi: int

    @property
    def plane_nodes(self) -> int:
        return math.prod(int(r) for r in self.res[1:])

    @property
    def org(self) -> int:
        """Global plane of the extended slab's first plane."""
        return self.rank * self.planes - self.lo

    @property
    def ext_planes(self) -> int:
        return self.lo + self.planes + self.hi

    @property
    def ext_res(self) -> Tuple[int, ...]:
        return (self.ext_planes,) + tuple(self.res[1:])

    @property
    def n_owned(self) -> int:
        return self.planes * self.plane_nodes

    @property
    def n_ext(self) -> int:
        return self.ext_planes * self.plane_nodes

    def local_x(self, x, dx: float):
        """Positions in the extended slab's frame (axis 0 shifted down by
        org planes)."""
        if self.org == 0:
            return x
        shift = torch.zeros(x.shape[-1], dtype=x.dtype, device=x.device)
        shift[0] = self.org * dx
        return x - shift


def make_slab(res, n_ranks: int, rank: int, halo: int = HALO) -> Slab:
    res = tuple(int(r) for r in res)
    if res[0] % n_ranks:
        raise ValueError(f"res[0]={res[0]} does not split into {n_ranks} slabs")
    planes = res[0] // n_ranks
    if n_ranks > 1 and planes < halo:
        raise ValueError(f"a slab of {planes} planes is thinner than its {halo}-plane halo; "
                         "use fewer ranks or multigrid levels")
    return Slab(res=res, planes=planes, rank=rank, lo=min(halo, rank * planes),
                hi=min(halo, res[0] - (rank + 1) * planes))


def exchange(slab: Slab, mesh: Mesh, v):
    """Owned (n_owned, ...) -> extended (n_ext, ...) with the neighbours' ghosts."""
    vp = v.reshape((slab.planes, slab.plane_nodes) + v.shape[1:])
    return halo_mod.exchange_halo(vp, mesh, slab.lo, slab.hi).reshape((slab.n_ext,) + v.shape[1:])


def fold(slab: Slab, mesh: Mesh, acc):
    """Extended (n_ext, ...) partial sums -> owned (n_owned, ...) sums."""
    ap = acc.reshape((slab.ext_planes, slab.plane_nodes) + acc.shape[1:])
    return halo_mod.fold_halo(ap, mesh, slab.lo, slab.hi).reshape(
        (slab.n_owned,) + acc.shape[1:])


def owned_positions(slab: Slab, dx: float, dtype, device):
    """(n_owned, dim) global positions of the owned nodes."""
    coords = transfer.unravel(torch.arange(slab.n_owned, device=device),
                              (slab.planes,) + tuple(slab.res[1:]))
    coords[:, 0] += slab.rank * slab.planes
    return coords.to(dtype) * dx


def owner_of(x, dx: float, res, n_ranks: int):
    """Rank owning each particle: the slab of its base plane."""
    base = torch.floor(x[:, 0] / dx - 0.5).long().clamp(0, int(res[0]) - 1)
    return torch.div(base, int(res[0]) // n_ranks, rounding_mode="floor").clamp(max=n_ranks - 1)


def slab_apply(slab: Slab, mesh: Mesh, x_soa, dx: float, F_soa, hess: obj_mod.HessianState, V0,
               dt: float, grid_m, active, w, overlap: bool = False):
    """(M + dt^2 K) w on the owned nodes (w owned, (n_owned, d)); the
    identity on inactive nodes. x_soa are the rank's particles in the
    extended slab's frame. With `overlap` (``solver.overlap_halo``), the
    linearity split: the launch on the owned data does not wait for the
    exchange, and a second launch on the ghosts alone adds the neighbours'
    part."""
    def df_ext(w_ext):
        return fused_apply(w_ext, x_soa, dx, slab.ext_res, F_soa, hess.U, hess.V, hess.A,
                           hess.b_plus, hess.b_minus, V0, dt)

    if overlap:
        d = w.shape[-1]
        wp = w.reshape(slab.planes, slab.plane_nodes, d)
        zl, zh = (wp.new_zeros((k, slab.plane_nodes, d)) for k in (slab.lo, slab.hi))
        own = df_ext(torch.cat([zl, wp, zh]).reshape(slab.n_ext, d))
        ghosts = exchange(slab, mesh, w).reshape(slab.ext_planes, slab.plane_nodes, d)
        ghosts = torch.cat([ghosts[:slab.lo], torch.zeros_like(wp),
                            ghosts[slab.lo + slab.planes:]])
        df = own + df_ext(ghosts.reshape(slab.n_ext, d))
    else:
        df = df_ext(exchange(slab, mesh, w))
    out = grid_m[:, None] * w - dt * fold(slab, mesh, df)
    return torch.where(active[:, None], out, w)


def block_diag(slab: Slab, mesh: Mesh, st, F, ctx, V0, dt: float, grid_m, active, dim: int):
    """Per-node (d, d) blocks of M + dt^2 K on the owned nodes: the elastic
    blocks scattered over the extended slab and folded, the mass added."""
    ones = torch.ones(slab.n_ext, dtype=torch.bool, device=F.device)
    K = obj_mod.elastic_block_diag(st, F, ctx, V0, dt, torch.zeros_like(ones, dtype=F.dtype),
                                   ones, dim)
    K = fold(slab, mesh, K)
    eye = torch.eye(dim, dtype=F.dtype, device=F.device)
    return torch.where(active[:, None, None], grid_m[:, None, None] * eye + K, eye)


class ShardedSystem(NamedTuple):
    """The rank's part of one Newton system."""

    slab: Slab
    dx: float
    x_soa: torch.Tensor      # (d, n_r) the rank's particles in the extended slab's frame
    F_soa: torch.Tensor      # (d*d, n_r)
    hess: obj_mod.HessianState   # the rank's particles' columns
    V0: torch.Tensor
    grid_m: torch.Tensor     # (n_owned,)
    active: torch.Tensor
    proj: torch.Tensor       # (n_owned, d, d)
    dt: float


def partition_system(x, F, hess: obj_mod.HessianState, V0, grid_m, active, proj, dt: float,
                     dx: float, res, mesh: Mesh) -> ShardedSystem:
    """The rank's part of a global system (every rank passes the same one):
    particles x (n, d), F (n, d, d), the HessianState of all particles,
    grid arrays over the whole grid."""
    slab = make_slab(res, mesh.size, mesh.rank)
    mine = torch.nonzero(owner_of(x, dx, res, mesh.size) == mesh.rank).reshape(-1)
    lo = slab.rank * slab.n_owned
    own = slice(lo, lo + slab.n_owned)
    return ShardedSystem(
        slab=slab, dx=dx, x_soa=soa(slab.local_x(x[mine], dx)), F_soa=soa(F[mine]),
        hess=obj_mod.HessianState(*(t[:, mine].contiguous() for t in hess)), V0=V0[mine],
        grid_m=grid_m[own], active=active[own], proj=proj[own], dt=dt)


def apply(system: ShardedSystem, w, mesh: Mesh):
    """(M + dt^2 K) w on the owned nodes (``slab_apply``)."""
    s = system
    return slab_apply(s.slab, mesh, s.x_soa, s.dx, s.F_soa, s.hess, s.V0, s.dt, s.grid_m,
                      s.active, w)


def sharded_cg_solve(system: ShardedSystem, b, mesh: Mesh, *, tol: float = 1e-8,
                     max_iters: int = 1000) -> CGResult:
    """PCG on the owned part b (n_owned, d) of the right-hand side; x on
    the owned nodes, the same iterations on every rank."""
    s = system
    inv_m = torch.where(s.active, 1.0 / torch.clamp(s.grid_m, min=1e-30),
                        torch.ones_like(s.grid_m))

    def project(r):
        r = torch.einsum("nij,nj->ni", s.proj, r)
        return torch.where(s.active[:, None], r, torch.zeros_like(r))

    return cg_solve(lambda w: apply(s, w, mesh), b, precondition=lambda r: r * inv_m[:, None],
                    project=project, tol=tol, max_iters=max_iters,
                    reduce=lambda t: halo_mod.all_reduce_sum(t, mesh))
