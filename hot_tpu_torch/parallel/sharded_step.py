"""The sharded implicit step: P2G, Newton and G2P on a rank's slab, particle
migration, the sharded simulation and its checkpoints.

Counterpart of ``hot_tpu.parallel.sharded_step``. The grid's x-planes are
split into D contiguous slabs (``parallel.sharded``); rank r keeps every
grid vector over the planes it owns, and its particles are those whose
base plane it owns. Each rank runs the step of ``sim.simulation`` on its
extended slab, the owned planes with HALO ghost planes on each side that
has a neighbour:

  P2G    scatter into the extended slab, fold the ghosts to their owners;
  BC     at the owned nodes' global positions;
  Newton linearize -> preconditioner -> CG {Hessian apply, ``slab_apply``}:
         both particle kernels launch on the rank's particles over the
         extended slab (the grid vector exchanged in, the forces folded
         out), every dot
         product, norm and slope summed over the ranks, so every rank
         takes the same Newton and CG iterations;
  G2P    exchange the ghosts, then ``sim.simulation.update_particles``.

``ShardedSimulation`` is ``sim.Simulation``'s frame loop with the
partition, the reductions and migration in its hooks.

The particle kernels take a slab as they take any grid: the particles'
positions shifted down by the slab's first plane (a whole number of planes,
so the B-spline weights do not change) on the slab's extended res. A
stencil clamped to the slab's edge is clamped to the grid's edge there: a
slab has no ghost planes beyond the grid (rank 0 below, rank D - 1 above),
and inside the grid a particle's stencil never reaches past its slab's
ghosts. The kernels' plain versions read the same stencil.

Eager PyTorch sizes each rank's particles to what it holds, so hot_tpu's
static capacities (n_max, migrate_cap), its padding slots and its overflow
fallback (the plain block step and the one global repartition) have no
counterpart: migration (``migrate``) sends any number of particles to any
rank, with their global ids, and a destination beyond the grid raises.

The sharded step runs hot_tpu's sharded configuration: the dense grid,
quadratic transfers, implicit Newton with CG and the matrix-free outer
Hessian, with the none, Jacobi, block-Jacobi or multigrid preconditioner
(``parallel.sharded_mg``), and ``solver.overlap_halo``. Every other value of
the settings hot_tpu's sharded step does not read raises NotImplementedError
(``check_sharded``), as does a batch.
"""

from __future__ import annotations

import glob
import math
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from hot_tpu_torch.models import constitutive as cm
from hot_tpu_torch.ops import transfer
from hot_tpu_torch.ops.fused_apply import soa
from hot_tpu_torch.ops.fused_linearize import fused_linearize
from hot_tpu_torch.parallel import halo as halo_mod
from hot_tpu_torch.parallel.distributed import checkpoint_spec
from hot_tpu_torch.parallel.mesh import Mesh
from hot_tpu_torch.parallel.sharded import (Slab, block_diag, exchange, fold, make_slab,
                                            owned_positions, owner_of, slab_apply)
from hot_tpu_torch.sim import collision
from hot_tpu_torch.sim import objective as obj_mod
from hot_tpu_torch.sim.simulation import PLASTICITY, Simulation, StepStats, update_particles
from hot_tpu_torch.sim.state import FIELDS, ParticleState
from hot_tpu_torch.solver.newton import newton_solve
from hot_tpu_torch.utils.config import SimConfig
from hot_tpu_torch.utils.metrics import MetricsLogger
from hot_tpu_torch.utils.timing import h2d, span, synced

def check_sharded(cfg: SimConfig, batched: bool = False):
    """Refuse what hot_tpu's sharded step does not run (it reads none of
    these settings, so it would run its own configuration in their place)."""
    sol = cfg.solver
    refused = [
        (batched, "a batch of states under a device mesh"),
        (cfg.grid_backend != "dense", f"grid_backend={cfg.grid_backend!r}"),
        (cfg.transfer_kernel != "quadratic", f"transfer_kernel={cfg.transfer_kernel!r}"),
        (sol.integrator != "implicit", f"solver.integrator={sol.integrator!r}"),
        (sol.nonlinear != "newton", f"solver.nonlinear={sol.nonlinear!r}"),
        (sol.linear_solver != "cg", f"solver.linear_solver={sol.linear_solver!r}"),
        (not sol.matrix_free, "solver.matrix_free=False"),
        (sol.line_search, "solver.line_search=True"),
        (cfg.transfer != "apic", f"transfer={cfg.transfer!r}"),
    ]
    for bad, what in refused:
        if bad:
            raise NotImplementedError(f"the sharded step does not run {what}")
    if sol.preconditioner == "multigrid":
        from hot_tpu_torch.parallel.sharded_mg import check_multigrid

        check_multigrid(sol.multigrid)
    elif sol.preconditioner not in ("none", "jacobi", "block_jacobi"):
        raise ValueError(f"unknown preconditioner '{sol.preconditioner}'")


def sharded_step(ps: ParticleState, dt: float, t: float, *, mesh: Mesh, cfg: SimConfig, model,
                 colliders: Sequence[collision.Collider],
                 plasticity: Optional[str] = None) -> Tuple[ParticleState, StepStats]:
    """One step of this rank's particles `ps` (those it owns) at time t:
    (particles, global stats); the particles may have left the slab
    (``migrate`` moves them). Every rank calls it together."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check_sharded(cfg, ps.batch is not None)
    sol = cfg.solver
    dim, dx = cfg.dim, cfg.dx
    res = tuple(int(r) for r in cfg.grid_res[:dim])
    dtype, device = ps.x.dtype, ps.x.device
    slab = make_slab(res, mesh.size, mesh.rank)
    reduce = lambda s: halo_mod.all_reduce_sum(s, mesh)  # noqa: E731

    # ---- stencil on the extended slab, P2G
    x_loc = slab.local_x(ps.x, dx)
    st = transfer.particle_stencil(x_loc, dx, slab.ext_res)
    n_ext = slab.n_ext

    def scatter_fold(values):
        return fold(slab, mesh, transfer.scatter_sum(st.node_ids, values, n_ext))

    mw, mv = transfer.apic_momentum_vals(st, ps.v, ps.C, ps.m)
    grid_m, grid_mv = scatter_fold(mw), scatter_fold(mv)
    active = grid_m > 0
    inv_m = torch.where(active, 1.0 / torch.clamp(grid_m, min=1e-30), torch.zeros_like(grid_m))
    v_grid = grid_mv * inv_m[:, None]

    # ---- BC at the owned nodes' global positions
    gravity = h2d(torch.tensor(cfg.gravity[:dim], dtype=dtype, device=device))
    v_star = v_grid + dt * gravity
    node_pos = owned_positions(slab, dx, dtype, device)
    proj, v_bc, constrained = collision.grid_boundary_conditions(
        node_pos, t, colliders, grid_v=v_star, boundary_margin=2, res=res, dx=dx)
    v0 = collision.apply_bc_to_velocity(v_star, proj, v_bc)

    # ---- objective on the slab
    stiff = ps.V0 * (2.0 * ps.mu + ps.lam) / dx
    f_char = scatter_fold(st.wn * stiff[:, None])
    cn_scale = torch.maximum(dt * f_char, grid_m * dx / dt)
    cn_scale = torch.where(active, cn_scale, torch.ones_like(cn_scale))
    x_soa, F_soa = soa(x_loc), soa(ps.F)

    def project(r):
        r = torch.einsum("nij,nj->ni", proj, r)
        return torch.where(active[:, None], r, torch.zeros_like(r))

    def linearize(v):
        f, U, V, A, bp, bm = fused_linearize(
            exchange(slab, mesh, v), x_soa, dx, slab.ext_res, F_soa, ps.mu, ps.lam, ps.V0, dt,
            model, project=sol.project_hessian)
        r = grid_m[:, None] * (v - v_star) - dt * fold(slab, mesh, f)
        return project(r), obj_mod.HessianState(U=U, V=V, A=A, b_plus=bp, b_minus=bm)

    def multiply(h, w):
        return slab_apply(slab, mesh, x_soa, dx, F_soa, h, ps.V0, dt, grid_m, active, w,
                          overlap=sol.overlap_halo)

    n_active = reduce(torch.sum(active).to(dtype))

    def cn_norm(r):
        scaled = r / cn_scale[:, None]
        return torch.sqrt(reduce(torch.sum(scaled * scaled)) / torch.clamp(n_active, min=1.0))

    # ---- preconditioner
    if sol.preconditioner == "none":
        build_precond, precond = (lambda h: None), (lambda pre, r: r)
    elif sol.preconditioner == "jacobi":
        inv_mj = torch.where(active, 1.0 / torch.clamp(grid_m, min=1e-30),
                             torch.ones_like(grid_m))
        build_precond, precond = (lambda h: None), (lambda pre, r: r * inv_mj[:, None])
    elif sol.preconditioner == "block_jacobi":
        def build_precond(h):
            return obj_mod.sym_block_inv(block_diag(slab, mesh, x_soa, dx, F_soa, h, ps.V0, dt,
                                                    grid_m, active))

        precond = lambda Dinv, r: torch.einsum("nij,nj->ni", Dinv, r)  # noqa: E731
    else:
        from hot_tpu_torch.parallel import sharded_mg as smg

        mgc = sol.multigrid
        hier = smg.build_static(ps.x, ps.m, res, dx, mgc, constrained, mesh, dtype)

        def build_precond(h):
            return smg.build_precond(hier, ps.F, h, ps.V0, dt, mgc, dim, mesh)

        precond = lambda pre, r: smg.mg_precondition(hier, pre, dt, mgc, r, mesh)  # noqa: E731

    result = newton_solve(
        linearize=linearize, multiply=multiply, project=project, precondition=precond,
        build_preconditioner=build_precond, cn_norm=cn_norm, v0=v0,
        max_newton=sol.max_newton, cn_eps=sol.cn_eps if sol.use_cn else 0.0,
        abs_tol=sol.abs_tol, cg_tol=sol.cg_tol, max_cg=sol.max_cg,
        adaptive_forcing=sol.adaptive_forcing, precond_refresh=sol.precond_refresh,
        reduce=reduce)
    v_new = collision.apply_bc_to_velocity(result.v, proj, v_bc)

    # ---- G2P from the extended slab and the particle update
    new = update_particles(ps, st, exchange(slab, mesh, v_new), None, dt, cfg, plasticity)
    v_pic, F_new = new.v, new.F

    # ---- global diagnostics (one all-reduce)
    if cfg.compute_energy:
        pe = torch.sum(ps.V0 * cm.psi_from_F(model, F_new, ps.mu, ps.lam))
    else:
        pe = torch.zeros((), dtype=dtype, device=device)
    sums = reduce(torch.stack([0.5 * torch.sum(ps.m * torch.sum(v_pic * v_pic, -1)), pe,
                               torch.sum(active).to(dtype)]))
    vmax = halo_mod.all_reduce_max(torch.linalg.norm(v_pic, dim=-1).amax()
                                   if ps.n else torch.zeros((), dtype=dtype, device=device), mesh)
    ke, pe, n_act = synced(sums.tolist())
    stats = StepStats(
        newton_iters=result.iters, cg_iters=result.cg_iters, cn_residual=result.cn_residual,
        cn_residual0=result.cn_residual0, converged=result.converged,
        max_velocity=synced(float(vmax)), kinetic_energy=ke, potential_energy=pe,
        active_nodes=int(n_act), ls_backtracks=result.ls_backtracks)
    return new, stats


# ---------------------------------------------------------------------------
# particles across ranks: partition, migration, gathering
# ---------------------------------------------------------------------------


def _take(ps: ParticleState, idx) -> ParticleState:
    return ParticleState(**{f: getattr(ps, f)[idx] for f in FIELDS})


def partition(state: ParticleState, ids, mesh: Mesh, cfg: SimConfig):
    """This rank's particles of a global `state` (every rank passes the same
    one) and their global ids, in the state's order."""
    res = cfg.grid_res[:cfg.dim]
    owner = owner_of(state.x, cfg.dx, res, mesh.size)
    mine = torch.nonzero(owner == mesh.rank).reshape(-1)
    return _take(state, mine), ids[mine]


def _pack(ps: ParticleState):
    return torch.cat([getattr(ps, f).reshape(ps.n, _width(f, ps.dim)) for f in FIELDS], 1)


def _width(field: str, dim: int) -> int:
    return {"x": dim, "v": dim, "Cf": dim * dim, "Ff": dim * dim}.get(field, 1)


def _unpack(flat, dim: int) -> ParticleState:
    out, c = {}, 0
    for f in FIELDS:
        w = _width(f, dim)
        col = flat[:, c:c + w]
        out[f] = (col if f in ("x", "v", "Cf", "Ff") else col.reshape(-1)).contiguous()
        c += w
    return ParticleState(**out)


def migrate(ps: ParticleState, ids, mesh: Mesh, cfg: SimConfig):
    """Send every particle whose base plane left this rank's slab to its
    new owner (all_to_all: counts, then the fields and the ids). Returns
    (particles, ids, number sent from this rank). Raises for a particle
    whose base plane is outside the grid."""
    res = cfg.grid_res[:cfg.dim]
    base = torch.floor(ps.x[:, 0] / cfg.dx - 0.5).long()
    if ps.n and synced(bool(((base < 0) | (base >= int(res[0]))).any())):
        raise RuntimeError("a particle's base plane left the grid")
    if mesh.size == 1:
        return ps, ids, 0
    dest = owner_of(ps.x, cfg.dx, res, mesh.size)
    order = torch.argsort(dest, stable=True)
    counts = synced(torch.bincount(dest, minlength=mesh.size).tolist())
    flat, sid = _pack(ps)[order], ids[order]
    got = halo_mod.all_to_all(list(torch.split(flat, counts)), mesh)
    got_ids = halo_mod.all_to_all(list(torch.split(sid, counts)), mesh)
    sent = ps.n - counts[mesh.rank]
    # keep the stayers first, in their order, then arrivals by source rank
    keep = [got[mesh.rank]] + [g for r, g in enumerate(got) if r != mesh.rank]
    keep_ids = [got_ids[mesh.rank]] + [g for r, g in enumerate(got_ids) if r != mesh.rank]
    return _unpack(torch.cat(keep, 0), cfg.dim), torch.cat(keep_ids, 0), sent


def gather_state(ps: ParticleState, ids, n: int, mesh: Mesh) -> ParticleState:
    """The global state on every rank, in id order."""
    if mesh.size == 1:
        order = torch.argsort(ids)
        return _take(ps, order)
    counts = halo_mod.all_gather(torch.tensor([ps.n], device=ps.x.device), mesh).reshape(-1)
    n_max = int(counts.max())
    flat = _pack(ps)
    pad = flat.new_zeros((n_max - ps.n, flat.shape[1]))
    all_flat = halo_mod.all_gather(torch.cat([flat, pad]), mesh)
    all_ids = halo_mod.all_gather(torch.cat([ids, ids.new_full((n_max - ps.n,), -1)]), mesh)
    keep = all_ids.reshape(-1) >= 0
    flat, gids = all_flat.reshape(-1, flat.shape[1])[keep], all_ids.reshape(-1)[keep]
    if gids.shape[0] != n:
        raise RuntimeError(f"gathered {gids.shape[0]} particles of {n}")
    out = torch.empty_like(flat)
    out[gids] = flat
    return _unpack(out, ps.dim)


# ---------------------------------------------------------------------------
# the frame loop and its checkpoints
# ---------------------------------------------------------------------------


class ShardedSimulation(Simulation):
    """``sim.Simulation``'s frame loop (CFL dt, the step with dt-halving
    retries, metrics) over the slab decomposition (hot_tpu's
    ShardedSimulation): this rank's particles ``ps`` and their global ids,
    ``state`` the global state in id order (gathered, a collective; setting
    it partitions a global state), the CFL dt and the retry decision over
    every rank, migration after every step, and sharded checkpoints. Every
    rank builds it from the same global state (seeded once, so the rank
    count does not change the particles) and calls every method together."""

    def __init__(self, mesh: Mesh, cfg: SimConfig, state: ParticleState, model,
                 colliders: Sequence[collision.Collider] = (),
                 plasticity: Optional[str] = None, metrics: Optional[MetricsLogger] = None):
        self.mesh, self.migrated = mesh, 0
        super().__init__(cfg, state, model, colliders, plasticity, metrics)

    def _check(self, cfg: SimConfig, plasticity, state: ParticleState):
        check_sharded(cfg, state.batch is not None)
        if plasticity is not None and plasticity not in PLASTICITY:
            raise ValueError(f"unknown plasticity '{plasticity}'; have {PLASTICITY}")
        make_slab(cfg.grid_res[:cfg.dim], self.mesh.size, self.mesh.rank)

    @property
    def state(self) -> ParticleState:
        return gather_state(self.ps, self.ids, self.n, self.mesh)

    @state.setter
    def state(self, state: ParticleState):
        self.n = state.n
        self.ps, self.ids = partition(state, torch.arange(state.n, device=state.x.device),
                                      self.mesh, self.cfg)

    def _max_speed(self) -> float:
        vmax = (torch.linalg.norm(self.ps.v, dim=-1).amax() if self.ps.n
                else torch.zeros((), dtype=self.ps.x.dtype, device=self.ps.x.device))
        return synced(float(halo_mod.all_reduce_max(vmax, self.mesh)))

    def _attempt(self, dt: float):
        with span("attempt"):
            new, stats = sharded_step(self.ps, dt, self.t, mesh=self.mesh, cfg=self.cfg,
                                      model=self.model, colliders=self.colliders,
                                      plasticity=self.plasticity)
        # the stats are global, so every rank takes the same decision
        finite = math.isfinite(stats.cn_residual) and synced(bool(halo_mod.all_reduce_sum(
            (~torch.isfinite(new.x)).sum(), self.mesh) == 0))
        return new, stats, finite

    def _accept(self, new: ParticleState):
        with span("migrate"):
            self.ps, self.ids, sent = migrate(new, self.ids, self.mesh, self.cfg)
        self.migrated += synced(int(halo_mod.all_reduce_sum(
            h2d(torch.tensor(sent, device=self.ps.x.device)), self.mesh)))

    def save_checkpoint(self, dirpath: str):
        save_sharded_checkpoint(dirpath, self.ps, self.ids, self.t, self.step_count,
                                self.mesh, self.cfg)

    def restore(self, dirpath: str):
        """Continue from a sharded checkpoint directory of either package,
        written by any number of ranks."""
        self.state, _, self.t, self.step_count = load_sharded_checkpoint(
            dirpath, device=self.ps.x.device, dtype=self.ps.x.dtype)


def _pad_rows(ps: ParticleState, n_max: int, slab: Slab, dx: float, res):
    """hot_tpu's padding slots: zero mass at the slab's centre, F = I."""
    k, d = n_max - ps.n, ps.dim
    pad_x = torch.tensor([(slab.rank + 0.5) * slab.planes * dx]
                         + [0.5 * int(r) * dx for r in res[1:]], dtype=ps.x.dtype)
    eye = torch.eye(d, dtype=ps.x.dtype).reshape(-1)
    fill = dict(x=pad_x, v=torch.zeros(d, dtype=ps.x.dtype), Cf=torch.zeros(d * d),
                Ff=eye, m=0.0, V0=0.0, mu=0.0, lam=0.0, yield_stress=math.inf, Jp=1.0)
    out = {}
    for f in FIELDS:
        a = getattr(ps, f).detach().cpu().numpy()
        pad = np.broadcast_to(np.asarray(fill[f], dtype=a.dtype), (k,) + a.shape[1:])
        out[f] = np.concatenate([a, pad])[None]
    return out


def save_sharded_checkpoint(dirpath: str, ps: ParticleState, ids, t: float, step_count: int,
                            mesh: Mesh, cfg: SimConfig):
    """Each rank writes its slab's row to shard_p{rank:04d}.npz, hot_tpu's
    layout: __rows, __n_rows, __t, __step_count, __ids and every field as
    (1, n_max, ...) rows, padded to the ranks' largest count with hot_tpu's
    padding slots (id -1), so hot_tpu's load_sharded_checkpoint reads it."""
    os.makedirs(dirpath, exist_ok=True)
    n_max = int(halo_mod.all_reduce_max(torch.tensor(ps.n, device=ps.x.device), mesh))
    slab = make_slab(cfg.grid_res[:cfg.dim], mesh.size, mesh.rank)
    rows = _pad_rows(ps, n_max, slab, cfg.dx, cfg.grid_res[:cfg.dim])
    pid = np.full((1, n_max), -1, np.int32)
    pid[0, :ps.n] = ids.cpu().numpy()
    rows_saved, n_rows = checkpoint_spec(mesh)
    np.savez_compressed(os.path.join(dirpath, f"shard_p{mesh.rank:04d}.npz"),
                        __rows=np.asarray(rows_saved, np.int64), __n_rows=n_rows,
                        __t=t, __step_count=step_count, __ids=pid, **rows)
    halo_mod.barrier(mesh)     # every shard is on disk before any rank reads


def load_sharded_checkpoint(dirpath: str, device="cuda", dtype=None):
    """(global state in id order, ids, t, step_count) from every shard file
    of a directory (the port's or hot_tpu's, any number of rows); padding
    slots (id -1) are dropped."""
    files = sorted(glob.glob(os.path.join(dirpath, "shard_p*.npz")))
    if not files:
        raise FileNotFoundError(f"no shard files in {dirpath}")
    parts = {f: [] for f in FIELDS + ("__ids",)}
    rows_seen, n_rows = set(), None
    for path in files:
        with np.load(path) as data:
            n_rows = int(data["__n_rows"])
            rows_seen.update(int(r) for r in data["__rows"])
            t, step_count = float(data["__t"]), int(data["__step_count"])
            for f in parts:
                parts[f].append(data[f].reshape((-1,) + data[f].shape[2:]))
    if rows_seen != set(range(n_rows)):
        raise ValueError(f"shard rows {sorted(rows_seen)} of {n_rows} in {dirpath}")
    ids = np.concatenate(parts.pop("__ids"))
    keep = ids >= 0
    order = np.argsort(ids[keep], kind="stable")
    fields = {f: torch.as_tensor(np.concatenate(a)[keep][order], device=device)
              for f, a in parts.items()}
    if dtype is not None:
        fields = {f: a.to(dtype) for f, a in fields.items()}
    gids = torch.as_tensor(ids[keep][order].astype(np.int64), device=device)
    if not torch.equal(gids, torch.arange(gids.shape[0], device=device)):
        raise ValueError("the shards' ids are not 0 .. n - 1")
    return ParticleState(**fields), gids, t, step_count
