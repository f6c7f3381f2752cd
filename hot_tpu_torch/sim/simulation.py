"""The MPM time step and the frame loop.

Counterpart of ``hot_tpu.sim.simulation`` on the dense grid or the sparse
tile grid (``grid_backend="sparse"``, ``grid.sparse``: every grid array over
the compact nodes of the tiles the particles touch, at most
``tile_capacity`` of them), with quadratic or cubic B-spline transfers
(``transfer_kernel``; cubic on the dense grid only). The default integrator is
implicit backward Euler with inexact Newton: P2G -> grid BC -> Newton
{linearize -> preconditioner -> CG or MINRES {Hessian apply} [-> Armijo line
search]} -> G2P -> F update -> plasticity -> advection. The Hessian is
matrix-free (``ops.fused_apply``) or, with ``matrix_free=False``, an
explicit BSR operator assembled once per Newton iteration (``ops.bsr``,
applied by ``ops.bsr_spmv``). The preconditioner is none, mass Jacobi,
block-Jacobi or HOT's multigrid (``solver.multigrid``: matrix-free
quadrature levels or assembled levels with Galerkin or quadrature
coarsening, the first assembled level below a matrix-free finest one the
composed Galerkin operator). ``solver.nonlinear="lbfgs"`` minimises the same objective by
L-BFGS (``solver.lbfgs``, the paper's LBFGS-H baseline) and
``solver.integrator="explicit"`` takes a symplectic-Euler grid update at
F_n with no solve. The plasticity return maps are von Mises, snow (with Jp)
and Drucker-Prager at a 30 degree friction angle (``models.plasticity``).
The kernels run whenever the state lives on a CUDA device.

A batch of members (``sim.state.stack_states``: one scene at B stiffnesses,
say) steps together, as hot_tpu's ``jax.vmap(advance_one_step, in_axes=(0,
None, None))`` does: every per-particle and per-node array carries a leading
member dimension, dt, t, cfg, model, colliders and plasticity are shared,
each member runs its own Newton and CG or MINRES iterations
(``solver.newton``) or its own L-BFGS (``solver.lbfgs``), and each particle
kernel runs once per batch. The batch takes every configuration one state
takes: both grids (on the sparse grid each member has its own tile set,
``grid.sparse``), both transfer kernels, every preconditioner including
HOT's multigrid in all its forms (a hierarchy per member inside one set of
batched arrays, ``solver.multigrid``), the explicit BSR Hessian (one
block-diagonal operator, ``ops.bsr``, so each SpMV is one launch), line
search, the explicit integrator, every model and return map.

The step is eager PyTorch; dt is a Python float. As in hot_tpu, cubic
transfers refuse every operator assembled into the 5-wide quadratic BSR:
the explicit outer Hessian, assembled multigrid levels and (the port's
addition) the direct coarse solve; the sparse grid refuses cubic transfers
and the explicit outer Hessian. A device mesh other than (1,) runs through
``parallel.ShardedSimulation``: this one-grid step refuses it (a batch under
a mesh raises NotImplementedError, as hot_tpu has no such path), and
``solver.overlap_halo`` is read only by the sharded step.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch

from hot_tpu_torch.grid import sparse
from hot_tpu_torch.models import constitutive as cm
from hot_tpu_torch.models import plasticity as plast
from hot_tpu_torch.ops import bsr
from hot_tpu_torch.ops import transfer
from hot_tpu_torch.ops.bspline import apic_d_inv_factor, kernel_width
from hot_tpu_torch.sim import collision
from hot_tpu_torch.sim import objective as obj_mod
from hot_tpu_torch.sim.state import ParticleState
from hot_tpu_torch.solver import multigrid as mg_mod
from hot_tpu_torch.solver.lbfgs import lbfgs_solve
from hot_tpu_torch.solver.newton import NewtonResult, newton_solve
from hot_tpu_torch.utils.config import SimConfig
from hot_tpu_torch.utils.metrics import MetricsLogger
from hot_tpu_torch.utils.timing import TRACER, h2d, span, synced


class StepStats(NamedTuple):
    """One step's diagnostics; for a batch every field is a list, one entry
    per member."""

    newton_iters: int
    cg_iters: int
    cn_residual: float
    cn_residual0: float
    converged: bool
    max_velocity: float
    kinetic_energy: float
    potential_energy: float
    active_nodes: int
    ls_backtracks: int          # line-search halvings (0 without line search)
    active_tiles: int = 0       # active tiles of the sparse grid (0 on the dense grid)


PLASTICITY = ("von_mises", "snow", "drucker_prager")
GRID_BACKENDS = ("dense", "sparse")
INTEGRATORS = ("implicit", "explicit")
NONLINEAR = ("newton", "lbfgs")
DRUCKER_PRAGER_FRICTION_DEG = 30.0


def _check_supported(cfg: SimConfig, plasticity, batched: bool = False):
    sol = cfg.solver
    mgc = sol.multigrid
    if tuple(cfg.mesh.shape) != (1,):
        if batched:
            raise NotImplementedError("a batch under a device mesh: hot_tpu has no such path")
        raise ValueError(f"a device mesh of shape {tuple(cfg.mesh.shape)} runs through "
                         "hot_tpu_torch.parallel.ShardedSimulation, not the one-grid step")
    for name, value, allowed in (("integrator", sol.integrator, INTEGRATORS),
                                 ("nonlinear", sol.nonlinear, NONLINEAR),
                                 ("grid_backend", cfg.grid_backend, GRID_BACKENDS)):
        if value not in allowed:
            raise ValueError(f"unknown {name} '{value}'; have {allowed}")
    if cfg.grid_backend == "sparse":
        # hot_tpu's refusals (simulation.py:115-118, 287-290)
        if kernel_width(cfg.transfer_kernel) != 3:
            raise NotImplementedError("cubic transfers require the dense grid backend")
        if not sol.matrix_free:
            raise NotImplementedError("explicit BSR currently requires the dense grid backend")
    if kernel_width(cfg.transfer_kernel) != 3:
        # hot_tpu's refusals (simulation.py:291-295, 363-367), whatever the
        # integrator, and the direct coarse solve, which assembles the
        # coarsest level the same way
        if not sol.matrix_free:
            raise NotImplementedError(
                "explicit BSR assembles the 5-wide quadratic structure; use "
                "matrix_free=True with cubic transfers")
        if sol.preconditioner == "multigrid":
            if mgc.assembled:
                raise NotImplementedError(
                    "assembled MG levels use the 5-wide quadratic BSR; run the matrix-free "
                    "MG (multigrid.assembled=False) with cubic")
            if mgc.coarse_solver == "direct":
                raise NotImplementedError(
                    "the direct coarse solve assembles the 5-wide quadratic BSR; use "
                    "multigrid.coarse_solver='smoother' or 'cg' with cubic")
    if plasticity is not None and plasticity not in PLASTICITY:
        raise ValueError(f"unknown plasticity '{plasticity}'; have {PLASTICITY}")


def return_map(plasticity: Optional[str], F, state: ParticleState):
    """(F, Jp) after the plasticity return map of the trial F (n, d, d)."""
    if plasticity == "von_mises":
        return plast.VonMisesHencky.project(F, state.mu, state.lam, state.yield_stress), state.Jp
    if plasticity == "snow":
        F, jp_ratio = plast.SnowPlasticity.project(F)
        return F, state.Jp * jp_ratio
    if plasticity == "drucker_prager":
        alpha = plast.DruckerPrager.alpha_from_friction_angle(DRUCKER_PRAGER_FRICTION_DEG)
        return plast.DruckerPrager.project(F, state.mu, state.lam, alpha), state.Jp
    return F, state.Jp


def _explicit_update(model, obj: obj_mod.ObjectiveContext, state: ParticleState,
                     inv_m) -> NewtonResult:
    """Symplectic-Euler grid update: forces at F_n, v = v* + dt f / m, no
    solve (hot_tpu/sim/simulation.py:431-448). No kernel runs."""
    P = cm.first_piola(model, state.F, state.mu, state.lam)
    f = transfer.scatter_force(obj.stencil, P @ state.F.transpose(-1, -2), state.V0,
                               obj.grid_m.shape[-1])
    v = obj.v_star + obj.dt * f * inv_m[..., None]
    if state.batch is None:
        return NewtonResult(v=v, iters=0, cg_iters=0, cn_residual=0.0, cn_residual0=0.0,
                            converged=True, cn_history=[], ls_backtracks=0)
    zeros = [0] * state.batch
    return NewtonResult(v=v, iters=zeros, cg_iters=zeros, cn_residual=[0.0] * state.batch,
                        cn_residual0=[0.0] * state.batch, converged=[True] * state.batch,
                        cn_history=[[] for _ in zeros], ls_backtracks=zeros)


def _lbfgs_update(model, obj: obj_mod.ObjectiveContext, sol, v0) -> NewtonResult:
    """L-BFGS on the incremental potential with the mass preconditioner as
    its initial inverse Hessian, at most max_cg iterations; the stats are
    filled as hot_tpu fills them (iterations for both counts, the final
    gradient's CN for both residuals). The gradient is the residual of the
    linearize (its kernel on the card)."""
    res = lbfgs_solve(
        energy=lambda v: obj_mod.energy(model, obj, v),
        gradient=lambda v: obj_mod.linearize(model, obj, v, project_spd=sol.project_hessian)[0],
        project=lambda r: obj_mod.project(obj, r),
        precondition=lambda r: obj_mod.mass_precondition(obj, r),
        cn_norm=lambda r: obj_mod.cn_norm(obj, r),
        v0=v0, history=sol.lbfgs_history, max_iters=sol.max_cg,
        cn_eps=sol.cn_eps if sol.use_cn else 0.0)
    history = [[] for _ in res.iters] if isinstance(res.iters, list) else []
    return NewtonResult(v=res.v, iters=res.iters, cg_iters=res.iters, cn_residual=res.grad_norm,
                        cn_residual0=res.grad_norm, converged=res.converged, cn_history=history,
                        ls_backtracks=res.backtracks)


def _newton_update(model, objective: obj_mod.ObjectiveContext, cfg: SimConfig,
                   state: ParticleState, v0, constrained) -> NewtonResult:
    """Inexact Newton with the configured Hessian form and preconditioner;
    the Hessian state is (per-particle context, BSR or None)."""
    sol = cfg.solver
    dim, res, dx, dt = cfg.dim, objective.res, objective.dx, objective.dt
    st, grid_m, active = objective.stencil, objective.grid_m, objective.active
    n_nodes, dtype = grid_m.shape[-1], state.x.dtype

    def lin_particles(v):
        return obj_mod.linearize(model, objective, v, project_spd=sol.project_hessian)

    if sol.matrix_free:
        def linearize(v):
            r, hess = lin_particles(v)
            return r, (hess, None)

        multiply = lambda hp, w: obj_mod.multiply(objective, hp[0], w)  # noqa: E731
    else:
        # explicit outer Hessian, assembled once per Newton iteration
        mat0 = bsr.structure(active, res, dtype=dtype)

        def linearize(v):
            r, hess = lin_particles(v)
            return r, (hess, bsr.assemble_hessian(mat0, st, state.F, hess.context(dim),
                                                  state.V0, dt, grid_m))

        def multiply(hp, w):
            mat = hp[1]
            y = bsr.rows_to_grid_vector(mat, bsr.spmv(mat, bsr.grid_vector_to_rows(mat, w)),
                                        n_nodes)
            return torch.where(active[..., None], y, w)

    refresh_precond = None
    if sol.preconditioner == "none":
        build_precond = lambda hp: None  # noqa: E731
        precond = lambda pstate, r: r  # noqa: E731
    elif sol.preconditioner == "jacobi":
        build_precond = lambda hp: None  # noqa: E731
        precond = lambda pstate, r: obj_mod.mass_precondition(objective, r)  # noqa: E731
    elif sol.preconditioner == "block_jacobi":
        def build_precond(hp):
            D = obj_mod.elastic_block_diag(objective.x_soa, dx, res, objective.F_soa, hp[0],
                                           state.V0, dt, grid_m, active, objective.kernel,
                                           objective.tgrid)
            return obj_mod.sym_block_inv(D)

        precond = lambda Dinv, r: torch.einsum("...ij,...j->...i", Dinv, r)  # noqa: E731
    elif sol.preconditioner == "multigrid":
        mgc = sol.multigrid
        with span("mg_static"):
            mg_static = mg_mod.build_static(
                state.x, state.m, res, dx, mgc.levels, constrained, dtype,
                assembled_from=mgc.assembled_from_level if mgc.assembled else None,
                kernel=cfg.transfer_kernel, tgrid=objective.tgrid,
                tile_capacity=cfg.tile_capacity, dense_switch=mgc.sparse_dense_switch,
                composed=mgc.coarsening == "galerkin")

        def build_precond(hp):
            return mg_mod.build_precond(mg_static, state.F, hp[0], state.V0, dt, mgc, dim)

        if mgc.rap_refresh == "lagged" and mgc.assembled:
            # first assembled level and smoother data fresh per Newton
            # iteration; the deeper Galerkin chain and coarse factor from v0
            def refresh_precond(hp, base):
                return mg_mod.build_precond(mg_static, state.F, hp[0], state.V0, dt, mgc, dim,
                                            reuse=base)

        precond = lambda pre, r: mg_mod.mg_precondition(mg_static, pre, dt, mgc, r)  # noqa: E731
    else:
        raise ValueError(f"unknown preconditioner '{sol.preconditioner}'")

    return newton_solve(
        linearize=linearize,
        multiply=multiply,
        project=lambda r: obj_mod.project(objective, r),
        precondition=precond,
        build_preconditioner=build_precond,
        refresh_preconditioner=refresh_precond,
        cn_norm=lambda r: obj_mod.cn_norm(objective, r),
        v0=v0,
        max_newton=sol.max_newton,
        cn_eps=sol.cn_eps if sol.use_cn else 0.0,
        abs_tol=sol.abs_tol,
        cg_tol=sol.cg_tol,
        max_cg=sol.max_cg,
        adaptive_forcing=sol.adaptive_forcing,
        linear_solver=sol.linear_solver,
        energy=lambda v: obj_mod.energy(model, objective, v),
        line_search=sol.line_search,
        precond_refresh=sol.precond_refresh,
    )


def update_particles(state: ParticleState, st: transfer.Stencil, v_new, v_grid, dt: float,
                     cfg: SimConfig, plasticity: Optional[str]) -> ParticleState:
    """G2P of the solved grid velocities v_new (FLIP blends in the change
    from the pre-solve v_grid), the F update and return map, and the
    advection clamped to the grid's inner cells."""
    dim, dx = cfg.dim, cfg.dx
    res = tuple(cfg.grid_res[:dim])
    dtype, device = state.x.dtype, state.x.device
    d_inv = apic_d_inv_factor(cfg.transfer_kernel)
    v_pic, grad_v, C_new = transfer.g2p(st, v_new, dx, d_inv_factor=d_inv)
    if cfg.transfer == "flip":
        v_old, _, _ = transfer.g2p(st, v_grid, dx, d_inv_factor=d_inv)
        v_p = (1.0 - cfg.flip_ratio) * v_pic + cfg.flip_ratio * (state.v + (v_pic - v_old))
        C_next = torch.zeros_like(state.C)
    else:
        v_p, C_next = v_pic, C_new
    eye = torch.eye(dim, dtype=dtype, device=device)
    F_new, Jp_new = return_map(plasticity, (eye + dt * grad_v) @ state.F, state)
    hi = (h2d(torch.tensor(res, dtype=dtype, device=device)) - 3.0) * dx
    x_new = torch.minimum(torch.clamp(state.x + dt * v_pic, min=2.0 * dx), hi)
    return state.replace(x=x_new, v=v_p, C=C_next, F=F_new, Jp=Jp_new)


def advance_one_step(state: ParticleState, dt: float, t: float, *, cfg: SimConfig,
                     model, colliders: Sequence[collision.Collider],
                     plasticity: Optional[str] = None) -> Tuple[ParticleState, StepStats]:
    """One MPM step from `state` at time t (implicit backward Euler unless
    cfg.solver.integrator is "explicit"); `state` may be a batch (see the
    module doc), whose StepStats hold a list per field.

    Float32 products run in full float32: TF32, like the TPU's default bf16
    matmul passes, loses about three decimal digits, which stalls Newton.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    batched = state.batch is not None
    _check_supported(cfg, plasticity, batched)
    dim = cfg.dim
    res = tuple(cfg.grid_res[:dim])
    dx = cfg.dx
    dtype, device = state.x.dtype, state.x.device
    sol = cfg.solver

    # ---- grid activation + P2G
    tgrid = None
    if cfg.grid_backend == "sparse":
        with span("tile_activation"):
            tgrid = sparse.build_tile_grid(state.x, dx, res, cfg.tile_capacity)
            st = sparse.sparse_stencil(state.x, dx, tgrid)
            n_nodes = tgrid.n_cnodes
            node_pos = sparse.node_positions(tgrid, dx, dtype)
    with span("p2g"):
        if tgrid is None:
            st = transfer.particle_stencil(state.x, dx, res, kernel=cfg.transfer_kernel)
            n_nodes = transfer.n_nodes_of(res)
            node_pos = transfer.node_positions(res, dx, dtype, device)
        grid_m, grid_mv = transfer.p2g_mass_momentum(st, state.v, state.C, state.m, n_nodes)
        active = grid_m > 0
        inv_m = torch.where(active, 1.0 / torch.clamp(grid_m, min=1e-30),
                            torch.zeros_like(grid_m))
        v_grid = grid_mv * inv_m[..., None]

    # ---- grid BC (node positions shared by a batch's members on the dense grid)
    with span("grid_bc"):
        gravity = h2d(torch.tensor(cfg.gravity[:dim], dtype=dtype, device=device))
        v_star = v_grid + dt * gravity
        proj, v_bc, constrained = collision.grid_boundary_conditions(
            node_pos, t, colliders, grid_v=v_star, boundary_margin=2, res=res, dx=dx)
        if batched:
            # each member's own copy, so that every projection runs at the batch's
            # shape and gives contiguous vectors, as the kernels take them
            proj = proj.expand(v_star.shape + (dim,)).contiguous()
            v_bc = v_bc.expand(v_star.shape).contiguous()
        v0 = collision.apply_bc_to_velocity(v_star, proj, v_bc)

    # ---- grid update: implicit (Newton or L-BFGS) or explicit
    objective = obj_mod.make_objective(model, st, state.F, state.V0, state.mu, state.lam,
                                       grid_m, v_star, proj, dt, dx, state.x, res,
                                       kernel=cfg.transfer_kernel, tgrid=tgrid)
    if sol.integrator == "explicit":
        result = _explicit_update(model, objective, state, inv_m)
    elif sol.nonlinear == "lbfgs":
        result = _lbfgs_update(model, objective, sol, v0)
    else:
        result = _newton_update(model, objective, cfg, state, v0, constrained)
    with span("g2p"):
        v_new = collision.apply_bc_to_velocity(result.v, proj, v_bc)
        new_state = update_particles(state, st, v_new, v_grid, dt, cfg, plasticity)
    v_p, F_new = new_state.v, new_state.F

    # ---- diagnostics (one readback), per member for a batch
    with span("diagnostics"):
        if cfg.compute_energy:
            potential = obj_mod.member_sum(
                state.V0 * cm.psi_from_F(model, F_new, state.mu, state.lam), 1)
        else:
            potential = torch.zeros(active.shape[:-1], dtype=dtype, device=device)
        vmax, ke, pe, n_active = synced(torch.stack([
            torch.linalg.norm(v_p, dim=-1).amax(-1),
            0.5 * obj_mod.member_sum(state.m * torch.sum(v_p * v_p, dim=-1), 1),
            potential,
            obj_mod.member_sum(active, 1).to(dtype),
        ]).tolist())
    stats = StepStats(
        newton_iters=result.iters, cg_iters=result.cg_iters,
        cn_residual=result.cn_residual, cn_residual0=result.cn_residual0,
        converged=result.converged, max_velocity=vmax, kinetic_energy=ke,
        potential_energy=pe, active_nodes=_ints(n_active), ls_backtracks=result.ls_backtracks,
        active_tiles=0 if tgrid is None else tgrid.n_active,
    )
    if batched:
        stats = stats._replace(active_tiles=[0] * state.batch if tgrid is None
                               else tgrid.member_tiles)
    return new_state, stats


def _ints(counts):
    return [int(c) for c in counts] if isinstance(counts, list) else int(counts)


def _members(values):
    """A StepStats field over a batch's members (or one state's value)."""
    return values if isinstance(values, list) else [values]


class Simulation:
    """The frame loop: CFL dt, the step with dt-halving retries, metrics.
    A batch's members share dt, and a step is retried unless every member
    converged to a finite state. ``parallel.ShardedSimulation`` runs the
    same loop over the slab decomposition (its hooks: ``_check``,
    ``_max_speed``, ``_attempt``, ``_accept``)."""

    def __init__(self, cfg: SimConfig, state: ParticleState, model,
                 colliders: Sequence[collision.Collider] = (),
                 plasticity: Optional[str] = None,
                 metrics: Optional[MetricsLogger] = None):
        self._check(cfg, plasticity, state)
        self.cfg = cfg
        self.state = state
        self.model = model
        self.colliders = tuple(colliders)
        self.plasticity = plasticity
        self.metrics = metrics or MetricsLogger()
        self.on_card = state.x.device.type == "cuda"
        self.t = 0.0
        self.step_count = 0
        self.retry_count = 0

    def _check(self, cfg: SimConfig, plasticity, state: ParticleState):
        _check_supported(cfg, plasticity, state.batch is not None)

    def _max_speed(self) -> float:
        return synced(float(torch.linalg.norm(self.state.v, dim=-1).max()))

    def _attempt(self, dt: float):
        """One try of the step at dt from the current state: (new state,
        stats, whether it is finite)."""
        with span("attempt"):
            new_state, stats = advance_one_step(
                self.state, dt, self.t, cfg=self.cfg, model=self.model,
                colliders=self.colliders, plasticity=self.plasticity)
            finite = (all(map(math.isfinite, _members(stats.cn_residual)))
                      and synced(bool(torch.isfinite(new_state.x).all())))
        return new_state, stats, finite

    def _accept(self, new_state: ParticleState):
        self.state = new_state

    def compute_dt(self) -> float:
        """CFL dt: particles move at most cfl cells per step (with the
        velocity bound inflated by gravity over max_dt)."""
        vmax = self._max_speed()
        g = float(torch.linalg.norm(torch.tensor(self.cfg.gravity[: self.cfg.dim])))
        vmax = vmax + g * self.cfg.max_dt
        dt_cfl = self.cfg.cfl * self.cfg.dx / max(vmax, 1e-6)
        return float(min(self.cfg.max_dt, max(self.cfg.min_dt, dt_cfl)))

    def step(self, dt: Optional[float] = None) -> StepStats:
        """One step. If Newton does not converge or the state goes
        non-finite, the step is retried from the saved state at halved dt,
        up to solver.dt_retries times. The step's spans carry its number
        and each try's index (``utils.timing``)."""
        dt = self.compute_dt() if dt is None else dt
        TRACER.begin_step(self.step_count + 1, self.on_card)
        with span("step"):
            attempt = 0
            while True:
                TRACER.attempt = attempt
                new_state, stats, finite = self._attempt(dt)
                converged = all(_members(stats.converged))
                if finite and (converged or attempt >= self.cfg.solver.dt_retries):
                    break
                if attempt >= self.cfg.solver.dt_retries:
                    self.metrics.log(event="nonfinite_give_up", dt=dt)
                    break
                attempt += 1
                dt = dt * 0.5
                self.retry_count += 1
                self.metrics.log(event="dt_retry", attempt=attempt, dt=dt)
            self._accept(new_state)
            self.t += dt
            self.step_count += 1
            self.metrics.log(step=self.step_count, t=self.t, dt=dt, **stats._asdict())
        return stats

    def advance_frame(self, frame_callback: Optional[Callable] = None):
        """Advance one whole output frame of duration cfg.frame_dt."""
        t_end = self.t + self.cfg.frame_dt
        while self.t < t_end - 1e-12:
            self.step(min(self.compute_dt(), t_end - self.t))
        if frame_callback is not None:
            frame_callback(self)

    def run(self, frames: int, frame_callback: Optional[Callable] = None):
        for _ in range(frames):
            self.advance_frame(frame_callback)
