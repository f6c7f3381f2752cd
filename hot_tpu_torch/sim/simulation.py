"""The implicit MPM time step and the frame loop.

Counterpart of ``hot_tpu.sim.simulation`` for the dense grid and the
implicit backward-Euler integrator with inexact Newton: P2G -> grid BC ->
Newton {linearize -> preconditioner -> CG {Hessian apply}} -> G2P -> F
update -> advection. The Hessian is matrix-free (``ops.fused_apply``) or,
with ``matrix_free=False``, an explicit BSR operator assembled once per
Newton iteration (``ops.bsr``, applied by ``ops.bsr_spmv``). The
preconditioner is none, mass Jacobi, block-Jacobi or HOT's multigrid
(``solver.multigrid``: matrix-free quadrature levels or assembled levels
with Galerkin or quadrature coarsening). The kernels run whenever the state
lives on a CUDA device.

The step is eager PyTorch; dt is a Python float. Not ported yet (they raise
NotImplementedError): the sparse grid, cubic transfers, the explicit
integrator, LBFGS, MINRES, line search, the composed Galerkin multigrid
level, plasticity.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch

from hot_tpu_torch.models import constitutive as cm
from hot_tpu_torch.ops import bsr
from hot_tpu_torch.ops import transfer
from hot_tpu_torch.ops.bspline import apic_d_inv_factor
from hot_tpu_torch.sim import collision
from hot_tpu_torch.sim import objective as obj_mod
from hot_tpu_torch.sim.state import ParticleState
from hot_tpu_torch.solver import multigrid as mg_mod
from hot_tpu_torch.solver.newton import newton_solve
from hot_tpu_torch.utils.config import SimConfig
from hot_tpu_torch.utils.metrics import MetricsLogger
from hot_tpu_torch.utils.timing import PhaseTimer


class StepStats(NamedTuple):
    newton_iters: int
    cg_iters: int
    cn_residual: float
    cn_residual0: float
    converged: bool
    max_velocity: float
    kinetic_energy: float
    potential_energy: float
    active_nodes: int


def _check_supported(cfg: SimConfig, plasticity):
    sol = cfg.solver
    mgc = sol.multigrid
    unsupported = [
        (cfg.grid_backend != "dense", f"grid_backend='{cfg.grid_backend}'"),
        (cfg.transfer_kernel != "quadratic", f"transfer_kernel='{cfg.transfer_kernel}'"),
        (sol.integrator != "implicit", f"integrator='{sol.integrator}'"),
        (sol.nonlinear != "newton", f"nonlinear='{sol.nonlinear}'"),
        (sol.linear_solver != "cg", f"linear_solver='{sol.linear_solver}'"),
        (sol.line_search, "line_search=True"),
        (sol.preconditioner == "multigrid" and mgc.assembled and mgc.coarsening == "galerkin"
         and mgc.assembled_from_level > 0,
         "composed Galerkin multigrid (assembled_from_level > 0, coarsening='galerkin')"),
        (plasticity is not None, f"plasticity='{plasticity}'"),
    ]
    for bad, what in unsupported:
        if bad:
            raise NotImplementedError(f"{what} is not ported to hot_tpu_torch yet")


def advance_one_step(state: ParticleState, dt: float, t: float, *, cfg: SimConfig,
                     model, colliders: Sequence[collision.Collider],
                     plasticity: Optional[str] = None) -> Tuple[ParticleState, StepStats]:
    """One implicit backward-Euler MPM step from `state` at time t.

    Float32 products run in full float32: TF32, like the TPU's default bf16
    matmul passes, loses about three decimal digits, which stalls Newton.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _check_supported(cfg, plasticity)
    dim = cfg.dim
    res = tuple(cfg.grid_res[:dim])
    dx = cfg.dx
    dtype, device = state.x.dtype, state.x.device
    sol = cfg.solver

    # ---- P2G
    st = transfer.particle_stencil(state.x, dx, res, kernel=cfg.transfer_kernel)
    n_nodes = transfer.n_nodes_of(res)
    node_pos = transfer.node_positions(res, dx, dtype, device)
    grid_m, grid_mv = transfer.p2g_mass_momentum(st, state.v, state.C, state.m, n_nodes)
    active = grid_m > 0
    inv_m = torch.where(active, 1.0 / torch.clamp(grid_m, min=1e-30), torch.zeros_like(grid_m))
    v_grid = grid_mv * inv_m[:, None]

    # ---- grid BC
    gravity = torch.tensor(cfg.gravity[:dim], dtype=dtype, device=device)
    v_star = v_grid + dt * gravity[None, :]
    proj, v_bc, constrained = collision.grid_boundary_conditions(
        node_pos, t, colliders, grid_v=v_star, boundary_margin=2, res=res, dx=dx)
    v0 = collision.apply_bc_to_velocity(v_star, proj, v_bc)

    # ---- implicit solve: the Hessian state is (per-particle context, BSR or None)
    objective = obj_mod.make_objective(model, st, state.F, state.V0, state.mu, state.lam,
                                       grid_m, v_star, proj, dt, dx, state.x, res)

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
            return torch.where(active[:, None], y, w)

    refresh_precond = None
    if sol.preconditioner == "none":
        build_precond = lambda hp: None  # noqa: E731
        precond = lambda pstate, r: r  # noqa: E731
    elif sol.preconditioner == "jacobi":
        build_precond = lambda hp: None  # noqa: E731
        precond = lambda pstate, r: obj_mod.mass_precondition(objective, r)  # noqa: E731
    elif sol.preconditioner == "block_jacobi":
        def build_precond(hp):
            D = obj_mod.elastic_block_diag(st, state.F, hp[0].context(dim), state.V0, dt,
                                           grid_m, active, dim)
            return obj_mod.sym_block_inv(D)

        precond = lambda Dinv, r: torch.einsum("nij,nj->ni", Dinv, r)  # noqa: E731
    elif sol.preconditioner == "multigrid":
        mgc = sol.multigrid
        mg_static = mg_mod.build_static(
            state.x, state.m, res, dx, mgc.levels, constrained, dtype,
            assembled_from=mgc.assembled_from_level if mgc.assembled else None)

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

    result = newton_solve(
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
        line_search=sol.line_search,
        precond_refresh=sol.precond_refresh,
    )
    v_new = collision.apply_bc_to_velocity(result.v, proj, v_bc)

    # ---- G2P + state update
    d_inv = apic_d_inv_factor(cfg.transfer_kernel)
    v_pic, grad_v, C_new = transfer.g2p(st, v_new, dx, d_inv_factor=d_inv)
    if cfg.transfer == "flip":
        v_old, _, _ = transfer.g2p(st, v_grid, dx, d_inv_factor=d_inv)
        v_p = (1.0 - cfg.flip_ratio) * v_pic + cfg.flip_ratio * (state.v + (v_pic - v_old))
        C_next = torch.zeros_like(state.C)
    else:
        v_p, C_next = v_pic, C_new
    eye = torch.eye(dim, dtype=dtype, device=device)
    F_new = (eye + dt * grad_v) @ state.F
    hi = (torch.tensor(res, dtype=dtype, device=device) - 3.0) * dx
    x_new = torch.minimum(torch.clamp(state.x + dt * v_pic, min=2.0 * dx), hi[None, :])
    new_state = state.replace(x=x_new, v=v_p, C=C_next, F=F_new)

    # ---- diagnostics (one readback)
    if cfg.compute_energy:
        potential = torch.sum(state.V0 * cm.psi_from_F(model, F_new, state.mu, state.lam))
    else:
        potential = torch.zeros((), dtype=dtype, device=device)
    vmax, ke, pe, n_active = torch.stack([
        torch.linalg.norm(v_p, dim=-1).max(),
        0.5 * torch.sum(state.m * torch.sum(v_p * v_p, dim=-1)),
        potential,
        active.sum().to(dtype),
    ]).tolist()
    stats = StepStats(
        newton_iters=result.iters, cg_iters=result.cg_iters,
        cn_residual=result.cn_residual, cn_residual0=result.cn_residual0,
        converged=result.converged, max_velocity=vmax, kinetic_energy=ke,
        potential_energy=pe, active_nodes=int(n_active),
    )
    return new_state, stats


class Simulation:
    """Frame-loop driver: CFL dt, the step with dt-halving retries, metrics."""

    def __init__(self, cfg: SimConfig, state: ParticleState, model,
                 colliders: Sequence[collision.Collider] = (),
                 plasticity: Optional[str] = None,
                 metrics: Optional[MetricsLogger] = None):
        _check_supported(cfg, plasticity)
        self.cfg = cfg
        self.state = state
        self.model = model
        self.colliders = tuple(colliders)
        self.plasticity = plasticity
        self.metrics = metrics or MetricsLogger()
        self.timer = PhaseTimer(state.x.device)
        self.t = 0.0
        self.step_count = 0
        self.retry_count = 0

    def compute_dt(self) -> float:
        """CFL dt: particles move at most cfl cells per step (with the
        velocity bound inflated by gravity over max_dt)."""
        vmax = float(torch.linalg.norm(self.state.v, dim=-1).max())
        g = float(torch.linalg.norm(torch.tensor(self.cfg.gravity[: self.cfg.dim])))
        vmax = vmax + g * self.cfg.max_dt
        dt_cfl = self.cfg.cfl * self.cfg.dx / max(vmax, 1e-6)
        return float(min(self.cfg.max_dt, max(self.cfg.min_dt, dt_cfl)))

    def step(self, dt: Optional[float] = None) -> StepStats:
        """One step. If Newton does not converge or the state goes
        non-finite, the step is retried from the saved state at halved dt,
        up to solver.dt_retries times."""
        dt = self.compute_dt() if dt is None else dt
        prev_state = self.state
        attempt = 0
        while True:
            with self.timer.scope("advance_one_step"):
                new_state, stats = advance_one_step(
                    prev_state, dt, self.t, cfg=self.cfg, model=self.model,
                    colliders=self.colliders, plasticity=self.plasticity)
            finite = (math.isfinite(stats.cn_residual)
                      and bool(torch.isfinite(new_state.x).all()))
            if finite and (stats.converged or attempt >= self.cfg.solver.dt_retries):
                break
            if attempt >= self.cfg.solver.dt_retries:
                self.metrics.log(event="nonfinite_give_up", dt=dt)
                break
            attempt += 1
            dt = dt * 0.5
            self.retry_count += 1
            self.metrics.log(event="dt_retry", attempt=attempt, dt=dt)
        self.state = new_state
        self.t += dt
        self.step_count += 1
        self.metrics.log(step=self.step_count, t=self.t, dt=dt, **stats._asdict())
        return stats

    def advance_frame(self, frame_callback: Optional[Callable] = None, max_steps: int = 0):
        """Advance one output frame of duration cfg.frame_dt; with
        max_steps > 0, stop early once step_count reaches it."""
        t_end = self.t + self.cfg.frame_dt
        while self.t < t_end - 1e-12:
            if max_steps and self.step_count >= max_steps:
                break
            self.step(min(self.compute_dt(), t_end - self.t))
        if frame_callback is not None:
            frame_callback(self)

    def run(self, frames: int, frame_callback: Optional[Callable] = None):
        for _ in range(frames):
            self.advance_frame(frame_callback)
