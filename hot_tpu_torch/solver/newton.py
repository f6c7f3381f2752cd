"""Inexact projected Newton with characteristic-norm termination.

Counterpart of ``hot_tpu.solver.newton.newton_solve``, as a host loop:
    r_k = grad E(v_k);  stop when |r_k|_CN <= eps (or |r_k|_2 <= abs_tol)
    solve H_k dv = -r_k by preconditioned CG to forcing tolerance eta_k
    v_{k+1} = v_k + dv
with eta_k = clip(sqrt(cn_k / cn_0), cg_tol, 0.5) when adaptive_forcing.
The inner solver is CG or MINRES (``linear_solver``). With ``line_search``
the update is v + alpha dv, alpha halved from 1 (at most ls_max_backtracks
times) until the Armijo condition E(v + alpha dv) <= E(v) + 1e-4 alpha
r . dv holds; each trial is one energy evaluation and one readback.

A batch of B independent problems (v (B, ...); cn_norm and energy return
(B,)) runs as ``jax.vmap`` runs hot_tpu's loop: each member takes its own CN
norm, forcing eta, CG and line search and its own counters, as if alone; a
member that has stopped is frozen (v, r and its CN norm kept by select) and
the loop runs while any member is active, reading back one (B,) activity mask
per iteration (and per line-search trial). CG and MINRES both take a batch.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple

import torch

from hot_tpu_torch.solver.cg import (any_going, cg_solve, count, keep, minres_solve,
                                     per_member, reducing)
from hot_tpu_torch.utils.timing import span, synced

SOLVERS = {"cg": cg_solve, "minres": minres_solve}


class NewtonResult(NamedTuple):
    """The solve's result; for a batch every field but v is a list, one
    entry per member."""

    v: torch.Tensor
    iters: int                  # Newton iterations executed
    cg_iters: int               # total CG iterations across the solve
    cn_residual: float          # final characteristic-norm residual
    cn_residual0: float
    converged: bool
    cn_history: List[float]     # CN residual after each iteration, from cn0
    ls_backtracks: int          # line-search halvings across the solve


def newton_solve(*, multiply: Callable, project: Callable, precondition: Callable,
                 cn_norm: Callable, v0, residual: Callable = None,
                 build_hessian: Callable = None, linearize: Callable = None,
                 build_preconditioner: Callable = lambda hess: None,
                 max_newton: int = 10, cn_eps: float = 1e-2, abs_tol: float = 0.0,
                 cg_tol: float = 1e-3, max_cg: int = 200, adaptive_forcing: bool = True,
                 linear_solver: str = "cg", energy: Callable = None,
                 line_search: bool = False, ls_max_backtracks: int = 8,
                 precond_refresh: str = "newton", refresh_preconditioner: Callable = None,
                 reduce: Callable = None) -> NewtonResult:
    """Run the inexact Newton loop.

    linearize(v) -> (r, hess) evaluates both at once; without it,
    residual(v) and build_hessian(v) are called. precond_refresh "newton"
    rebuilds the preconditioner at every iterate, "step" builds it once at
    v0 and reuses it. With refresh_preconditioner(hess, base) and "newton",
    a base is built once at v0 and each iterate refreshes part of it (the
    lagged Galerkin chain of MultigridConfig.rap_refresh="lagged").
    line_search needs energy(v), the objective the residual is the gradient of.
    reduce (hot_tpu's axis_name) sums a rank's partial dot products over the
    ranks of a slab decomposition; cn_norm and energy then return the
    global values, so every rank takes the same iterations.

    Spans (``utils.timing``): ``newton`` around the solve, ``newton.iter``
    per iteration, ``linearize`` per call, ``precond_build`` per build or
    refresh of the preconditioner, ``cg`` per linear solve and
    ``line_search``.
    """
    if linear_solver not in SOLVERS:
        raise ValueError(f"unknown linear_solver '{linear_solver}'")
    if line_search and energy is None:
        raise ValueError("line_search needs the energy callable")
    if precond_refresh not in ("newton", "step"):
        raise ValueError(f"unknown precond_refresh '{precond_refresh}'")
    if linearize is None:
        linearize = lambda v: (residual(v), build_hessian(v))  # noqa: E731
    solve = SOLVERS[linear_solver]
    with span("newton"):
        v = v0
        with span("linearize"):
            r, hess = linearize(v)
        cn0 = cn_norm(r)
        cn = cn0
        batch = cn0.shape[0] if cn0.ndim else None
        dot_ = reducing(batch is not None, reduce)
        partial = refresh_preconditioner is not None and precond_refresh == "newton"
        frozen = None
        if precond_refresh == "step" or partial:
            with span("precond_build"):
                frozen = build_preconditioner(hess)
        history = [cn0]
        k = 0
        iters, cg_total, backtracks = ([0] * batch for _ in range(3)) if batch else (0, 0, 0)
        while k < max_newton:
            going = (cn > cn_eps) & (torch.sqrt(dot_(r, r)) > abs_tol)
            flags = synced(going.tolist())
            if not any_going(flags):
                break
            with span("newton.iter"):
                if precond_refresh == "step":
                    pstate = frozen
                else:
                    with span("precond_build"):
                        pstate = (refresh_preconditioner(hess, frozen) if partial
                                  else build_preconditioner(hess))
                if adaptive_forcing:
                    eta = torch.clamp(torch.sqrt(cn / torch.clamp(cn0, min=1e-30)), cg_tol, 0.5)
                else:
                    eta = cg_tol
                with span("cg"):
                    res = solve(lambda w: multiply(hess, w), -r,
                                precondition=lambda z: precondition(pstate, z),
                                project=project, tol=eta, max_iters=max_cg, reduce=reduce,
                                **({} if batch is None else {"active": going}))
                step = res.x
                if line_search:
                    with span("line_search"):
                        E0, slope = energy(v), dot_(r, res.x)
                        alpha = torch.ones_like(cn)
                        trying = going
                        for _ in range(ls_max_backtracks):
                            trying = trying & ~(energy(v + per_member(alpha, v) * res.x)
                                                <= E0 + 1e-4 * alpha * slope)
                            halve = synced(trying.tolist())
                            if not any_going(halve):
                                break
                            alpha = torch.where(trying, 0.5 * alpha, alpha)
                            backtracks = count(backtracks, halve)
                        step = per_member(alpha, v) * res.x
                v = keep(going, v + step, v)
                with span("linearize"):
                    r_new, hess = linearize(v)
                r, cn = keep(going, r_new, r), keep(going, cn_norm(r_new), cn)
                k += 1
                iters = count(iters, flags)
                cg_total = count(cg_total, res.iters)   # a frozen member's CG counts 0
                history.append(cn)
        # one readback: the CN norms from cn0 on
        history = synced(torch.stack(history).tolist())
    if batch is None:
        return NewtonResult(v=v, iters=k, cg_iters=cg_total, cn_residual=history[-1],
                            cn_residual0=history[0], converged=history[-1] <= cn_eps,
                            cn_history=history, ls_backtracks=backtracks)
    per = [[h[b] for h in history[:iters[b] + 1]] for b in range(batch)]
    return NewtonResult(v=v, iters=iters, cg_iters=cg_total, cn_residual=[h[-1] for h in per],
                        cn_residual0=[h[0] for h in per],
                        converged=[h[-1] <= cn_eps for h in per], cn_history=per,
                        ls_backtracks=backtracks)
