"""Inexact projected Newton with characteristic-norm termination.

Counterpart of ``hot_tpu.solver.newton.newton_solve``, as a host loop:
    r_k = grad E(v_k);  stop when |r_k|_CN <= eps (or |r_k|_2 <= abs_tol)
    solve H_k dv = -r_k by preconditioned CG to forcing tolerance eta_k
    v_{k+1} = v_k + dv
with eta_k = clip(sqrt(cn_k / cn_0), cg_tol, 0.5) when adaptive_forcing.
Line search, partial preconditioner refresh and MINRES are not ported yet.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple

import torch

from hot_tpu_torch.solver.cg import cg_solve


class NewtonResult(NamedTuple):
    v: torch.Tensor
    iters: int                  # Newton iterations executed
    cg_iters: int               # total CG iterations across the solve
    cn_residual: float          # final characteristic-norm residual
    cn_residual0: float
    converged: bool
    cn_history: List[float]     # CN residual after each iteration, from cn0


def newton_solve(*, multiply: Callable, project: Callable, precondition: Callable,
                 cn_norm: Callable, v0, residual: Callable = None,
                 build_hessian: Callable = None, linearize: Callable = None,
                 build_preconditioner: Callable = lambda hess: None,
                 max_newton: int = 10, cn_eps: float = 1e-2, abs_tol: float = 0.0,
                 cg_tol: float = 1e-3, max_cg: int = 200, adaptive_forcing: bool = True,
                 linear_solver: str = "cg", line_search: bool = False,
                 precond_refresh: str = "newton", refresh_preconditioner: Callable = None,
                 axis_name: str = None) -> NewtonResult:
    """Run the inexact Newton loop.

    linearize(v) -> (r, hess) evaluates both at once; without it,
    residual(v) and build_hessian(v) are called. precond_refresh "newton"
    rebuilds the preconditioner at every iterate, "step" builds it once at
    v0 and reuses it.
    """
    if linear_solver != "cg":
        raise NotImplementedError(f"linear_solver='{linear_solver}' is not ported yet")
    if line_search:
        raise NotImplementedError("line search is not ported yet")
    if refresh_preconditioner is not None:
        raise NotImplementedError("partial preconditioner refresh is not ported yet")
    if axis_name is not None:
        raise NotImplementedError("distributed Newton is not ported yet")
    if precond_refresh not in ("newton", "step"):
        raise ValueError(f"unknown precond_refresh '{precond_refresh}'")
    if linearize is None:
        linearize = lambda v: (residual(v), build_hessian(v))  # noqa: E731

    v = v0
    r, hess = linearize(v)
    cn0 = cn_norm(r)
    cn = cn0
    frozen = build_preconditioner(hess) if precond_refresh == "step" else None
    history = [float(cn0)]
    k = cg_total = 0
    while k < max_newton:
        cn_f, rnorm = torch.stack([cn, torch.sqrt(torch.sum(r * r))]).tolist()
        if not (cn_f > cn_eps and rnorm > abs_tol):
            break
        pstate = frozen if precond_refresh == "step" else build_preconditioner(hess)
        if adaptive_forcing:
            eta = torch.clamp(torch.sqrt(cn / torch.clamp(cn0, min=1e-30)), cg_tol, 0.5)
        else:
            eta = cg_tol
        res = cg_solve(lambda w: multiply(hess, w), -r,
                       precondition=lambda z: precondition(pstate, z),
                       project=project, tol=eta, max_iters=max_cg)
        v = v + res.x
        r, hess = linearize(v)
        cn = cn_norm(r)
        k += 1
        cg_total += res.iters
        history.append(float(cn))
    cn_f = float(cn)
    return NewtonResult(v=v, iters=k, cg_iters=cg_total, cn_residual=cn_f,
                        cn_residual0=history[0], converged=cn_f <= cn_eps,
                        cn_history=history)
