"""L-BFGS minimiser over the incremental potential: HOT's LBFGS-H baseline.

Counterpart of ``hot_tpu.solver.lbfgs.lbfgs_solve``, as a host loop (like
``solver.newton``): the two-loop recursion over a ring buffer of the last
``history`` (s, y) pairs with the preconditioner as the initial inverse
Hessian, steepest descent (the preconditioned, projected gradient) where
the direction is not a descent direction, Armijo backtracking by halving up
to ``ls_max_backtracks`` times, and a pair kept only where s . y > 1e-12.
The loop stops when the characteristic norm of the gradient reaches cn_eps
or after max_iters iterations.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch


class LbfgsResult(NamedTuple):
    v: torch.Tensor
    iters: int              # iterations executed
    grad_norm: float        # characteristic norm of the final gradient
    converged: bool
    backtracks: int         # Armijo halvings across the solve


def _dot(a, b):
    return torch.sum(a * b)


def lbfgs_solve(*, energy: Callable, gradient: Callable, project: Callable, v0,
                precondition: Optional[Callable] = None, cn_norm: Optional[Callable] = None,
                history: int = 8, max_iters: int = 100, cn_eps: float = 1e-2,
                ls_max_backtracks: int = 10) -> LbfgsResult:
    """Minimise energy(v) from v0; gradient(v) is its projected gradient."""
    precondition = precondition or (lambda r: r)
    cn_norm = cn_norm or (lambda r: torch.linalg.norm(r))
    pairs = []              # (s, y, rho), oldest first, at most `history`

    def two_loop(g):
        q, alphas = g, []
        for s, y, rho in reversed(pairs):
            a = rho * _dot(s, q)
            q = q - a * y
            alphas.append(a)
        z = precondition(q)
        for (s, y, rho), a in zip(pairs, reversed(alphas)):
            z = z + (a - rho * _dot(y, z)) * s
        return z

    v, g = v0, gradient(v0)
    gn = float(cn_norm(g))
    k = backtracks = 0
    while k < max_iters and gn > cn_eps:
        d = project(-two_loop(g))
        E0 = energy(v)
        slope = _dot(g, d)
        if not bool(slope < 0):
            d = -project(precondition(g))
            slope = torch.minimum(slope, _dot(g, d))
        alpha, j = 1.0, 0
        while j < ls_max_backtracks and not bool(
                energy(v + alpha * d) <= E0 + 1e-4 * alpha * slope):
            alpha, j = 0.5 * alpha, j + 1
        backtracks += j
        v_new = v + alpha * d
        g_new = gradient(v_new)
        s, y = v_new - v, g_new - g
        sy = _dot(s, y)
        if bool(sy > 1e-12):
            pairs = (pairs + [(s, y, 1.0 / sy)])[-history:]
        v, g = v_new, g_new
        gn = float(cn_norm(g))
        k += 1
    return LbfgsResult(v=v, iters=k, grad_norm=gn, converged=gn <= cn_eps,
                       backtracks=backtracks)
