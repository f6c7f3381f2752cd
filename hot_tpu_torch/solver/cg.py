"""Matrix-free preconditioned projected CG and conjugate residual (MINRES)
over an abstract operator.

Counterpart of ``hot_tpu.solver.cg`` (``cg_solve``, ``minres_solve``). The
loops run on the host: each iteration reads one scalar (the residual norm)
back from the device to decide whether to stop. CG applies the operator
once for the initial residual and once per iteration; MINRES once more,
for the first preconditioned residual, and the preconditioner twice per
iteration.

``project`` enforces Dirichlet/collision constraints: an orthogonal
projector applied to residuals and directions; the operator acts as the
identity on the projected-out subspace.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch


class CGResult(NamedTuple):
    x: torch.Tensor
    iters: int                 # iterations executed
    residual: torch.Tensor     # final |r|_2
    residual0: torch.Tensor    # initial |r|_2
    converged: bool


def _dot(a, b):
    return torch.sum(a * b)


def _identity(x):
    return x


def cg_solve(multiply: Callable, b, x0=None, *, precondition: Optional[Callable] = None,
             project: Optional[Callable] = None, tol=1e-3, abs_tol: float = 0.0,
             max_iters: int = 200) -> CGResult:
    """Solve A x = b; stop when |r|_2 <= max(tol |r0|_2, abs_tol)."""
    precondition = precondition or _identity
    project = project or _identity
    x = torch.zeros_like(b) if x0 is None else x0
    r = project(b - multiply(x))
    z = project(precondition(r))
    p = z
    rz = _dot(r, z)
    rnorm0 = torch.sqrt(_dot(r, r))
    threshold = torch.clamp(tol * rnorm0, min=abs_tol)
    rnorm = rnorm0
    k = 0
    while k < max_iters and bool(rnorm > threshold):
        Ap = project(multiply(p))
        pAp = _dot(p, Ap)
        alpha = torch.where(pAp > 0, rz / torch.where(pAp == 0, torch.ones_like(pAp), pAp),
                            torch.zeros_like(pAp))
        x = x + alpha * p
        r = r - alpha * Ap
        z = project(precondition(r))
        rz_new = _dot(r, z)
        beta = rz_new / torch.where(rz == 0, torch.ones_like(rz), rz)
        p = z + beta * p
        rz = rz_new
        k += 1
        rnorm = torch.sqrt(_dot(r, r))
    return CGResult(x=x, iters=k, residual=rnorm, residual0=rnorm0,
                    converged=bool(rnorm <= threshold))


def minres_solve(multiply: Callable, b, x0=None, *, precondition: Optional[Callable] = None,
                 project: Optional[Callable] = None, tol=1e-3, abs_tol: float = 0.0,
                 max_iters: int = 200) -> CGResult:
    """Preconditioned conjugate residual (MINRES-equivalent for symmetric A,
    so it takes a mildly indefinite operator, e.g. the Hessian without SPD
    projection), `precondition` SPD:

        z = M^-1 r,  alpha = (z . Az) / (Ap . M^-1 Ap),
        beta = (z' . Az') / (z . Az),  p = z' + beta p,  Ap = Az' + beta Ap.

    hot_tpu's minres_solve divides by Ap . Ap, which is this only for M = I
    and diverges under any other preconditioner; with M = I the two take
    the same iterates. Stops as cg_solve does. Each iteration applies the
    operator once and the preconditioner twice."""
    precondition = precondition or _identity
    project = project or _identity
    x = torch.zeros_like(b) if x0 is None else x0
    r = project(b - multiply(x))
    z = project(precondition(r))
    Az = project(multiply(z))
    p, Ap = z, Az
    zAz = _dot(z, Az)
    rnorm0 = torch.sqrt(_dot(r, r))
    threshold = torch.clamp(tol * rnorm0, min=abs_tol)
    rnorm = rnorm0
    k = 0
    while k < max_iters and bool(rnorm > threshold):
        ApMAp = _dot(Ap, project(precondition(Ap)))
        alpha = torch.where(ApMAp.abs() > 0,
                            zAz / torch.where(ApMAp == 0, torch.ones_like(ApMAp), ApMAp),
                            torch.zeros_like(ApMAp))
        x = x + alpha * p
        r = r - alpha * Ap
        z = project(precondition(r))
        Az = project(multiply(z))
        zAz_new = _dot(z, Az)
        beta = zAz_new / torch.where(zAz == 0, torch.ones_like(zAz), zAz)
        p = z + beta * p
        Ap = Az + beta * Ap
        zAz = zAz_new
        k += 1
        rnorm = torch.sqrt(_dot(r, r))
    return CGResult(x=x, iters=k, residual=rnorm, residual0=rnorm0,
                    converged=bool(rnorm <= threshold))
