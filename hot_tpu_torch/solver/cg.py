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

Both also solve a batch of B independent systems at once, vectors with a
leading member dimension (what ``jax.vmap`` makes of hot_tpu's loop): every
dot product is per member, each member takes its own alpha and beta and
stops on its own threshold, and a member that has stopped is frozen (its
iterate kept by select, never multiplied by a mask, so a frozen member's
0/0 cannot poison the others). The loop runs while any member is active and
reads back one (B,) activity mask per iteration.

On a slab of a rank mesh (``parallel``) every dot product is a partial sum
over the rank's nodes: ``reduce`` (hot_tpu's ``axis_name``) sums it over the
ranks, so every rank takes the same alpha, beta and iteration count. None
(one grid) leaves the path as it was.

Each iteration is a ``cg.iter`` span (``utils.timing``), and its read-back
counts one host sync.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from hot_tpu_torch.utils.timing import span, synced


class CGResult(NamedTuple):
    x: torch.Tensor
    iters: int                 # iterations executed (a batch: a list, per member)
    residual: torch.Tensor     # final |r|_2 (a batch: (B,))
    residual0: torch.Tensor    # initial |r|_2
    converged: bool            # (a batch: a (B,) tensor)


def _dot(a, b):
    return torch.sum(a * b)


def dot(a, b, batched: bool = False):
    """a . b; per member (B,) over everything but the leading dimension for
    a batch."""
    return torch.sum(a * b, dim=tuple(range(1, a.ndim))) if batched else _dot(a, b)


def reducing(batched: bool, reduce: Optional[Callable] = None):
    """The dot product of a solve: per member for a batch, summed over the
    ranks by `reduce` on a slab."""
    if reduce is None:
        return lambda a, b: dot(a, b, batched)
    return lambda a, b: reduce(dot(a, b, batched))


def per_member(s, like):
    """A scalar per problem (0-dim, or (B,) for a batch) against vectors
    shaped like `like`."""
    return s if s.ndim == 0 else s.reshape(s.shape + (1,) * (like.ndim - 1))


def keep(going, new, old):
    """new where a member is still going, old where it is frozen. One
    problem (a 0-dim mask) leaves its loop instead of freezing, so inside
    the loop it takes new."""
    if going.ndim == 0:
        return new
    return torch.where(going.reshape(going.shape + (1,) * (new.ndim - going.ndim)), new, old)


def any_going(flags) -> bool:
    """A read-back mask (a bool, or a list per member) has a member going."""
    return any(flags) if isinstance(flags, list) else flags


def count(total, flags):
    """Iteration counters advanced by a read-back mask: an int for one
    problem, a list per member for a batch."""
    if isinstance(flags, list):
        return [t + f for t, f in zip(total, flags)]
    return total + flags


def _identity(x):
    return x


def _result(x, iters, rnorm, rnorm0, threshold) -> CGResult:
    converged = rnorm <= threshold
    return CGResult(x=x, iters=iters, residual=rnorm, residual0=rnorm0,
                    converged=converged if converged.ndim else synced(bool(converged)))


def cg_solve(multiply: Callable, b, x0=None, *, precondition: Optional[Callable] = None,
             project: Optional[Callable] = None, tol=1e-3, abs_tol: float = 0.0,
             max_iters: int = 200, active=None, reduce: Optional[Callable] = None) -> CGResult:
    """Solve A x = b; stop when |r|_2 <= max(tol |r0|_2, abs_tol).

    A batch (b (B, ...)) passes `active`, the (B,) mask of the members to
    solve (the others keep x0 and count no iteration), and tol may be a
    (B,) tensor (see the module doc)."""
    precondition = precondition or _identity
    project = project or _identity
    batched = active is not None
    dot_ = reducing(batched, reduce)
    x = torch.zeros_like(b) if x0 is None else x0
    r = project(b - multiply(x))
    z = project(precondition(r))
    p = z
    rz = dot_(r, z)
    rnorm0 = torch.sqrt(dot_(r, r))
    threshold = torch.clamp(tol * rnorm0, min=abs_tol)
    rnorm = rnorm0
    going = rnorm > threshold
    if active is not None:
        going = going & active
    iters = [0] * going.shape[0] if going.ndim else 0
    k = 0
    while k < max_iters:
        flags = synced(going.tolist())
        if not any_going(flags):
            break
        with span("cg.iter"):
            Ap = project(multiply(p))
            pAp = dot_(p, Ap)
            alpha = per_member(torch.where(
                pAp > 0, rz / torch.where(pAp == 0, torch.ones_like(pAp), pAp),
                torch.zeros_like(pAp)), p)
            x = keep(going, x + alpha * p, x)
            r = keep(going, r - alpha * Ap, r)
            z = project(precondition(r))
            rz_new = dot_(r, z)
            beta = rz_new / torch.where(rz == 0, torch.ones_like(rz), rz)
            p = keep(going, z + per_member(beta, p) * p, p)
            rz = keep(going, rz_new, rz)
            k += 1
            iters = count(iters, flags)
            rnorm = keep(going, torch.sqrt(dot_(r, r)), rnorm)
            going = going & (rnorm > threshold)
    return _result(x, iters, rnorm, rnorm0, threshold)


def minres_solve(multiply: Callable, b, x0=None, *, precondition: Optional[Callable] = None,
                 project: Optional[Callable] = None, tol=1e-3, abs_tol: float = 0.0,
                 max_iters: int = 200, active=None,
                 reduce: Optional[Callable] = None) -> CGResult:
    """Preconditioned conjugate residual (MINRES-equivalent for symmetric A,
    so it takes a mildly indefinite operator, e.g. the Hessian without SPD
    projection), `precondition` SPD:

        z = M^-1 r,  alpha = (z . Az) / (Ap . M^-1 Ap),
        beta = (z' . Az') / (z . Az),  p = z' + beta p,  Ap = Az' + beta Ap.

    hot_tpu's minres_solve divides by Ap . Ap, which is this only for M = I
    and diverges under any other preconditioner; with M = I the two take
    the same iterates. Stops as cg_solve does, and takes a batch as
    cg_solve does (per-member alpha, beta and counters, a stopped member
    frozen by select). Each iteration applies the operator once and the
    preconditioner twice."""
    precondition = precondition or _identity
    project = project or _identity
    batched = active is not None
    dot_ = reducing(batched, reduce)
    x = torch.zeros_like(b) if x0 is None else x0
    r = project(b - multiply(x))
    z = project(precondition(r))
    Az = project(multiply(z))
    p, Ap = z, Az
    zAz = dot_(z, Az)
    rnorm0 = torch.sqrt(dot_(r, r))
    threshold = torch.clamp(tol * rnorm0, min=abs_tol)
    rnorm = rnorm0
    going = rnorm > threshold
    if batched:
        going = going & active
    iters = [0] * going.shape[0] if going.ndim else 0
    k = 0
    while k < max_iters:
        flags = synced(going.tolist())
        if not any_going(flags):
            break
        with span("cg.iter"):
            ApMAp = dot_(Ap, project(precondition(Ap)))
            alpha = per_member(torch.where(
                ApMAp.abs() > 0, zAz / torch.where(ApMAp == 0, torch.ones_like(ApMAp), ApMAp),
                torch.zeros_like(ApMAp)), p)
            x = keep(going, x + alpha * p, x)
            r = keep(going, r - alpha * Ap, r)
            z = project(precondition(r))
            Az = project(multiply(z))
            zAz_new = dot_(z, Az)
            beta = per_member(zAz_new / torch.where(zAz == 0, torch.ones_like(zAz), zAz), p)
            p = keep(going, z + beta * p, p)
            Ap = keep(going, Az + beta * Ap, Ap)
            zAz = keep(going, zAz_new, zAz)
            k += 1
            iters = count(iters, flags)
            rnorm = keep(going, torch.sqrt(dot_(r, r)), rnorm)
            going = going & (rnorm > threshold)
    return _result(x, iters, rnorm, rnorm0, threshold)
