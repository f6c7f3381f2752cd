"""L-BFGS minimiser over the incremental potential: HOT's LBFGS-H baseline.

Counterpart of ``hot_tpu.solver.lbfgs.lbfgs_solve``, as a host loop (like
``solver.newton``): the two-loop recursion over a ring buffer of the last
``history`` (s, y) pairs with the preconditioner as the initial inverse
Hessian, steepest descent (the preconditioned, projected gradient) where
the direction is not a descent direction, Armijo backtracking by halving up
to ``ls_max_backtracks`` times, and a pair kept only where s . y > 1e-12.
The loop stops when the characteristic norm of the gradient reaches cn_eps
or after max_iters iterations.

A batch of B problems (v (B, ...); energy and cn_norm return (B,)) runs as
``jax.vmap`` runs hot_tpu's loops: every member keeps its own history ring
(hot_tpu's slot count % history), two-loop scalars, steepest-descent
fallback, Armijo search, curvature test and counters, and a member that has
stopped is frozen (``solver.cg.keep``). Each iteration reads back one (B,)
mask with the members' curvature tests, and each line-search trial one.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from hot_tpu_torch.solver.cg import any_going, count, dot, keep, per_member
from hot_tpu_torch.utils.timing import h2d, synced


class LbfgsResult(NamedTuple):
    """The result; for a batch every field but v is a list, one entry per
    member."""

    v: torch.Tensor
    iters: int              # iterations executed
    grad_norm: float        # characteristic norm of the final gradient
    converged: bool
    backtracks: int         # Armijo halvings across the solve


def lbfgs_solve(*, energy: Callable, gradient: Callable, project: Callable, v0,
                precondition: Optional[Callable] = None, cn_norm: Optional[Callable] = None,
                history: int = 8, max_iters: int = 100, cn_eps: float = 1e-2,
                ls_max_backtracks: int = 10) -> LbfgsResult:
    """Minimise energy(v) from v0; gradient(v) is its projected gradient.
    With cn_norm returning (B,) the problem is a batch (see the module doc);
    one problem runs as a batch of one, whose sums are the whole vectors'
    sums, so it takes the same iterates."""
    precondition = precondition or (lambda r: r)
    cn_norm = cn_norm or (lambda r: torch.linalg.norm(r))
    g0 = gradient(v0)
    gn0 = cn_norm(g0)
    if gn0.ndim:
        return _lbfgs_batch(energy, gradient, project, precondition, cn_norm, v0, g0, gn0,
                            history, max_iters, cn_eps, ls_max_backtracks)

    def one(fn):
        return lambda v: fn(v[0])[None]

    res = _lbfgs_batch(one(energy), one(gradient), one(project), one(precondition), one(cn_norm),
                       v0[None], g0[None], gn0[None], history, max_iters, cn_eps,
                       ls_max_backtracks)
    return LbfgsResult(v=res.v[0], iters=res.iters[0], grad_norm=res.grad_norm[0],
                       converged=res.converged[0], backtracks=res.backtracks[0])


def _lbfgs_batch(energy, gradient, project, precondition, cn_norm, v0, g, gn, m: int,
                 max_iters: int, cn_eps: float, ls_max_backtracks: int) -> LbfgsResult:
    """lbfgs_solve's loop over a batch: the same operations per member, with
    the ring of hot_tpu's lbfgs_solve (a member's pair i back from its newest
    in slot (count - 1 - i) % m)."""
    B = gn.shape[0]
    members = torch.arange(B, device=v0.device)
    S = Y = rho = None              # (m, B, ...) rings, allocated at the first pair
    counts = [0] * B                # pairs kept per member
    n_pairs = [0] * B               # pairs in use: min(count, m)

    def pair(i):
        """Each member's pair i back from its newest: (s, y, rho, valid)."""
        slot = h2d(torch.tensor([(c - 1 - i) % m for c in counts], device=v0.device))
        valid = h2d(torch.tensor([i < n for n in n_pairs], device=v0.device))
        return S[slot, members], Y[slot, members], rho[slot, members], valid

    def two_loop(q):
        alphas = []
        for i in range(max(n_pairs)):
            s, y, r, valid = pair(i)
            a = torch.where(valid, r * dot(s, q, True), torch.zeros_like(r))
            q = q - per_member(a, q) * y
            alphas.append(a)
        z = precondition(q)
        for i in reversed(range(max(n_pairs))):
            s, y, r, valid = pair(i)
            c = torch.where(valid, alphas[i] - r * dot(y, z, True), torch.zeros_like(r))
            z = z + per_member(c, z) * s
        return z

    v = v0
    going = gn > cn_eps
    flags = synced(going.tolist())
    k, iters, backtracks = 0, [0] * B, [0] * B
    while k < max_iters and any_going(flags):
        d = project(-two_loop(g))
        E0 = energy(v)
        slope = dot(g, d, True)
        # steepest descent where the direction is not a descent direction
        descent = slope < 0
        fallback = -project(precondition(g))
        d = keep(descent, d, fallback)
        slope = torch.where(descent, slope, torch.minimum(slope, dot(g, fallback, True)))
        alpha = torch.ones_like(slope)
        trying = going
        for _ in range(ls_max_backtracks):
            trying = trying & ~(energy(v + per_member(alpha, v) * d)
                                <= E0 + 1e-4 * alpha * slope)
            halve = synced(trying.tolist())
            if not any_going(halve):
                break
            alpha = torch.where(trying, 0.5 * alpha, alpha)
            backtracks = count(backtracks, halve)
        v_new = v + per_member(alpha, v) * d
        g_new = gradient(v_new)
        s, y = v_new - v, g_new - g
        sy = dot(s, y, True)
        kept = going & (sy > 1e-12)
        if S is None:
            S, Y = (torch.zeros((m,) + v.shape, dtype=v.dtype, device=v.device)
                    for _ in range(2))
            rho = torch.zeros((m, B), dtype=v.dtype, device=v.device)
        slot = h2d(torch.tensor([c % m for c in counts], device=v.device))
        S[slot, members] = keep(kept, s, S[slot, members])
        Y[slot, members] = keep(kept, y, Y[slot, members])
        rho[slot, members] = torch.where(kept, 1.0 / torch.where(kept, sy, torch.ones_like(sy)),
                                         rho[slot, members])
        v, g = keep(going, v_new, v), keep(going, g_new, g)
        gn = keep(going, cn_norm(g_new), gn)
        k += 1
        iters = count(iters, flags)
        going = going & (gn > cn_eps)
        kept_flags, flags = synced(torch.stack([kept, going]).tolist())
        counts = count(counts, kept_flags)
        n_pairs = [min(c, m) for c in counts]
    gn = synced(gn.tolist())
    return LbfgsResult(v=v, iters=iters, grad_norm=gn, converged=[x <= cn_eps for x in gn],
                       backtracks=backtracks)
