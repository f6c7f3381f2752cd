"""Finite-difference check of the implicit objective: energy -> residual
-> Hessian.

Counterpart of ``hot_tpu.sim.difftest``. For halving steps h along a
random projected unit direction dv at v0:
  e_grad(h) = |E(v + h dv) - E(v) - h <r(v), dv>|      ~ O(h^2)
  e_hess(h) = |r(v + h dv) - r(v) - h H(v) dv|_2       ~ O(h^2)
(the Hessian row at inactive nodes, the identity, is left out), and the
observed orders log2(e(h) / e(h/2)).
"""

from __future__ import annotations

import math

import torch

from hot_tpu_torch.sim import objective as obj_mod


def run_difftest(model, obj, v0, generator: torch.Generator = None, n_refinements: int = 8,
                 project_spd: bool = False, verbose: bool = True):
    """The refinement sweep at v0: a dict of h, e_grad, e_hess, order_grad
    and order_hess. The direction is drawn from `generator` (seed 0 when
    None)."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    dv = torch.randn(v0.shape, generator=generator, dtype=v0.dtype).to(v0.device)
    dv = obj_mod.project(obj, dv)
    dv = dv / torch.linalg.norm(dv)

    E0 = obj_mod.energy(model, obj, v0)
    r0 = obj_mod.residual(model, obj, v0)
    hess = obj_mod.build_hessian(model, obj, v0, project_spd=project_spd)
    Hdv = obj_mod.multiply(obj, hess, dv)
    mask = obj.active[:, None]
    Hdv = torch.where(mask, Hdv, torch.zeros_like(Hdv))
    rdv = torch.sum(r0 * dv)

    hs, e_grad, e_hess = [], [], []
    for k in range(n_refinements):
        h = 1e-2 * 0.5 ** k
        vh = v0 + h * dv
        e_g = abs(float(obj_mod.energy(model, obj, vh) - E0 - h * rdv))
        diff = obj_mod.residual(model, obj, vh) - r0 - h * Hdv
        e_h = float(torch.linalg.norm(torch.where(mask, diff, torch.zeros_like(diff))))
        hs.append(h)
        e_grad.append(e_g)
        e_hess.append(e_h)

    def orders(errs):
        return [math.log2(a / b) if a > 0 and b > 0 else float("nan")
                for a, b in zip(errs[:-1], errs[1:])]

    result = dict(h=hs, e_grad=e_grad, e_hess=e_hess, order_grad=orders(e_grad),
                  order_hess=orders(e_hess))
    if verbose:
        print("      h        e_grad   order    e_hess   order")
        for i, h in enumerate(hs):
            og = result["order_grad"][i - 1] if i else float("nan")
            oh = result["order_hess"][i - 1] if i else float("nan")
            print(f"{h:10.3e} {e_grad[i]:9.2e} {og:6.2f} {e_hess[i]:9.2e} {oh:6.2f}")
    return result
