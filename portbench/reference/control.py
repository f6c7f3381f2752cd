"""The control: the reference put in the program's place, in the precision
just below the configuration's (float32 with TF32 off, so TF32: every
product's operands rounded to 10 mantissa bits).

``control_step`` takes a whole step as the program does: P2G, the
boundary conditions, inexact Newton on the backward-Euler system with the
configuration's tolerances (HOT's characteristic norm, forcing
eta = clip(sqrt(cn / cn0), cg_tol, 0.5), at most max_newton iterations and
max_cg CG iterations each, CG preconditioned by the inverse grid mass, the
Hessian product the forward-mode derivative of the residual), then G2P. It
returns a record of the form the judge reads, so the judge holds the
control to the same numbers as the program.
"""

from __future__ import annotations

import torch
import torch.autograd.forward_ad as fwAD

from portbench.reference import mpm


def _cg(apply, b, precond, tol: float, max_iters: int):
    x = torch.zeros_like(b)
    r = b.clone()
    z = precond(r)
    p = z.clone()
    rz = torch.sum(r * z)
    b_norm = torch.sqrt(torch.sum(b * b))
    for it in range(max_iters):
        if float(torch.sqrt(torch.sum(r * r))) <= tol * float(b_norm):
            return x, it
        Ap = apply(p)
        pAp = torch.sum(p * Ap)
        if float(pAp) <= 0.0:
            return x, it
        alpha = rz / pAp
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = torch.sum(r * z)
        p = z + (rz_new / rz) * p
        rz = rz_new
    return x, max_iters


def control_step(sc: mpm.Scene, state: dict, dt: float, solver: dict, ar: mpm.Arith):
    """One step from `state` (x, v, Cf, Ff) in the arithmetic `ar`; returns
    (record, stats)."""
    x, v = state["x"], state["v"]
    n = x.shape[0]
    C, F = state["Cf"].reshape(n, 3, 3), state["Ff"].reshape(n, 3, 3)
    st = mpm.stencil(x, sc.dx, sc.res)
    mass, v_star = mpm.p2g(sc, st, v, C, dt, ar)
    active = mass > 0
    act = torch.nonzero(active).squeeze(-1)
    fixed_a, v_bc_a = mpm.boundary(sc, mpm.node_positions(sc, act, x.dtype))
    fixed = torch.zeros_like(active)
    fixed[act] = fixed_a
    v_bc = torch.zeros_like(v_star)
    v_bc[act] = v_bc_a
    free = (active & ~fixed)[:, None].to(x.dtype)
    scale = mpm.cn_scale(sc, st, mass, dt)
    inv_m = torch.where(active, 1.0 / torch.where(active, mass, 1.0), 0.0)[:, None]

    def res(vg):
        return mpm.residual(sc, st, F, mass, v_star, fixed, v_bc, vg, dt, ar)

    vg = torch.where(fixed[:, None], v_bc, v_star)
    r = res(vg)
    cn0 = cn = float(mpm.cn_norm(r, scale, mass))
    newton = cg_total = 0
    while newton < solver["max_newton"] and cn > solver["cn_eps"]:
        eta = min(max((cn / max(cn0, 1e-30)) ** 0.5, solver["cg_tol"]), 0.5)

        def hess(w, vg=vg):
            with fwAD.dual_level():
                out = res(fwAD.make_dual(vg, w * free))
                return fwAD.unpack_dual(out).tangent * free

        dv, its = _cg(hess, -r * free, lambda z: z * inv_m, eta, solver["max_cg"])
        vg = vg + dv * free
        r = res(vg)
        cn = float(mpm.cn_norm(r, scale, mass))
        newton += 1
        cg_total += its
    x1, v1, C1, F1 = mpm.g2p(sc, st, x, F, vg, dt, ar)
    pos = mpm.node_positions(sc, act, x.dtype)
    record = {"dt": dt, "node_pos": pos, "v_star": v_star[act], "v_new": vg[act],
              "out": {"x": x1, "v": v1, "Cf": C1.reshape(n, 9), "Ff": F1.reshape(n, 9)}}
    return record, {"newton": newton, "cg": cg_total, "cn": cn, "cn0": cn0}
