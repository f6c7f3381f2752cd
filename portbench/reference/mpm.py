"""A plain PyTorch reference of one implicit MPM step (HOT's backward
Euler on APIC transfers), written from the method's equations and
independent of the program under test: it imports no module of the port or
of the JAX package, and takes no table, weight or state the program made.

The step, for particles (x, v, C, F) with mass m, volume V0 and Lame
parameters (mu, lam), on a dense grid of spacing dx (node i at i dx):

* stencil: quadratic B-splines, base node floor(x/dx - 1/2), 3 nodes per
  axis, node coordinates clamped to the grid;
* P2G: m_i = sum_p w_ip m_p, (m v)_i = sum_p w_ip m_p (v_p + C_p (x_i - x_p)),
  v*_i = (m v)_i / m_i + dt g;
* boundary conditions: a node strictly inside a sticky box takes the box's
  rigid velocity; a node within `margin` layers of the domain's faces is
  held at rest; both are constrained;
* the solve: v minimises E(v) = 1/2 |v - v*|_M^2 + sum_p V0_p psi(F_p(v)),
  F_p(v) = (I + dt sum_i v_i grad w_ip^T) F_p, with psi fixed corotated,
  P = 2 mu (F - R) + lam (J - 1) cof(F); its residual at free nodes is
  r_i = m_i (v_i - v*_i) + dt sum_p V0_p P_p F_p^T grad w_ip, at constrained
  nodes m_i (v_i - v_bc,i); HOT's characteristic norm is
  CN = sqrt(sum_i |r_i / s_i|^2 / n_active), s_i = max(dt f_i, m_i dx / dt),
  f_i = sum_p w_ip V0_p (2 mu_p + lam_p) / dx;
* G2P: v_p = sum_i w_ip v_i, C_p = 4/dx^2 sum_i w_ip v_i (x_i - x_p)^T,
  F_p <- (I + dt grad v_p) F_p, x_p <- x_p + dt v_p clamped to
  [2 dx, (res - 3) dx].

Every contraction (matrix products, stencil sums) goes through ``Arith``,
so the same code runs in float64 (the judge), float32, or float32 with each
product's operands rounded to TF32 (the control: the tensor cores' 10-bit
mantissa, products accumulated in float32).
"""

from __future__ import annotations

import itertools
from typing import NamedTuple

import torch

STICKY = "sticky"


def tf32_round(t):
    """t (float32) rounded to the nearest TF32 value (10 mantissa bits,
    ties to even), as the tensor cores read their operands."""
    bits = t.contiguous().view(torch.int32)
    bias = 0xFFF + ((bits >> 13) & 1)
    return ((bits + bias) & ~0x1FFF).view(torch.float32)


class Arith:
    """The arithmetic of the contractions: `dtype`, and with `tf32` each
    product's operands rounded to TF32 first (float32 only). The rounding
    passes forward-mode tangents through unchanged."""

    def __init__(self, dtype=torch.float64, tf32: bool = False):
        if tf32 and dtype != torch.float32:
            raise ValueError("TF32 rounds float32 operands")
        self.dtype, self.tf32 = dtype, tf32

    def _op(self, a):
        if not self.tf32:
            return a
        plain = a.detach()
        return a + (tf32_round(plain) - plain)

    def ein(self, eq: str, a, b):
        return torch.einsum(eq, self._op(a), self._op(b))


class Stencil(NamedTuple):
    ids: torch.Tensor    # (n, 27) int64 dense node ids (row-major)
    w: torch.Tensor      # (n, 27) weights
    gw: torch.Tensor     # (n, 27, 3) weight gradients
    rel: torch.Tensor    # (n, 27, 3) node position - particle position


OFFSETS = tuple(itertools.product(range(3), repeat=3))


def stencil(x, dx: float, res: int) -> Stencil:
    xs = x / dx
    base = torch.floor(xs - 0.5)
    u = xs - base
    w1 = torch.stack([0.5 * (1.5 - u) ** 2, 0.75 - (u - 1.0) ** 2, 0.5 * (u - 0.5) ** 2], -1)
    d1 = torch.stack([u - 1.5, -2.0 * (u - 1.0), u - 0.5], -1) / dx
    off = torch.tensor(OFFSETS, device=x.device)                     # (27, 3)
    a, b, c = off[:, 0], off[:, 1], off[:, 2]
    wx, wy, wz = w1[:, 0, a], w1[:, 1, b], w1[:, 2, c]               # (n, 27)
    w = wx * wy * wz
    gw = torch.stack([d1[:, 0, a] * wy * wz, wx * d1[:, 1, b] * wz, wx * wy * d1[:, 2, c]], -1)
    coords = (base.long()[:, None, :] + off).clamp(0, res - 1)
    ids = (coords[..., 0] * res + coords[..., 1]) * res + coords[..., 2]
    rel = coords.to(x.dtype) * dx - x[:, None, :]
    return Stencil(ids=ids, w=w, gw=gw, rel=rel)


def scatter(ids, vals, n_nodes: int):
    """sum of (n, 27[, c]) values onto (n_nodes[, c])."""
    flat = vals.reshape((-1,) + vals.shape[2:])
    out = torch.zeros((n_nodes,) + vals.shape[2:], dtype=vals.dtype, device=vals.device)
    return out.index_add(0, ids.reshape(-1), flat)


class Scene(NamedTuple):
    """What the reference needs of the configuration and the inputs the
    benchmark made: the grid, the step's constants and the particles'
    material (m, V0, mu, lam)."""

    res: int
    dx: float
    gravity: tuple
    margin: int             # node layers held at rest at the domain's faces
    boxes: tuple            # sticky boxes: dicts of lo, hi, center, omega (3-vectors)
    m: torch.Tensor
    V0: torch.Tensor
    mu: torch.Tensor
    lam: torch.Tensor

    @property
    def n_nodes(self) -> int:
        return self.res ** 3


def p2g(sc: Scene, st: Stencil, v, C, dt: float, ar: Arith):
    """(grid mass (N,), v* (N, 3)) on the dense grid."""
    mw = sc.m[:, None] * st.w
    affine = ar.ein("pij,pkj->pki", C, st.rel)
    mass = scatter(st.ids, mw, sc.n_nodes)
    mom = scatter(st.ids, mw[..., None] * (v[:, None, :] + affine), sc.n_nodes)
    active = mass > 0
    vel = torch.where(active[:, None], mom / torch.where(active, mass, 1.0)[:, None], 0.0)
    g = torch.tensor(sc.gravity, dtype=vel.dtype, device=vel.device)
    return mass, vel + dt * g


def node_positions(sc: Scene, idx, dtype):
    r = sc.res
    coords = torch.stack([idx // (r * r), (idx // r) % r, idx % r], -1)
    return coords.to(dtype) * sc.dx


def boundary(sc: Scene, pos):
    """(constrained (k,), v_bc (k, 3)) at node positions pos (k, 3)."""
    fixed = torch.zeros(pos.shape[0], dtype=torch.bool, device=pos.device)
    v_bc = torch.zeros_like(pos)
    for box in sc.boxes:
        lo, hi, ctr, om = (torch.tensor(box[k], dtype=pos.dtype, device=pos.device)
                           for k in ("lo", "hi", "center", "omega"))
        inside = torch.all((pos > lo) & (pos < hi), dim=-1)
        v_obj = torch.linalg.cross(om.expand_as(pos), pos - ctr, dim=-1)
        v_bc = torch.where(inside[:, None], v_obj, v_bc)
        fixed = fixed | inside
    lo = sc.margin * sc.dx
    hi = (sc.res - 1 - sc.margin) * sc.dx
    wall = torch.any((pos < lo) | (pos > hi), dim=-1)
    v_bc = torch.where(wall[:, None], 0.0, v_bc)
    return fixed | wall, v_bc


def _cofactor(F):
    """cof(F) = det(F) F^{-T}, entrywise (no matrix product)."""
    a = F
    c00 = a[:, 1, 1] * a[:, 2, 2] - a[:, 1, 2] * a[:, 2, 1]
    c01 = a[:, 1, 2] * a[:, 2, 0] - a[:, 1, 0] * a[:, 2, 2]
    c02 = a[:, 1, 0] * a[:, 2, 1] - a[:, 1, 1] * a[:, 2, 0]
    c10 = a[:, 0, 2] * a[:, 2, 1] - a[:, 0, 1] * a[:, 2, 2]
    c11 = a[:, 0, 0] * a[:, 2, 2] - a[:, 0, 2] * a[:, 2, 0]
    c12 = a[:, 0, 1] * a[:, 2, 0] - a[:, 0, 0] * a[:, 2, 1]
    c20 = a[:, 0, 1] * a[:, 1, 2] - a[:, 0, 2] * a[:, 1, 1]
    c21 = a[:, 0, 2] * a[:, 1, 0] - a[:, 0, 0] * a[:, 1, 2]
    c22 = a[:, 0, 0] * a[:, 1, 1] - a[:, 0, 1] * a[:, 1, 0]
    cof = torch.stack([torch.stack([c00, c01, c02], -1), torch.stack([c10, c11, c12], -1),
                       torch.stack([c20, c21, c22], -1)], -2)
    det = a[:, 0, 0] * c00 + a[:, 0, 1] * c01 + a[:, 0, 2] * c02
    return cof, det


POLAR_ITERS = 12


def rotation(F):
    """R of the polar decomposition F = R S (det F > 0) by Newton's
    iteration R <- (R + R^{-T}) / 2, which converges quadratically from R = F
    for the stretches of an elastic step."""
    R = F
    for _ in range(POLAR_ITERS):
        cof, det = _cofactor(R)
        R = 0.5 * (R + cof / det[:, None, None])
    return R


def piola(F, mu, lam):
    """Fixed corotated first Piola-Kirchhoff stress (Stomakhin et al. 2012)."""
    cof, J = _cofactor(F)
    return (2.0 * mu[:, None, None] * (F - rotation(F))
            + (lam * (J - 1.0))[:, None, None] * cof)


def updated_F(st: Stencil, v_grid, F, dt: float, ar: Arith):
    vk = v_grid[st.ids]                                   # (n, 27, 3)
    grad = ar.ein("pki,pkj->pij", vk, st.gw)
    eye = torch.eye(3, dtype=F.dtype, device=F.device)
    return ar.ein("pij,pjk->pik", eye + dt * grad, F)


def elastic_force(sc: Scene, st: Stencil, v_grid, F, dt: float, ar: Arith):
    """f (N, 3) = -sum_p V0_p P(F_p(v)) F_p^T grad w_ip."""
    P = piola(updated_F(st, v_grid, F, dt, ar), sc.mu, sc.lam)
    PFt = ar.ein("pij,pkj->pik", P, F)
    contrib = -sc.V0[:, None, None] * ar.ein("pij,pkj->pki", PFt, st.gw)
    return scatter(st.ids, contrib, sc.n_nodes)


def cn_scale(sc: Scene, st: Stencil, mass, dt: float):
    stiff = sc.V0 * (2.0 * sc.mu + sc.lam) / sc.dx
    f_char = scatter(st.ids, st.w * stiff[:, None], sc.n_nodes)
    return torch.maximum(dt * f_char, mass * sc.dx / dt)


def residual(sc: Scene, st: Stencil, F, mass, v_star, fixed, v_bc, v_grid, dt: float,
             ar: Arith):
    """r (N, 3) of the constrained backward-Euler system (see the module
    doc); zero at nodes without mass."""
    f = elastic_force(sc, st, v_grid, F, dt, ar)
    free = mass[:, None] * (v_grid - v_star) - dt * f
    held = mass[:, None] * (v_grid - v_bc)
    r = torch.where(fixed[:, None], held, free)
    return torch.where((mass > 0)[:, None], r, 0.0)


def cn_norm(r, scale, mass):
    active = mass > 0
    s = torch.where(active, scale, 1.0)
    scaled = (r / s[:, None]) ** 2
    return torch.sqrt(scaled.sum() / torch.clamp(active.sum(), min=1).to(r.dtype))


def g2p(sc: Scene, st: Stencil, x, F, v_grid, dt: float, ar: Arith):
    """(x, v, C, F) after the step, from the solved grid velocities."""
    vk = v_grid[st.ids]
    v_p = ar.ein("pk,pki->pi", st.w, vk)
    grad = ar.ein("pki,pkj->pij", vk, st.gw)
    C = (4.0 / (sc.dx * sc.dx)) * ar.ein("pki,pkj->pij", st.w[..., None] * vk, st.rel)
    eye = torch.eye(3, dtype=F.dtype, device=F.device)
    F_new = ar.ein("pij,pjk->pik", eye + dt * grad, F)
    x_new = torch.clamp(x + dt * v_p, min=2.0 * sc.dx, max=(sc.res - 3) * sc.dx)
    return x_new, v_p, C, F_new


def scene_from(spec: dict, material: dict, device, dtype) -> Scene:
    """A Scene from the configuration's recipe (its grid, gravity and sticky
    boxes) and the benchmark's material arrays."""
    boxes = []
    for b in spec["colliders"]:
        if b["kind"] != STICKY or b["shape"] != "box":
            raise ValueError(f"the reference models sticky boxes only, not {b}")
        om = [0.0, 0.0, 0.0]
        om[b["spin_axis"]] = b["spin_sign"] * spec["omega"]
        boxes.append(dict(lo=b["lo"], hi=b["hi"], center=spec["center"], omega=om))
    return Scene(res=spec["res"], dx=1.0 / spec["res"], gravity=tuple(spec["gravity"]),
                 margin=spec["boundary_margin"], boxes=tuple(boxes),
                 **{k: material[k].to(device=device, dtype=dtype)
                    for k in ("m", "V0", "mu", "lam")})

