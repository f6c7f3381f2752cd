"""Analytic collision objects and grid-node boundary conditions.

Counterpart of ``hot_tpu.sim.collision`` (half spaces and axis boxes with
scripted rigid motion). Per grid node the colliders give a (d, d)
projection P_i and a target velocity v_bc_i; the implicit solver applies
P_i in its ``project`` callback every CG iteration.

Velocity convention at constrained nodes: v_i = v_bc_i + P_i (v_i - v_bc_i)
  * sticky:   P = 0          v = v_obj
  * slip:     P = I - n n^T  normal component pinned to the object's
  * separate: slip only while approaching (evaluated at pre-solve v)
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import torch

STICKY = "sticky"
SLIP = "slip"
SEPARATE = "separate"


def _t(value, like):
    return torch.as_tensor(value, dtype=like.dtype, device=like.device)


def _unit(v):
    return v / torch.clamp(torch.linalg.norm(v), min=1e-12)


@dataclasses.dataclass(frozen=True)
class Collider:
    """Base: subclasses implement phi/normal. ``motion(t)`` returns
    (linear velocity, angular velocity, center) of a scripted rigid motion;
    None is a static object."""

    kind: str = STICKY
    motion: Optional[Callable] = None
    friction: float = 0.0      # Coulomb coefficient for slip/separate

    def phi(self, x, t):       # (n, d) -> (n,), < 0 inside
        raise NotImplementedError

    def normal(self, x, t):    # (n, d) -> (n, d), outward
        raise NotImplementedError

    def velocity(self, x, t):
        """The object's material velocity at points x: v_lin + omega x r."""
        if self.motion is None:
            return torch.zeros_like(x)
        v_lin, omega, center = self.motion(t)
        rel = x - _t(center, x)[None, :]
        w = _t(omega, x)
        if x.shape[-1] == 2:
            rot = w * torch.stack([-rel[:, 1], rel[:, 0]], dim=-1)
        else:
            rot = torch.linalg.cross(w.expand_as(rel), rel, dim=-1)
        return _t(v_lin, x)[None, :] + rot


@dataclasses.dataclass(frozen=True)
class HalfSpace(Collider):
    """phi(x) = n . (x - origin); contact where phi < 0."""

    origin: Tuple[float, ...] = (0.0, 0.0, 0.0)
    n: Tuple[float, ...] = (0.0, 1.0, 0.0)

    def phi(self, x, t):
        return (x - _t(self.origin, x)[None, :]) @ _unit(_t(self.n, x))

    def normal(self, x, t):
        return _unit(_t(self.n, x)).expand_as(x)


@dataclasses.dataclass(frozen=True)
class AxisBox(Collider):
    """Axis-aligned box; contact inside (clamps, pads). Normal: the axis of
    deepest penetration, toward the nearer face."""

    lo: Tuple[float, ...] = (0.0, 0.0, 0.0)
    hi: Tuple[float, ...] = (1.0, 1.0, 1.0)

    def _q(self, x):
        lo, hi = _t(self.lo, x), _t(self.hi, x)
        return lo, hi, torch.maximum(lo[None, :] - x, x - hi[None, :])

    def phi(self, x, t):
        _, _, q = self._q(x)
        outside = torch.linalg.norm(torch.clamp(q, min=0.0), dim=-1)
        inside = q.amax(-1)
        return torch.where(inside < 0, inside, outside)

    def normal(self, x, t):
        lo, hi, q = self._q(x)
        axis = torch.argmax(q, dim=-1)
        rows = torch.arange(x.shape[0], device=x.device)
        sign = torch.where((x - lo[None, :])[rows, axis] > (hi - lo)[axis] * 0.5, 1.0, -1.0)
        nrm = torch.zeros_like(x)
        nrm[rows, axis] = sign.to(x.dtype)
        return nrm


def grid_boundary_conditions(node_pos, t, colliders: Sequence[Collider], grid_v=None,
                             boundary_margin: int = 0, res=None, dx=None):
    """(proj (n_nodes, d, d), v_bc (n_nodes, d), constrained (n_nodes,)).

    Colliders apply in order; with boundary_margin > 0 the outermost
    `boundary_margin` node layers of the domain are stuck as well.
    """
    n, d = node_pos.shape
    eye = torch.eye(d, dtype=node_pos.dtype, device=node_pos.device)
    proj = eye.expand(n, d, d)
    v_bc = torch.zeros_like(node_pos)
    constrained = torch.zeros(n, dtype=torch.bool, device=node_pos.device)
    for c in colliders:
        active = c.phi(node_pos, t) < 0.0
        v_obj = c.velocity(node_pos, t)
        if c.kind == STICKY:
            P_c = torch.zeros((n, d, d), dtype=node_pos.dtype, device=node_pos.device)
        else:
            nrm = c.normal(node_pos, t)
            P_c = eye - nrm[:, :, None] * nrm[:, None, :]
            if c.kind == SEPARATE:
                if grid_v is None:
                    raise ValueError("separate contact needs grid_v")
                approaching = torch.sum((grid_v - v_obj) * nrm, dim=-1) < 0.0
                active = active & approaching
        proj = torch.where(active[:, None, None], P_c @ proj, proj)
        v_bc_new = v_obj + _apply(P_c, v_bc - v_obj)
        if c.kind != STICKY and c.friction > 0.0 and grid_v is not None:
            # Coulomb friction on the pre-solve velocity: scale the tangential
            # relative velocity by max(0, 1 - mu |vn| / |vt|); a node with
            # scale 0 is stuck
            rel_v = grid_v - v_obj
            vn = torch.sum(rel_v * nrm, dim=-1)
            vt = rel_v - vn[:, None] * nrm
            scale = torch.clamp(1.0 - c.friction * torch.clamp(-vn, min=0.0)
                                / torch.clamp(torch.linalg.norm(vt, dim=-1), min=1e-12), min=0.0)
            proj = torch.where((active & (scale <= 0.0))[:, None, None],
                               torch.zeros_like(proj), proj)
            v_bc_new = v_obj + vt * scale[:, None]
        v_bc = torch.where(active[:, None], v_bc_new, v_bc)
        constrained = constrained | active
    if boundary_margin > 0:
        lo = boundary_margin * dx
        hi = (torch.tensor(res, dtype=node_pos.dtype, device=node_pos.device)
              - 1 - boundary_margin) * dx
        wall = torch.any((node_pos < lo) | (node_pos > hi[None, :]), dim=-1)
        proj = torch.where(wall[:, None, None], torch.zeros_like(proj), proj)
        v_bc = torch.where(wall[:, None], torch.zeros_like(v_bc), v_bc)
        constrained = constrained | wall
    return proj, v_bc, constrained


def _apply(P, v):
    return torch.einsum("nij,nj->ni", P, v)


def apply_bc_to_velocity(grid_v, proj, v_bc):
    """v <- v_bc + P (v - v_bc)."""
    return v_bc + _apply(proj, grid_v - v_bc)
