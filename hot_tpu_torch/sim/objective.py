"""The backward-Euler incremental-potential objective on grid velocities.

Counterpart of ``hot_tpu.sim.objective``: E(v) = 1/2 |v - v*|_M^2 +
Phi(x + dt v) with the residual, Hessian apply, preconditioners, projection
and characteristic norm the Newton/CG layer needs. The per-particle work of
the two hot calls goes through the fused kernels:

  * ``linearize`` (once per Newton iteration) -> ``ops.fused_linearize``;
  * ``multiply`` (once per CG iteration)      -> ``ops.fused_apply``.

Both dispatch on the tensors' device (plain PyTorch on the CPU, the CUDA
kernel on the card). The kernels compute the particles' stencil (quadratic
or cubic, ``ObjectiveContext.kernel``) from their positions; positions and
deformation gradients are kept in the kernels' structure-of-arrays layout
(particle index last), built once per step in ``make_objective``.

Unknowns are (n_nodes, d) over the flattened dense grid, or over the
compact nodes of the sparse tile grid (``ObjectiveContext.tgrid``; every
per-node array, from the mass to the block-Jacobi blocks, is then
n_cnodes long); inactive nodes (zero mass) act as the identity so CG leaves
them alone.

A batch of B members (hot_tpu's ``jax.vmap`` over the step, on either
grid; on the tile grid each member's compact nodes are its own) puts a
leading member dimension on every per-particle and per-node array (x_soa
(B, d, n), grid_m (B, n_nodes), ...); each kernel call takes the whole
batch, and every reduction (``cn_norm``, ``energy``) is per member.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from hot_tpu_torch.models import constitutive as cm
from hot_tpu_torch.ops import transfer
from hot_tpu_torch.ops.fused_apply import aos_mat, fused_apply, soa
from hot_tpu_torch.ops.fused_linearize import fused_linearize
from hot_tpu_torch.ops.svd import eigh_sym


class ObjectiveContext(NamedTuple):
    """Everything fixed during one implicit solve (one time step); a
    batch's arrays carry a leading member dimension."""

    stencil: transfer.Stencil
    F_n: torch.Tensor        # (n, d, d) deformation gradients at step start
    V0: torch.Tensor         # (n,)
    mu: torch.Tensor         # (n,)
    lam: torch.Tensor        # (n,)
    grid_m: torch.Tensor     # (n_nodes,)
    v_star: torch.Tensor     # (n_nodes, d) predictor velocity (with gravity)
    active: torch.Tensor     # (n_nodes,) bool, nodes with mass
    proj: torch.Tensor       # (n_nodes, d, d) BC projection matrices
    dt: float
    cn_scale: torch.Tensor   # (n_nodes,) characteristic impulse per node
    x_soa: torch.Tensor      # (d, n) particle positions
    F_soa: torch.Tensor      # (d*d, n)
    dx: float
    res: tuple               # grid size per axis
    kernel: str              # transfer kernel family: quadratic | cubic
    tgrid: object = None     # grid.sparse.TileGrid of compact nodes, None = dense


class HessianState(NamedTuple):
    """Per-particle linearization cache in the kernels' SoA layout."""

    U: torch.Tensor        # (d*d, n)
    V: torch.Tensor        # (d*d, n)
    A: torch.Tensor        # (d*d, n)
    b_plus: torch.Tensor   # (n_pairs, n)
    b_minus: torch.Tensor  # (n_pairs, n)

    def context(self, d: int) -> cm.HessianContext:
        """Particle-major (n, d, d) views ((B, n, d, d) for a batch)."""
        return cm.HessianContext(U=aos_mat(self.U, d), V=aos_mat(self.V, d),
                                 A=aos_mat(self.A, d), b_plus=self.b_plus.transpose(-1, -2),
                                 b_minus=self.b_minus.transpose(-1, -2))


def make_objective(model, stencil, F_n, V0, mu, lam, grid_m, v_star, proj,
                   dt: float, dx: float, x, res, kernel: str = "quadratic",
                   tgrid=None) -> ObjectiveContext:
    """Build the ObjectiveContext for the particles at x (n, d), whose
    stencil of the kernel family on the grid (dx, res) is `stencil`, with
    the characteristic-norm scale:
      force scale   f_i = sum_p w_ip V0_p (2 mu_p + lam_p) / dx
      impulse scale s_i = max(dt f_i, m_i dx / dt)
    (the second term keeps free-fall nodes, with no stiffness, scaled).
    With `tgrid` the stencil's node ids are that tile grid's compact ids; x
    (B, n, d) makes a batch's context."""
    active = grid_m > 0
    n_nodes = grid_m.shape[-1]
    stiff = V0 * (2.0 * mu + lam) / dx
    f_char = transfer.scatter_sum(stencil.node_ids, stencil.wn * stiff[..., None], n_nodes)
    cn_scale = torch.maximum(dt * f_char, grid_m * dx / dt)
    cn_scale = torch.where(active, cn_scale, torch.ones_like(cn_scale))
    return ObjectiveContext(
        stencil=stencil, F_n=F_n, V0=V0, mu=mu, lam=lam, grid_m=grid_m,
        v_star=v_star, active=active, proj=proj, dt=dt, cn_scale=cn_scale,
        x_soa=soa(x, x.ndim - 2), F_soa=soa(F_n, x.ndim - 2), dx=dx, res=tuple(res),
        kernel=kernel, tgrid=tgrid,
    )


def member_sum(t, dims: int):
    """The sum of t's trailing `dims` dimensions: a scalar for one state, (B,)
    for a batch (a leading member dimension more)."""
    return torch.sum(t) if t.ndim == dims else torch.sum(t, dim=tuple(range(-dims, 0)))


def updated_F(obj: ObjectiveContext, v):
    """F_p(v) = (I + dt grad_v_p) F_n_p."""
    grad_v = transfer.velocity_gradient(obj.stencil, v)
    eye = torch.eye(v.shape[-1], dtype=v.dtype, device=v.device)
    return (eye + obj.dt * grad_v) @ obj.F_n


def residual(model, obj: ObjectiveContext, v):
    """r(v) = M (v - v*) - dt f(v), BC-projected, zero at inactive nodes."""
    P = cm.first_piola(model, updated_F(obj, v), obj.mu, obj.lam)
    f = transfer.scatter_force(obj.stencil, P @ obj.F_n.transpose(-1, -2), obj.V0,
                               obj.grid_m.shape[-1])
    return project(obj, obj.grid_m[..., None] * (v - obj.v_star) - obj.dt * f)


def energy(model, obj: ObjectiveContext, v):
    """E(v), per member for a batch."""
    psi = cm.psi_from_F(model, updated_F(obj, v), obj.mu, obj.lam)
    dv = v - obj.v_star
    return 0.5 * member_sum(obj.grid_m[..., None] * dv * dv, 2) + member_sum(obj.V0 * psi, 1)


def build_hessian(model, obj: ObjectiveContext, v, project_spd: bool = True) -> HessianState:
    """The per-particle Hessian context at v, without the residual."""
    ctx = cm.hessian_context(model, updated_F(obj, v), obj.mu, obj.lam, project=project_spd)
    return HessianState(*(soa(t, v.ndim - 2) for t in ctx))


def linearize(model, obj: ObjectiveContext, v, project_spd: bool = True):
    """(residual, HessianState) at v with one SVD per particle: the
    per-Newton-iteration evaluation, through ``ops.fused_linearize``."""
    f, U, V, A, bp, bm = fused_linearize(
        v, obj.x_soa, obj.dx, obj.res, obj.F_soa, obj.mu, obj.lam, obj.V0, obj.dt, model,
        project=project_spd, kernel=obj.kernel, tgrid=obj.tgrid)
    r = obj.grid_m[..., None] * (v - obj.v_star) - obj.dt * f
    return project(obj, r), HessianState(U=U, V=V, A=A, b_plus=bp, b_minus=bm)


def elastic_hessian_apply(x_soa, dx: float, res, F_soa, hess: HessianState, V0,
                          dt: float, grid_m, active, w, kernel: str = "quadratic", tgrid=None):
    """Matrix-free (M + dt^2 K) w through ``ops.fused_apply``; the identity
    on inactive nodes. The grid (dx, res) may be any multigrid level's, with
    that level's mass and mask (and tile grid, for compact nodes)."""
    df = fused_apply(w, x_soa, dx, res, F_soa, hess.U, hess.V, hess.A, hess.b_plus,
                     hess.b_minus, V0, dt, kernel, tgrid)
    out = grid_m[..., None] * w - dt * df
    return torch.where(active[..., None], out, w)


def multiply(obj: ObjectiveContext, hess: HessianState, w):
    """H w at the finest level."""
    return elastic_hessian_apply(obj.x_soa, obj.dx, obj.res, obj.F_soa, hess, obj.V0, obj.dt,
                                 obj.grid_m, obj.active, w, obj.kernel, obj.tgrid)


# particles per block-diagonal chunk: bounds each (chunk, s, d, d)
# temporary at 2^24 values (unchunked, one is 6.2 GB in fp64 at 256^3)
_BLOCK_DIAG_BUDGET = 2 ** 24


def elastic_block_diag(stencil, F_n, ctx: cm.HessianContext, V0, dt: float,
                       grid_m, active, dim: int):
    """Per-node (d, d) diagonal blocks of M + dt^2 K (HOT's --Ainv).

    The SPD-projected diagonal-space dP/dF is exactly d + 2 n_pairs rank-1
    modes, so particle p's block at its stencil node k is
      B_k = dt^2 V0 sum_m lam_m z_m(k) z_m(k)^T,
    with y_k = V^T F^T gw_k and
      z_m = U (Q e_m o y_k)            lam_m = eig_m(A)   (normal modes)
      z   = (U_i y_j +- U_j y_i)/sqrt2  lam = b-/b+       (pair modes).
    Computed and scattered in chunks of particles; a batch's members are
    one particle set over their stacked grids (the stencil's member offsets).
    """
    d = dim
    lead, n_nodes = grid_m.shape[:-1], grid_m.shape[-1]
    if lead:
        stencil = transfer.Stencil(*(t.flatten(0, 1) for t in stencil))
        F_n, V0 = F_n.flatten(0, 1), V0.flatten(0, 1)
        ctx = cm.HessianContext(*(t.flatten(0, 1) for t in ctx))
    n, s = stencil.wn.shape
    K = torch.zeros((math.prod(lead) * n_nodes, d * d), dtype=F_n.dtype, device=F_n.device)
    chunk = max(1, _BLOCK_DIAG_BUDGET // (s * d * d))
    inv_sqrt2 = 0.7071067811865476
    for lo in range(0, n, chunk):
        sl = slice(lo, min(n, lo + chunk))
        U, V, A, b_plus, b_minus = (t[sl] for t in ctx)
        g = torch.einsum("pkb,pba->pka", stencil.gwn[sl], F_n[sl])   # F^T gw_k
        y = torch.einsum("pka,pac->pkc", g, V)
        w_eig, Q = eigh_sym(A)
        lam_scale = (dt * dt) * V0[sl]
        z = torch.einsum("pec,pcm,pkc->pkme", U, Q, y)              # (c, s, d, d)
        B = torch.einsum("pm,pkma,pkmb->pkab", lam_scale[:, None] * w_eig, z, z)
        for k_p, (i, j) in enumerate(cm._pairs(d)):
            Ui, Uj = U[:, None, :, i], U[:, None, :, j]              # (c, 1, d)
            yi, yj = y[:, :, i, None], y[:, :, j, None]              # (c, s, 1)
            for b, sign in ((b_minus[:, k_p], 1.0), (b_plus[:, k_p], -1.0)):
                zm = (Ui * yj + sign * Uj * yi) * inv_sqrt2
                B = B + (lam_scale * b)[:, None, None, None] * zm[..., :, None] * zm[..., None, :]
        K.index_add_(0, stencil.node_ids[sl].reshape(-1), B.reshape(-1, d * d))
    eye = torch.eye(d, dtype=K.dtype, device=K.device)
    D = grid_m[..., None, None] * eye + K.reshape(lead + (n_nodes, d, d))
    return torch.where(active[..., None, None], D, eye)


def sym_block_inv(D):
    """Analytic inverse of symmetric (n, d, d) blocks, d in {2, 3}, reading
    the upper triangle. Scaled by the largest diagonal entry first: a
    tiny-mass block m I has det = m^d, which underflows in fp32 for
    m ~ 1e-30 and would turn the whole solve non-finite."""
    d = D.shape[-1]
    diag = torch.diagonal(D, dim1=-2, dim2=-1)
    s = torch.clamp(diag.abs().amax(-1), min=1e-30)
    D = D / s[..., None, None]
    if d == 2:
        a, b, c = D[..., 0, 0], D[..., 0, 1], D[..., 1, 1]
        inv_det = 1.0 / ((a * c - b * b) * s)
        return torch.stack([torch.stack([c, -b], -1), torch.stack([-b, a], -1)], -2) \
            * inv_det[..., None, None]
    if d != 3:
        raise ValueError(f"sym_block_inv supports d in (2, 3); got {d}")
    a, b, c = D[..., 0, 0], D[..., 0, 1], D[..., 0, 2]
    e, f = D[..., 1, 1], D[..., 1, 2]
    g = D[..., 2, 2]
    A00 = e * g - f * f
    A01 = c * f - b * g
    A02 = b * f - c * e
    A11 = a * g - c * c
    A12 = b * c - a * f
    A22 = a * e - b * b
    inv_det = 1.0 / ((a * A00 + b * A01 + c * A02) * s)
    rows = [torch.stack(r, -1) for r in ((A00, A01, A02), (A01, A11, A12), (A02, A12, A22))]
    return torch.stack(rows, -2) * inv_det[..., None, None]


def project(obj: ObjectiveContext, r):
    """BC projection and inactive-node mask."""
    r = torch.einsum("...ij,...j->...i", obj.proj, r)
    return torch.where(obj.active[..., None], r, torch.zeros_like(r))


def mass_precondition(obj: ObjectiveContext, r):
    """Inverse-mass (Jacobi on the inertia term) preconditioner."""
    inv_m = torch.where(obj.active, 1.0 / torch.clamp(obj.grid_m, min=1e-30),
                        torch.ones_like(obj.grid_m))
    return r * inv_m[..., None]


def cn_norm(obj: ObjectiveContext, r):
    """Characteristic norm: RMS of the nondimensionalised residual (per
    member for a batch)."""
    scaled = r / obj.cn_scale[..., None]
    n_active = torch.clamp(member_sum(obj.active, 1), min=1)
    return torch.sqrt(member_sum(scaled * scaled, 2) / n_active.to(r.dtype))
