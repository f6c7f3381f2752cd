"""HOT's multigrid on the slab decomposition: slab levels with their halos,
partial operators per rank, and an agglomerated direct coarse solve.

Counterpart of ``hot_tpu.parallel.sharded_mg``, on the operators, smoothers
and SpGEMM of the one-grid port (``solver.multigrid``, ``ops.bsr``,
``ops.spgemm``). Level l is sliced as the finest grid is (``Slab``): rank r
owns planes [r P_l, (r + 1) P_l) of the level and keeps ghost planes on its
extended slab, HALO = 2 wide, 3 on the coarse levels of Galerkin
coarsening (the embedding of a 2-plane halo row reaches one plane further,
and 3 is the fixed point). Every level vector lives on the owned nodes; a
level operator exchanges the ghosts in and folds the partial sums out:

  * matrix-free: ``parallel.sharded.slab_apply``, the rank's particles
    over the level's extended slab (shifted into its frame);
  * assembled: the rank's partial operator A_r over its extended slab,
    applied by ``ops.bsr_spmv``. A = sum_r A_r by quadrature additivity:
    quadrature levels assemble the elastic part from the rank's particles
    and add the (owned, folded) mass outside; Galerkin coarsening puts the
    rank's unfolded mass into the level-0 partial and takes each coarse
    partial as P^T A_r P (``ops.spgemm.rap`` with the slabs' origins).

The rows of an assembled partial are the level's active nodes of the
extended slab (the nodes the rank's particles touch, on a quadrature
level), as the one-grid hierarchy's rows are its active nodes. The
smoothers' lambda_max and the coarse CG reduce over the ranks. The direct
coarse solve is agglomerated: each rank densifies its partial coarsest
operator at the global active rows, the ranks sum it, and every rank
factors it and solves the gathered right-hand side. The level slabs must
stay at least a halo thick (``build_static`` raises otherwise: use fewer
levels).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from hot_tpu_torch.ops import bsr as bsr_mod
from hot_tpu_torch.ops import spgemm, transfer
from hot_tpu_torch.ops.fused_apply import soa
from hot_tpu_torch.parallel import halo as halo_mod
from hot_tpu_torch.parallel.mesh import Mesh
from hot_tpu_torch.parallel.sharded import (HALO, Slab, block_diag, exchange, fold, make_slab,
                                            slab_apply)
from hot_tpu_torch.sim import objective as obj_mod
from hot_tpu_torch.solver import multigrid as mg_mod
from hot_tpu_torch.solver.cg import cg_solve
from hot_tpu_torch.utils.config import MultigridConfig

GALERKIN_HALO = 3


def check_multigrid(mgc: MultigridConfig):
    """Refuse the multigrid settings hot_tpu's sharded hierarchy does not run."""
    refused = [
        (mgc.smoother not in ("chebyshev", "jacobi"), f"smoother={mgc.smoother!r}"),
        (mgc.coarse_solver not in ("direct", "cg", "smoother"),
         f"coarse_solver={mgc.coarse_solver!r}"),
        (mgc.assembled and mgc.assembled_from_level != 0,
         f"assembled_from_level={mgc.assembled_from_level}"),
        (mgc.assembled and mgc.rap_refresh != "newton", f"rap_refresh={mgc.rap_refresh!r}"),
        (mgc.rap_max_half is not None, f"rap_max_half={mgc.rap_max_half}"),
    ]
    for bad, what in refused:
        if bad:
            raise NotImplementedError(f"the sharded multigrid does not run multigrid.{what}")


@dataclasses.dataclass
class SLevel:
    slab: Slab
    dx: float
    stencil: transfer.Stencil     # the rank's particles on the extended slab
    x_soa: torch.Tensor           # (d, n) positions in the extended slab's frame
    grid_m: torch.Tensor          # (n_owned,)
    active: torch.Tensor
    free: torch.Tensor
    rows: Optional[torch.Tensor] = None       # (n_ext,) bool: rows of the partial operator
    ext_mass: Optional[torch.Tensor] = None   # unfolded mass (Galerkin level 0)


class SMGStatic(NamedTuple):
    levels: Tuple[SLevel, ...]
    embeds: Tuple[transfer.Stencil, ...]   # owned level-l nodes -> level-(l+1) extended ids
    assembled: bool
    galerkin: bool


class SMGPrecond(NamedTuple):
    diag_inv: Tuple[torch.Tensor, ...]
    lmax: Tuple[torch.Tensor, ...]
    hess: obj_mod.HessianState
    F_soa: torch.Tensor
    V0: torch.Tensor
    mats: Tuple[Optional[bsr_mod.BsrMatrix], ...]
    coarse: object = None                  # (Cholesky factor, global row nodes)


def _embedding(fine: Slab, coarse: Slab, device):
    """The owned fine nodes' quadratic embedding in the coarse level, from
    their integer coords (``ops.spgemm.embedding_weights``): node ids on the
    coarse extended slab, clamped to the grid."""
    coords = transfer.unravel(torch.arange(fine.n_owned, device=device),
                              (fine.planes,) + tuple(fine.res[1:]))
    coords[:, 0] += fine.rank * fine.planes
    base, w = spgemm.embedding_weights(coords, torch.float64)
    offs = transfer.stencil_offsets(len(fine.res), 3, device=device)
    hi = torch.tensor(coarse.res, dtype=torch.long, device=device) - 1
    c = torch.minimum((base[:, None, :] + offs).clamp(min=0), hi)
    c[..., 0] -= coarse.org
    ids = (c * transfer._row_major_strides(coarse.ext_res, device)).sum(-1)
    return ids, w


def build_static(x, m, res, dx: float, mgc: MultigridConfig, constrained, mesh: Mesh,
                 dtype) -> SMGStatic:
    """The hierarchy of this rank's particles (x, m) for one step;
    constrained is the owned finest nodes' Dirichlet mask."""
    assembled = mgc.assembled
    galerkin = assembled and mgc.coarsening == "galerkin"
    levels, embeds = [], []
    cur_res, cur_dx, cons = tuple(res), dx, constrained
    for l in range(mgc.levels):
        slab = make_slab(cur_res, mesh.size, mesh.rank,
                         GALERKIN_HALO if galerkin and l > 0 else HALO)
        x_l = slab.local_x(x, cur_dx)
        st = transfer.particle_stencil(x_l, cur_dx, slab.ext_res)
        ext_mass = transfer.scatter_sum(st.node_ids, st.wn * m[:, None], slab.n_ext)
        grid_m = fold(slab, mesh, ext_mass)
        active = grid_m > 0
        rows = None
        if assembled:
            # quadrature partial: the nodes the rank's particles touch; a
            # Galerkin coarse partial: the level's active nodes of the slab
            rows = (ext_mass > 0 if not (galerkin and l > 0)
                    else exchange(slab, mesh, active.to(dtype)) > 0)
        levels.append(SLevel(slab=slab, dx=cur_dx, stencil=st, x_soa=soa(x_l), grid_m=grid_m,
                             active=active, free=active & ~cons, rows=rows,
                             ext_mass=ext_mass if galerkin and l == 0 else None))
        if l == mgc.levels - 1:
            break
        nxt_res, nxt_dx = mg_mod.coarse_res(cur_res), cur_dx * 2.0
        nxt = make_slab(nxt_res, mesh.size, mesh.rank, GALERKIN_HALO if galerkin else HALO)
        ids, w = _embedding(slab, nxt, x.device)
        embed = transfer.Stencil(node_ids=ids, wn=w.to(dtype), gwn=None, rel=None)
        embeds.append(embed)
        w_total = fold(nxt, mesh, transfer.scatter_sum(ids, embed.wn, nxt.n_ext))
        w_cons = fold(nxt, mesh, transfer.scatter_sum(ids, embed.wn * cons[:, None].to(dtype),
                                                      nxt.n_ext))
        cons = w_cons > 0.25 * torch.clamp(w_total, min=1e-30)
        cur_res, cur_dx = nxt_res, nxt_dx
    return SMGStatic(levels=tuple(levels), embeds=tuple(embeds), assembled=assembled,
                     galerkin=galerkin)


# ---------------------------------------------------------------------------
# level operators on owned vectors
# ---------------------------------------------------------------------------


def level_mul(hier: SMGStatic, pre: SMGPrecond, l: int, dt: float, mesh: Mesh):
    level = hier.levels[l]
    slab, mat = level.slab, pre.mats[l]

    if mat is None:
        return lambda w: slab_apply(slab, mesh, level.x_soa, level.dx, pre.F_soa, pre.hess,
                                    pre.V0, dt, level.grid_m, level.active, w)

    def mul(w):
        rows = bsr_mod.spmv(mat, bsr_mod.grid_vector_to_rows(mat, exchange(slab, mesh, w)))
        y = fold(slab, mesh, bsr_mod.rows_to_grid_vector(mat, rows, slab.n_ext))
        if not hier.galerkin:
            y = y + level.grid_m[:, None] * w
        return torch.where(level.active[:, None], y, w)
    return mul


def level_project(level: SLevel, r):
    return torch.where(level.free[:, None], r, torch.zeros_like(r))


def _norm(v, mesh: Mesh):
    return torch.sqrt(halo_mod.all_reduce_sum(torch.sum(v * v), mesh))


def _power_lmax(mul, level: SLevel, Dinv, iters: int, mesh: Mesh):
    """lambda_max(D^-1 A) on the free subspace, the norms summed over the
    ranks (solver.multigrid._power_iteration_lmax)."""
    d = Dinv.shape[-1]
    v = level.free[:, None].to(Dinv.dtype).expand(-1, d)
    v = v / torch.clamp(_norm(v, mesh), min=1e-30)
    lam = torch.ones((), dtype=Dinv.dtype, device=Dinv.device)
    for _ in range(iters):
        Av = level_project(level, mg_mod._bapply(Dinv, mul(level_project(level, v))))
        lam = _norm(Av, mesh) / torch.clamp(_norm(v, mesh), min=1e-30)
        v = Av / torch.clamp(_norm(Av, mesh), min=1e-30)
    return torch.clamp(lam, min=1e-12)


def _assembled_diag(level: SLevel, mat, galerkin: bool, mesh: Mesh, dim: int):
    """Owned (d, d) diagonal blocks: the partial centre blocks folded, the
    mass added unless the partial holds it; the identity off the free nodes."""
    slab = level.slab
    centre = bsr_mod.block_diag(mat).reshape(-1, dim * dim)
    D = fold(slab, mesh, bsr_mod.rows_to_grid_vector(mat, centre, slab.n_ext))
    D = D.reshape(-1, dim, dim)
    eye = torch.eye(dim, dtype=D.dtype, device=D.device)
    if not galerkin:
        D = D + level.grid_m[:, None, None] * eye
    return torch.where(level.free[:, None, None], D, eye)


def build_precond(hier: SMGStatic, F_n, hess: obj_mod.HessianState, V0, dt: float,
                  mgc: MultigridConfig, dim: int, mesh: Mesh) -> SMGPrecond:
    """Per-Newton-iteration data: each level's partial operator (assembled),
    block-diagonal inverse and lambda_max, and the coarse factor."""
    ctx = hess.context(dim)
    pre = SMGPrecond(diag_inv=(), lmax=(), hess=hess, F_soa=soa(F_n), V0=V0, mats=())
    mats, diag_inv, lmax = [], [], []
    n_levels = len(hier.levels)
    for l, level in enumerate(hier.levels):
        slab = level.slab
        mat = None
        if hier.assembled:
            if hier.galerkin and l > 0:
                prev = hier.levels[l - 1]
                mat = spgemm.rap(mats[-1], slab.ext_res, level.rows,
                                 fine_origin=prev.slab.org, coarse_origin=slab.org)
            else:
                mat = bsr_mod.structure(level.rows, slab.ext_res, dtype=F_n.dtype)
                mass = level.ext_mass if hier.galerkin else torch.zeros(
                    slab.n_ext, dtype=F_n.dtype, device=F_n.device)
                mat = bsr_mod.assemble_hessian(mat, level.stencil, F_n, ctx, V0, dt, mass)
            D = _assembled_diag(level, mat, hier.galerkin, mesh, dim)
        else:
            D = block_diag(slab, mesh, level.stencil, F_n, ctx, V0, dt, level.grid_m,
                            level.active, dim)
            D = mg_mod._floor_fp32_diag(D)
        mats.append(mat)
        Dinv = obj_mod.sym_block_inv(D)
        diag_inv.append(Dinv)
        pre = pre._replace(mats=tuple(mats))
        if mgc.smoother == "chebyshev" and (l < n_levels - 1 or mgc.coarse_solver == "smoother"):
            lam = _power_lmax(level_mul(hier, pre, l, dt, mesh), level, Dinv, mgc.power_iters,
                              mesh)
        else:
            lam = torch.ones((), dtype=F_n.dtype, device=F_n.device)
        lmax.append(lam)
    pre = pre._replace(diag_inv=tuple(diag_inv), lmax=tuple(lmax))
    if mgc.coarse_solver == "direct":
        pre = pre._replace(coarse=_coarse_factor(hier, pre, dt, dim, mesh))
    return pre


# ---------------------------------------------------------------------------
# the agglomerated coarse solve
# ---------------------------------------------------------------------------


def _global_ids(slab: Slab, local_ids):
    """Global flat ids of extended-slab node ids."""
    c = transfer.unravel(local_ids, slab.ext_res)
    c[..., 0] += slab.org
    return (c * transfer._row_major_strides(slab.res, local_ids.device)).sum(-1)


def _coarse_factor(hier: SMGStatic, pre: SMGPrecond, dt: float, dim: int, mesh: Mesh):
    """Cholesky factor of the BC-projected coarsest operator over its global
    active nodes (solver.multigrid._dense_factor_from_mat): every rank's
    partial densified at global rows and summed, the mass added where the
    partial lacks it. A matrix-free coarsest level assembles its partial
    from the rank's particles first."""
    level = hier.levels[-1]
    slab = level.slab
    F_n = pre.F_soa.transpose(0, 1).reshape(-1, dim, dim)
    mat = pre.mats[-1]
    if mat is None:
        rows = transfer.scatter_sum(level.stencil.node_ids, level.stencil.wn, slab.n_ext) > 0
        mat = bsr_mod.assemble_hessian(
            bsr_mod.structure(rows, slab.ext_res, dtype=F_n.dtype), level.stencil, F_n,
            pre.hess.context(dim), pre.V0, dt, torch.zeros(slab.n_ext, dtype=F_n.dtype,
                                                           device=F_n.device))
    gm = halo_mod.all_gather(level.grid_m, mesh).reshape(-1)
    free = halo_mod.all_gather(level.free, mesh).reshape(-1)
    nodes = torch.nonzero(gm > 0).reshape(-1)
    n = nodes.shape[0]
    row_of = torch.full_like(gm, -1, dtype=torch.long)
    row_of[nodes] = torch.arange(n, device=gm.device)
    g_row = row_of[_global_ids(slab, mat.node_of)]
    cols = mat.col_row.long()
    g_col = torch.where(cols >= 0, row_of[_global_ids(slab, mat.node_of[cols.clamp(min=0)])], -1)
    ok = (cols >= 0) & (g_row >= 0)[:, None] & (g_col >= 0)
    r, k = torch.nonzero(ok, as_tuple=True)
    A = torch.zeros((n, n, dim, dim), dtype=mat.vals.dtype, device=mat.vals.device)
    A.index_put_((g_row[r], g_col[r, k]), mat.vals[r, k], accumulate=True)
    A = halo_mod.all_reduce_sum(A, mesh)
    eye = torch.eye(dim, dtype=A.dtype, device=A.device)
    if not hier.galerkin:
        idx = torch.arange(n, device=A.device)
        A[idx, idx] += gm[nodes][:, None, None] * eye
    fr = free[nodes]
    A = torch.where((fr[:, None] & fr[None, :])[:, :, None, None], A, torch.zeros_like(A))
    A = A.transpose(1, 2).reshape(n * dim, n * dim)
    A = A + torch.diag((~fr).repeat_interleave(dim).to(A.dtype))
    eps = 1e-8 * torch.clamp(torch.diagonal(A).amax(), min=1.0)
    A = A + eps * torch.eye(n * dim, dtype=A.dtype, device=A.device)
    return torch.linalg.cholesky(A), nodes


def _coarse_solve(level: SLevel, coarse, b, mesh: Mesh):
    L, nodes = coarse
    slab = level.slab
    d = b.shape[-1]
    b_all = halo_mod.all_gather(b, mesh).reshape(-1, d)
    x_rows = torch.cholesky_solve(b_all[nodes].reshape(-1, 1), L).reshape(-1, d)
    x_all = torch.zeros_like(b_all)
    x_all[nodes] = x_rows
    lo = slab.rank * slab.n_owned
    return x_all[lo:lo + slab.n_owned]


# ---------------------------------------------------------------------------
# V-cycle
# ---------------------------------------------------------------------------


def restrict(hier: SMGStatic, l: int, r, mesh: Mesh):
    embed, nxt = hier.embeds[l], hier.levels[l + 1].slab
    vals = embed.wn[..., None] * r[:, None, :]
    return fold(nxt, mesh, transfer.scatter_sum(embed.node_ids, vals, nxt.n_ext))


def prolong(hier: SMGStatic, l: int, e, mesh: Mesh):
    embed, nxt = hier.embeds[l], hier.levels[l + 1].slab
    return torch.sum(embed.wn[..., None] * transfer.gather(exchange(nxt, mesh, e),
                                                           embed.node_ids), dim=-2)


def _smooth(mul, level: SLevel, pre: SMGPrecond, l: int, mgc: MultigridConfig, b, x,
            iters: int):
    proj = lambda r: level_project(level, r)  # noqa: E731
    if mgc.smoother == "chebyshev":
        return mg_mod.chebyshev_smooth(mul, proj, pre.diag_inv[l], pre.lmax[l], b, x,
                                       max(iters * mgc.chebyshev_order, 1), mgc.chebyshev_lo,
                                       mgc.chebyshev_hi)
    return mg_mod.jacobi_smooth(mul, proj, pre.diag_inv[l], b, x, iters, mgc.jacobi_omega)


def v_cycle(hier: SMGStatic, pre: SMGPrecond, dt: float, mgc: MultigridConfig, b, mesh: Mesh,
            l: int = 0):
    level = hier.levels[l]
    mul = level_mul(hier, pre, l, dt, mesh)
    x = torch.zeros_like(b)
    if l == len(hier.levels) - 1:
        if mgc.coarse_solver == "direct":
            return level_project(level, _coarse_solve(level, pre.coarse, b, mesh))
        if mgc.coarse_solver == "cg":
            Dinv = pre.diag_inv[l]
            return cg_solve(lambda w: level_project(level, mul(w)), b,
                            precondition=lambda r: mg_mod._bapply(Dinv, r),
                            project=lambda r: level_project(level, r), tol=1e-2,
                            max_iters=mgc.coarse_iters,
                            reduce=lambda s: halo_mod.all_reduce_sum(s, mesh)).x
        return _smooth(mul, level, pre, l, mgc, b, x, mgc.coarse_iters)
    x = _smooth(mul, level, pre, l, mgc, b, x, mgc.pre_smooth)
    r = level_project(level, b - mul(x))
    r_c = level_project(hier.levels[l + 1], restrict(hier, l, r, mesh))
    e_c = v_cycle(hier, pre, dt, mgc, r_c, mesh, l + 1)
    x = x + level_project(level, prolong(hier, l, e_c, mesh))
    return _smooth(mul, level, pre, l, mgc, b, x, mgc.post_smooth)


def mg_precondition(hier: SMGStatic, pre: SMGPrecond, dt: float, mgc: MultigridConfig, r,
                    mesh: Mesh):
    z = v_cycle(hier, pre, dt, mgc, r, mesh)
    for _ in range(mgc.cycles - 1):
        res = r - level_mul(hier, pre, 0, dt, mesh)(z)
        z = z + v_cycle(hier, pre, dt, mgc, level_project(hier.levels[0], res), mesh)
    return z
