"""HOT's node-embedding geometric multigrid on the dense grid.

Counterpart of ``hot_tpu.solver.multigrid`` (dense levels). Coarse level L
has spacing 2^L dx; fine nodes embed in the coarse grid's quadratic
B-spline stencils (prolongation = interpolation weights, restriction = its
transpose). A level's operator is one of:

  * matrix-free: the particle-quadrature Hessian apply at the level's
    spacing, through ``ops.fused_apply`` on the card (``MGLevel.mat_sym`` is
    None);
  * assembled: an explicit BSR operator (``ops.bsr``), from particle
    quadrature on the first assembled level and, with
    ``coarsening="galerkin"``, P^T A P (``ops.spgemm.rap``) below it. Its
    smoothers, residuals and power iteration run through ``ops.bsr_spmv``.

Smoothers: Chebyshev over a power-iteration lambda_max, damped Jacobi, or
symmetric parity-colored Gauss-Seidel; coarsest solve by Cholesky
("direct"), CG or the smoother. One V-cycle per PCG application.

The hierarchy splits in two:
  MGStatic  - per time step: stencils, masses, activity, BC per level;
  MGPrecond - per Newton iteration: operators, block-diagonal inverses,
              Chebyshev bounds and the coarse factor.

Every assembled level uses the compressed-row layout of ``ops.bsr``, sized
to its active nodes; ``hot_tpu``'s tile-row level 0 and its capacities were
for the TPU's static shapes. Not ported (they raise NotImplementedError):
the composed Galerkin first level (``assembled_from_level > 0`` with
``coarsening="galerkin"``), compact sparse-grid levels and the phased build.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from hot_tpu_torch.ops import bsr as bsr_mod
from hot_tpu_torch.ops import spgemm
from hot_tpu_torch.ops import transfer
from hot_tpu_torch.ops.fused_apply import soa
from hot_tpu_torch.sim import objective as obj_mod
from hot_tpu_torch.solver.cg import cg_solve
from hot_tpu_torch.utils.config import MultigridConfig


@dataclasses.dataclass
class MGLevel:
    stencil: transfer.Stencil   # particle stencil at this level's spacing
    grid_m: torch.Tensor        # (n_nodes_l,) node mass
    active: torch.Tensor        # (n_nodes_l,) bool
    free: torch.Tensor          # (n_nodes_l,) bool, active and unconstrained
    dx: float
    res: Tuple[int, ...]
    # assembled levels: the symbolic BSR structure; None = matrix-free
    mat_sym: Optional[bsr_mod.BsrMatrix] = None
    # matrix-free levels: the particle positions (d, n) SoA, from which the
    # fused apply builds the stencil at this level's dx and res
    x_soa: Optional[torch.Tensor] = None


class MGStatic(NamedTuple):
    levels: Tuple[MGLevel, ...]
    # embeds[l]: level-l nodes embedded in the level-(l+1) grid (node_ids, wn)
    embeds: Tuple[transfer.Stencil, ...]


class MGPrecond(NamedTuple):
    diag_inv: Tuple[torch.Tensor, ...]  # per level (n_l, d, d), row order when assembled
    lmax: Tuple[torch.Tensor, ...]      # per level: scalar spectral bound
    hess: obj_mod.HessianState          # per-particle dPdF context, shared by levels
    F_soa: torch.Tensor                 # (d*d, n) step-start F, SoA
    V0: torch.Tensor
    coarse_chol: object = None          # (Cholesky factor, coarsest BSR) for "direct"
    mats: Tuple[Optional[bsr_mod.BsrMatrix], ...] = ()   # None: matrix-free level


def coarse_res(res: Tuple[int, ...]) -> Tuple[int, ...]:
    return tuple((r + 1) // 2 for r in res)


def build_static(x, m, res, dx: float, n_levels: int, constrained, dtype,
                 assembled_from: Optional[int] = None) -> MGStatic:
    """Per-step hierarchy topology, mass and BC.

    constrained: (n_nodes_0,) bool fine-level Dirichlet/contact nodes. A
    coarse node is constrained when more than 25% of its restriction weight
    comes from constrained fine nodes. assembled_from: index of the first
    assembled level (None: all levels matrix-free)."""
    device = x.device
    levels, embeds = [], []
    cur_res, cur_dx, cons = tuple(res), dx, constrained
    x_soa = soa(x)
    for l in range(n_levels):
        st = transfer.particle_stencil(x, cur_dx, cur_res)
        n_nodes = transfer.n_nodes_of(cur_res)
        grid_m = transfer.scatter_sum(st.node_ids, st.wn * m[:, None], n_nodes)
        active = grid_m > 0
        assembled = assembled_from is not None and l >= assembled_from
        levels.append(MGLevel(
            stencil=st, grid_m=grid_m, active=active, free=active & ~cons,
            dx=cur_dx, res=cur_res,
            mat_sym=bsr_mod.structure(active, cur_res, dtype=dtype) if assembled else None,
            x_soa=None if assembled else x_soa))
        if l == n_levels - 1:
            break
        nxt_res, nxt_dx = coarse_res(cur_res), cur_dx * 2.0
        node_pos = transfer.node_positions(cur_res, cur_dx, dtype, device)
        embed = transfer.particle_stencil(node_pos, nxt_dx, nxt_res)
        # restriction and prolongation read only node_ids and wn
        embeds.append(transfer.Stencil(node_ids=embed.node_ids, wn=embed.wn, gwn=None, rel=None))
        n_coarse = transfer.n_nodes_of(nxt_res)
        w_total = transfer.scatter_sum(embed.node_ids, embed.wn, n_coarse)
        w_cons = transfer.scatter_sum(embed.node_ids, embed.wn * cons[:, None].to(dtype),
                                      n_coarse)
        cons = w_cons > 0.25 * torch.clamp(w_total, min=1e-30)
        cur_res, cur_dx = nxt_res, nxt_dx
    return MGStatic(levels=tuple(levels), embeds=tuple(embeds))


# ---------------------------------------------------------------------------
# level operators
# ---------------------------------------------------------------------------


def level_multiply(level: MGLevel, pre: MGPrecond, dt: float, w):
    """Matrix-free A_l w through ``ops.fused_apply``; identity on inactive nodes."""
    return obj_mod.elastic_hessian_apply(level.x_soa, level.dx, level.res, pre.F_soa, pre.hess,
                                         pre.V0, dt, level.grid_m, level.active, w)


def level_project(level: MGLevel, r):
    return torch.where(level.free[:, None], r, torch.zeros_like(r))


def _free_rows_of(level: MGLevel, mat):
    """Free mask in the row order of `mat`."""
    return level.free[mat.node_of]


def _from_rows(level: MGLevel, mat, y):
    return bsr_mod.rows_to_grid_vector(mat, y, level.grid_m.shape[0])


def level_multiply_any(level: MGLevel, mat, pre: MGPrecond, dt: float, w):
    """A_l w on dense level vectors: the explicit SpMV when `mat` is given,
    the quadrature apply otherwise."""
    if mat is None:
        return level_multiply(level, pre, dt, w)
    y = _from_rows(level, mat, bsr_mod.spmv(mat, bsr_mod.grid_vector_to_rows(mat, w)))
    return torch.where(level.active[:, None], y, w)


def _level_ops_rows(level: MGLevel, mat):
    """(mul, proj) on row vectors of an explicit-operator level."""
    free_rows = _free_rows_of(level, mat)[:, None]
    return (lambda w: bsr_mod.spmv(mat, w),
            lambda r: torch.where(free_rows, r, torch.zeros_like(r)))


def _floor_fp32_diag(D):
    """fp32 smoother-stability floor: raise each diagonal entry to 1e-10 x
    the level's largest. Fringe active nodes (stencil-tail masses ~1e-20)
    otherwise give Dinv rows ~1e14, which Chebyshev compounds to fp32
    overflow. fp64 keeps its range and is left alone."""
    if D.dtype != torch.float32:
        return D
    diag = torch.diagonal(D, dim1=-2, dim2=-1)
    floor = 1e-10 * diag.max()
    return D + torch.diag_embed(torch.clamp(floor - diag, min=0.0))


def _level_smoother_data(level: MGLevel, mat, pre: MGPrecond, ctx, F_n, dt: float,
                         cfg: MultigridConfig, need_lmax: bool, dim: int):
    """One level's per-Newton smoother data: block-diagonal inverse and
    (Chebyshev) power-iteration lambda_max of the operator it smooths."""
    eye = torch.eye(dim, dtype=F_n.dtype, device=F_n.device)
    if mat is not None:
        free_rows = _free_rows_of(level, mat)
        D = torch.where(free_rows[:, None, None], bsr_mod.block_diag(mat), eye)
        mul, proj = _level_ops_rows(level, mat)
        v0 = free_rows[:, None].to(F_n.dtype).expand(-1, dim)
    else:
        D = obj_mod.elastic_block_diag(level.stencil, F_n, ctx, pre.V0, dt, level.grid_m,
                                       level.active, dim)
        D = _floor_fp32_diag(D)
        mul = lambda w: level_multiply(level, pre, dt, w)  # noqa: E731
        proj = lambda r: level_project(level, r)  # noqa: E731
        v0 = level.free[:, None].to(F_n.dtype).expand(-1, dim)
    Dinv = obj_mod.sym_block_inv(D)
    if need_lmax:
        lam = _power_iteration_lmax(mul, proj, Dinv, v0, cfg.power_iters)
    else:
        lam = torch.ones((), dtype=F_n.dtype, device=F_n.device)
    return Dinv, lam


def build_precond(mg: MGStatic, F_n, hess: obj_mod.HessianState, V0, dt: float,
                  cfg: MultigridConfig, dim: int, reuse: Optional[MGPrecond] = None) -> MGPrecond:
    """Per-Newton-iteration preconditioner data.

    Assembled levels assemble their explicit operator here, once per Newton
    iteration, amortised over every smoother and residual application.

    reuse (cfg.rap_refresh == "lagged"): a previously built MGPrecond whose
    Galerkin chain (every assembled level after the first) and coarse factor
    are taken as they are; the first assembled level and the smoother data
    of the levels above are rebuilt."""
    ctx = hess.context(dim)
    pre = MGPrecond(diag_inv=(), lmax=(), hess=hess, F_soa=soa(F_n), V0=V0)
    n_levels = len(mg.levels)
    first_asm = next((l for l, lv in enumerate(mg.levels) if lv.mat_sym is not None), None)
    galerkin = cfg.coarsening == "galerkin" and first_asm is not None
    if galerkin and first_asm > 0:
        raise NotImplementedError(
            "composed Galerkin (assembled_from_level > 0 with coarsening='galerkin', "
            "hot_tpu/ops/composed.py) is not ported to hot_tpu_torch yet")
    diag_inv, lmax, mats = [], [], []
    prev_mat = None
    for l, level in enumerate(mg.levels):
        if reuse is not None and level.mat_sym is not None and l > first_asm:
            mats.append(reuse.mats[l])
            prev_mat = reuse.mats[l]
            diag_inv.append(reuse.diag_inv[l])
            lmax.append(reuse.lmax[l])
            continue
        mat = None
        if level.mat_sym is not None:
            if galerkin and prev_mat is not None:
                mat = spgemm.rap(prev_mat, level.res, level.active, max_half=cfg.rap_max_half)
            else:
                mat = bsr_mod.assemble_hessian(level.mat_sym, level.stencil, F_n, ctx, V0, dt,
                                               level.grid_m)
            prev_mat = mat
        mats.append(mat)
        need_lmax = cfg.smoother == "chebyshev" and (
            l < n_levels - 1 or cfg.coarse_solver == "smoother")
        Dinv, lam = _level_smoother_data(level, mat, pre, ctx, F_n, dt, cfg, need_lmax, dim)
        diag_inv.append(Dinv)
        lmax.append(lam)
    chol = None
    if cfg.coarse_solver == "direct":
        if (reuse is not None and reuse.coarse_chol is not None and galerkin
                and n_levels - 1 > first_asm):
            chol = reuse.coarse_chol        # the coarsest level was lagged above
        elif galerkin and mats[-1] is not None:
            chol = (_dense_factor_from_mat(mats[-1], _free_rows_of(mg.levels[-1], mats[-1]),
                                           dim), mats[-1])
        else:
            chol = _coarse_dense_factor(mg.levels[-1], F_n, ctx, V0, dt, dim)
    return pre._replace(diag_inv=tuple(diag_inv), lmax=tuple(lmax), coarse_chol=chol,
                        mats=tuple(mats))


def _coarse_dense_factor(level: MGLevel, F_n, ctx, V0, dt: float, dim: int):
    """(Cholesky factor, BSR) of the BC-projected coarsest operator, from
    particle quadrature over the active coarsest rows."""
    mat = bsr_mod.structure(level.active, level.res, dtype=F_n.dtype)
    mat = bsr_mod.assemble_hessian(mat, level.stencil, F_n, ctx, V0, dt, level.grid_m)
    return _dense_factor_from_mat(mat, _free_rows_of(level, mat), dim), mat


def _dense_factor_from_mat(mat: bsr_mod.BsrMatrix, free_rows, dim: int):
    """Lower Cholesky factor of a BC-projected explicit BSR operator: the
    identity on non-free DoFs and a 1e-8 relative Tikhonov guard."""
    n = mat.n_rows
    cols = mat.col_row.long().clamp(min=0)
    ok = (mat.col_row >= 0) & free_rows[:, None] & free_rows[cols]
    r, k = torch.nonzero(ok, as_tuple=True)
    A = torch.zeros((n, dim, n, dim), dtype=mat.vals.dtype, device=mat.vals.device)
    # the columns of one row are distinct nodes, so (row, col) pairs are unique
    A[r, :, cols[r, k], :] = mat.vals[r, k]
    A = A.reshape(n * dim, n * dim)
    A = A + torch.diag((~free_rows).repeat_interleave(dim).to(A.dtype))
    eps = 1e-8 * torch.clamp(torch.diagonal(A).max(), min=1.0)
    A = A + eps * torch.eye(n * dim, dtype=A.dtype, device=A.device)
    return torch.linalg.cholesky(A)


def _coarse_dense_solve(chol_and_mat, b, n_nodes: int):
    L, mat = chol_and_mat
    d = b.shape[1]
    x = torch.cholesky_solve(bsr_mod.grid_vector_to_rows(mat, b).reshape(-1, 1), L)
    return bsr_mod.rows_to_grid_vector(mat, x.reshape(-1, d), n_nodes)


def _bapply(B, v):
    """Block-diagonal application: (n, d, d) blocks on (n, d) vectors."""
    return (B * v[:, None, :]).sum(-1)


def _norm(v):
    return torch.sqrt(torch.sum(v * v))


def _power_iteration_lmax(mul, proj, Dinv, v, iters: int):
    """lambda_max(D^-1 A) on the free subspace by power iteration."""
    v = v / torch.clamp(_norm(v), min=1e-30)
    lam = torch.ones((), dtype=v.dtype, device=v.device)
    for _ in range(iters):
        Av = proj(_bapply(Dinv, mul(proj(v))))
        lam = _norm(Av) / torch.clamp(_norm(v), min=1e-30)
        v = Av / torch.clamp(_norm(Av), min=1e-30)
    return torch.clamp(lam, min=1e-12)


# ---------------------------------------------------------------------------
# smoothers (mul/proj close over the level's operator and vector layout)
# ---------------------------------------------------------------------------


def jacobi_smooth(mul, proj, Dinv, b, x, iters: int, omega: float):
    for _ in range(iters):
        x = x + omega * _bapply(Dinv, proj(b - mul(x)))
    return x


def chebyshev_smooth(mul, proj, Dinv, lmax, b, x, order: int, lo: float, hi: float):
    """Chebyshev polynomial smoother on D^-1 A over [lo lmax, hi lmax];
    `order` operator applications."""
    lmin, lmx = lo * lmax, hi * lmax
    theta = 0.5 * (lmx + lmin)
    delta = 0.5 * (lmx - lmin)
    sigma1 = theta / delta
    d = proj(_bapply(Dinv, proj(b - mul(x)))) / theta
    x = x + d
    rho_prev = 1.0 / sigma1
    for _ in range(order - 1):
        z = proj(_bapply(Dinv, proj(b - mul(x))))
        rho = 1.0 / (2.0 * sigma1 - rho_prev)
        d = rho * rho_prev * d + (2.0 * rho / delta) * z
        x = x + d
        rho_prev = rho
    return x


def colored_gs_smooth(mul, proj, Dinv, color, n_colors: int, b, x, iters: int):
    """Symmetric multicolor Gauss-Seidel (forward then reverse color order,
    so the V-cycle stays symmetric); nodes colored by coordinate parity.
    One iteration costs 2 n_colors operator applications."""
    order = list(range(n_colors)) + list(range(n_colors - 1, -1, -1))
    masks = [(color == c).to(x.dtype)[:, None] for c in range(n_colors)]
    for _ in range(iters):
        for c in order:
            x = x + masks[c] * _bapply(Dinv, proj(b - mul(x)))
    return x


def _parity_colors(node_of, res: Tuple[int, ...], device):
    """(n,) parity color of each vector entry: sum over axes of
    (coord_k & 1) << k. node_of None means the dense layout."""
    if node_of is None:
        node_of = torch.arange(transfer.n_nodes_of(res), device=device)
    coords = transfer.unravel(node_of, res)
    color = torch.zeros(node_of.shape, dtype=torch.long, device=device)
    for k in range(len(res)):
        color = color | ((coords[:, k] & 1) << k)
    return color


def _smooth_ops(mul, proj, pre: MGPrecond, l: int, cfg: MultigridConfig, b, x, iters: int,
                color=None, n_colors: int = 0):
    if cfg.smoother == "chebyshev":
        return chebyshev_smooth(mul, proj, pre.diag_inv[l], pre.lmax[l], b, x,
                                max(iters * cfg.chebyshev_order, 1), cfg.chebyshev_lo,
                                cfg.chebyshev_hi)
    if cfg.smoother == "colored_gs":
        return colored_gs_smooth(mul, proj, pre.diag_inv[l], color, n_colors, b, x, iters)
    if cfg.smoother == "jacobi":
        return jacobi_smooth(mul, proj, pre.diag_inv[l], b, x, iters, cfg.jacobi_omega)
    raise ValueError(f"unknown smoother '{cfg.smoother}'")


def _smooth(level: MGLevel, pre: MGPrecond, l: int, dt: float, cfg: MultigridConfig, b, x,
            iters: int):
    """Smooth on dense level vectors. Assembled levels convert to rows once
    per call and run the whole smoother against the SpMV."""
    mat = pre.mats[l]
    n_colors = 2 ** len(level.res)
    device = b.device
    if mat is None:
        color = (_parity_colors(None, level.res, device)
                 if cfg.smoother == "colored_gs" else None)
        return _smooth_ops(lambda w: level_multiply(level, pre, dt, w),
                           lambda r: level_project(level, r), pre, l, cfg, b, x, iters,
                           color=color, n_colors=n_colors)
    mul, proj = _level_ops_rows(level, mat)
    color = (_parity_colors(mat.node_of, level.res, device)
             if cfg.smoother == "colored_gs" else None)
    x_r = _smooth_ops(mul, proj, pre, l, cfg, bsr_mod.grid_vector_to_rows(mat, b),
                      bsr_mod.grid_vector_to_rows(mat, x), iters, color=color, n_colors=n_colors)
    return _from_rows(level, mat, x_r)


# ---------------------------------------------------------------------------
# V-cycle
# ---------------------------------------------------------------------------


def restrict(embed: transfer.Stencil, r_fine, n_nodes_coarse: int):
    """R = P^T: scatter the fine residual into the coarse nodes."""
    return transfer.scatter_sum(embed.node_ids, embed.wn[:, :, None] * r_fine[:, None, :],
                                n_nodes_coarse)


def prolong(embed: transfer.Stencil, e_coarse):
    """P: interpolate the coarse correction at the fine nodes."""
    return torch.sum(embed.wn[:, :, None] * e_coarse[embed.node_ids], dim=1)


def v_cycle(mg: MGStatic, pre: MGPrecond, dt: float, cfg: MultigridConfig, b, l: int = 0):
    """One V(nu1, nu2) cycle on level l; returns approximately A_l^-1 b."""
    level = mg.levels[l]
    x = torch.zeros_like(b)
    if l == len(mg.levels) - 1:
        if cfg.coarse_solver == "direct":
            return level_project(level, _coarse_dense_solve(pre.coarse_chol, b,
                                                            level.grid_m.shape[0]))
        if cfg.coarse_solver == "cg":
            Dinv = pre.diag_inv[l]
            cmat = pre.mats[l]
            if cmat is None:
                res = cg_solve(lambda w: level_project(level, level_multiply(level, pre, dt, w)),
                               b, precondition=lambda r: _bapply(Dinv, r),
                               project=lambda r: level_project(level, r), tol=1e-2,
                               max_iters=cfg.coarse_iters)
                return res.x
            mul, proj = _level_ops_rows(level, cmat)
            res = cg_solve(lambda w: proj(mul(w)), bsr_mod.grid_vector_to_rows(cmat, b),
                           precondition=lambda r: _bapply(Dinv, r), project=proj, tol=1e-2,
                           max_iters=cfg.coarse_iters)
            return _from_rows(level, cmat, res.x)
        if cfg.coarse_solver == "smoother":
            return _smooth(level, pre, l, dt, cfg, b, x, cfg.coarse_iters)
        raise ValueError(f"unknown coarse_solver '{cfg.coarse_solver}'")
    x = _smooth(level, pre, l, dt, cfg, b, x, cfg.pre_smooth)
    r = level_project(level, b - level_multiply_any(level, pre.mats[l], pre, dt, x))
    coarse = mg.levels[l + 1]
    r_c = level_project(coarse, restrict(mg.embeds[l], r, coarse.grid_m.shape[0]))
    e_c = v_cycle(mg, pre, dt, cfg, r_c, l + 1)
    x = x + level_project(level, prolong(mg.embeds[l], e_c))
    return _smooth(level, pre, l, dt, cfg, b, x, cfg.post_smooth)


def mg_precondition(mg: MGStatic, pre: MGPrecond, dt: float, cfg: MultigridConfig, r):
    """Preconditioner application: `cycles` V-cycles (usually 1)."""
    z = v_cycle(mg, pre, dt, cfg, r)
    for _ in range(cfg.cycles - 1):
        res = r - level_multiply_any(mg.levels[0], pre.mats[0], pre, dt, z)
        z = z + v_cycle(mg, pre, dt, cfg, level_project(mg.levels[0], res))
    return z
