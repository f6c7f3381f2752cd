"""HOT's node-embedding geometric multigrid.

Counterpart of ``hot_tpu.solver.multigrid``. Coarse level L
has spacing 2^L dx; fine nodes embed in the coarse grid's quadratic
B-spline stencils (prolongation = interpolation weights, restriction = its
transpose), whatever the transfer kernel. A level's particle quadrature uses
the transfer kernel family of the step (quadratic or cubic). A level's
operator is one of:

  * matrix-free: the particle-quadrature Hessian apply at the level's
    spacing, through ``ops.fused_apply`` on the card (``MGLevel.mat_sym`` is
    None);
  * assembled: an explicit BSR operator (``ops.bsr``), from particle
    quadrature on the first assembled level and, with
    ``coarsening="galerkin"``, P^T A P (``ops.spgemm.rap``) below it. Under
    Galerkin coarsening with a matrix-free finest level
    (``assembled_from > 0``), the first assembled level is the exact
    composed Galerkin operator P^T A_0 P built from the particles and the
    fine node masses (``ops.composed``), since no fine matrix exists to RAP
    from. Its smoothers, residuals and power iteration run through
    ``ops.bsr_spmv``.

On the sparse tile grid (``tgrid``, the step's ``grid.sparse.TileGrid``),
level 0 and every coarser level whose dense node count is above
``dense_switch`` (2 tile_capacity 4^dim by default) are compact: their
vectors live on the compact nodes of their own tile grid (activated by the
particles at that level's spacing) and their stencils, kernels and BSR rows
address compact ids; below the switch the levels are dense. The embeddings
run compact to compact, compact to dense and dense to dense; a fine node
that is inactive (or the dump row) embeds with weight zero, and a fine node
whose coarse stencil leaves the coarse tile grid loses that coupling (the
subspace Galerkin of hot_tpu).

Smoothers: Chebyshev over a power-iteration lambda_max, damped Jacobi, or
symmetric parity-colored Gauss-Seidel; coarsest solve by Cholesky
("direct"), CG or the smoother. One V-cycle per PCG application.

The hierarchy splits in two:
  MGStatic  - per time step: stencils, masses, activity, BC per level;
  MGPrecond - per Newton iteration: operators, block-diagonal inverses,
              Chebyshev bounds and the coarse factor.

Every assembled level uses the compressed-row layout of ``ops.bsr``, sized
to its rows: the active nodes of a dense quadrature or RAP level, and, as
in hot_tpu's tile-row layout, every node of the active tiles on a compact
level and on a dense composed level (the composed stencil reaches nodes the
level's own particle stencils leave inactive). hot_tpu's tile-row layout,
its capacities and the phased build were for the TPU's static shapes and
are not ported.

A batch of B members (hot_tpu's ``jax.vmap`` over the step: x (B, n, d),
level vectors (B, n_nodes_l, d)) builds one hierarchy whose every array
has a leading member dimension: each member's levels have their own
active nodes, constrained set (the 25% rule over the member's own fine
nodes), tile grids (``grid.sparse``'s batch) and assembled operators
(``ops.bsr``'s block-diagonal batch, RAP and the composed level on it, so
each SpMV is one launch for all members). Everything that reduces is per
member, as under ``vmap``: the power iteration's lambda_max and so every
Chebyshev coefficient, the fp32 diagonal floor, the coarse Cholesky factor
(one per member, batched over blocks padded with the identity) and the
coarse CG, which freezes a converged member (``solver.cg``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from hot_tpu_torch.grid import sparse
from hot_tpu_torch.ops import bsr as bsr_mod
from hot_tpu_torch.ops import composed as comp_mod
from hot_tpu_torch.ops import spgemm
from hot_tpu_torch.ops import transfer
from hot_tpu_torch.ops.fused_apply import soa
from hot_tpu_torch.sim import objective as obj_mod
from hot_tpu_torch.solver.cg import cg_solve, dot, per_member
from hot_tpu_torch.utils.config import MultigridConfig
from hot_tpu_torch.utils.timing import span, synced


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
    kernel: str = "quadratic"   # the particle stencil's kernel family
    # compact levels: the level's tile grid (vectors over its n_cnodes);
    # None = dense
    tgrid: Optional[sparse.TileGrid] = None
    # the composed Galerkin level: its particles' composed weights and the
    # fine level's node coords and masses (ops.composed); None elsewhere
    comp: Optional["ComposedLevel"] = None


class ComposedLevel(NamedTuple):
    base: torch.Tensor          # (n, dim) composed base of each particle
    w: torch.Tensor             # (n, dim, width) composed per-axis weights
    dw: torch.Tensor            # (n, dim, width) composed per-axis gradients
    node_coords: torch.Tensor   # (nf, dim) fine node coords
    node_m: torch.Tensor        # (nf,) fine lumped masses


class MGStatic(NamedTuple):
    levels: Tuple[MGLevel, ...]
    # embeds[l]: level-l nodes embedded in the level-(l+1) grid (node_ids, wn)
    embeds: Tuple[transfer.Stencil, ...]


class MGPrecond(NamedTuple):
    diag_inv: Tuple[torch.Tensor, ...]  # per level (n_l, d, d), row order when assembled
    lmax: Tuple[torch.Tensor, ...]      # per level: spectral bound (a batch's: per member)
    hess: obj_mod.HessianState          # per-particle dPdF context, shared by levels
    F_soa: torch.Tensor                 # (d*d, n) step-start F, SoA
    V0: torch.Tensor
    coarse_chol: object = None          # (Cholesky factor, coarsest BSR) for "direct"
    mats: Tuple[Optional[bsr_mod.BsrMatrix], ...] = ()   # None: matrix-free level


def coarse_res(res: Tuple[int, ...]) -> Tuple[int, ...]:
    return tuple((r + 1) // 2 for r in res)


def build_static(x, m, res, dx: float, n_levels: int, constrained, dtype,
                 assembled_from: Optional[int] = None,
                 kernel: str = "quadratic", tgrid: Optional[sparse.TileGrid] = None,
                 tile_capacity: int = 0, dense_switch: Optional[int] = None,
                 composed: bool = False) -> MGStatic:
    """Per-step hierarchy topology, mass and BC.

    constrained: (n_nodes_0,) bool fine-level Dirichlet/contact nodes. A
    coarse node is constrained when more than 25% of its restriction weight
    comes from constrained fine nodes. assembled_from: index of the first
    assembled level (None: all levels matrix-free). kernel: the particle
    stencils' family; assembled levels fill the quadratic 5-wide structure,
    so a cubic hierarchy is matrix-free (hot_tpu refuses the rest too).
    tgrid: the step's tile grid (level 0 compact; None = the dense grid),
    with tile_capacity the coarse compact levels' limit and dense_switch
    (None = 2 tile_capacity 4^dim) the dense node count at or below which a
    level is dense. composed: with assembled_from > 0, make that level the
    composed Galerkin operator (coarsening="galerkin"). A batch's x and m
    (and tile grid) give the batch's hierarchy (see the module doc)."""
    if kernel != "quadratic" and assembled_from is not None:
        raise NotImplementedError(
            "assembled MG levels use the 5-wide quadratic BSR; run the matrix-free MG "
            "(multigrid.assembled=False) with cubic")
    device = x.device
    dim = len(res)
    if tgrid is not None and dense_switch is None:
        dense_switch = 2 * tile_capacity * 4 ** dim
    levels, embeds = [], []
    cur_res, cur_dx, cons = tuple(res), dx, constrained
    batch = x.shape[0] if x.ndim == 3 else None
    x_soa = soa(x, x.ndim - 2)
    tg = tgrid
    for l in range(n_levels):
        if tg is not None:
            st = sparse.sparse_stencil(x, cur_dx, tg)
            n_nodes = tg.n_cnodes
        else:
            st = transfer.particle_stencil(x, cur_dx, cur_res, kernel=kernel)
            n_nodes = transfer.n_nodes_of(cur_res)
        grid_m = transfer.scatter_sum(st.node_ids, st.wn * m[..., None], n_nodes)
        active = grid_m > 0
        assembled = assembled_from is not None and l >= assembled_from
        comp = None
        mat_sym = None
        if assembled:
            half, rows = 2, active
            if composed and l == assembled_from > 0:
                half = comp_mod.structure_half(l)
                comp = _composed_level(x, dx, l, levels[0])
                if tg is None:
                    # hot_tpu's rows: every node of the level's active tiles
                    rows = _tile_rows(x, cur_dx, cur_res)
            if tg is not None:
                rows = sparse.slot_nodes(tg)
            mat_sym = bsr_mod.structure(rows, cur_res, half=half, dtype=dtype, tgrid=tg)
        levels.append(MGLevel(
            stencil=st, grid_m=grid_m, active=active, free=active & ~cons,
            dx=cur_dx, res=cur_res, mat_sym=mat_sym,
            x_soa=None if assembled else x_soa, kernel=kernel, tgrid=tg, comp=comp))
        if l == n_levels - 1:
            break
        nxt_res, nxt_dx = coarse_res(cur_res), cur_dx * 2.0
        if tg is not None:
            node_pos = sparse.node_positions(tg, cur_dx, dtype)
        else:
            node_pos = transfer.node_positions(cur_res, cur_dx, dtype, device)
        fine_compact = tg is not None
        tg = (sparse.build_tile_grid(x, nxt_dx, nxt_res, tile_capacity)
              if tgrid is not None and transfer.n_nodes_of(nxt_res) > dense_switch else None)
        if tg is not None:
            embed = sparse.sparse_stencil(node_pos, nxt_dx, tg)
        else:
            embed = transfer.particle_stencil(node_pos, nxt_dx, nxt_res)
        n_coarse = tg.n_cnodes if tg is not None else transfer.n_nodes_of(nxt_res)
        node_ids, wn = embed.node_ids, embed.wn
        if batch is not None and node_pos.ndim == 2:
            # dense to dense: the members share the embedding, each on its own nodes
            node_ids = node_ids + transfer.member_offsets(batch, n_coarse, device)
            wn = wn.expand(batch, -1, -1)
        if fine_compact:
            # the dump row sits far outside the grid: no weight from it or
            # from any other inactive fine node
            wn = torch.where(active[..., None], wn, torch.zeros((), dtype=wn.dtype, device=device))
        embed = transfer.Stencil(node_ids=node_ids, wn=wn, gwn=None, rel=None)
        # restriction and prolongation read only node_ids and wn
        embeds.append(embed)
        w_total = transfer.scatter_sum(embed.node_ids, embed.wn, n_coarse)
        w_cons = transfer.scatter_sum(embed.node_ids, embed.wn * cons[..., None].to(dtype),
                                      n_coarse)
        cons = w_cons > 0.25 * torch.clamp(w_total, min=1e-30)
        cur_res, cur_dx = nxt_res, nxt_dx
    return MGStatic(levels=tuple(levels), embeds=tuple(embeds))


def _tile_rows(x, dx: float, res):
    """(n_nodes,) bool, a batch's (B, n_nodes): the dense nodes inside the
    tiles that the particles' stencils at spacing dx activate."""
    tg = sparse.build_tile_grid(x, dx, res, capacity=transfer.n_nodes_of(res))
    return sparse.compact_to_dense(tg, sparse.slot_nodes(tg), fill=False)


def _composed_level(x, dx: float, L: int, fine: MGLevel) -> ComposedLevel:
    """The composed Galerkin data of level L: the particles' composed
    weights and the fine level's node coords and masses (its compact nodes
    on the tile grid, the dump row left out); a batch's with a leading
    member dimension."""
    base, w, dw = (t.reshape(x.shape[:-1] + t.shape[1:])
                   for t in comp_mod.composed_particle_weights(x.reshape(-1, x.shape[-1]), dx, L))
    n_f = fine.grid_m.shape[-1] if fine.tgrid is None else fine.tgrid.dump
    ids = torch.arange(n_f, device=x.device).expand(fine.grid_m.shape[:-1] + (n_f,))
    coords = bsr_mod.node_coords(fine.res, fine.tgrid, ids)
    return ComposedLevel(base=base, w=w, dw=dw, node_coords=coords,
                         node_m=fine.grid_m[..., :n_f])


def level_node_coords(level: MGLevel):
    """(n_nodes_l, dim) integer coords of the level's vector entries (the
    dump row of a compact level at the origin); a batch's compact level's
    (B, n_nodes_l, dim)."""
    n = level.grid_m.shape[-1]
    ids = torch.arange(n, device=level.grid_m.device)
    if level.tgrid is None:
        return transfer.unravel(ids, level.res)
    ids = ids.expand(level.grid_m.shape[:-1] + (n,))
    coords = bsr_mod.node_coords(level.res, level.tgrid, ids.clamp(max=level.tgrid.dump - 1))
    return torch.where((ids < level.tgrid.dump)[..., None], coords, torch.zeros_like(coords))


# ---------------------------------------------------------------------------
# level operators
# ---------------------------------------------------------------------------


def level_multiply(level: MGLevel, pre: MGPrecond, dt: float, w):
    """Matrix-free A_l w through ``ops.fused_apply``; identity on inactive nodes."""
    return obj_mod.elastic_hessian_apply(level.x_soa, level.dx, level.res, pre.F_soa, pre.hess,
                                         pre.V0, dt, level.grid_m, level.active, w, level.kernel,
                                         level.tgrid)


def level_project(level: MGLevel, r):
    return torch.where(level.free[..., None], r, torch.zeros_like(r))


def _free_rows_of(level: MGLevel, mat):
    """Free mask in the row order of `mat` (a batch's (B, R), False on its
    padding rows)."""
    return bsr_mod.grid_vector_to_rows(mat, level.free)


def _from_rows(level: MGLevel, mat, y):
    return bsr_mod.rows_to_grid_vector(mat, y, level.grid_m.shape[-1])


def level_multiply_any(level: MGLevel, mat, pre: MGPrecond, dt: float, w):
    """A_l w on dense level vectors: the explicit SpMV when `mat` is given,
    the quadrature apply otherwise."""
    if mat is None:
        return level_multiply(level, pre, dt, w)
    y = _from_rows(level, mat, bsr_mod.spmv(mat, bsr_mod.grid_vector_to_rows(mat, w)))
    return torch.where(level.active[..., None], y, w)


def _level_ops_rows(level: MGLevel, mat):
    """(mul, proj) on row vectors of an explicit-operator level."""
    free_rows = _free_rows_of(level, mat)[..., None]
    return (lambda w: bsr_mod.spmv(mat, w),
            lambda r: torch.where(free_rows, r, torch.zeros_like(r)))


def _floor_fp32_diag(D):
    """fp32 smoother-stability floor: raise each diagonal entry to 1e-10 x
    the level's largest (a batch's member's own). Fringe active nodes
    (stencil-tail masses ~1e-20) otherwise give Dinv rows ~1e14, which
    Chebyshev compounds to fp32 overflow. fp64 keeps its range and is left
    alone."""
    if D.dtype != torch.float32:
        return D
    diag = torch.diagonal(D, dim1=-2, dim2=-1)
    floor = diag.amax(dim=(-2, -1), keepdim=True) * 1e-10 if D.ndim == 4 else 1e-10 * diag.max()
    return D + torch.diag_embed(torch.clamp(floor - diag, min=0.0))


def _level_smoother_data(level: MGLevel, mat, pre: MGPrecond, ctx, F_n, dt: float,
                         cfg: MultigridConfig, need_lmax: bool, dim: int):
    """One level's per-Newton smoother data: block-diagonal inverse and
    (Chebyshev) power-iteration lambda_max of the operator it smooths."""
    eye = torch.eye(dim, dtype=F_n.dtype, device=F_n.device)
    if mat is not None:
        free_rows = _free_rows_of(level, mat)
        D = torch.where(free_rows[..., None, None], bsr_mod.block_diag(mat), eye)
        mul, proj = _level_ops_rows(level, mat)
        v0 = free_rows[..., None].to(F_n.dtype).expand(free_rows.shape + (dim,))
    else:
        D = obj_mod.elastic_block_diag(level.stencil, F_n, ctx, pre.V0, dt, level.grid_m,
                                       level.active, dim)
        D = _floor_fp32_diag(D)
        mul = lambda w: level_multiply(level, pre, dt, w)  # noqa: E731
        proj = lambda r: level_project(level, r)  # noqa: E731
        v0 = level.free[..., None].to(F_n.dtype).expand(level.free.shape + (dim,))
    Dinv = obj_mod.sym_block_inv(D)
    if need_lmax:
        lam = _power_iteration_lmax(mul, proj, Dinv, v0, cfg.power_iters)
    else:
        lam = torch.ones(F_n.shape[:-3], dtype=F_n.dtype, device=F_n.device)
    return Dinv, lam


def build_precond(mg: MGStatic, F_n, hess: obj_mod.HessianState, V0, dt: float,
                  cfg: MultigridConfig, dim: int, reuse: Optional[MGPrecond] = None) -> MGPrecond:
    """Per-Newton-iteration preconditioner data.

    Assembled levels assemble their explicit operator here, once per Newton
    iteration, amortised over every smoother and residual application.

    reuse (cfg.rap_refresh == "lagged"): a previously built MGPrecond whose
    Galerkin chain (every assembled level after the first) and coarse factor
    are taken as they are; the first assembled level and the smoother data
    of the levels above are rebuilt.

    Spans (``utils.timing``): ``mg.assemble`` (a level's quadrature or
    composed operator), ``mg.rap``, ``mg.smoother_data`` (per level) and
    ``mg.coarse_factor``."""
    ctx = hess.context(dim)
    pre = MGPrecond(diag_inv=(), lmax=(), hess=hess, F_soa=soa(F_n, F_n.ndim - 3), V0=V0)
    n_levels = len(mg.levels)
    first_asm = next((l for l, lv in enumerate(mg.levels) if lv.mat_sym is not None), None)
    galerkin = cfg.coarsening == "galerkin" and first_asm is not None
    if cfg.coarse_solver == "direct" and mg.levels[-1].tgrid is not None:
        raise NotImplementedError(
            "direct coarse solve needs a dense coarsest level: add MG levels (or lower "
            "dense_switch) so the coarsest grid leaves the compact tile representation")
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
                with span("mg.rap"):
                    mat = spgemm.rap(prev_mat, level.res, level.mat_sym.row_nodes(),
                                     max_half=cfg.rap_max_half, coarse_tgrid=level.tgrid)
            elif galerkin and level.comp is not None:
                c = level.comp
                with span("mg.assemble"):
                    mat = comp_mod.assemble_composed_galerkin(
                        level.mat_sym, l, F_n, ctx, V0, dt, c.node_coords, c.node_m, c.base,
                        c.w, c.dw)
            else:
                with span("mg.assemble"):
                    mat = bsr_mod.assemble_hessian(level.mat_sym, level.stencil, F_n, ctx, V0,
                                                   dt, level.grid_m)
            prev_mat = mat
        mats.append(mat)
        need_lmax = cfg.smoother == "chebyshev" and (
            l < n_levels - 1 or cfg.coarse_solver == "smoother")
        with span("mg.smoother_data"):
            Dinv, lam = _level_smoother_data(level, mat, pre, ctx, F_n, dt, cfg, need_lmax, dim)
        diag_inv.append(Dinv)
        lmax.append(lam)
    chol = None
    if cfg.coarse_solver == "direct":
        if (reuse is not None and reuse.coarse_chol is not None and galerkin
                and n_levels - 1 > first_asm):
            chol = reuse.coarse_chol        # the coarsest level was lagged above
        elif galerkin and mats[-1] is not None:
            with span("mg.coarse_factor"):
                chol = (_dense_factor_from_mat(mats[-1], _free_rows_of(mg.levels[-1], mats[-1]),
                                               dim), mats[-1])
        else:
            with span("mg.coarse_factor"):
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
    identity on non-free DoFs and a 1e-8 relative Tikhonov guard. A batch's
    operator gives (B, R d, R d), each member's own factor of its own block
    (the identity on its padding rows, whose free mask is False)."""
    B, n = mat.batch or 1, mat.member_rows
    free = free_rows.reshape(-1)
    cols = mat.col_row.long().clamp(min=0)
    ok = (mat.col_row >= 0) & free[:, None] & free[cols]
    r, k = synced(torch.nonzero(ok, as_tuple=True))
    A = torch.zeros((B, n, dim, n, dim), dtype=mat.vals.dtype, device=mat.vals.device)
    # the columns of one row are distinct nodes, so (row, col) pairs are unique
    A[torch.div(r, n, rounding_mode="floor"), r % n, :, cols[r, k] % n, :] = mat.vals[r, k]
    A = A.reshape(B, n * dim, n * dim)
    A = A + torch.diag_embed((~free).reshape(B, n).repeat_interleave(dim, dim=1).to(A.dtype))
    eps = 1e-8 * torch.clamp(torch.diagonal(A, dim1=-2, dim2=-1).amax(-1), min=1.0)
    A = A + eps[:, None, None] * torch.eye(n * dim, dtype=A.dtype, device=A.device)
    L = synced(torch.linalg.cholesky(A))       # checks the factor's info on the host
    return L if mat.batch is not None else L[0]


def _coarse_dense_solve(chol_and_mat, b, n_nodes: int):
    L, mat = chol_and_mat
    rows = bsr_mod.grid_vector_to_rows(mat, b)
    x = torch.cholesky_solve(rows.reshape(rows.shape[:-2] + (-1, 1)), L)
    return bsr_mod.rows_to_grid_vector(mat, x.reshape(rows.shape), n_nodes)


def _bapply(B, v):
    """Block-diagonal application: (n, d, d) blocks on (n, d) vectors (a
    batch's (B, n, ...))."""
    return (B * v[..., None, :]).sum(-1)


def _norm(v):
    """|v|_2: a scalar, per member (B,) for a batch's (B, n, d)."""
    return torch.sqrt(dot(v, v, v.ndim == 3))


def _scaled(v, s):
    """v / s with s a scalar or per member."""
    return v / per_member(s, v)


def _power_iteration_lmax(mul, proj, Dinv, v, iters: int):
    """lambda_max(D^-1 A) on the free subspace by power iteration (per
    member for a batch)."""
    v = _scaled(v, torch.clamp(_norm(v), min=1e-30))
    lam = torch.ones(v.shape[:-2], dtype=v.dtype, device=v.device)
    for _ in range(iters):
        Av = proj(_bapply(Dinv, mul(proj(v))))
        lam = _norm(Av) / torch.clamp(_norm(v), min=1e-30)
        v = _scaled(Av, torch.clamp(_norm(Av), min=1e-30))
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
    `order` operator applications. A batch's lmax (B,) gives each member
    its own coefficients."""
    lmin, lmx = lo * lmax, hi * lmax
    theta = 0.5 * (lmx + lmin)
    delta = 0.5 * (lmx - lmin)
    sigma1 = theta / delta
    d = _scaled(proj(_bapply(Dinv, proj(b - mul(x)))), theta)
    x = x + d
    rho_prev = 1.0 / sigma1
    for _ in range(order - 1):
        z = proj(_bapply(Dinv, proj(b - mul(x))))
        rho = 1.0 / (2.0 * sigma1 - rho_prev)
        d = per_member(rho * rho_prev, d) * d + per_member(2.0 * rho / delta, z) * z
        x = x + d
        rho_prev = rho
    return x


def colored_gs_smooth(mul, proj, Dinv, color, n_colors: int, b, x, iters: int):
    """Symmetric multicolor Gauss-Seidel (forward then reverse color order,
    so the V-cycle stays symmetric); nodes colored by coordinate parity.
    One iteration costs 2 n_colors operator applications."""
    order = list(range(n_colors)) + list(range(n_colors - 1, -1, -1))
    masks = [(color == c).to(x.dtype)[..., None] for c in range(n_colors)]
    for _ in range(iters):
        for c in order:
            x = x + masks[c] * _bapply(Dinv, proj(b - mul(x)))
    return x


def _parity_colors(coords):
    """(...,) parity color of each vector entry from its node coords (..., dim):
    sum over axes of (coord_k & 1) << k."""
    color = torch.zeros(coords.shape[:-1], dtype=torch.long, device=coords.device)
    for k in range(coords.shape[-1]):
        color = color | ((coords[..., k] & 1) << k)
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
    if mat is None:
        color = (_parity_colors(level_node_coords(level))
                 if cfg.smoother == "colored_gs" else None)
        return _smooth_ops(lambda w: level_multiply(level, pre, dt, w),
                           lambda r: level_project(level, r), pre, l, cfg, b, x, iters,
                           color=color, n_colors=n_colors)
    mul, proj = _level_ops_rows(level, mat)
    color = (_parity_colors(bsr_mod.grid_vector_to_rows(mat, level_node_coords(level).expand(
        level.grid_m.shape + (len(level.res),)))) if cfg.smoother == "colored_gs" else None)
    x_r = _smooth_ops(mul, proj, pre, l, cfg, bsr_mod.grid_vector_to_rows(mat, b),
                      bsr_mod.grid_vector_to_rows(mat, x), iters, color=color, n_colors=n_colors)
    return _from_rows(level, mat, x_r)


# ---------------------------------------------------------------------------
# V-cycle
# ---------------------------------------------------------------------------


def restrict(embed: transfer.Stencil, r_fine, n_nodes_coarse: int):
    """R = P^T: scatter the fine residual into the coarse nodes (a batch's
    (B, n_f, d) onto (B, n_c, d) through the member-offset embedding)."""
    return transfer.scatter_sum(embed.node_ids, embed.wn[..., None] * r_fine[..., None, :],
                                n_nodes_coarse)


def prolong(embed: transfer.Stencil, e_coarse):
    """P: interpolate the coarse correction at the fine nodes."""
    return torch.sum(embed.wn[..., None] * transfer.gather(e_coarse, embed.node_ids), dim=-2)


def v_cycle(mg: MGStatic, pre: MGPrecond, dt: float, cfg: MultigridConfig, b, l: int = 0):
    """One V(nu1, nu2) cycle on level l; returns approximately A_l^-1 b."""
    level = mg.levels[l]
    x = torch.zeros_like(b)
    if l == len(mg.levels) - 1:
        if cfg.coarse_solver == "direct":
            return level_project(level, _coarse_dense_solve(pre.coarse_chol, b,
                                                            level.grid_m.shape[-1]))
        if cfg.coarse_solver == "cg":
            Dinv = pre.diag_inv[l]
            cmat = pre.mats[l]
            # a batch's members solve at once, each frozen once it converges
            batch = {} if b.ndim == 2 else {
                "active": torch.ones(b.shape[:1], dtype=torch.bool, device=b.device)}
            if cmat is None:
                res = cg_solve(lambda w: level_project(level, level_multiply(level, pre, dt, w)),
                               b, precondition=lambda r: _bapply(Dinv, r),
                               project=lambda r: level_project(level, r), tol=1e-2,
                               max_iters=cfg.coarse_iters, **batch)
                return res.x
            mul, proj = _level_ops_rows(level, cmat)
            res = cg_solve(lambda w: proj(mul(w)), bsr_mod.grid_vector_to_rows(cmat, b),
                           precondition=lambda r: _bapply(Dinv, r), project=proj, tol=1e-2,
                           max_iters=cfg.coarse_iters, **batch)
            return _from_rows(level, cmat, res.x)
        if cfg.coarse_solver == "smoother":
            return _smooth(level, pre, l, dt, cfg, b, x, cfg.coarse_iters)
        raise ValueError(f"unknown coarse_solver '{cfg.coarse_solver}'")
    x = _smooth(level, pre, l, dt, cfg, b, x, cfg.pre_smooth)
    r = level_project(level, b - level_multiply_any(level, pre.mats[l], pre, dt, x))
    coarse = mg.levels[l + 1]
    r_c = level_project(coarse, restrict(mg.embeds[l], r, coarse.grid_m.shape[-1]))
    e_c = v_cycle(mg, pre, dt, cfg, r_c, l + 1)
    x = x + level_project(level, prolong(mg.embeds[l], e_c))
    return _smooth(level, pre, l, dt, cfg, b, x, cfg.post_smooth)


def mg_precondition(mg: MGStatic, pre: MGPrecond, dt: float, cfg: MultigridConfig, r):
    """Preconditioner application: `cycles` V-cycles (usually 1), one
    ``vcycle`` span (``utils.timing``)."""
    with span("vcycle"):
        z = v_cycle(mg, pre, dt, cfg, r)
        for _ in range(cfg.cycles - 1):
            res = r - level_multiply_any(mg.levels[0], pre.mats[0], pre, dt, z)
            z = z + v_cycle(mg, pre, dt, cfg, level_project(mg.levels[0], res))
    return z
