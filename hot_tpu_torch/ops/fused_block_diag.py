"""Block-Jacobi's per-node elastic blocks, scattered from the particles.

For the particles' SoA Hessian context (``ops.fused_linearize``'s output)
it returns K (n_nodes, d, d): at each grid node the sum over the particles
whose stencil holds it of

    B_k = dt^2 V0 sum_m lam_m z_m(k) z_m(k)^T,

the diagonal blocks of dt^2 K. The SPD-projected diagonal-space dP/dF is
exactly d + 2 n_pairs rank-1 modes, so with y_k = V^T F^T gw_k

    z_m = U (Q e_m o y_k)            lam_m = eig_m(A)   (normal modes)
    z   = (U_i y_j +- U_j y_i)/sqrt2  lam = b-/b+       (pair modes).

``sim.objective.elastic_block_diag`` adds the mass and the identity on
inactive nodes; the sharded step folds K over the slabs first, and the
multigrid floors it in fp32 after. The stencil is the quadratic or cubic
one (``kernel``) of the positions x (d, n) on the grid (dx, res), or the tile
grid's compact nodes with ``tgrid``, as in ``ops.fused_apply``, whose
argument layout this module takes.

The CUDA kernel (``hot_tpu_torch/csrc/fused_block_diag.cu``) replaces no TPU
kernel: hot_tpu builds these blocks in plain jnp. It sums the same modes in
U's frame, B_k = dt^2 V0 U M_k U^T with M_k = diag(y) A diag(y) plus the
pair terms, which needs no eigensolve of A (the source's note has the
identity and the design), and scatters each block's upper triangle once
per Newton iteration. ``ops.fused_apply.launch_config`` with its values
a node sets its launch, and ``window_stats`` collects its counters, as in
``ops.fused_apply``.

A batch passes every argument with a leading member dimension and gets K
(B, n_nodes, d, d) from one launch.

Dispatch is by device: CPU tensors take ``fused_block_diag_plain``; CUDA
tensors launch the kernel or raise. The tracer's counter
``launches.fused_block_diag`` (``utils.timing``) counts kernel launches,
one per call with particles.
"""

from __future__ import annotations

import math

import torch

from hot_tpu_torch.models import constitutive as cm
from hot_tpu_torch.ops import cuda_lib
from hot_tpu_torch.ops import transfer
from hot_tpu_torch.ops.bspline import kernel_width
from hot_tpu_torch.ops.fused_apply import (N_HIST, STATS, aos_mat, batch_of, launch_config,
                                           lookup_args, param_specs, stencil_of)
from hot_tpu_torch.ops.svd import eigh_sym
from hot_tpu_torch.utils.timing import count

# particles per block-diagonal chunk of the plain version: bounds each
# (chunk, s, d, d) temporary at 2^24 values (unchunked, one is 6.2 GB in
# fp64 at 256^3)
_BLOCK_DIAG_BUDGET = 2 ** 24

window_stats = None


def upper_values(d: int) -> int:
    """Values the kernel scatters per node: a block's upper triangle."""
    return d * (d + 1) // 2


def mirrored(K_upper, d: int):
    """(..., n_nodes, d (d + 1) / 2) upper triangles, row-major -> the full
    symmetric (..., n_nodes, d, d) blocks."""
    index = {i: {} for i in range(d)}
    t = 0
    for i in range(d):
        for j in range(i, d):
            index[i][j] = index[j][i] = t
            t += 1
    cols = [K_upper[..., index[i][j]] for i in range(d) for j in range(d)]
    return torch.stack(cols, -1).reshape(K_upper.shape[:-1] + (d, d))


def nodes_of(res, tgrid=None) -> int:
    """Rows of a grid vector over res, or over the tile grid's compact nodes."""
    return transfer.n_nodes_of(res) if tgrid is None else tgrid.n_cnodes


def fused_block_diag_plain(x, dx, res, F, U, V, A, b_plus, b_minus, V0, dt,
                           kernel: str = "quadratic", tgrid=None):
    """The modes' sum in chunks of particles in plain PyTorch (the reference
    for the kernel); a batch's members are one particle set over their
    stacked grids (the stencil's member offsets)."""
    d = x.shape[-2]
    stencil = stencil_of(x, dx, res, kernel, tgrid)
    F_n = aos_mat(F, d)
    ctx = cm.HessianContext(U=aos_mat(U, d), V=aos_mat(V, d), A=aos_mat(A, d),
                            b_plus=b_plus.transpose(-1, -2), b_minus=b_minus.transpose(-1, -2))
    lead, n_nodes = tuple(x.shape[:-2]), nodes_of(res, tgrid)
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
    return K.reshape(lead + (n_nodes, d, d))


def fused_block_diag_cuda(x, dx, res, F, U, V, A, b_plus, b_minus, V0, dt,
                          kernel: str = "quadratic", tgrid=None, threads=None,
                          window_nodes=None):
    """Launch the CUDA kernel (CUDA tensors only), once for the whole batch."""
    d, n = x.shape[-2], x.shape[-1]
    values = upper_values(d)
    K = torch.zeros(tuple(x.shape[:-2]) + (nodes_of(res, tgrid), values), dtype=x.dtype,
                    device=x.device)
    params = dict(F=F, U=U, V=V, A=A, b_plus=b_plus, b_minus=b_minus, V0=V0)
    cuda_lib.check_inputs(K, param_specs(K, x, res, tgrid, kernel, per_node=values, **params))
    if window_stats is not None:
        cuda_lib.check_inputs(K, [("window_stats", window_stats, (len(STATS) + N_HIST,),
                                   torch.int64)])
    width = kernel_width(kernel)
    default_threads, default_nodes = launch_config(d, width, K.element_size(), values)
    lib = cuda_lib.load()
    rc = lib.hot_fused_block_diag(
        cuda_lib.dtype_code(K), d, width, x.data_ptr(), float(dx), cuda_lib.int_array(res),
        *lookup_args(tgrid), *(t.data_ptr() for t in params.values()), float(dt),
        K.data_ptr(), n, K.shape[-2], batch_of(K),
        default_threads if threads is None else threads,
        default_nodes if window_nodes is None else window_nodes,
        None if window_stats is None else window_stats.data_ptr(),
        cuda_lib.stream_ptr(K.device))
    cuda_lib.check(rc, "fused_block_diag")
    # the C entry launches nothing for no particles
    count("launches.fused_block_diag", int(n > 0))
    return mirrored(K, d)


def fused_block_diag(x, dx, res, F, U, V, A, b_plus, b_minus, V0, dt,
                     kernel: str = "quadratic", tgrid=None):
    """K (n_nodes, d, d), a batch's (B, n_nodes, d, d) (see the module doc)."""
    args = (x, dx, res, F, U, V, A, b_plus, b_minus, V0, dt, kernel, tgrid)
    if x.device.type == "cpu":
        return fused_block_diag_plain(*args)
    if x.device.type != "cuda":
        raise ValueError(f"fused_block_diag runs on cpu or cuda tensors, not {x.device}")
    return fused_block_diag_cuda(*args)
