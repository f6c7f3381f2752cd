"""Fused matrix-free Hessian apply: the per-CG-iteration force differential.

Replaces the TPU kernel ``hot_tpu/ops/pallas_apply.py:fused_contrib_cl``
with the CUDA kernel ``hot_tpu_torch/csrc/fused_apply.cu``. For a grid
direction w it returns

    df_i = sum_p sum_k [node_k(p) = i] -V0_p (dP_p F_p^T) gw_pk,
    dP_p = dP/dF(F_p) : (dt grad_w_p F_p),  grad_w_p = sum_k w_k gw_pk^T,

i.e. stencil -> gather -> velocity gradient -> diagonal-space Hessian apply
-> force scatter, fused into one launch. The caller adds the mass term and
masks inactive nodes (``sim.objective.elastic_hessian_apply``).

The stencil (node_k(p), gw_pk) is the quadratic B-spline stencil of
``ops.transfer.particle_stencil`` at the particle positions x on the grid
of spacing dx and size res; the kernel computes it from x, so the same call
serves every matrix-free multigrid level (its dx and res). Per-particle
arguments are structure-of-arrays with the particle index last: x (d, n),
F/U/V/A (d*d, n) row-major per particle, b_plus/b_minus (n_pairs, n),
V0 (n,). This is the layout the linearize kernel writes, so the
per-Newton parameter block needs no transposes.

On the H100 the kernel is bound by bytes; a block gathers through a
shared-memory window over its particles' nodes and scatters through a
counting sort by node there (see the source's note). BLOCK_THREADS and
WINDOW_NODES set its launch; ``window_stats``, when set to a
``new_window_stats`` buffer, collects its counters (blocks, blocks that
overflowed the window, box sizes, global atomics).

Dispatch is by device: CPU tensors take ``fused_apply_plain``; CUDA tensors
launch the kernel or raise. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import math

import torch

from hot_tpu_torch.models import constitutive as cm
from hot_tpu_torch.ops import cuda_lib
from hot_tpu_torch.ops import transfer

# threads per block, and the largest node box a block takes through shared
# memory: 256 threads and 1536 nodes reserve 110 KB a block in fp32 3D
# (csrc/particle_window.cuh:window_bytes), the most that keeps two blocks on
# an H100 SM, and cover the boxes of the 64^3 main path (up to 1,444 nodes);
# chosen from chip_smoke.py's sweep (PERF.md)
BLOCK_THREADS = 256
WINDOW_NODES = 1536
# the kernels' counters (csrc/particle_window.cuh:WindowStat), then a
# histogram of log2(box nodes)
STATS = ("blocks", "overflow_blocks", "window_nodes", "max_window_nodes", "global_atomics")
N_HIST = 24

launches = 0
window_stats = None


def new_window_stats(device):
    """A zeroed counter buffer for a kernel's ``window_stats``."""
    return torch.zeros(len(STATS) + N_HIST, dtype=torch.int64, device=device)


def read_window_stats(buf) -> dict:
    vals = buf.tolist()
    out = dict(zip(STATS, vals))
    out["log2_nodes_histogram"] = {b: c for b, c in enumerate(vals[len(STATS):]) if c}
    return out


def aos_mat(M, d: int):
    """(d*d, n) SoA -> (n, d, d) view."""
    return M.T.reshape(-1, d, d)


def soa(M):
    """(n, ...) particle-major -> contiguous (prod(...), n) SoA."""
    return M.reshape(M.shape[0], -1).T.contiguous()


def fused_apply_plain(w, x, dx, res, F, U, V, A, b_plus, b_minus, V0, dt):
    """The unfused chain in plain PyTorch (the reference for the kernel)."""
    d = w.shape[-1]
    st = transfer.particle_stencil(x.T, dx, res)
    Fp = aos_mat(F, d)
    ctx = cm.HessianContext(U=aos_mat(U, d), V=aos_mat(V, d), A=aos_mat(A, d),
                            b_plus=b_plus.T, b_minus=b_minus.T)
    grad_w = transfer.velocity_gradient(st, w)
    dP = cm.apply_hessian(ctx, dt * (grad_w @ Fp))
    return transfer.scatter_force(st, dP @ Fp.transpose(-1, -2), V0, w.shape[0])


def param_specs(grid_vec, x, res, **params):
    """check_inputs specs for a stencil kernel's arguments: the grid vector
    (n_nodes, d) over res, x (d, n) and the per-particle SoA arrays."""
    d = grid_vec.shape[-1]
    n = x.shape[-1]
    if d not in (2, 3) or len(res) != d:
        raise ValueError(f"need a 2D or 3D grid, got d={d}, res={tuple(res)}")
    n_nodes = math.prod(int(r) for r in res)
    if n_nodes * d >= 2 ** 31:
        raise ValueError(f"grid {tuple(res)} too large for 32-bit node offsets")
    rows = {"F": d * d, "U": d * d, "V": d * d, "A": d * d,
            "b_plus": 1 if d == 2 else 3, "b_minus": 1 if d == 2 else 3}
    specs = [("grid vector", grid_vec, (n_nodes, d), grid_vec.dtype),
             ("x", x, (d, n), grid_vec.dtype)]
    for name, t in params.items():
        specs.append((name, t, (rows[name], n) if name in rows else (n,), grid_vec.dtype))
    return specs


def launch_args(ref, threads, window_nodes, stats):
    """(threads, window_nodes, stats pointer or None) of a stencil kernel's
    launch: the module defaults unless given."""
    if stats is not None:
        cuda_lib.check_inputs(ref, [("window_stats", stats, (len(STATS) + N_HIST,),
                                     torch.int64)])
    return (BLOCK_THREADS if threads is None else threads,
            WINDOW_NODES if window_nodes is None else window_nodes,
            None if stats is None else stats.data_ptr())


def fused_apply_cuda(w, x, dx, res, F, U, V, A, b_plus, b_minus, V0, dt, threads=None,
                     window_nodes=None):
    """Launch the CUDA kernel (CUDA tensors only)."""
    global launches
    params = dict(F=F, U=U, V=V, A=A, b_plus=b_plus, b_minus=b_minus, V0=V0)
    cuda_lib.check_inputs(w, param_specs(w, x, res, **params))
    lib = cuda_lib.load()
    df = torch.zeros_like(w)
    rc = lib.hot_fused_apply(
        cuda_lib.dtype_code(w), w.shape[-1], w.data_ptr(), x.data_ptr(), float(dx),
        cuda_lib.int_array(res), *(t.data_ptr() for t in params.values()), float(dt),
        df.data_ptr(), x.shape[1], *launch_args(w, threads, window_nodes, window_stats),
        cuda_lib.stream_ptr(w.device))
    cuda_lib.check(rc, "fused_apply")
    launches += 1
    return df


def fused_apply(w, x, dx, res, F, U, V, A, b_plus, b_minus, V0, dt):
    """df (n_nodes, d) for grid direction w (see the module doc)."""
    if w.device.type == "cpu":
        return fused_apply_plain(w, x, dx, res, F, U, V, A, b_plus, b_minus, V0, dt)
    if w.device.type != "cuda":
        raise ValueError(f"fused_apply runs on cpu or cuda tensors, not {w.device}")
    return fused_apply_cuda(w, x, dx, res, F, U, V, A, b_plus, b_minus, V0, dt)
