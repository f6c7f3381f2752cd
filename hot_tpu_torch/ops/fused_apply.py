"""Fused matrix-free Hessian apply: the per-CG-iteration force differential.

Replaces the TPU kernel ``hot_tpu/ops/pallas_apply.py:fused_contrib_cl``
with the CUDA kernel ``hot_tpu_torch/csrc/fused_apply.cu``. For a grid
direction w it returns

    df_i = sum_p sum_k [node_k(p) = i] -V0_p (dP_p F_p^T) gw_pk,
    dP_p = dP/dF(F_p) : (dt grad_w_p F_p),  grad_w_p = sum_k w_k gw_pk^T,

i.e. stencil -> gather -> velocity gradient -> diagonal-space Hessian apply
-> force scatter, fused into one launch. The caller adds the mass term and
masks inactive nodes (``sim.objective.elastic_hessian_apply``).

The stencil (node_k(p), gw_pk) is the quadratic or cubic B-spline stencil
(``kernel``) of ``ops.transfer.particle_stencil`` at the particle positions
x on the grid of spacing dx and size res; the kernel computes it from x, so
the same call serves every matrix-free multigrid level (its dx and res).
The quadratic and cubic stencils are separate instances of the kernel.

With ``tgrid`` (a ``grid.sparse.TileGrid``) the grid vectors w and df live
on that tile grid's compact nodes (n_cnodes, d), and the node ids are its
compact ids (``grid.sparse.sparse_stencil``, quadratic only): the kernel
takes the tile lookup and turns each logical node into its compact address
(the source's note says how).
Per-particle arguments are structure-of-arrays with the particle index
last: x (d, n),
F/U/V/A (d*d, n) row-major per particle, b_plus/b_minus (n_pairs, n),
V0 (n,). This is the layout the linearize kernel writes, so the
per-Newton parameter block needs no transposes.

On the H100 the kernel is bound by bytes; a block gathers through a
shared-memory window over its particles' nodes and scatters through a
counting sort by node there (see the source's note). BLOCK_THREADS and
WINDOW_NODES set its launch (``launch_config``: fewer threads where a
cubic stencil's slots would not fit a block's shared memory);
``window_stats``, when set to a
``new_window_stats`` buffer, collects its counters (blocks, blocks that
overflowed the window, box sizes, global atomics).

A batch of B members (``sim.simulation``'s batched step) passes every
argument with a leading member dimension: w (B, n_nodes, d), x (B, d, n),
F (B, d*d, n), V0 (B, n), and so on. The kernel takes the whole batch in one
launch, the members along the launch grid's y axis (at most
MAX_BATCH); the plain version stacks the members' grids end to end
(``transfer.particle_stencil``'s member offsets). On a batch's tile grid
(``grid.sparse``: one tile set per member, every member padded to the same
slots) each member's blocks read its own row of the (B, n_tiles) lookup.

Dispatch is by device: CPU tensors take ``fused_apply_plain``; CUDA tensors
launch the kernel or raise. The tracer's counter ``launches.fused_apply``
(``utils.timing``) counts kernel launches, one per call, whatever the
batch, none for a call with no particle.
"""

from __future__ import annotations

import math

import torch

from hot_tpu_torch.models import constitutive as cm
from hot_tpu_torch.ops import cuda_lib
from hot_tpu_torch.ops import transfer
from hot_tpu_torch.ops.bspline import kernel_width
from hot_tpu_torch.utils.timing import count

# threads per block, and the largest node box a block takes through shared
# memory: 256 threads and 1536 nodes reserve 110 KB a block in fp32 3D
# (csrc/particle_window.cuh:window_bytes), the most that keeps two blocks on
# an H100 SM, and cover the boxes of the 64^3 main path (up to 1,444 nodes);
# chosen from chip_smoke.py's sweep (PERF.md)
BLOCK_THREADS = 256
WINDOW_NODES = 1536
# the most dynamic shared memory a block may opt into on an H100 (227 KB),
# less the kernels' static shared memory
SMEM_PER_BLOCK = 227 * 1024 - 64
# the kernels' counters (csrc/particle_window.cuh:WindowStat), then a
# histogram of log2(box nodes)
STATS = ("blocks", "overflow_blocks", "window_nodes", "max_window_nodes", "global_atomics")
N_HIST = 24
# the most members a launch takes: the launch grid's y extent (gridDim.y)
MAX_BATCH = 65535

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
    """(d*d, n) SoA -> (n, d, d) view; a batch's (B, d*d, n) -> (B, n, d, d)."""
    return M.transpose(-1, -2).reshape(M.shape[:-2] + (-1, d, d))


def soa(M, lead: int = 0):
    """(n, ...) particle-major -> contiguous (prod(...), n) SoA, after
    `lead` leading dimensions (1 for a batch: (B, n, ...) -> (B, C, n))."""
    return M.flatten(lead + 1).transpose(-1, -2).contiguous()


def window_bytes(d: int, width: int, itemsize: int, threads: int, window_nodes: int,
                 per_node=None) -> int:
    """Dynamic shared memory of a launch (csrc/particle_window.cuh:window_bytes):
    the gathered window and the slots, d values a node each; with
    `per_node`, a kernel that gathers nothing and scatters per_node values a
    node (scatter_window_bytes): the slots alone."""
    s = width ** d
    gathered, slot = (d, d) if per_node is None else (0, per_node)
    return ((window_nodes * gathered + threads * s * slot) * itemsize
            + (2 * (window_nodes + 1) + threads // 32) * 4)


def launch_config(d: int, width: int, itemsize: int, per_node=None):
    """(threads, window_nodes) of a stencil kernel's launch (`per_node` as in
    window_bytes): WINDOW_NODES and the largest block, halving from
    BLOCK_THREADS, whose shared memory fits SMEM_PER_BLOCK. Only the 3D
    cubic stencil in fp64 gets fewer (64): its slots hold 64 nodes x 3
    values per particle; in fp32 its 256 threads take 222 KB, one block per
    SM."""
    threads = BLOCK_THREADS
    while window_bytes(d, width, itemsize, threads, WINDOW_NODES, per_node) > SMEM_PER_BLOCK:
        threads //= 2
    return threads, WINDOW_NODES


def stencil_of(x, dx, res, kernel: str = "quadratic", tgrid=None) -> transfer.Stencil:
    """The stencil the kernels compute from x (d, n), or a batch's
    (B, d, n): the dense grid's, or with compact ids on the tile grid
    `tgrid` (quadratic only; a batch's on the batch's tile grid)."""
    if tgrid is None:
        return transfer.particle_stencil(x.transpose(-1, -2), dx, res, kernel=kernel)
    from hot_tpu_torch.grid import sparse

    return sparse.sparse_stencil(x.transpose(-1, -2), dx, tgrid)


def fused_apply_plain(w, x, dx, res, F, U, V, A, b_plus, b_minus, V0, dt,
                      kernel: str = "quadratic", tgrid=None):
    """The unfused chain in plain PyTorch (the reference for the kernel)."""
    d = w.shape[-1]
    st = stencil_of(x, dx, res, kernel, tgrid)
    Fp = aos_mat(F, d)
    ctx = cm.HessianContext(U=aos_mat(U, d), V=aos_mat(V, d), A=aos_mat(A, d),
                            b_plus=b_plus.transpose(-1, -2), b_minus=b_minus.transpose(-1, -2))
    grad_w = transfer.velocity_gradient(st, w)
    dP = cm.apply_hessian(ctx, dt * (grad_w @ Fp))
    return transfer.scatter_force(st, dP @ Fp.transpose(-1, -2), V0, w.shape[-2])


def batch_of(grid_vec) -> int:
    """Members of a launch: the leading dimension of a batch's (B, n_nodes,
    d) grid vector, 1 for one (n_nodes, d); at most MAX_BATCH."""
    if grid_vec.ndim not in (2, 3):
        raise ValueError(f"a grid vector is (n_nodes, d) or (B, n_nodes, d), got "
                         f"{tuple(grid_vec.shape)}")
    batch = grid_vec.shape[0] if grid_vec.ndim == 3 else 1
    if not 1 <= batch <= MAX_BATCH:
        raise ValueError(f"a launch takes 1 to {MAX_BATCH} members, got {batch}")
    return batch


def param_specs(grid_vec, x, res, tgrid=None, kernel: str = "quadratic", per_node=None,
                **params):
    """check_inputs specs for a stencil kernel's arguments: the grid vector
    (n_nodes, d) over res (the tile grid's (n_cnodes, d) with `tgrid`), or
    (n_nodes, per_node) for `per_node` values a node, x (d, n), the
    per-particle SoA arrays and the tile lookup; every shape with the grid
    vector's leading member dimension in a batch.
    Node offsets inside a member are 32-bit; the kernels offset each
    member's base pointers in 64 bits."""
    d = grid_vec.shape[-1] if per_node is None else x.shape[-2]
    per_node = d if per_node is None else per_node
    n = x.shape[-1]
    lead = tuple(grid_vec.shape[:-2])
    batch_of(grid_vec)
    if d not in (2, 3) or len(res) != d:
        raise ValueError(f"need a 2D or 3D grid, got d={d}, res={tuple(res)}")
    if tgrid is not None and (tgrid.batch or 1) != batch_of(grid_vec):
        raise ValueError(f"a tile grid of {tgrid.batch} members for a launch of "
                         f"{batch_of(grid_vec)}")
    n_nodes = math.prod(int(r) for r in res)
    if tgrid is not None:
        if tuple(tgrid.res) != tuple(res) or kernel_width(kernel) != 3:
            raise ValueError(f"the tile grid of res {tgrid.res} takes the quadratic stencil "
                             f"on that grid, got {kernel} on {tuple(res)}")
        tiled = math.prod(r * tgrid.tile for r in tgrid.tile_res)
        if max(tgrid.n_cnodes, tiled) * per_node >= 2 ** 31:
            raise ValueError(f"tile grid {tuple(res)} too large for 32-bit node offsets")
    elif n_nodes * per_node >= 2 ** 31:
        raise ValueError(f"grid {tuple(res)} too large for 32-bit node offsets")
    rows = {"F": d * d, "U": d * d, "V": d * d, "A": d * d,
            "b_plus": 1 if d == 2 else 3, "b_minus": 1 if d == 2 else 3}
    specs = [("grid vector", grid_vec,
              lead + (n_nodes if tgrid is None else tgrid.n_cnodes, per_node), grid_vec.dtype),
             ("x", x, lead + (d, n), grid_vec.dtype)]
    if tgrid is not None:
        specs.append(("tile lookup", tgrid.lookup, lead + (tgrid.n_tiles_logical,),
                      torch.int32))
    for name, t in params.items():
        specs.append((name, t, lead + ((rows[name], n) if name in rows else (n,)),
                      grid_vec.dtype))
    return specs


def launch_args(ref, width, threads, window_nodes, stats):
    """(threads, window_nodes, stats pointer or None) of a stencil kernel's
    launch: ``launch_config``'s unless given."""
    if stats is not None:
        cuda_lib.check_inputs(ref, [("window_stats", stats, (len(STATS) + N_HIST,),
                                     torch.int64)])
    default_threads, default_nodes = launch_config(ref.shape[-1], width, ref.element_size())
    return (default_threads if threads is None else threads,
            default_nodes if window_nodes is None else window_nodes,
            None if stats is None else stats.data_ptr())


def lookup_args(tgrid):
    """(lookup pointer or None, tile) of a stencil kernel's node addressing."""
    return (None, 0) if tgrid is None else (tgrid.lookup.data_ptr(), tgrid.tile)


def fused_apply_cuda(w, x, dx, res, F, U, V, A, b_plus, b_minus, V0, dt,
                     kernel: str = "quadratic", tgrid=None, threads=None, window_nodes=None):
    """Launch the CUDA kernel (CUDA tensors only), once for the whole batch."""
    params = dict(F=F, U=U, V=V, A=A, b_plus=b_plus, b_minus=b_minus, V0=V0)
    cuda_lib.check_inputs(w, param_specs(w, x, res, tgrid, kernel, **params))
    width = kernel_width(kernel)
    lib = cuda_lib.load()
    df = torch.zeros_like(w)
    rc = lib.hot_fused_apply(
        cuda_lib.dtype_code(w), w.shape[-1], width, w.data_ptr(), x.data_ptr(), float(dx),
        cuda_lib.int_array(res), *lookup_args(tgrid),
        *(t.data_ptr() for t in params.values()), float(dt),
        df.data_ptr(), x.shape[-1], w.shape[-2], batch_of(w),
        *launch_args(w, width, threads, window_nodes, window_stats),
        cuda_lib.stream_ptr(w.device))
    cuda_lib.check(rc, "fused_apply")
    # the C entry launches nothing for no particles
    count("launches.fused_apply", int(x.shape[-1] > 0))
    return df


def fused_apply(w, x, dx, res, F, U, V, A, b_plus, b_minus, V0, dt, kernel: str = "quadratic",
                tgrid=None):
    """df (n_nodes, d) for grid direction w, a batch's (B, n_nodes, d) for
    (B, n_nodes, d) (see the module doc)."""
    args = (w, x, dx, res, F, U, V, A, b_plus, b_minus, V0, dt, kernel, tgrid)
    if w.device.type == "cpu":
        return fused_apply_plain(*args)
    if w.device.type != "cuda":
        raise ValueError(f"fused_apply runs on cpu or cuda tensors, not {w.device}")
    return fused_apply_cuda(*args)
