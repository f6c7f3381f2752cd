"""The CUDA sources of hot_tpu_torch/csrc compiled for the host with g++,
against the kernels' plain PyTorch versions.

A small stand-in for the CUDA runtime (SHIM) turns each launch into host
code, so the kernels' own code runs on the CPU at 16^3 / 24^2:

  * the particle kernels (launched with dynamic shared memory, on a grid of
    blocks by batch members, blockIdx.y the member) run each block's
    threads at once, one std::thread each; __syncthreads is a
    std::barrier, __shared__ data is function-static (blocks run one after
    another, so it is block-shared), the dynamic shared memory is the
    block's buffer, atomics go through std::atomic_ref, and the warp
    reductions (__reduce_*_sync) and shuffles (__shfl_up_sync,
    __shfl_sync) meet at the block barrier, since the kernels call them
    with every thread of the block;
  * the SpMV runs blocks and lanes one after another, and its warp shuffles
    are emulated for that order (see SHIM).

The particle kernels are checked in lattice order (every block through its
shared-memory window), with half the particles permuted under a small window
budget (both branches in one launch, with the window counters checked
against boxes computed here), and with the particles moved into the clamped
boundary band; with the quadratic and the cubic stencil (the width is a
template parameter), and for the four model codes of the linearize. This
cannot show that nvcc accepts the sources or that they are right on the
card; chip_smoke.py and the `cuda`-marked tests do that.

Tolerances are relative to the plain result's largest entry: 1e-10 in fp64
(summation order only) and 2e-5 in fp32, as chip_smoke.py states them.
"""

import ctypes
import re
import shutil
import subprocess

import pytest
import torch

from hot_tpu_torch.grid import sparse
from hot_tpu_torch.models import constitutive as cm
from hot_tpu_torch.models.constitutive import MODEL_REGISTRY
from hot_tpu_torch.ops import cuda_lib
from hot_tpu_torch.ops import fused_apply as fa
from hot_tpu_torch.ops import fused_block_diag as fbd
from hot_tpu_torch.ops.bspline import kernel_width
from hot_tpu_torch.ops.bsr_spmv import bsr_spmv_plain
from hot_tpu_torch.ops import fused_linearize as fl
from hot_tpu_torch.scenes import build_scene

SHIM = r"""
#pragma once
#include <array>
#include <atomic>
#include <barrier>
#include <bit>
#include <climits>
#include <thread>
#include <vector>
struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3() = default;
  dim3(unsigned x_, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};
inline thread_local dim3 blockIdx{0, 0, 0}, threadIdx{0, 0, 0}, blockDim, gridDim;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __shared__ static
#define __align__(x) alignas(x)
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline int cudaGetLastError() { return 0; }
template <typename F> inline int cudaFuncSetAttribute(F, int, int) { return 0; }
template <typename T> inline T __ldg(const T* p) { return *p; }
inline int __clz(int x) { return x == 0 ? 32 : __builtin_clz((unsigned)x); }
template <typename T> inline T atomicAdd(T* p, T v) {
  return std::atomic_ref<T>(*p).fetch_add(v);
}
template <typename T> inline T atomicCAS(T* p, T expected, T desired) {
  std::atomic_ref<T>(*p).compare_exchange_strong(expected, desired);
  return expected;
}
inline unsigned __float_as_uint(float v) { return std::bit_cast<unsigned>(v); }
inline float __uint_as_float(unsigned b) { return std::bit_cast<float>(b); }
inline long long __double_as_longlong(double v) { return std::bit_cast<long long>(v); }
inline double __longlong_as_double(long long b) { return std::bit_cast<double>(b); }
template <typename T> inline T atomicMin(T* p, T v) {
  std::atomic_ref<T> r(*p);
  T old = r.load();
  while (v < old && !r.compare_exchange_weak(old, v)) {}
  return old;
}
template <typename T> inline T atomicMax(T* p, T v) {
  std::atomic_ref<T> r(*p);
  T old = r.load();
  while (v > old && !r.compare_exchange_weak(old, v)) {}
  return old;
}

// One block of the concurrent launch: its barrier, warp-reduction slots and
// dynamic shared memory.
struct HostBlock {
  struct alignas(16) Chunk { unsigned char b[16]; };
  HostBlock(unsigned threads, size_t smem)
      : bar(threads), slots(threads), smem((smem + 15) / 16) {}
  std::barrier<> bar;
  std::vector<long long> slots;
  std::vector<Chunk> smem;
};
inline thread_local HostBlock* host_block = nullptr;
inline void __syncthreads() { host_block->bar.arrive_and_wait(); }
inline unsigned char* host_dynamic_smem() {
  return reinterpret_cast<unsigned char*>(host_block->smem.data());
}
// Every thread of the block reaches a warp reduction together (the kernels
// call them in uniform control flow), so the block barrier stands in for
// the warp's: write, wait, read the warp's 32 slots, wait.
template <typename T, typename Op> inline T host_warp_reduce(T v, Op op) {
  HostBlock& b = *host_block;
  b.slots[threadIdx.x] = (long long)v;
  b.bar.arrive_and_wait();
  const unsigned first = threadIdx.x / 32 * 32;
  T r = (T)b.slots[first];
  for (unsigned l = first + 1; l < first + 32; ++l) r = op(r, (T)b.slots[l]);
  b.bar.arrive_and_wait();
  return r;
}
inline int __reduce_min_sync(unsigned, int v) {
  return host_warp_reduce(v, [](int a, int b) { return a < b ? a : b; });
}
inline int __reduce_max_sync(unsigned, int v) {
  return host_warp_reduce(v, [](int a, int b) { return a > b ? a : b; });
}
inline unsigned __reduce_add_sync(unsigned, unsigned v) {
  return host_warp_reduce(v, [](unsigned a, unsigned b) { return a + b; });
}
// Shuffles of the concurrent launches, through the same write, wait, read.
template <typename Src> inline int host_warp_shuffle(int v, Src src_lane) {
  HostBlock& b = *host_block;
  b.slots[threadIdx.x] = v;
  b.bar.arrive_and_wait();
  const int src = src_lane(threadIdx.x % 32);
  const int r = src < 0 ? v : (int)b.slots[threadIdx.x / 32 * 32 + src];
  b.bar.arrive_and_wait();
  return r;
}
inline int __shfl_up_sync(unsigned, int v, int delta) {
  return host_warp_shuffle(v, [delta](int lane) { return lane >= delta ? lane - delta : -1; });
}
inline int __shfl_sync(unsigned, int v, int src) {
  return host_warp_shuffle(v, [src](int) { return src; });
}

// Sequential launches (the SpMV): lanes run one after another, so a shuffle
// returns what the partner lane passed at the same call if that lane has
// already run (a lower lane), and stale data otherwise. After an xor
// butterfly the LAST lane holds the full sum (its partners at every step are
// lower lanes), so kernels store from it.
inline thread_local int shfl_calls = 0;
template <typename T> inline T __shfl_xor_sync(unsigned, T v, int mask) {
  static std::vector<std::array<T, 32>> slots;
  const unsigned lane = threadIdx.x % 32, call = shfl_calls++;
  if (slots.size() <= call) slots.resize(call + 1);
  slots[call][lane] = v;
  return slots[call][lane ^ mask];
}
template <typename Fn, typename... Args>
inline void host_launch(unsigned blocks, unsigned threads, Fn fn, Args... args) {
  blockDim.x = threads;
  for (unsigned b = 0; b < blocks; ++b) {
    blockIdx.x = b;
    for (unsigned t = 0; t < threads; ++t) { threadIdx.x = t; shfl_calls = 0; fn(args...); }
  }
}
// Concurrent launches (the particle kernels): a block's threads at once,
// blocks one after another, the grid's y rows (batch members) in turn.
template <typename Fn, typename... Args>
inline void host_launch_block(dim3 blocks, unsigned threads, size_t smem, Fn fn,
                              Args... args) {
  for (unsigned by = 0; by < blocks.y; ++by)
    for (unsigned b = 0; b < blocks.x; ++b) {
      HostBlock blk(threads, smem);
      std::vector<std::thread> pool;
      for (unsigned t = 0; t < threads; ++t)
        pool.emplace_back([&, t] {
          blockDim = dim3(threads);
          gridDim = blocks;
          blockIdx = dim3(b, by, 0);
          threadIdx = dim3(t, 0, 0);
          host_block = &blk;
          fn(args...);
        });
      for (auto& th : pool) th.join();
    }
}
"""
LAUNCHES = [(re.compile(r"(\w+<[^<>]*>)<<<blocks, kThreads, 0, stream>>>\("),
             r"host_launch(blocks, kThreads, \1, "),
            (re.compile(r"(\w+<[^<>]*>)<<<blocks, threads, smem, stream>>>\("),
             r"host_launch_block(blocks, threads, smem, \1, ")]
DYNAMIC_SMEM = re.compile(r"extern __shared__ __align__\(16\) unsigned char (\w+)\[\];")
TOL = {torch.float32: (2e-5, 2e-5), torch.float64: (1e-10, 1e-10)}
DT = 2e-3
N_STATS = len(fa.STATS) + fa.N_HIST


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    out = tmp_path_factory.mktemp("csrc_host")
    (out / "cuda_runtime.h").write_text(SHIM)
    for header in cuda_lib.CSRC.glob("*.cuh"):
        shutil.copy(header, out)
    cpps = []
    for cu in sorted(cuda_lib.CSRC.glob("*.cu")):
        text = DYNAMIC_SMEM.sub(r"unsigned char* \1 = host_dynamic_smem();", cu.read_text())
        n = 0
        for pattern, repl in LAUNCHES:
            text, k = pattern.subn(repl, text)
            n += k
        assert n == 1, f"{cu.name}: expected one kernel launch, found {n}"
        cpps.append(out / (cu.stem + ".cpp"))
        cpps[-1].write_text(text)
    lib_path = out / "libhost.so"
    subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                    "-Wno-unknown-pragmas", "-I", str(out), "-o", str(lib_path),
                    *map(str, cpps)], check=True, timeout=600)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in cuda_lib._SIGNATURES.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    return lib


SMALL = {3: ("twisting_bar_3d", dict(res=16, ppc=2)), 2: ("block_drop_2d", dict(res=24))}


def _inputs(d, dtype, rng, name=None, kw=None, noise=0.1):
    """Grid velocity, particle arrays (SoA) and grid of a small scene, F
    perturbed by seeded noise."""
    name, kw = (name, kw) if name else SMALL[d]
    state = build_scene(name, device="cpu", dtype=dtype, **kw)["state"]
    res = (kw["res"],) * d
    n = state.n
    F = state.F + torch.as_tensor(noise * rng.standard_normal((n, d, d)), dtype=dtype)
    v = torch.as_tensor(rng.standard_normal((kw["res"] ** d, d)), dtype=dtype)
    return dict(v=v, x=state.x.clone(), F=F, mu=state.mu, lam=state.lam, V0=state.V0,
                dx=1.0 / kw["res"], res=res)


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_kernels(host_lib, c, model_name, dtype, threads=128,
                   window_nodes=fa.WINDOW_NODES, stats=(None, None), project=True,
                   kernel="quadratic", tgrid=None):
    """Both host-compiled kernels against their plain versions on inputs c
    (grid vectors on the compact nodes of the tile grid `tgrid` if given)."""
    model = MODEL_REGISTRY[model_name]
    width = kernel_width(kernel)
    x = fa.soa(c["x"])
    F = fa.soa(c["F"])
    d, n = x.shape
    n_pairs = 1 if d == 2 else 3
    f = torch.zeros_like(c["v"])
    U, V, A = (torch.empty((d * d, n), dtype=dtype) for _ in range(3))
    bp, bm = (torch.empty((n_pairs, n), dtype=dtype) for _ in range(2))
    code = 0 if dtype == torch.float32 else 1
    res = cuda_lib.int_array(c["res"])
    lookup = (None, 0) if tgrid is None else (_ptr(tgrid.lookup), tgrid.tile)
    rc = host_lib.hot_fused_linearize(
        fl.MODEL_CODES[model_name], code, d, width, _ptr(c["v"]), _ptr(x), c["dx"], res, *lookup,
        _ptr(F),
        _ptr(c["mu"]), _ptr(c["lam"]), _ptr(c["V0"]), DT, int(project), _ptr(f), _ptr(U),
        _ptr(V), _ptr(A), _ptr(bp), _ptr(bm), n, c["v"].shape[0], 1, threads, window_nodes,
        _ptr(stats[0]), None)
    assert rc == 0
    want = fl.fused_linearize_plain(c["v"], x, c["dx"], c["res"], F, c["mu"], c["lam"],
                                    c["V0"], DT, model, project, kernel, tgrid)
    tol_lin, tol_apply = TOL[dtype]
    for got, ref in zip((f, A, bp, bm), (want[0], want[3], want[4], want[5])):
        assert _rel(got, ref) <= tol_lin
    eps = torch.finfo(dtype).eps
    eye = torch.eye(d, dtype=dtype)
    for M in (U, V):
        M = M.T.reshape(n, d, d)
        assert float((M.transpose(1, 2) @ M - eye).abs().max()) <= 50 * eps
        assert float((torch.linalg.det(M) - 1).abs().max()) <= 50 * eps

    w = torch.randn(c["v"].shape, dtype=dtype, generator=torch.Generator().manual_seed(1))
    df = torch.zeros_like(w)
    ctx = want[1:]
    rc = host_lib.hot_fused_apply(code, d, width, _ptr(w), _ptr(x), c["dx"], res, *lookup,
                                  _ptr(F), *map(_ptr, ctx), _ptr(c["V0"]), DT, _ptr(df), n,
                                  w.shape[0], 1, threads, window_nodes, _ptr(stats[1]), None)
    assert rc == 0
    assert _rel(df, fa.fused_apply_plain(w, x, c["dx"], c["res"], F, *ctx, c["V0"], DT,
                                         kernel, tgrid)) <= tol_apply
    if tgrid is not None:
        # nothing lands in the dump row
        assert float(f[tgrid.dump].abs().max()) == 0 and float(df[tgrid.dump].abs().max()) == 0


def _boxes(x, dx, res, threads, width=3):
    """Each block's node-box size, as the kernels' window reduction forms it."""
    base = (torch.floor(x / dx - 0.5) if width == 3 else torch.floor(x / dx) - 1).long()
    hi = torch.tensor(res) - 1
    lo = torch.minimum(base.clamp(min=0), hi)
    top = torch.minimum((base + width - 1).clamp(min=0), hi)
    return [int((top[i:i + threads].max(0).values - lo[i:i + threads].min(0).values + 1).prod())
            for i in range(0, x.shape[0], threads)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("model_name", ["fixed_corotated", "stvk_hencky"])
@pytest.mark.parametrize("d", [2, 3])
def test_host_compiled_kernels_match_plain(host_lib, rng, d, model_name, dtype):
    _check_kernels(host_lib, _inputs(d, dtype, rng), model_name, dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("model_name", ["fixed_corotated", "stvk_hencky"])
@pytest.mark.parametrize("d", [2, 3])
def test_host_compiled_kernels_indefinite_hessian(host_lib, rng, d, model_name, dtype):
    """F perturbed by 0.5: a share of the particles has an indefinite
    sym(A), so the linearize runs its clamp eigensolve for some particles
    and skips it for the rest."""
    c = _inputs(d, dtype, rng, noise=0.5)
    model = MODEL_REGISTRY[model_name]
    ctx = cm.hessian_context(model, c["F"], c["mu"], c["lam"], project=False)
    sym = 0.5 * (ctx.A + ctx.A.transpose(1, 2))
    indefinite = torch.linalg.eigvalsh(sym).min(1).values <= 0
    assert 0 < int(indefinite.sum()) < indefinite.numel()
    _check_kernels(host_lib, c, model_name, dtype)


@pytest.mark.parametrize("model_name", ["fixed_corotated", "stvk_hencky"])
@pytest.mark.parametrize("d", [2, 3])
def test_host_compiled_kernels_unprojected_heterogeneous(host_lib, rng, d, model_name):
    """The linearize's project=False branch (MINRES runs with it) on F
    perturbed by 0.5, with per-particle Young's moduli spread over four
    decades (the stacked boxes' 1e4..1e8), in fp64: the unclamped A and
    b+- must be the plain version's, indefinite entries included."""
    c = _inputs(d, torch.float64, rng, noise=0.5)
    E = 10.0 ** torch.as_tensor(rng.uniform(4.0, 8.0, c["x"].shape[0]))
    c["mu"], c["lam"] = cm.lame_parameters(E, 0.3)
    ctx = cm.hessian_context(MODEL_REGISTRY[model_name], c["F"], c["mu"], c["lam"],
                             project=False)
    assert bool((ctx.b_minus < 0).any() | (ctx.b_plus < 0).any())
    _check_kernels(host_lib, c, model_name, torch.float64, project=False)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("model_name", ["neo_hookean", "linear_corotated"])
@pytest.mark.parametrize("d", [2, 3])
def test_host_compiled_kernels_new_models(host_lib, rng, d, model_name, dtype):
    """Model codes 2 (Neo-Hookean) and 3 (linear corotated) of the
    linearize, quadratic stencil."""
    _check_kernels(host_lib, _inputs(d, dtype, rng), model_name, dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("model_name", list(fl.MODEL_CODES))
@pytest.mark.parametrize("d", [2, 3])
def test_host_compiled_cubic_kernels_match_plain(host_lib, rng, d, model_name, dtype):
    """The 4-wide (cubic) instances of both kernels, every model."""
    _check_kernels(host_lib, _inputs(d, dtype, rng), model_name, dtype, kernel="cubic")


def _on_tile_grid(c, rng):
    """c with its grid velocity on the compact nodes of the particles' tile
    grid; returns the grid."""
    tgrid = sparse.build_tile_grid(c["x"], c["dx"], c["res"], capacity=10 ** 6)
    c["v"] = torch.as_tensor(rng.standard_normal((tgrid.n_cnodes, len(c["res"]))),
                             dtype=c["v"].dtype)
    return tgrid


def _check_permuted(host_lib, rng, dtype, width, compact=False):
    """The second half of the particles permuted at random, 64-thread blocks
    and a window budget that the lattice-ordered blocks fit: the permuted
    blocks take the global-atomic branch of the same launch. Both kernels
    count the blocks, overflows, box sizes and atomics computed here. With
    `compact`, the grid vectors are on the tile grid's compact nodes."""
    c = _inputs(3, dtype, rng, "twisting_bar_3d", dict(res=16, ppc=8))
    n, threads = c["x"].shape[0], 64
    tail = torch.arange(n // 2, n)
    perm = torch.cat([torch.arange(n // 2), tail[torch.from_numpy(rng.permutation(len(tail)))]])
    for key in ("x", "F", "mu", "lam", "V0"):
        c[key] = c[key][perm].contiguous()
    tgrid = _on_tile_grid(c, rng) if compact else None
    boxes = _boxes(c["x"], c["dx"], c["res"], threads, width)
    budget = max(boxes[:(n // 2) // threads])
    over = [b for b in boxes if b > budget]
    assert 0 < len(over) < len(boxes)
    stats = (torch.zeros(N_STATS, dtype=torch.int64), torch.zeros(N_STATS, dtype=torch.int64))
    _check_kernels(host_lib, c, "fixed_corotated", dtype, threads, budget, stats,
                   kernel="cubic" if width == 4 else "quadratic", tgrid=tgrid)
    for buf in stats:
        got = fa.read_window_stats(buf)
        assert (got["blocks"], got["overflow_blocks"]) == (len(boxes), len(over))
        assert (got["window_nodes"], got["max_window_nodes"]) == (sum(boxes), max(boxes))
        assert sum(got["log2_nodes_histogram"].values()) == len(boxes)
        # the permuted blocks take 3 W^3 global atomics per particle (81, cubic
        # 192); the windowed ones one per non-zero box entry, at most 3 per
        # box node
        direct = 3 * width ** 3 * sum(min(threads, n - i * threads)
                                      for i, b in enumerate(boxes) if b > budget)
        assert direct < got["global_atomics"] <= direct + 3 * sum(b for b in boxes
                                                                  if b <= budget)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_host_compiled_kernels_permuted_order(host_lib, rng, dtype):
    """Half the particles in a random order (see _check_permuted)."""
    _check_permuted(host_lib, rng, dtype, 3)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_host_compiled_cubic_kernels_permuted_order(host_lib, rng, dtype):
    """The same with the cubic stencil: a box one node wider per axis."""
    _check_permuted(host_lib, rng, dtype, 4)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("d", [2, 3])
def test_host_compiled_kernels_compact_ids(host_lib, rng, d, dtype):
    """Both kernels on the tile grid's compact node ids, lattice order: the
    box load and the flush through the tile lookup, a run of a row per
    thread."""
    c = _inputs(d, dtype, rng)
    tgrid = _on_tile_grid(c, rng)
    assert tgrid.n_cnodes < torch.tensor(c["res"]).prod()
    stats = (torch.zeros(N_STATS, dtype=torch.int64), torch.zeros(N_STATS, dtype=torch.int64))
    _check_kernels(host_lib, c, "fixed_corotated", dtype, stats=stats, tgrid=tgrid)
    for buf in stats:
        got = fa.read_window_stats(buf)
        assert got["blocks"] > 0 and got["overflow_blocks"] < got["blocks"]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_host_compiled_kernels_compact_ids_permuted(host_lib, rng, dtype):
    """Compact ids with half the particles permuted (see _check_permuted):
    the global-atomic branch addresses the compact nodes through the
    lookup, the windowed blocks through their runs."""
    _check_permuted(host_lib, rng, dtype, 3, compact=True)


@pytest.mark.parametrize("d", [2, 3])
def test_host_compiled_kernels_compact_inactive_tiles(host_lib, rng, d):
    """Each block holds two clusters of particles at opposite corners of the
    grid, so its node box spans tiles that no stencil touches: those box
    nodes read 0 and are never written (the dump row stays 0), and every
    block still goes through its window."""
    res_n, per = (32, 16) if d == 2 else (16, 16)
    dx = 1.0 / res_n
    lo = torch.as_tensor(rng.uniform(5 * dx, 7 * dx, (per, d)))
    hi = torch.as_tensor(rng.uniform((res_n - 7) * dx, (res_n - 5) * dx, (per, d)))
    x = torch.cat([torch.cat([lo, hi]) + 0.01 * k * dx for k in range(4)])
    n = x.shape[0]
    c = dict(x=x, F=torch.eye(d, dtype=torch.float64) + torch.as_tensor(
        0.1 * rng.standard_normal((n, d, d))), mu=torch.full((n,), 30.0, dtype=torch.float64),
        lam=torch.full((n,), 50.0, dtype=torch.float64),
        V0=torch.as_tensor(rng.uniform(0.5, 1.5, n)),
        v=torch.zeros((1, d), dtype=torch.float64), dx=dx, res=(res_n,) * d)
    tgrid = _on_tile_grid(c, rng)
    box = (int(torch.floor(hi.max(0).values / dx + 1.5).max())
           - int(torch.floor(lo.min(0).values / dx - 0.5).min()) + 1) ** d
    assert tgrid.n_active < tgrid.n_tiles_logical and (tgrid.lookup < 0).any()
    stats = (torch.zeros(N_STATS, dtype=torch.int64), torch.zeros(N_STATS, dtype=torch.int64))
    _check_kernels(host_lib, c, "fixed_corotated", torch.float64, threads=2 * per,
                   window_nodes=box, stats=stats, tgrid=tgrid)
    for buf in stats:
        got = fa.read_window_stats(buf)
        assert got["overflow_blocks"] == 0 and got["max_window_nodes"] > tgrid.n_cnodes // 2


@pytest.mark.parametrize("d", [2, 3])
def test_host_compiled_kernels_boundary_band(host_lib, rng, d):
    """Particles moved into the clamped band at both ends of the grid (the
    cloud's low corner 0.1 dx from node 0 on axis 0, its high end 0.1 dx
    from the top on axis 1), in lattice order: clamped stencils repeat node
    ids inside the window and must sum as particle_stencil's do."""
    c = _inputs(d, torch.float64, rng)
    x, dx, top = c["x"], c["dx"], c["res"][1] * c["dx"]
    x[:, 0] += 0.1 * dx - x[:, 0].min()
    x[:, 1] += top - 0.1 * dx - x[:, 1].max()
    base = torch.floor(x / dx - 0.5)
    assert bool((base[:, 0] < 0).any()) and bool((base[:, 1] + 2 > c["res"][1] - 1).any())
    stats = (None, torch.zeros(N_STATS, dtype=torch.int64))
    _check_kernels(host_lib, c, "fixed_corotated", torch.float64, stats=stats)
    assert fa.read_window_stats(stats[1])["overflow_blocks"] == 0


@pytest.mark.parametrize("d", [2, 3])
def test_host_compiled_cubic_kernels_boundary_band(host_lib, rng, d):
    """The clamped band with the cubic stencil, whose base floor(x/dx) - 1
    clamps one node further in, Neo-Hookean."""
    c = _inputs(d, torch.float64, rng)
    x, dx, top = c["x"], c["dx"], c["res"][1] * c["dx"]
    x[:, 0] += 0.1 * dx - x[:, 0].min()
    x[:, 1] += top - 1.1 * dx - x[:, 1].max()
    base = torch.floor(x / dx) - 1
    assert bool((base[:, 0] < 0).any()) and bool((base[:, 1] + 3 > c["res"][1] - 1).any())
    _check_kernels(host_lib, c, "neo_hookean", torch.float64, kernel="cubic")


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("d,K", [(3, 125), (3, 729), (2, 25), (2, 81)])
def test_host_compiled_bsr_spmv_matches_plain(host_lib, rng, d, K, dtype):
    """Rows of K blocks (K not a multiple of the warp: tail lanes), about a
    third of the columns absent, and a row count that is not a multiple of
    the four warps of a block."""
    R = 1003
    vals = torch.as_tensor(rng.standard_normal((R, K, d, d)), dtype=dtype)
    col = rng.integers(0, R, (R, K))
    col[rng.random((R, K)) < 0.3] = -1
    col_row = torch.as_tensor(col, dtype=torch.int32)
    x = torch.as_tensor(rng.standard_normal((R, d)), dtype=dtype)
    y = torch.full((R, d), float("nan"), dtype=dtype)
    code = 0 if dtype == torch.float32 else 1
    rc = host_lib.hot_bsr_spmv(code, d, vals.data_ptr(), col_row.data_ptr(), x.data_ptr(),
                               y.data_ptr(), R, K, None)
    assert rc == 0
    assert _rel(y, bsr_spmv_plain(vals, col_row, x)) <= TOL[dtype][0]


def test_unsupported_dim_is_refused(host_lib):
    z = torch.zeros(1)
    p = z.data_ptr()
    res = cuda_lib.int_array((1, 1, 1))
    assert host_lib.hot_fused_apply(0, 4, 3, p, p, 1.0, res, None, 0, *[p] * 7, DT, p, 1, 1, 1,
                                    128, 0, None, None) != 0
    assert host_lib.hot_fused_apply(0, 3, 3, p, p, 1.0, res, None, 0, *[p] * 7, DT, p, 1, 1, 1,
                                    100, 0, None, None) != 0
    assert host_lib.hot_fused_apply(0, 3, 5, p, p, 1.0, res, None, 0, *[p] * 7, DT, p, 1, 1, 1,
                                    128, 0, None, None) != 0
    assert host_lib.hot_fused_linearize(7, 0, 3, 3, p, p, 1.0, res, None, 0, *[p] * 4, DT, 1,
                                        *[p] * 6, 1, 1, 1, 128, 0, None, None) != 0
    assert host_lib.hot_fused_linearize(0, 0, 3, 2, p, p, 1.0, res, None, 0, *[p] * 4, DT, 1,
                                        *[p] * 6, 1, 1, 1, 128, 0, None, None) != 0
    # a tile lookup needs a tile size, and the quadratic stencil
    assert host_lib.hot_fused_apply(0, 3, 3, p, p, 1.0, res, p, 0, *[p] * 7, DT, p, 1, 1, 1,
                                    128, 0, None, None) != 0
    assert host_lib.hot_fused_apply(0, 3, 4, p, p, 1.0, res, p, 4, *[p] * 7, DT, p, 1, 1, 1,
                                    128, 0, None, None) != 0
    assert host_lib.hot_fused_linearize(0, 0, 3, 4, p, p, 1.0, res, p, 4, *[p] * 4, DT, 1,
                                        *[p] * 6, 1, 1, 1, 128, 0, None, None) != 0
    # a batch of 1 to 65535 members (the launch grid's y extent)
    for batch in (0, 65536):
        assert host_lib.hot_fused_apply(0, 3, 3, p, p, 1.0, res, None, 0, *[p] * 7, DT, p, 1, 1,
                                        batch, 128, 0, None, None) != 0
        assert host_lib.hot_fused_linearize(0, 0, 3, 3, p, p, 1.0, res, None, 0, *[p] * 4, DT,
                                            1, *[p] * 6, 1, 1, batch, 128, 0, None,
                                            None) != 0
    assert host_lib.hot_bsr_spmv(0, 4, *[z.data_ptr()] * 4, 1, 125, None) != 0
    # the block-diagonal kernel: dim, block, width, a lookup without a tile
    # size or with the cubic stencil, and the batch
    for dim, width, lookup, tile, threads, batch in ((4, 3, None, 0, 128, 1),
                                                     (3, 3, None, 0, 100, 1),
                                                     (3, 5, None, 0, 128, 1), (3, 3, p, 0, 128, 1),
                                                     (3, 4, p, 4, 128, 1), (3, 3, None, 0, 128, 0),
                                                     (3, 3, None, 0, 128, 65536)):
        assert host_lib.hot_fused_block_diag(0, dim, width, p, 1.0, res, lookup, tile, *[p] * 7,
                                             DT, p, 1, 1, batch, threads, 0, None, None) != 0


def _launch_pair(host_lib, c, model_name, width, batch, nodes, stats, tgrid=None):
    """The linearize, then the apply on its context, as launched for one
    member (batch 1) or a stacked batch (on the compact nodes of `tgrid` if
    given); returns (f, U, V, A, b+, b-, df)."""
    x, F, v = c["x"], c["F"], c["v"]
    d, n = x.shape[-2], x.shape[-1]
    lead = x.shape[:-2]
    n_pairs = 1 if d == 2 else 3
    f = torch.zeros_like(v)
    U, V, A = (torch.empty(lead + (d * d, n), dtype=v.dtype) for _ in range(3))
    bp, bm = (torch.empty(lead + (n_pairs, n), dtype=v.dtype) for _ in range(2))
    code = 0 if v.dtype == torch.float32 else 1
    res = cuda_lib.int_array(c["res"])
    lookup = (None, 0) if tgrid is None else (_ptr(tgrid.lookup), tgrid.tile)
    rc = host_lib.hot_fused_linearize(
        fl.MODEL_CODES[model_name], code, d, width, _ptr(v), _ptr(x), c["dx"], res, *lookup,
        _ptr(F), _ptr(c["mu"]), _ptr(c["lam"]), _ptr(c["V0"]), DT, 1, _ptr(f), _ptr(U),
        _ptr(V), _ptr(A), _ptr(bp), _ptr(bm), n, nodes, batch, 128, fa.WINDOW_NODES,
        _ptr(stats[0]), None)
    assert rc == 0
    df = torch.zeros_like(c["w"])
    rc = host_lib.hot_fused_apply(code, d, width, _ptr(c["w"]), _ptr(x), c["dx"], res, *lookup,
                                  _ptr(F), *map(_ptr, (U, V, A, bp, bm)), _ptr(c["V0"]), DT,
                                  _ptr(df), n, nodes, batch, 128, fa.WINDOW_NODES,
                                  _ptr(stats[1]), None)
    assert rc == 0
    return f, U, V, A, bp, bm, df


@pytest.mark.parametrize("kernel", ["quadratic", "cubic"])
@pytest.mark.parametrize("d", [2, 3])
def test_host_compiled_kernels_batched_launch(host_lib, rng, d, kernel):
    """Three members in one launch (blockIdx.y the member; fp64): each
    member's particles jittered by up to 0.2 dx, with its own F noise,
    stiffness and grid vectors. Every output equals three single launches
    to 1e-12 of its largest entry (the scatter's atomics may sum in another
    order), and the window counters sum over the members."""
    width, members = kernel_width(kernel), []
    for k in range(3):
        c = _inputs(d, torch.float64, rng)
        c["x"] = fa.soa(c["x"] + torch.as_tensor(rng.uniform(-0.2, 0.2, c["x"].shape)) * c["dx"])
        c["F"] = fa.soa(c["F"])
        c["mu"], c["lam"] = c["mu"] * 10.0 ** k, c["lam"] * 10.0 ** k
        c["w"] = torch.as_tensor(rng.standard_normal(c["v"].shape))
        members.append(c)
    nodes = members[0]["v"].shape[0]
    batch = dict(members[0], **{key: torch.stack([c[key] for c in members])
                                for key in ("x", "F", "mu", "lam", "V0", "v", "w")})
    new_stats = lambda: [torch.zeros(N_STATS, dtype=torch.int64) for _ in range(2)]  # noqa: E731
    stats = new_stats()
    got = _launch_pair(host_lib, batch, "fixed_corotated", width, 3, nodes, stats)
    single_stats = new_stats()
    want = [torch.stack(t) for t in zip(*(
        _launch_pair(host_lib, c, "fixed_corotated", width, 1, nodes, single_stats)
        for c in members))]
    for g, w in zip(got, want):
        assert g.shape == w.shape and _rel(g, w) <= 1e-12
    for b, s in zip(stats, single_stats):
        assert fa.read_window_stats(b) == fa.read_window_stats(s)
    assert fa.read_window_stats(stats[0])["blocks"] > 3


@pytest.mark.parametrize("d", [2, 3])
def test_host_compiled_kernels_batched_tile_grid(host_lib, rng, d):
    """Three members on a batch's tile grid (fp64), each on its own tile set
    (its particles shifted by a whole tile and 0.3 of a cell from the
    previous member's), in one launch: each block reads its member's row of the
    (B, n_tiles) lookup. f, A, b+-, and df equal the plain version on the
    same batch to 1e-10 of their largest entry, and each member's outputs
    equal the member's own single launch on its own tile grid to 1e-12;
    nothing lands in a member's padding slots or dump row."""
    members = []
    for k in range(3):
        c = _inputs(d, torch.float64, rng)
        shift = torch.zeros(d, dtype=torch.float64)
        shift[1] = (k - 1) * (sparse.TILE + 0.3) * c["dx"]
        c["x"] = c["x"] + shift
        c["mu"], c["lam"] = c["mu"] * 10.0 ** k, c["lam"] * 10.0 ** k
        members.append(c)
    x = torch.stack([c["x"] for c in members])
    tgrid = sparse.build_tile_grid(x, members[0]["dx"], members[0]["res"], capacity=10 ** 6)
    assert len(set(map(tuple, tgrid.tile_ids.tolist()))) == 3
    nodes = tgrid.n_cnodes
    batch = dict(members[0], x=fa.soa(x, 1), F=fa.soa(torch.stack([c["F"] for c in members]), 1),
                 **{key: torch.stack([c[key] for c in members]) for key in ("mu", "lam", "V0")})
    batch["v"], batch["w"] = (torch.as_tensor(rng.standard_normal((3, nodes, d)))
                              for _ in range(2))
    slots = sparse.slot_nodes(tgrid)[..., None]
    batch["v"], batch["w"] = (torch.where(slots, t, 0.0) for t in (batch["v"], batch["w"]))
    stats = [torch.zeros(N_STATS, dtype=torch.int64) for _ in range(2)]
    got = _launch_pair(host_lib, batch, "fixed_corotated", 3, 3, nodes, stats, tgrid)
    model = MODEL_REGISTRY["fixed_corotated"]
    want = fl.fused_linearize_plain(batch["v"], batch["x"], batch["dx"], batch["res"], batch["F"],
                                    batch["mu"], batch["lam"], batch["V0"], DT, model,
                                    tgrid=tgrid)
    want_df = fa.fused_apply_plain(batch["w"], batch["x"], batch["dx"], batch["res"],
                                   batch["F"], *want[1:], batch["V0"], DT, tgrid=tgrid)
    for b in range(3):
        # U and V may differ from the plain version's by paired column signs
        for i in (0, 3, 4, 5, 6):
            assert _rel(got[i][b], (want + (want_df,))[i][b]) <= 1e-10
        own = tgrid.member(b)
        n_own = own.n_cnodes - 1
        alone = dict(batch, x=batch["x"][b], F=batch["F"][b], mu=batch["mu"][b],
                     lam=batch["lam"][b], V0=batch["V0"][b],
                     **{k: torch.cat([batch[k][b, :n_own], batch[k][b, -1:]]) for k in "vw"})
        single = _launch_pair(host_lib, alone, "fixed_corotated", 3, 1, own.n_cnodes,
                              [None, None], own)
        for g, s in zip(got, single):
            g = g[b] if g.shape[-1] == s.shape[-1] else torch.cat([g[b, :n_own], g[b, -1:]])
            assert _rel(g, s) <= 1e-12
        for g in (got[0], got[-1]):
            assert float(g[b, n_own:].abs().max()) == 0
    assert fa.read_window_stats(stats[0])["blocks"] > 3


BLOCK_DIAG_CASES = [("3d", torch.float64), ("3d", torch.float32), ("2d", torch.float64),
                    ("2d", torch.float32), ("3d-cubic", torch.float64),
                    ("2d-cubic", torch.float32), ("3d-tiles", torch.float32),
                    ("2d-tiles", torch.float64), ("3d-batch4", torch.float64),
                    ("3d-batch4-tiles", torch.float32), ("3d-slab", torch.float64),
                    ("3d-indefinite", torch.float64), ("2d-indefinite", torch.float32),
                    ("3d-permuted", torch.float32)]


@pytest.mark.parametrize("case,dtype", BLOCK_DIAG_CASES)
def test_host_compiled_block_diag_matches_plain(host_lib, rng, case, dtype):
    """The block-diagonal kernel against fused_block_diag_plain in the card
    test's cases (tests/test_torch_kernels_card.py): through the window
    (every box fits), through global atomics alone (window 0, every block
    over it), and for `3d-permuted` with 64-thread blocks and a budget that
    only the lattice-ordered blocks fit (both paths in one launch)."""
    from test_torch_kernels_card import assert_blocks_close, block_diag_inputs

    kw = block_diag_inputs(case, rng, dtype)
    x, d = kw["x"], kw["x"].shape[-2]
    n, members = x.shape[-1], x.shape[0] if x.ndim == 3 else 1
    want = fbd.fused_block_diag_plain(**kw)
    width = kernel_width(kw["kernel"])
    threads, window_nodes = fa.launch_config(d, width, x.element_size(), fbd.upper_values(d))
    launches = [(threads, window_nodes, 0), (threads, 0, -(-n // threads) * members)]
    if case == "3d-permuted":
        boxes = _boxes(x.T, kw["dx"], kw["res"], 64, width)
        budget = max(boxes[:(n // 2) // 64])
        over = sum(b > budget for b in boxes)
        assert 0 < over < len(boxes)
        launches.append((64, budget, over))
    lookup = (None, 0) if kw["tgrid"] is None else (_ptr(kw["tgrid"].lookup), kw["tgrid"].tile)
    for threads, window, overflow in launches:
        stats = torch.zeros(N_STATS, dtype=torch.int64)
        K = torch.zeros(want.shape[:-2] + (fbd.upper_values(d),), dtype=dtype)
        rc = host_lib.hot_fused_block_diag(
            0 if dtype == torch.float32 else 1, d, width, _ptr(x), kw["dx"],
            cuda_lib.int_array(kw["res"]), *lookup,
            *(_ptr(kw[k]) for k in ("F", "U", "V", "A", "b_plus", "b_minus", "V0")), DT,
            _ptr(K), n, K.shape[-2], members, threads, window, _ptr(stats), None)
        assert rc == 0
        assert_blocks_close(fbd.mirrored(K, d), want, TOL[dtype][0])
        got = fa.read_window_stats(stats)
        assert (got["blocks"], got["overflow_blocks"]) == (-(-n // threads) * members, overflow)
        if kw["tgrid"] is not None:
            # nothing lands in the dump row
            assert float(K[..., -1, :].abs().max()) == 0
