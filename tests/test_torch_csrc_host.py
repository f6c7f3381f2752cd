"""The CUDA sources of hot_tpu_torch/csrc compiled for the host with g++,
against the kernels' plain PyTorch versions.

A small stand-in for the CUDA runtime (SHIM) turns each launch into host
code, so the kernels' own code runs on the CPU at 16^3 / 24^2:

  * the particle kernels (launched with dynamic shared memory) run each
    block's threads at once, one std::thread each; __syncthreads is a
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
boundary band. This cannot show that nvcc accepts the sources or that they
are right on the card; chip_smoke.py and the `cuda`-marked tests do that.

Tolerances are relative to the plain result's largest entry: 1e-10 in fp64
(summation order only) and 2e-5 in fp32, as chip_smoke.py states them.
"""

import ctypes
import re
import shutil
import subprocess

import pytest
import torch

from hot_tpu_torch.models import constitutive as cm
from hot_tpu_torch.models.constitutive import MODEL_REGISTRY
from hot_tpu_torch.ops import cuda_lib
from hot_tpu_torch.ops import fused_apply as fa
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
struct Dim3 { unsigned x = 0, y = 0, z = 0; };
inline thread_local Dim3 blockIdx, threadIdx, blockDim;
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
// blocks one after another.
template <typename Fn, typename... Args>
inline void host_launch_block(unsigned blocks, unsigned threads, size_t smem, Fn fn,
                              Args... args) {
  for (unsigned b = 0; b < blocks; ++b) {
    HostBlock blk(threads, smem);
    std::vector<std::thread> pool;
    for (unsigned t = 0; t < threads; ++t)
      pool.emplace_back([&, t] {
        blockDim.x = threads;
        blockIdx.x = b;
        threadIdx.x = t;
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
                   window_nodes=fa.WINDOW_NODES, stats=(None, None)):
    """Both host-compiled kernels against their plain versions on inputs c."""
    model = MODEL_REGISTRY[model_name]
    x = fa.soa(c["x"])
    F = fa.soa(c["F"])
    d, n = x.shape
    n_pairs = 1 if d == 2 else 3
    f = torch.zeros_like(c["v"])
    U, V, A = (torch.empty((d * d, n), dtype=dtype) for _ in range(3))
    bp, bm = (torch.empty((n_pairs, n), dtype=dtype) for _ in range(2))
    code = 0 if dtype == torch.float32 else 1
    res = cuda_lib.int_array(c["res"])
    rc = host_lib.hot_fused_linearize(
        fl.MODEL_CODES[model_name], code, d, _ptr(c["v"]), _ptr(x), c["dx"], res, _ptr(F),
        _ptr(c["mu"]), _ptr(c["lam"]), _ptr(c["V0"]), DT, 1, _ptr(f), _ptr(U), _ptr(V),
        _ptr(A), _ptr(bp), _ptr(bm), n, threads, window_nodes, _ptr(stats[0]), None)
    assert rc == 0
    want = fl.fused_linearize_plain(c["v"], x, c["dx"], c["res"], F, c["mu"], c["lam"],
                                    c["V0"], DT, model)
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
    rc = host_lib.hot_fused_apply(code, d, _ptr(w), _ptr(x), c["dx"], res, _ptr(F),
                                  *map(_ptr, ctx), _ptr(c["V0"]), DT, _ptr(df), n, threads,
                                  window_nodes, _ptr(stats[1]), None)
    assert rc == 0
    assert _rel(df, fa.fused_apply_plain(w, x, c["dx"], c["res"], F, *ctx, c["V0"], DT)) \
        <= tol_apply


def _boxes(x, dx, res, threads):
    """Each block's node-box size, as the kernels' window reduction forms it."""
    base = torch.floor(x / dx - 0.5).long()
    hi = torch.tensor(res) - 1
    lo, top = torch.minimum(base.clamp(min=0), hi), torch.minimum((base + 2).clamp(min=0), hi)
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


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_host_compiled_kernels_permuted_order(host_lib, rng, dtype):
    """The second half of the particles permuted at random, 64-thread blocks
    and a window budget that the lattice-ordered blocks fit: the permuted
    blocks take the global-atomic branch of the same launch. Both kernels
    count the blocks, overflows, box sizes and atomics computed here."""
    c = _inputs(3, dtype, rng, "twisting_bar_3d", dict(res=16, ppc=8))
    n, threads = c["x"].shape[0], 64
    tail = torch.arange(n // 2, n)
    perm = torch.cat([torch.arange(n // 2), tail[torch.from_numpy(rng.permutation(len(tail)))]])
    for key in ("x", "F", "mu", "lam", "V0"):
        c[key] = c[key][perm].contiguous()
    boxes = _boxes(c["x"], c["dx"], c["res"], threads)
    budget = max(boxes[:(n // 2) // threads])
    over = [b for b in boxes if b > budget]
    assert 0 < len(over) < len(boxes)
    stats = (torch.zeros(N_STATS, dtype=torch.int64), torch.zeros(N_STATS, dtype=torch.int64))
    _check_kernels(host_lib, c, "fixed_corotated", dtype, threads, budget, stats)
    for buf in stats:
        got = fa.read_window_stats(buf)
        assert (got["blocks"], got["overflow_blocks"]) == (len(boxes), len(over))
        assert (got["window_nodes"], got["max_window_nodes"]) == (sum(boxes), max(boxes))
        assert sum(got["log2_nodes_histogram"].values()) == len(boxes)
        # the permuted blocks issue 81 atomics per particle; the windowed
        # ones one per non-zero box entry, at most 3 per box node
        direct = 81 * sum(min(threads, n - i * threads) for i, b in enumerate(boxes)
                          if b > budget)
        assert direct < got["global_atomics"] <= direct + 3 * sum(b for b in boxes
                                                                  if b <= budget)


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
    assert host_lib.hot_fused_apply(0, 4, p, p, 1.0, res, *[p] * 7, DT, p, 1, 128, 0, None,
                                    None) != 0
    assert host_lib.hot_fused_apply(0, 3, p, p, 1.0, res, *[p] * 7, DT, p, 1, 100, 0,
                                    None, None) != 0
    assert host_lib.hot_fused_linearize(7, 0, 3, p, p, 1.0, res, *[p] * 4, DT, 1, *[p] * 6,
                                        1, 128, 0, None, None) != 0
    assert host_lib.hot_bsr_spmv(0, 4, *[z.data_ptr()] * 4, 1, 125, None) != 0
