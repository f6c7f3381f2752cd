"""The CUDA sources of hot_tpu_torch/csrc compiled for the host with g++,
against the kernels' plain PyTorch versions.

A small stand-in for the CUDA runtime turns each launch into a loop over
blocks and threads (atomicAdd becomes a plain add), so the kernels' own
per-particle code runs on the CPU at 16^3 / 24^2; warp shuffles are
emulated for the one-warp-per-row SpMV (see SHIM). This cannot show that
nvcc accepts the sources or that they are right on the card; chip_smoke.py
and the `cuda`-marked tests do that.

Tolerances are relative to the plain result's largest entry: 1e-10 in fp64
(summation order only) and 2e-5 in fp32, as chip_smoke.py states them.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from hot_tpu_torch.models.constitutive import MODEL_REGISTRY
from hot_tpu_torch.ops import cuda_lib, transfer
from hot_tpu_torch.ops import fused_apply as fa
from hot_tpu_torch.ops.bsr_spmv import bsr_spmv_plain
from hot_tpu_torch.ops import fused_linearize as fl
from hot_tpu_torch.scenes import build_scene

SHIM = r"""
#pragma once
#include <array>
#include <vector>
struct Dim3 { unsigned x = 0, y = 0, z = 0; };
inline thread_local Dim3 blockIdx, threadIdx, blockDim;
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline int cudaGetLastError() { return 0; }
template <typename T> inline T atomicAdd(T* p, T v) { T old = *p; *p += v; return old; }
template <typename T> inline T __ldg(const T* p) { return *p; }
// Lanes run one after another, so a shuffle returns what the partner lane
// passed at the same call if that lane has already run (a lower lane), and
// stale data otherwise. After an xor butterfly the LAST lane holds the full
// sum (its partners at every step are lower lanes), so kernels store from it.
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
"""
LAUNCH = re.compile(r"(\w+<[^<>]*>)<<<blocks, kThreads, 0, stream>>>\(")
TOL = {torch.float32: (2e-5, 2e-5), torch.float64: (1e-10, 1e-10)}
DT = 2e-3


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    out = tmp_path_factory.mktemp("csrc_host")
    (out / "cuda_runtime.h").write_text(SHIM)
    shutil.copy(cuda_lib.CSRC / "small_mat.cuh", out)
    cpps = []
    for cu in sorted(cuda_lib.CSRC.glob("*.cu")):
        text, n = LAUNCH.subn(r"host_launch(blocks, kThreads, \1, ", cu.read_text())
        assert n == 1, f"{cu.name}: expected one kernel launch, found {n}"
        cpps.append(out / (cu.stem + ".cpp"))
        cpps[-1].write_text(text)
    lib_path = out / "libhost.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-Wno-unknown-pragmas",
                    "-I", str(out), "-o", str(lib_path), *map(str, cpps)],
                   check=True, timeout=600)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in cuda_lib._SIGNATURES.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    return lib


def _inputs(d, dtype, rng):
    name, kw = ("twisting_bar_3d", dict(res=16, ppc=2)) if d == 3 else ("block_drop_2d",
                                                                         dict(res=24))
    state = build_scene(name, device="cpu", dtype=dtype, **kw)["state"]
    res = kw["res"]
    n = state.n
    F = state.F + torch.as_tensor(0.1 * rng.standard_normal((n, d, d)), dtype=dtype)
    st = transfer.particle_stencil(state.x, 1.0 / res, (res,) * d)
    s = st.wn.shape[1]
    v = torch.as_tensor(rng.standard_normal((res ** d, d)), dtype=dtype)
    return (v, st.node_ids.T.to(torch.int32).contiguous(),
            st.gwn.reshape(n, s * d).T.contiguous(), F.reshape(n, d * d).T.contiguous(),
            state.mu, state.lam, state.V0)


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("model_name", ["fixed_corotated", "stvk_hencky"])
@pytest.mark.parametrize("d", [2, 3])
def test_host_compiled_kernels_match_plain(host_lib, rng, d, model_name, dtype):
    model = MODEL_REGISTRY[model_name]
    v, ids, gwn, F, mu, lam, V0 = _inputs(d, dtype, rng)
    n = ids.shape[1]
    n_pairs = 1 if d == 2 else 3
    f = torch.zeros_like(v)
    U, V, A = (torch.empty((d * d, n), dtype=dtype) for _ in range(3))
    bp, bm = (torch.empty((n_pairs, n), dtype=dtype) for _ in range(2))
    code = 0 if dtype == torch.float32 else 1
    ptr = lambda t: t.data_ptr()  # noqa: E731
    rc = host_lib.hot_fused_linearize(
        fl.MODEL_CODES[model_name], code, d, ptr(v), ptr(ids), ptr(gwn), ptr(F), ptr(mu),
        ptr(lam), ptr(V0), DT, 1, ptr(f), ptr(U), ptr(V), ptr(A), ptr(bp), ptr(bm), n, None)
    assert rc == 0
    want = fl.fused_linearize_plain(v, ids, gwn, F, mu, lam, V0, DT, model)
    tol_lin, tol_apply = TOL[dtype]
    for got, ref in zip((f, A, bp, bm), (want[0], want[3], want[4], want[5])):
        assert _rel(got, ref) <= tol_lin
    eps = torch.finfo(dtype).eps
    eye = torch.eye(d, dtype=dtype)
    for M in (U, V):
        M = M.T.reshape(n, d, d)
        assert float((M.transpose(1, 2) @ M - eye).abs().max()) <= 50 * eps
        assert float((torch.linalg.det(M) - 1).abs().max()) <= 50 * eps

    w = torch.as_tensor(rng.standard_normal(tuple(v.shape)), dtype=dtype)
    df = torch.zeros_like(w)
    ctx = want[1:]
    rc = host_lib.hot_fused_apply(code, d, ptr(w), ptr(ids), ptr(gwn), ptr(F),
                                  *map(ptr, ctx), ptr(V0), DT, ptr(df), n, None)
    assert rc == 0
    assert _rel(df, fa.fused_apply_plain(w, ids, gwn, F, *ctx, V0, DT)) <= tol_apply


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
    assert host_lib.hot_fused_apply(0, 4, *[z.data_ptr()] * 10, DT, z.data_ptr(), 1,
                                    None) != 0
    assert host_lib.hot_fused_linearize(7, 0, 3, *[z.data_ptr()] * 7, DT, 1,
                                        *[z.data_ptr()] * 6, 1, None) != 0
    assert host_lib.hot_bsr_spmv(0, 4, *[z.data_ptr()] * 4, 1, 125, None) != 0
