// Fused matrix-free Hessian apply: df = sum_p (stencil scatter of) the
// per-particle force differential, for one CG iteration.
//
// Replaces the TPU kernel hot_tpu/ops/pallas_apply.py:fused_contrib_cl. One
// thread per particle keeps the whole chain in registers:
//   gather w at the 3^d stencil nodes (node_ids, SoA (s, n))
//   grad_w = sum_k w_k gw_k^T;  dF = dt grad_w F;  W = U^T dF V
//   dP^ = diag(A diag(W)) plus the b+/- pair blocks;  dP = U dP^ V^T
//   contrib_k = -V0 (dP F^T) gw_k, atomically added into df (n_nodes, d).
// Per-particle parameters are SoA (component-major, leading dimension n), so
// neighbouring threads read neighbouring addresses.
//
// Bound on the H100: bytes. A 3D particle reads about 160 values of
// parameters, 27 random grid vectors, and issues 81 atomics, against roughly
// 1.5k flops. The design keeps every intermediate in registers (one read of
// each parameter and one write per contribution); particles seeded in
// lattice order keep the grid reads and atomics of a warp on nearby nodes.
#include <cuda_runtime.h>

#include "small_mat.cuh"

namespace {

constexpr int kThreads = 128;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fused_apply_kernel(const T* __restrict__ w, const int* __restrict__ node_ids,
                   const T* __restrict__ gwn, const T* __restrict__ Fm,
                   const T* __restrict__ Um, const T* __restrict__ Vm,
                   const T* __restrict__ Am, const T* __restrict__ bp,
                   const T* __restrict__ bm, const T* __restrict__ V0, T dt,
                   T* __restrict__ df, long long n) {
  constexpr int S = D == 2 ? 9 : 27;
  constexpr int DD = D * D;
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;

  T grad[D][D];
#pragma unroll
  for (int a = 0; a < D; ++a)
#pragma unroll
    for (int b = 0; b < D; ++b) grad[a][b] = T(0);
  for (int k = 0; k < S; ++k) {
    const long long node = node_ids[k * n + p];
    T wk[D], gk[D];
#pragma unroll
    for (int a = 0; a < D; ++a) {
      wk[a] = w[node * D + a];
      gk[a] = gwn[(k * D + a) * n + p];
    }
#pragma unroll
    for (int a = 0; a < D; ++a)
#pragma unroll
      for (int b = 0; b < D; ++b) grad[a][b] += wk[a] * gk[b];
  }

  T F[D][D], U[D][D], V[D][D];
#pragma unroll
  for (int i = 0; i < DD; ++i) {
    F[i / D][i % D] = Fm[i * n + p];
    U[i / D][i % D] = Um[i * n + p];
    V[i / D][i % D] = Vm[i * n + p];
  }
  // dF = dt grad F
  T dF[D][D];
#pragma unroll
  for (int a = 0; a < D; ++a)
#pragma unroll
    for (int b = 0; b < D; ++b) {
      T acc = T(0);
#pragma unroll
      for (int c = 0; c < D; ++c) acc += grad[a][c] * F[c][b];
      dF[a][b] = dt * acc;
    }
  // W = U^T dF V
  T UtdF[D][D], W[D][D];
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int b = 0; b < D; ++b) {
      T acc = T(0);
#pragma unroll
      for (int a = 0; a < D; ++a) acc += U[a][i] * dF[a][b];
      UtdF[i][b] = acc;
    }
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      T acc = T(0);
#pragma unroll
      for (int b = 0; b < D; ++b) acc += UtdF[i][b] * V[b][j];
      W[i][j] = acc;
    }
  // dP^ in diagonal space
  T dPh[D][D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    T acc = T(0);
#pragma unroll
    for (int j = 0; j < D; ++j) acc += Am[(i * D + j) * n + p] * W[j][j];
    dPh[i][i] = acc;
  }
#pragma unroll
  for (int k = 0; k < hot::Pairs<D>::n; ++k) {
    const int i = hot::Pairs<D>::i(k), j = hot::Pairs<D>::j(k);
    const T bpk = bp[k * n + p], bmk = bm[k * n + p];
    const T b11 = T(0.5) * (bpk + bmk), b12 = T(0.5) * (bmk - bpk);
    dPh[i][j] = b11 * W[i][j] + b12 * W[j][i];
    dPh[j][i] = b12 * W[i][j] + b11 * W[j][i];
  }
  // dP = U dP^ V^T, then dPFt = dP F^T
  T UdPh[D][D], dP[D][D], dPFt[D][D];
#pragma unroll
  for (int a = 0; a < D; ++a)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      T acc = T(0);
#pragma unroll
      for (int i = 0; i < D; ++i) acc += U[a][i] * dPh[i][j];
      UdPh[a][j] = acc;
    }
#pragma unroll
  for (int a = 0; a < D; ++a)
#pragma unroll
    for (int b = 0; b < D; ++b) {
      T acc = T(0);
#pragma unroll
      for (int j = 0; j < D; ++j) acc += UdPh[a][j] * V[b][j];
      dP[a][b] = acc;
    }
#pragma unroll
  for (int a = 0; a < D; ++a)
#pragma unroll
    for (int b = 0; b < D; ++b) {
      T acc = T(0);
#pragma unroll
      for (int c = 0; c < D; ++c) acc += dP[a][c] * F[b][c];
      dPFt[a][b] = acc;
    }

  const T negV0 = -V0[p];
  for (int k = 0; k < S; ++k) {
    const long long node = node_ids[k * n + p];
    T gk[D];
#pragma unroll
    for (int b = 0; b < D; ++b) gk[b] = gwn[(k * D + b) * n + p];
#pragma unroll
    for (int a = 0; a < D; ++a) {
      T acc = T(0);
#pragma unroll
      for (int b = 0; b < D; ++b) acc += dPFt[a][b] * gk[b];
      atomicAdd(&df[node * D + a], negV0 * acc);
    }
  }
}

template <typename T, int D>
void launch(const void* w, const void* node_ids, const void* gwn, const void* F,
            const void* U, const void* V, const void* A, const void* bp,
            const void* bm, const void* V0, double dt, void* df, long long n,
            cudaStream_t stream) {
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  fused_apply_kernel<T, D><<<blocks, kThreads, 0, stream>>>(
      (const T*)w, (const int*)node_ids, (const T*)gwn, (const T*)F, (const T*)U,
      (const T*)V, (const T*)A, (const T*)bp, (const T*)bm, (const T*)V0, (T)dt,
      (T*)df, n);
}

}  // namespace

// dtype: 0 = float32, 1 = float64. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for an unsupported dtype or dim).
extern "C" int hot_fused_apply(int dtype, int dim, const void* w,
                               const void* node_ids, const void* gwn,
                               const void* F, const void* U, const void* V,
                               const void* A, const void* bp, const void* bm,
                               const void* V0, double dt, void* df, long long n,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0) {
    if (dtype == 0 && dim == 3) launch<float, 3>(w, node_ids, gwn, F, U, V, A, bp, bm, V0, dt, df, n, s);
    else if (dtype == 0 && dim == 2) launch<float, 2>(w, node_ids, gwn, F, U, V, A, bp, bm, V0, dt, df, n, s);
    else if (dtype == 1 && dim == 3) launch<double, 3>(w, node_ids, gwn, F, U, V, A, bp, bm, V0, dt, df, n, s);
    else if (dtype == 1 && dim == 2) launch<double, 2>(w, node_ids, gwn, F, U, V, A, bp, bm, V0, dt, df, n, s);
    else return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
