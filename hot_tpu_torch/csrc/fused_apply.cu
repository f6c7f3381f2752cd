// Fused matrix-free Hessian apply: df = sum_p (stencil scatter of) the
// per-particle force differential, for one CG iteration.
//
// Replaces the TPU kernel hot_tpu/ops/pallas_apply.py:fused_contrib_cl. One
// thread per particle keeps the whole chain in registers:
//   the quadratic stencil from x (particle_window.cuh)
//   gather w at the 3^d stencil nodes
//   grad_w = sum_k w_k gw_k^T;  dF = dt grad_w F;  W = U^T dF V
//   dP^ = diag(A diag(W)) plus the b+/- pair blocks;  dP = U dP^ V^T
//   contrib_k = -V0 (dP F^T) gw_k, added into df (n_nodes, d).
// Per-particle parameters are SoA (component-major, leading dimension n), so
// neighbouring threads read neighbouring addresses.
//
// Bound on the H100: bytes. A 3D particle reads 46 values (x, F, U, V, A,
// b+/-, V0: 184 B in fp32) against about 1.6k flops; the grid vector is read
// and written once over the nodes the particles touch. The stencil is
// computed from x, not read from a table (the table was 432 of the 604 B a
// particle read), and the gather and scatter go through the block's
// shared-memory node window (particle_window.cuh): a block of lattice-ordered
// particles reads w with coalesced rows and issues one global atomic per
// non-zero node value of its box instead of 81 per particle.
#include <cuda_runtime.h>

#include "particle_window.cuh"
#include "small_mat.cuh"

namespace {

template <typename T, int D>
__global__ void __launch_bounds__(hot::kMaxThreads)
fused_apply_kernel(const T* __restrict__ w, const T* __restrict__ x, T dx, hot::Grid<D> grid,
                   const T* __restrict__ Fm, const T* __restrict__ Um,
                   const T* __restrict__ Vm, const T* __restrict__ Am,
                   const T* __restrict__ bp, const T* __restrict__ bm,
                   const T* __restrict__ V0, T dt, T* __restrict__ df, long long n,
                   int window_nodes, unsigned long long* __restrict__ stats) {
  constexpr int DD = D * D;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_box[2 * D];
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  hot::window_frame<T, D>(w, x, dx, grid, df, n, window_nodes, stats, smem, s_box,
                          [&](const T* src, const hot::Stencil<T, D>& s,
                              const int off[D][3], T M[D][D]) {
    T grad[D][D];
    hot::gather_grad(src, s, off, grad);
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
    // dP = U dP^ V^T, then M = -V0 dP F^T
    T UdPh[D][D], dP[D][D];
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
        M[a][b] = -V0[p] * acc;
      }
  });
}

template <typename T, int D>
int launch(const void* w, const void* x, double dx, const int* res, const void* F,
           const void* U, const void* V, const void* A, const void* bp, const void* bm,
           const void* V0, double dt, void* df, long long n, int threads, int window_nodes,
           unsigned long long* stats, cudaStream_t stream) {
  hot::Grid<D> grid;
  for (int a = 0; a < D; ++a) grid.res[a] = res[a];
  const size_t smem = window_nodes > 0 ? hot::window_bytes<T, D>(window_nodes, threads) : 0;
  // the static shared memory counts against the default 48 KB too, so the
  // limit is raised for any window
  if (smem > 0) {
    const cudaError_t rc = cudaFuncSetAttribute(
        fused_apply_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  fused_apply_kernel<T, D><<<blocks, threads, smem, stream>>>(
      (const T*)w, (const T*)x, (T)dx, grid, (const T*)F, (const T*)U, (const T*)V, (const T*)A,
      (const T*)bp, (const T*)bm, (const T*)V0, (T)dt, (T*)df, n, window_nodes, stats);
  return 0;
}

}  // namespace

// dtype: 0 = float32, 1 = float64; res: dim grid sizes; threads: a multiple
// of 32 up to 256; window_nodes: the largest node box a block takes through
// shared memory (0: every block through global memory); stats: NULL or
// hot::kStatCount uint64 counters. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for an unsupported dtype, dim or block).
extern "C" int hot_fused_apply(int dtype, int dim, const void* w, const void* x, double dx,
                               const int* res, const void* F, const void* U, const void* V,
                               const void* A, const void* bp, const void* bm, const void* V0,
                               double dt, void* df, long long n, int threads,
                               int window_nodes, void* stats, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  auto* st = (unsigned long long*)stats;
  if (threads <= 0 || threads > hot::kMaxThreads || threads % hot::kWarp != 0 ||
      window_nodes < 0)
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    int rc;
    if (dtype == 0 && dim == 3) rc = launch<float, 3>(w, x, dx, res, F, U, V, A, bp, bm, V0, dt, df, n, threads, window_nodes, st, s);
    else if (dtype == 0 && dim == 2) rc = launch<float, 2>(w, x, dx, res, F, U, V, A, bp, bm, V0, dt, df, n, threads, window_nodes, st, s);
    else if (dtype == 1 && dim == 3) rc = launch<double, 3>(w, x, dx, res, F, U, V, A, bp, bm, V0, dt, df, n, threads, window_nodes, st, s);
    else if (dtype == 1 && dim == 2) rc = launch<double, 2>(w, x, dx, res, F, U, V, A, bp, bm, V0, dt, df, n, threads, window_nodes, st, s);
    else return (int)cudaErrorInvalidValue;
    if (rc != 0) return rc;
  }
  return (int)cudaGetLastError();
}
