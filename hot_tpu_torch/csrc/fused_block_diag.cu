// Block-Jacobi's elastic blocks: the (d, d) diagonal blocks of dt^2 K at
// every grid node, scattered straight from the particles, once per Newton
// iteration.
//
// Replaces no TPU kernel: hot_tpu builds these blocks in plain jnp
// (hot_tpu/sim/objective.py:elastic_block_diag), and the port's plain
// version (ops/fused_block_diag.py:fused_block_diag_plain) runs that chain
// in chunks of particles, with a Jacobi eigensolve of each particle's A and
// batched 3x3 products that cuBLAS ran on 32x32 tiles: 89 ms a build at
// 128^3 on the H100, most of a block-Jacobi segment. One thread per particle
// now computes its blocks in registers. For particle p at stencil node k:
//   y_k = V^T F^T gw_k
//   B_k = dt^2 V0 U M_k U^T,
//   M_k = diag(y) A diag(y)
//       + sum over pairs i < j of 1/2 [(b- + b+)(y_j^2 e_i e_i^T + y_i^2 e_j e_j^T)
//                                     + (b- - b+) y_i y_j (e_i e_j^T + e_j e_i^T)].
// That is the plain version's sum of rank-1 modes written in U's frame: its
// normal modes sum lam_m z_m z_m^T with z_m = U (Q e_m o y) to
// U diag(y) (Q Lam Q^T) diag(y) U^T, and Q Lam Q^T is A, so no eigensolve is
// needed; the pair terms are its (U_i y_j +- U_j y_i) / sqrt2 modes
// expanded. A enters through its symmetric part, as the eigensolve reads it.
// Only the d(d+1)/2 upper-triangle entries of each block are scattered
// (row-major: 00 01 02 11 12 22 in 3D, 00 01 11 in 2D); the wrapper mirrors
// them.
//
// Bound on the H100: bytes and operations about equally, and far from both.
// A 3D particle reads 46 values (x, F, U, V, A, b+/-, V0: 184 B in fp32) and
// does about 4.4k flops (150 a stencil node: y, M, U M and the scaled upper
// triangle of U M U^T); K is written once over the touched nodes (6 values
// a node). At the 128^3 bar that is about 76 MB, 23 us at 3.35 TB/s, and
// 1.8 GFLOP, 26 us at 67 TFLOP/s in fp32. The scatter is the hard part: 27 x 6
// values per particle. It goes through particle_window.cuh's counting sort by
// node (scatter_frame: no grid vector is gathered, so the window holds only
// the slots, 6 values a stencil node instead of 3), so a block of
// lattice-ordered particles issues one global atomic per non-zero value of
// its node box instead of 162 per particle; a block whose box does not fit
// its window, and a clamped particle, take the global atomics. At the 128^3
// bar in fp32 a launch takes 0.29 ms through the window and 1.03 ms with
// the global atomics alone (window_nodes 0), so the window stays.
//
// The axes are fused_apply's: fp32 and fp64, d = 2 and 3, the quadratic and
// cubic stencil, the dense grid and the tile grid's compact ids (Tiled), and
// a batch of members on blockIdx.y, each with its own arrays and blocks.
#include <cuda_runtime.h>

#include "particle_window.cuh"
#include "small_mat.cuh"

namespace {

template <typename T, int D, int SW, bool Tiled>
__global__ void __launch_bounds__(hot::kMaxThreads)
fused_block_diag_kernel(const T* __restrict__ x, T dx, hot::Grid<D> grid,
                        const T* __restrict__ Fm, const T* __restrict__ Um,
                        const T* __restrict__ Vm, const T* __restrict__ Am,
                        const T* __restrict__ bp, const T* __restrict__ bm,
                        const T* __restrict__ V0, T dt, T* __restrict__ K, long long n,
                        long long nodes, int window_nodes, unsigned long long* __restrict__ stats) {
  constexpr int DD = D * D;
  constexpr int NP = hot::Pairs<D>::n;
  constexpr int NV = D * (D + 1) / 2;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_box[2 * D];
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  // this block's member
  K += hot::member_offset(nodes * NV);
  x += hot::member_offset(D * n);
  Fm += hot::member_offset(DD * n);
  Um += hot::member_offset(DD * n);
  Vm += hot::member_offset(DD * n);
  Am += hot::member_offset(DD * n);
  bp += hot::member_offset(NP * n);
  bm += hot::member_offset(NP * n);
  V0 += hot::member_offset(n);
  // per particle: G = F V (so y_k = G^T gw_k), U, and M's coefficients in
  // U's frame: the diagonal of A, A's symmetric off-diagonal plus
  // (b- - b+)/2, and (b- + b+)/2 per pair; the scale dt^2 V0
  T G[D][D], U[D][D], Ad[D], C[NP], P[NP], scale = T(0);
  if (p < n) {
    T F[D][D], V[D][D];
#pragma unroll
    for (int i = 0; i < DD; ++i) {
      F[i / D][i % D] = Fm[i * n + p];
      V[i / D][i % D] = Vm[i * n + p];
      U[i / D][i % D] = Um[i * n + p];
    }
#pragma unroll
    for (int a = 0; a < D; ++a)
#pragma unroll
      for (int c = 0; c < D; ++c) {
        T acc = T(0);
#pragma unroll
        for (int b = 0; b < D; ++b) acc += F[a][b] * V[b][c];
        G[a][c] = acc;
      }
#pragma unroll
    for (int i = 0; i < D; ++i) Ad[i] = Am[(i * D + i) * n + p];
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      const int i = hot::Pairs<D>::i(k), j = hot::Pairs<D>::j(k);
      const T bpk = bp[k * n + p], bmk = bm[k * n + p];
      C[k] = T(0.5) * (Am[(i * D + j) * n + p] + Am[(j * D + i) * n + p]) + T(0.5) * (bmk - bpk);
      P[k] = T(0.5) * (bmk + bpk);
    }
    scale = dt * dt * V0[p];
  }
  hot::scatter_frame<T, D, SW, NV, Tiled>(
      x, dx, grid.for_member(), K, n, window_nodes, stats, smem, s_box,
      [&](const T* g, T* out) {
        T y[D];
#pragma unroll
        for (int c = 0; c < D; ++c) {
          T acc = T(0);
#pragma unroll
          for (int b = 0; b < D; ++b) acc += g[b] * G[b][c];
          y[c] = acc;
        }
        T M[D][D];
#pragma unroll
        for (int i = 0; i < D; ++i) M[i][i] = Ad[i] * y[i] * y[i];
#pragma unroll
        for (int k = 0; k < NP; ++k) {
          const int i = hot::Pairs<D>::i(k), j = hot::Pairs<D>::j(k);
          M[i][i] += P[k] * y[j] * y[j];
          M[j][j] += P[k] * y[i] * y[i];
          M[i][j] = M[j][i] = C[k] * y[i] * y[j];
        }
        // UM = U M, then the upper triangle of scale * UM U^T
        T UM[D][D];
#pragma unroll
        for (int a = 0; a < D; ++a)
#pragma unroll
          for (int b = 0; b < D; ++b) {
            T acc = T(0);
#pragma unroll
            for (int c = 0; c < D; ++c) acc += U[a][c] * M[c][b];
            UM[a][b] = acc;
          }
        int t = 0;
#pragma unroll
        for (int a = 0; a < D; ++a)
#pragma unroll
          for (int b = a; b < D; ++b) {
            T acc = T(0);
#pragma unroll
            for (int c = 0; c < D; ++c) acc += UM[a][c] * U[b][c];
            out[t++] = scale * acc;
          }
      });
}

template <typename T, int D, int SW, bool Tiled>
int launch(const void* x, double dx, const int* res, const int* lookup, int tile, const void* F,
           const void* U, const void* V, const void* A, const void* bp, const void* bm,
           const void* V0, double dt, void* K, long long n, long long nodes, int batch,
           int threads, int window_nodes, unsigned long long* stats, cudaStream_t stream) {
  constexpr int NV = D * (D + 1) / 2;
  const hot::Grid<D> grid = hot::make_grid<D>(res, lookup, tile);
  const size_t smem =
      window_nodes > 0 ? hot::scatter_window_bytes<T, D, SW, NV>(window_nodes, threads) : 0;
  // the static shared memory counts against the default 48 KB too, so the
  // limit is raised for any window
  if (smem > 0) {
    const cudaError_t rc = cudaFuncSetAttribute(
        fused_block_diag_kernel<T, D, SW, Tiled>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  const dim3 blocks((unsigned)((n + threads - 1) / threads), (unsigned)batch);
  fused_block_diag_kernel<T, D, SW, Tiled><<<blocks, threads, smem, stream>>>(
      (const T*)x, (T)dx, grid, (const T*)F, (const T*)U, (const T*)V, (const T*)A,
      (const T*)bp, (const T*)bm, (const T*)V0, (T)dt, (T*)K, n, nodes, window_nodes, stats);
  return 0;
}

template <int SW, bool Tiled>
int dispatch(int dtype, int dim, const void* x, double dx, const int* res, const int* lookup,
             int tile, const void* F, const void* U, const void* V, const void* A,
             const void* bp, const void* bm, const void* V0, double dt, void* K, long long n,
             long long nodes, int batch, int threads, int window_nodes,
             unsigned long long* st, cudaStream_t s) {
  if (dtype == 0 && dim == 3) return launch<float, 3, SW, Tiled>(x, dx, res, lookup, tile, F, U, V, A, bp, bm, V0, dt, K, n, nodes, batch, threads, window_nodes, st, s);
  if (dtype == 0 && dim == 2) return launch<float, 2, SW, Tiled>(x, dx, res, lookup, tile, F, U, V, A, bp, bm, V0, dt, K, n, nodes, batch, threads, window_nodes, st, s);
  if (dtype == 1 && dim == 3) return launch<double, 3, SW, Tiled>(x, dx, res, lookup, tile, F, U, V, A, bp, bm, V0, dt, K, n, nodes, batch, threads, window_nodes, st, s);
  if (dtype == 1 && dim == 2) return launch<double, 2, SW, Tiled>(x, dx, res, lookup, tile, F, U, V, A, bp, bm, V0, dt, K, n, nodes, batch, threads, window_nodes, st, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The arguments are hot_fused_apply's without the grid vector w, and K in
// place of df: K (nodes, dim (dim + 1) / 2) per member, the upper triangle
// of each node's block, row-major, added into (the caller zeroes it).
// Returns the error of raising the block's shared-memory limit if that
// fails, else cudaGetLastError() after the launch (cudaErrorInvalidValue for
// an unsupported dtype, dim, width, tile, batch or block).
extern "C" int hot_fused_block_diag(int dtype, int dim, int width, const void* x, double dx,
                                    const int* res, const int* lookup, int tile, const void* F,
                                    const void* U, const void* V, const void* A, const void* bp,
                                    const void* bm, const void* V0, double dt, void* K,
                                    long long n, long long nodes, int batch, int threads,
                                    int window_nodes, void* stats, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  auto* st = (unsigned long long*)stats;
  if (threads <= 0 || threads > hot::kMaxThreads || threads % hot::kWarp != 0 ||
      window_nodes < 0 || (lookup != nullptr && tile <= 0) || batch < 1 ||
      batch > hot::kMaxBatch)
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    int rc;
    if (width == 3 && lookup != nullptr)
      rc = dispatch<3, true>(dtype, dim, x, dx, res, lookup, tile, F, U, V, A, bp, bm, V0, dt, K, n, nodes, batch, threads, window_nodes, st, s);
    else if (width == 3)
      rc = dispatch<3, false>(dtype, dim, x, dx, res, lookup, tile, F, U, V, A, bp, bm, V0, dt, K, n, nodes, batch, threads, window_nodes, st, s);
    else if (width == 4 && lookup == nullptr)
      rc = dispatch<4, false>(dtype, dim, x, dx, res, lookup, tile, F, U, V, A, bp, bm, V0, dt, K, n, nodes, batch, threads, window_nodes, st, s);
    else
      rc = (int)cudaErrorInvalidValue;
    if (rc != 0) return rc;
  }
  return (int)cudaGetLastError();
}
