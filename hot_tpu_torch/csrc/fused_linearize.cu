// Fused per-particle Newton linearization: the residual's elastic force and
// the diagonal-space Hessian context, once per Newton iteration.
//
// Replaces the TPU kernel hot_tpu/ops/pallas_linearize.py:fused_linearize.
// One thread per particle:
//   the quadratic stencil from x (particle_window.cuh)
//   gather v at the 3^d stencil nodes; grad_v; F_new = (I + dt grad_v) F
//   SVD of F_new (small_mat.cuh: Jacobi eigh of F^T F, sort with parity,
//   Givens QR, sign fix)
//   model derivatives g, A, the stable b-; b+ = (g_i + g_j)/(s_i + s_j)
//   SPD clamp: eigh of sym(A) with eigenvalues clamped at 0; b+/- >= 0
//   P = U diag(g) V^T; contrib_k = -V0 (P F^T) gw_k added into f (n_nodes, d)
//   U, V, A, b+, b- written SoA ((d*d, n), (n_pairs, n)): the exact layout
//   the fused apply reads in every CG iteration, so nothing is transposed
//   between the two kernels.
//
// Bound on the H100: bytes, with operations close behind. A 3D particle
// reads 15 values (x, F, mu, lam, V0) and writes 33 (U, V, A, b+/-): 192 B
// in fp32, plus the grid vector read and written once over the touched
// nodes. The chain is about 3.0k flops, and 1.3k more where the clamp's
// eigensolve runs (chip_smoke.py counts both on each run's inputs); IEEE
// sqrt and division are kept (the plain version's tolerances were set with
// them). The eigensolve runs only where sym(A) is not positive definite, the
// stencil is computed from x rather than read from a table, and v is
// gathered and f scattered through the block's shared-memory node window
// (particle_window.cuh), as in the apply.
#include <cuda_runtime.h>

#include "particle_window.cuh"
#include "small_mat.cuh"

namespace {

constexpr int kSweeps = 6;

template <typename T, int D, typename Model>
__global__ void __launch_bounds__(hot::kMaxThreads)
fused_linearize_kernel(const T* __restrict__ v, const T* __restrict__ x, T dx,
                       hot::Grid<D> grid, const T* __restrict__ Fm,
                       const T* __restrict__ mu_, const T* __restrict__ lam_,
                       const T* __restrict__ V0, T dt, int project,
                       T* __restrict__ f, T* __restrict__ Uo, T* __restrict__ Vo,
                       T* __restrict__ Ao, T* __restrict__ bpo,
                       T* __restrict__ bmo, long long n, int window_nodes,
                       unsigned long long* __restrict__ stats) {
  constexpr int DD = D * D;
  constexpr int NP = hot::Pairs<D>::n;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_box[2 * D];
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  hot::window_frame<T, D>(v, x, dx, grid, f, n, window_nodes, stats, smem, s_box,
                          [&](const T* src, const hot::Stencil<T, D>& s,
                              const int off[D][3], T M[D][D]) {
    T grad[D][D];
    hot::gather_grad(src, s, off, grad);
    T F[D][D], Fn[D][D];
#pragma unroll
    for (int i = 0; i < DD; ++i) F[i / D][i % D] = Fm[i * n + p];
#pragma unroll
    for (int a = 0; a < D; ++a)
#pragma unroll
      for (int b = 0; b < D; ++b) grad[a][b] = (a == b ? T(1) : T(0)) + dt * grad[a][b];
#pragma unroll
    for (int a = 0; a < D; ++a)
#pragma unroll
      for (int b = 0; b < D; ++b) {
        T acc = T(0);
#pragma unroll
        for (int c = 0; c < D; ++c) acc += grad[a][c] * F[c][b];
        Fn[a][b] = acc;
      }

    T U[D][D], sig[D], V[D][D];
    hot::svd<T, D>(Fn, U, sig, V, kSweeps);

    const T mu = mu_[p], lam = lam_[p];
    T g[D], A[D][D], bm[3], bpv[3];
    Model::template derivs<T, D>(sig, mu, lam, g, A, bm);
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      const int i = hot::Pairs<D>::i(k), j = hot::Pairs<D>::j(k);
      const T den = sig[i] + sig[j];
      const T sign = den >= T(0) ? T(1) : T(-1);
      bpv[k] = (g[i] + g[j]) * sign / hot::max_(hot::abs_(den), hot::Eps<T>::pair);
    }
    T As[D][D];
#pragma unroll
    for (int a = 0; a < D; ++a)
#pragma unroll
      for (int b = 0; b < D; ++b) As[a][b] = T(0.5) * (A[a][b] + A[b][a]);
    // the clamp leaves a positive definite sym(A) as it is (up to the
    // rounding of Q diag(w) Q^T), so its eigensolve runs only where a
    // leading minor is not positive
    if (project && !hot::positive_definite<T, D>(As)) {
      T wA[D], Q[D][D];
      hot::eigh_sym<T, D>(As, wA, Q, kSweeps);
#pragma unroll
      for (int a = 0; a < D; ++a) wA[a] = hot::max_(wA[a], T(0));
#pragma unroll
      for (int a = 0; a < D; ++a)
#pragma unroll
        for (int b = 0; b < D; ++b) {
          T acc = T(0);
#pragma unroll
          for (int c = 0; c < D; ++c) acc += Q[a][c] * wA[c] * Q[b][c];
          As[a][b] = acc;
        }
    }
    if (project) {
#pragma unroll
      for (int k = 0; k < NP; ++k) {
        bpv[k] = hot::max_(bpv[k], T(0));
        bm[k] = hot::max_(bm[k], T(0));
      }
    }

    // P = U diag(g) V^T; M = -V0 P F^T (the step-start F)
    T P[D][D];
#pragma unroll
    for (int a = 0; a < D; ++a)
#pragma unroll
      for (int b = 0; b < D; ++b) {
        T acc = T(0);
#pragma unroll
        for (int c = 0; c < D; ++c) acc += U[a][c] * g[c] * V[b][c];
        P[a][b] = acc;
      }
#pragma unroll
    for (int a = 0; a < D; ++a)
#pragma unroll
      for (int b = 0; b < D; ++b) {
        T acc = T(0);
#pragma unroll
        for (int c = 0; c < D; ++c) acc += P[a][c] * F[b][c];
        M[a][b] = -V0[p] * acc;
      }
#pragma unroll
    for (int i = 0; i < DD; ++i) {
      Uo[i * n + p] = U[i / D][i % D];
      Vo[i * n + p] = V[i / D][i % D];
      Ao[i * n + p] = As[i / D][i % D];
    }
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      bpo[k * n + p] = bpv[k];
      bmo[k * n + p] = bm[k];
    }
  });
}

template <typename T, int D, typename Model>
int launch(const void* v, const void* x, double dx, const int* res, const void* F,
           const void* mu, const void* lam, const void* V0, double dt, int project, void* f,
           void* U, void* V, void* A, void* bp, void* bm, long long n, int threads,
           int window_nodes, unsigned long long* stats, cudaStream_t stream) {
  hot::Grid<D> grid;
  for (int a = 0; a < D; ++a) grid.res[a] = res[a];
  const size_t smem = window_nodes > 0 ? hot::window_bytes<T, D>(window_nodes, threads) : 0;
  // the static shared memory counts against the default 48 KB too, so the
  // limit is raised for any window
  if (smem > 0) {
    const cudaError_t rc = cudaFuncSetAttribute(fused_linearize_kernel<T, D, Model>,
                                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  fused_linearize_kernel<T, D, Model><<<blocks, threads, smem, stream>>>(
      (const T*)v, (const T*)x, (T)dx, grid, (const T*)F, (const T*)mu, (const T*)lam,
      (const T*)V0, (T)dt, project, (T*)f, (T*)U, (T*)V, (T*)A, (T*)bp, (T*)bm, n,
      window_nodes, stats);
  return 0;
}

template <typename Model>
int dispatch(int dtype, int dim, const void* v, const void* x, double dx, const int* res,
             const void* F, const void* mu, const void* lam, const void* V0, double dt,
             int project, void* f, void* U, void* V, void* A, void* bp, void* bm,
             long long n, int threads, int window_nodes, unsigned long long* st,
             cudaStream_t s) {
  if (dtype == 0 && dim == 3) return launch<float, 3, Model>(v, x, dx, res, F, mu, lam, V0, dt, project, f, U, V, A, bp, bm, n, threads, window_nodes, st, s);
  if (dtype == 0 && dim == 2) return launch<float, 2, Model>(v, x, dx, res, F, mu, lam, V0, dt, project, f, U, V, A, bp, bm, n, threads, window_nodes, st, s);
  if (dtype == 1 && dim == 3) return launch<double, 3, Model>(v, x, dx, res, F, mu, lam, V0, dt, project, f, U, V, A, bp, bm, n, threads, window_nodes, st, s);
  if (dtype == 1 && dim == 2) return launch<double, 2, Model>(v, x, dx, res, F, mu, lam, V0, dt, project, f, U, V, A, bp, bm, n, threads, window_nodes, st, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// model: 0 = fixed_corotated, 1 = stvk_hencky; dtype: 0 = float32,
// 1 = float64; res, threads, window_nodes and stats as for hot_fused_apply.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for an
// unsupported model, dtype, dim or block).
extern "C" int hot_fused_linearize(int model, int dtype, int dim, const void* v,
                                   const void* x, double dx, const int* res, const void* F,
                                   const void* mu, const void* lam, const void* V0,
                                   double dt, int project, void* f, void* U, void* V,
                                   void* A, void* bp, void* bm, long long n, int threads,
                                   int window_nodes, void* stats, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  auto* st = (unsigned long long*)stats;
  if (threads <= 0 || threads > hot::kMaxThreads || threads % hot::kWarp != 0 ||
      window_nodes < 0)
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    int rc;
    if (model == 0)
      rc = dispatch<hot::FixedCorotated>(dtype, dim, v, x, dx, res, F, mu, lam, V0, dt, project, f, U, V, A, bp, bm, n, threads, window_nodes, st, s);
    else if (model == 1)
      rc = dispatch<hot::StvkHencky>(dtype, dim, v, x, dx, res, F, mu, lam, V0, dt, project, f, U, V, A, bp, bm, n, threads, window_nodes, st, s);
    else
      rc = (int)cudaErrorInvalidValue;
    if (rc != 0) return rc;
  }
  return (int)cudaGetLastError();
}
