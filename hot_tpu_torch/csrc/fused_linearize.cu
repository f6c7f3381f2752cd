// Fused per-particle Newton linearization: the residual's elastic force and
// the diagonal-space Hessian context, once per Newton iteration.
//
// Replaces the TPU kernel hot_tpu/ops/pallas_linearize.py:fused_linearize.
// One thread per particle:
//   gather v at the 3^d stencil nodes; grad_v; F_new = (I + dt grad_v) F
//   SVD of F_new (small_mat.cuh: Jacobi eigh of F^T F, sort with parity,
//   Givens QR, sign fix)
//   model derivatives g, A, the stable b-; b+ = (g_i + g_j)/(s_i + s_j)
//   SPD clamp: eigh of sym(A) with eigenvalues clamped at 0; b+/- >= 0
//   P = U diag(g) V^T; contrib_k = -V0 (P F^T) gw_k atomically added into
//   f (n_nodes, d)
//   U, V, A, b+, b- written SoA ((d*d, n), (n_pairs, n)): the exact layout
//   the fused apply reads in every CG iteration, so nothing is transposed
//   between the two kernels.
//
// Bound on the H100: operations. The 3D chain is about 2-3k flops per
// particle (two 6-sweep Jacobi solves dominate) against about 120 values
// read and 30 written; IEEE sqrt and division are used throughout. The
// design keeps the chain in registers and spends one thread per particle, so
// the card's full width of threads works on independent particles.
#include <cuda_runtime.h>

#include "small_mat.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kSweeps = 6;

template <typename T, int D, typename Model>
__global__ void __launch_bounds__(kThreads)
fused_linearize_kernel(const T* __restrict__ v, const int* __restrict__ node_ids,
                       const T* __restrict__ gwn, const T* __restrict__ Fm,
                       const T* __restrict__ mu_, const T* __restrict__ lam_,
                       const T* __restrict__ V0, T dt, int project,
                       T* __restrict__ f, T* __restrict__ Uo, T* __restrict__ Vo,
                       T* __restrict__ Ao, T* __restrict__ bpo,
                       T* __restrict__ bmo, long long n) {
  constexpr int S = D == 2 ? 9 : 27;
  constexpr int DD = D * D;
  constexpr int NP = hot::Pairs<D>::n;
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;

  T grad[D][D];
#pragma unroll
  for (int a = 0; a < D; ++a)
#pragma unroll
    for (int b = 0; b < D; ++b) grad[a][b] = T(0);
  for (int k = 0; k < S; ++k) {
    const long long node = node_ids[k * n + p];
    T vk[D], gk[D];
#pragma unroll
    for (int a = 0; a < D; ++a) {
      vk[a] = v[node * D + a];
      gk[a] = gwn[(k * D + a) * n + p];
    }
#pragma unroll
    for (int a = 0; a < D; ++a)
#pragma unroll
      for (int b = 0; b < D; ++b) grad[a][b] += vk[a] * gk[b];
  }
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
  if (project) {
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
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      bpv[k] = hot::max_(bpv[k], T(0));
      bm[k] = hot::max_(bm[k], T(0));
    }
  }

  // P = U diag(g) V^T; PFt = P F^T (the step-start F)
  T P[D][D], PFt[D][D];
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
      PFt[a][b] = acc;
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
      for (int b = 0; b < D; ++b) acc += PFt[a][b] * gk[b];
      atomicAdd(&f[node * D + a], negV0 * acc);
    }
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
}

template <typename T, int D, typename Model>
void launch(const void* v, const void* node_ids, const void* gwn, const void* F,
            const void* mu, const void* lam, const void* V0, double dt,
            int project, void* f, void* U, void* V, void* A, void* bp, void* bm,
            long long n, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  fused_linearize_kernel<T, D, Model><<<blocks, kThreads, 0, stream>>>(
      (const T*)v, (const int*)node_ids, (const T*)gwn, (const T*)F,
      (const T*)mu, (const T*)lam, (const T*)V0, (T)dt, project, (T*)f, (T*)U,
      (T*)V, (T*)A, (T*)bp, (T*)bm, n);
}

template <typename Model>
int dispatch(int dtype, int dim, const void* v, const void* node_ids,
             const void* gwn, const void* F, const void* mu, const void* lam,
             const void* V0, double dt, int project, void* f, void* U, void* V,
             void* A, void* bp, void* bm, long long n, cudaStream_t s) {
  if (dtype == 0 && dim == 3) launch<float, 3, Model>(v, node_ids, gwn, F, mu, lam, V0, dt, project, f, U, V, A, bp, bm, n, s);
  else if (dtype == 0 && dim == 2) launch<float, 2, Model>(v, node_ids, gwn, F, mu, lam, V0, dt, project, f, U, V, A, bp, bm, n, s);
  else if (dtype == 1 && dim == 3) launch<double, 3, Model>(v, node_ids, gwn, F, mu, lam, V0, dt, project, f, U, V, A, bp, bm, n, s);
  else if (dtype == 1 && dim == 2) launch<double, 2, Model>(v, node_ids, gwn, F, mu, lam, V0, dt, project, f, U, V, A, bp, bm, n, s);
  else return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// model: 0 = fixed_corotated, 1 = stvk_hencky; dtype: 0 = float32,
// 1 = float64. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for an unsupported model, dtype or dim).
extern "C" int hot_fused_linearize(int model, int dtype, int dim, const void* v,
                                   const void* node_ids, const void* gwn,
                                   const void* F, const void* mu,
                                   const void* lam, const void* V0, double dt,
                                   int project, void* f, void* U, void* V,
                                   void* A, void* bp, void* bm, long long n,
                                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0) {
    int rc;
    if (model == 0)
      rc = dispatch<hot::FixedCorotated>(dtype, dim, v, node_ids, gwn, F, mu, lam, V0, dt, project, f, U, V, A, bp, bm, n, s);
    else if (model == 1)
      rc = dispatch<hot::StvkHencky>(dtype, dim, v, node_ids, gwn, F, mu, lam, V0, dt, project, f, U, V, A, bp, bm, n, s);
    else
      rc = (int)cudaErrorInvalidValue;
    if (rc != 0) return rc;
  }
  return (int)cudaGetLastError();
}
