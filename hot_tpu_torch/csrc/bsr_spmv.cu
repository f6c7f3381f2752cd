// Block-sparse matrix-vector product over the compressed-row BSR layout of
// hot_tpu_torch/ops/bsr.py:
//   y[r, :] = sum_{k < K} vals[r, k] @ x[col_row[r, k], :],  col_row < 0 skipped,
// with vals (R, K, D, D) contiguous, col_row (R, K) int32, x (n_rows, D).
//
// Replaces the TPU kernel hot_tpu/ops/bsr_tiled.py:spmv_T (an XLA gather of
// the K-offset windows feeding a Pallas multiply-reduce over (K, lane)
// blocks, with absent columns pointing at a zero dump block). Here the
// gather is in the kernel and an absent column is skipped.
//
// One warp per block row. The lanes stride over k, so a warp reads
// consecutive blocks of its row (vals and col_row coalesced, each byte read
// once); each lane keeps D partial sums, the x gather goes through the
// read-only path, and a butterfly of warp shuffles finishes the row. y is
// written, not accumulated: no atomics. The last lane stores the row (every
// lane holds the same sum after the butterfly).
//
// Bound on the H100: bytes. A row moves K (D*D + 1) * 4 B of vals and
// col_row in fp32 (K = 125: 5 kB) for 2 K D^2 flops, about 0.2 flop/B;
// x and y are small beside it and x mostly hits L2.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarp = 32;

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int m = kWarp / 2; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
bsr_spmv_kernel(const T* __restrict__ vals, const int* __restrict__ col_row,
                const T* __restrict__ x, T* __restrict__ y, long long n_rows,
                int K) {
  constexpr int DD = D * D;
  const long long r = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (r >= n_rows) return;  // the whole warp: one row per warp
  const T* vr = vals + r * K * DD;
  const int* cr = col_row + r * K;
  T acc[D];
#pragma unroll
  for (int i = 0; i < D; ++i) acc[i] = T(0);
  for (int k = lane; k < K; k += kWarp) {
    const int c = cr[k];
    if (c < 0) continue;
    T xc[D];
#pragma unroll
    for (int j = 0; j < D; ++j) xc[j] = __ldg(x + (long long)c * D + j);
    const T* blk = vr + (long long)k * DD;
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) acc[i] += blk[i * D + j] * xc[j];
  }
#pragma unroll
  for (int i = 0; i < D; ++i) acc[i] = warp_sum(acc[i]);
  if (lane == kWarp - 1) {
#pragma unroll
    for (int i = 0; i < D; ++i) y[r * D + i] = acc[i];
  }
}

template <typename T, int D>
void launch(const void* vals, const void* col_row, const void* x, void* y,
            long long n_rows, int K, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((n_rows * kWarp + kThreads - 1) / kThreads);
  bsr_spmv_kernel<T, D><<<blocks, kThreads, 0, stream>>>(
      (const T*)vals, (const int*)col_row, (const T*)x, (T*)y, n_rows, K);
}

}  // namespace

// dtype: 0 = float32, 1 = float64. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for an unsupported dtype or dim).
extern "C" int hot_bsr_spmv(int dtype, int dim, const void* vals,
                            const void* col_row, const void* x, void* y,
                            long long n_rows, int K, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n_rows > 0) {
    if (dtype == 0 && dim == 3) launch<float, 3>(vals, col_row, x, y, n_rows, K, s);
    else if (dtype == 0 && dim == 2) launch<float, 2>(vals, col_row, x, y, n_rows, K, s);
    else if (dtype == 1 && dim == 3) launch<double, 3>(vals, col_row, x, y, n_rows, K, s);
    else if (dtype == 1 && dim == 2) launch<double, 2>(vals, col_row, x, y, n_rows, K, s);
    else return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
