// K4 — batched Gauss-Jordan inverse of small positive-definite matrices.
//
// Replaces: pmf_tpu/ops/pallas/gj_inverse.py::_gj_kernel.
//
// Computes, for each of R row-major (K, K) float32 matrices A, its inverse
// by Gauss-Jordan elimination over [A | I] without pivoting (valid for
// positive-definite A: every step leaves a positive-definite trailing
// block, so each pivot is positive).
//
// What bounds it on an H100: memory.  Each matrix is read once and its
// inverse written once (2 * 4K^2 bytes); the elimination does ~4K^3
// flops, ~6 flops per byte at K=20, below the FP32 line's ~20.  At K = 50
// it is 25 flops a byte and at K = 128 64: there the FP32 operations
// bound it, and in the CTA form below the shared-memory traffic of the
// per-pivot update (a read and a write a matrix entry a pivot).
//
// Design, K <= 32: one warp per matrix.  Lane j < K holds column j of A
// and column j of the running inverse in registers (the arrays are sized
// by a compile-time bound KMAX >= K, so every index is static after
// unrolling).  At pivot p the warp reads column p of A from lane p with
// K __shfl_sync broadcasts; each lane then scales its own row-p entries
// and eliminates its column.  Loads and stores are coalesced: for each
// row i, lanes j = 0..K-1 touch consecutive floats.  The TPU kernel's
// lane-major (K, K, R) transpose and 128-matrix padding were for VMEM
// tiles and are not needed here.
//
// Design, 32 < K <= 128: one CTA of 256 threads per matrix, held in
// shared memory (K x (K + 1) floats, 66 KB at K = 128; the odd row stride
// keeps a column read free of bank conflicts).  The elimination runs in
// place: column p of A is no longer needed once pivot p is taken, so it
// becomes column p of the inverse.  Per pivot the CTA first copies the
// scaled pivot row ([A | I]'s row p over the pivot, with the 1 of I's
// column p in place of A's) and the old column p into two K-float
// buffers, syncs, then updates every entry from the buffers and syncs
// again: a[i][j] = (j == p ? 0 : a[i][j]) - col[i] * row[j] for i != p,
// row[j] for i == p.  These are the same operations, on the same values,
// as the [A | I] form (A's column p is dropped there instead).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

template <int KMAX>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gj_inverse_kernel(const float* __restrict__ mats, int R, int K,
                  float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (r >= R) return;  // whole warp leaves together
  const bool active = lane < K;
  const float* src = mats + r * K * K;
  float a[KMAX], v[KMAX];
#pragma unroll
  for (int i = 0; i < KMAX; ++i) {
    a[i] = (active && i < K) ? src[i * K + lane] : 0.f;
    v[i] = (i == lane) ? 1.f : 0.f;
  }
#pragma unroll
  for (int p = 0; p < KMAX; ++p) {
    if (p < K) {  // uniform across the warp
      float col[KMAX];
#pragma unroll
      for (int i = 0; i < KMAX; ++i) col[i] = __shfl_sync(kFull, a[i], p);
      const float ar = a[p] / col[p];
      const float vr = v[p] / col[p];
#pragma unroll
      for (int i = 0; i < KMAX; ++i) {
        if (i == p) {
          a[i] = ar;
          v[i] = vr;
        } else {
          a[i] -= col[i] * ar;
          v[i] -= col[i] * vr;
        }
      }
    }
  }
  if (active) {
    float* dst = out + r * K * K;
#pragma unroll
    for (int i = 0; i < KMAX; ++i)
      if (i < K) dst[i * K + lane] = v[i];
  }
}

constexpr int kCtaThreads = 256;
constexpr int kMaxK = 128;

__global__ void __launch_bounds__(kCtaThreads)
gj_inverse_cta_kernel(const float* __restrict__ mats, int K, float* __restrict__ out) {
  extern __shared__ float sm[];
  const int S = K + 1;  // row stride in shared memory
  float* a = sm;  // K x S
  float* row = a + K * S;  // the scaled pivot row
  float* col = row + K;  // the pivot column before the step
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int kWarps = kCtaThreads / 32;
  const int64_t r = blockIdx.x;
  const float* src = mats + r * K * K;
  float* dst = out + r * K * K;
  // Warp w takes rows w, w + 8, ...; lane l columns l, l + 32, ...
  for (int i = warp; i < K; i += kWarps)
    for (int j = lane; j < K; j += 32) a[i * S + j] = src[(int64_t)i * K + j];
  __syncthreads();
  for (int p = 0; p < K; ++p) {
    const float piv = a[p * S + p];
    for (int j = threadIdx.x; j < K; j += kCtaThreads) {
      row[j] = (j == p ? 1.f : a[p * S + j]) / piv;
      col[j] = a[j * S + p];
    }
    __syncthreads();
    for (int i = warp; i < K; i += kWarps) {
      float* ai = a + i * S;
      if (i == p) {
        for (int j = lane; j < K; j += 32) ai[j] = row[j];
      } else {
        const float ci = col[i];
        for (int j = lane; j < K; j += 32) ai[j] = (j == p ? 0.f : ai[j]) - ci * row[j];
      }
    }
    __syncthreads();
  }
  for (int i = warp; i < K; i += kWarps)
    for (int j = lane; j < K; j += 32) dst[(int64_t)i * K + j] = a[i * S + j];
}

template <int KMAX>
void launch(const float* mats, int R, int K, float* out, cudaStream_t stream) {
  const int blocks = (R + kWarpsPerBlock - 1) / kWarpsPerBlock;
  gj_inverse_kernel<KMAX><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      mats, R, K, out);
}

cudaError_t launch_cta(const float* mats, int R, int K, float* out, cudaStream_t stream) {
  const int smem = (K * (K + 1) + 2 * K) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gj_inverse_cta_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  gj_inverse_cta_kernel<<<R, kCtaThreads, smem, stream>>>(mats, K, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" int pmf_gj_inverse(const float* mats, int R, int K, float* out,
                              void* stream) {
  if (K < 1 || K > kMaxK) return (int)cudaErrorInvalidValue;
  if (R > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (K <= 8) {
      launch<8>(mats, R, K, out, s);
    } else if (K <= 16) {
      launch<16>(mats, R, K, out, s);
    } else if (K <= 24) {
      launch<24>(mats, R, K, out, s);
    } else if (K <= 32) {
      launch<32>(mats, R, K, out, s);
    } else {
      return (int)launch_cta(mats, R, K, out, s);
    }
  }
  return (int)cudaGetLastError();
}
