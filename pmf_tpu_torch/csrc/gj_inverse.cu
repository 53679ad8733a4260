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
// flops, ~6 flops per byte at K=20, below the FP32 line's ~20.
//
// Design: one warp per matrix.  Lane j < K holds column j of A and column
// j of the running inverse in registers (the arrays are sized by a
// compile-time bound KMAX >= K, so every index is static after
// unrolling).  At pivot p the warp reads column p of A from lane p with
// K __shfl_sync broadcasts; each lane then scales its own row-p entries
// and eliminates its column.  Loads and stores are coalesced: for each
// row i, lanes j = 0..K-1 touch consecutive floats.  The TPU kernel's
// lane-major (K, K, R) transpose and 128-matrix padding were for VMEM
// tiles and are not needed here.

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

template <int KMAX>
void launch(const float* mats, int R, int K, float* out, cudaStream_t stream) {
  const int blocks = (R + kWarpsPerBlock - 1) / kWarpsPerBlock;
  gj_inverse_kernel<KMAX><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      mats, R, K, out);
}

}  // namespace

extern "C" int pmf_gj_inverse(const float* mats, int R, int K, float* out,
                              void* stream) {
  if (K < 1 || K > 32) return (int)cudaErrorInvalidValue;
  if (R > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (K <= 8) {
      launch<8>(mats, R, K, out, s);
    } else if (K <= 16) {
      launch<16>(mats, R, K, out, s);
    } else if (K <= 24) {
      launch<24>(mats, R, K, out, s);
    } else {
      launch<32>(mats, R, K, out, s);
    }
  }
  return (int)cudaGetLastError();
}
