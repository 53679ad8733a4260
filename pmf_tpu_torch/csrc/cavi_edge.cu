// K1 — sparse-tail CAVI edge pass for the Poisson/HPF family.
//
// Replaces: pmf_tpu/ops/pallas/cavi_edge.py::_kernel (modes "cavi" and
// "raw").
//
// Computes, per new-space self row r with tail edges (r, o, x) in CSR:
//   out[r, 0:K]  = sum_e x * e_self[r] * e_other[o] / max(<e_self[r], e_other[o]>, floor)
//   out[r, K:2K] = sum_e e_other[o]
// Rows without tail edges get zeros.  Mode "raw" (cavi_edge_raw_kernel)
// drops the rating and the rate: out[r, 0:K] = sum_e e_self[r] * e_other[o],
// the statistic the tensor-parallel extended-Poisson scalar pass reads
// when the other table arrives pre-scaled.  It keeps the skeleton below
// without the per-edge reduction: each lane sums its own factor.
//
// What bounds it on an H100: memory.  Per edge it moves an 8-byte
// (other id, rating) pair from HBM and one K-float row of the other table;
// the tables (<= ~13 MB at 162k x 20 f32) stay resident in the 50 MB L2,
// so HBM traffic is ~8 B per edge plus one read of each table and one
// write of each output row.  The arithmetic (~5K flops per edge) is far
// below the FP32 line.
//
// Design: one warp per self row; lane l holds factors l, l + 32, ... (F =
// ceil(K / 32) a lane, a template parameter: F = 1 for K <= 32, up to 4
// for K <= 128; factors >= K hold 0).  The row's e_self is read once; the
// warp loads 32 edges' ids and ratings with one coalesced load each, then
// walks them, reading each other row as F coalesced 32-float accesses and
// reducing the dot with one __shfl_xor_sync butterfly an edge (each lane
// first adds its F products).  Four edges are in flight at once so the L2
// reads overlap.  Sums accumulate in registers in edge order: no atomics,
// so the result is deterministic.  A single very long row serialises one
// warp; the dense head (K2) takes the heaviest rows out of the tail.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxK = 128;  // F = ceil(K / 32) <= 4 factors a lane

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

template <int F>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
cavi_edge_kernel(const float* __restrict__ e_self,
                 const float* __restrict__ e_other,
                 const int64_t* __restrict__ row_ptr,
                 const int32_t* __restrict__ other,
                 const float* __restrict__ x,
                 int n_self, int K, float rate_floor,
                 float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n_self) return;  // whole warp leaves together
  float es[F], acc_a[F], acc_o[F];
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const int k = 32 * f + lane;
    es[f] = k < K ? e_self[(int64_t)row * K + k] : 0.f;
    acc_a[f] = 0.f;
    acc_o[f] = 0.f;
  }
  // One edge: the rate from the warp's dot, then the lane's F factors.
  auto edge = [&](const float (&eo)[F], float xv) {
    float p[F];
    float part = es[0] * eo[0];
    p[0] = part;
#pragma unroll
    for (int f = 1; f < F; ++f) {
      p[f] = es[f] * eo[f];
      part += p[f];
    }
    const float rate = fmaxf(warp_sum(part), rate_floor);
#pragma unroll
    for (int f = 0; f < F; ++f) {
      acc_a[f] += (xv / rate) * p[f];
      acc_o[f] += eo[f];
    }
  };
  auto gather = [&](int o, float (&eo)[F]) {
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const int k = 32 * f + lane;
      eo[f] = k < K ? __ldg(e_other + (int64_t)o * K + k) : 0.f;
    }
  };
  const int64_t begin = row_ptr[row];
  const int64_t end = row_ptr[row + 1];
  for (int64_t base = begin; base < end; base += 32) {
    const int64_t left = end - base;
    const int n = left < 32 ? (int)left : 32;
    int my_o = 0;
    float my_x = 0.f;
    if (lane < n) {
      my_o = other[base + lane];
      my_x = x[base + lane];
    }
    int j = 0;
    for (; j + 4 <= n; j += 4) {
      float eo[4][F], xv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int o = __shfl_sync(kFull, my_o, j + q);
        xv[q] = __shfl_sync(kFull, my_x, j + q);
        gather(o, eo[q]);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) edge(eo[q], xv[q]);
    }
    for (; j < n; ++j) {
      const int o = __shfl_sync(kFull, my_o, j);
      const float xv = __shfl_sync(kFull, my_x, j);
      float eo[F];
      gather(o, eo);
      edge(eo, xv);
    }
  }
  float* dst = out + (int64_t)row * 2 * K;
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const int k = 32 * f + lane;
    if (k < K) {
      dst[k] = acc_a[f];
      dst[K + k] = acc_o[f];
    }
  }
}

template <int F>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
cavi_edge_raw_kernel(const float* __restrict__ e_self,
                     const float* __restrict__ e_other,
                     const int64_t* __restrict__ row_ptr,
                     const int32_t* __restrict__ other,
                     int n_self, int K, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n_self) return;  // whole warp leaves together
  float es[F], acc_p[F], acc_o[F];
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const int k = 32 * f + lane;
    es[f] = k < K ? e_self[(int64_t)row * K + k] : 0.f;
    acc_p[f] = 0.f;
    acc_o[f] = 0.f;
  }
  auto gather = [&](int o, float (&eo)[F]) {
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const int k = 32 * f + lane;
      eo[f] = k < K ? __ldg(e_other + (int64_t)o * K + k) : 0.f;
    }
  };
  auto edge = [&](const float (&eo)[F]) {
#pragma unroll
    for (int f = 0; f < F; ++f) {
      acc_p[f] += es[f] * eo[f];
      acc_o[f] += eo[f];
    }
  };
  const int64_t begin = row_ptr[row];
  const int64_t end = row_ptr[row + 1];
  for (int64_t base = begin; base < end; base += 32) {
    const int64_t left = end - base;
    const int n = left < 32 ? (int)left : 32;
    const int my_o = lane < n ? other[base + lane] : 0;
    int j = 0;
    for (; j + 4 <= n; j += 4) {
      float eo[4][F];
#pragma unroll
      for (int q = 0; q < 4; ++q) gather(__shfl_sync(kFull, my_o, j + q), eo[q]);
#pragma unroll
      for (int q = 0; q < 4; ++q) edge(eo[q]);
    }
    for (; j < n; ++j) {
      float eo[F];
      gather(__shfl_sync(kFull, my_o, j), eo);
      edge(eo);
    }
  }
  float* dst = out + (int64_t)row * 2 * K;
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const int k = 32 * f + lane;
    if (k < K) {
      dst[k] = acc_p[f];
      dst[K + k] = acc_o[f];
    }
  }
}

// Launch KERNEL<F> with F = ceil(K / 32) factors a lane (K <= 128).
#define PMF_LAUNCH_F(KERNEL, K, GRID, STREAM, ...)                          \
  switch (((K) + 31) / 32) {                                                 \
    case 1: KERNEL<1><<<GRID, kWarpsPerBlock * 32, 0, STREAM>>>(__VA_ARGS__); break; \
    case 2: KERNEL<2><<<GRID, kWarpsPerBlock * 32, 0, STREAM>>>(__VA_ARGS__); break; \
    case 3: KERNEL<3><<<GRID, kWarpsPerBlock * 32, 0, STREAM>>>(__VA_ARGS__); break; \
    case 4: KERNEL<4><<<GRID, kWarpsPerBlock * 32, 0, STREAM>>>(__VA_ARGS__); break; \
    default: return (int)cudaErrorInvalidValue;                              \
  }

}  // namespace

extern "C" int pmf_cavi_edge_raw(const float* e_self, const float* e_other,
                                 const int64_t* row_ptr, const int32_t* other,
                                 int n_self, int K, float* out, void* stream) {
  if (K < 1 || K > kMaxK) return (int)cudaErrorInvalidValue;
  if (n_self > 0) {
    const int blocks = (n_self + kWarpsPerBlock - 1) / kWarpsPerBlock;
    PMF_LAUNCH_F(cavi_edge_raw_kernel, K, blocks, static_cast<cudaStream_t>(stream),
                 e_self, e_other, row_ptr, other, n_self, K, out);
  }
  return (int)cudaGetLastError();
}

extern "C" int pmf_cavi_edge(const float* e_self, const float* e_other,
                             const int64_t* row_ptr, const int32_t* other,
                             const float* x, int n_self, int K,
                             float rate_floor, float* out, void* stream) {
  if (K < 1 || K > kMaxK) return (int)cudaErrorInvalidValue;
  if (n_self > 0) {
    const int blocks = (n_self + kWarpsPerBlock - 1) / kWarpsPerBlock;
    PMF_LAUNCH_F(cavi_edge_kernel, K, blocks, static_cast<cudaStream_t>(stream),
                 e_self, e_other, row_ptr, other, x, n_self, K, rate_floor, out);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* pmf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
