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
// Design: one warp per self row, lane k holds factor k (K <= 32, lanes
// >= K hold 0).  The row's e_self is read once; the warp loads 32 edges'
// ids and ratings with one coalesced load each, then walks them, reading
// each other row as one coalesced K-float access and reducing the dot
// with __shfl_xor_sync.  Four edges are in flight at once so the L2 reads
// overlap.  Sums accumulate in registers in edge order: no atomics, so
// the result is deterministic.  A single very long row serialises one
// warp; the dense head (K2) takes the heaviest rows out of the tail.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

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
  const bool active = lane < K;
  const float es = active ? e_self[(int64_t)row * K + lane] : 0.f;
  float acc_a = 0.f, acc_o = 0.f;
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
      float eo[4], xv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int o = __shfl_sync(kFull, my_o, j + q);
        xv[q] = __shfl_sync(kFull, my_x, j + q);
        eo[q] = active ? __ldg(e_other + (int64_t)o * K + lane) : 0.f;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float p = es * eo[q];
        const float rate = fmaxf(warp_sum(p), rate_floor);
        acc_a += (xv[q] / rate) * p;
        acc_o += eo[q];
      }
    }
    for (; j < n; ++j) {
      const int o = __shfl_sync(kFull, my_o, j);
      const float xv = __shfl_sync(kFull, my_x, j);
      const float eo = active ? __ldg(e_other + (int64_t)o * K + lane) : 0.f;
      const float p = es * eo;
      const float rate = fmaxf(warp_sum(p), rate_floor);
      acc_a += (xv / rate) * p;
      acc_o += eo;
    }
  }
  if (active) {
    float* dst = out + (int64_t)row * 2 * K;
    dst[lane] = acc_a;
    dst[K + lane] = acc_o;
  }
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
cavi_edge_raw_kernel(const float* __restrict__ e_self,
                     const float* __restrict__ e_other,
                     const int64_t* __restrict__ row_ptr,
                     const int32_t* __restrict__ other,
                     int n_self, int K, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n_self) return;  // whole warp leaves together
  const bool active = lane < K;
  const float es = active ? e_self[(int64_t)row * K + lane] : 0.f;
  float acc_p = 0.f, acc_o = 0.f;
  const int64_t begin = row_ptr[row];
  const int64_t end = row_ptr[row + 1];
  for (int64_t base = begin; base < end; base += 32) {
    const int64_t left = end - base;
    const int n = left < 32 ? (int)left : 32;
    const int my_o = lane < n ? other[base + lane] : 0;
    int j = 0;
    for (; j + 4 <= n; j += 4) {
      float eo[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int o = __shfl_sync(kFull, my_o, j + q);
        eo[q] = active ? __ldg(e_other + (int64_t)o * K + lane) : 0.f;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc_p += es * eo[q];
        acc_o += eo[q];
      }
    }
    for (; j < n; ++j) {
      const int o = __shfl_sync(kFull, my_o, j);
      const float eo = active ? __ldg(e_other + (int64_t)o * K + lane) : 0.f;
      acc_p += es * eo;
      acc_o += eo;
    }
  }
  if (active) {
    float* dst = out + (int64_t)row * 2 * K;
    dst[lane] = acc_p;
    dst[K + lane] = acc_o;
  }
}

}  // namespace

extern "C" int pmf_cavi_edge_raw(const float* e_self, const float* e_other,
                                 const int64_t* row_ptr, const int32_t* other,
                                 int n_self, int K, float* out, void* stream) {
  if (n_self > 0) {
    const int blocks = (n_self + kWarpsPerBlock - 1) / kWarpsPerBlock;
    cavi_edge_raw_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        e_self, e_other, row_ptr, other, n_self, K, out);
  }
  return (int)cudaGetLastError();
}

extern "C" int pmf_cavi_edge(const float* e_self, const float* e_other,
                             const int64_t* row_ptr, const int32_t* other,
                             const float* x, int n_self, int K,
                             float rate_floor, float* out, void* stream) {
  if (n_self > 0) {
    const int blocks = (n_self + kWarpsPerBlock - 1) / kWarpsPerBlock;
    cavi_edge_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        e_self, e_other, row_ptr, other, x, n_self, K, rate_floor, out);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* pmf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
