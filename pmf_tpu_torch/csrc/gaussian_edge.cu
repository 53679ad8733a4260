// K3, K5, K6 — sparse-tail edge passes of the Gaussian CAVI blocks.
//
// Replace: pmf_tpu/ops/pallas/gaussian_edge.py::_factor_kernel (K3),
//          pmf_tpu/ops/pallas/gaussian_edge.py::_bias_kernel (K5),
//          pmf_tpu/ops/pallas/gaussian_edge.py::_diag_kernel (K6).
//
// All three walk the direction's CSR tail (row_ptr, other, x over
// new-space self rows) with one warp per self row, as K1 does, and write
// per-row sums in edge order: no atomics, deterministic.  Rows without
// tail edges get zeros.  Other-row records are read from a table that
// the wrapper builds once per pass (permuted into new space):
//
//   K3 factor pass, record [m | b | triu(V + m m^T)] (K + 1 + T floats,
//      T = K(K+1)/2); output per self row
//      [sum m_o (x - b_o) | sum m_o | sum tri_o (| sum x | sum b_o)],
//      2K + T (+ 2) columns.  The wrapper applies the -b_self * sum m_o
//      correction and unpacks the triangle.
//   K5 bias pass, record [m | b] (K + 1); output [sum m_o | sum b_o | sum x].
//   K6 diag pass, record [m | v + m^2 | b] (2K + 1) and the self row's
//      [m | b]; output [sum m_o (x - b_s - b_o - <m_s, m_o>) |
//      sum (v_o + m_o^2) | sum m_o^2], 3K columns.
//
// What bounds them on an H100: memory.  K3 reads a 924-byte record per
// edge at K=20; the tables (59k x 924 B = 55 MB by user, 162k x 924 B =
// 150 MB by item) do not fit the 50 MB L2, so record gathers come from
// HBM, ~5 flops per 4 bytes read.  K5 and K6 read 84 and 164 bytes per
// edge from tables that do fit L2, and are latency-bound on the gathers
// like K1.
//
// Design: in K3, lane l reads record floats l, l + 32, ... (one coalesced
// 128-byte pass per 32 floats, NI = ceil((K+1+T)/32) loads a lane, all
// in flight together) and keeps one accumulator per loaded float, so the
// record's layout is the accumulator layout: lanes < K own a factor (and
// also sum m_o), lane K sums b_o, the rest sum triangle entries.  b_o is
// broadcast from lane K with one shuffle.  Two edges are in flight at a
// time.  K5 is the narrow pass: lane k < K holds factor k, lane K the
// bias.  K6 loads the self row's [m | b] once per warp and reduces
// <m_s, m_o> with a 5-step __shfl_xor_sync, as K1 does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;
// Largest K the factor pass takes: K + 1 + K(K+1)/2 <= 16 * 32 floats.
constexpr int kFactorMaxK = 30;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// ---------------------------------------------------------------- K3 --

template <int NI>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
factor_kernel(const float* __restrict__ aug, const int64_t* __restrict__ row_ptr,
              const int32_t* __restrict__ other, const float* __restrict__ x,
              int n_self, int K, int with_bias_stats, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n_self) return;  // whole warp leaves together
  const int T = K * (K + 1) / 2;
  const int w_in = K + 1 + T;
  const bool is_m = lane < K;
  float acc[NI];
#pragma unroll
  for (int t = 0; t < NI; ++t) acc[t] = 0.f;
  float acc_m = 0.f, acc_x = 0.f;

  auto load = [&](int o, float (&val)[NI]) {
    const float* rec = aug + (int64_t)o * w_in;
#pragma unroll
    for (int t = 0; t < NI; ++t) {
      const int c = t * 32 + lane;
      val[t] = c < w_in ? __ldg(rec + c) : 0.f;
    }
  };
  auto add = [&](const float (&val)[NI], float xv) {
    const float b = __shfl_sync(kFull, val[0], K);
    acc[0] += is_m ? val[0] * (xv - b) : val[0];
    acc_m += is_m ? val[0] : 0.f;
#pragma unroll
    for (int t = 1; t < NI; ++t) acc[t] += val[t];
    acc_x += xv;
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
    for (; j + 2 <= n; j += 2) {
      float v0[NI], v1[NI];
      const int o0 = __shfl_sync(kFull, my_o, j);
      const int o1 = __shfl_sync(kFull, my_o, j + 1);
      const float x0 = __shfl_sync(kFull, my_x, j);
      const float x1 = __shfl_sync(kFull, my_x, j + 1);
      load(o0, v0);
      load(o1, v1);
      add(v0, x0);
      add(v1, x1);
    }
    if (j < n) {
      float v0[NI];
      const int o0 = __shfl_sync(kFull, my_o, j);
      const float x0 = __shfl_sync(kFull, my_x, j);
      load(o0, v0);
      add(v0, x0);
    }
  }

  const int w_out = 2 * K + T + (with_bias_stats ? 2 : 0);
  float* dst = out + (int64_t)row * w_out;
#pragma unroll
  for (int t = 0; t < NI; ++t) {
    const int c = t * 32 + lane;
    if (c >= w_in) continue;
    if (c < K) {
      dst[c] = acc[t];
      dst[K + c] = acc_m;
    } else if (c == K) {
      if (with_bias_stats) dst[2 * K + T + 1] = acc[t];
    } else {
      dst[2 * K + (c - K - 1)] = acc[t];
    }
  }
  if (with_bias_stats && lane == 0) dst[2 * K + T] = acc_x;
}

template <int NI>
void launch_factor(const float* aug, const int64_t* row_ptr, const int32_t* other,
                   const float* x, int n_self, int K, int with_bias_stats,
                   float* out, cudaStream_t stream) {
  const int blocks = (n_self + kWarpsPerBlock - 1) / kWarpsPerBlock;
  factor_kernel<NI><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      aug, row_ptr, other, x, n_self, K, with_bias_stats, out);
}

// ---------------------------------------------------------------- K5 --

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
bias_kernel(const float* __restrict__ aug, const int64_t* __restrict__ row_ptr,
            const int32_t* __restrict__ other, const float* __restrict__ x,
            int n_self, int K, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n_self) return;
  const int w_in = K + 1;
  const bool active = lane < w_in;
  float acc = 0.f, acc_x = 0.f;
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
      float v[4], xv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int o = __shfl_sync(kFull, my_o, j + q);
        xv[q] = __shfl_sync(kFull, my_x, j + q);
        v[q] = active ? __ldg(aug + (int64_t)o * w_in + lane) : 0.f;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc += v[q];
        acc_x += xv[q];
      }
    }
    for (; j < n; ++j) {
      const int o = __shfl_sync(kFull, my_o, j);
      acc_x += __shfl_sync(kFull, my_x, j);
      acc += active ? __ldg(aug + (int64_t)o * w_in + lane) : 0.f;
    }
  }
  float* dst = out + (int64_t)row * (K + 2);
  if (active) dst[lane] = acc;
  if (lane == 0) dst[K + 1] = acc_x;
}

// ---------------------------------------------------------------- K6 --

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
diag_kernel(const float* __restrict__ aug, const float* __restrict__ self_tab,
            const int64_t* __restrict__ row_ptr, const int32_t* __restrict__ other,
            const float* __restrict__ x, int n_self, int K,
            float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n_self) return;
  const int w_in = 2 * K + 1;
  const bool active = lane < K;
  const float* self_rec = self_tab + (int64_t)row * (K + 1);
  const float ms = active ? self_rec[lane] : 0.f;
  const float bs = self_rec[K];
  float acc_mr = 0.f, acc_sq = 0.f, acc_mm = 0.f;

  auto edge = [&](float m, float sq, float bo, float xv) {
    const float pred = warp_sum(ms * m);
    acc_mr += m * ((xv - bs - bo) - pred);
    acc_sq += sq;
    acc_mm += m * m;
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
      float m[4], sq[4], bo[4], xv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int o = __shfl_sync(kFull, my_o, j + q);
        xv[q] = __shfl_sync(kFull, my_x, j + q);
        const float* rec = aug + (int64_t)o * w_in;
        m[q] = active ? __ldg(rec + lane) : 0.f;
        sq[q] = active ? __ldg(rec + K + lane) : 0.f;
        bo[q] = __ldg(rec + 2 * K);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) edge(m[q], sq[q], bo[q], xv[q]);
    }
    for (; j < n; ++j) {
      const int o = __shfl_sync(kFull, my_o, j);
      const float xv = __shfl_sync(kFull, my_x, j);
      const float* rec = aug + (int64_t)o * w_in;
      edge(active ? __ldg(rec + lane) : 0.f, active ? __ldg(rec + K + lane) : 0.f,
           __ldg(rec + 2 * K), xv);
    }
  }
  if (active) {
    float* dst = out + (int64_t)row * 3 * K;
    dst[lane] = acc_mr;
    dst[K + lane] = acc_sq;
    dst[2 * K + lane] = acc_mm;
  }
}

int blocks_for(int n_self) { return (n_self + kWarpsPerBlock - 1) / kWarpsPerBlock; }

}  // namespace

extern "C" int pmf_gauss_factor(const float* aug, const int64_t* row_ptr,
                                const int32_t* other, const float* x, int n_self,
                                int K, int with_bias_stats, float* out,
                                void* stream) {
  if (K < 1 || K > kFactorMaxK) return (int)cudaErrorInvalidValue;
  if (n_self > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int ni = (K + 1 + K * (K + 1) / 2 + 31) / 32;
    switch (ni) {
#define PMF_NI_CASE(N)                                                     \
  case N:                                                                  \
    launch_factor<N>(aug, row_ptr, other, x, n_self, K, with_bias_stats,   \
                     out, s);                                              \
    break;
      PMF_NI_CASE(1) PMF_NI_CASE(2) PMF_NI_CASE(3) PMF_NI_CASE(4)
      PMF_NI_CASE(5) PMF_NI_CASE(6) PMF_NI_CASE(7) PMF_NI_CASE(8)
      PMF_NI_CASE(9) PMF_NI_CASE(10) PMF_NI_CASE(11) PMF_NI_CASE(12)
      PMF_NI_CASE(13) PMF_NI_CASE(14) PMF_NI_CASE(15) PMF_NI_CASE(16)
#undef PMF_NI_CASE
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}

extern "C" int pmf_gauss_bias(const float* aug, const int64_t* row_ptr,
                              const int32_t* other, const float* x, int n_self,
                              int K, float* out, void* stream) {
  if (K < 1 || K > 31) return (int)cudaErrorInvalidValue;
  if (n_self > 0) {
    bias_kernel<<<blocks_for(n_self), kWarpsPerBlock * 32, 0,
                  static_cast<cudaStream_t>(stream)>>>(aug, row_ptr, other, x,
                                                       n_self, K, out);
  }
  return (int)cudaGetLastError();
}

extern "C" int pmf_gauss_diag(const float* aug, const float* self_tab,
                              const int64_t* row_ptr, const int32_t* other,
                              const float* x, int n_self, int K, float* out,
                              void* stream) {
  if (K < 1 || K > 32) return (int)cudaErrorInvalidValue;
  if (n_self > 0) {
    diag_kernel<<<blocks_for(n_self), kWarpsPerBlock * 32, 0,
                  static_cast<cudaStream_t>(stream)>>>(aug, self_tab, row_ptr,
                                                       other, x, n_self, K, out);
  }
  return (int)cudaGetLastError();
}
