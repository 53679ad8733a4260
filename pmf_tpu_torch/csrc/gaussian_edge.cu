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
// Design: in K3, lane l reads record floats c0 + l, c0 + l + 32, ... (one
// coalesced 128-byte pass per 32 floats, NI loads a lane, all in flight
// together) and keeps one accumulator per loaded float, so the record's
// layout is the accumulator layout: floats < K are factors (also summed
// into sum m_o), float K sums b_o, the rest sum triangle entries.  b_o is
// broadcast with one shuffle from the lane that loaded it.  Two edges are
// in flight at a time.  Up to K = 30 the whole record fits NI <= 16 loads
// a lane, one warp a row (c0 = 0).  Past that (K + 1 + T up to 8,385
// floats at K = 128) the record is cut into chunks of 16 * 32 floats on
// grid.y: each chunk's warp walks the row's edges again, rereading the 8
// bytes of id and rating an edge, and keeps 16 accumulators a lane; the
// first chunk holds all of m and b (K + 1 <= 512), so it alone computes
// m (x - b), sum m and sum x.  MT = ceil(K / 32) loads hold the factors.
// K5 is the narrow pass: lanes hold the K + 1 record floats, F =
// ceil((K + 1) / 32) a lane.  K6 loads the self row's [m | b] once per
// warp, F = ceil(K / 32) factors a lane, and reduces <m_s, m_o> with one
// __shfl_xor_sync butterfly an edge, as K1 does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxK = 128;
// Record floats a K3 chunk loads (16 a lane) past K = 30, where the whole
// record no longer fits one warp's 16 loads a lane.
constexpr int kChunkNI = 16;
constexpr int kWholeRecordMaxK = 30;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// ---------------------------------------------------------------- K3 --

// One warp per (self row, record chunk blockIdx.y of NI * 32 floats).
template <int NI, int MT>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
factor_kernel(const float* __restrict__ aug, const int64_t* __restrict__ row_ptr,
              const int32_t* __restrict__ other, const float* __restrict__ x,
              int n_self, int K, int with_bias_stats, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n_self) return;  // whole warp leaves together
  const int T = K * (K + 1) / 2;
  const int w_in = K + 1 + T;
  const int c0 = blockIdx.y * NI * 32;
  const bool first = blockIdx.y == 0;  // the chunk with m and b
  const int tb = K >> 5;  // b is load tb of lane K & 31
  float acc[NI];
#pragma unroll
  for (int t = 0; t < NI; ++t) acc[t] = 0.f;
  float acc_m[MT];
#pragma unroll
  for (int t = 0; t < MT; ++t) acc_m[t] = 0.f;
  float acc_x = 0.f;

  auto load = [&](int o, float (&val)[NI]) {
    const float* rec = aug + (int64_t)o * w_in + c0;
#pragma unroll
    for (int t = 0; t < NI; ++t) {
      const int c = c0 + t * 32 + lane;
      val[t] = c < w_in ? __ldg(rec + t * 32 + lane) : 0.f;
    }
  };
  auto add = [&](const float (&val)[NI], float xv) {
    if (first) {
      float bsrc = val[0];
#pragma unroll
      for (int t = 1; t <= MT && t < NI; ++t)
        if (t == tb) bsrc = val[t];
      const float b = __shfl_sync(kFull, bsrc, K & 31);
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        const bool is_m = t * 32 + lane < K;
        acc[t] += is_m ? val[t] * (xv - b) : val[t];
        acc_m[t] += is_m ? val[t] : 0.f;
      }
#pragma unroll
      for (int t = MT; t < NI; ++t) acc[t] += val[t];
      acc_x += xv;
    } else {
#pragma unroll
      for (int t = 0; t < NI; ++t) acc[t] += val[t];
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
    const int c = c0 + t * 32 + lane;
    if (c >= w_in) continue;
    if (c < K) {
      dst[c] = acc[t];
      dst[K + c] = acc_m[t < MT ? t : 0];  // c < K holds only in the first MT loads
    } else if (c == K) {
      if (with_bias_stats) dst[2 * K + T + 1] = acc[t];
    } else {
      dst[2 * K + (c - K - 1)] = acc[t];
    }
  }
  if (with_bias_stats && first && lane == 0) dst[2 * K + T] = acc_x;
}

template <int NI, int MT>
void launch_factor(const float* aug, const int64_t* row_ptr, const int32_t* other,
                   const float* x, int n_self, int K, int with_bias_stats,
                   float* out, cudaStream_t stream) {
  const int w_in = K + 1 + K * (K + 1) / 2;
  const dim3 grid((n_self + kWarpsPerBlock - 1) / kWarpsPerBlock,
                  (w_in + NI * 32 - 1) / (NI * 32));
  factor_kernel<NI, MT><<<grid, kWarpsPerBlock * 32, 0, stream>>>(
      aug, row_ptr, other, x, n_self, K, with_bias_stats, out);
}

// ---------------------------------------------------------------- K5 --

// Lane l holds record floats l, l + 32, ... of [m | b] (F a lane).
template <int F>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
bias_kernel(const float* __restrict__ aug, const int64_t* __restrict__ row_ptr,
            const int32_t* __restrict__ other, const float* __restrict__ x,
            int n_self, int K, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n_self) return;
  const int w_in = K + 1;
  float acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.f;
  float acc_x = 0.f;
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
      float v[4][F], xv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int o = __shfl_sync(kFull, my_o, j + q);
        xv[q] = __shfl_sync(kFull, my_x, j + q);
        const float* rec = aug + (int64_t)o * w_in;
#pragma unroll
        for (int f = 0; f < F; ++f) {
          const int c = 32 * f + lane;
          v[q][f] = c < w_in ? __ldg(rec + c) : 0.f;
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int f = 0; f < F; ++f) acc[f] += v[q][f];
        acc_x += xv[q];
      }
    }
    for (; j < n; ++j) {
      const int o = __shfl_sync(kFull, my_o, j);
      acc_x += __shfl_sync(kFull, my_x, j);
      const float* rec = aug + (int64_t)o * w_in;
#pragma unroll
      for (int f = 0; f < F; ++f) {
        const int c = 32 * f + lane;
        acc[f] += c < w_in ? __ldg(rec + c) : 0.f;
      }
    }
  }
  float* dst = out + (int64_t)row * (K + 2);
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const int c = 32 * f + lane;
    if (c < w_in) dst[c] = acc[f];
  }
  if (lane == 0) dst[K + 1] = acc_x;
}

// ---------------------------------------------------------------- K6 --

// Lane l holds factors l, l + 32, ... (F a lane).
template <int F>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
diag_kernel(const float* __restrict__ aug, const float* __restrict__ self_tab,
            const int64_t* __restrict__ row_ptr, const int32_t* __restrict__ other,
            const float* __restrict__ x, int n_self, int K,
            float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n_self) return;
  const int w_in = 2 * K + 1;
  const float* self_rec = self_tab + (int64_t)row * (K + 1);
  float ms[F], acc_mr[F], acc_sq[F], acc_mm[F];
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const int k = 32 * f + lane;
    ms[f] = k < K ? self_rec[k] : 0.f;
    acc_mr[f] = 0.f;
    acc_sq[f] = 0.f;
    acc_mm[f] = 0.f;
  }
  const float bs = self_rec[K];

  auto gather = [&](int o, float (&m)[F], float (&sq)[F], float& bo) {
    const float* rec = aug + (int64_t)o * w_in;
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const int k = 32 * f + lane;
      m[f] = k < K ? __ldg(rec + k) : 0.f;
      sq[f] = k < K ? __ldg(rec + K + k) : 0.f;
    }
    bo = __ldg(rec + 2 * K);
  };
  auto edge = [&](const float (&m)[F], const float (&sq)[F], float bo, float xv) {
    float part = ms[0] * m[0];
#pragma unroll
    for (int f = 1; f < F; ++f) part += ms[f] * m[f];
    const float pred = warp_sum(part);
#pragma unroll
    for (int f = 0; f < F; ++f) {
      acc_mr[f] += m[f] * ((xv - bs - bo) - pred);
      acc_sq[f] += sq[f];
      acc_mm[f] += m[f] * m[f];
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
      float m[4][F], sq[4][F], bo[4], xv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int o = __shfl_sync(kFull, my_o, j + q);
        xv[q] = __shfl_sync(kFull, my_x, j + q);
        gather(o, m[q], sq[q], bo[q]);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) edge(m[q], sq[q], bo[q], xv[q]);
    }
    for (; j < n; ++j) {
      const int o = __shfl_sync(kFull, my_o, j);
      const float xv = __shfl_sync(kFull, my_x, j);
      float m[F], sq[F], bo;
      gather(o, m, sq, bo);
      edge(m, sq, bo, xv);
    }
  }
  float* dst = out + (int64_t)row * 3 * K;
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const int k = 32 * f + lane;
    if (k < K) {
      dst[k] = acc_mr[f];
      dst[K + k] = acc_sq[f];
      dst[2 * K + k] = acc_mm[f];
    }
  }
}

int blocks_for(int n_self) { return (n_self + kWarpsPerBlock - 1) / kWarpsPerBlock; }

}  // namespace

extern "C" int pmf_gauss_factor(const float* aug, const int64_t* row_ptr,
                                const int32_t* other, const float* x, int n_self,
                                int K, int with_bias_stats, float* out,
                                void* stream) {
  if (K < 1 || K > kMaxK) return (int)cudaErrorInvalidValue;
  if (n_self > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    // Whole records: NI = ceil(w_in / 32) loads a lane; chunks of 16 past K = 30.
    const int ni = K <= kWholeRecordMaxK ? (K + 1 + K * (K + 1) / 2 + 31) / 32 : 0;
    switch (ni) {
#define PMF_NI_CASE(N)                                                     \
  case N:                                                                  \
    launch_factor<N, 1>(aug, row_ptr, other, x, n_self, K, with_bias_stats, \
                        out, s);                                           \
    break;
      PMF_NI_CASE(1) PMF_NI_CASE(2) PMF_NI_CASE(3) PMF_NI_CASE(4)
      PMF_NI_CASE(5) PMF_NI_CASE(6) PMF_NI_CASE(7) PMF_NI_CASE(8)
      PMF_NI_CASE(9) PMF_NI_CASE(10) PMF_NI_CASE(11) PMF_NI_CASE(12)
      PMF_NI_CASE(13) PMF_NI_CASE(14) PMF_NI_CASE(15) PMF_NI_CASE(16)
#undef PMF_NI_CASE
      default:
        switch ((K + 31) / 32) {
#define PMF_MT_CASE(M)                                                          \
  case M:                                                                       \
    launch_factor<kChunkNI, M>(aug, row_ptr, other, x, n_self, K, with_bias_stats, \
                               out, s);                                         \
    break;
          PMF_MT_CASE(1) PMF_MT_CASE(2) PMF_MT_CASE(3) PMF_MT_CASE(4)
#undef PMF_MT_CASE
          default:
            return (int)cudaErrorInvalidValue;
        }
    }
  }
  return (int)cudaGetLastError();
}

// Launch KERNEL<F> for F = 1..5 (5 covers K5's K + 1 <= 129 record floats).
#define PMF_LAUNCH_F(KERNEL, F, GRID, STREAM, ...)                          \
  switch (F) {                                                               \
    case 1: KERNEL<1><<<GRID, kWarpsPerBlock * 32, 0, STREAM>>>(__VA_ARGS__); break; \
    case 2: KERNEL<2><<<GRID, kWarpsPerBlock * 32, 0, STREAM>>>(__VA_ARGS__); break; \
    case 3: KERNEL<3><<<GRID, kWarpsPerBlock * 32, 0, STREAM>>>(__VA_ARGS__); break; \
    case 4: KERNEL<4><<<GRID, kWarpsPerBlock * 32, 0, STREAM>>>(__VA_ARGS__); break; \
    case 5: KERNEL<5><<<GRID, kWarpsPerBlock * 32, 0, STREAM>>>(__VA_ARGS__); break; \
    default: return (int)cudaErrorInvalidValue;                              \
  }

extern "C" int pmf_gauss_bias(const float* aug, const int64_t* row_ptr,
                              const int32_t* other, const float* x, int n_self,
                              int K, float* out, void* stream) {
  if (K < 1 || K > kMaxK) return (int)cudaErrorInvalidValue;
  if (n_self > 0) {
    PMF_LAUNCH_F(bias_kernel, (K + 1 + 31) / 32, blocks_for(n_self),
                 static_cast<cudaStream_t>(stream), aug, row_ptr, other, x, n_self,
                 K, out);
  }
  return (int)cudaGetLastError();
}

extern "C" int pmf_gauss_diag(const float* aug, const float* self_tab,
                              const int64_t* row_ptr, const int32_t* other,
                              const float* x, int n_self, int K, float* out,
                              void* stream) {
  if (K < 1 || K > kMaxK) return (int)cudaErrorInvalidValue;
  if (n_self > 0) {
    PMF_LAUNCH_F(diag_kernel, (K + 31) / 32, blocks_for(n_self),
                 static_cast<cudaStream_t>(stream), aug, self_tab, row_ptr, other, x,
                 n_self, K, out);
  }
  return (int)cudaGetLastError();
}
