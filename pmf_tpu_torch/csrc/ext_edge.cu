// K7 and K8 — sparse-tail edge passes of the extended Poisson model
// (x ~ Poisson(phi_u psi_i <theta_u, beta_i>), scalar activity factors).
//
// Replaces: pmf_tpu/ops/pallas/ext_edge.py::_factor_kernel (K7) and
//           pmf_tpu/ops/pallas/ext_edge.py::_scalar_kernel (K8).
//
// Per new-space self row r with tail edges (r, o, x) in CSR, with s the
// other side's scalar expectations:
//   K7  out[r, 0:K]  = sum_e x * e_self[r] * e_other[o] / max(<e_self[r], e_other[o]>, floor)
//       out[r, K:2K] = sum_e s[o] * e_other[o]
//   K8  out[r]       = sum_e s[o] * <e_self_new[r], e_other[o]>
// The allocation divides by the dot WITHOUT the scalars (they cancel in
// the multinomial allocation); only the second half of K7 is weighted.
// K8 runs after the row update with the refreshed self rows and has no
// floor.  Rows without tail edges get zeros.
//
// What bounds them on an H100: memory, as K1.  Per edge they move a 4-byte
// other id (K7 also a 4-byte rating) from HBM, one K-float row of the
// other table and one scalar; the tables and the scalar vector (<= ~14 MB
// at 162k x 20 f32) stay resident in the 50 MB L2, so HBM traffic is the
// CSR arrays plus one read of each table and one write of each output
// row.  The arithmetic (~6K flops per edge for K7, 3K for K8) is far below
// the FP32 line; in practice the L2 row gathers' latency sets the time.
//
// Design: K1's skeleton.  One warp per self row; lane l holds factors l,
// l + 32, ... (F = ceil(K / 32) a lane, a template parameter, F <= 4 for
// K <= 128; factors >= K hold 0).  The scalars are their own array, not a
// K+1-th table column, so the other rows stay K floats wide: the warp
// loads 32 edges' ids (and ratings) with one coalesced load, each lane
// gathers ITS edge's scalar, and the walk over the batch shares id, rating
// and scalar by __shfl_sync.  Each other row is F coalesced 32-float
// reads; four edges are in flight at once.  K7 reduces the dot with one
// __shfl_xor_sync butterfly per edge (the division needs it); K8 is linear
// in the dot, so each lane sums s * e_self[k] * e_other[k] over the row's
// edges and the warp reduces once at the end.  Sums run in edge order in
// registers: no atomics, deterministic results.

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
__device__ __forceinline__ void gather_row(const float* __restrict__ tab, int o, int K,
                                           int lane, float (&eo)[F]) {
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const int k = 32 * f + lane;
    eo[f] = k < K ? __ldg(tab + (int64_t)o * K + k) : 0.f;
  }
}

template <int F>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ext_factor_kernel(const float* __restrict__ e_self,
                  const float* __restrict__ e_other,
                  const float* __restrict__ s_other,
                  const int64_t* __restrict__ row_ptr,
                  const int32_t* __restrict__ other,
                  const float* __restrict__ x,
                  int n_self, int K, float rate_floor,
                  float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n_self) return;  // whole warp leaves together
  float es[F], acc_a[F], acc_w[F];
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const int k = 32 * f + lane;
    es[f] = k < K ? e_self[(int64_t)row * K + k] : 0.f;
    acc_a[f] = 0.f;
    acc_w[f] = 0.f;
  }
  auto edge = [&](const float (&eo)[F], float xv, float sv) {
    float p[F];
    float part = es[0] * eo[0];
    p[0] = part;
#pragma unroll
    for (int f = 1; f < F; ++f) {
      p[f] = es[f] * eo[f];
      part += p[f];
    }
    const float dot = fmaxf(warp_sum(part), rate_floor);
#pragma unroll
    for (int f = 0; f < F; ++f) {
      acc_a[f] += (xv / dot) * p[f];
      acc_w[f] += sv * eo[f];
    }
  };
  const int64_t begin = row_ptr[row];
  const int64_t end = row_ptr[row + 1];
  for (int64_t base = begin; base < end; base += 32) {
    const int64_t left = end - base;
    const int n = left < 32 ? (int)left : 32;
    int my_o = 0;
    float my_x = 0.f, my_s = 0.f;
    if (lane < n) {
      my_o = other[base + lane];
      my_x = x[base + lane];
      my_s = __ldg(s_other + my_o);
    }
    int j = 0;
    for (; j + 4 <= n; j += 4) {
      float eo[4][F], xv[4], sv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int o = __shfl_sync(kFull, my_o, j + q);
        xv[q] = __shfl_sync(kFull, my_x, j + q);
        sv[q] = __shfl_sync(kFull, my_s, j + q);
        gather_row(e_other, o, K, lane, eo[q]);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) edge(eo[q], xv[q], sv[q]);
    }
    for (; j < n; ++j) {
      const int o = __shfl_sync(kFull, my_o, j);
      const float xv = __shfl_sync(kFull, my_x, j);
      const float sv = __shfl_sync(kFull, my_s, j);
      float eo[F];
      gather_row(e_other, o, K, lane, eo);
      edge(eo, xv, sv);
    }
  }
  float* dst = out + (int64_t)row * 2 * K;
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const int k = 32 * f + lane;
    if (k < K) {
      dst[k] = acc_a[f];
      dst[K + k] = acc_w[f];
    }
  }
}

template <int F>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ext_scalar_kernel(const float* __restrict__ e_self_new,
                  const float* __restrict__ e_other,
                  const float* __restrict__ s_other,
                  const int64_t* __restrict__ row_ptr,
                  const int32_t* __restrict__ other,
                  int n_self, int K,
                  float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n_self) return;  // whole warp leaves together
  // This lane's share: sum_e s_o * e_self_new[k] * e_other[o, k], its F factors.
  float es[F], acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const int k = 32 * f + lane;
    es[f] = k < K ? e_self_new[(int64_t)row * K + k] : 0.f;
    acc[f] = 0.f;
  }
  auto edge = [&](const float (&eo)[F], float sv) {
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] += sv * (es[f] * eo[f]);
  };
  const int64_t begin = row_ptr[row];
  const int64_t end = row_ptr[row + 1];
  for (int64_t base = begin; base < end; base += 32) {
    const int64_t left = end - base;
    const int n = left < 32 ? (int)left : 32;
    int my_o = 0;
    float my_s = 0.f;
    if (lane < n) {
      my_o = other[base + lane];
      my_s = __ldg(s_other + my_o);
    }
    int j = 0;
    for (; j + 4 <= n; j += 4) {
      float eo[4][F], sv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int o = __shfl_sync(kFull, my_o, j + q);
        sv[q] = __shfl_sync(kFull, my_s, j + q);
        gather_row(e_other, o, K, lane, eo[q]);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) edge(eo[q], sv[q]);
    }
    for (; j < n; ++j) {
      const int o = __shfl_sync(kFull, my_o, j);
      const float sv = __shfl_sync(kFull, my_s, j);
      float eo[F];
      gather_row(e_other, o, K, lane, eo);
      edge(eo, sv);
    }
  }
  float part = acc[0];
#pragma unroll
  for (int f = 1; f < F; ++f) part += acc[f];
  const float total = warp_sum(part);
  if (lane == 0) out[row] = total;
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

extern "C" int pmf_ext_factor(const float* e_self, const float* e_other,
                              const float* s_other, const int64_t* row_ptr,
                              const int32_t* other, const float* x, int n_self,
                              int K, float rate_floor, float* out,
                              void* stream) {
  if (K < 1 || K > kMaxK) return (int)cudaErrorInvalidValue;
  if (n_self > 0) {
    const int blocks = (n_self + kWarpsPerBlock - 1) / kWarpsPerBlock;
    PMF_LAUNCH_F(ext_factor_kernel, K, blocks, static_cast<cudaStream_t>(stream),
                 e_self, e_other, s_other, row_ptr, other, x, n_self, K, rate_floor,
                 out);
  }
  return (int)cudaGetLastError();
}

extern "C" int pmf_ext_scalar(const float* e_self_new, const float* e_other,
                              const float* s_other, const int64_t* row_ptr,
                              const int32_t* other, int n_self, int K,
                              float* out, void* stream) {
  if (K < 1 || K > kMaxK) return (int)cudaErrorInvalidValue;
  if (n_self > 0) {
    const int blocks = (n_self + kWarpsPerBlock - 1) / kWarpsPerBlock;
    PMF_LAUNCH_F(ext_scalar_kernel, K, blocks, static_cast<cudaStream_t>(stream),
                 e_self_new, e_other, s_other, row_ptr, other, n_self, K, out);
  }
  return (int)cudaGetLastError();
}
