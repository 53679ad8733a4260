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
// What bounds them on an H100: instruction issue and L2 gather latency, not
// bytes.  Per edge they move a 4-byte other id (K7 also a 4-byte rating)
// from HBM, one K-float row of the other table and one scalar; the tables
// and the scalar vector (<= ~14 MB at 162k x 20 f32) stay resident in the
// 50 MB L2, so HBM traffic is the CSR arrays plus one read of each table and
// one write of each output row.  The arithmetic (~6K flops per edge for K7,
// 3K for K8) is far below the FP32 line.
//
// K7 is the mode kExt instance of tail_groups.cuh (K1's row groups: G lanes
// a self row, float4 words of tables padded to 4 * ceil(K / 4) floats, a
// log2(G)-step butterfly an edge, s_o read by every lane of the group from
// one address beside the row gather); the header holds its design and
// reckoning.
//
// K8 takes a warp a row: one warp per self row; lane l holds
// factors l, l + 32, ... (F = ceil(K / 32) a lane, a template parameter,
// F <= 4 for K <= 128; factors >= K hold 0), on unpadded tables.  The warp
// loads 32 edges' ids with one coalesced load, each lane gathers ITS edge's
// scalar, and the walk over the batch shares id and scalar by __shfl_sync.
// Each other row is F coalesced 32-float reads; four edges are in flight at
// once.  K8 is linear in the dot, so each lane sums s * e_self[k] *
// e_other[k] over the row's edges and the warp reduces once at the end.
// Sums run in edge order in registers: no atomics, deterministic results.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tail_groups.cuh"

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
                              int n_long, int K, float rate_floor, float* out,
                              void* stream) {
  const tail_groups::Tables t{e_self, e_other, nullptr, s_other, row_ptr, other, x};
  return tail_groups::launch<tail_groups::kExt>(t, n_self, n_long, K, rate_floor, out,
                                                static_cast<cudaStream_t>(stream));
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
