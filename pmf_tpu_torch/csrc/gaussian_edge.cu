// K3, K5, K6 — sparse-tail edge passes of the Gaussian CAVI blocks.
//
// Replace: pmf_tpu/ops/pallas/gaussian_edge.py::_factor_kernel (K3),
//          pmf_tpu/ops/pallas/gaussian_edge.py::_bias_kernel (K5),
//          pmf_tpu/ops/pallas/gaussian_edge.py::_diag_kernel (K6).
//
// All three walk the direction's CSR tail (row_ptr, other, x over
// new-space self rows) and write per-row sums in edge order: no atomics,
// deterministic.  Rows without tail edges get zeros.
//
//   K3 factor pass, record [m | b | triu(V + m m^T)] (K + 1 + T floats,
//      T = K(K+1)/2) from a table the wrapper builds once per pass
//      (permuted into new space); output per self row
//      [sum m_o (x - b_o) | sum m_o | sum tri_o (| sum x | sum b_o)],
//      2K + T (+ 2) columns.  The wrapper applies the -b_self * sum m_o
//      correction and unpacks the triangle.
//   K5 bias pass: [sum m_o | sum b_o | sum x], K + 2 columns.
//   K6 diag pass: [sum m_o (x - b_s - b_o - <m_s, m_o>) | sum (v_o + m_o^2) |
//      sum m_o^2], 3K columns.
//
// K5 and K6 are the modes kBias and kDiag of tail_groups.cuh, the
// row-group skeleton of K1 and K7, which holds their design and reckoning:
// a group of G lanes a self row, the rows [m | b] read as records of
// 4 * ceil((K + 1) / 4) floats in float4 words (K6 also v + m^2, padded to
// 4 * ceil(K / 4)), K6's b_o shared from the lane that holds column K and
// its dot the group's log2(G)-step butterfly.  This file holds their entry
// points.
//
// K3's table is padded to a multiple of 4 floats a record (stride), so
// that every record starts on 16 bytes.  What bounds it on an H100:
// memory.  K3 gathers a 924-byte record (29 sectors of 32 bytes) per edge
// at K=20; the tables (59k x 928 B = 55 MB by user, 162k x 928 B = 150 MB
// by item) do not fit the 50 MB L2, and one pass gathers 4.5 GB a
// direction: 1.34 ms at 3.35 TB/s if every sector came from HBM, against
// 0.07 ms to read each table once.  The item pass runs at that per-edge
// gather bound, the user pass below it (about half its sectors hit L2); at
// K=50 (5.3 KB records) both passes do.
//
// Design: in K3, lane l reads record floats c0 + 128 t + 4 l .. + 3 as one
// float4 (t < NV, one coalesced 512-byte load a warp), four edges in
// flight, and keeps one accumulator per loaded float, so the record's
// layout is the accumulator layout: floats < K (all in t = 0) are factors
// (also summed into sum m_o), float K sums b_o, the rest sum triangle
// entries.  b_o is broadcast with one shuffle from the lane that loaded
// it.  Up to K = 30 the whole record fits NV <= 4 loads a lane, one warp a
// row (c0 = 0).  Past that (K + 1 + T up to 8,385 floats at K = 128) the
// record is cut into chunks of 512 floats on grid.y: each chunk's warp
// walks the row's edges again, rereading the 8 bytes of id and rating an
// edge; the first chunk holds all of m and b (K + 1 <= 512), so it alone
// computes m (x - b), sum m and sum x.  Two other designs were timed
// against this one on the real tail (PERF.md): bands of the other table
// sized to L2, no faster by item and slower by user, since the gathers
// still move 4.5 GB a direction and each band launch walks every self row
// again; and a ring of 4 or 8 record slots a warp in shared memory filled
// by TMA bulk copies, 1.3-1.8x slower at K=20 and at best as fast at
// K=50 (2 KB chunks).

#include <cuda_runtime.h>
#include <stdint.h>

#include "tail_groups.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxK = 128;
// Past K = 30 a K3 warp takes a chunk of 512 record floats (4 float4
// loads a lane), where the whole record no longer fits 16 floats a lane.
constexpr int kWholeRecordMaxK = 30;
constexpr int kChunkNV = 4;
constexpr int kEdges = 4;  // K3 edges in flight a warp

// ---------------------------------------------------------------- K3 --

// The register form: one warp per (self row, record chunk blockIdx.y of
// NV * 128 floats); lane l loads record floats c0 + 128 t + 4 l .. + 3 as
// one float4 (t < NV), E edges in flight, and keeps one accumulator per
// loaded float.  Floats < K (all in t = 0, K <= 128) are factors, float K
// is b (broadcast by a shuffle from the lane that loaded it).
template <int NV, int E>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
factor_kernel(const float* __restrict__ aug, int stride,
                  const int64_t* __restrict__ row_ptr, const int32_t* __restrict__ other,
                  const float* __restrict__ x, int n_self, int K, int with_bias_stats,
                  float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n_self) return;  // whole warp leaves together
  const int T = K * (K + 1) / 2;
  const int w_in = K + 1 + T;
  const int c0 = blockIdx.y * NV * 128;
  const bool first = blockIdx.y == 0;  // the chunk with m and b
  const int tb = K >> 7, lb = (K & 127) >> 2, qb = K & 3;  // where b lands
  float4 acc[NV];
#pragma unroll
  for (int t = 0; t < NV; ++t) acc[t] = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 acc_m = make_float4(0.f, 0.f, 0.f, 0.f);
  float acc_x = 0.f;
  const int64_t begin = row_ptr[row];
  const int64_t end = row_ptr[row + 1];

  auto load = [&](int o, float4 (&v)[NV]) {
    const float* rec = aug + (int64_t)o * stride + c0;
#pragma unroll
    for (int t = 0; t < NV; ++t) {
      const int c = c0 + t * 128 + 4 * lane;
      v[t] = c < stride ? __ldg(reinterpret_cast<const float4*>(rec + t * 128) + lane)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto add4 = [](float4& a, const float4& v) {
    a.x += v.x; a.y += v.y; a.z += v.z; a.w += v.w;
  };
  auto add = [&](const float4 (&v)[NV], float xv) {
    if (first) {
      float4 vb = v[0];
#pragma unroll
      for (int t = 1; t < NV; ++t)
        if (t == tb) vb = v[t];
      const float bsrc = qb == 0 ? vb.x : qb == 1 ? vb.y : qb == 2 ? vb.z : vb.w;
      const float b = __shfl_sync(kFull, bsrc, lb);
      const float r = xv - b;
      const int c = 4 * lane;
      float4 a = v[0];
      if (c < K) { acc_m.x += a.x; a.x *= r; }
      if (c + 1 < K) { acc_m.y += a.y; a.y *= r; }
      if (c + 2 < K) { acc_m.z += a.z; a.z *= r; }
      if (c + 3 < K) { acc_m.w += a.w; a.w *= r; }
      add4(acc[0], a);
#pragma unroll
      for (int t = 1; t < NV; ++t) add4(acc[t], v[t]);
      acc_x += xv;
    } else {
#pragma unroll
      for (int t = 0; t < NV; ++t) add4(acc[t], v[t]);
    }
  };

  for (int64_t base = begin; base < end; base += 32) {
    const int64_t left = end - base;
    const int n = left < 32 ? (int)left : 32;
    int my_o = 0;
    float my_x = 0.f;
    if (lane < n) {
      my_o = __ldcs(other + base + lane);
      my_x = __ldcs(x + base + lane);
    }
    int j = 0;
    for (; j + E <= n; j += E) {
      float4 v[E][NV];
      float xv[E];
#pragma unroll
      for (int q = 0; q < E; ++q) {
        xv[q] = __shfl_sync(kFull, my_x, j + q);
        load(__shfl_sync(kFull, my_o, j + q), v[q]);
      }
#pragma unroll
      for (int q = 0; q < E; ++q) add(v[q], xv[q]);
    }
    for (; j < n; ++j) {
      float4 v[NV];
      const float xv = __shfl_sync(kFull, my_x, j);
      load(__shfl_sync(kFull, my_o, j), v);
      add(v, xv);
    }
  }

  const int w_out = 2 * K + T + (with_bias_stats ? 2 : 0);
  float* dst = out + (int64_t)row * w_out;
#pragma unroll
  for (int t = 0; t < NV; ++t) {
    const float a4[4] = {acc[t].x, acc[t].y, acc[t].z, acc[t].w};
    const float m4[4] = {acc_m.x, acc_m.y, acc_m.z, acc_m.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = c0 + t * 128 + 4 * lane + q;
      if (c >= w_in) continue;
      if (c < K) {
        __stcs(dst + c, a4[q]);
        __stcs(dst + K + c, m4[q]);  // c < K holds only in t = 0 of the first chunk
      } else if (c == K) {
        if (with_bias_stats) __stcs(dst + 2 * K + T + 1, a4[q]);
      } else {
        __stcs(dst + 2 * K + (c - K - 1), a4[q]);
      }
    }
  }
  if (with_bias_stats && first && lane == 0) __stcs(dst + 2 * K + T, acc_x);
}

template <int NV, int E>
cudaError_t launch_factor_vec(const float* aug, int stride, const int64_t* row_ptr,
                              const int32_t* other, const float* x, int n_self, int K,
                              int wbs, float* out, cudaStream_t stream) {
  const dim3 grid((n_self + kWarpsPerBlock - 1) / kWarpsPerBlock,
                  (stride + NV * 128 - 1) / (NV * 128));
  factor_kernel<NV, E><<<grid, kWarpsPerBlock * 32, 0, stream>>>(
      aug, stride, row_ptr, other, x, n_self, K, wbs, out);
  return cudaGetLastError();
}

cudaError_t launch_factor_vec_nv(const float* aug, int stride, const int64_t* row_ptr,
                                 const int32_t* other, const float* x, int n_self,
                                 int K, int wbs, float* out, cudaStream_t s) {
  const int nv = K <= kWholeRecordMaxK ? (stride + 127) / 128 : kChunkNV;
  switch (nv) {
    case 1: return launch_factor_vec<1, kEdges>(aug, stride, row_ptr, other, x, n_self, K, wbs, out, s);
    case 2: return launch_factor_vec<2, kEdges>(aug, stride, row_ptr, other, x, n_self, K, wbs, out, s);
    case 3: return launch_factor_vec<3, kEdges>(aug, stride, row_ptr, other, x, n_self, K, wbs, out, s);
    case 4: return launch_factor_vec<4, kEdges>(aug, stride, row_ptr, other, x, n_self, K, wbs, out, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int pmf_gauss_factor(const float* aug, int stride, const int64_t* row_ptr,
                                const int32_t* other, const float* x, int n_self,
                                int K, int with_bias_stats, float* out, void* stream) {
  if (K < 1 || K > kMaxK || stride % 4 != 0 || stride < K + 1 + K * (K + 1) / 2)
    return (int)cudaErrorInvalidValue;
  if (n_self <= 0) return (int)cudaGetLastError();
  return (int)launch_factor_vec_nv(aug, stride, row_ptr, other, x, n_self, K,
                                   with_bias_stats, out, static_cast<cudaStream_t>(stream));
}

extern "C" int pmf_gauss_bias(const float* mb_other, const int64_t* row_ptr,
                              const int32_t* other, const float* x, int n_self,
                              int n_long, int K, float* out, void* stream) {
  const tail_groups::Tables t{nullptr, mb_other, nullptr, row_ptr, other, x};
  return tail_groups::launch<tail_groups::kBias>(t, n_self, n_long, K, 0.f, out,
                                                 static_cast<cudaStream_t>(stream));
}

extern "C" int pmf_gauss_diag(const float* mb_self, const float* mb_other,
                              const float* sq_other, const int64_t* row_ptr,
                              const int32_t* other, const float* x, int n_self, int n_long,
                              int K, float* out, void* stream) {
  const tail_groups::Tables t{mb_self, mb_other, sq_other, row_ptr, other, x};
  return tail_groups::launch<tail_groups::kDiag>(t, n_self, n_long, K, 0.f, out,
                                                 static_cast<cudaStream_t>(stream));
}
