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
// its dot the group's log2(G)-step butterfly.  K6 takes that register form
// to K = 127; from K = 128 to 511 (33 to 128 words a record) the ring form,
// tail_ring_kernel (a warp a row, each edge's two rows copied by cp.async
// into a ring in shared memory, D dots a round in one reduction); past it
// tail_wide_kernel.  K5 takes the register form to K = 159; from K = 160 to
// 511 the sum form, tail_sum_kernel (a warp a row, the records through a
// cp.async ring, other-id windows where they outgrow the L2).  This file
// holds their entry points.
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
// computes m (x - b), sum m and sum x.  Past K = 128 the wide forms
// below take over (factor_plan, in the host plan block).  Two other
// designs were timed against the K <= 128 form on the real tail (PERF.md):
// bands of the other table sized to L2, no faster by item and slower by
// user, since the gathers still move 4.5 GB a direction and each band
// launch walks every self row again; and a ring of 4 or 8 record slots a
// warp in shared memory filled by TMA bulk copies, 1.3-1.8x slower at K=20
// and at best as fast at K=50 (2 KB chunks).
//
// The wide forms (K > 128; records of 52 KB at K = 160, 133 KB at 256).
// A record is too wide to gather whole per edge from HBM, and the card
// reaches each chunk of it from L2 only while the column slab of that
// chunk (n_other x chunk floats) stays there.  Both forms first copy the
// table slab-major (factor_copy_kernel, below), then walk the record chunk
// by chunk in chunk-major order (blockIdx.x = chunk * row blocks + row
// block), so the CTAs in flight share one slab.  Timed on the card
// (PERF.md, PR 20): narrower chunks alone did not help, since every chunk
// pays each edge's id, rating and address again; the slab-major copy and
// 4 float4s a lane did.
//  - Slab form (rows that share few other rows): the chunk is the widest of
//    512, 256, 128, 64 floats whose slab fits the L2; a row takes chunk / 16
//    lanes of 4 float4s each (32 / lanes rows a warp), two edges in flight,
//    each chunk rereading the row's 8 bytes of id and rating an edge.  The
//    chunks that hold factors and the rest are two launches of two
//    instances, so the rest keep no registers for sum m, b_o and x.  Each
//    float sums its edges in CSR order, as the K <= 128 form: the same bits
//    at any chunk.
//  - Group form (rows that share other rows: edges per distinct (group,
//    other) pair at least kGroupMinReuseX4 / 4): a CTA takes kGroupRows
//    consecutive self rows and one chunk of 128 floats.  Each distinct other
//    row of the group is staged once into shared memory, kGroupSlots at a
//    time (a window, two buffers filled by cp.async), and the warp that owns
//    a row adds the staged records of its edges from there.  The schedule
//    (ops/gaussian_edge.py::factor_schedule, built once a CSR) orders each
//    group's edges by (window, row, slot): a row sums its edges in the order
//    of their other ids, not in CSR order.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tail_groups.cuh"

namespace {

// BEGIN host plan: K3's form and geometry, in plain C++ (the tests compile
// this block alone with a host compiler and hold it against
// ops/gaussian_edge.py::factor_plan).
// Up to K = 128 the factors lie in the first float4 load of each lane.
constexpr int kNarrowMaxK = 128;
// Past K = 30 a K3 warp takes a chunk of 512 record floats (4 float4
// loads a lane), where the whole record no longer fits 16 floats a lane.
constexpr int kWholeRecordMaxK = 30;
constexpr int kChunkNV = 4;
constexpr int kEdges = 4;  // edges in flight a warp to K = 128
// The wide forms.
constexpr int kSlabMaxChunk = 512;  // record floats a chunk of the slab form, at most
constexpr int kSlabMinChunk = 64;   // and at least (8 sectors)
constexpr int kSlabL2Div = 1;       // the column slab may fill 1 / kSlabL2Div of L2
constexpr int kSlabNV = 4;          // float4s a lane a record chunk
constexpr int kSlabEdges = 2;       // edges in flight a row
constexpr int kGroupRows = 32;      // self rows a CTA of the group form
constexpr int kGroupChunk = 128;    // record floats a chunk there (a float4 a lane)
constexpr int kGroupSlots = 64;     // other records a window of shared memory
constexpr int kGroupEdges = 4;      // edges in flight a warp, from shared memory
constexpr int kGroupStages = 2;     // windows in the shared-memory ring
constexpr int kGroupCtas = 3;       // CTAs an SM (the launch bound)
// The group form where 4 nnz >= kGroupMinReuseX4 pairs: at least 2 edges
// a distinct (group, other row) pair.
constexpr int64_t kGroupMinReuseX4 = 8;

enum FactorForm { kFormWhole, kFormChunked, kFormSlab, kFormGroup };

struct FactorPlan {
  int form;
  int chunk;     // record floats a chunk
  int lanes;     // lanes a self row
  int edges;     // edges in flight
  int rows;      // self rows a CTA
  int64_t smem;  // bytes of dynamic shared memory a CTA
};

int64_t factor_stride_of(int K) {
  return ((int64_t)K + 1 + (int64_t)K * (K + 1) / 2 + 3) / 4 * 4;
}

// n_other: the table's rows; nnz and pairs: the CSR's edges and its
// distinct (group of kGroupRows self rows, other row) pairs (pairs 0: not
// counted); l2_bytes: the card's L2.
FactorPlan factor_plan(int K, int64_t n_other, int64_t nnz, int64_t pairs,
                       int64_t l2_bytes) {
  if (K <= kWholeRecordMaxK)
    return {kFormWhole, (int)((factor_stride_of(K) + 127) / 128 * 128), 32, kEdges, 8, 0};
  if (K <= kNarrowMaxK) return {kFormChunked, kChunkNV * 128, 32, kEdges, 8, 0};
  if (pairs > 0 && 4 * nnz >= kGroupMinReuseX4 * pairs)
    return {kFormGroup, kGroupChunk, 32, kGroupEdges, kGroupRows,
            (int64_t)kGroupStages * kGroupSlots * (kGroupChunk + 1) * 4};
  int chunk = kSlabMaxChunk;
  while (chunk > kSlabMinChunk && n_other * chunk * 4 > l2_bytes / kSlabL2Div) chunk /= 2;
  const int lanes = chunk / (4 * kSlabNV);
  return {kFormSlab, chunk, lanes, kSlabEdges, 8 * (32 / lanes), 0};
}
// END host plan

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void add4(float4& a, const float4& v) {
  a.x += v.x; a.y += v.y; a.z += v.z; a.w += v.w;
}

// A wide chunk's float4 of record floats c .. c + 3: floats < K are
// factors, each summed into am and weighted by r = x - b_o into a; the
// others go into a as they are.
__device__ __forceinline__ void add_wide(float4& a, float4& am, float4 v, int c, int K,
                                         float r) {
  if (c < K) { am.x += v.x; v.x *= r; }
  if (c + 1 < K) { am.y += v.y; v.y *= r; }
  if (c + 2 < K) { am.z += v.z; v.z *= r; }
  if (c + 3 < K) { am.w += v.w; v.w *= r; }
  add4(a, v);
}

// One lane's sums of record floats c .. c + 3 into their output columns.
__device__ __forceinline__ void store_wide(float* dst, const float4& a, const float4& am,
                                           int c, int K, int T, int w_in, int wbs) {
  const float a4[4] = {a.x, a.y, a.z, a.w};
  const float m4[4] = {am.x, am.y, am.z, am.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int cq = c + q;
    if (cq >= w_in) continue;
    if (cq < K) {
      __stcs(dst + cq, a4[q]);
      __stcs(dst + K + cq, m4[q]);
    } else if (cq == K) {
      if (wbs) __stcs(dst + 2 * K + T + 1, a4[q]);
    } else {
      __stcs(dst + 2 * K + (cq - K - 1), a4[q]);
    }
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

// ---------------------------------------------------------------- K3 --

// The register form (K <= 128): one warp per (self row, record chunk
// blockIdx.y of NV * 128 floats); lane l loads record floats c0 + 128 t +
// 4 l .. + 3 as one float4 (t < NV), E edges in flight, and keeps one
// accumulator per loaded float.  Floats < K (all in t = 0) are factors,
// float K is b (broadcast by a shuffle from the lane that loaded it).
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
  float4 acc_m[1];
  acc_m[0] = make_float4(0.f, 0.f, 0.f, 0.f);
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
      if (c < K) { acc_m[0].x += a.x; a.x *= r; }
      if (c + 1 < K) { acc_m[0].y += a.y; a.y *= r; }
      if (c + 2 < K) { acc_m[0].z += a.z; a.z *= r; }
      if (c + 3 < K) { acc_m[0].w += a.w; a.w *= r; }
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
        const int o = __shfl_sync(kFull, my_o, j + q);
        load(o, v[q]);
      }
#pragma unroll
      for (int q = 0; q < E; ++q) add(v[q], xv[q]);
    }
    for (; j < n; ++j) {
      float4 v[NV];
      const float xv = __shfl_sync(kFull, my_x, j);
      const int o = __shfl_sync(kFull, my_o, j);
      load(o, v);
      add(v, xv);
    }
  }

  const int w_out = 2 * K + T + (with_bias_stats ? 2 : 0);
  float* dst = out + (int64_t)row * w_out;
#pragma unroll
  for (int t = 0; t < NV; ++t) {
    const float a4[4] = {acc[t].x, acc[t].y, acc[t].z, acc[t].w};
    const float4& am = acc_m[0];
    const float m4[4] = {am.x, am.y, am.z, am.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = c0 + t * 128 + 4 * lane + q;
      if (c >= w_in) continue;
      if (c < K) {
        __stcs(dst + c, a4[q]);
        __stcs(dst + K + c, m4[q]);  // c < K holds only in t = 0 of chunk 0
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

// The wide forms read the table in slab-major order: a copy, made by
// factor_copy_kernel in the same launch, of record chunk c of every other
// row o at slabs + (c n_other + o) W (W the plan's chunk, zeros past the
// stride), so that one chunk's column slab is n_other W contiguous floats:
// a few pages of the card's address space where the row-major table puts
// each record of the slab on a page of its own.
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
factor_copy_kernel(const float* __restrict__ aug, int stride, int n_other, int w_shift,
                   int o_blocks, float* __restrict__ slabs) {
  constexpr int kRows = 64;  // other rows a block
  const int w4 = 1 << (w_shift - 2);  // float4s a chunk
  const int c = blockIdx.x / o_blocks;
  const int o0 = (blockIdx.x - c * o_blocks) * kRows;
  const int64_t c0 = (int64_t)c << w_shift;
  float4* dst = reinterpret_cast<float4*>(slabs + (c * (int64_t)n_other + o0) * (1 << w_shift));
  for (int f = threadIdx.x; f < kRows * w4; f += kWarpsPerBlock * 32) {
    const int o = o0 + (f >> (w_shift - 2));
    if (o >= n_other) break;
    const int64_t col = c0 + 4 * (f & (w4 - 1));
    dst[f] = col < stride ? __ldcs(reinterpret_cast<const float4*>(aug + (int64_t)o * stride + col))
                          : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// The slab form (K > 128): LPR lanes a self row (32 / LPR rows a warp),
// each kSlabNV float4s of the chunk of 16 LPR record floats, E edges in
// flight a row, blocks chunk-major from chunk0.  Lane s of a row loads
// record floats c0 + 4 LPR t + 4 s .. + 3 and sums them over the row's
// edges in CSR order; a group of E edges that runs past the row's end loads
// and adds only the edges it holds, so every float's sum is the K <= 128
// form's, in bits.  HAS_F: the instance for the chunks that hold factors
// (they read b_o, sum m and, in the first, x); the others keep no registers
// for them.
template <int LPR, int E, bool HAS_F>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
factor_slab_kernel(const float* __restrict__ slabs, int n_other,
                   const int64_t* __restrict__ row_ptr, const int32_t* __restrict__ other,
                   const float* __restrict__ x, int n_self, int K, int wbs, int row_blocks,
                   int chunk0, float* __restrict__ out) {
  constexpr int NV = kSlabNV;
  constexpr int kRowsPerWarp = 32 / LPR;
  constexpr int kChunk = LPR * 4 * NV;
  const int lane = threadIdx.x & 31;
  const int sub = lane % LPR;  // the lane within its row
  const int half = lane / LPR;
  const unsigned mask = LPR == 32 ? kFull : (((1u << LPR) - 1u) << (LPR * half));
  const int chunk = chunk0 + (int)(blockIdx.x / row_blocks);
  const int row = ((blockIdx.x % row_blocks) * kWarpsPerBlock + (threadIdx.x >> 5)) *
                      kRowsPerWarp + half;
  if (row >= n_self) return;  // the row's lanes leave together
  const int T = K * (K + 1) / 2;
  const int w_in = K + 1 + T;
  const int c0 = chunk * kChunk;
  const bool first = chunk == 0;  // sums x
  const float* slab = slabs + (int64_t)chunk * n_other * kChunk + 4 * sub;
  const float* b_col = slabs + (int64_t)(K / kChunk) * n_other * kChunk + K % kChunk;
  float4 acc[NV], acc_m[HAS_F ? NV : 1];
#pragma unroll
  for (int t = 0; t < NV; ++t) acc[t] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int t = 0; t < (HAS_F ? NV : 1); ++t) acc_m[t] = make_float4(0.f, 0.f, 0.f, 0.f);
  float acc_x = 0.f;
  const int64_t begin = row_ptr[row];
  const int64_t end = row_ptr[row + 1];

  for (int64_t base = begin; base < end; base += LPR) {
    const int64_t left = end - base;
    const int n = left < LPR ? (int)left : LPR;
    int my_o = 0;
    float my_x = 0.f;
    if (sub < n) {
      my_o = __ldcs(other + base + sub);
      if (HAS_F) my_x = __ldcs(x + base + sub);
    }
    for (int j = 0; j < n; j += E) {
      const int cnt = n - j < E ? n - j : E;  // the same on the row's lanes
      float4 v[E][NV];
      float xv[E], bv[E];
#pragma unroll
      for (int q = 0; q < E; ++q) {
        if (q < cnt) {
          const int o = __shfl_sync(mask, my_o, j + q, LPR);
          const float* rec = slab + (int64_t)o * kChunk;
#pragma unroll
          for (int t = 0; t < NV; ++t)
            v[q][t] = __ldg(reinterpret_cast<const float4*>(rec + t * 4 * LPR));
          if constexpr (HAS_F) {
            xv[q] = __shfl_sync(mask, my_x, j + q, LPR);
            bv[q] = __ldg(b_col + (int64_t)o * kChunk);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < E; ++q) {
        if (q < cnt) {
          if constexpr (HAS_F) {
            const float r = xv[q] - bv[q];
#pragma unroll
            for (int t = 0; t < NV; ++t)
              add_wide(acc[t], acc_m[t], v[q][t], c0 + t * 4 * LPR + 4 * sub, K, r);
            if (first) acc_x += xv[q];
          } else {
#pragma unroll
            for (int t = 0; t < NV; ++t) add4(acc[t], v[q][t]);
          }
        }
      }
    }
  }

  float* dst = out + (int64_t)row * (2 * K + T + (wbs ? 2 : 0));
#pragma unroll
  for (int t = 0; t < NV; ++t)
    store_wide(dst, acc[t], acc_m[HAS_F ? t : 0], c0 + t * 4 * LPR + 4 * sub, K, T, w_in,
               wbs);
  if (wbs && first && sub == 0) __stcs(dst + 2 * K + T, acc_x);
}

// The group form's schedule (ops/gaussian_edge.py::factor_schedule): each
// group's distinct other rows in ascending order, cut into windows of
// kGroupSlots; the edges ordered by (group, window, row, slot).
struct GroupSchedule {
  const int32_t* gp_other;  // distinct other rows of each group
  const int64_t* gp_ptr;    // (groups + 1) offsets into gp_other
  const int32_t* gw_ptr;    // (groups + 1) the first window of each group
  const int64_t* w_off;     // (windows * kGroupRows + 1): row r of window w from
                            // w_off[w * kGroupRows + r]
  const int32_t* e_slot;    // (nnz) each edge's slot in its window
  const float* e_x;         // (nnz) its rating
};

// A warp's cursor over the schedule: lanes 0 .. kRows hold the offsets of
// its rows in the current window; slot and x a batch of 32 edges from base.
struct GroupCursor {
  int64_t off, base;
  int slot;
  float x;
};

template <bool HAS_F>
__device__ __forceinline__ void group_batch(const GroupSchedule& s, GroupCursor& k,
                                            int64_t base, int64_t w_end, int lane) {
  k.base = base;
  k.slot = 0;
  k.x = 0.f;
  if (base + lane < w_end) {
    k.slot = __ldg(s.e_slot + base + lane);
    if (HAS_F) k.x = __ldg(s.e_x + base + lane);
  }
}

// One window of a warp's kRows rows: their edges of the window are
// contiguous, read 32 slots and ratings at a time, kGroupEdges records in
// flight from shared memory.
template <bool HAS_F>
__device__ __forceinline__ void group_window(
    const float4* __restrict__ buf, const float* __restrict__ bsm, const GroupSchedule& s,
    GroupCursor& k, int lane, int c, int K, bool sum_x,
    float4 (&acc)[kGroupRows / kWarpsPerBlock],
    float4 (&acc_m)[HAS_F ? kGroupRows / kWarpsPerBlock : 1],
    float (&acc_x)[HAS_F ? kGroupRows / kWarpsPerBlock : 1]) {
  constexpr int kRows = kGroupRows / kWarpsPerBlock;
  int64_t e = __shfl_sync(kFull, k.off, 0);
  const int64_t w_end = __shfl_sync(kFull, k.off, kRows);
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    const int64_t r_end = __shfl_sync(kFull, k.off, rr + 1);
    while (e < r_end) {
      const int cnt = r_end - e < kGroupEdges ? (int)(r_end - e) : kGroupEdges;
      if (e + cnt > k.base + 32) group_batch<HAS_F>(s, k, e, w_end, lane);
      const int j = (int)(e - k.base);
      float4 v[kGroupEdges];
      float xv[kGroupEdges], bv[kGroupEdges];
#pragma unroll
      for (int q = 0; q < kGroupEdges; ++q) {
        if (q < cnt) {
          const int slot = __shfl_sync(kFull, k.slot, j + q);
          v[q] = buf[slot * 32 + lane];
          if constexpr (HAS_F) {
            xv[q] = __shfl_sync(kFull, k.x, j + q);
            bv[q] = bsm[slot];
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kGroupEdges; ++q) {
        if (q < cnt) {
          if constexpr (HAS_F) {
            add_wide(acc[rr], acc_m[rr], v[q], c, K, xv[q] - bv[q]);
            if (sum_x) acc_x[rr] += xv[q];
          } else {
            add4(acc[rr], v[q]);
          }
        }
      }
      e += cnt;
    }
  }
}

// A CTA per (group of kGroupRows self rows, chunk of kGroupChunk record
// floats), chunk-major: warp w owns rows kRows w .. + kRows - 1 of the
// group, lane l record floats c0 + 4 l .. + 3.  The group's distinct other
// rows are staged a window of kGroupSlots at a time (their chunk from the
// slabs, and b_o where the chunk holds factors) by cp.async into a ring of
// kGroupStages buffers, kGroupStages - 1 windows ahead of the one summed;
// each warp reads its next window's offsets before the barrier that opens
// a window and its first 32 slots before the one that closes it.
template <bool HAS_F>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, kGroupCtas)
factor_group_kernel(const float* __restrict__ slabs, int n_other, int n_self, int K, int wbs,
                    int groups, int chunk0, GroupSchedule s, float* __restrict__ out) {
  constexpr int kRows = kGroupRows / kWarpsPerBlock;
  constexpr int kBufFloat4 = kGroupSlots * (kGroupChunk / 4);
  extern __shared__ __align__(16) float4 sm4[];  // the ring, then its b columns
  float* bsm = reinterpret_cast<float*>(sm4 + kGroupStages * kBufFloat4);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int chunk = chunk0 + (int)(blockIdx.x / groups);
  const int g = blockIdx.x % groups;
  const int c0 = chunk * kGroupChunk;
  const int c = c0 + 4 * lane;
  const bool sum_x = chunk == 0;
  const int64_t p0 = s.gp_ptr[g];
  const int n_dist = (int)(s.gp_ptr[g + 1] - p0);
  const int n_win = (n_dist + kGroupSlots - 1) / kGroupSlots;
  const int w0 = s.gw_ptr[g];
  const float* slab = slabs + (int64_t)chunk * n_other * kGroupChunk;
  const float* b_col = slabs + (int64_t)(K / kGroupChunk) * n_other * kGroupChunk +
                       K % kGroupChunk;
  float4 acc[kRows], acc_m[HAS_F ? kRows : 1];
  float acc_x[HAS_F ? kRows : 1];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int r = 0; r < (HAS_F ? kRows : 1); ++r) {
    acc_m[r] = make_float4(0.f, 0.f, 0.f, 0.f);
    acc_x[r] = 0.f;
  }

  auto stage = [&](int w) {  // window w into buffer w % kGroupStages
    if (w < n_win) {
      float4* buf = sm4 + (w % kGroupStages) * kBufFloat4;
      float* bb = bsm + (w % kGroupStages) * kGroupSlots;
      const int i0 = w * kGroupSlots;
      const int n = n_dist - i0 < kGroupSlots ? n_dist - i0 : kGroupSlots;
      for (int f = threadIdx.x; f < n * 32; f += kWarpsPerBlock * 32) {
        const int i = f >> 5, l = f & 31;
        const int64_t o = __ldg(s.gp_other + p0 + i0 + i);
        cp_async16(buf + f, slab + o * kGroupChunk + 4 * l);
        if (HAS_F && l == 0) cp_async4(bb + i, b_col + o * kGroupChunk);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");  // empty past the last
  };
  auto offsets = [&](int w) -> int64_t {  // lanes 0 .. kRows: window w's row offsets
    return w < n_win && lane <= kRows
               ? __ldg(s.w_off + (int64_t)(w0 + w) * kGroupRows + warp * kRows + lane)
               : 0;
  };

  GroupCursor k;
  k.off = offsets(0);
  if (n_win > 0)
    group_batch<HAS_F>(s, k, __shfl_sync(kFull, k.off, 0), __shfl_sync(kFull, k.off, kRows),
                       lane);
  for (int w = 0; w < kGroupStages - 1; ++w) stage(w);
  for (int w = 0; w < n_win; ++w) {
    stage(w + kGroupStages - 1);
    const int64_t next_off = offsets(w + 1);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kGroupStages - 1) : "memory");
    __syncthreads();
    const float4* buf = sm4 + (w % kGroupStages) * kBufFloat4;
    const float* bb = bsm + (w % kGroupStages) * kGroupSlots;
    group_window<HAS_F>(buf, bb, s, k, lane, c, K, sum_x, acc, acc_m, acc_x);
    k.off = next_off;
    if (w + 1 < n_win)
      group_batch<HAS_F>(s, k, __shfl_sync(kFull, k.off, 0), __shfl_sync(kFull, k.off, kRows),
                       lane);
    __syncthreads();  // the buffer is staged again kGroupStages windows on
  }

  const int T = K * (K + 1) / 2;
  const int w_in = K + 1 + T;
  const int w_out = 2 * K + T + (wbs ? 2 : 0);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = g * kGroupRows + warp * kRows + r;
    if (row < n_self) {
      float* dst = out + (int64_t)row * w_out;
      store_wide(dst, acc[r], acc_m[HAS_F ? r : 0], c, K, T, w_in, wbs);
      if (HAS_F && wbs && sum_x && lane == 0) __stcs(dst + 2 * K + T, acc_x[HAS_F ? r : 0]);
    }
  }
}

int log2_of(int w) {
  int s = 0;
  while ((1 << s) < w) ++s;
  return s;
}

cudaError_t copy_slabs(const float* aug, int stride, int n_other, int chunk, float* slabs,
                       cudaStream_t stream) {
  const int o_blocks = (n_other + 63) / 64;
  const int64_t blocks = (int64_t)o_blocks * ((stride + chunk - 1) / chunk);
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  factor_copy_kernel<<<(unsigned)blocks, kWarpsPerBlock * 32, 0, stream>>>(
      aug, stride, n_other, log2_of(chunk), o_blocks, slabs);
  return cudaGetLastError();
}

// The chunks that hold factors (c0 < K) and the others, as two launches of
// one form's instances (blocks chunk-major within each).
int factor_chunks(int K, int chunk) { return (K + chunk - 1) / chunk; }

template <int LPR>
cudaError_t launch_slab(const float* slabs, int n_other, int stride, const int64_t* row_ptr,
                        const int32_t* other, const float* x, int n_self, int K, int wbs,
                        float* out, cudaStream_t stream) {
  constexpr int kRowsPerBlock = kWarpsPerBlock * 32 / LPR;
  constexpr int kChunk = LPR * 4 * kSlabNV;
  const int row_blocks = (n_self + kRowsPerBlock - 1) / kRowsPerBlock;
  const int chunks = (stride + kChunk - 1) / kChunk, f = factor_chunks(K, kChunk);
  if ((int64_t)row_blocks * chunks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  factor_slab_kernel<LPR, kSlabEdges, true><<<row_blocks * f, kWarpsPerBlock * 32, 0, stream>>>(
      slabs, n_other, row_ptr, other, x, n_self, K, wbs, row_blocks, 0, out);
  if (chunks > f)
    factor_slab_kernel<LPR, kSlabEdges, false>
        <<<row_blocks * (chunks - f), kWarpsPerBlock * 32, 0, stream>>>(
            slabs, n_other, row_ptr, other, x, n_self, K, wbs, row_blocks, f, out);
  return cudaGetLastError();
}

cudaError_t launch_group(const float* slabs, int n_other, int stride, int n_self, int K,
                         int wbs, const GroupSchedule& s, const FactorPlan& plan, float* out,
                         cudaStream_t stream) {
  if (!s.gp_other || !s.gp_ptr || !s.gw_ptr || !s.w_off || !s.e_slot || !s.e_x)
    return cudaErrorInvalidValue;  // the group form without its schedule
  for (auto fn : {factor_group_kernel<true>, factor_group_kernel<false>}) {
    const cudaError_t err =
        cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)plan.smem);
    if (err != cudaSuccess) return err;
  }
  const int groups = (n_self + kGroupRows - 1) / kGroupRows;
  const int chunks = (stride + kGroupChunk - 1) / kGroupChunk;
  const int f = factor_chunks(K, kGroupChunk);
  if ((int64_t)groups * chunks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  factor_group_kernel<true><<<groups * f, kWarpsPerBlock * 32, plan.smem, stream>>>(
      slabs, n_other, n_self, K, wbs, groups, 0, s, out);
  if (chunks > f)
    factor_group_kernel<false><<<groups * (chunks - f), kWarpsPerBlock * 32, plan.smem,
                                 stream>>>(slabs, n_other, n_self, K, wbs, groups, f, s, out);
  return cudaGetLastError();
}

cudaError_t launch_factor(const float* aug, int stride, int n_other, const int64_t* row_ptr,
                          const int32_t* other, const float* x, int n_self, int K, int wbs,
                          const FactorPlan& plan, const GroupSchedule& s, float* slabs,
                          float* out, cudaStream_t st) {
  switch (plan.form) {
    case kFormWhole:
      switch (plan.chunk / 128) {
        case 1: return launch_factor_vec<1, kEdges>(aug, stride, row_ptr, other, x, n_self, K, wbs, out, st);
        case 2: return launch_factor_vec<2, kEdges>(aug, stride, row_ptr, other, x, n_self, K, wbs, out, st);
        case 3: return launch_factor_vec<3, kEdges>(aug, stride, row_ptr, other, x, n_self, K, wbs, out, st);
        case 4: return launch_factor_vec<4, kEdges>(aug, stride, row_ptr, other, x, n_self, K, wbs, out, st);
        default: return cudaErrorInvalidValue;
      }
    case kFormChunked:
      return launch_factor_vec<kChunkNV, kEdges>(aug, stride, row_ptr, other, x, n_self, K,
                                                 wbs, out, st);
    default:
      break;
  }
  if (!slabs) return cudaErrorInvalidValue;  // the wide forms' slab copy
  if (n_other > 0) {
    const cudaError_t err = copy_slabs(aug, stride, n_other, plan.chunk, slabs, st);
    if (err != cudaSuccess) return err;
  }
  if (plan.form == kFormGroup)
    return launch_group(slabs, n_other, stride, n_self, K, wbs, s, plan, out, st);
  switch (plan.lanes) {
    case 32: return launch_slab<32>(slabs, n_other, stride, row_ptr, other, x, n_self, K, wbs, out, st);
    case 16: return launch_slab<16>(slabs, n_other, stride, row_ptr, other, x, n_self, K, wbs, out, st);
    case 8: return launch_slab<8>(slabs, n_other, stride, row_ptr, other, x, n_self, K, wbs, out, st);
    case 4: return launch_slab<4>(slabs, n_other, stride, row_ptr, other, x, n_self, K, wbs, out, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// K3.  n_other, nnz, pairs and l2_bytes are factor_plan's inputs.  Past
// K = 128 ``slabs`` holds the table's slab-major copy (the plan's chunks x
// n_other x chunk floats), and the group form reads its schedule (null
// where the plan takes another form: a launch the plan gives the group
// form fails without it).
extern "C" int pmf_gauss_factor(const float* aug, int stride, const int64_t* row_ptr,
                                const int32_t* other, const float* x, int n_self,
                                int K, int with_bias_stats, int64_t n_other, int64_t nnz,
                                int64_t pairs, int64_t l2_bytes, const int32_t* gp_other,
                                const int64_t* gp_ptr, const int32_t* gw_ptr,
                                const int64_t* w_off, const int32_t* e_slot,
                                const float* e_x, float* slabs, float* out, void* stream) {
  if (K < 1 || stride % 4 != 0 || (int64_t)stride != factor_stride_of(K) ||
      n_other > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  if (n_self <= 0) return (int)cudaGetLastError();
  const FactorPlan plan = factor_plan(K, n_other, nnz, pairs, l2_bytes);
  const GroupSchedule s{gp_other, gp_ptr, gw_ptr, w_off, e_slot, e_x};
  return (int)launch_factor(aug, stride, (int)n_other, row_ptr, other, x, n_self, K,
                            with_bias_stats, plan, s, slabs, out,
                            static_cast<cudaStream_t>(stream));
}

// K5.  n_win > 1: the sum form's other-id windows (tail_groups::Windows:
// the window row pointers, the edges regrouped by window, n_win partial
// rows a self row, a zeroed arrival count a self row).
extern "C" int pmf_gauss_bias(const float* mb_other, const int64_t* row_ptr,
                              const int32_t* other, const float* x, int n_self,
                              int n_long, int K, int n_win, const int64_t* win_ptr,
                              const int32_t* win_other, const float* win_x, float* part,
                              unsigned* count, float* out, void* stream) {
  const tail_groups::Tables t{nullptr, mb_other, nullptr, row_ptr, other, x};
  const tail_groups::Windows win{n_win, win_ptr, win_other, win_x, part, count};
  return tail_groups::launch<tail_groups::kBias>(t, n_self, n_long, K, 0.f, out,
                                                 static_cast<cudaStream_t>(stream), win);
}

extern "C" int pmf_gauss_diag(const float* mb_self, const float* mb_other,
                              const float* sq_other, const int64_t* row_ptr,
                              const int32_t* other, const float* x, int n_self, int n_long,
                              int K, float* out, void* stream) {
  const tail_groups::Tables t{mb_self, mb_other, sq_other, row_ptr, other, x};
  return tail_groups::launch<tail_groups::kDiag>(t, n_self, n_long, K, 0.f, out,
                                                 static_cast<cudaStream_t>(stream));
}
