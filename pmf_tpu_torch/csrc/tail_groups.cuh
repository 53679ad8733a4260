// The row-group skeleton of K1 (modes "cavi" and "raw") and K7, the
// Poisson-family sparse-tail edge passes.
//
// Replaces: pmf_tpu/ops/pallas/cavi_edge.py::_kernel (K1, modes "cavi" and
//           "raw") and pmf_tpu/ops/pallas/ext_edge.py::_factor_kernel (K7);
// included by cavi_edge.cu and ext_edge.cu, which hold the entry points.
//
// Per new-space self row r with tail edges (r, o, x) in CSR:
//   cavi  out[r, 0:K] = sum_e x * e_s * e_o / max(<e_s, e_o>, floor),  out[r, K:2K] = sum_e e_o
//   raw   out[r, 0:K] = sum_e e_s * e_o,                               out[r, K:2K] = sum_e e_o
//   ext   out[r, 0:K] = as cavi,                                       out[r, K:2K] = sum_e s_o * e_o
// Rows without tail edges get zeros.
//
// What bounds them on an H100: instruction issue and the latency of the L2
// row gathers, not bytes.  At K=20 the other table is 4.7 MB (by user) or
// 13.0 MB (by item), resident in the 50 MB L2; per edge the kernel reads an
// 8-byte (id, rating) pair from HBM and an 80-byte row (3 sectors) from
// L2.  The previous design (a warp a row, lane l factor l) spent seven warp
// shuffles an edge: two broadcasts and a five-step dot butterfly.  At one
// warp shuffle a clock per SM (cc 9.0) that is 7 x 4.74M edges / 132 SMs,
// about 0.13 ms a direction, beside a bytes bound of 0.02 ms; it also left
// 12 of 32 lanes idle at K=20 and kept four edges in flight a warp.
//
// Design: a group of G lanes (a power of two) takes one self row, so a warp
// holds 32/G rows; ops/_tail.py::launch_plan mirrors the choice of G and V
// from K below (K=20: G=8, V=1, 5 of 8 lanes loading; K=50: G=8, V=2).
// Tables are padded to a stride of 4 * ceil(K / 4) floats, so every row
// starts on 16 bytes, and lane l of a group holds the float4 words l, l + G,
// ..., l + (V - 1) G of a row (words past the row hold 0; the self row's pad
// columns are zeroed, so finite pad columns of the other table add nothing;
// the builders write zeros there).  The dot of an edge is a log2(G)-step
// __shfl_xor_sync butterfly inside the group, one warp instruction for 32/G
// edges.  Each lane loads the (id, rating) of every G-th edge of a batch of
// B = max(G, 8) edges, coalesced within the group, one batch ahead, and the
// group shares them by __shfl_sync of width G; K7's scalar s_o is read by
// every lane of the group from the same address beside the row gather.  A
// group gathers 4 edges at once, so a warp has 4 * 32/G in flight (8 in
// flight measured slower).  The warp walks its longest row's batches
// together (edges past a row's end read nothing and add zeros), so every
// shuffle names the full warp; rows are in descending-count order in new
// space, so a warp's rows have nearly equal lengths.
//
// Long rows: a group walks its row one gather round trip at a time, so
// the item pass's 757-edge rows set its end (on an H100 at K=20 the item
// pass took 0.26 ms unsplit against the user pass's 0.14 on as many
// edges, whose rows stop at 112).  The first n_long rows of new space
// (TailCSR.long_rows: every row of at least LONG_ROW edges lies among
// them) therefore take a whole warp each: group j walks the j-th
// contiguous share of the row, and the groups' sums meet by a butterfly
// over lane offsets G, 2G, ..., 16.  Sums accumulate in registers in a
// fixed order (edge order within a group): no atomics, equal bits on a
// repeat.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tail_groups {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;     // warps a CTA
constexpr int kThreads = 32 * kWarps;
constexpr int kInFlight = 4;  // edges a group gathers at once
constexpr int kMaxK = 128;    // at most 32 float4 words a row
constexpr int kOneWord = 8;   // spans up to 8 words take one word a lane, wider two

enum Mode { kCavi = 0, kRaw = 1, kExt = 2 };

// Edges a group takes a batch: each lane loads B / G of their ids.
__host__ __device__ constexpr int batch_of(int g) { return g < 8 ? 8 : g; }

template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off, G);
  return v;
}

template <int G, typename T>
__device__ __forceinline__ T group_bcast(T v, int src) {
  if constexpr (G == 1) {
    return v;
  } else {
    return __shfl_sync(kFull, v, src, G);
  }
}

__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}

__device__ __forceinline__ float comp(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// One launch: G lanes a row, V float4 words a lane (G * V >= ceil(K / 4)).  Warps [0, n_long) take rows [0, n_long), one
// a warp, their 32/G groups each walking a contiguous share of the row's
// edges; the later warps take 32/G rows each from row n_long on.  e_self
// and e_other are padded to 4 * ceil(K / 4) floats a row and start on 16
// bytes; s_other is read in mode kExt only, x in modes kCavi and kExt.
template <int kMode, int G, int V>
__global__ void __launch_bounds__(kThreads)
tail_group_kernel(const float* __restrict__ e_self,
                  const float* __restrict__ e_other,
                  const float* __restrict__ s_other,
                  const int64_t* __restrict__ row_ptr,
                  const int32_t* __restrict__ other,
                  const float* __restrict__ x,
                  int n_self, int n_long, int K, float rate_floor,
                  float* __restrict__ out) {
  constexpr int R = 32 / G;  // groups a warp
  constexpr int B = batch_of(G);
  constexpr int P = B / G;
  constexpr int D = kInFlight;
  static_assert(B % D == 0 && B % G == 0, "batch must hold whole gathers");
  const int lane = threadIdx.x & 31;
  const int gl = lane & (G - 1);
  const int group = lane / G;
  const int warp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const bool split = warp < n_long;  // warp-uniform
  int row;
  int64_t begin = 0;
  int len = 0;
  if (split) {
    row = warp;
    begin = row_ptr[row];
    const int n = (int)(row_ptr[row + 1] - begin);
    const int share = (n + R - 1) / R;
    const int lo = min(group * share, n);
    begin += lo;
    len = min(share, n - lo);
  } else {
    const int row0 = n_long + (warp - n_long) * R;
    if (row0 >= n_self) return;  // whole warp leaves together
    row = row0 + group;
    if (row < n_self) {
      begin = row_ptr[row];
      len = (int)(row_ptr[row + 1] - begin);
    }
  }
  const bool has_row = row < n_self;
  const int W = (K + 3) >> 2;  // float4 words a row
  const int span = (int)__reduce_max_sync(kFull, (unsigned)len);

  const float4* __restrict__ eo4 = reinterpret_cast<const float4*>(e_other);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 es[V], acc_a[V], acc_o[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int w = v * G + gl;
    float4 e = zero;
    if (has_row && w < W) {
      e = reinterpret_cast<const float4*>(e_self)[(int64_t)row * W + w];
      const int k = 4 * w;
      if (k + 1 >= K) e.y = 0.f;
      if (k + 2 >= K) e.z = 0.f;
      if (k + 3 >= K) e.w = 0.f;
    }
    es[v] = e;
    acc_a[v] = zero;
    acc_o[v] = zero;
  }

  // One edge: the rate from the group's dot, then the lane's words.
  auto edge = [&](const float4 (&eo)[V], float xv, float sv) {
    if constexpr (kMode == kRaw) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        acc_a[v].x += es[v].x * eo[v].x;
        acc_a[v].y += es[v].y * eo[v].y;
        acc_a[v].z += es[v].z * eo[v].z;
        acc_a[v].w += es[v].w * eo[v].w;
        acc_o[v].x += eo[v].x;
        acc_o[v].y += eo[v].y;
        acc_o[v].z += eo[v].z;
        acc_o[v].w += eo[v].w;
      }
    } else {
      float4 p[V];
      float part = 0.f;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        p[v] = mul4(es[v], eo[v]);
        part += p[v].x;
        part += p[v].y;
        part += p[v].z;
        part += p[v].w;
      }
      const float coef = xv / fmaxf(group_sum<G>(part), rate_floor);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        acc_a[v].x += coef * p[v].x;
        acc_a[v].y += coef * p[v].y;
        acc_a[v].z += coef * p[v].z;
        acc_a[v].w += coef * p[v].w;
        if constexpr (kMode == kExt) {
          acc_o[v].x += sv * eo[v].x;
          acc_o[v].y += sv * eo[v].y;
          acc_o[v].z += sv * eo[v].z;
          acc_o[v].w += sv * eo[v].w;
        } else {
          acc_o[v].x += eo[v].x;
          acc_o[v].y += eo[v].y;
          acc_o[v].z += eo[v].z;
          acc_o[v].w += eo[v].w;
        }
      }
    }
  };

  // Lane gl loads edges base + gl + G q of its row's batch (q < P).
  auto load_batch = [&](int base, int (&ids)[P], float (&xs)[P]) {
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const int e = base + gl + G * q;
      const bool ok = e < len;
      ids[q] = ok ? other[begin + e] : 0;
      if constexpr (kMode != kRaw) xs[q] = ok ? x[begin + e] : 0.f;
    }
  };

  int ids[P] = {}, nids[P] = {};
  float xs[P] = {}, nxs[P] = {};
  if (span > 0) load_batch(0, ids, xs);
  for (int base = 0; base < span; base += B) {
    if (base + B < span) load_batch(base + B, nids, nxs);  // warp-uniform
#pragma unroll
    for (int c = 0; c < B; c += D) {
      float4 eo[D][V];
      float xv[D], sv[D];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const int e = c + d;  // edge e of the batch: lane e % G, slot e / G
        const int o = group_bcast<G>(ids[e / G], e % G);
        xv[d] = 0.f;
        sv[d] = 0.f;
        if constexpr (kMode != kRaw) xv[d] = group_bcast<G>(xs[e / G], e % G);
        const bool ok = base + e < len;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const int w = v * G + gl;
          eo[d][v] = (ok && w < W) ? __ldg(eo4 + (int64_t)o * W + w) : zero;
        }
        if constexpr (kMode == kExt) sv[d] = ok ? __ldg(s_other + o) : 0.f;
      }
#pragma unroll
      for (int d = 0; d < D; ++d) edge(eo[d], xv[d], sv[d]);
    }
#pragma unroll
    for (int q = 0; q < P; ++q) {
      ids[q] = nids[q];
      xs[q] = nxs[q];
    }
  }

  if (split) {  // the groups' shares of the row, by a fixed butterfly
#pragma unroll
    for (int v = 0; v < V; ++v) {
#pragma unroll
      for (int off = G; off < 32; off <<= 1) {
        acc_a[v].x += __shfl_xor_sync(kFull, acc_a[v].x, off);
        acc_a[v].y += __shfl_xor_sync(kFull, acc_a[v].y, off);
        acc_a[v].z += __shfl_xor_sync(kFull, acc_a[v].z, off);
        acc_a[v].w += __shfl_xor_sync(kFull, acc_a[v].w, off);
        acc_o[v].x += __shfl_xor_sync(kFull, acc_o[v].x, off);
        acc_o[v].y += __shfl_xor_sync(kFull, acc_o[v].y, off);
        acc_o[v].z += __shfl_xor_sync(kFull, acc_o[v].z, off);
        acc_o[v].w += __shfl_xor_sync(kFull, acc_o[v].w, off);
      }
    }
  }
  if (!has_row || (split && group != 0)) return;
  float* dst = out + (int64_t)row * 2 * K;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int w = v * G + gl;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = 4 * w + j;
      if (w < W && k < K) {
        dst[k] = comp(acc_a[v], j);
        dst[K + k] = comp(acc_o[v], j);
      }
    }
  }
}

// The plan for K: W = ceil(K / 4) words a row, span = the power of two at
// or above W, V = 1 word a lane up to a span of kOneWord and 2 past it, G =
// span / V lanes a row (ops/_tail.py::launch_plan mirrors it).  Warps
// [0, n_long) take a row each.
template <int kMode>
int launch(const float* e_self, const float* e_other, const float* s_other,
           const int64_t* row_ptr, const int32_t* other, const float* x,
           int n_self, int n_long, int K, float rate_floor, float* out,
           cudaStream_t stream) {
  if (K < 1 || K > kMaxK || n_long < 0 || n_long > n_self)
    return (int)cudaErrorInvalidValue;
  if (n_self == 0) return (int)cudaGetLastError();
  const int W = (K + 3) / 4;
  int span = 1;
  while (span < W) span *= 2;
  const int V = span <= kOneWord ? 1 : 2;
  const int G = span / V;
  const int64_t warps = n_long + ((int64_t)(n_self - n_long) * G + 31) / 32;
  const int blocks = (int)((warps + kWarps - 1) / kWarps);
#define PMF_TAIL_PLAN(G_, V_)                                                      \
  if (G == G_ && V == V_) {                                                        \
    tail_group_kernel<kMode, G_, V_><<<blocks, kThreads, 0, stream>>>(             \
        e_self, e_other, s_other, row_ptr, other, x, n_self, n_long, K, rate_floor,\
        out);                                                                      \
    return (int)cudaGetLastError();                                                \
  }
  PMF_TAIL_PLAN(1, 1)
  PMF_TAIL_PLAN(2, 1)
  PMF_TAIL_PLAN(4, 1)
  PMF_TAIL_PLAN(8, 1)
  PMF_TAIL_PLAN(8, 2)
  PMF_TAIL_PLAN(16, 2)
#undef PMF_TAIL_PLAN
  return (int)cudaErrorInvalidValue;
}

}  // namespace tail_groups
