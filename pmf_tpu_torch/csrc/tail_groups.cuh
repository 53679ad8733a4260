// The row-group skeleton of the sparse-tail edge passes K1 (modes "cavi"
// and "raw"), K7, K5, K6 and K8.
//
// Replaces: pmf_tpu/ops/pallas/cavi_edge.py::_kernel (K1, modes "cavi" and
//           "raw"), pmf_tpu/ops/pallas/ext_edge.py::_factor_kernel (K7)
//           and ::_scalar_kernel (K8),
//           pmf_tpu/ops/pallas/gaussian_edge.py::_bias_kernel (K5) and
//           ::_diag_kernel (K6); included by cavi_edge.cu, ext_edge.cu and
//           gaussian_edge.cu, which hold the entry points.
//
// Per new-space self row r with tail edges (r, o, x) in CSR:
//   cavi  out[r, 0:K] = sum_e x * e_s * e_o / max(<e_s, e_o>, floor),  out[r, K:2K] = sum_e e_o
//   raw   out[r, 0:K] = sum_e e_s * e_o,                               out[r, K:2K] = sum_e e_o
//   ext   out[r, 0:K] = as cavi,                                       out[r, K:2K] = sum_e s_o * e_o
//   bias  out[r] = [sum_e m_o | sum_e b_o | sum_e x]                   (K + 2 columns)
//   diag  out[r] = [sum_e m_o (x - b_s - b_o - <m_s, m_o>) | sum_e sq_o | sum_e m_o^2]
//                                                                      (3K columns)
//   scalar out[r] = sum_e s_o * <e_s, e_o>                             (1 column)
// with sq_o = v_o + m_o^2 (K6's other-row second moment).  Rows without
// tail edges get zeros.
//
// What bounds them on an H100: instruction issue and the latency of the L2
// row gathers, not bytes.  At K=20 the other table is 4.7 MB (by user) or
// 13.0 MB (by item), resident in the 50 MB L2; per edge the kernel reads an
// 8-byte (id, rating) pair from HBM and an 80-byte row (3 sectors) from
// L2 (K5, K7 and K8 a 96-byte record, [m | b] or [e | s], 3 sectors; K6
// that record and an 80-byte v + m^2 row).  The previous design (a warp a
// row, lane l factor l) spent seven warp shuffles an edge in K1: two
// broadcasts and a five-step dot butterfly.  At one warp shuffle a clock
// per SM (cc 9.0) that is 7 x 4.74M edges / 132 SMs, about 0.13 ms a
// direction, beside a bytes bound of 0.02 ms; it also left 12 of 32 lanes
// idle at K=20 and kept four edges in flight a warp.
//
// Design: a group of G lanes (a power of two) takes one self row, so a warp
// holds 32/G rows; ops/_tail.py::launch_plan mirrors the choice of G, V and
// D below (K=20: G=8, V=1, 5 or 6 of 8 lanes loading; K=50: G=8, V=2 for K1,
// K7 and K8, G=16, V=1 for K5 and K6).  Tables are padded to a stride of 4 *
// ceil(columns / 4) floats, so every row starts on 16 bytes, and lane l of a
// group holds the float4 words l, l + G, ..., l + (V - 1) G of a row (words
// past the row hold 0; the self row's pad columns are zeroed, so finite pad
// columns of the other tables add nothing to a dot; the builders write zeros
// there).  K5 and K6 read m and b as one record [m | b] of K + 1 columns, K7
// and K8 e and s as one record [e | s]: K5 sums the whole record (sum m |
// sum b); K6, K7 and K8 take the scalar (b_o, s_o) from the lane holding
// column K by one shuffle an edge; K6 takes b_s once a row and gathers v +
// m^2 into the same lanes' words, so its three sums line up with m.  (A
// scalar read beside the row, a load by every lane and a sector an edge, was
// 14-29% slower in K5 and K6, and in K8 0.20 against 0.15 ms a sweep at
// K=20, H100 80GB HBM3 at 700 W; loaded by every lane from the record,
// 12-15% slower in K6.)  K8 is linear in e_o: each lane sums s_o * e_o over
// its words, one multiply-add an element an edge and no butterfly, and dots
// that with its words of the self row at the row's end, one butterfly a row.
// The dot of an edge (cavi, ext, diag) is a log2(G)-step __shfl_xor_sync
// butterfly inside the group, one warp instruction for 32/G edges.  Each
// lane loads the (id, rating) of every G-th edge of a batch of B = max(G, 8)
// edges, coalesced within the group, one batch ahead, and the group shares
// them by __shfl_sync of width G.  A group gathers D edges at once (D = 4;
// K6, two rows an edge, 2), so a warp has D * 32/G in flight (8 in flight
// measured slower).  The warp walks its longest row's batches together
// (edges past a row's end read nothing and add zeros), so every shuffle
// names the full warp; rows are in descending-count order in new space, so a
// warp's rows have nearly equal lengths.
//
// Past a span of 64 words (K1 past K = 256, the record modes from K = 255
// on: rows of more than 64 float4 words) tail_wide_kernel takes the row:
// a warp a row, lane l holding words l and l + 32 of a chunk of 64 words,
// the chunks one after another (a second walk of the row's edges a chunk).
// Each edge's dot runs over the whole row in every chunk, the lane's words
// l, l + 32, ... of e_s and e_o read again from L1 and L2, and the scalar
// (b_o, s_o) is a load by every lane; K8 sums its chunks' dots in the
// warp.  Correct at any K, not tuned: at K = 300 it reads each row's
// factors three times where the register form reads them once.
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
constexpr int kInFlight = 4;       // edges a group gathers at once (K1, K7, K5, K8)
constexpr int kDiagInFlight = 2;   // K6
constexpr int kOneWord = 8;        // K1, K7, K8: one word a lane up to 8 words, wider two
constexpr int kRecordOneWord = 16;  // K5, K6 ([m | b] records): up to 16 words
constexpr int kMaxSpan = 64;        // words a row of the register form: G = 32, V = 2
constexpr int kWideWords = 64;      // words a chunk of tail_wide_kernel: 2 a lane

enum Mode { kCavi = 0, kRaw = 1, kExt = 2, kBias = 3, kDiag = 4, kScalar = 5 };

// What a pass reads.  Tables of rows are padded to 4 * ceil(columns / 4)
// floats and start on 16 bytes; a pointer a mode does not read may be null.
struct Tables {
  const float* e_self;    // self rows: K1, K7, K8 e_self; K6 [m_self | b_self]
  const float* e_other;   // other rows: K1 e_other; K7, K8 [e_other | s_other];
                          // K5, K6 [m_other | b_other]
  const float* sq_other;  // K6: v_other + m_other^2, K columns
  const int64_t* row_ptr;
  const int32_t* other;
  const float* x;         // ratings: every mode but kRaw and K8
};

// K5 and K6 gather [m | b] records, K7 and K8 [e | s] records: K + 1
// columns, the scalar in column K.
__host__ __device__ constexpr bool is_record(int mode) { return mode >= kExt; }
// The modes that take the other row's scalar (b_o, s_o) from its record.
__host__ __device__ constexpr bool reads_scalar(int mode) {
  return is_record(mode) && mode != kBias;
}
// The modes that read the ratings: all but kRaw and K8.
__host__ __device__ constexpr bool reads_x(int mode) {
  return mode != kRaw && mode != kScalar;
}
__host__ __device__ constexpr int columns(int mode, int K) { return is_record(mode) ? K + 1 : K; }
__host__ __device__ constexpr int out_width(int mode, int K) {
  return mode == kBias ? K + 2 : mode == kDiag ? 3 * K : mode == kScalar ? 1 : 2 * K;
}
__host__ __device__ constexpr int in_flight(int mode) {
  return mode == kDiag ? kDiagInFlight : kInFlight;
}
__host__ __device__ constexpr int one_word(int mode) {
  return mode == kBias || mode == kDiag ? kRecordOneWord : kOneWord;
}

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

// One launch: G lanes a row, V float4 words a lane (G * V >= the row's
// words), D edges in flight a group.  Warps [0, n_long) take rows
// [0, n_long), one a warp, their 32/G groups each walking a contiguous
// share of the row's edges; the later warps take 32/G rows each from row
// n_long on.
template <int kMode, int G, int V, int D>
__global__ void __launch_bounds__(kThreads)
tail_group_kernel(const float* __restrict__ e_self,
                  const float* __restrict__ e_other,
                  const float* __restrict__ sq_other,
                  const int64_t* __restrict__ row_ptr,
                  const int32_t* __restrict__ other,
                  const float* __restrict__ x,
                  int n_self, int n_long, int K, float rate_floor,
                  float* __restrict__ out) {
  constexpr int R = 32 / G;  // groups a warp
  constexpr int B = batch_of(G);
  constexpr int P = B / G;
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
  const int C = columns(kMode, K);
  const int W = (C + 3) >> 2;  // float4 words a row of e_other
  const int Wq = (K + 3) >> 2;  // of sq_other
  const int Ws = kMode == kDiag ? W : Wq;  // of e_self (K6: a record)
  const int span = (int)__reduce_max_sync(kFull, (unsigned)len);

  const float4* __restrict__ eo4 = reinterpret_cast<const float4*>(e_other);
  const float4* __restrict__ sq4 = reinterpret_cast<const float4*>(sq_other);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  // cavi, raw, ext: acc_a the first K columns, acc_o the second; bias:
  // acc_o sums the [m | b] record; diag: acc_a, acc_o, acc_c its three
  // column blocks.
  float4 es[V], acc_a[V], acc_o[V], acc_c[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int w = v * G + gl;
    float4 e = zero;
    if constexpr (kMode != kBias) {  // K5 reads no self row
      if (has_row && w < Ws) {
        e = reinterpret_cast<const float4*>(e_self)[(int64_t)row * Ws + w];
        const int k = 4 * w;
        if (k >= K) e.x = 0.f;  // K6: b_s, column K of the record
        if (k + 1 >= K) e.y = 0.f;
        if (k + 2 >= K) e.z = 0.f;
        if (k + 3 >= K) e.w = 0.f;
      }
    }
    es[v] = e;
    acc_a[v] = zero;
    acc_o[v] = zero;
    acc_c[v] = zero;
  }
  float acc_x = 0.f;  // bias: sum x
  float bs = 0.f;     // diag: b_s
  if constexpr (kMode == kDiag) {
    if (has_row) bs = e_self[(int64_t)row * 4 * W + K];
  }

  // One edge: the group's dot where the mode needs one, then the lane's
  // words.
  auto edge = [&](const float4 (&eo)[V], const float4 (&sq)[V], float xv, float sv) {
    if constexpr (kMode == kScalar) {  // K8: s_o e_o, dotted with e_s at the end
#pragma unroll
      for (int v = 0; v < V; ++v) {
        acc_o[v].x += sv * eo[v].x;
        acc_o[v].y += sv * eo[v].y;
        acc_o[v].z += sv * eo[v].z;
        acc_o[v].w += sv * eo[v].w;
      }
    } else if constexpr (kMode == kRaw) {
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
    } else if constexpr (kMode == kBias) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        acc_o[v].x += eo[v].x;
        acc_o[v].y += eo[v].y;
        acc_o[v].z += eo[v].z;
        acc_o[v].w += eo[v].w;
      }
      acc_x += xv;
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
      if constexpr (kMode == kDiag) {
        const float coef = ((xv - bs) - sv) - group_sum<G>(part);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          acc_a[v].x += coef * eo[v].x;
          acc_a[v].y += coef * eo[v].y;
          acc_a[v].z += coef * eo[v].z;
          acc_a[v].w += coef * eo[v].w;
          acc_o[v].x += sq[v].x;
          acc_o[v].y += sq[v].y;
          acc_o[v].z += sq[v].z;
          acc_o[v].w += sq[v].w;
          acc_c[v].x += eo[v].x * eo[v].x;
          acc_c[v].y += eo[v].y * eo[v].y;
          acc_c[v].z += eo[v].z * eo[v].z;
          acc_c[v].w += eo[v].w * eo[v].w;
        }
      } else {
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
    }
  };

  // Lane gl loads edges base + gl + G q of its row's batch (q < P).
  auto load_batch = [&](int base, int (&ids)[P], float (&xs)[P]) {
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const int e = base + gl + G * q;
      const bool ok = e < len;
      ids[q] = ok ? other[begin + e] : 0;
      if constexpr (reads_x(kMode)) xs[q] = ok ? x[begin + e] : 0.f;
    }
  };

  int ids[P] = {}, nids[P] = {};
  float xs[P] = {}, nxs[P] = {};
  if (span > 0) load_batch(0, ids, xs);
  for (int base = 0; base < span; base += B) {
    if (base + B < span) load_batch(base + B, nids, nxs);  // warp-uniform
#pragma unroll
    for (int c = 0; c < B; c += D) {
      float4 eo[D][V], sq[D][V];
      float xv[D], sv[D];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const int e = c + d;  // edge e of the batch: lane e % G, slot e / G
        const int o = group_bcast<G>(ids[e / G], e % G);
        xv[d] = 0.f;
        sv[d] = 0.f;
        if constexpr (reads_x(kMode)) xv[d] = group_bcast<G>(xs[e / G], e % G);
        const bool ok = base + e < len;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const int w = v * G + gl;
          eo[d][v] = (ok && w < W) ? __ldg(eo4 + (int64_t)o * W + w) : zero;
          if constexpr (kMode == kDiag)
            sq[d][v] = (ok && w < Wq) ? __ldg(sq4 + (int64_t)o * Wq + w) : zero;
        }
      }
      if constexpr (reads_scalar(kMode)) {
        // b_o (K6) or s_o (K7, K8): column K of the record, word K / 4
        // (lane (K / 4) % G, slot (K / 4) / G), from that lane to the group
        // (a shuffle an edge measured faster than a load of it by every
        // lane, or than a scalar read beside the row).
        const int wb = K >> 2;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          float4 src = eo[d][0];
          if constexpr (V > 1) {
            if (wb >= G) src = eo[d][1];
          }
          sv[d] = group_bcast<G>(comp(src, K & 3), wb & (G - 1));
        }
      }
#pragma unroll
      for (int d = 0; d < D; ++d) edge(eo[d], sq[d], xv[d], sv[d]);
    }
#pragma unroll
    for (int q = 0; q < P; ++q) {
      ids[q] = nids[q];
      xs[q] = nxs[q];
    }
  }

  if constexpr (kMode == kScalar) {  // K8: <e_s, sum s_o e_o>, one group_sum a row
    float part = 0.f;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      part += es[v].x * acc_o[v].x;
      part += es[v].y * acc_o[v].y;
      part += es[v].z * acc_o[v].z;
      part += es[v].w * acc_o[v].w;
    }
    part = group_sum<G>(part);
    if (split) {  // the groups' shares of the row, by a fixed butterfly
#pragma unroll
      for (int off = G; off < 32; off <<= 1) part += __shfl_xor_sync(kFull, part, off);
    }
    if (has_row && !(split && group != 0) && gl == 0) out[row] = part;
    return;
  }

  if (split) {  // the groups' shares of the row, by a fixed butterfly
#pragma unroll
    for (int v = 0; v < V; ++v) {
#pragma unroll
      for (int off = G; off < 32; off <<= 1) {
        if constexpr (kMode != kBias) {
          acc_a[v].x += __shfl_xor_sync(kFull, acc_a[v].x, off);
          acc_a[v].y += __shfl_xor_sync(kFull, acc_a[v].y, off);
          acc_a[v].z += __shfl_xor_sync(kFull, acc_a[v].z, off);
          acc_a[v].w += __shfl_xor_sync(kFull, acc_a[v].w, off);
        }
        acc_o[v].x += __shfl_xor_sync(kFull, acc_o[v].x, off);
        acc_o[v].y += __shfl_xor_sync(kFull, acc_o[v].y, off);
        acc_o[v].z += __shfl_xor_sync(kFull, acc_o[v].z, off);
        acc_o[v].w += __shfl_xor_sync(kFull, acc_o[v].w, off);
        if constexpr (kMode == kDiag) {
          acc_c[v].x += __shfl_xor_sync(kFull, acc_c[v].x, off);
          acc_c[v].y += __shfl_xor_sync(kFull, acc_c[v].y, off);
          acc_c[v].z += __shfl_xor_sync(kFull, acc_c[v].z, off);
          acc_c[v].w += __shfl_xor_sync(kFull, acc_c[v].w, off);
        }
      }
    }
    if constexpr (kMode == kBias) {
#pragma unroll
      for (int off = G; off < 32; off <<= 1) acc_x += __shfl_xor_sync(kFull, acc_x, off);
    }
  }
  if (!has_row || (split && group != 0)) return;
  float* dst = out + (int64_t)row * out_width(kMode, K);
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int w = v * G + gl;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = 4 * w + j;
      if constexpr (kMode == kBias) {
        if (w < W && k < C) dst[k] = comp(acc_o[v], j);  // [sum m | sum b]
      } else if (w < W && k < K) {
        dst[k] = comp(acc_a[v], j);
        dst[K + k] = comp(acc_o[v], j);
        if constexpr (kMode == kDiag) dst[2 * K + k] = comp(acc_c[v], j);
      }
    }
  }
  if constexpr (kMode == kBias) {
    if (gl == 0) dst[K + 1] = acc_x;
  }
}

// Rows of more than kMaxSpan words: a warp a row (n_long plays no part:
// the warp walks the whole row), the output words in chunks of kWideWords,
// lane l holding words c + l and c + 32 + l of chunk c.  Every chunk walks
// the row's edges; the dot of an edge (cavi, ext, diag) is taken over the
// whole row each time, and the scalar of a record (b_o, s_o) is read by
// every lane.  K8 dots each chunk's sum of s_o e_o with e_s and adds the
// chunks' dots in order.
template <int kMode>
__global__ void __launch_bounds__(kThreads)
tail_wide_kernel(const float* __restrict__ e_self, const float* __restrict__ e_other,
                 const float* __restrict__ sq_other, const int64_t* __restrict__ row_ptr,
                 const int32_t* __restrict__ other, const float* __restrict__ x,
                 int n_self, int K, float rate_floor, float* __restrict__ out) {
  constexpr int V = kWideWords / 32;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n_self) return;  // whole warp leaves together
  const int64_t begin = row_ptr[row];
  const int len = (int)(row_ptr[row + 1] - begin);
  const int C = columns(kMode, K);
  const int W = (C + 3) >> 2;   // float4 words a row of e_other
  const int Wq = (K + 3) >> 2;  // words holding the K factors
  const int Ws = kMode == kDiag ? W : Wq;  // of e_self (K6: a record)
  const int Wout = kMode == kBias ? W : Wq;  // words a chunk walk sums
  const float4* __restrict__ es4 = reinterpret_cast<const float4*>(e_self) + (int64_t)row * Ws;
  const float4* __restrict__ eo4 = reinterpret_cast<const float4*>(e_other);
  const float4* __restrict__ sq4 = reinterpret_cast<const float4*>(sq_other);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  // Word w of the self row with the columns past K zeroed (K6: b_s).
  auto self_word = [&](int w) {
    float4 e = es4[w];
    const int k = 4 * w;
    if (k >= K) e.x = 0.f;
    if (k + 1 >= K) e.y = 0.f;
    if (k + 2 >= K) e.z = 0.f;
    if (k + 3 >= K) e.w = 0.f;
    return e;
  };
  float bs = 0.f;
  if constexpr (kMode == kDiag) bs = e_self[(int64_t)row * 4 * W + K];
  float scalar_total = 0.f;  // K8

  for (int c0 = 0; c0 < Wout; c0 += kWideWords) {
    float4 es[V], acc_a[V], acc_o[V], acc_c[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int w = c0 + 32 * v + lane;
      es[v] = (kMode != kBias && w < Wq) ? self_word(w) : zero;
      acc_a[v] = zero;
      acc_o[v] = zero;
      acc_c[v] = zero;
    }
    float acc_x = 0.f;
    for (int base = 0; base < len; base += 32) {
      const int n = min(len - base, 32);
      int my_o = 0;
      float my_x = 0.f;
      if (lane < n) {
        my_o = other[begin + base + lane];
        if constexpr (reads_x(kMode)) my_x = x[begin + base + lane];
      }
      for (int j = 0; j < n; ++j) {
        const int o = __shfl_sync(kFull, my_o, j);
        const float xv = __shfl_sync(kFull, my_x, j);
        const float4* orow = eo4 + (int64_t)o * W;
        float4 eo[V], sq[V];
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const int w = c0 + 32 * v + lane;
          eo[v] = w < Wout ? __ldg(orow + w) : zero;
          if constexpr (kMode == kDiag)
            sq[v] = w < Wq ? __ldg(sq4 + (int64_t)o * Wq + w) : zero;
        }
        float sv = 0.f;
        if constexpr (reads_scalar(kMode)) sv = __ldg(e_other + (int64_t)o * 4 * W + K);
        float coef = 0.f;
        if constexpr (kMode == kCavi || kMode == kExt || kMode == kDiag) {
          float part = 0.f;
          for (int w = lane; w < Wq; w += 32) {
            const float4 p = mul4(self_word(w), __ldg(orow + w));
            part += p.x;
            part += p.y;
            part += p.z;
            part += p.w;
          }
          const float dot = group_sum<32>(part);
          coef = kMode == kDiag ? ((xv - bs) - sv) - dot : xv / fmaxf(dot, rate_floor);
        }
#pragma unroll
        for (int v = 0; v < V; ++v) {
          if constexpr (kMode == kScalar) {
            acc_o[v].x += sv * eo[v].x;
            acc_o[v].y += sv * eo[v].y;
            acc_o[v].z += sv * eo[v].z;
            acc_o[v].w += sv * eo[v].w;
          } else if constexpr (kMode == kBias) {
            acc_o[v].x += eo[v].x;
            acc_o[v].y += eo[v].y;
            acc_o[v].z += eo[v].z;
            acc_o[v].w += eo[v].w;
          } else if constexpr (kMode == kDiag) {
            acc_a[v].x += coef * eo[v].x;
            acc_a[v].y += coef * eo[v].y;
            acc_a[v].z += coef * eo[v].z;
            acc_a[v].w += coef * eo[v].w;
            acc_o[v].x += sq[v].x;
            acc_o[v].y += sq[v].y;
            acc_o[v].z += sq[v].z;
            acc_o[v].w += sq[v].w;
            acc_c[v].x += eo[v].x * eo[v].x;
            acc_c[v].y += eo[v].y * eo[v].y;
            acc_c[v].z += eo[v].z * eo[v].z;
            acc_c[v].w += eo[v].w * eo[v].w;
          } else {
            const float4 p = mul4(es[v], eo[v]);
            const float a = kMode == kRaw ? 1.f : coef;
            acc_a[v].x += a * p.x;
            acc_a[v].y += a * p.y;
            acc_a[v].z += a * p.z;
            acc_a[v].w += a * p.w;
            const float b = kMode == kExt ? sv : 1.f;
            acc_o[v].x += b * eo[v].x;
            acc_o[v].y += b * eo[v].y;
            acc_o[v].z += b * eo[v].z;
            acc_o[v].w += b * eo[v].w;
          }
        }
        if constexpr (kMode == kBias) acc_x += xv;
      }
    }
    if constexpr (kMode == kScalar) {
      float part = 0.f;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        part += es[v].x * acc_o[v].x;
        part += es[v].y * acc_o[v].y;
        part += es[v].z * acc_o[v].z;
        part += es[v].w * acc_o[v].w;
      }
      scalar_total += group_sum<32>(part);
      continue;
    }
    float* dst = out + (int64_t)row * out_width(kMode, K);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int w = c0 + 32 * v + lane;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = 4 * w + j;
        if constexpr (kMode == kBias) {
          if (k < C) dst[k] = comp(acc_o[v], j);  // [sum m | sum b]
        } else if (k < K) {
          dst[k] = comp(acc_a[v], j);
          dst[K + k] = comp(acc_o[v], j);
          if constexpr (kMode == kDiag) dst[2 * K + k] = comp(acc_c[v], j);
        }
      }
    }
    if constexpr (kMode == kBias) {
      if (c0 == 0 && lane == 0) dst[K + 1] = acc_x;
    }
  }
  if constexpr (kMode == kScalar) {
    if (lane == 0) out[row] = scalar_total;
  }
}

// The plan for K: W = ceil(columns / 4) words a row, span = the power of
// two at or above W, V = 1 word a lane up to a span of one_word(mode) and 2
// past it, G = span / V lanes a row, in_flight(mode) edges in flight a
// group; past a span of kMaxSpan words tail_wide_kernel
// (ops/_tail.py::launch_plan mirrors it).
__host__ __device__ constexpr int plan_span(int mode, int K) {
  int span = 1;
  while (span < (columns(mode, K) + 3) / 4) span *= 2;
  return span;
}
__host__ __device__ constexpr int plan_vec(int mode, int K) {
  return plan_span(mode, K) <= one_word(mode) ? 1 : 2;
}
__host__ __device__ constexpr int plan_lanes(int mode, int K) {
  return plan_span(mode, K) / plan_vec(mode, K);
}
__host__ __device__ constexpr bool plan_wide(int mode, int K) {
  return plan_span(mode, K) > kMaxSpan;
}
// Whether some K of the register form takes the plan (G, V) in this mode:
// only those instances are built.
__host__ __device__ constexpr bool reachable(int mode, int G, int V) {
  for (int K = 1; !plan_wide(mode, K); ++K)
    if (plan_lanes(mode, K) == G && plan_vec(mode, K) == V) return true;
  return false;
}

inline int blocks_of(int n_self, int n_long, int G) {
  const int64_t warps = n_long + ((int64_t)(n_self - n_long) * G + 31) / 32;
  return (int)((warps + kWarps - 1) / kWarps);
}

inline bool bad_args(int n_self, int n_long, int K) {
  return K < 1 || n_long < 0 || n_long > n_self;
}

template <int kMode, int G, int V, int D>
int launch_instance(const Tables& t, int n_self, int n_long, int K, float rate_floor,
                    float* out, cudaStream_t stream) {
  tail_group_kernel<kMode, G, V, D><<<blocks_of(n_self, n_long, G), kThreads, 0, stream>>>(
      t.e_self, t.e_other, t.sq_other, t.row_ptr, t.other, t.x, n_self, n_long,
      K, rate_floor, out);
  return (int)cudaGetLastError();
}

// Warps [0, n_long) take a row each.
template <int kMode>
int launch(const Tables& t, int n_self, int n_long, int K, float rate_floor, float* out,
           cudaStream_t stream) {
  if (bad_args(n_self, n_long, K)) return (int)cudaErrorInvalidValue;
  if (n_self == 0) return (int)cudaGetLastError();
  if (plan_wide(kMode, K)) {
    tail_wide_kernel<kMode><<<(n_self + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
        t.e_self, t.e_other, t.sq_other, t.row_ptr, t.other, t.x, n_self, K, rate_floor,
        out);
    return (int)cudaGetLastError();
  }
  const int G = plan_lanes(kMode, K), V = plan_vec(kMode, K);
  constexpr int D = in_flight(kMode);
#define PMF_TAIL_PLAN(G_, V_)                                                      \
  if constexpr (reachable(kMode, G_, V_)) {                                        \
    if (G == G_ && V == V_)                                                        \
      return launch_instance<kMode, G_, V_, D>(t, n_self, n_long, K, rate_floor, out, \
                                               stream);                           \
  }
  PMF_TAIL_PLAN(1, 1)
  PMF_TAIL_PLAN(2, 1)
  PMF_TAIL_PLAN(4, 1)
  PMF_TAIL_PLAN(8, 1)
  PMF_TAIL_PLAN(16, 1)
  PMF_TAIL_PLAN(8, 2)
  PMF_TAIL_PLAN(16, 2)
  PMF_TAIL_PLAN(32, 2)
#undef PMF_TAIL_PLAN
  return (int)cudaErrorInvalidValue;
}

}  // namespace tail_groups
