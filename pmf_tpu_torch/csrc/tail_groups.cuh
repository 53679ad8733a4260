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
// The dot form (K1 "cavi" from K = 129, K7 from K = 128, rows of 33 to
// 32 * kDotMaxVec float4 words): tail_dot_kernel.  There the register form
// has G = 32, V = 2: a warp a row, 4 edges in flight a warp, 103-109
// registers (16 warps an SM), five shuffles and a division an edge that no
// second edge shares.  In the dot form a warp takes a row and walks its
// edges in rounds of D edges: their rows are copied by cp.async into a
// ring of S rounds in the warp's shared memory (S - 1 rounds in flight
// while one is summed, no registers held for them); lane l reads words l,
// l + 32, ... of each of the round's rows, the D partial dots meet in one
// transposed reduction (log2(D) halving steps, then a butterfly: D + 4 -
// log2(D) shuffles for D dots, not 5 D), after which lane l holds the dot
// of edge l / (32 / D), takes that edge's rating from the ring and its
// coefficient x / max(dot, floor) (one division a lane for D edges), and D
// shuffles share the coefficients.  The sums are linear in e_o: acc_a sums
// coef * e_o and acc_o e_o (K7 s_o e_o, s_o read from the record in the
// ring), and the row's end multiplies acc_a by e_s.  Sums in edge order,
// no atomics, equal bits on a repeat.  Long rows keep a warp each (the
// register form's G = 32 did the same).  What bounds it on an H100 at
// K = 160: the gathers of 640-byte rows, 6.6 GB a sweep counted by sector
// (1.96 ms at 3.35 TB/s) of which L2 serves most; the item pass's user
// table (104 MB) is twice the L2, and with the other ids cut to 40,000
// rows the pass took 0.59 ms against 0.67 (K1 "raw", no dot, 0.43 against
// 0.75).
//
// The ring form (K6 from K = 128, rows of 33 to 32 * kRingMaxVec float4
// words): tail_ring_kernel, the dot form's walk for two rows an edge.  There
// the register form had G = 32, V = 2, D = 2: 110 registers, two edges in
// flight a warp, each edge's [m | b] record and v + m^2 row in registers,
// a five-step butterfly an edge.  In the ring form each edge's record (W
// words) and its v + m^2 row (Wq = ceil(K / 4) words) are copied by
// cp.async into a ring of S rounds of D edges in the warp's shared memory;
// lane l reads words l, l + 32, ... of both; the round's D partial dots
// <m_s, m_o> meet in one transposed reduction; the lane that holds edge
// d's dot reads its rating and b_o (column K of the record in the ring)
// and forms ((x - b_s) - b_o) - dot, the register form's float order
// (b_s read once a row from the self record); D shuffles share the
// coefficients.  Three accumulators a lane-word, in edge order: coef *
// m_o, v_o + m_o^2 (added straight from the ring) and m_o^2.  No atomics,
// equal bits on a repeat; long rows keep a warp each.  Geometry from
// scripts/probe_k6_ring.py (H100 80GB HBM3 at 700 W, the bench tail): D =
// 4, S = 3 at V = 2 (118 registers, 62.4 KB a CTA of 4 warps at K = 160: 3
// CTAs, 12 warps an SM), D = 2, S = 3 at V = 3 and 4 (118 and 140
// registers): there D = 4 left one or two CTAs an SM (116 KB a CTA at K =
// 300, 14% slower).  One record [m | b | v + m^2] a row, one contiguous
// copy an edge, ran within 2% of the two tables (the same sectors) and
// was not kept.  What bounds it at K = 160: the gathers of two rows an
// edge, 13.1 GB a sweep counted by sector (3.90 ms at 3.35 TB/s) of which
// L2 serves most; the item pass misses on the user tables (2 x 104 MB,
// four times the L2): with the other ids cut to 40,000 rows it took 1.12
// ms against 1.70.
//
// The sum form (K5 from K = 160, K8 from K = 144, to 128 float4 words a
// record: K = 511): tail_sum_kernel.  K5 and K8 take no per-edge dot: each
// lane sums its words of the other rows (K5 [m | b] and x, K8 s_o * e_o,
// dotted with e_s at the row's end).  A warp a row walks its edges in
// rounds of D = kSumInFlight = 2, each edge's record copied by cp.async into
// a ring of S = kSumStages = 4 rounds in the warp's shared memory, in edge
// order: equal bits to the register form's G = 32, V = 2 instance.  Where
// the gathered records exceed 1.5 times the L2 (the item pass's user
// records: 106 MB at K = 160), the rows' edges are walked in windows of
// other ids (ops/_tail.py::tail_windows: up to 4, each at most 0.75 of the
// L2, on passes of at least 16 edges a mean row and window), one window
// per grid.y, window-major so the CTAs of one window run together; each
// window's warp writes its row's partial sums, and the warp that arrives
// last (an arrival count a row) adds the row's nonempty windows in window
// order: no atomics on the sums, equal bits on a repeat.  Measured by
// scripts/probe_k5k8.py (H100 80GB HBM3 at 700 W, the bench tails): the
// ring alone lost to the register form by 4-12% (its loads cost less where
// every gather hits, and the register form was never short of warps: 40
// an SM for K5); the item pass lost 37-45% of its time to the user table's
// L2 misses, and the windows take 0.15-0.3 ms off it at K = 160; below K =
// 160 (K5) and 144 (K8) the register form stays, faster there.
//
// Past a span of 64 words (K1 raw past K = 256: rows of more than 64 float4
// words; K1 and K7 past the dot form, K6 past the ring form, K5 and K8 past
// the sum form) tail_wide_kernel takes the row:
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
constexpr int kDotWarps = 4;        // warps a CTA of tail_dot_kernel, a row each
constexpr int kDotInFlight = 4;     // D: edges a round of the dot form
constexpr int kDotStages = 3;       // S: rounds in a warp's ring
constexpr int kDotMaxVec = 4;       // words a lane: the dot form up to 128 words a row
constexpr int kRingInFlight = 4;      // D: edges a round of K6's ring form, 2 words a lane
constexpr int kRingWideInFlight = 2;  // and at 3 or 4 words a lane (rows past 64 words)
constexpr int kRingStages = 3;        // S: rounds in a warp's ring there
constexpr int kRingMaxVec = 4;        // words a lane: the ring form up to 128 words a row
constexpr int kSumInFlight = 2;    // D: edges a round of K5's and K8's sum form
constexpr int kSumStages = 4;      // S: rounds in a warp's ring there
constexpr int kSumMaxVec = 4;      // words a lane: the sum form up to 128 words a row
constexpr int kSumBiasFrom = 41;   // K5's sum form from 41 words a record (K = 160)
constexpr int kSumScalarFrom = 37; // K8's from 37 words (K = 144)

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

// ------------------------------------------------------------ dot form --

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// D partial dots (one a lane, each a register p[d]) summed over the warp:
// log2(D) halving steps at lane offsets 16, 8, ... (a lane keeps the half
// of its dots that its bit names and adds its partner's half), then a
// butterfly over the offsets left.  Lane l returns the whole dot of edge
// l / (32 / D).
template <int D>
__device__ __forceinline__ float warp_dots(float (&p)[D], int lane) {
#pragma unroll
  for (int j = 0; (D >> j) > 1; ++j) {
    const int n = D >> (j + 1);
    const bool hi = lane & (16 >> j);
#pragma unroll
    for (int i = 0; i < n; ++i) {
      const float send = hi ? p[i] : p[i + n];
      const float keep = hi ? p[i + n] : p[i];
      p[i] = keep + __shfl_xor_sync(kFull, send, 16 >> j);
    }
  }
  float v = p[0];
#pragma unroll
  for (int off = 32 / D / 2; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Float4 words of one warp's ring: S rounds of D rows of W words, then the
// S * D ratings (a word holds four; K8's sum form reads none).
__host__ __device__ constexpr int dot_ring_words(int W, int D, int S) {
  return S * D * W + (S * D + 3) / 4;
}

// K1 "cavi" (kCavi) or K7 (kExt) on rows of up to 32 V words: a warp a row
// (kDotWarps rows a CTA), its edges in rounds of D, a ring of S rounds in
// dynamic shared memory (the header's design note).
template <int kMode, int V, int D, int S>
__global__ void __launch_bounds__(32 * kDotWarps)
tail_dot_kernel(const float* __restrict__ e_self, const float* __restrict__ e_other,
                const int64_t* __restrict__ row_ptr, const int32_t* __restrict__ other,
                const float* __restrict__ x, int n_self, int K, float rate_floor,
                float* __restrict__ out) {
  static_assert(kMode == kCavi || kMode == kExt, "the dot form is K1 cavi's and K7's");
  static_assert((D & (D - 1)) == 0 && D <= 32 && S >= 2, "D a power of two, S >= 2");
  extern __shared__ float4 dot_ring[];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int row = blockIdx.x * kDotWarps + wid;
  if (row >= n_self) return;  // whole warp leaves together
  const int W = (columns(kMode, K) + 3) >> 2;  // words a row of e_other
  const int Ws = (K + 3) >> 2;                 // of e_self and of the output
  float4* __restrict__ ring = dot_ring + (int64_t)wid * dot_ring_words(W, D, S);
  float* __restrict__ ring_x = reinterpret_cast<float*>(ring + S * D * W);
  const int64_t begin = row_ptr[row];
  const int len = (int)(row_ptr[row + 1] - begin);
  const float4* __restrict__ eo4 = reinterpret_cast<const float4*>(e_other);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 es[V], acc_a[V], acc_o[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int w = 32 * v + lane;
    float4 e = zero;
    if (w < Ws) {
      e = reinterpret_cast<const float4*>(e_self)[(int64_t)row * Ws + w];
      const int k = 4 * w;
      if (k + 1 >= K) e.y = 0.f;  // the self row's pad columns
      if (k + 2 >= K) e.z = 0.f;
      if (k + 3 >= K) e.w = 0.f;
    }
    es[v] = e;
    acc_a[v] = zero;
    acc_o[v] = zero;
  }

  // Lane l holds the other id of edge 32 b + l of the batch b the copies
  // have reached (ids) and of the batch after it (nids).
  int batch = 0;
  int ids = lane < len ? other[begin + lane] : 0;
  int nids = 32 + lane < len ? other[begin + 32 + lane] : 0;
  const int rounds = (len + D - 1) / D;
  // Round q's rows and ratings into ring stage q % S; one commit group a
  // round (empty past the last).
  auto issue = [&](int q) {
    if (q < rounds) {
      const int b = (q * D) >> 5;  // rounds come in order: b is batch or batch + 1
      if (b != batch) {
        batch = b;
        ids = nids;
        const int e = 32 * (b + 1) + lane;
        nids = e < len ? other[begin + e] : 0;
      }
      const int st = q % S;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const int e = q * D + d;
        const int o = __shfl_sync(kFull, ids, e & 31);
        if (e < len) {
          float4* dst = ring + (st * D + d) * W;
          const float4* src = eo4 + (int64_t)o * W;
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const int w = 32 * v + lane;
            if (w < W) cp_async16(dst + w, src + w);
          }
        }
      }
      if (lane < D && q * D + lane < len) cp_async4(ring_x + st * D + lane, x + begin + q * D + lane);
    }
    cp_async_commit();
  };

#pragma unroll
  for (int q = 0; q < S - 1; ++q) issue(q);
  for (int r = 0; r < rounds; ++r) {
    issue(r + S - 1);
    cp_async_wait<S - 1>();  // round r has landed (this lane's copies)
    __syncwarp();            // and every lane's
    const int st = r % S;
    const float4* rows = ring + st * D * W;
    float4 eo[D][V];
    float part[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const bool ok = r * D + d < len;  // warp-uniform
      part[d] = 0.f;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int w = 32 * v + lane;
        eo[d][v] = (ok && w < W) ? rows[d * W + w] : zero;
        part[d] = fmaf(es[v].x, eo[d][v].x, part[d]);
        part[d] = fmaf(es[v].y, eo[d][v].y, part[d]);
        part[d] = fmaf(es[v].z, eo[d][v].z, part[d]);
        part[d] = fmaf(es[v].w, eo[d][v].w, part[d]);
      }
    }
    const float dot = warp_dots<D>(part, lane);
    const int dl = lane / (32 / D);  // the edge whose dot this lane holds
    const float xv = r * D + dl < len ? ring_x[st * D + dl] : 0.f;
    const float coef = xv / fmaxf(dot, rate_floor);
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float c = __shfl_sync(kFull, coef, d * (32 / D));
      float sv = 1.f;
      if constexpr (kMode == kExt)  // s_o, column K of the record
        sv = r * D + d < len ? reinterpret_cast<const float*>(rows + d * W)[K] : 0.f;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        acc_a[v].x = fmaf(c, eo[d][v].x, acc_a[v].x);
        acc_a[v].y = fmaf(c, eo[d][v].y, acc_a[v].y);
        acc_a[v].z = fmaf(c, eo[d][v].z, acc_a[v].z);
        acc_a[v].w = fmaf(c, eo[d][v].w, acc_a[v].w);
        if constexpr (kMode == kExt) {
          acc_o[v].x = fmaf(sv, eo[d][v].x, acc_o[v].x);
          acc_o[v].y = fmaf(sv, eo[d][v].y, acc_o[v].y);
          acc_o[v].z = fmaf(sv, eo[d][v].z, acc_o[v].z);
          acc_o[v].w = fmaf(sv, eo[d][v].w, acc_o[v].w);
        } else {
          acc_o[v].x += eo[d][v].x;
          acc_o[v].y += eo[d][v].y;
          acc_o[v].z += eo[d][v].z;
          acc_o[v].w += eo[d][v].w;
        }
      }
    }
    __syncwarp();  // every lane has read stage st before round r + S refills it
  }

  float* dst = out + (int64_t)row * 2 * K;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int w = 32 * v + lane;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = 4 * w + j;
      if (w < Ws && k < K) {
        dst[k] = comp(es[v], j) * comp(acc_a[v], j);
        dst[K + k] = comp(acc_o[v], j);
      }
    }
  }
}

// K6 (kDiag) on records of 33 to 32 V words: the ring form (the header's
// design note).  A warp a row (kDotWarps rows a CTA); each edge's [m | b]
// record (W words, rows rec_stride words apart) and its v + m^2 row (Wq
// words, sq_stride apart) copied into the warp's ring, E = W + Wq words an
// edge.  The entry passes W and Wq; scripts/probe_k6_ring.py passes one
// joined table's [m | b | v + m^2] rows.
template <int V, int D, int S>
__global__ void __launch_bounds__(32 * kDotWarps)
tail_ring_kernel(const float* __restrict__ mb_self, const float* __restrict__ mb_other,
                 const float* __restrict__ sq_other, const int64_t* __restrict__ row_ptr,
                 const int32_t* __restrict__ other, const float* __restrict__ x,
                 int n_self, int K, int rec_stride, int sq_stride, float* __restrict__ out) {
  static_assert((D & (D - 1)) == 0 && D <= 32 && S >= 2, "D a power of two, S >= 2");
  extern __shared__ float4 dot_ring[];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int row = blockIdx.x * kDotWarps + wid;
  if (row >= n_self) return;  // whole warp leaves together
  const int W = (K + 4) >> 2;   // words a record, [m | b]
  const int Wq = (K + 3) >> 2;  // of a v + m^2 row, and of each output block
  const int E = W + Wq;
  float4* __restrict__ ring = dot_ring + (int64_t)wid * dot_ring_words(E, D, S);
  float* __restrict__ ring_x = reinterpret_cast<float*>(ring + S * D * E);
  const int64_t begin = row_ptr[row];
  const int len = (int)(row_ptr[row + 1] - begin);
  const float4* __restrict__ mb4 = reinterpret_cast<const float4*>(mb_other);
  const float4* __restrict__ sq4 = reinterpret_cast<const float4*>(sq_other);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  // ms: m_s with b_s and the pad zeroed; acc_a, acc_o, acc_c the three
  // output blocks.
  float4 ms[V], acc_a[V], acc_o[V], acc_c[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int w = 32 * v + lane;
    float4 e = zero;
    if (w < Wq) {
      e = reinterpret_cast<const float4*>(mb_self)[(int64_t)row * W + w];
      const int k = 4 * w;
      if (k + 1 >= K) e.y = 0.f;
      if (k + 2 >= K) e.z = 0.f;
      if (k + 3 >= K) e.w = 0.f;
    }
    ms[v] = e;
    acc_a[v] = zero;
    acc_o[v] = zero;
    acc_c[v] = zero;
  }
  const float bs = mb_self[(int64_t)row * 4 * W + K];

  int batch = 0;
  int ids = lane < len ? other[begin + lane] : 0;
  int nids = 32 + lane < len ? other[begin + 32 + lane] : 0;
  const int rounds = (len + D - 1) / D;
  // Round q's records, v + m^2 rows and ratings into ring stage q % S; one
  // commit group a round (empty past the last).
  auto issue = [&](int q) {
    if (q < rounds) {
      const int b = (q * D) >> 5;
      if (b != batch) {
        batch = b;
        ids = nids;
        const int e = 32 * (b + 1) + lane;
        nids = e < len ? other[begin + e] : 0;
      }
      const int st = q % S;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const int e = q * D + d;
        const int o = __shfl_sync(kFull, ids, e & 31);
        if (e < len) {
          float4* dst = ring + (st * D + d) * E;
          const float4* rec = mb4 + (int64_t)o * rec_stride;
          const float4* sq = sq4 + (int64_t)o * sq_stride;
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const int w = 32 * v + lane;
            if (w < W) cp_async16(dst + w, rec + w);
            if (w < Wq) cp_async16(dst + W + w, sq + w);
          }
        }
      }
      if (lane < D && q * D + lane < len) cp_async4(ring_x + st * D + lane, x + begin + q * D + lane);
    }
    cp_async_commit();
  };

#pragma unroll
  for (int q = 0; q < S - 1; ++q) issue(q);
  for (int r = 0; r < rounds; ++r) {
    issue(r + S - 1);
    cp_async_wait<S - 1>();  // round r has landed (this lane's copies)
    __syncwarp();            // and every lane's
    const int st = r % S;
    const float4* edges = ring + st * D * E;
    float4 mo[D][V];
    float part[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const bool ok = r * D + d < len;  // warp-uniform
      part[d] = 0.f;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int w = 32 * v + lane;
        mo[d][v] = (ok && w < Wq) ? edges[d * E + w] : zero;
        part[d] = fmaf(ms[v].x, mo[d][v].x, part[d]);
        part[d] = fmaf(ms[v].y, mo[d][v].y, part[d]);
        part[d] = fmaf(ms[v].z, mo[d][v].z, part[d]);
        part[d] = fmaf(ms[v].w, mo[d][v].w, part[d]);
      }
    }
    const float dot = warp_dots<D>(part, lane);
    const int dl = lane / (32 / D);  // the edge whose dot this lane holds
    float xv = 0.f, bo = 0.f;
    if (r * D + dl < len) {
      xv = ring_x[st * D + dl];
      bo = reinterpret_cast<const float*>(edges + dl * E)[K];  // b_o, column K
    }
    const float coef = ((xv - bs) - bo) - dot;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float c = __shfl_sync(kFull, coef, d * (32 / D));
      const bool ok = r * D + d < len;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int w = 32 * v + lane;
        acc_a[v].x = fmaf(c, mo[d][v].x, acc_a[v].x);
        acc_a[v].y = fmaf(c, mo[d][v].y, acc_a[v].y);
        acc_a[v].z = fmaf(c, mo[d][v].z, acc_a[v].z);
        acc_a[v].w = fmaf(c, mo[d][v].w, acc_a[v].w);
        acc_c[v].x = fmaf(mo[d][v].x, mo[d][v].x, acc_c[v].x);
        acc_c[v].y = fmaf(mo[d][v].y, mo[d][v].y, acc_c[v].y);
        acc_c[v].z = fmaf(mo[d][v].z, mo[d][v].z, acc_c[v].z);
        acc_c[v].w = fmaf(mo[d][v].w, mo[d][v].w, acc_c[v].w);
        if (ok && w < Wq) {
          const float4 sq = edges[d * E + W + w];
          acc_o[v].x += sq.x;
          acc_o[v].y += sq.y;
          acc_o[v].z += sq.z;
          acc_o[v].w += sq.w;
        }
      }
    }
    __syncwarp();  // every lane has read stage st before round r + S refills it
  }

  float* dst = out + (int64_t)row * 3 * K;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int w = 32 * v + lane;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = 4 * w + j;
      if (w < Wq && k < K) {
        dst[k] = comp(acc_a[v], j);
        dst[K + k] = comp(acc_o[v], j);
        dst[2 * K + k] = comp(acc_c[v], j);
      }
    }
  }
}

// K5's and K8's other-id windows (the sum form): n windows of other ids;
// window w's edges of self row r are [ptr[w n_self + r], ptr[(w + 1) n_self
// + r]) of ``other`` and ``x`` (the tail's edges regrouped by window inside
// each row, so ptr[0] and ptr[n] are the CSR's row pointers); ``part``
// holds n partial output rows a self row, ``count`` an arrival count a self
// row (zero before the launch).  n = 1: no windows, the CSR itself.
struct Windows {
  int n = 1;
  const int64_t* ptr = nullptr;
  const int32_t* other = nullptr;
  const float* x = nullptr;
  float* part = nullptr;
  unsigned* count = nullptr;
};

// K5 (kBias) or K8 (kScalar) on records of up to 32 V words: the sum form
// (the header's design note).  A warp a row (kDotWarps rows a CTA) and a
// window (blockIdx.y); each edge's record (W words) copied into the warp's
// ring, K5's ratings beside the rounds.  Lane l sums words l, l + 32, ... of
// the records in edge order: K5 the record and the rating, K8 s_o * e_o
// (s_o, column K, read from the ring); K8 dots its sums with its words of
// e_self at the row's end, one butterfly a row.  With windows, each
// window's warp writes its partial row (K5) or dot (K8), and the warp that
// arrives last adds the row's nonempty windows' partials in window order.
template <int kMode, int V, int D, int S>
__global__ void __launch_bounds__(32 * kDotWarps)
tail_sum_kernel(const float* __restrict__ e_self, const float* __restrict__ e_other,
                const int64_t* __restrict__ row_ptr, const int32_t* __restrict__ other,
                const float* __restrict__ x, int n_self, int K, Windows win,
                float* __restrict__ out) {
  static_assert(kMode == kBias || kMode == kScalar, "the sum form is K5's and K8's");
  static_assert((D & (D - 1)) == 0 && D <= 32 && S >= 2, "D a power of two, S >= 2");
  extern __shared__ float4 dot_ring[];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int row = blockIdx.x * kDotWarps + wid;
  if (row >= n_self) return;  // whole warp leaves together
  const int wnd = blockIdx.y;  // the window
  const int W = (K + 4) >> 2;   // words a record, [m | b] or [e | s]
  const int Ws = (K + 3) >> 2;  // of e_self (K8)
  const int Wout = kMode == kBias ? K + 2 : 1;  // floats an output row
  float4* __restrict__ ring = dot_ring + (int64_t)wid * dot_ring_words(W, D, S);
  float* __restrict__ ring_x = reinterpret_cast<float*>(ring + S * D * W);
  int64_t begin = row_ptr[row];
  int len = (int)(row_ptr[row + 1] - begin);
  if (win.n > 1) {
    begin = win.ptr[(int64_t)wnd * n_self + row];
    len = (int)(win.ptr[(int64_t)(wnd + 1) * n_self + row] - begin);
    other = win.other;
    x = win.x;
  }
  const float4* __restrict__ eo4 = reinterpret_cast<const float4*>(e_other);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = zero;
  float acc_x = 0.f;  // K5: sum x

  int batch = 0;
  int ids = lane < len ? other[begin + lane] : 0;
  int nids = 32 + lane < len ? other[begin + 32 + lane] : 0;
  const int rounds = (len + D - 1) / D;
  // Round q's records (and K5's ratings) into ring stage q % S; one commit
  // group a round (empty past the last).
  auto issue = [&](int q) {
    if (q < rounds) {
      const int b = (q * D) >> 5;
      if (b != batch) {
        batch = b;
        ids = nids;
        const int e = 32 * (b + 1) + lane;
        nids = e < len ? other[begin + e] : 0;
      }
      const int st = q % S;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const int e = q * D + d;
        const int o = __shfl_sync(kFull, ids, e & 31);
        if (e < len) {
          float4* dst = ring + (st * D + d) * W;
          const float4* src = eo4 + (int64_t)o * W;
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const int w = 32 * v + lane;
            if (w < W) cp_async16(dst + w, src + w);
          }
        }
      }
      if constexpr (kMode == kBias) {
        if (lane < D && q * D + lane < len)
          cp_async4(ring_x + st * D + lane, x + begin + q * D + lane);
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int q = 0; q < S - 1; ++q) issue(q);
  for (int r = 0; r < rounds; ++r) {
    issue(r + S - 1);
    cp_async_wait<S - 1>();  // round r has landed (this lane's copies)
    __syncwarp();            // and every lane's
    const int st = r % S;
    const float4* rows = ring + st * D * W;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      if (r * D + d >= len) break;  // warp-uniform: the row's last round
      const float4* rec = rows + d * W;
      float sv = 0.f;  // K8: s_o, column K of the record
      if constexpr (kMode == kScalar) sv = reinterpret_cast<const float*>(rec)[K];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float4 eo = 32 * v + lane < W ? rec[32 * v + lane] : zero;
        if constexpr (kMode == kScalar) {
          acc[v].x = fmaf(sv, eo.x, acc[v].x);
          acc[v].y = fmaf(sv, eo.y, acc[v].y);
          acc[v].z = fmaf(sv, eo.z, acc[v].z);
          acc[v].w = fmaf(sv, eo.w, acc[v].w);
        } else {
          acc[v].x += eo.x;
          acc[v].y += eo.y;
          acc[v].z += eo.z;
          acc[v].w += eo.w;
        }
      }
      if constexpr (kMode == kBias) acc_x += ring_x[st * D + d];
    }
    __syncwarp();  // every lane has read stage st before round r + S refills it
  }

  float dot = 0.f;  // K8: <e_s, sum s_o e_o>, one butterfly a row
  if constexpr (kMode == kScalar) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int w = 32 * v + lane;
      float4 e = zero;
      if (w < Ws) {
        e = reinterpret_cast<const float4*>(e_self)[(int64_t)row * Ws + w];
        const int k = 4 * w;
        if (k + 1 >= K) e.y = 0.f;  // the self row's pad columns
        if (k + 2 >= K) e.z = 0.f;
        if (k + 3 >= K) e.w = 0.f;
      }
      dot = fmaf(e.x, acc[v].x, dot);
      dot = fmaf(e.y, acc[v].y, dot);
      dot = fmaf(e.z, acc[v].z, dot);
      dot = fmaf(e.w, acc[v].w, dot);
    }
    dot = group_sum<32>(dot);
  }
  // Lane l's output floats: K8 float 0 (lane 0), K5 4 w + j for its words w
  // (k <= K) and K + 1 (sum x, lane 0).
  auto own = [&](int v, int j) { return comp(acc[v], j); };
  if (win.n > 1) {  // the partial into the window's slot; the last to arrive adds
    float* mine = win.part + ((int64_t)wnd * n_self + row) * Wout;
    if (len > 0) {
      if constexpr (kMode == kScalar) {
        if (lane == 0) mine[0] = dot;
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const int w = 32 * v + lane;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (w < W && 4 * w + j <= K) mine[4 * w + j] = own(v, j);
        }
        if (lane == 0) mine[K + 1] = acc_x;
      }
    }
    __threadfence();
    __syncwarp();
    unsigned before = 0;
    if (lane == 0) before = atomicAdd(win.count + row, 1u);
    if (__shfl_sync(kFull, before, 0) != (unsigned)(win.n - 1)) return;
    __threadfence();
    // The windows' partials in window order, the empty ones left out.
    float4 tot[V];
#pragma unroll
    for (int v = 0; v < V; ++v) tot[v] = zero;
    float tot_x = 0.f, tot_dot = 0.f;
    for (int u = 0; u < win.n; ++u) {
      const int64_t lo = win.ptr[(int64_t)u * n_self + row];
      if (win.ptr[(int64_t)(u + 1) * n_self + row] == lo) continue;  // warp-uniform
      const float* theirs = win.part + ((int64_t)u * n_self + row) * Wout;
      if constexpr (kMode == kScalar) {
        tot_dot += u == wnd ? dot : __ldcg(theirs);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const int w = 32 * v + lane;
          if (w < W) {
            float4 p = acc[v];
            if (u != wnd) {
              p.x = 4 * w <= K ? __ldcg(theirs + 4 * w) : 0.f;
              p.y = 4 * w + 1 <= K ? __ldcg(theirs + 4 * w + 1) : 0.f;
              p.z = 4 * w + 2 <= K ? __ldcg(theirs + 4 * w + 2) : 0.f;
              p.w = 4 * w + 3 <= K ? __ldcg(theirs + 4 * w + 3) : 0.f;
            }
            tot[v].x += p.x;
            tot[v].y += p.y;
            tot[v].z += p.z;
            tot[v].w += p.w;
          }
        }
        tot_x += u == wnd ? acc_x : __ldcg(theirs + K + 1);
      }
    }
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = tot[v];
    acc_x = tot_x;
    dot = tot_dot;
  }

  if constexpr (kMode == kScalar) {
    if (lane == 0) out[row] = dot;
  } else {
    float* dst = out + (int64_t)row * Wout;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int w = 32 * v + lane;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = 4 * w + j;
        if (w < W && k <= K) dst[k] = own(v, j);  // [sum m | sum b]
      }
    }
    if (lane == 0) dst[K + 1] = acc_x;
  }
}

// The plan for K: W = ceil(columns / 4) words a row, span = the power of
// two at or above W, V = 1 word a lane up to a span of one_word(mode) and 2
// past it, G = span / V lanes a row, in_flight(mode) edges in flight a
// group; past a span of kMaxSpan words tail_wide_kernel.  K1 "cavi" and
// K7 take the dot form for W in (32, 32 * kDotMaxVec], K6 the ring form
// for W in (32, 32 * kRingMaxVec], K5 and K8 the sum form for W in (32,
// 32 * kSumMaxVec], V = ceil(W / 32) words a lane, and tail_wide_kernel
// past them (ops/_tail.py::launch_plan mirrors it).
__host__ __device__ constexpr int plan_words(int mode, int K) { return (columns(mode, K) + 3) / 4; }
__host__ __device__ constexpr bool plan_dot(int mode, int K) {
  return (mode == kCavi || mode == kExt) && plan_words(mode, K) > 32 &&
         plan_words(mode, K) <= 32 * kDotMaxVec;
}
// K6 takes the ring form for W in (32, 32 * kRingMaxVec], V = ceil(W / 32).
static_assert(kRingMaxVec >= 2, "the ring form takes every K6 row of 33 to 64 words");
__host__ __device__ constexpr bool plan_ring(int mode, int K) {
  return mode == kDiag && plan_words(mode, K) > 32 && plan_words(mode, K) <= 32 * kRingMaxVec;
}
// K5 takes the sum form for W in [kSumBiasFrom, 32 * kSumMaxVec], K8 for W in
// [kSumScalarFrom, 32 * kSumMaxVec], V = ceil(W / 32); the register form's
// G = 32, V = 2 below (it ran faster there: PERF.md, the sum form).
static_assert(kSumBiasFrom > 32 && kSumScalarFrom > 32 && kSumBiasFrom <= kMaxSpan + 1 &&
                  kSumScalarFrom <= kMaxSpan + 1 && kSumMaxVec >= 2,
              "the register form takes K5's and K8's rows below the sum form");
__host__ __device__ constexpr bool plan_sum(int mode, int K) {
  return ((mode == kBias && plan_words(mode, K) >= kSumBiasFrom) ||
          (mode == kScalar && plan_words(mode, K) >= kSumScalarFrom)) &&
         plan_words(mode, K) <= 32 * kSumMaxVec;
}
__host__ __device__ constexpr int plan_dot_vec(int mode, int K) {
  return (plan_words(mode, K) + 31) / 32;
}
__host__ __device__ constexpr int plan_span(int mode, int K) {
  int span = 1;
  while (span < plan_words(mode, K)) span *= 2;
  return span;
}
__host__ __device__ constexpr int plan_vec(int mode, int K) {
  return plan_span(mode, K) <= one_word(mode) ? 1 : 2;
}
__host__ __device__ constexpr int plan_lanes(int mode, int K) {
  return plan_span(mode, K) / plan_vec(mode, K);
}
__host__ __device__ constexpr bool plan_wide(int mode, int K) {
  return mode == kCavi || mode == kExt ? plan_words(mode, K) > 32 * kDotMaxVec
         : mode == kDiag               ? plan_words(mode, K) > 32 * kRingMaxVec
         : mode == kRaw                ? plan_span(mode, K) > kMaxSpan
                                       : plan_words(mode, K) > 32 * kSumMaxVec;  // K5, K8
}
// Whether some K of the register form takes the plan (G, V) in this mode:
// only those instances are built.
__host__ __device__ constexpr bool reachable(int mode, int G, int V) {
  for (int K = 1; plan_span(mode, K) <= kMaxSpan; ++K)
    if (!plan_dot(mode, K) && !plan_ring(mode, K) && plan_lanes(mode, K) == G &&
        plan_vec(mode, K) == V && !plan_sum(mode, K))
      return true;
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

// The dot form at V words a lane: dynamic shared memory of kDotWarps rings
// (the attribute raised past the default 48 KB).
template <int kMode, int V>
int launch_dot(const Tables& t, int n_self, int K, float rate_floor, float* out,
               cudaStream_t stream) {
  constexpr int D = kDotInFlight, S = kDotStages;
  auto kernel = tail_dot_kernel<kMode, V, D, S>;
  const int smem = kDotWarps * 16 * dot_ring_words(plan_words(kMode, K), D, S);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(n_self + kDotWarps - 1) / kDotWarps, 32 * kDotWarps, smem, stream>>>(
      t.e_self, t.e_other, t.row_ptr, t.other, t.x, n_self, K, rate_floor, out);
  return (int)cudaGetLastError();
}

// K6's ring form at V words a lane, D edges a round, S rounds a ring, its
// other tables' rows rec_stride and sq_stride float4 words apart: dynamic
// shared memory of kDotWarps rings.
template <int V, int D, int S>
int launch_ring(const Tables& t, int n_self, int K, int rec_stride, int sq_stride, float* out,
                cudaStream_t stream) {
  auto kernel = tail_ring_kernel<V, D, S>;
  const int smem = kDotWarps * 16 * dot_ring_words(plan_words(kDiag, K) + (K + 3) / 4, D, S);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(n_self + kDotWarps - 1) / kDotWarps, 32 * kDotWarps, smem, stream>>>(
      t.e_self, t.e_other, t.sq_other, t.row_ptr, t.other, t.x, n_self, K, rec_stride,
      sq_stride, out);
  return (int)cudaGetLastError();
}

// K5's or K8's sum form at V words a lane, D edges a round, S rounds a
// ring: dynamic shared memory of kDotWarps rings; grid.y the windows.
template <int kMode, int V, int D, int S>
int launch_sum(const Tables& t, int n_self, int K, const Windows& win, float* out,
               cudaStream_t stream) {
  auto kernel = tail_sum_kernel<kMode, V, D, S>;
  const int smem = kDotWarps * 16 * dot_ring_words(plan_words(kMode, K), D, S);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((n_self + kDotWarps - 1) / kDotWarps, win.n);  // window-major
  kernel<<<grid, 32 * kDotWarps, smem, stream>>>(t.e_self, t.e_other, t.row_ptr, t.other,
                                                 t.x, n_self, K, win, out);
  return (int)cudaGetLastError();
}

// Warps [0, n_long) take a row each (the dot, ring and sum forms give every
// row a warp).
// ``win``: K5's and K8's other-id windows, taken by the sum form alone.
template <int kMode>
int launch(const Tables& t, int n_self, int n_long, int K, float rate_floor, float* out,
           cudaStream_t stream, const Windows& win = Windows{}) {
  if (bad_args(n_self, n_long, K) || win.n < 1 ||
      (win.n > 1 && !(plan_sum(kMode, K) && win.ptr && win.other && win.part && win.count &&
                      (kMode != kBias || win.x))))
    return (int)cudaErrorInvalidValue;
  if (n_self == 0) return (int)cudaGetLastError();
  if (plan_wide(kMode, K)) {
    tail_wide_kernel<kMode><<<(n_self + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
        t.e_self, t.e_other, t.sq_other, t.row_ptr, t.other, t.x, n_self, K, rate_floor,
        out);
    return (int)cudaGetLastError();
  }
  if constexpr (kMode == kCavi || kMode == kExt) {
    if (plan_dot(kMode, K)) {
      switch (plan_dot_vec(kMode, K)) {
        case 2: return launch_dot<kMode, 2>(t, n_self, K, rate_floor, out, stream);
        case 3: return launch_dot<kMode, 3>(t, n_self, K, rate_floor, out, stream);
        case 4: return launch_dot<kMode, 4>(t, n_self, K, rate_floor, out, stream);
        default: return (int)cudaErrorInvalidValue;
      }
    }
  }
  if constexpr (kMode == kDiag) {
    if (plan_ring(kMode, K)) {
      constexpr int D = kRingInFlight, Dw = kRingWideInFlight, S = kRingStages;
      const int W = plan_words(kMode, K), Wq = (K + 3) / 4;
      switch (plan_dot_vec(kMode, K)) {
        case 2: return launch_ring<2, D, S>(t, n_self, K, W, Wq, out, stream);
        case 3: return launch_ring<3, Dw, S>(t, n_self, K, W, Wq, out, stream);
        case 4: return launch_ring<4, Dw, S>(t, n_self, K, W, Wq, out, stream);
        default: return (int)cudaErrorInvalidValue;
      }
    }
  }
  if constexpr (kMode == kBias || kMode == kScalar) {
    if (plan_sum(kMode, K)) {
      constexpr int D = kSumInFlight, S = kSumStages;
      switch (plan_dot_vec(kMode, K)) {
        case 2: return launch_sum<kMode, 2, D, S>(t, n_self, K, win, out, stream);
        case 3: return launch_sum<kMode, 3, D, S>(t, n_self, K, win, out, stream);
        case 4: return launch_sum<kMode, 4, D, S>(t, n_self, K, win, out, stream);
        default: return (int)cudaErrorInvalidValue;
      }
    }
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
