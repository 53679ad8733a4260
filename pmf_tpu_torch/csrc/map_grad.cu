// K9 — HPF-MAP minibatch gradients of the Poisson NLL, one launch a
// direction an Adam step.
//
// Replaces: pmf_tpu/ops/pallas/map_grad.py::_kernel.
//
// Layout (ops/map_grad.py::group_steps, rebuilt on the card once an epoch
// from the epoch's segment order): one direction's edges grouped by (step,
// self row), so that a row's edges inside one step form one run (to K =
// 128 a step's runs ordered by length, longest first), and every run cut
// into pieces of at most PIECE edges.  Piece p holds the edges
// piece_ptr[p] .. piece_ptr[p + 1] of `other` / `x`, belongs to row
// piece_row[p], and its run is the piece_count[p] pieces from
// piece_first[p] on.  Step s owns the pieces step_off[s] .. step_off[s + 1].
// With the softplus'd tables [theta | xi] and [beta | eta] (K+1 columns,
// row stride K+1, the last column not part of the dot), per edge:
//   lam = max(<self, other>, floor)
//   w   = 1 - x / lam        (0 where the dot fell below the floor)
//   nll = lam - x log lam
// and per row of the step, STORED into the zeroed accumulator row:
//   out[row, 0:K] = sum_e w * other[o_e]
//   out[row, K]   = number of edges
//   out[row, K+1] = sum_e nll                  (with_nll: user direction)
// The user direction runs with (self, other) = (users, items) and row
// width K+2, the item direction with the tables swapped and width K+1.
// lam is computed in both directions: that doubles a dot and saves every
// atomic on the other side's rows.
//
// What bounds it on an H100: memory and latency, not arithmetic.  Per edge
// it streams an 8-byte (other id, rating) pair from HBM and gathers one
// (K+1)-float row of the other table (at K = 20 both tables, under 19 MB,
// stay in the 50 MB L2; at K = 160 the user table, 104 MB, is twice the
// L2, one step's rows are not).  Per piece it reads 20 bytes of piece list
// and writes one accumulator row (or one partial row and, for the last
// piece of a run, reads the run's partials).  The arithmetic (~4K flops
// per edge) is far below the FP32 line.
//
// Design: one launch covers a whole step (65,536 edges at batch_size
// 65536), and no warp walks a long run while the card waits.
//  * K <= 128, the runs form (map_grad_runs_kernel<G, V>).  The grouping
//    (ops/map_grad.py::group_steps) orders each step's runs by length,
//    longest first, and splits them in two classes: runs of more than
//    short_of(K) = 16 edges are cut into pieces of PIECE = 64 edges (the
//    step's first n_long pieces), the shorter runs are one piece each
//    (the step's last n_short pieces).  On the bench's steps (PERF.md)
//    a user run holds 15.9 edges and an item run 6.0 on average, so one
//    warp a run left most of its lanes idle.  Here a GROUP of G lanes
//    takes a short run, so a warp takes R = 32 / G of them, whose lengths
//    are near equal (sorted); lane l of a group holds columns l, l + G,
//    ..., l + (V - 1) G of the rows (G V >= K, loads coalesced within the
//    group), the group gathers D = kRunInFlight edges at once, each
//    edge's dot is a log2(G)-step butterfly inside the group (every lane
//    of the group ends with the same float), and the group stores its
//    row itself: each lane its columns, its first lane the count and the
//    nll.  A long piece takes a whole warp: its R groups walk contiguous
//    shares of its edges and their sums meet by a butterfly across the
//    groups (offsets G, 2G, ..., 16) before the first group stores the
//    row, or the partial row and the run's merge.  The grid is sized by
//    the step's own classes (the host passes n_long and n_short, counted
//    once an epoch), the long pieces' blocks first.  Measured on the bench's
//    steps (scripts/probe_k9.py, chip_smoke.py's phase k9 parent; H100
//    80GB HBM3, 700 W): one warp a piece took 18.3-18.5 ms an epoch at K =
//    20 (its lane form's 31-shuffle reduce-scatter more than half of the
//    item pass), this form 6.4-6.6; at K = 50 28.9 -> 9.9, at 128 31.2 ->
//    17.0.  Short runs of at most 16 edges and pieces of 64 ran 16% and
//    15-28% faster than 32 and 128; what is left at K = 20 is mostly each
//    launch's fixed chain of metadata loads (the walk compiled out keeps
//    89% of the item pass).
//  * 128 < K <= 256: one warp a piece, lanes over factors, F = ceil(K /
//    32) a lane (an instance for each F from 5 to 8), a warp dot an edge
//    (one __shfl_xor_sync butterfly), four edges in flight, as K1; pieces
//    of PIECE_WIDE = 32 edges.  What sets a launch's end past K = 128
//    (H100, scripts/probe_k9.py, PERF.md) is the longest walk of one
//    warp, not the gathers' bytes: at K = 160 pieces of 32 edges in place
//    of 128 took an epoch from 34.8 to 23.1 ms.  A form that gave a warp a
//    span of short pieces and copied their rows through a cp.async ring in
//    shared memory lost to this one at K = 129-256 and won 1.2-1.4x only
//    past 256, where no fit runs; it is kept in the probe
//    (scripts/probe_k9_stream.cuh), not here.
//  * K > 256 (map_grad_general_kernel): lanes over factors in a loop, one
//    edge at a time, the sums of w * other kept in the row the piece
//    stores (its output row or its scratch partial) instead of registers:
//    a read and a write of L1 a factor an edge.  Correct at any K, not
//    tuned.
//  * Rows are unique within a step.  A run of one piece STORES its row: no
//    read-modify-write.  A run of several pieces writes each piece's
//    partial row to a scratch slot; the last piece to arrive (a counter a
//    run, atomicInc after __threadfence, which wraps the counter back to 0
//    for the next launch) adds the run's partials in piece order and
//    stores the row.  No float atomics: every sum is taken in a fixed
//    order, so two launches of one step give equal bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWideMaxF = 8;  // factors a lane of the register instances: K <= 256
constexpr int kRunInFlight = 4;  // edges a group of the runs form gathers at once

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Sum v over the G lanes of each aligned group of G lanes (an xor
// butterfly: every lane of the group ends with the same float).
template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off, G);
  return v;
}

struct Pieces {
  const int32_t* step_off;
  const int64_t* piece_ptr;
  const int32_t* piece_row;
  const int32_t* piece_first;
  const int32_t* piece_count;
  const int32_t* other;
  const float* x;
};

// One row (or partial) of width K + 1 + with_nll: lane l holds factors
// l, l + 32, ... in v; lane 0 writes the count and the nll.
template <int F>
__device__ __forceinline__ void store_row(float* dst, const float (&v)[F], float count,
                                          float nll, int K, int with_nll, int lane) {
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const int k = 32 * f + lane;
    if (k < K) dst[k] = v[f];
  }
  if (lane == 0) {
    dst[K] = count;
    if (with_nll) dst[K + 1] = nll;
  }
}

__device__ __forceinline__ void merge_run(const Pieces& pc, int p, int p0, int row, int n,
                                          int width, float* out, float* scratch,
                                          unsigned* counters, int lane);

// Piece p (local slot p - p0) is done: store its row, or its partial and,
// if it is the run's last piece to arrive, the run's sum.
template <int F>
__device__ __forceinline__ void finish_piece(const Pieces& pc, int p, int p0, int row,
                                             const float (&v)[F], float count, float nll,
                                             int K, int with_nll, float* out,
                                             float* scratch, unsigned* counters, int lane) {
  const int width = K + 1 + with_nll;
  const int n = pc.piece_count[p];
  if (n == 1) {
    store_row(out + (int64_t)row * width, v, count, nll, K, with_nll, lane);
    return;
  }
  store_row(scratch + (int64_t)(p - p0) * width, v, count, nll, K, with_nll, lane);
  merge_run(pc, p, p0, row, n, width, out, scratch, counters, lane);
}

// After piece p (local slot p - p0) of a run of n > 1 pieces has stored
// its partial row: if it is the run's last piece to arrive, add the run's
// partials in piece order into the row.
__device__ __forceinline__ void merge_run(const Pieces& pc, int p, int p0, int row, int n,
                                          int width, float* out, float* scratch,
                                          unsigned* counters, int lane) {
  __threadfence();  // this lane's partial is visible before the count moves
  __syncwarp();
  const int first = pc.piece_first[p] - p0;
  unsigned old = 0;
  if (lane == 0) old = atomicInc(counters + first, (unsigned)(n - 1));
  old = __shfl_sync(kFull, old, 0);
  if (old != (unsigned)(n - 1)) return;
  __threadfence();
  const float* part = scratch + (int64_t)first * width;
  float* dst = out + (int64_t)row * width;
  for (int c = lane; c < width; c += 32) {
    float s = __ldcg(part + c);
    for (int q = 1; q < n; ++q) s += __ldcg(part + (int64_t)q * width + c);
    dst[c] = s;
  }
}

// K <= 128: the runs form.  Warps [0, 8 ceil(n_long / 8)) take the long
// pieces p0 .. p0 + n_long, one a warp, their R groups each walking a
// contiguous share of the piece's edges; the later warps take the short
// runs p0 + n_long .. p0 + n_long + n_short, R a warp, one a group.
template <int G, int V>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
map_grad_runs_kernel(const float* __restrict__ self_tab,
                     const float* __restrict__ other_tab, Pieces pc, int p0, int n_long,
                     int n_short, int K, float lam_floor, int with_nll,
                     float* __restrict__ out, float* scratch, unsigned* counters) {
  constexpr int R = 32 / G;  // groups a warp
  constexpr int D = kRunInFlight;
  static_assert(G % D == 0 && G >= D && G <= 32, "a batch of G edges holds whole rounds");
  const int lane = threadIdx.x & 31;
  const int gl = lane & (G - 1);
  const int grp = lane / G;
  const int warp = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int long_warps = (n_long + kWarpsPerBlock - 1) / kWarpsPerBlock * kWarpsPerBlock;
  const bool is_long = warp < long_warps;  // block-uniform
  int p, n = 0, row = 0, len = 0;
  int64_t begin = 0;
  bool has_row;
  if (is_long) {
    if (warp >= n_long) return;  // whole warp leaves together
    p = p0 + warp;
    row = pc.piece_row[p];
    const int64_t b = pc.piece_ptr[p];
    n = (int)(pc.piece_ptr[p + 1] - b);
    const int share = (n + R - 1) / R;
    const int lo = min(grp * share, n);
    begin = b + lo;
    len = min(share, n - lo);
    has_row = true;
  } else {
    const int r0 = (warp - long_warps) * R;
    if (r0 >= n_short) return;  // whole warp leaves together
    p = p0 + n_long + r0 + grp;
    has_row = r0 + grp < n_short;
    if (has_row) {
      row = pc.piece_row[p];
      begin = pc.piece_ptr[p];
      len = (int)(pc.piece_ptr[p + 1] - begin);
    }
  }
  const int stride = K + 1;
  const float* srow = self_tab + (int64_t)row * stride;
  float es[V], acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int k = gl + G * v;
    es[v] = has_row && k < K ? __ldg(srow + k) : 0.f;
    acc[v] = 0.f;
  }
  float acc_nll = 0.f;  // the same on every lane of the group
  // The warp walks its longest share's batches of G edges together (the
  // runs of a warp are near equal in length); lane gl of a group holds
  // edge base + gl of its share, loaded one batch ahead.
  const int span = (int)__reduce_max_sync(kFull, (unsigned)len);
  int next_o = 0;
  float next_x = 0.f;
  if (gl < len) {
    next_o = __ldg(pc.other + begin + gl);
    next_x = __ldg(pc.x + begin + gl);
  }
  for (int base = 0; base < span; base += G) {
    const int my_o = next_o;
    const float my_x = next_x;
    if (base + G + gl < len) {
      next_o = __ldg(pc.other + begin + base + G + gl);
      next_x = __ldg(pc.x + begin + base + G + gl);
    }
    const int nb = min(G, span - base);  // warp-uniform
    for (int j = 0; j < nb; j += D) {
      float eo[D][V], xv[D];
      bool ok[D];
#pragma unroll
      for (int q = 0; q < D; ++q) {
        ok[q] = base + j + q < len;
        const int o = __shfl_sync(kFull, my_o, j + q, G);
        xv[q] = __shfl_sync(kFull, my_x, j + q, G);
        const float* orow = other_tab + (int64_t)o * stride;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const int k = gl + G * v;
          eo[q][v] = ok[q] && k < K ? __ldg(orow + k) : 0.f;
        }
      }
#pragma unroll
      for (int q = 0; q < D; ++q) {
        float part = es[0] * eo[q][0];
#pragma unroll
        for (int v = 1; v < V; ++v) part = fmaf(es[v], eo[q][v], part);
        const float dot = group_sum<G>(part);
        const float lam = fmaxf(dot, lam_floor);
        const float w = ok[q] && dot >= lam_floor ? 1.f - xv[q] / lam : 0.f;
#pragma unroll
        for (int v = 0; v < V; ++v) acc[v] = fmaf(w, eo[q][v], acc[v]);
        if (ok[q]) acc_nll += lam - xv[q] * logf(lam);
      }
    }
  }
  const int width = K + 1 + with_nll;
  if (!is_long) {
    if (has_row) {
      float* dst = out + (int64_t)row * width;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int k = gl + G * v;
        if (k < K) dst[k] = acc[v];
      }
      if (gl == 0) {
        dst[K] = (float)len;
        if (with_nll) dst[K + 1] = acc_nll;
      }
    }
    return;
  }
  // A long piece: the groups' shares meet (every lane ends with the total).
#pragma unroll
  for (int off = G; off < 32; off <<= 1) {
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] += __shfl_xor_sync(kFull, acc[v], off);
    acc_nll += __shfl_xor_sync(kFull, acc_nll, off);
  }
  const int n_run = pc.piece_count[p];
  float* dst = n_run == 1 ? out + (int64_t)row * width : scratch + (int64_t)(p - p0) * width;
  if (grp == 0) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int k = gl + G * v;
      if (k < K) dst[k] = acc[v];
    }
    if (gl == 0) {
      dst[K] = (float)n;
      if (with_nll) dst[K + 1] = acc_nll;
    }
  }
  if (n_run > 1) merge_run(pc, p, p0, row, n_run, width, out, scratch, counters, lane);
}

// 128 < K <= 256: lanes over factors, F = ceil(K / 32) a lane, a warp dot an
// edge.
template <int F>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
map_grad_wide_kernel(const float* __restrict__ self_tab,
                     const float* __restrict__ other_tab, Pieces pc, int step, int K,
                     float lam_floor, int with_nll, float* __restrict__ out,
                     float* scratch, unsigned* counters) {
  const int lane = threadIdx.x & 31;
  const int p0 = pc.step_off[step];
  const int p1 = pc.step_off[step + 1];
  const int stride = K + 1;
  for (int p = p0 + blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5); p < p1;
       p += gridDim.x * kWarpsPerBlock) {
    const int row = pc.piece_row[p];
    const float* srow = self_tab + (int64_t)row * stride;
    float es[F], acc[F];
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const int k = 32 * f + lane;
      es[f] = k < K ? __ldg(srow + k) : 0.f;
      acc[f] = 0.f;
    }
    float acc_nll = 0.f;  // the same on every lane
    auto gather = [&](int o, float (&eo)[F]) {
      const float* orow = other_tab + (int64_t)o * stride;
#pragma unroll
      for (int f = 0; f < F; ++f) {
        const int k = 32 * f + lane;
        eo[f] = k < K ? __ldg(orow + k) : 0.f;
      }
    };
    auto edge = [&](const float (&eo)[F], float xv) {
      float part = es[0] * eo[0];
#pragma unroll
      for (int f = 1; f < F; ++f) part = fmaf(es[f], eo[f], part);
      const float dot = warp_sum(part);
      const float lam = fmaxf(dot, lam_floor);
      const float w = dot >= lam_floor ? 1.f - xv / lam : 0.f;
#pragma unroll
      for (int f = 0; f < F; ++f) acc[f] = fmaf(w, eo[f], acc[f]);
      acc_nll += lam - xv * logf(lam);
    };
    const int64_t begin = pc.piece_ptr[p];
    const int64_t end = pc.piece_ptr[p + 1];
    for (int64_t base = begin; base < end; base += 32) {
      const int64_t left = end - base;
      const int n = left < 32 ? (int)left : 32;
      int my_o = 0;
      float my_x = 0.f;
      if (lane < n) {
        my_o = pc.other[base + lane];
        my_x = pc.x[base + lane];
      }
      int j = 0;
      for (; j + 4 <= n; j += 4) {
        float eo[4][F], xv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          xv[q] = __shfl_sync(kFull, my_x, j + q);
          gather(__shfl_sync(kFull, my_o, j + q), eo[q]);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) edge(eo[q], xv[q]);
      }
      for (; j < n; ++j) {
        const float xv = __shfl_sync(kFull, my_x, j);
        float eo[F];
        gather(__shfl_sync(kFull, my_o, j), eo);
        edge(eo, xv);
      }
    }
    finish_piece<F>(pc, p, p0, row, acc, (float)(end - begin), acc_nll, K, with_nll, out,
                    scratch, counters, lane);
  }
}

// K > 256: the sums of w * other in the row the piece stores (its output
// row, or its scratch partial for a run of several pieces), lanes over the
// factors in a loop, one edge at a time.
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
map_grad_general_kernel(const float* __restrict__ self_tab,
                        const float* __restrict__ other_tab, Pieces pc, int step, int K,
                        float lam_floor, int with_nll, float* out, float* scratch,
                        unsigned* counters) {
  const int lane = threadIdx.x & 31;
  const int p0 = pc.step_off[step];
  const int p1 = pc.step_off[step + 1];
  const int stride = K + 1;
  const int width = K + 1 + with_nll;
  for (int p = p0 + blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5); p < p1;
       p += gridDim.x * kWarpsPerBlock) {
    const int row = pc.piece_row[p];
    const int n_run = pc.piece_count[p];
    const float* srow = self_tab + (int64_t)row * stride;
    float* dst = n_run == 1 ? out + (int64_t)row * width : scratch + (int64_t)(p - p0) * width;
    for (int k = lane; k < K; k += 32) dst[k] = 0.f;
    float acc_nll = 0.f;  // the same on every lane
    const int64_t begin = pc.piece_ptr[p];
    const int64_t end = pc.piece_ptr[p + 1];
    for (int64_t base = begin; base < end; base += 32) {
      const int64_t left = end - base;
      const int n = left < 32 ? (int)left : 32;
      int my_o = 0;
      float my_x = 0.f;
      if (lane < n) {
        my_o = pc.other[base + lane];
        my_x = pc.x[base + lane];
      }
      for (int j = 0; j < n; ++j) {
        const float xv = __shfl_sync(kFull, my_x, j);
        const float* orow = other_tab + (int64_t)__shfl_sync(kFull, my_o, j) * stride;
        float part = 0.f;
        for (int k = lane; k < K; k += 32) part = fmaf(__ldg(srow + k), __ldg(orow + k), part);
        const float dot = warp_sum(part);
        const float lam = fmaxf(dot, lam_floor);
        const float w = dot >= lam_floor ? 1.f - xv / lam : 0.f;
        for (int k = lane; k < K; k += 32) dst[k] = fmaf(w, __ldg(orow + k), dst[k]);
        acc_nll += lam - xv * logf(lam);
      }
    }
    if (lane == 0) {
      dst[K] = (float)(end - begin);
      if (with_nll) dst[K + 1] = acc_nll;
    }
    if (n_run > 1) merge_run(pc, p, p0, row, n_run, width, out, scratch, counters, lane);
  }
}

}  // namespace

// K > 128, one direction of step `step`.  max_pieces: the most pieces any
// step of the layout holds (the grid gives each a warp); scratch:
// max_pieces rows of K + 1 + with_nll floats; counters: max_pieces zeros,
// left zero.  K <= 128 is pmf_map_grad_runs's.
extern "C" int pmf_map_grad(const float* self_tab, const float* other_tab,
                            const int32_t* step_off, int step, int max_pieces,
                            const int64_t* piece_ptr, const int32_t* piece_row,
                            const int32_t* piece_first, const int32_t* piece_count,
                            const int32_t* other, const float* x, int K,
                            float lam_floor, int with_nll, float* out, float* scratch,
                            unsigned* counters, void* stream) {
  if (K <= 128) return (int)cudaErrorInvalidValue;
  if (max_pieces > 0) {
    const int blocks = (max_pieces + kWarpsPerBlock - 1) / kWarpsPerBlock;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const Pieces pc{step_off, piece_ptr, piece_row, piece_first, piece_count, other, x};
#define PMF_MAP_GRAD_LAUNCH(KERNEL)                                           \
  KERNEL<<<blocks, kWarpsPerBlock * 32, 0, st>>>(self_tab, other_tab, pc, step, K, \
                                                  lam_floor, with_nll, out, scratch, \
                                                  counters)
    if (K <= 160) PMF_MAP_GRAD_LAUNCH(map_grad_wide_kernel<5>);
    else if (K <= 192) PMF_MAP_GRAD_LAUNCH(map_grad_wide_kernel<6>);
    else if (K <= 224) PMF_MAP_GRAD_LAUNCH(map_grad_wide_kernel<7>);
    else if (K <= 32 * kWideMaxF) PMF_MAP_GRAD_LAUNCH(map_grad_wide_kernel<kWideMaxF>);
    else PMF_MAP_GRAD_LAUNCH(map_grad_general_kernel);
#undef PMF_MAP_GRAD_LAUNCH
  }
  return (int)cudaGetLastError();
}

// K <= 128, one direction of one step: its pieces start at p0, the n_long
// pieces of its long runs first, then its n_short short runs (one piece
// each; ops/map_grad.py::group_steps).  scratch: n_long rows of K + 1 +
// with_nll floats at least; counters: as many zeros, left zero.
extern "C" int pmf_map_grad_runs(const float* self_tab, const float* other_tab, int p0,
                                 int n_long, int n_short, const int64_t* piece_ptr,
                                 const int32_t* piece_row, const int32_t* piece_first,
                                 const int32_t* piece_count, const int32_t* other,
                                 const float* x, int K, float lam_floor, int with_nll,
                                 float* out, float* scratch, unsigned* counters,
                                 void* stream) {
  if (K < 1 || K > 128 || n_long < 0 || n_short < 0) return (int)cudaErrorInvalidValue;
  if (n_long + n_short > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const Pieces pc{nullptr, piece_ptr, piece_row, piece_first, piece_count, other, x};
    const int long_blocks = (n_long + kWarpsPerBlock - 1) / kWarpsPerBlock;
#define PMF_MAP_GRAD_RUNS(G, V)                                                        \
  map_grad_runs_kernel<G, V>                                                           \
      <<<long_blocks + (n_short + kWarpsPerBlock * (32 / G) - 1) /                     \
                           (kWarpsPerBlock * (32 / G)),                                \
         kWarpsPerBlock * 32, 0, st>>>(self_tab, other_tab, pc, p0, n_long, n_short, K, \
                                       lam_floor, with_nll, out, scratch, counters)
    if (K <= 8) PMF_MAP_GRAD_RUNS(4, 2);
    else if (K <= 16) PMF_MAP_GRAD_RUNS(4, 4);
    else if (K <= 24) PMF_MAP_GRAD_RUNS(4, 6);
    else if (K <= 32) PMF_MAP_GRAD_RUNS(4, 8);
    else if (K <= 48) PMF_MAP_GRAD_RUNS(8, 6);
    else if (K <= 64) PMF_MAP_GRAD_RUNS(8, 8);
    else if (K <= 96) PMF_MAP_GRAD_RUNS(16, 6);
    else PMF_MAP_GRAD_RUNS(16, 8);
#undef PMF_MAP_GRAD_RUNS
  }
  return (int)cudaGetLastError();
}
