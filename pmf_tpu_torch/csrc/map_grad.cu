// K9 — HPF-MAP minibatch gradients of the Poisson NLL, one launch a
// direction an Adam step.
//
// Replaces: pmf_tpu/ops/pallas/map_grad.py::_kernel.
//
// Layout (ops/map_grad.py::group_steps, rebuilt on the card once an epoch
// from the epoch's segment order): one direction's edges sorted by (step,
// self row), so that a row's edges inside one step form one run, and every
// run cut into pieces of at most PIECE edges.  Piece p holds the edges
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
// (K+1)-float row of the other table; both tables (under 19 MB at
// 162k + 59k rows of 21 floats) stay in the 50 MB L2.  Per piece it reads
// 20 bytes of piece list and writes one accumulator row (or one partial
// row and, for the last piece of a run, reads the run's partials).  The
// arithmetic (~4K flops per edge) is far below the FP32 line.
//
// Design: one launch covers a whole step (65,536 edges at batch_size
// 65536), enough pieces to fill 132 SMs, and no piece holds more than
// PIECE edges, so no warp walks a run of a thousand edges while the card
// waits.  One warp a piece.
//  * K <= 32: one LANE PER EDGE.  Each lane takes every 32nd edge of the
//    piece, gathers that edge's other row into registers (K independent
//    loads in flight), and computes its dot, lam, w and nll privately.
//    Each lane keeps K partial sums of w * other; the piece's self row is
//    read once (a broadcast load).  At the end the warp folds the K
//    partial sums across its lanes by a reduce-scatter (31 shuffles),
//    which leaves factor k's total in lane k.  The register arrays are
//    sized by a template bound KMAX (8, 16, 24 or 32).
//  * 32 < K <= 256: lanes over factors, F = ceil(K / 32) a lane (an
//    instance for each F up to 8), a warp dot an edge (one __shfl_xor_sync
//    butterfly), four edges in flight, as K1.
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Sum v[0..31] across the warp's lanes; lane l returns the total of v[l].
// Level `half`: a lane whose bit `half` is set keeps the upper half of its
// remaining values, the others the lower half, and each adds its
// partner's copy of the half it keeps.
__device__ __forceinline__ float warp_reduce_scatter(float (&v)[32], int lane) {
#pragma unroll
  for (int half = 16; half >= 1; half >>= 1) {
    const bool upper = (lane & half) != 0;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float send = upper ? v[i] : v[i + half];
      const float keep = upper ? v[i + half] : v[i];
      v[i] = keep + __shfl_xor_sync(kFull, send, half);
    }
  }
  return v[0];
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

// K <= 32: one lane per edge.
template <int KMAX>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
map_grad_kernel(const float* __restrict__ self_tab, const float* __restrict__ other_tab,
                Pieces pc, int step, int K, float lam_floor, int with_nll,
                float* __restrict__ out, float* scratch, unsigned* counters) {
  const int lane = threadIdx.x & 31;
  const int p0 = pc.step_off[step];
  const int p1 = pc.step_off[step + 1];
  const int stride = K + 1;
  for (int p = p0 + blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5); p < p1;
       p += gridDim.x * kWarpsPerBlock) {
    const int row = pc.piece_row[p];
    const float* srow = self_tab + (int64_t)row * stride;
    float es[KMAX], acc[KMAX];
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      es[k] = k < K ? __ldg(srow + k) : 0.f;
      acc[k] = 0.f;
    }
    float acc_nll = 0.f;
    const int64_t begin = pc.piece_ptr[p];
    const int64_t end = pc.piece_ptr[p + 1];
    for (int64_t e = begin + lane; e < end; e += 32) {
      const float* orow = other_tab + (int64_t)pc.other[e] * stride;
      const float xv = pc.x[e];
      float eo[KMAX];
#pragma unroll
      for (int k = 0; k < KMAX; ++k) eo[k] = k < K ? __ldg(orow + k) : 0.f;
      float dot = 0.f;
#pragma unroll
      for (int k = 0; k < KMAX; ++k) dot = fmaf(es[k], eo[k], dot);
      const float lam = fmaxf(dot, lam_floor);
      const float w = dot >= lam_floor ? 1.f - xv / lam : 0.f;
#pragma unroll
      for (int k = 0; k < KMAX; ++k) acc[k] = fmaf(w, eo[k], acc[k]);
      acc_nll += lam - xv * logf(lam);
    }
    __syncwarp();
    float v[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) v[k] = k < KMAX ? acc[k] : 0.f;
    const float total[1] = {warp_reduce_scatter(v, lane)};
    acc_nll = warp_sum(acc_nll);
    finish_piece<1>(pc, p, p0, row, total, (float)(end - begin), acc_nll, K, with_nll,
                    out, scratch, counters, lane);
  }
}

// K > 32: lanes over factors, F = ceil(K / 32) a lane, a warp dot an edge.
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

// One direction of step `step`.  max_pieces: the most pieces any step of
// the layout holds (the grid gives each a warp); scratch: max_pieces rows
// of K + 1 + with_nll floats; counters: max_pieces zeros, left zero.
extern "C" int pmf_map_grad(const float* self_tab, const float* other_tab,
                            const int32_t* step_off, int step, int max_pieces,
                            const int64_t* piece_ptr, const int32_t* piece_row,
                            const int32_t* piece_first, const int32_t* piece_count,
                            const int32_t* other, const float* x, int K,
                            float lam_floor, int with_nll, float* out, float* scratch,
                            unsigned* counters, void* stream) {
  if (K < 1) return (int)cudaErrorInvalidValue;
  if (max_pieces > 0) {
    const int blocks = (max_pieces + kWarpsPerBlock - 1) / kWarpsPerBlock;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const Pieces pc{step_off, piece_ptr, piece_row, piece_first, piece_count, other, x};
#define PMF_MAP_GRAD_LAUNCH(KERNEL)                                           \
  KERNEL<<<blocks, kWarpsPerBlock * 32, 0, st>>>(self_tab, other_tab, pc, step, K, \
                                                  lam_floor, with_nll, out, scratch, \
                                                  counters)
    if (K <= 8) PMF_MAP_GRAD_LAUNCH(map_grad_kernel<8>);
    else if (K <= 16) PMF_MAP_GRAD_LAUNCH(map_grad_kernel<16>);
    else if (K <= 24) PMF_MAP_GRAD_LAUNCH(map_grad_kernel<24>);
    else if (K <= 32) PMF_MAP_GRAD_LAUNCH(map_grad_kernel<32>);
    else if (K <= 64) PMF_MAP_GRAD_LAUNCH(map_grad_wide_kernel<2>);
    else if (K <= 96) PMF_MAP_GRAD_LAUNCH(map_grad_wide_kernel<3>);
    else if (K <= 128) PMF_MAP_GRAD_LAUNCH(map_grad_wide_kernel<4>);
    else if (K <= 160) PMF_MAP_GRAD_LAUNCH(map_grad_wide_kernel<5>);
    else if (K <= 192) PMF_MAP_GRAD_LAUNCH(map_grad_wide_kernel<6>);
    else if (K <= 224) PMF_MAP_GRAD_LAUNCH(map_grad_wide_kernel<7>);
    else if (K <= 32 * kWideMaxF) PMF_MAP_GRAD_LAUNCH(map_grad_wide_kernel<kWideMaxF>);
    else PMF_MAP_GRAD_LAUNCH(map_grad_general_kernel);
#undef PMF_MAP_GRAD_LAUNCH
  }
  return (int)cudaGetLastError();
}
