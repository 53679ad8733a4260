// K9 — HPF-MAP minibatch gradients of the Poisson NLL, one direction of
// one batch segment per launch.
//
// Replaces: pmf_tpu/ops/pallas/map_grad.py::_kernel.
//
// A segment is a few thousand edges of the tile-major edge order, stored
// once per direction as a small CSR over the self rows that occur in it
// (rows[r] = the table row of run r, row_ptr[r]..row_ptr[r+1] its edges).
// With the softplus'd tables [theta | xi] and [beta | eta] (K+1 columns,
// row stride K+1, the last column not part of the dot), per edge:
//   lam = max(<self, other>, floor)
//   w   = 1 - x / lam        (0 where the dot fell below the floor)
//   nll = lam - x log lam
// and per run r, ADDED into the dense accumulator row rows[r]:
//   out[row, 0:K] += sum_e w * other[o_e]
//   out[row, K]   += number of edges
//   out[row, K+1] += sum_e nll                  (with_nll: user direction)
// The user direction runs with (self, other) = (users, items) and row
// width K+2, the item direction with the tables swapped and width K+1.
// lam is computed in both directions: that doubles a dot and saves every
// atomic.
//
// What bounds it on an H100: memory and latency, not arithmetic.  Per edge
// it streams an 8-byte (other id, rating) pair from HBM and gathers one
// (K+1)-float row of the other table; both tables (under 19 MB at
// 162k + 59k rows of 21 floats) stay in the 50 MB L2.  Per run it reads
// 12 bytes of row list and read-modify-writes one accumulator row.  The
// arithmetic (~4K flops per edge) is far below the FP32 line.  A segment
// holds only some hundreds to thousands of runs, so one launch cannot
// fill the card, and its time is that of its LONGEST run: in the dense
// corner of a Zipf-shaped rating matrix one row holds hundreds to over a
// thousand of a segment's 8192 edges.
//
// Design: one warp per run, one LANE PER EDGE.  Each lane takes every 32nd
// edge of the run, gathers that edge's other row into registers (K
// independent loads in flight), and computes its dot, lam, w and nll
// privately: no shuffle, divide or logarithm is repeated across lanes,
// and a long run advances 32 edges per iteration.  Each lane keeps K
// partial sums of w * other in registers; the run's self row is read once
// (a broadcast load).  At the end of the run the warp folds the K partial
// sums across its lanes by a reduce-scatter (31 shuffles: at each level a
// lane keeps one half of its values and hands the other half to its
// partner), which leaves factor k's total in lane k; lane 0 writes the
// count (the run length) and the butterfly-reduced nll.  K is a run-time
// argument, so the register arrays are sized by a template bound KMAX
// (8, 16, 24 or 32) and the loops are unrolled with a k < K guard.
// Every sum is taken in a fixed order (a lane's edges in order, then the
// fixed tree).  Within one segment and direction every row occurs in one
// run only, and launches on one stream run in order, so the
// read-modify-write needs no atomic and the result is deterministic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

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

template <int KMAX>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
map_grad_kernel(const float* __restrict__ self_tab,
                const float* __restrict__ other_tab,
                const int32_t* __restrict__ rows,
                const int64_t* __restrict__ row_ptr,
                const int32_t* __restrict__ other,
                const float* __restrict__ x,
                int n_rows, int K, float lam_floor, int with_nll,
                float* out) {
  const int lane = threadIdx.x & 31;
  const int run = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (run >= n_rows) return;  // whole warp leaves together
  const int stride = K + 1;
  const int64_t row = rows[run];
  const float* srow = self_tab + row * stride;
  float es[KMAX], acc[KMAX];
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    es[k] = k < K ? __ldg(srow + k) : 0.f;
    acc[k] = 0.f;
  }
  float acc_nll = 0.f;
  const int64_t begin = row_ptr[run];
  const int64_t end = row_ptr[run + 1];
  for (int64_t e = begin + lane; e < end; e += 32) {
    const float* orow = other_tab + (int64_t)other[e] * stride;
    const float xv = x[e];
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
  const float total = warp_reduce_scatter(v, lane);
  acc_nll = warp_sum(acc_nll);
  float* dst = out + row * (stride + (with_nll ? 1 : 0));
  if (lane < K) dst[lane] += total;
  if (lane == 0) {
    dst[K] += (float)(end - begin);
    if (with_nll) dst[K + 1] += acc_nll;
  }
}

}  // namespace

extern "C" int pmf_map_grad(const float* self_tab, const float* other_tab,
                            const int32_t* rows, const int64_t* row_ptr,
                            const int32_t* other, const float* x, int n_rows,
                            int K, float lam_floor, int with_nll, float* out,
                            void* stream) {
  if (n_rows > 0) {
    const int blocks = (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PMF_MAP_GRAD_LAUNCH(KMAX)                                            \
  map_grad_kernel<KMAX><<<blocks, kWarpsPerBlock * 32, 0, st>>>(             \
      self_tab, other_tab, rows, row_ptr, other, x, n_rows, K, lam_floor,    \
      with_nll, out)
    if (K <= 8) PMF_MAP_GRAD_LAUNCH(8);
    else if (K <= 16) PMF_MAP_GRAD_LAUNCH(16);
    else if (K <= 24) PMF_MAP_GRAD_LAUNCH(24);
    else PMF_MAP_GRAD_LAUNCH(32);
#undef PMF_MAP_GRAD_LAUNCH
  }
  return (int)cudaGetLastError();
}
