// K2 — dense-head tier of the hybrid HPF/Poisson CAVI pass.
//
// Replaces: pmf_tpu/ops/dense_head.py::_fused_kernel (launched by
// fused_alloc_tier).
//
// One tier holds new-space user rows x the top hip item columns as dense
// cell planes: X = x_hi (+ x_lo), both bf16, and multiplicity M (bf16 or
// f32).  With theta (rows, K) and beta (hip, K, zero past the real
// columns):
//   R = theta beta^T,  W = where(M > 0, X / max(R, floor), 0)
//   user side: out (rows, 2K) = [W beta | M beta]
//   item side: out (hip, 2K)  = [W^T theta | M^T theta]
// The caller multiplies the first half by its self factor.  W never
// reaches device memory.
//
// What bounds it on an H100: arithmetic.  Each cell costs ~6K + 2 flops
// (the K-long rate dot, then two K-wide accumulations) against 4 bytes of
// cell planes (6 with x_lo): at K = 20 that is ~30 flops per byte, above
// the FP32 CUDA-core balance point of 67 TFLOP/s / 3.35 TB/s = 20.
//
// Design (simple, CUDA cores, no tensor cores yet):
//  * user side: a CTA owns 64 rows and a range of 32-column tiles.  Each
//    thread keeps one row's theta and its 2K sums in registers and
//    handles 8 consecutive columns of a tile, read as one 16-byte load
//    per plane; a quarter warp is 8 rows at one column group, so a warp
//    reads 64 contiguous bytes of 8 rows.  The beta tile sits in shared
//    memory and a quarter warp reads the same row of it (broadcast).
//    The 4 column groups of a row are summed with shuffles at the end.
//  * item side: a CTA owns 64 columns and a range of rows.  Each lane
//    keeps its 2 columns' beta and 2K sums in registers; a warp reads one
//    row's 64 cells as 128 contiguous bytes, with that row's theta read
//    from shared memory by every lane (broadcast).  The CTA's 4 warps
//    take interleaved rows and are summed through shared memory.
//  * Tiers that would leave the card idle (few row tiles on the user
//    side, few column tiles on the item side) split the reduction axis
//    over more CTAs; each split writes its own partial rows and a second
//    kernel sums them.  No atomics, so the result is deterministic.
// Tensor cores (mma/wgmma for R and the two products) and TMA staging are
// later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// User side geometry (kept in step with ops/dense_head.py).
constexpr int kUserRows = 64;     // rows per CTA
constexpr int kUserCols = 32;     // columns per tile
constexpr int kUserThreads = 256;
// Item side geometry.
constexpr int kItemCols = 64;     // columns per CTA
constexpr int kItemRowBatch = 32; // theta rows staged per batch
constexpr int kItemThreads = 128;
constexpr int kItemWarps = kItemThreads / 32;

__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

__device__ __forceinline__ void unpack8(const uint4 v, float* f) {
  f[0] = bf16_lo(v.x); f[1] = bf16_hi(v.x);
  f[2] = bf16_lo(v.y); f[3] = bf16_hi(v.y);
  f[4] = bf16_lo(v.z); f[5] = bf16_hi(v.z);
  f[6] = bf16_lo(v.w); f[7] = bf16_hi(v.w);
}

template <int KP, bool M_F32>
__global__ void __launch_bounds__(kUserThreads)
head_user_kernel(const float* __restrict__ theta, const float* __restrict__ beta,
                 const uint16_t* __restrict__ x_hi, const uint16_t* __restrict__ x_lo,
                 const void* __restrict__ m_ptr, int rows, int hip, int K,
                 float rate_floor, int tiles_per_split, float* __restrict__ dst) {
  __shared__ __align__(16) float bs[kUserCols][KP];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int cg = lane >> 3;  // column group: 8 columns each
  const int row = blockIdx.x * kUserRows + warp * 8 + (lane & 7);
  const bool row_ok = row < rows;

  float th[KP], acc_a[KP], acc_o[KP];
#pragma unroll
  for (int k = 0; k < KP; ++k) {
    th[k] = (row_ok && k < K) ? theta[(int64_t)row * K + k] : 0.f;
    acc_a[k] = 0.f;
    acc_o[k] = 0.f;
  }
  const int n_tiles = hip / kUserCols;
  const int t0 = blockIdx.y * tiles_per_split;
  const int t1 = min(t0 + tiles_per_split, n_tiles);
  for (int t = t0; t < t1; ++t) {
    const int c0 = t * kUserCols;
    __syncthreads();
    for (int e = tid; e < kUserCols * KP; e += kUserThreads) {
      const int c = e / KP, k = e % KP;
      bs[c][k] = k < K ? beta[(int64_t)(c0 + c) * K + k] : 0.f;
    }
    __syncthreads();
    float xv[8], mv[8];
    if (row_ok) {
      const int64_t off = (int64_t)row * hip + c0 + cg * 8;
      unpack8(*reinterpret_cast<const uint4*>(x_hi + off), xv);
      if (x_lo != nullptr) {
        float lo[8];
        unpack8(*reinterpret_cast<const uint4*>(x_lo + off), lo);
#pragma unroll
        for (int j = 0; j < 8; ++j) xv[j] += lo[j];
      }
      if (M_F32) {
        const float4* mp = reinterpret_cast<const float4*>(
            static_cast<const float*>(m_ptr) + off);
        const float4 a = mp[0], b = mp[1];
        mv[0] = a.x; mv[1] = a.y; mv[2] = a.z; mv[3] = a.w;
        mv[4] = b.x; mv[5] = b.y; mv[6] = b.z; mv[7] = b.w;
      } else {
        unpack8(*reinterpret_cast<const uint4*>(
                    static_cast<const uint16_t*>(m_ptr) + off), mv);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) { xv[j] = 0.f; mv[j] = 0.f; }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4* brow = reinterpret_cast<const float4*>(&bs[cg * 8 + j][0]);
      float b[KP];
#pragma unroll
      for (int k4 = 0; k4 < KP / 4; ++k4) {
        const float4 v = brow[k4];
        b[4 * k4] = v.x; b[4 * k4 + 1] = v.y; b[4 * k4 + 2] = v.z; b[4 * k4 + 3] = v.w;
      }
      float r = 0.f;
#pragma unroll
      for (int k = 0; k < KP; ++k) r = fmaf(th[k], b[k], r);
      const float w = mv[j] > 0.f ? xv[j] / fmaxf(r, rate_floor) : 0.f;
#pragma unroll
      for (int k = 0; k < KP; ++k) {
        acc_a[k] = fmaf(w, b[k], acc_a[k]);
        acc_o[k] = fmaf(mv[j], b[k], acc_o[k]);
      }
    }
  }
  // Sum the 4 column groups of each row (lane bits 3 and 4).
#pragma unroll
  for (int k = 0; k < KP; ++k) {
    acc_a[k] += __shfl_xor_sync(kFull, acc_a[k], 8);
    acc_a[k] += __shfl_xor_sync(kFull, acc_a[k], 16);
    acc_o[k] += __shfl_xor_sync(kFull, acc_o[k], 8);
    acc_o[k] += __shfl_xor_sync(kFull, acc_o[k], 16);
  }
  if (cg == 0 && row_ok) {
    float* out = dst + ((int64_t)blockIdx.y * rows + row) * 2 * K;
#pragma unroll
    for (int k = 0; k < KP; ++k) {
      if (k < K) {
        out[k] = acc_a[k];
        out[K + k] = acc_o[k];
      }
    }
  }
}

template <int KP, bool M_F32>
__global__ void __launch_bounds__(kItemThreads)
head_item_kernel(const float* __restrict__ theta, const float* __restrict__ beta,
                 const uint16_t* __restrict__ x_hi, const uint16_t* __restrict__ x_lo,
                 const void* __restrict__ m_ptr, int rows, int hip, int K,
                 float rate_floor, int batches_per_split, float* __restrict__ dst) {
  __shared__ __align__(16) float ts[kItemRowBatch][KP];
  __shared__ float red[kItemCols][2 * KP];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int c0 = blockIdx.x * kItemCols;
  const int c = c0 + 2 * lane;  // this lane's two columns: c, c + 1

  float b0[KP], b1[KP], a0[KP], o0[KP], a1[KP], o1[KP];
#pragma unroll
  for (int k = 0; k < KP; ++k) {
    b0[k] = k < K ? beta[(int64_t)c * K + k] : 0.f;
    b1[k] = k < K ? beta[(int64_t)(c + 1) * K + k] : 0.f;
    a0[k] = o0[k] = a1[k] = o1[k] = 0.f;
  }
  const int n_batches = (rows + kItemRowBatch - 1) / kItemRowBatch;
  const int bt0 = blockIdx.y * batches_per_split;
  const int bt1 = min(bt0 + batches_per_split, n_batches);
  for (int bt = bt0; bt < bt1; ++bt) {
    const int r0 = bt * kItemRowBatch;
    __syncthreads();
    for (int e = tid; e < kItemRowBatch * KP; e += kItemThreads) {
      const int r = e / KP, k = e % KP;
      ts[r][k] = (r0 + r < rows && k < K) ? theta[(int64_t)(r0 + r) * K + k] : 0.f;
    }
    __syncthreads();
    const int nr = min(kItemRowBatch, rows - r0);
    for (int r = warp; r < nr; r += kItemWarps) {
      const int64_t off = (int64_t)(r0 + r) * hip + c;
      const uint32_t xh = *reinterpret_cast<const uint32_t*>(x_hi + off);
      float x0 = bf16_lo(xh), x1 = bf16_hi(xh);
      if (x_lo != nullptr) {
        const uint32_t xl = *reinterpret_cast<const uint32_t*>(x_lo + off);
        x0 += bf16_lo(xl);
        x1 += bf16_hi(xl);
      }
      float m0, m1;
      if (M_F32) {
        const float2 mm = *reinterpret_cast<const float2*>(
            static_cast<const float*>(m_ptr) + off);
        m0 = mm.x; m1 = mm.y;
      } else {
        const uint32_t mm = *reinterpret_cast<const uint32_t*>(
            static_cast<const uint16_t*>(m_ptr) + off);
        m0 = bf16_lo(mm); m1 = bf16_hi(mm);
      }
      float t[KP];
      const float4* trow = reinterpret_cast<const float4*>(&ts[r][0]);
#pragma unroll
      for (int k4 = 0; k4 < KP / 4; ++k4) {
        const float4 v = trow[k4];
        t[4 * k4] = v.x; t[4 * k4 + 1] = v.y; t[4 * k4 + 2] = v.z; t[4 * k4 + 3] = v.w;
      }
      float r0v = 0.f, r1v = 0.f;
#pragma unroll
      for (int k = 0; k < KP; ++k) {
        r0v = fmaf(t[k], b0[k], r0v);
        r1v = fmaf(t[k], b1[k], r1v);
      }
      const float w0 = m0 > 0.f ? x0 / fmaxf(r0v, rate_floor) : 0.f;
      const float w1 = m1 > 0.f ? x1 / fmaxf(r1v, rate_floor) : 0.f;
#pragma unroll
      for (int k = 0; k < KP; ++k) {
        a0[k] = fmaf(w0, t[k], a0[k]);
        o0[k] = fmaf(m0, t[k], o0[k]);
        a1[k] = fmaf(w1, t[k], a1[k]);
        o1[k] = fmaf(m1, t[k], o1[k]);
      }
    }
  }
  // Sum the warps' partial columns through shared memory, one warp at a time.
  for (int w = 0; w < kItemWarps; ++w) {
    __syncthreads();
    if (warp == w) {
      const int cl = 2 * lane;
#pragma unroll
      for (int k = 0; k < KP; ++k) {
        const bool first = w == 0;
        red[cl][k] = (first ? 0.f : red[cl][k]) + a0[k];
        red[cl][KP + k] = (first ? 0.f : red[cl][KP + k]) + o0[k];
        red[cl + 1][k] = (first ? 0.f : red[cl + 1][k]) + a1[k];
        red[cl + 1][KP + k] = (first ? 0.f : red[cl + 1][KP + k]) + o1[k];
      }
    }
  }
  __syncthreads();
  float* out = dst + ((int64_t)blockIdx.y * hip + c0) * 2 * K;
  for (int e = tid; e < kItemCols * 2 * K; e += kItemThreads) {
    const int cl = e / (2 * K), j = e % (2 * K);
    out[e] = red[cl][j < K ? j : KP + (j - K)];
  }
}

__global__ void sum_partials_kernel(const float* __restrict__ partial, int n_splits,
                                    int64_t n, float* __restrict__ out) {
  for (int64_t idx = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; idx < n;
       idx += (int64_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < n_splits; ++p) s += partial[p * n + idx];
    out[idx] = s;
  }
}

template <int KP, bool M_F32>
void launch(const float* theta, const float* beta, const uint16_t* x_hi,
            const uint16_t* x_lo, const void* m, int rows, int hip, int K,
            float floor, int item_side, int n_splits, float* dst,
            cudaStream_t stream) {
  if (item_side) {
    const int n_batches = (rows + kItemRowBatch - 1) / kItemRowBatch;
    const int per = (n_batches + n_splits - 1) / n_splits;
    dim3 grid(hip / kItemCols, n_splits);
    head_item_kernel<KP, M_F32><<<grid, kItemThreads, 0, stream>>>(
        theta, beta, x_hi, x_lo, m, rows, hip, K, floor, per, dst);
  } else {
    const int n_tiles = hip / kUserCols;
    const int per = (n_tiles + n_splits - 1) / n_splits;
    dim3 grid((rows + kUserRows - 1) / kUserRows, n_splits);
    head_user_kernel<KP, M_F32><<<grid, kUserThreads, 0, stream>>>(
        theta, beta, x_hi, x_lo, m, rows, hip, K, floor, per, dst);
  }
}

template <int KP>
void launch_m(int m_is_f32, const float* theta, const float* beta,
              const uint16_t* x_hi, const uint16_t* x_lo, const void* m, int rows,
              int hip, int K, float floor, int item_side, int n_splits, float* dst,
              cudaStream_t stream) {
  if (m_is_f32)
    launch<KP, true>(theta, beta, x_hi, x_lo, m, rows, hip, K, floor, item_side,
                     n_splits, dst, stream);
  else
    launch<KP, false>(theta, beta, x_hi, x_lo, m, rows, hip, K, floor, item_side,
                      n_splits, dst, stream);
}

}  // namespace

// theta (rows, K) f32, beta (hip, K) f32, x_hi/x_lo (rows, hip) bf16 bits
// (x_lo may be null), m (rows, hip) bf16 or f32.  hip % 64 == 0, K <= 32.
// n_splits > 1 needs partial (n_splits * out_rows * 2K floats).
extern "C" int pmf_dense_head_tier(const float* theta, const float* beta,
                                   const void* x_hi, const void* x_lo,
                                   const void* m, int m_is_f32, int rows,
                                   int hip, int K, float rate_floor,
                                   int item_side, int n_splits, float* partial,
                                   float* out, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const uint16_t* xh = static_cast<const uint16_t*>(x_hi);
  const uint16_t* xl = static_cast<const uint16_t*>(x_lo);
  float* dst = n_splits > 1 ? partial : out;
  const int KP = (K + 3) / 4 * 4;
  switch (KP) {
#define PMF_CASE(N)                                                            \
  case N:                                                                      \
    launch_m<N>(m_is_f32, theta, beta, xh, xl, m, rows, hip, K, rate_floor,    \
                item_side, n_splits, dst, stream);                             \
    break;
    PMF_CASE(4) PMF_CASE(8) PMF_CASE(12) PMF_CASE(16)
    PMF_CASE(20) PMF_CASE(24) PMF_CASE(28) PMF_CASE(32)
#undef PMF_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_splits <= 1) return (int)err;
  const int64_t n = (int64_t)(item_side ? hip : rows) * 2 * K;
  const int threads = 256;
  const int64_t want = (n + threads - 1) / threads;
  const int blocks = want < 4096 ? (int)want : 4096;
  sum_partials_kernel<<<blocks, threads, 0, stream>>>(partial, n_splits, n, out);
  return (int)cudaGetLastError();
}
