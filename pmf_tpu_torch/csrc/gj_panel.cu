// K4's panel form (K >= 240): the batched Gauss-Jordan inverse of
// gj_inverse.cu with one CTA a matrix held in global memory.
//
// Replaces (with gj_inverse.cu): pmf_tpu/ops/pallas/gj_inverse.py::_gj_kernel.
//
// What bounds it.  Past the CTA form an SM's registers and shared memory
// no longer hold a matrix, so it lives in the output, and the pivots go in
// panels of b (gj_inverse.cu's panel_plan): the matrix passes through the
// SM K / b times, not K times, 8 K^2 bytes a panel for 2 b K^2 flops, b / 4
// flops a byte.  The H100's FP32 line is 67 TFLOP/s over 3.35 TB/s, 20
// flops a byte, so b = 80 would make the FP32 pipe the bound.  But the
// strips carry b values a thread through b pivots (b^2 work an item,
// unrolled), and every b past 32 timed on the card ran slower, with or
// without spills (PERF.md): so b <= 32 (8 flops a byte), and memory
// bounds the passes once a matrix's passes leave the 50 MB L2 (K >= 384).

// Design.  For the panel's pivots p0 .. p0 + nb - 1:
//   1. the nb x nb pivot block is eliminated alone in shared memory (its
//      entries' updates take only its own entries), in two buffers so
//      that one barrier a pivot suffices: the threads that update the
//      next pivot's row and column publish them as they go, each taking
//      the next pivot from the same operands as its owner.  Each pivot's
//      row r_k (at the panel's columns) and column c^(k) (at the panel's
//      rows, before the pivot) are kept;
//   2. the strips: each other column of the panel's rows, and each other
//      row of the panel's columns, is one thread's nb values in
//      registers, taken through the nb pivots in order (the row strip
//      divides by each pivot, the column strip keeps each multiplier and
//      zeroes the pivot's column), writing r_k and c^(k) at that column or
//      row into shared memory and its final values out;
//   3. the rest: every other entry once, in register tiles of 8 x 4 over
//      blocks of 128 x 64, through the nb pivots in order from r_k and
//      c^(k) in shared memory, a[i][j] = a[i][j] - c_i^(k) r_k[j].
// Each entry sees the operations of the unblocked in-place elimination in
// pivot order, the division as the IEEE quotient (FastDiv where it is
// exact), so the output is the plain form's, bit for bit where the
// compiler contracts alike.  Where even b = 8 leaves no room for the
// strips' rows in shared memory, they go to global scratch.  FP32
// throughout, no tensor cores.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gj_tile.cuh"

namespace {

// Keep in step with gj_inverse.cu's host plan (kPanelMaxB, kPanelCtas) and
// ops/gj_inverse.py (PANEL_THREADS, PANEL_MAX_B, PANEL_CTAS).
constexpr int kThreads = 256;
constexpr int kMaxB = 32;  // pivots a panel at most: a strip's values in registers
constexpr int kCtas = 2;   // the launch bound: 128 registers a thread

// x / piv rounded as the IEEE division: FastDiv where both lie in its
// exact range (fast_div_ok), else the division itself.
__device__ __forceinline__ float panel_div(float x, float piv, const FastDiv& d) {
  return fast_div_ok(x) && fast_div_ok(piv) ? d(x) : x / piv;
}

// One CTA a matrix: pivots in panels of b; S the strips' row stride;
// `vec`: K % 4 == 0 and both tables 16-byte aligned, so rows move in
// float4s.  GP: the strips' rows in global scratch.  Entries of the
// output that one thread stores reach the others at __syncthreads, so it
// is read without __restrict__ (no read-only path).
template <bool GP>
__global__ void __launch_bounds__(kThreads, kCtas)
gj_inverse_panel_kernel(const float* mats, int K, int b, int S, int vec, float* out,
                        float* scratch) {
  extern __shared__ __align__(16) float sm[];
  constexpr int B = kMaxB;
  static_assert(B % 8 == 0 && B * B % kThreads == 0, "the pivot block's entries a thread");
  const int t = threadIdx.x;
  const int64_t kk = (int64_t)K * K;
  float* g = out + blockIdx.x * kk;
  const int b4 = (b + 3) & ~3;
  float* Db = sm;             // 2 x b x b4: the pivot block, before and after each pivot
  float* rD = Db + 2 * b * b4;  // row k: r_k at the panel's columns (after pivot k)
  float* cD = rD + b * b4;    // row k: column k at the panel's rows, before pivot k
  float* pv = cD + b * b4;    // the pivots
  float* Rs = GP ? scratch + blockIdx.x * 2 * (int64_t)b * S : pv + b4;  // r_k, other columns
  float* Cs = Rs + (int64_t)b * S;  // c^(k) at the other rows
  const int ty = t >> 4, tx = t & 15;

  for (int p0 = 0; p0 < K; p0 += b) {
    const float* src = p0 == 0 ? mats + blockIdx.x * kk : g;
    const int nb = min(b, K - p0), kc = K - nb;  // pivots, other rows (and columns)

    // 1. The pivot block: entry (e / B, e % B) of thread t for e = t + 256 s.
    // Pivot k reads buffer k & 1 and writes the other.
    for (int e = t; e < nb * B; e += kThreads) {
      const int r = e / B, c = e % B;
      if (c < nb) {
        const float v = src[(int64_t)(p0 + r) * K + p0 + c];
        Db[r * b4 + c] = v;
        if (r == 0) rD[c] = (c == 0 ? 1.f : v) / src[(int64_t)p0 * K + p0];
        if (c == 0) cD[r] = v;
      }
    }
    if (t == 0) pv[0] = src[(int64_t)p0 * K + p0];
    __syncthreads();
    for (int k = 0; k < nb; ++k) {
      const float* cur = Db + (k & 1) * b * b4;
      float* nxt = Db + ((k + 1) & 1) * b * b4;
      const float* rk = rD + k * b4;
      const float* ck = cD + k * b4;
      const bool more = k + 1 < nb;
      // the next pivot, as its owner takes it below
      const float pn = more ? fmaf(-ck[k + 1], rk[k + 1], cur[(k + 1) * b4 + k + 1]) : 1.f;
#pragma unroll
      for (int s = 0; s < B * B / kThreads; ++s) {
        const int e = t + s * kThreads, r = e / B, c = e % B;
        if (r < nb && c < nb) {
          const float v = r == k ? rk[c] : fmaf(-ck[r], rk[c], c == k ? 0.f : cur[r * b4 + c]);
          nxt[r * b4 + c] = v;
          if (more && r == k + 1) rD[(k + 1) * b4 + c] = (c == k + 1 ? 1.f : v) / pn;
          if (more && c == k + 1) cD[(k + 1) * b4 + r] = v;
        }
      }
      if (more && t == 0) pv[k + 1] = pn;
      __syncthreads();
    }
    const float* D = Db + (nb & 1) * b * b4;
    for (int e = t; e < nb * B; e += kThreads) {
      const int r = e / B, c = e % B;
      if (c < nb) g[(int64_t)(p0 + r) * K + p0 + c] = D[r * b4 + c];
    }

    // 2. The strips: items [0, kc) the panel's rows at another column j,
    // [kc, 2 kc) the panel's columns at another row i.
    for (int it = t; it < 2 * kc; it += kThreads) {
      float v[B];
      if (it < kc) {
        const int x = it, j = x < p0 ? x : x + nb;
#pragma unroll
        for (int k = 0; k < B; ++k) v[k] = k < nb ? src[(int64_t)(p0 + k) * K + j] : 0.f;
#pragma unroll
        for (int k = 0; k < B; ++k) {
          if (k < nb) {
            const float piv = pv[k];
            const float r = panel_div(v[k], piv, FastDiv(piv));
            v[k] = r;  // row p takes r
            Rs[(int64_t)k * S + x] = r;
            const float* ck = cD + k * b4;
#pragma unroll
            for (int g4 = 0; g4 < B / 4; ++g4) {
              if (4 * g4 < nb) {
                const float4 c = *reinterpret_cast<const float4*>(ck + 4 * g4);
                const float cc[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
                for (int q = 0; q < 4; ++q)
                  if (4 * g4 + q != k) v[4 * g4 + q] = fmaf(-cc[q], r, v[4 * g4 + q]);
              }
            }
          }
        }
#pragma unroll
        for (int k = 0; k < B; ++k)
          if (k < nb) g[(int64_t)(p0 + k) * K + j] = v[k];
      } else {
        const int x = it - kc, i = x < p0 ? x : x + nb;
        const float* row = src + (int64_t)i * K + p0;
#pragma unroll
        for (int g4 = 0; g4 < B / 4; ++g4) {
          if (vec && 4 * g4 + 4 <= nb) {
            const float4 w = *reinterpret_cast<const float4*>(row + 4 * g4);
            v[4 * g4] = w.x, v[4 * g4 + 1] = w.y, v[4 * g4 + 2] = w.z, v[4 * g4 + 3] = w.w;
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q) v[4 * g4 + q] = 4 * g4 + q < nb ? row[4 * g4 + q] : 0.f;
          }
        }
#pragma unroll
        for (int k = 0; k < B; ++k) {
          if (k < nb) {
            const float c = v[k];  // this row's multiplier for pivot p0 + k
            Cs[(int64_t)k * S + x] = c;
            const float* rk = rD + k * b4;
#pragma unroll
            for (int g4 = 0; g4 < B / 4; ++g4) {
              if (4 * g4 < nb) {
                const float4 r = *reinterpret_cast<const float4*>(rk + 4 * g4);
                const float rr[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                  const int j = 4 * g4 + q;  // column p is zeroed first
                  v[j] = fmaf(-c, rr[q], j == k ? 0.f : v[j]);
                }
              }
            }
          }
        }
        float* dst = g + (int64_t)i * K + p0;
#pragma unroll
        for (int g4 = 0; g4 < B / 4; ++g4) {
          if (vec && 4 * g4 + 4 <= nb) {
            *reinterpret_cast<float4*>(dst + 4 * g4) =
                make_float4(v[4 * g4], v[4 * g4 + 1], v[4 * g4 + 2], v[4 * g4 + 3]);
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q)
              if (4 * g4 + q < nb) dst[4 * g4 + q] = v[4 * g4 + q];
          }
        }
      }
    }
    __syncthreads();

    // 3. The rest: rows u and columns v of the other entries (u, v < kc;
    // index u < p0 ? u : u + nb), thread (ty, tx) holding rows 8 ty + m
    // and columns 4 tx + q of each 128 x 64 block.
    for (int u0 = 0; u0 < kc; u0 += 128) {
      const int ub = u0 + 8 * ty;
      if (ub >= kc) continue;
      int64_t roff[8];
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int u = ub + m;
        roff[m] = (int64_t)(u < p0 ? u : u + nb) * K;
      }
      for (int v0 = 0; v0 < kc; v0 += 64) {
        const int vb = v0 + 4 * tx;
        const int j0 = vb < p0 ? vb : vb + nb;
        const bool full = vb + 4 <= kc;
        float a[8][4];
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          const bool in = ub + m < kc;
          if (vec && full && in) {
            const float4 w = *reinterpret_cast<const float4*>(src + roff[m] + j0);
            a[m][0] = w.x, a[m][1] = w.y, a[m][2] = w.z, a[m][3] = w.w;
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int vq = vb + q;
              a[m][q] = in && vq < kc ? src[roff[m] + (vq < p0 ? vq : vq + nb)] : 0.f;
            }
          }
        }
        const float* cp = Cs + ub;
        const float* rp = Rs + vb;
#pragma unroll 2
        for (int k = 0; k < nb; ++k) {
          const float4 c0 = *reinterpret_cast<const float4*>(cp + (int64_t)k * S);
          const float4 c1 = *reinterpret_cast<const float4*>(cp + (int64_t)k * S + 4);
          const float4 r4 = *reinterpret_cast<const float4*>(rp + (int64_t)k * S);
          const float c[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
          const float r[4] = {r4.x, r4.y, r4.z, r4.w};
#pragma unroll
          for (int m = 0; m < 8; ++m)
#pragma unroll
            for (int q = 0; q < 4; ++q) a[m][q] = fmaf(-c[m], r[q], a[m][q]);
        }
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          const bool in = ub + m < kc;
          if (vec && full && in) {
            *reinterpret_cast<float4*>(g + roff[m] + j0) =
                make_float4(a[m][0], a[m][1], a[m][2], a[m][3]);
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int vq = vb + q;
              if (in && vq < kc) g[roff[m] + (vq < p0 ? vq : vq + nb)] = a[m][q];
            }
          }
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace

// The plan's b, bytes of shared memory, strips in global memory (scratch:
// 2 b S floats a matrix and 8 more) and stride S, from gj_inverse.cu's
// panel_plan.
cudaError_t gj_panel_launch(const float* mats, int R, int K, float* out, float* scratch,
                            int b, int smem, bool global, int stride, cudaStream_t stream) {
  if (b < 1 || b > kMaxB) return cudaErrorInvalidValue;
  auto kernel = global ? gj_inverse_panel_kernel<true> : gj_inverse_panel_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(mats) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(out) % 16 == 0;
  kernel<<<R, kThreads, smem, stream>>>(mats, K, b, stride, vec, out, scratch);
  return cudaGetLastError();
}
