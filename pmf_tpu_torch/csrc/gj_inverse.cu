// K4 — batched Gauss-Jordan inverse of small positive-definite matrices.
//
// Replaces: pmf_tpu/ops/pallas/gj_inverse.py::_gj_kernel.
//
// Computes, for each of R row-major (K, K) float32 matrices A, its inverse
// by Gauss-Jordan elimination without pivoting (valid for positive-definite
// A: every step leaves a positive-definite trailing block, so each pivot
// is positive).  The elimination runs in place: column p of A is no longer
// needed once pivot p is taken, so it becomes column p of the inverse.  At
// pivot p, with r = [A's row p, the 1 of I's column p in place of A's
// entry p] / a[p][p]:
//   a[p][j] = r[j];   a[i][j] = (j == p ? 0 : a[i][j]) - a[i][p] * r[j], i != p.
// These are the operations of the [A | I] form on the same values (A's
// column p is dropped there instead), at K^3 multiply-adds a matrix in
// place of 2 K^3.
//
// What bounds it on an H100: memory at K <= 32.  Each matrix is read once
// and its inverse written once (2 * 4K^2 bytes); the elimination does
// 2K^3 flops, 5 flops a byte at K = 20, below the FP32 line's 20.  At K = 50
// it is 12.5 flops a byte, at K = 128 32: there the FP32 operations bound
// it.  Beside each multiply-add the row form spends a select and a share
// of the pivot row's broadcast loads, so it runs at several times these
// bounds.
//
// Design, K <= 64 (gj_inverse_rows_kernel): a CTA inverts M matrices that
// are contiguous in memory, thread t holding row t % K of matrix t / K in
// registers, so the rows of several matrices fill the warps (K = 20: eight
// matrices in five warps; K = 8: four a warp).  The CTA copies its
// matrices with cp.async (16 bytes where K % 4 == 0), every thread on
// consecutive bytes, into shared memory at a padded row stride S (a
// multiple of 4 and 4 mod 8, so float4 reads of eight rows at one column
// touch 32 distinct banks); each thread reads its row with float4 loads.
// At pivot p the thread that holds row p scales it by one reciprocal into
// its matrix's row buffer in shared memory (two buffers, alternating, so
// one __syncthreads a pivot orders the write before the reads and the
// reads before the next write two pivots on); every thread reads it back
// with K/4 broadcast float4 loads and updates its row.  The pivot index is
// a compile-time constant after unrolling, so a[i][p] is a register.  The
// rows go back to the same shared tile and out with coalesced stores.
//
// Design, 64 < K < 240 (the CTA form, gj_inverse_tile_kernel in
// gj_tile.cuh): one CTA of 256 threads a matrix, held in registers as a
// 16 x 16 grid of T x T tiles, T = ceil(K / 16); the warp holding each
// pivot row publishes it and its readers meet it at named barriers.
//
// Design, K >= 240 (the panel form, gj_inverse_panel_kernel in
// gj_panel.cu): the matrix in global memory, its pivots in panels of b
// (panel_plan below), the matrix passing through the SM K / b times.

#include <cuda_runtime.h>
#include <stdint.h>

// The CTA form (gj_tile.cuh), its instances split over two sources, and
// the panel form (gj_panel.cu).
cudaError_t gj_tile_launch_lo(const float* mats, int R, int K, float* out,
                              cudaStream_t stream);
cudaError_t gj_tile_launch_hi(const float* mats, int R, int K, float* out,
                              cudaStream_t stream);
cudaError_t gj_panel_launch(const float* mats, int R, int K, float* out, float* scratch,
                            int b, int smem, bool global, int stride, cudaStream_t stream);

namespace {

// BEGIN host plan: the dispatch's choice of form and the panel form's
// plan, in plain C++ (the tests compile this block alone with a host
// compiler and hold it against ops/gj_inverse.py's form and panel_plan).
constexpr int kRowsMaxK = 64;   // the row form; past it the CTA form
constexpr int kCtaMaxK = 239;   // the CTA form's last K (gj_tile.cuh's tiles to T = 15)
constexpr int kSmemPerCta = 232448;  // dynamic shared memory a CTA may ask for
constexpr int kSmemPerSm = 233472;   // an SM's, 1 KB of it reserved a CTA
constexpr int kPanelMaxB = 32;  // pivots a panel at most: a strip's values in registers
constexpr int kPanelMinB = 8;   // the fewest before the strips' rows go to global memory
constexpr int kPanelCtas = 2;   // the panel kernel's launch bound: 128 registers a thread
constexpr int kPanelMinB2 = 16; // the fewest pivots a panel with two CTAs an SM

enum Form { kFormRows, kFormCta, kFormPanel };

Form form_of(int K) {
  if (K <= kRowsMaxK) return kFormRows;
  return K <= kCtaMaxK ? kFormCta : kFormPanel;
}

// Floats of the panel form's shared memory for K and b: the pivot block's
// two buffers and its rows and columns (4 b x b4), the pivots (b4) and,
// unless they are in global memory, the strips' rows r_k and columns
// c^(k) at the other entries (2 b x stride, and 8 floats of slack for the
// tiles' reads past the last row).
int64_t panel_stride(int K) { return ((int64_t)K + 3) / 4 * 4; }

int64_t panel_words(int K, int b, bool global) {
  const int64_t b4 = (b + 3) / 4 * 4;
  return 4 * b * b4 + b4 + (global ? 0 : 2 * b * panel_stride(K) + 8);
}

struct PanelPlan {
  int b;         // pivots a panel
  int ctas;      // CTAs an SM, as shared memory allows (at most kPanelCtas)
  int64_t smem;  // bytes of dynamic shared memory
  bool global;   // the strips' rows in global scratch (2 b stride + 8 floats a matrix)
};

// b: the largest multiple of 8 up to kPanelMaxB whose shared memory
// leaves two CTAs an SM, if it is at least kPanelMinB2 (one CTA's
// elimination of its pivot block then overlaps the other's passes); else
// the largest that fits one CTA; else kPanelMaxB with the strips' rows in
// global memory.
PanelPlan panel_plan(int K) {
  auto fits = [&](int b, int ctas) {
    return ctas * (panel_words(K, b, false) * 4 + 1024) <= kSmemPerSm &&
           panel_words(K, b, false) * 4 <= kSmemPerCta;
  };
  int b = 0, ctas = 0;
  for (int c = kPanelCtas; c >= 1 && b == 0; --c)
    for (int t = kPanelMaxB; t >= (c > 1 ? kPanelMinB2 : kPanelMinB); t -= 8)
      if (fits(t, c)) {
        b = t;
        ctas = c;
        break;
      }
  const bool global = b == 0;
  if (global) b = kPanelMaxB;
  const int64_t smem = panel_words(K, b, global) * 4;
  if (global) ctas = kPanelCtas * (smem + 1024) <= kSmemPerSm ? kPanelCtas : 1;
  return {b, ctas, smem, global};
}
// END host plan

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}

// Row stride in shared memory: K rounded up to 4 floats, then made 4 mod 8.
__host__ __device__ inline int row_stride(int K) {
  const int s = (K + 3) / 4 * 4;
  return s % 8 == 0 ? s + 4 : s;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src)
               : "memory");
}

// e / K for e < 2^32 / K: (e * ceil(2^32 / K)) >> 32, and e itself at K = 1.
__device__ __forceinline__ int div_k(int e, uint32_t magic) {
  return magic ? (int)__umulhi((uint32_t)e, magic) : e;
}

// KMAX: registers a row (K <= KMAX); WMAX: warps a CTA at most.  The CTA
// holds M matrices, thread t row t % K of matrix t / K (threads past M * K
// idle); `magic` = ceil(2^32 / K).  `vec`: K % 4 == 0 and both tables
// 16-byte aligned, so the tile moves in float4s.
template <int KMAX, int WMAX>
__global__ void __launch_bounds__(WMAX * 32)
gj_inverse_rows_kernel(const float* __restrict__ mats, int R, int K, int M, int S,
                       uint32_t magic, int vec, float* __restrict__ out) {
  extern __shared__ __align__(16) float sm[];
  static_assert(KMAX % 4 == 0, "rows are read as float4s");
  const int t = threadIdx.x, nt = blockDim.x;
  const int64_t m0 = (int64_t)blockIdx.x * M;
  const int nm = (int)(R - m0 < M ? R - m0 : M);  // matrices in this CTA
  float* tile = sm;  // M * K rows of stride S; row t is thread t's
  float* rowbuf = sm + M * K * S;  // 2 x KMAX floats per matrix
  const int n_el = nm * K * K;
  const float* src = mats + m0 * K * K;
  if (vec) {
    for (int e = 4 * t; e < n_el; e += 4 * nt) {
      const int q = div_k(e, magic);
      cp_async16(tile + q * S + (e - q * K), src + e);
    }
  } else {
    for (int e = t; e < n_el; e += nt) {
      const int q = div_k(e, magic);
      cp_async4(tile + q * S + (e - q * K), src + e);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  const int mat = div_k(t, magic);
  const int i = t - mat * K;  // this thread's row
  const bool live = mat < nm;
  float a[KMAX];
#pragma unroll
  for (int j4 = 0; j4 < KMAX / 4; ++j4) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (4 * j4 < K && live) v = *reinterpret_cast<const float4*>(tile + t * S + 4 * j4);
    a[4 * j4] = v.x;
    a[4 * j4 + 1] = 4 * j4 + 1 < K ? v.y : 0.f;
    a[4 * j4 + 2] = 4 * j4 + 2 < K ? v.z : 0.f;
    a[4 * j4 + 3] = 4 * j4 + 3 < K ? v.w : 0.f;
  }

  const float* rb = rowbuf + (mat < M ? mat : M - 1) * 2 * KMAX;
#pragma unroll
  for (int p = 0; p < KMAX; ++p) {
    if (p < K) {  // uniform across the CTA
      const bool me = live && i == p;  // this thread holds row p
      float* buf = rowbuf + mat * 2 * KMAX + (p & 1) * KMAX;
      if (me) {  // r = [row p with the 1 of I's column p] / a[p][p]
        const float inv = 1.f / a[p];
#pragma unroll
        for (int j4 = 0; j4 < KMAX / 4; ++j4) {
          if (4 * j4 < K) {
            float4 v;
            v.x = (4 * j4 == p ? 1.f : a[4 * j4]) * inv;
            v.y = (4 * j4 + 1 == p ? 1.f : a[4 * j4 + 1]) * inv;
            v.z = (4 * j4 + 2 == p ? 1.f : a[4 * j4 + 2]) * inv;
            v.w = (4 * j4 + 3 == p ? 1.f : a[4 * j4 + 3]) * inv;
            *reinterpret_cast<float4*>(buf + 4 * j4) = v;
          }
        }
      }
      __syncthreads();
      // a[i][j] = (j == p ? 0 : a[i][j]) - a[i][p] * r[j] for i != p; r
      // for i == p.  The other buffer, written at the next pivot, was read
      // before this barrier.
      const float* rp = rb + (p & 1) * KMAX;
      const float c = a[p];
#pragma unroll
      for (int j4 = 0; j4 < KMAX / 4; ++j4) {
        if (4 * j4 < K) {
          const float4 r = *reinterpret_cast<const float4*>(rp + 4 * j4);
          const float rv[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int j = 4 * j4 + q;
            a[j] = me ? rv[q] : (j == p ? 0.f : a[j]) - c * rv[q];
          }
        }
      }
    }
  }

  if (live) {
#pragma unroll
    for (int j4 = 0; j4 < KMAX / 4; ++j4)
      if (4 * j4 < K)
        *reinterpret_cast<float4*>(tile + t * S + 4 * j4) =
            make_float4(a[4 * j4], a[4 * j4 + 1], a[4 * j4 + 2], a[4 * j4 + 3]);
  }
  __syncthreads();
  float* dst = out + m0 * K * K;
  if (vec) {
    for (int e = 4 * t; e < n_el; e += 4 * nt) {
      const int q = div_k(e, magic);
      __stcs(reinterpret_cast<float4*>(dst + e),
             *reinterpret_cast<const float4*>(tile + q * S + (e - q * K)));
    }
  } else {
    for (int e = t; e < n_el; e += nt) {
      const int q = div_k(e, magic);
      __stcs(dst + e, tile[q * S + (e - q * K)]);
    }
  }
}

// Warps a CTA for K: the fewest of 1..wmax that leave the smallest share
// of threads idle (32 w / K matrices of K rows each).
int rows_warps(int K, int wmax) {
  int best = 1;
  for (int w = 2; w <= wmax; ++w)
    if ((32 * w / K) * K * 32 * best > (32 * best / K) * K * 32 * w) best = w;
  return best;
}

template <int KMAX, int WMAX>
cudaError_t launch_rows(const float* mats, int R, int K, float* out,
                        cudaStream_t stream) {
  auto kernel = gj_inverse_rows_kernel<KMAX, WMAX>;
  const int w = rows_warps(K, WMAX);
  const int M = 32 * w / K;
  const int S = row_stride(K);
  const int smem = (M * K * S + M * 2 * KMAX) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const uint32_t magic = K == 1 ? 0u : (uint32_t)(((1ull << 32) + K - 1) / K);
  const int vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(mats) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(out) % 16 == 0;
  kernel<<<(R + M - 1) / M, 32 * w, smem, stream>>>(mats, R, K, M, S, magic, vec, out);
  return cudaGetLastError();
}

}  // namespace

// scratch: 2 b S + 8 floats a matrix (ops/gj_inverse.py::panel_plan), read
// only where the panel form's strips do not fit shared memory; may be null
// elsewhere.
extern "C" int pmf_gj_inverse(const float* mats, int R, int K, float* out,
                              float* scratch, void* stream) {
  if (K < 1) return (int)cudaErrorInvalidValue;
  if (R <= 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // Keep in step with ops/gj_inverse.py::launch_plan.
  if (K <= 8) return (int)launch_rows<8, 8>(mats, R, K, out, s);
  if (K <= 16) return (int)launch_rows<16, 8>(mats, R, K, out, s);
  if (K <= 24) return (int)launch_rows<24, 8>(mats, R, K, out, s);
  if (K <= 32) return (int)launch_rows<32, 8>(mats, R, K, out, s);
  if (K <= 40) return (int)launch_rows<40, 4>(mats, R, K, out, s);
  if (K <= 48) return (int)launch_rows<48, 4>(mats, R, K, out, s);
  if (K <= 52) return (int)launch_rows<52, 4>(mats, R, K, out, s);
  if (K <= 56) return (int)launch_rows<56, 4>(mats, R, K, out, s);
  if (K <= kRowsMaxK) return (int)launch_rows<64, 4>(mats, R, K, out, s);
  if (form_of(K) == kFormCta)  // gj_tile_lo.cu's tiles to T = 10, K = 160
    return (int)(K <= 160 ? gj_tile_launch_lo : gj_tile_launch_hi)(mats, R, K, out, s);
  const PanelPlan pp = panel_plan(K);
  if (pp.global && scratch == nullptr) return (int)cudaErrorInvalidValue;
  return (int)gj_panel_launch(mats, R, K, out, scratch, pp.b, (int)pp.smem, pp.global,
                              (int)panel_stride(K), s);
}
