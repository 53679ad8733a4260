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
// Design, 64 < K < 240 (gj_inverse_cta_kernel): one CTA of 256 threads per
// matrix, held in shared memory (K x (K + 1) floats, 66 KB at K = 128, 226
// KB at K = 239, the most that fits a CTA's 227 KB with the two buffers;
// the odd row stride keeps a column read free of bank conflicts), in
// place.  Per pivot the CTA copies the scaled pivot row and the old column
// p into two K-float buffers, syncs, updates every entry from the buffers
// and syncs again.  (A row form there would keep up to 128 floats a
// thread, more registers than its unrolled elimination can hold.)
//
// Design, K >= 240 (gj_inverse_global_kernel): the CTA form's steps with
// the matrix split: as many of its first rows as fit beside the two
// buffers stay in shared memory (224 of 256 at K = 256, 191 of 300 at K =
// 300), the rest in the output in global memory, where every pivot reads
// and writes them through L1 and L2.  Past K = 29,056 the buffers too are
// global (a scratch row pair a matrix).  Correct at any K, not tuned.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// BEGIN host plan: the dispatch's choice of form, in plain C++ (the tests
// compile this block alone with a host compiler and hold it against
// ops/gj_inverse.py's form and global_shared_rows).
constexpr int kRowsMaxK = 64;  // the row form; past it the CTA form
constexpr int kSmemPerCta = 232448;  // dynamic shared memory a CTA may ask for

// Shared memory of the CTA form: the K x (K + 1) matrix and two K-float
// buffers, in 64 bits (it passes 2^31 bytes from K = 23,170).
int64_t cta_smem_bytes(int K) {
  return ((int64_t)K * (K + 1) + 2 * (int64_t)K) * (int64_t)sizeof(float);
}

enum Form { kFormRows, kFormCta, kFormGlobal };

Form form_of(int K) {
  if (K <= kRowsMaxK) return kFormRows;
  return cta_smem_bytes(K) <= kSmemPerCta ? kFormCta : kFormGlobal;
}

// Past the CTA form: the pivot row and column buffers and the first `rs`
// rows of the matrix (stride K + 1) in shared memory, the other rows in
// global memory (the output, stride K, A's rows copied in first).  Where
// even the buffers do not fit (2K floats past kSmemPerCta) they are the
// matrix's 2K floats of global scratch and rs = 0.
struct GlobalPlan {
  int rs;        // rows in shared memory
  int smem;      // bytes of dynamic shared memory
  bool buffers;  // the buffers in shared memory
};

GlobalPlan global_plan(int K) {
  const int64_t buf = 2 * (int64_t)K * (int64_t)sizeof(float);
  if (buf > kSmemPerCta) return {0, 0, false};
  const int64_t rs = (kSmemPerCta - buf) / ((int64_t)(K + 1) * (int64_t)sizeof(float));
  const int r = rs < K ? (int)rs : K;
  return {r, (int)(buf + (int64_t)r * (K + 1) * (int64_t)sizeof(float)), true};
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

constexpr int kCtaThreads = 256;

__global__ void __launch_bounds__(kCtaThreads)
gj_inverse_cta_kernel(const float* __restrict__ mats, int K, float* __restrict__ out) {
  extern __shared__ float sm[];
  const int S = K + 1;  // row stride in shared memory
  float* a = sm;  // K x S
  float* row = a + K * S;  // the scaled pivot row
  float* col = row + K;  // the pivot column before the step
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int kWarps = kCtaThreads / 32;
  const int64_t r = blockIdx.x;
  const float* src = mats + r * K * K;
  float* dst = out + r * K * K;
  // Warp w takes rows w, w + 8, ...; lane l columns l, l + 32, ...
  for (int i = warp; i < K; i += kWarps)
    for (int j = lane; j < K; j += 32) a[i * S + j] = src[(int64_t)i * K + j];
  __syncthreads();
  for (int p = 0; p < K; ++p) {
    const float piv = a[p * S + p];
    for (int j = threadIdx.x; j < K; j += kCtaThreads) {
      row[j] = (j == p ? 1.f : a[p * S + j]) / piv;
      col[j] = a[j * S + p];
    }
    __syncthreads();
    for (int i = warp; i < K; i += kWarps) {
      float* ai = a + i * S;
      if (i == p) {
        for (int j = lane; j < K; j += 32) ai[j] = row[j];
      } else {
        const float ci = col[i];
        for (int j = lane; j < K; j += 32) ai[j] = (j == p ? 0.f : ai[j]) - ci * row[j];
      }
    }
    __syncthreads();
  }
  for (int i = warp; i < K; i += kWarps)
    for (int j = lane; j < K; j += 32) dst[(int64_t)i * K + j] = a[i * S + j];
}

cudaError_t launch_cta(const float* mats, int R, int K, float* out, cudaStream_t stream) {
  const int smem = (int)cta_smem_bytes(K);  // <= kSmemPerCta (form_of)
  cudaError_t err = cudaFuncSetAttribute(
      gj_inverse_cta_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  gj_inverse_cta_kernel<<<R, kCtaThreads, smem, stream>>>(mats, K, out);
  return cudaGetLastError();
}

// The CTA form's elimination with rows [0, rs) in shared memory and rows
// [rs, K) in global memory (GlobalPlan).  Stores of one thread to global
// memory reach the others of its CTA at each __syncthreads.
__global__ void __launch_bounds__(kCtaThreads)
gj_inverse_global_kernel(const float* __restrict__ mats, int K, int rs, int buffers,
                         float* out, float* scratch) {
  extern __shared__ float sm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int kWarps = kCtaThreads / 32;
  const int64_t kk = (int64_t)K * K;
  const int S = K + 1;
  const float* src = mats + blockIdx.x * kk;
  float* g = out + blockIdx.x * kk;
  float* row = buffers ? sm : scratch + blockIdx.x * 2 * (int64_t)K;
  float* col = row + K;
  float* shared_rows = sm + 2 * K;
  auto row_of = [&](int i) -> float* {
    return i < rs ? shared_rows + (int64_t)i * S : g + (int64_t)i * K;
  };
  for (int i = warp; i < K; i += kWarps) {
    float* ai = row_of(i);
    for (int j = lane; j < K; j += 32) ai[j] = src[(int64_t)i * K + j];
  }
  __syncthreads();
  for (int p = 0; p < K; ++p) {
    const float* ap = row_of(p);
    const float piv = ap[p];
    for (int j = threadIdx.x; j < K; j += kCtaThreads) {
      row[j] = (j == p ? 1.f : ap[j]) / piv;
      col[j] = row_of(j)[p];
    }
    __syncthreads();
    for (int i = warp; i < K; i += kWarps) {
      float* ai = row_of(i);
      if (i == p) {
        for (int j = lane; j < K; j += 32) ai[j] = row[j];
      } else {
        const float ci = col[i];
        for (int j = lane; j < K; j += 32) ai[j] = (j == p ? 0.f : ai[j]) - ci * row[j];
      }
    }
    __syncthreads();
  }
  for (int i = warp; i < rs; i += kWarps)
    for (int j = lane; j < K; j += 32) g[(int64_t)i * K + j] = shared_rows[(int64_t)i * S + j];
}

}  // namespace

// scratch: 2K floats a matrix, read only where the global form's buffers
// do not fit shared memory (K > 29,056); may be null below that.
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
  if (form_of(K) == kFormCta) return (int)launch_cta(mats, R, K, out, s);
  const GlobalPlan gp = global_plan(K);
  if (!gp.buffers && scratch == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      gj_inverse_global_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, gp.smem);
  if (err != cudaSuccess) return (int)err;
  gj_inverse_global_kernel<<<R, kCtaThreads, gp.smem, s>>>(mats, K, gp.rs, gp.buffers, out,
                                                          scratch);
  return (int)cudaGetLastError();
}
