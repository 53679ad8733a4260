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
// What bounds it on an H100: bytes.  The three lines of the bound over the
// benchmark's four tiers at K = 20 (3.35 GB of cell planes a side: 4 bytes
// a stored cell, 6 with x_lo, 8 with x_lo and a float32 M), per sweep:
//   bytes       every real cell read once at 3.35 TB/s           1.95 ms
//               (2.02 ms with the zero columns the layout stores)
//   tensor work 24 mma.m16n8k16 per 256 cells (27 with a float32
//               M), 4096 flops each, at the 989 TFLOP/s bf16 peak 0.53 ms
//   elementwise 5.5 float32 operations a cell at 67 TFLOP/s      0.14 ms
// The kernel takes 2.78-2.96 ms a sweep (H100 80GB HBM3 at 700 W,
// chip_smoke.py phase K2): 54-82% of 3.35 TB/s tier by tier.  With the
// three products on the CUDA cores (the design before this one, 60 FMAs
// a cell, 193-255 registers) it took 12.65 ms against an operations line
// of 2.03 ms.
//
// Design:
//  * Both sides are one kernel body.  The CTA's fixed operand P (64 theta
//    rows on the user side, 64 beta rows on the item side, 16 per warp)
//    sits in registers as mma A fragments; the other table Q streams past
//    in tiles of 32 rows together with the 64 x 32 cell tiles.  Per 16-row
//    chunk of Q a warp computes acc = P Q^T (R, or R^T on the item side),
//    turns the accumulator into W in registers, and feeds W and M as the A
//    operand of the second product, out += [W | M] Q: the accumulator
//    layout of two neighbouring n8 tiles of mma.m16n8k16 is its A-fragment
//    layout.  Each warp owns its P rows over the whole reduction axis, so
//    nothing is summed across warps.  The next chunk's first product is
//    issued before the current chunk's elementwise work.
//  * Precision: every f32 operand is two bf16 planes rounded to nearest
//    (hi = bf16(t), lo = bf16(t - hi)) and every product three terms,
//    lo*hi + hi*lo + hi*hi, summed in float32.  P is split in registers
//    once a CTA; Q once a launch by split_planes_kernel into planes of
//    8 * ceil(K / 8) zero-padded columns; W in registers; a bf16 M is
//    exact, a float32 M is split like W.  K pads to blocks of 8 in depth
//    (k16 steps and one k8 step) and in width.  Against the plain version
//    in float64 (chip_smoke.py phase K2small): 2.5e-5 relative at worst.
//    Truncated hi planes lose three times as much (the emulation in
//    tests/test_torch_dense_head.py: R to 6.0e-5 against 2.1e-5).
//  * The tensor core's float32 accumulator truncates, so a chain of mma
//    steps as long as the reduction axis loses about 6e-8 of the sum a
//    step (7e-5 over tier 0's 1400 steps).  Each tile's products therefore
//    start from a zero accumulator (6 steps) and are added to the running
//    sums with float adds.
//  * mma.sync.m16n8k16 with ldmatrix, not wgmma: the tensor work is a
//    quarter of the bytes line, W has to pass through registers between
//    the products in any case, and mma.sync needs no shared-memory
//    descriptors or swizzled tiles.  X and M are read from shared memory
//    at the accumulator's positions by ldmatrix; the item side reads the
//    same row-major tiles with ldmatrix.trans, so W^T is the accumulator
//    and is never transposed.  The Q tile serves the first product through
//    ldmatrix and the second through ldmatrix.trans.  Row strides are an
//    odd number of 16-byte slots (padded where needed), which keeps the 8
//    rows of every ldmatrix in distinct banks.
//  * Staging: a ring of 3 stages of (x_hi, x_lo, M, Q hi, Q lo) tiles in
//    dynamic shared memory (30-75 KB a CTA), filled by 16-byte cp.async.cg
//    copies (rows past the end are zero-filled through the src-size
//    operand), two tiles in flight while one is computed, one
//    __syncthreads a tile.  cp.async, not TMA: the tiles are plain 2-D
//    boxes of 64-256 byte rows, the copies cost a few instructions a
//    thread a tile, and no tensor map has to be encoded on the host.  On
//    the user side, where a tile takes 64 bytes of each of 64 rows, the
//    copies ask the L2 for the 256 bytes around them (6-25% faster).
//  * The divide is __fdividef (one MUFU.RCP and a multiply, 2 ulp).  Empty
//    cells are masked after W's split, two cells a register; a bf16 M
//    gives the mask with one packed compare.
//  * 138-168 registers a thread at K = 20 (no spills), 128 threads, three
//    CTAs an SM by the launch bounds and by shared memory.
//  * Precision "fast" (pmf_dense_head_tier_fast, TERMS = 1): the
//    reference's Precision.DEFAULT, one bf16 pass with operands rounded to
//    nearest.  P, Q, W and a float32 M are one RN plane each, every product
//    is one mma, split_planes_kernel writes Q's hi plane only and the ring
//    stages no Q lo tile; X is still x_hi + x_lo in float32, as in the
//    reference.  The bytes line is that of TERMS = 3; the tensor line falls
//    to a third.  The per-tile zero-started chains stay.
//  * K > 32: the depth pads to NT = 4 ceil(K / 32) blocks of 8 (8, 12 or
//    16), so the instances are few and every output group is whole.  P's
//    A fragments cover the whole depth (4 NT registers a thread), R is
//    taken over the whole depth in chains of 4 blocks (6 mma steps each,
//    added with float adds), and the outputs are cut into groups of 4
//    blocks (32 factors) on grid.z: each group's CTA recomputes R and W
//    and keeps only its group's [W Q | M Q] accumulators, so their
//    registers stay those of K = 32.  The cell planes are read once a
//    group.  Two CTAs an SM by the launch bounds (255 registers a
//    thread) and by the wider Q planes' shared memory.
//  * Tiers that would leave the card idle (few P tiles) split the
//    reduction axis over more CTAs; each split writes its own partial rows
//    and sum_partials_kernel adds them.  No atomics, so a launch repeats
//    bit for bit.  ops/dense_head.py::plan_launch picks the splits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, zero-filled past src_bytes.  With
// PREFETCH the copy asks the L2 to fetch the 256 bytes around the source.
template <bool PREFETCH>
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  if (PREFETCH)
    asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
  else
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t& r0, uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t addr, uint32_t& r0, uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1) : "r"(addr));
}

// d (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col).
__device__ __forceinline__ void mma16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                      uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                      uint32_t b1) {
  mma16(d, a[0], a[1], a[2], a[3], b0, b1);
}

// d = a * b: the start of a chain (no accumulator registers to zero first).
__device__ __forceinline__ void mma16_z(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                        uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1), "f"(0.f));
}

__device__ __forceinline__ void mma16_z(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  mma16_z(d, a[0], a[1], a[2], a[3], b0, b1);
}

__device__ __forceinline__ void mma8_z(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%7,%7,%7,%7};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0), "f"(0.f));
}

// d (16x8 f32) += a (16x8 bf16, row) * b (8x8 bf16, col).
__device__ __forceinline__ void mma8(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// Two floats rounded to nearest bf16, v0 in the low half.
__device__ __forceinline__ uint32_t pack_bf16_rn(float v0, float v1) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(v1), "f"(v0));
  return r;
}

// (v0, v1) as packed hi and lo bf16 planes, both rounded to nearest.
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16_rn(v0, v1);
  lo = pack_bf16_rn(v0 - bf16_lo(hi), v1 - bf16_hi(hi));
}

// tab (n, K) as two bf16 planes of KD zero-padded columns: hi, then lo.
// With one plane (precision "fast") only hi is written.
__global__ void split_planes_kernel(const float* __restrict__ tab, int n, int K, int KD,
                                    int two_planes, uint16_t* __restrict__ planes) {
  const int64_t total = (int64_t)n * KD;
  for (int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int64_t row = e / KD;
    const int k = (int)(e % KD);
    const float v = k < K ? tab[row * K + k] : 0.f;
    const __nv_bfloat16 hi = __float2bfloat16_rn(v);
    planes[e] = __bfloat16_as_ushort(hi);
    if (two_planes)
      planes[total + e] = __bfloat16_as_ushort(__float2bfloat16_rn(v - __bfloat162float(hi)));
  }
}

// Geometry (kept in step with ops/dense_head.py).
constexpr int kWarps = 4;  // warps a CTA; each owns 16 rows of P
constexpr int kBQ = 32;  // rows of Q per tile
constexpr int kStages = 3;  // ring of staged tiles: two in flight, one computed
constexpr int kThreads = kWarps * 32;
constexpr int kPT = kWarps * 16;  // rows of P a CTA
constexpr int kMinCtas = 3;  // resident CTAs the launch bounds keep room for (168 registers)
constexpr int kMinCtasWide = 2;  // the same past K = 32 (NT > 4)
constexpr int kGroupBlocks = 4;  // output blocks of 8 factors a CTA keeps past K = 32

// Blocks of 8 in the depth: ceil(K / 8) up to K = 32, then 4 ceil(K / 32).
__host__ __device__ constexpr int nt_of(int k) { return k <= 32 ? (k + 7) / 8 : 4 * ((k + 31) / 32); }

// Shared-memory row stride of a Q plane of NT 8-column blocks: 16 * NT
// bytes, padded where that is an even number of 16-byte slots, so that the
// 8 rows of an ldmatrix fall in distinct banks.
__host__ __device__ constexpr int q_stride(int nt) { return 16 * nt + (nt % 2 ? 0 : 16); }

// One CTA: kPT rows of P against its split's Q tiles of kBQ rows.  K pads
// to NT blocks of 8, in depth for the first product and in width for the
// second; past NT = 4 the CTA's outputs are the group of 4 blocks
// blockIdx.z.  TERMS = 3: every f32 operand as hi and lo planes, three
// terms a product; TERMS = 1: one RN plane, one term (precision "fast").
template <int NT, bool M_F32, bool ITEM, int TERMS>
__device__ __forceinline__ void head_tile_body(
    const float* __restrict__ p_tab, const uint16_t* __restrict__ q_hi,
    const uint16_t* __restrict__ q_lo, const uint16_t* __restrict__ x_hi,
    const uint16_t* __restrict__ x_lo, const void* __restrict__ m_ptr, int rows, int hip,
    int K, float rate_floor, int tiles_per_split, float* __restrict__ dst) {
  constexpr int BQ = kBQ, PT = kPT, THREADS = kThreads, STAGES = kStages;
  constexpr int KD = 8 * NT;
  constexpr int NC = BQ / 16;  // 16-row chunks of Q a tile
  constexpr int NG = NT > kGroupBlocks ? kGroupBlocks : NT;  // output blocks a CTA
  constexpr int NQ = (NT + 3) / 4;  // ldmatrix.x4 loads of Q's depth a row
  constexpr int CELL_ROWS = ITEM ? BQ : PT;
  constexpr int CELL_COLS = ITEM ? PT : BQ;
  constexpr int CS = CELL_COLS * 2 + 16;  // bf16 cell row stride, bytes
  constexpr int MS = M_F32 ? CELL_COLS * 4 + (ITEM ? 16 : 32) : CS;
  constexpr int QS = q_stride(NT);
  constexpr int X_BYTES = CELL_ROWS * CS;
  constexpr int M_BYTES = CELL_ROWS * MS;
  constexpr int Q_BYTES = BQ * QS;
  constexpr int OFF_M = X_BYTES;
  constexpr int OFF_Q = X_BYTES + M_BYTES;
  constexpr bool SPLIT = TERMS == 3;
  static_assert(TERMS == 3 || TERMS == 1, "three terms or one");
  constexpr int Q_PLANES = SPLIT ? 2 : 1;
  constexpr int OFF_XLO = OFF_Q + Q_PLANES * Q_BYTES;
  // The user side walks along the cell rows in pieces of 2 * BQ bytes:
  // ask the L2 for the whole 256 bytes the next tiles will want.
  constexpr bool PREFETCH = !ITEM;

  extern __shared__ __align__(128) unsigned char smem[];
  const bool has_lo = x_lo != nullptr;
  const int stage_bytes = OFF_XLO + (has_lo ? X_BYTES : 0);
  const uint32_t smem_base = smem_u32(smem);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, p = lane & 3;  // accumulator row and column pair
  const int mi = lane >> 3, lr = lane & 7;  // ldmatrix: matrix and row served
  const int nP = ITEM ? hip : rows, nQ = ITEM ? rows : hip;
  const int p0 = blockIdx.x * PT;
  const int zb = NT > kGroupBlocks ? kGroupBlocks * blockIdx.z : 0;  // first output block

  // This warp's 16 P rows as A fragments, split into both planes here:
  // block kb holds columns 8 kb + 2p, + 1 of rows g (h = 0) and g + 8.
  uint32_t a_hi[NT][2], a_lo[SPLIT ? NT : 1][2];
#pragma unroll
  for (int kb = 0; kb < NT; ++kb) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = p0 + warp * 16 + g + 8 * h;
      const int k = 8 * kb + 2 * p;
      const float* src = p_tab + (int64_t)row * K + k;
      const float v0 = (row < nP && k < K) ? src[0] : 0.f;
      const float v1 = (row < nP && k + 1 < K) ? src[1] : 0.f;
      if constexpr (SPLIT) split2(v0, v1, a_hi[kb][h], a_lo[kb][h]);
      else a_hi[kb][h] = pack_bf16_rn(v0, v1);
    }
  }

  const int n_tiles = (nQ + BQ - 1) / BQ;
  const int t0 = blockIdx.y * tiles_per_split;
  const int n_my = max(min(t0 + tiles_per_split, n_tiles) - t0, 0);

  auto load_tile = [&](int t, int s) {
    const uint32_t st = smem_base + s * stage_bytes;
    const int q0 = t * BQ;
    const int grow0 = ITEM ? q0 : p0, gcol0 = ITEM ? p0 : q0;
    constexpr int XCH = CELL_COLS / 8;  // 16-byte chunks a bf16 cell row
    for (int e = tid; e < CELL_ROWS * XCH; e += THREADS) {
      const int r = e / XCH, ch = e % XCH;
      const int gr = grow0 + r, gc = gcol0 + ch * 8;
      const bool ok = gr < rows && gc < hip;
      const int64_t off = ok ? (int64_t)gr * hip + gc : 0;
      const int nb = ok ? 16 : 0;
      const uint32_t d = st + r * CS + ch * 16;
      cp_async16<PREFETCH>(d, x_hi + off, nb);
      if (has_lo) cp_async16<PREFETCH>(d + OFF_XLO, x_lo + off, nb);
      if (!M_F32)
        cp_async16<PREFETCH>(d + OFF_M, static_cast<const uint16_t*>(m_ptr) + off, nb);
    }
    if (M_F32) {
      constexpr int MCH = CELL_COLS / 4;
      for (int e = tid; e < CELL_ROWS * MCH; e += THREADS) {
        const int r = e / MCH, ch = e % MCH;
        const int gr = grow0 + r, gc = gcol0 + ch * 4;
        const bool ok = gr < rows && gc < hip;
        const int64_t off = ok ? (int64_t)gr * hip + gc : 0;
        cp_async16<PREFETCH>(st + OFF_M + r * MS + ch * 16,
                             static_cast<const float*>(m_ptr) + off, ok ? 16 : 0);
      }
    }
    for (int e = tid; e < Q_PLANES * BQ * NT; e += THREADS) {
      const int pl = e / (BQ * NT), rem = e % (BQ * NT);
      const int r = rem / NT, ch = rem % NT;
      const int gq = q0 + r;
      const bool ok = gq < nQ;
      const int64_t off = ok ? (int64_t)gq * KD + ch * 8 : 0;
      cp_async16<false>(st + OFF_Q + pl * Q_BYTES + r * QS + ch * 16,
                        (pl ? q_lo : q_hi) + off, ok ? 16 : 0);
    }
  };

  float ow[NG][4], om[NG][4];
#pragma unroll
  for (int f = 0; f < NG; ++f) {
#pragma unroll
    for (int i = 0; i < 4; ++i) { ow[f][i] = 0.f; om[f][i] = 0.f; }
  }

  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_my) load_tile(t0 + s, s);
    cp_async_commit();
  }
  int s_cur = 0;  // stage of tile `it`
  for (int it = 0; it < n_my; ++it) {
    cp_async_wait<STAGES - 2>();  // tile `it` has landed (this thread's part)
    __syncthreads();  // everyone's part has; and tile it-1's stage is free
    {
      const int nx = it + STAGES - 1;
      const int s_nx = s_cur == 0 ? STAGES - 1 : s_cur - 1;
      if (nx < n_my) load_tile(t0 + nx, s_nx);
      cp_async_commit();
    }
    const unsigned char* stp = smem + s_cur * stage_bytes;
    const uint32_t st = smem_base + s_cur * stage_bytes;
    s_cur = s_cur + 1 == STAGES ? 0 : s_cur + 1;

    // acc[c][j] = P Q^T for Q rows 16c + 8j .. + 7 (n8 tile j): the depth
    // in k16 steps and, for an odd NT, one k8 step; TERMS terms.  One mma
    // chain a 4-block slice of the depth, the slices added with float adds.
    float acc[NC][2][4];
    auto first_product = [&](int c) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          uint32_t bh[4], bl[4];  // one register a k block (blocks >= NT repeat the last)
          const uint32_t addr = st + OFF_Q + (16 * c + 8 * j + lr) * QS
                                + min(4 * q + mi, NT - 1) * 16;
          ldsm_x4(addr, bh);
          if constexpr (SPLIT) ldsm_x4(addr + Q_BYTES, bl);
          float t[4];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int kb = 4 * q + 2 * h;
            if constexpr (!SPLIT) {
              if (kb + 1 < NT) {
                if (h == 0)
                  mma16_z(t, a_hi[kb][0], a_hi[kb][1], a_hi[kb + 1][0], a_hi[kb + 1][1],
                          bh[2 * h], bh[2 * h + 1]);
                else
                  mma16(t, a_hi[kb][0], a_hi[kb][1], a_hi[kb + 1][0], a_hi[kb + 1][1],
                        bh[2 * h], bh[2 * h + 1]);
              } else if (kb < NT) {
                if (h == 0) mma8_z(t, a_hi[kb][0], a_hi[kb][1], bh[2 * h]);
                else mma8(t, a_hi[kb][0], a_hi[kb][1], bh[2 * h]);
              }
            } else if (kb + 1 < NT) {
              if (h == 0)
                mma16_z(t, a_lo[kb][0], a_lo[kb][1], a_lo[kb + 1][0], a_lo[kb + 1][1],
                        bh[2 * h], bh[2 * h + 1]);
              else
                mma16(t, a_lo[kb][0], a_lo[kb][1], a_lo[kb + 1][0], a_lo[kb + 1][1],
                      bh[2 * h], bh[2 * h + 1]);
              mma16(t, a_hi[kb][0], a_hi[kb][1], a_hi[kb + 1][0], a_hi[kb + 1][1],
                    bl[2 * h], bl[2 * h + 1]);
              mma16(t, a_hi[kb][0], a_hi[kb][1], a_hi[kb + 1][0], a_hi[kb + 1][1],
                    bh[2 * h], bh[2 * h + 1]);
            } else if (kb < NT) {
              if (h == 0) mma8_z(t, a_lo[kb][0], a_lo[kb][1], bh[2 * h]);
              else mma8(t, a_lo[kb][0], a_lo[kb][1], bh[2 * h]);
              mma8(t, a_hi[kb][0], a_hi[kb][1], bl[2 * h]);
              mma8(t, a_hi[kb][0], a_hi[kb][1], bh[2 * h]);
            }
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[c][j][i] = q == 0 ? t[i] : acc[c][j][i] + t[i];
        }
      }
    };

    float tw[NG][4], tm[NG][4];  // chain temporaries of the second product
    first_product(0);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      // X and M at the accumulator's positions: register i = 2j + h holds
      // P row g + 8h, Q rows 16c + 8j + 2p + {0, 1}.
      const int crow = ITEM ? 16 * c + 8 * (mi >> 1) + lr : warp * 16 + 8 * (mi & 1) + lr;
      const int ccol = ITEM ? warp * 16 + 8 * (mi & 1) : 16 * c + 8 * (mi >> 1);
      const uint32_t caddr = st + crow * CS + ccol * 2;
      uint32_t xr[4], xl[4], mr[4];
      if (ITEM) ldsm_x4_t(caddr, xr); else ldsm_x4(caddr, xr);
      if (has_lo) {
        if (ITEM) ldsm_x4_t(caddr + OFF_XLO, xl); else ldsm_x4(caddr + OFF_XLO, xl);
      }
      if (!M_F32) {
        if (ITEM) ldsm_x4_t(caddr + OFF_M, mr); else ldsm_x4(caddr + OFF_M, mr);
      }
      // The next chunk's first product goes to the tensor cores before
      // this chunk's elementwise work, which does not depend on it.
      if (c + 1 < NC) first_product(c + 1);
      uint32_t w_hi[4], w_lo[4], m_hi[4], m_lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = i >> 1, h = i & 1;
        float x0 = bf16_lo(xr[i]), x1 = bf16_hi(xr[i]);
        if (has_lo) { x0 += bf16_lo(xl[i]); x1 += bf16_hi(xl[i]); }
        const float w0 = __fdividef(x0, fmaxf(acc[c][j][2 * h], rate_floor));
        const float w1 = __fdividef(x1, fmaxf(acc[c][j][2 * h + 1], rate_floor));
        if constexpr (SPLIT) split2(w0, w1, w_hi[i], w_lo[i]);
        else w_hi[i] = pack_bf16_rn(w0, w1);
        // Empty cells are masked after the split, both halves of a register
        // at once (which also drops what 0 / 0 left there).
        uint32_t keep;
        if (M_F32) {
          const unsigned char* mp = stp + OFF_M;
          float m0, m1;
          if (ITEM) {
            const int r0 = 16 * c + 8 * j + 2 * p, col = warp * 16 + g + 8 * h;
            m0 = *reinterpret_cast<const float*>(mp + r0 * MS + col * 4);
            m1 = *reinterpret_cast<const float*>(mp + (r0 + 1) * MS + col * 4);
          } else {
            const int r0 = warp * 16 + g + 8 * h, col = 16 * c + 8 * j + 2 * p;
            const float2 mm = *reinterpret_cast<const float2*>(mp + r0 * MS + col * 4);
            m0 = mm.x; m1 = mm.y;
          }
          if constexpr (SPLIT) split2(m0, m1, m_hi[i], m_lo[i]);
          else m_hi[i] = pack_bf16_rn(m0, m1);
          keep = (m0 > 0.f ? 0x0000ffffu : 0u) | (m1 > 0.f ? 0xffff0000u : 0u);
        } else {
          const uint32_t zero = 0u;
          m_hi[i] = mr[i];
          keep = __hgt2_mask(*reinterpret_cast<const __nv_bfloat162*>(&mr[i]),
                             *reinterpret_cast<const __nv_bfloat162*>(&zero));
        }
        w_hi[i] &= keep;
        if constexpr (SPLIT) w_lo[i] &= keep;
      }

      // out[f] += [W | M] (16 x 16) * Q (16 rows x factors 8 (zb + f) .. + 7).
#pragma unroll
      for (int f = 0; f < NG; f += 2) {
        uint32_t bh[4], bl[4];
        const uint32_t addr = st + OFF_Q + (16 * c + 8 * (mi & 1) + lr) * QS
                              + min(zb + f + (mi >> 1), NT - 1) * 16;
        if (f + 1 < NG) {
          ldsm_x4_t(addr, bh);
          if constexpr (SPLIT) ldsm_x4_t(addr + Q_BYTES, bl);
        } else {
          ldsm_x2_t(addr, bh[0], bh[1]);
          if constexpr (SPLIT) ldsm_x2_t(addr + Q_BYTES, bl[0], bl[1]);
        }
#pragma unroll
        for (int ff = 0; ff < 2; ++ff) {
          if (f + ff < NG) {
            // One mma chain a tile from a zero accumulator, then float
            // adds: the tensor core's accumulator truncates, and a chain as
            // long as the reduction axis would lose 6e-8 of the sum a step.
            const uint32_t h0 = bh[2 * ff], h1 = bh[2 * ff + 1];
            if constexpr (!SPLIT) {
              if (c == 0) {
                mma16_z(tw[f + ff], w_hi, h0, h1);
                mma16_z(tm[f + ff], m_hi, h0, h1);
              } else {
                mma16(tw[f + ff], w_hi, h0, h1);
                mma16(tm[f + ff], m_hi, h0, h1);
              }
            } else {
              const uint32_t l0 = bl[2 * ff], l1 = bl[2 * ff + 1];
              if (c == 0) {
                mma16_z(tw[f + ff], w_lo, h0, h1);
                if (M_F32) mma16_z(tm[f + ff], m_lo, h0, h1);
                else mma16_z(tm[f + ff], m_hi, l0, l1);
              } else {
                mma16(tw[f + ff], w_lo, h0, h1);
                if (M_F32) mma16(tm[f + ff], m_lo, h0, h1);
                else mma16(tm[f + ff], m_hi, l0, l1);
              }
              mma16(tw[f + ff], w_hi, l0, l1);
              mma16(tw[f + ff], w_hi, h0, h1);
              if (M_F32) mma16(tm[f + ff], m_hi, l0, l1);
              mma16(tm[f + ff], m_hi, h0, h1);
            }
            if (c == NC - 1) {
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                ow[f + ff][i] += tw[f + ff][i];
                om[f + ff][i] += tm[f + ff][i];
              }
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int f = 0; f < NG; ++f) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = p0 + warp * 16 + g + 8 * (i >> 1);
      const int k = 8 * (zb + f) + 2 * p + (i & 1);
      if (row < nP && k < K) {
        float* out = dst + ((int64_t)blockIdx.y * nP + row) * 2 * K;
        out[k] = ow[f][i];
        out[K + k] = om[f][i];
      }
    }
  }
}

// planes: the Q table's hi and lo planes, (nQ, 8 NT) bf16 each.
template <int NT, bool M_F32, int TERMS>
__global__ void __launch_bounds__(kThreads, NT > kGroupBlocks ? kMinCtasWide : kMinCtas)
head_user_kernel(const float* __restrict__ theta, const uint16_t* __restrict__ planes,
                 const uint16_t* __restrict__ x_hi, const uint16_t* __restrict__ x_lo,
                 const void* __restrict__ m, int rows, int hip, int K, float rate_floor,
                 int tiles_per_split, float* __restrict__ dst) {
  head_tile_body<NT, M_F32, false, TERMS>(theta, planes, planes + (int64_t)hip * 8 * NT, x_hi,
                                   x_lo, m, rows, hip, K, rate_floor, tiles_per_split, dst);
}

template <int NT, bool M_F32, int TERMS>
__global__ void __launch_bounds__(kThreads, NT > kGroupBlocks ? kMinCtasWide : kMinCtas)
head_item_kernel(const float* __restrict__ beta, const uint16_t* __restrict__ planes,
                 const uint16_t* __restrict__ x_hi, const uint16_t* __restrict__ x_lo,
                 const void* __restrict__ m, int rows, int hip, int K, float rate_floor,
                 int tiles_per_split, float* __restrict__ dst) {
  head_tile_body<NT, M_F32, true, TERMS>(beta, planes, planes + (int64_t)rows * 8 * NT, x_hi,
                                  x_lo, m, rows, hip, K, rate_floor, tiles_per_split, dst);
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

// Dynamic shared memory of one stage.  ops/dense_head.py::stage_bytes is a
// copy for the launch plan's reckoning of resident CTAs; the launch uses
// this one.
constexpr int stage_bytes_of(int nt, bool m_f32, bool has_lo, bool item, int terms) {
  const int bq = kBQ;
  const int cell_rows = item ? bq : kPT, cell_cols = item ? kPT : bq;
  const int cs = cell_cols * 2 + 16;
  const int ms = m_f32 ? cell_cols * 4 + (item ? 16 : 32) : cs;
  return cell_rows * cs * (has_lo ? 2 : 1) + cell_rows * ms
         + (terms == 3 ? 2 : 1) * bq * q_stride(nt);
}

template <int NT, bool M_F32, int TERMS>
cudaError_t launch(const float* p_tab, const uint16_t* planes, const uint16_t* x_hi,
                   const uint16_t* x_lo, const void* m, int rows, int hip, int K,
                   float floor, int item_side, int n_splits, float* dst,
                   cudaStream_t stream) {
  const int smem_bytes =
      kStages * stage_bytes_of(NT, M_F32, x_lo != nullptr, item_side != 0, TERMS);
  const int nP = item_side ? hip : rows, nQ = item_side ? rows : hip;
  const int n_tiles = (nQ + kBQ - 1) / kBQ;
  const int per = (n_tiles + n_splits - 1) / n_splits;
  dim3 grid((nP + kPT - 1) / kPT, n_splits, NT > kGroupBlocks ? NT / kGroupBlocks : 1);
  auto kernel = item_side ? head_item_kernel<NT, M_F32, TERMS>
                          : head_user_kernel<NT, M_F32, TERMS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem_bytes, stream>>>(
      p_tab, planes, x_hi, x_lo, m, rows, hip, K, floor, per, dst);
  return cudaGetLastError();
}

template <int TERMS, typename... Args>
cudaError_t launch_nt(int K, int m_is_f32, Args... args) {
#define PMF_CASE(N)                                                 \
  case N:                                                           \
    return m_is_f32 ? launch<N, true, TERMS>(args...) : launch<N, false, TERMS>(args...);
  switch (nt_of(K)) {
    PMF_CASE(1) PMF_CASE(2) PMF_CASE(3) PMF_CASE(4) PMF_CASE(8) PMF_CASE(12) PMF_CASE(16)
    default: return cudaErrorInvalidValue;
  }
#undef PMF_CASE
}

// planes: scratch for the streamed table's planes, TERMS == 3: hi and lo,
// 2 * n * 8 * nt_of(K) bf16; TERMS == 1: hi only, n * 8 * nt_of(K); with
// n = hip (user side) or rows.
template <int TERMS>
int dense_head_tier(const float* theta, const float* beta, const void* x_hi,
                    const void* x_lo, const void* m, int m_is_f32, int rows, int hip,
                    int K, float rate_floor, int item_side, int n_splits, void* planes,
                    float* partial, float* out, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (K < 1 || K > 128 || n_splits < 1)
    return (int)cudaErrorInvalidValue;
  const int KD = 8 * nt_of(K);
  uint16_t* pl = static_cast<uint16_t*>(planes);
  const float* p_tab = item_side ? beta : theta;
  {
    const int nQ = item_side ? rows : hip;
    const int64_t n = (int64_t)nQ * KD;
    const int threads = 256;
    const int64_t want = (n + threads - 1) / threads;
    split_planes_kernel<<<(int)(want < 2048 ? want : 2048), threads, 0, stream>>>(
        item_side ? theta : beta, nQ, K, KD, TERMS == 3, pl);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const uint16_t* xh = static_cast<const uint16_t*>(x_hi);
  const uint16_t* xl = static_cast<const uint16_t*>(x_lo);
  float* dst = n_splits > 1 ? partial : out;
  cudaError_t err = launch_nt<TERMS>(K, m_is_f32, p_tab, pl, xh, xl, m, rows, hip, K,
                                     rate_floor, item_side, n_splits, dst, stream);
  if (err != cudaSuccess || n_splits <= 1) return (int)err;
  const int64_t n = (int64_t)(item_side ? hip : rows) * 2 * K;
  const int threads = 256;
  const int64_t want = (n + threads - 1) / threads;
  const int blocks = want < 4096 ? (int)want : 4096;
  sum_partials_kernel<<<blocks, threads, 0, stream>>>(partial, n_splits, n, out);
  return (int)cudaGetLastError();
}

}  // namespace

// theta (rows, K) f32, beta (hip, K) f32, x_hi/x_lo (rows, hip) bf16 bits
// (x_lo may be null), m (rows, hip) bf16 or f32.  hip % 64 == 0, K <= 128.
// planes: scratch for the streamed table's hi and lo planes,
// 2 * n * 8 * nt_of(K) bf16 with n = hip (user side) or rows.
// n_splits > 1 needs partial (n_splits * out_rows * 2K floats).
extern "C" int pmf_dense_head_tier(const float* theta, const float* beta,
                                   const void* x_hi, const void* x_lo,
                                   const void* m, int m_is_f32, int rows,
                                   int hip, int K, float rate_floor,
                                   int item_side, int n_splits, void* planes,
                                   float* partial, float* out, void* stream_ptr) {
  return dense_head_tier<3>(theta, beta, x_hi, x_lo, m, m_is_f32, rows, hip, K, rate_floor,
                            item_side, n_splits, planes, partial, out, stream_ptr);
}

// The same at precision "fast": one RN bf16 plane an operand, one term a
// product; planes holds the streamed table's hi plane only, n * 8 * nt_of(K).
extern "C" int pmf_dense_head_tier_fast(const float* theta, const float* beta,
                                        const void* x_hi, const void* x_lo,
                                        const void* m, int m_is_f32, int rows,
                                        int hip, int K, float rate_floor,
                                        int item_side, int n_splits, void* planes,
                                        float* partial, float* out, void* stream_ptr) {
  return dense_head_tier<1>(theta, beta, x_hi, x_lo, m, m_is_f32, rows, hip, K, rate_floor,
                            item_side, n_splits, planes, partial, out, stream_ptr);
}
