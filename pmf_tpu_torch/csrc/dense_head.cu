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
//  * K > 32 (head_pass_kernel): R and W once per cell tile, for every
//    output of up to kPassMaxK = 160 factors.  One CTA of 8 warps a P tile;
//    the depth pads to ND = ceil(K / 160) chunks of CW factors (CW = 64,
//    96, 128 or 160) and pass z (grid.z) keeps the outputs of chunk z, so
//    K <= 160 is one pass over the cells and a larger K ceil(K / 160).  P's
//    and Q's planes are split once a launch by split_planes_kernel.  Per
//    cell tile each warp takes a 16 x 16 piece of R from shared memory by
//    ldmatrix (P resident, Q staged), turns it into W, and stores W's
//    planes (and a float32 M's) into a W tile in shared memory; after one
//    __syncthreads each warp takes [W | M] Q over 32 rows and a quarter of
//    the pass's output blocks, CW / 2 float sums a thread, a bf16 M read
//    straight from the staged cells.  Chains stay those of the form up to
//    K = 32: 32 factors of R a chain, the second product one chain a tile.
//    Its comment holds the design.  At K = 50 and 160 on the benchmark's
//    tiers (H100 80GB HBM3 at 700 W, chip_smoke.py phases "bigk timing"
//    and "huge timing"): 6.38 and 14.78 ms a sweep, where the output groups
//    that each took R again took 7.72 and 56.76.  126-128 registers at a
//    64-factor chunk (two CTAs an SM), 157-244 wider (one), no spills with
//    P resident; three of the P-in-the-ring instances at 160 spill 4-20
//    bytes.
//  * mma.sync, not wgmma, for both products.  A wgmma second product (each
//    warp's W rows as register A fragments, Q's chunk staged as 8 x 8
//    core matrices for B, issued and waited once a tile) measured slower,
//    6.93 and 15.68 ms a sweep at K = 50 and 160, and a tile loop that
//    overlapped one tile's second product with the next tile's first
//    product, with one barrier a tile, moved neither by more than a few
//    percent.  A wgmma first product (64 x 32 at depth K, N = 32) was not
//    built: timed with its parts compiled out, the kernel spends about
//    half its time at K = 50 and a third at K = 160 in the staging ring
//    alone (the cell tiles, Q's chunk read again from L2 for every P
//    tile, two barriers a tile), and the first product a quarter to a
//    third (1.7 of 6.4 ms at K = 50, 4.3 of 14.5 at K = 160), overlapping
//    little with the ring; a faster tensor instruction for it can take at
//    most that share (PERF.md).  Fewer bytes through the ring (larger P
//    tiles, Q shared between CTAs) and overlap come before the tensor
//    instruction.
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
constexpr int kMaxStages = 4;  // the most a ring of the pass form takes
constexpr int kThreads = kWarps * 32;
constexpr int kPT = kWarps * 16;  // rows of P a CTA
constexpr int kMinCtas = 3;  // resident CTAs the launch bounds keep room for (168 registers)
constexpr int kSmemPerCta = 232448;  // dynamic shared memory a CTA may ask for
constexpr int kSmemPerSm = 233472;  // of which every resident CTA reserves kSmemReserved
constexpr int kSmemReserved = 1024;

// Blocks of 8 in the depth of the form up to K = 32.
__host__ __device__ constexpr int nt_of(int k) { return (k + 7) / 8; }

// Shared-memory row stride of a Q plane of NT 8-column blocks: 16 * NT
// bytes, padded where that is an even number of 16-byte slots, so that the
// 8 rows of an ldmatrix fall in distinct banks.
__host__ __device__ constexpr int q_stride(int nt) { return 16 * nt + (nt % 2 ? 0 : 16); }

// The steps on a staged cell tile that both forms (head_tile_body and
// head_pass_kernel) take.  A stage holds the X hi plane at 0, M at OFF_M
// and the X lo plane at OFF_XLO; ROWS x COLS cells, rows of CS
// bytes (bf16) and of MS bytes for M.
template <bool ITEM, bool M_F32>
struct CellTile {
  static constexpr int ROWS = ITEM ? kBQ : kPT;
  static constexpr int COLS = ITEM ? kPT : kBQ;
  static constexpr int CS = COLS * 2 + 16;
  static constexpr int MS = M_F32 ? COLS * 4 + (ITEM ? 16 : 32) : CS;
  static constexpr int X_BYTES = ROWS * CS;
  static constexpr int M_BYTES = ROWS * MS;
};

// Copy the cells of rows grow0.., columns gcol0.. of the (rows, hip)
// planes into the stage at `st` with THREADS threads, zero past their edges.  The user side
// walks along the cell rows in pieces of 2 * BQ bytes: it asks the L2 for
// the whole 256 bytes the next tiles will want.
template <bool ITEM, bool M_F32, int OFF_M, int OFF_XLO, int THREADS = kThreads>
__device__ __forceinline__ void load_cells(uint32_t st, int grow0, int gcol0, int rows, int hip,
                                           const uint16_t* __restrict__ x_hi,
                                           const uint16_t* __restrict__ x_lo,
                                           const void* __restrict__ m_ptr, int tid) {
  using T = CellTile<ITEM, M_F32>;
  constexpr bool PREFETCH = !ITEM;
  const bool has_lo = x_lo != nullptr;
  constexpr int XCH = T::COLS / 8;  // 16-byte chunks a bf16 cell row
  for (int e = tid; e < T::ROWS * XCH; e += THREADS) {
    const int r = e / XCH, ch = e % XCH;
    const int gr = grow0 + r, gc = gcol0 + ch * 8;
    const bool ok = gr < rows && gc < hip;
    const int64_t off = ok ? (int64_t)gr * hip + gc : 0;
    const int nb = ok ? 16 : 0;
    const uint32_t d = st + r * T::CS + ch * 16;
    cp_async16<PREFETCH>(d, x_hi + off, nb);
    if (has_lo) cp_async16<PREFETCH>(d + OFF_XLO, x_lo + off, nb);
    if (!M_F32)
      cp_async16<PREFETCH>(d + OFF_M, static_cast<const uint16_t*>(m_ptr) + off, nb);
  }
  if (M_F32) {
    constexpr int MCH = T::COLS / 4;
    for (int e = tid; e < T::ROWS * MCH; e += THREADS) {
      const int r = e / MCH, ch = e % MCH;
      const int gr = grow0 + r, gc = gcol0 + ch * 4;
      const bool ok = gr < rows && gc < hip;
      const int64_t off = ok ? (int64_t)gr * hip + gc : 0;
      cp_async16<PREFETCH>(st + OFF_M + r * T::MS + ch * 16,
                           static_cast<const float*>(m_ptr) + off, ok ? 16 : 0);
    }
  }
}

// X (both planes) and bf16 M of chunk c of the staged tile at the
// accumulator's positions: register i = 2j + h holds P row g + 8h, Q rows
// 16c + 8j + 2p + {0, 1}.
template <bool ITEM, bool M_F32, int OFF_M, int OFF_XLO>
__device__ __forceinline__ void cell_fragments(uint32_t st, int c, int warp, int mi, int lr,
                                               bool has_lo, uint32_t (&xr)[4],
                                               uint32_t (&xl)[4], uint32_t (&mr)[4]) {
  const int crow = ITEM ? 16 * c + 8 * (mi >> 1) + lr : warp * 16 + 8 * (mi & 1) + lr;
  const int ccol = ITEM ? warp * 16 + 8 * (mi & 1) : 16 * c + 8 * (mi >> 1);
  const uint32_t caddr = st + crow * CellTile<ITEM, M_F32>::CS + ccol * 2;
  if (ITEM) ldsm_x4_t(caddr, xr); else ldsm_x4(caddr, xr);
  if (has_lo) {
    if (ITEM) ldsm_x4_t(caddr + OFF_XLO, xl); else ldsm_x4(caddr + OFF_XLO, xl);
  }
  if (!M_F32) {
    if (ITEM) ldsm_x4_t(caddr + OFF_M, mr); else ldsm_x4(caddr + OFF_M, mr);
  }
}

// W = where(M > 0, X / max(R, floor), 0) at the fragments' cells, R = `r`
// (chunk c's accumulators), as A fragments: hi and lo planes (SPLIT) or
// one RN plane, and M's (float32 M read from the stage at `stp`).
template <bool ITEM, bool M_F32, bool SPLIT, int OFF_M>
__device__ __forceinline__ void w_and_m(const unsigned char* stp, int c, int warp, int g, int p,
                                        bool has_lo, const uint32_t (&xr)[4],
                                        const uint32_t (&xl)[4], const uint32_t (&mr)[4],
                                        const float (&r)[2][4], float rate_floor,
                                        uint32_t (&w_hi)[4], uint32_t (&w_lo)[4],
                                        uint32_t (&m_hi)[4], uint32_t (&m_lo)[4]) {
  constexpr int MS = CellTile<ITEM, M_F32>::MS;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int j = i >> 1, h = i & 1;
    float x0 = bf16_lo(xr[i]), x1 = bf16_hi(xr[i]);
    if (has_lo) { x0 += bf16_lo(xl[i]); x1 += bf16_hi(xl[i]); }
    const float w0 = __fdividef(x0, fmaxf(r[j][2 * h], rate_floor));
    const float w1 = __fdividef(x1, fmaxf(r[j][2 * h + 1], rate_floor));
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
}

// t{w,m}[f] (+)= [W | M] (16 x 16) * Q (16 rows x the 8 factors of output
// block f), f < NG, for chunk c of NC.  `q_row`: Q row 16c + 8(mi & 1) + lr
// in the staged hi plane, the lo plane `q_plane` bytes on; block f at
// 16-byte slot min(blk0 + f + (mi >> 1), last).  One mma chain a tile from
// a zero accumulator (c == 0), added into o{w,m} with float adds at the
// last chunk: the tensor core's accumulator truncates, and a chain as long
// as the reduction axis would lose 6e-8 of the sum a step.
template <int NG, int NC, bool M_F32, bool SPLIT>
__device__ __forceinline__ void second_product(
    int c, uint32_t q_row, int q_plane, int blk0, int last, int mi,
    const uint32_t (&w_hi)[4], const uint32_t (&w_lo)[4], const uint32_t (&m_hi)[4],
    const uint32_t (&m_lo)[4], float (&tw)[NG][4], float (&tm)[NG][4], float (&ow)[NG][4],
    float (&om)[NG][4]) {
#pragma unroll
  for (int f = 0; f < NG; f += 2) {
    uint32_t bh[4], bl[4];
    const uint32_t addr = q_row + min(blk0 + f + (mi >> 1), last) * 16;
    if (f + 1 < NG) {
      ldsm_x4_t(addr, bh);
      if constexpr (SPLIT) ldsm_x4_t(addr + q_plane, bl);
    } else {
      ldsm_x2_t(addr, bh[0], bh[1]);
      if constexpr (SPLIT) ldsm_x2_t(addr + q_plane, bl[0], bl[1]);
    }
#pragma unroll
    for (int ff = 0; ff < 2; ++ff) {
      if (f + ff < NG) {
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

// One CTA: kPT rows of P against its split's Q tiles of kBQ rows.  K pads
// to NT blocks of 8 (NT <= 4), in depth for the first product and in
// width for the second.  TERMS = 3: every f32 operand as hi and lo planes, three
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
  constexpr int NQ = (NT + 3) / 4;  // ldmatrix.x4 loads of Q's depth a row
  constexpr int QS = q_stride(NT);
  constexpr int X_BYTES = CellTile<ITEM, M_F32>::X_BYTES;
  constexpr int M_BYTES = CellTile<ITEM, M_F32>::M_BYTES;
  constexpr int Q_BYTES = BQ * QS;
  constexpr int OFF_M = X_BYTES;
  constexpr int OFF_Q = X_BYTES + M_BYTES;
  constexpr bool SPLIT = TERMS == 3;
  static_assert(TERMS == 3 || TERMS == 1, "three terms or one");
  constexpr int Q_PLANES = SPLIT ? 2 : 1;
  constexpr int OFF_XLO = OFF_Q + Q_PLANES * Q_BYTES;

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
    load_cells<ITEM, M_F32, OFF_M, OFF_XLO>(st, ITEM ? q0 : p0, ITEM ? p0 : q0, rows, hip,
                                            x_hi, x_lo, m_ptr, tid);
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

  float ow[NT][4], om[NT][4];
#pragma unroll
  for (int f = 0; f < NT; ++f) {
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

    float tw[NT][4], tm[NT][4];  // chain temporaries of the second product
    first_product(0);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      uint32_t xr[4], xl[4], mr[4];
      cell_fragments<ITEM, M_F32, OFF_M, OFF_XLO>(st, c, warp, mi, lr, has_lo, xr, xl, mr);
      // The next chunk's first product goes to the tensor cores before
      // this chunk's elementwise work, which does not depend on it.
      if (c + 1 < NC) first_product(c + 1);
      uint32_t w_hi[4], w_lo[4], m_hi[4], m_lo[4];
      w_and_m<ITEM, M_F32, SPLIT, OFF_M>(stp, c, warp, g, p, has_lo, xr, xl, mr, acc[c],
                                         rate_floor, w_hi, w_lo, m_hi, m_lo);
      // out[f] += [W | M] (16 x 16) * Q (16 rows x factors 8 f .. + 7).
      second_product<NT, NC, M_F32, SPLIT>(
          c, st + OFF_Q + (16 * c + 8 * (mi & 1) + lr) * QS, Q_BYTES, 0, NT - 1, mi, w_hi,
          w_lo, m_hi, m_lo, tw, tm, ow, om);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int f = 0; f < NT; ++f) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = p0 + warp * 16 + g + 8 * (i >> 1);
      const int k = 8 * f + 2 * p + (i & 1);
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
__global__ void __launch_bounds__(kThreads, kMinCtas)
head_user_kernel(const float* __restrict__ theta, const uint16_t* __restrict__ planes,
                 const uint16_t* __restrict__ x_hi, const uint16_t* __restrict__ x_lo,
                 const void* __restrict__ m, int rows, int hip, int K, float rate_floor,
                 int tiles_per_split, float* __restrict__ dst) {
  head_tile_body<NT, M_F32, false, TERMS>(theta, planes, planes + (int64_t)hip * 8 * NT, x_hi,
                                   x_lo, m, rows, hip, K, rate_floor, tiles_per_split, dst);
}

template <int NT, bool M_F32, int TERMS>
__global__ void __launch_bounds__(kThreads, kMinCtas)
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
  dim3 grid((nP + kPT - 1) / kPT, n_splits);
  auto kernel = item_side ? head_item_kernel<NT, M_F32, TERMS>
                          : head_user_kernel<NT, M_F32, TERMS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem_bytes, stream>>>(
      p_tab, planes, x_hi, x_lo, m, rows, hip, K, floor, per, dst);
  return cudaGetLastError();
}

// K > 32 (head_pass_kernel): one CTA of kPassWarps warps a P tile, its
// outputs all in the CTA.  The depth pads to ND chunks of CW factors (CW a
// multiple of 32, at most kPassMaxK; ND = ceil(K / kPassMaxK)), and pass z
// (grid.z, ND of them) keeps the outputs of chunk z: one pass over the
// cells up to K = kPassMaxK.  A ring item is one depth chunk of one Q tile:
// Q's planes of the chunk (and P's, with P_RING); the chunks of a tile come
// in the order z + 1, ..., ND - 1, 0, ..., z, so the last item holds Q's
// columns of the pass and also stages the cell tile.  Per tile:
//  * R (kPT x kBQ): warp w sums rows 16 (w & 3) against Q rows 16 (w >> 2)
//    over the chunk, a zero-started chain of 32 factors (2 k16 steps a
//    term) at a time, added with float adds, across the tile's items too;
//  * at the tile's last item each warp turns its 16 x 16 piece of R into
//    W at the cell fragments' positions, as the K <= 32 form does, and
//    stores W's planes (hi, and lo where split; a float32 M's too)
//    row-major into the W tile in shared memory; one __syncthreads;
//  * the second product: warp w keeps rows 32 (w >> 2) .. + 31 (two m16
//    tiles) and the output blocks CW/32 (w & 3) .. + CW/32 - 1 of both
//    halves, [W | M] by ldmatrix from the W tile (a bf16 M from the staged
//    cells), Q's chunk by ldmatrix.trans: CW / 2 float sums a thread (80
//    at CW = 160), each tile's chains of 2 k16 steps started from zero.
// P's planes over the whole depth sit in shared memory for the CTA's walk,
// or, where they and three stages do not fit, ride the ring in chunks
// beside Q's with two stages (P_RING).  Otherwise the ring has as many
// stages, two to four, as keep the launch bounds' resident CTAs
// (pass_stages).
constexpr int kPassWarps = 8;
constexpr int kPassThreads = kPassWarps * 32;
constexpr int kPassMaxK = 160;  // output factors a pass keeps (CW at most)
constexpr int kWS = 2 * kBQ + 16;  // bytes a row of a W tile plane

// A bf16 M's A fragment for the second product, straight from the staged
// cell tile at `m_at`: P rows 16 rg .. + 15, Q rows 16 c .. + 15 (the
// positions cell_fragments reads).
template <bool ITEM>
__device__ __forceinline__ void m_cells(uint32_t m_at, int c, int rg, int mi, int lr,
                                        uint32_t (&mr)[4]) {
  const int crow = ITEM ? 16 * c + 8 * (mi >> 1) + lr : 16 * rg + 8 * (mi & 1) + lr;
  const int ccol = ITEM ? 16 * rg + 8 * (mi & 1) : 16 * c + 8 * (mi >> 1);
  const uint32_t addr = m_at + crow * CellTile<ITEM, false>::CS + ccol * 2;
  if (ITEM) ldsm_x4_t(addr, mr); else ldsm_x4(addr, mr);
}

// The depth's chunking past K = 32: ND chunks of CW factors.
__host__ __device__ constexpr int pass_chunks(int k) { return (k + kPassMaxK - 1) / kPassMaxK; }
__host__ __device__ constexpr int pass_width(int k) {
  return 32 * ((k + 32 * pass_chunks(k) - 1) / (32 * pass_chunks(k)));
}

// W tile planes: W hi (and lo where split), then for a float32 M its hi
// (and lo); a bf16 M is read from the staged cell tile.
__host__ __device__ constexpr int w_planes(bool m_f32, int terms) {
  return (terms == 3 ? 2 : 1) * (m_f32 ? 2 : 1);
}

template <int CW, bool M_F32, bool ITEM, int TERMS, bool P_RING>
__global__ void __launch_bounds__(kPassThreads, CW <= 64 ? 2 : 1)
head_pass_kernel(const uint16_t* __restrict__ p_planes, const uint16_t* __restrict__ q_planes,
                 const uint16_t* __restrict__ x_hi, const uint16_t* __restrict__ x_lo,
                 const void* __restrict__ m_ptr, int rows, int hip, int K, float rate_floor,
                 int tiles_per_split, int stages, float* __restrict__ dst) {
  constexpr int BQ = kBQ, PT = kPT, THREADS = kPassThreads;
  constexpr bool SPLIT = TERMS == 3;
  static_assert(TERMS == 3 || TERMS == 1, "three terms or one");
  static_assert(CW % 32 == 0 && CW <= kPassMaxK, "chunks of 32 factors");
  constexpr int PLANES = SPLIT ? 2 : 1;
  constexpr int CS = 2 * CW + 16;  // bytes a row of a staged chunk plane
  constexpr int NB = CW / 32;  // output blocks of 8 a warp keeps, of each half
  constexpr int X_BYTES = CellTile<ITEM, M_F32>::X_BYTES;
  constexpr int M_BYTES = CellTile<ITEM, M_F32>::M_BYTES;
  constexpr int QC_BYTES = BQ * CS;
  constexpr int PC_BYTES = PT * CS;
  constexpr int OFF_M = X_BYTES;
  constexpr int OFF_Q = X_BYTES + M_BYTES;
  constexpr int OFF_PC = OFF_Q + PLANES * QC_BYTES;
  constexpr int OFF_XLO = OFF_PC + (P_RING ? PLANES * PC_BYTES : 0);
  constexpr int WP_BYTES = PT * kWS;
  constexpr int W_BYTES = w_planes(M_F32, TERMS) * WP_BYTES;  // one W tile
  constexpr int OFF_WLO = WP_BYTES;  // W lo (split)
  constexpr int OFF_MHI = (SPLIT ? 2 : 1) * WP_BYTES;  // a float32 M's hi
  constexpr int OFF_MLO = OFF_MHI + WP_BYTES;  // and lo (split)

  extern __shared__ __align__(128) unsigned char smem[];
  const int nP = ITEM ? hip : rows, nQ = ITEM ? rows : hip;
  const int ND = pass_chunks(K);
  const int KD = CW * ND;
  const int PS = 2 * KD + 16;  // bytes a row of the resident P plane
  const int p_res_bytes = P_RING ? 0 : PLANES * PT * PS;
  const bool has_lo = x_lo != nullptr;
  const int stage_bytes = OFF_XLO + (has_lo ? X_BYTES : 0);
  const uint32_t smem_base = smem_u32(smem);
  const uint32_t wt = smem_base + p_res_bytes;  // the W tile
  unsigned char* ring = smem + p_res_bytes + W_BYTES;
  const uint32_t ring_base = smem_u32(ring);
  const uint16_t* p_lo = p_planes + (int64_t)nP * KD;
  const uint16_t* q_lo = q_planes + (int64_t)nQ * KD;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, p = lane & 3;
  const int mi = lane >> 3, lr = lane & 7;
  const int wr = warp & 3, wc = warp >> 2;  // R: P rows 16 wr, Q rows 16 wc
  const int sr = warp >> 2, sb = NB * (warp & 3);  // outputs: rows 32 sr, blocks sb..
  const int p0 = blockIdx.x * PT;
  const int z = blockIdx.z;  // pass: output factors CW z .. CW z + CW - 1

  const int n_tiles = (nQ + BQ - 1) / BQ;
  const int t0 = blockIdx.y * tiles_per_split;
  const int n_my = max(min(t0 + tiles_per_split, n_tiles) - t0, 0);
  const int n_items = n_my * ND;

  if constexpr (!P_RING) {  // the CTA's P rows, the whole depth, every plane
    const int per_plane = PT * (KD / 8);
    for (int e = tid; e < PLANES * per_plane; e += THREADS) {
      const int pl = e / per_plane, rem = e % per_plane;
      const int r = rem / (KD / 8), ch = rem % (KD / 8);
      const int gp = p0 + r;
      const bool ok = gp < nP;
      const int64_t off = ok ? (int64_t)gp * KD + ch * 8 : 0;
      cp_async16<false>(smem_base + pl * PT * PS + r * PS + ch * 16,
                        (pl ? p_lo : p_planes) + off, ok ? 16 : 0);
    }
  }

  // Item i: chunk d of tile t0 + i / ND; the tile's last item (d = z) also
  // brings the cell tile.
  auto chunk_of = [&](int i) { return (z + 1 + i % ND) % ND; };
  auto load_item = [&](int i, int s) {
    const uint32_t st = ring_base + s * stage_bytes;
    const int t = t0 + i / ND, d = chunk_of(i);
    const int q0 = t * BQ;
    constexpr int CH = CW / 8;  // 16-byte pieces a chunk row
    for (int e = tid; e < PLANES * BQ * CH; e += THREADS) {
      const int pl = e / (BQ * CH), rem = e % (BQ * CH);
      const int r = rem / CH, ch = rem % CH;
      const int gq = q0 + r;
      const bool ok = gq < nQ;
      const int64_t off = ok ? (int64_t)gq * KD + d * CW + ch * 8 : 0;
      cp_async16<false>(st + OFF_Q + pl * QC_BYTES + r * CS + ch * 16,
                        (pl ? q_lo : q_planes) + off, ok ? 16 : 0);
    }
    if constexpr (P_RING) {
      for (int e = tid; e < PLANES * PT * CH; e += THREADS) {
        const int pl = e / (PT * CH), rem = e % (PT * CH);
        const int r = rem / CH, ch = rem % CH;
        const int gp = p0 + r;
        const bool ok = gp < nP;
        const int64_t off = ok ? (int64_t)gp * KD + d * CW + ch * 8 : 0;
        cp_async16<false>(st + OFF_PC + pl * PC_BYTES + r * CS + ch * 16,
                          (pl ? p_lo : p_planes) + off, ok ? 16 : 0);
      }
    }
    if (i % ND != ND - 1) return;
    load_cells<ITEM, M_F32, OFF_M, OFF_XLO, THREADS>(st, ITEM ? q0 : p0, ITEM ? p0 : q0, rows,
                                                     hip, x_hi, x_lo, m_ptr, tid);
  };

  float ow[2][NB][4], om[2][NB][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int f = 0; f < NB; ++f)
#pragma unroll
      for (int i = 0; i < 4; ++i) { ow[mt][f][i] = 0.f; om[mt][f][i] = 0.f; }
  float acc[2][4];  // R for Q rows 16 wc + 8 j .. + 7 (n8 tile j)
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

  for (int s = 0; s < stages - 1; ++s) {
    if (s < n_items) load_item(s, s);
    cp_async_commit();  // the first group also carries the resident P
  }
  int s_cur = 0;
  for (int it = 0; it < n_items; ++it) {
    if (stages == 4) cp_async_wait<2>();  // item it has landed (this thread's part)
    else if (stages == 3) cp_async_wait<1>();
    else cp_async_wait<0>();
    __syncthreads();  // everyone's part has; the last item's stage and W tile are read
    {
      const int nx = it + stages - 1;
      const int s_nx = s_cur == 0 ? stages - 1 : s_cur - 1;
      if (nx < n_items) load_item(nx, s_nx);
      cp_async_commit();
    }
    const unsigned char* stp = ring + s_cur * stage_bytes;
    const uint32_t st = ring_base + s_cur * stage_bytes;
    s_cur = s_cur + 1 == stages ? 0 : s_cur + 1;
    const int dd = it % ND;

    // R += P_d Q_d^T over the chunk: ldmatrix of P's rows (A) and of Q's
    // rows (B: matrices j = 0, 1 at k 0-7 and 8-15), one zero-started
    // chain a 32 factors, added with float adds.
    uint32_t p_at, p_plane;
    if constexpr (P_RING) {
      p_at = st + OFF_PC + (16 * wr + (lane & 15)) * CS + 16 * (lane >> 4);
      p_plane = PC_BYTES;
    } else {
      p_at = smem_base + (16 * wr + (lane & 15)) * PS + 2 * CW * chunk_of(it) + 16 * (lane >> 4);
      p_plane = PT * PS;
    }
    const uint32_t q_at = st + OFF_Q + (16 * wc + 8 * (lane >> 4) + lr) * CS + 16 * (mi & 1);
#pragma unroll
    for (int kc = 0; kc < CW / 32; ++kc) {
      float t[2][4];
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const int col = 2 * (32 * kc + 16 * ks);  // bytes
        uint32_t ah[4], al[4], bh[4], bl[4];
        ldsm_x4(p_at + col, ah);
        ldsm_x4(q_at + col, bh);
        if constexpr (SPLIT) {
          ldsm_x4(p_at + p_plane + col, al);
          ldsm_x4(q_at + QC_BYTES + col, bl);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if constexpr (SPLIT) {
            if (ks == 0) mma16_z(t[j], al, bh[2 * j], bh[2 * j + 1]);
            else mma16(t[j], al, bh[2 * j], bh[2 * j + 1]);
            mma16(t[j], ah, bl[2 * j], bl[2 * j + 1]);
            mma16(t[j], ah, bh[2 * j], bh[2 * j + 1]);
          } else if (ks == 0) {
            mma16_z(t[j], ah, bh[2 * j], bh[2 * j + 1]);
          } else {
            mma16(t[j], ah, bh[2 * j], bh[2 * j + 1]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[j][i] = dd == 0 && kc == 0 ? t[j][i] : acc[j][i] + t[j][i];
    }
    if (dd != ND - 1) continue;

    // The tile's R is whole: W (and a float32 M's planes) at this warp's
    // 16 x 16 cells into the W tile, row-major by P row.
    {
      uint32_t xr[4], xl[4], mr[4];
      cell_fragments<ITEM, M_F32, OFF_M, OFF_XLO>(st, wc, wr, mi, lr, has_lo, xr, xl, mr);
      uint32_t w_hi[4], w_lo[4], m_hi[4], m_lo[4];
      w_and_m<ITEM, M_F32, SPLIT, OFF_M>(stp, wc, wr, g, p, has_lo, xr, xl, mr, acc,
                                         rate_floor, w_hi, w_lo, m_hi, m_lo);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = 16 * wr + g + 8 * (i & 1), col = 16 * wc + 8 * (i >> 1) + 2 * p;
        unsigned char* at = smem + p_res_bytes + row * kWS + 2 * col;
        *reinterpret_cast<uint32_t*>(at) = w_hi[i];
        if constexpr (SPLIT) *reinterpret_cast<uint32_t*>(at + OFF_WLO) = w_lo[i];
        if constexpr (M_F32) {
          *reinterpret_cast<uint32_t*>(at + OFF_MHI) = m_hi[i];
          if constexpr (SPLIT) *reinterpret_cast<uint32_t*>(at + OFF_MLO) = m_lo[i];
        }
      }
    }
    __syncthreads();

    // [W | M] (this warp's 32 rows) times Q's chunk, output blocks sb.. of
    // both halves: one chain a tile (2 k16 steps) from a zero accumulator,
    // added into o{w,m} with float adds.  A bf16 M comes straight from the
    // staged cell tile.
    float tw[NB][4], tm[NB][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const uint32_t a_at = wt + (32 * sr + 16 * mt + (lane & 15)) * kWS + 2 * (16 * c)
                              + 16 * (lane >> 4);
        uint32_t w_hi[4], w_lo[4], m_hi[4], m_lo[4];
        ldsm_x4(a_at, w_hi);
        if constexpr (SPLIT) ldsm_x4(a_at + OFF_WLO, w_lo);
        if constexpr (M_F32) {
          ldsm_x4(a_at + OFF_MHI, m_hi);
          if constexpr (SPLIT) ldsm_x4(a_at + OFF_MLO, m_lo);
        } else {
          m_cells<ITEM>(st + OFF_M, c, 2 * sr + mt, mi, lr, m_hi);
        }
        second_product<NB, 2, M_F32, SPLIT>(
            c, st + OFF_Q + (16 * c + 8 * (mi & 1) + lr) * CS, QC_BYTES, sb, sb + NB - 1, mi,
            w_hi, w_lo, m_hi, m_lo, tw, tm, ow[mt], om[mt]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int f = 0; f < NB; ++f) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = p0 + 32 * sr + 16 * mt + g + 8 * (i >> 1);
        const int k = CW * z + 8 * (sb + f) + 2 * p + (i & 1);
        if (row < nP && k < K) {
          float* out = dst + ((int64_t)blockIdx.y * nP + row) * 2 * K;
          out[k] = ow[mt][f][i];
          out[K + k] = om[mt][f][i];
        }
      }
    }
  }
}

// Shared memory of the form past K = 32: the resident P planes (none with
// P_RING), the W tile and the ring's stages.  ops/dense_head.py's
// pass_smem_bytes and pass_stages are copies.
constexpr int pass_stage_bytes(int cw, bool m_f32, bool has_lo, bool item, int terms,
                               bool p_ring) {
  const int cell_rows = item ? kBQ : kPT, cell_cols = item ? kPT : kBQ;
  const int cs = cell_cols * 2 + 16;
  const int ms = m_f32 ? cell_cols * 4 + (item ? 16 : 32) : cs;
  const int planes = terms == 3 ? 2 : 1;
  return cell_rows * cs * (has_lo ? 2 : 1) + cell_rows * ms
         + planes * (kBQ + (p_ring ? kPT : 0)) * (2 * cw + 16);
}
int64_t pass_smem_bytes(int K, bool m_f32, bool has_lo, bool item, int terms, bool p_ring,
                        int stages) {
  const int cw = pass_width(K), kd = cw * pass_chunks(K);
  const int64_t p_res = p_ring ? 0 : (int64_t)(terms == 3 ? 2 : 1) * kPT * (2 * kd + 16);
  return p_res + (int64_t)w_planes(m_f32, terms) * kPT * kWS
         + (int64_t)stages * pass_stage_bytes(cw, m_f32, has_lo, item, terms, p_ring);
}

// Stages of the ring: two where P rides the ring; else the most, from four
// down to two, that keep the launch bounds' resident CTAs (two at a chunk
// of 64 factors, one wider), or three where none does.
int pass_stages(int K, bool m_f32, bool has_lo, bool item, int terms, bool p_ring) {
  if (p_ring) return 2;
  const int64_t per_sm = kSmemPerSm / (pass_width(K) == 64 ? 2 : 1) - kSmemReserved;
  const int64_t room = per_sm < kSmemPerCta ? per_sm : kSmemPerCta;
  for (int stages = kMaxStages; stages >= 2; --stages)
    if (pass_smem_bytes(K, m_f32, has_lo, item, terms, false, stages) <= room) return stages;
  return kStages;
}

template <int CW, bool M_F32, int TERMS, bool P_RING>
cudaError_t launch_pass(const uint16_t* p_planes, const uint16_t* q_planes,
                        const uint16_t* x_hi, const uint16_t* x_lo, const void* m, int rows,
                        int hip, int K, float floor, int item_side, int n_splits, float* dst,
                        cudaStream_t stream) {
  const bool has_lo = x_lo != nullptr, item = item_side != 0;
  const int stages = pass_stages(K, M_F32, has_lo, item, TERMS, P_RING);
  const int smem_bytes = (int)pass_smem_bytes(K, M_F32, has_lo, item, TERMS, P_RING, stages);
  const int nP = item_side ? hip : rows, nQ = item_side ? rows : hip;
  const int n_tiles = (nQ + kBQ - 1) / kBQ;
  const int per = (n_tiles + n_splits - 1) / n_splits;
  dim3 grid((nP + kPT - 1) / kPT, n_splits, pass_chunks(K));
  auto kernel = item_side ? head_pass_kernel<CW, M_F32, true, TERMS, P_RING>
                          : head_pass_kernel<CW, M_F32, false, TERMS, P_RING>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kPassThreads, smem_bytes, stream>>>(p_planes, q_planes, x_hi, x_lo, m, rows,
                                                     hip, K, floor, per, stages, dst);
  return cudaGetLastError();
}

// Past K = 32: the instance of the chunk width, M's type and P's place.
// P rides the ring only past kPassMaxK (ND > 1), where CW >= 96.
template <int CW, int TERMS, typename... Args>
cudaError_t launch_pass_cw(int m_is_f32, bool p_ring, Args... args) {
  if constexpr (CW > 64) {
    if (p_ring)
      return m_is_f32 ? launch_pass<CW, true, TERMS, true>(args...)
                      : launch_pass<CW, false, TERMS, true>(args...);
  } else if (p_ring) {
    return cudaErrorInvalidValue;
  }
  return m_is_f32 ? launch_pass<CW, true, TERMS, false>(args...)
                  : launch_pass<CW, false, TERMS, false>(args...);
}

template <int TERMS, typename... Args>
cudaError_t launch_pass_for(int K, int m_is_f32, bool p_ring, Args... args) {
  switch (pass_width(K)) {
    case 64: return launch_pass_cw<64, TERMS>(m_is_f32, p_ring, args...);
    case 96: return launch_pass_cw<96, TERMS>(m_is_f32, p_ring, args...);
    case 128: return launch_pass_cw<128, TERMS>(m_is_f32, p_ring, args...);
    case 160: return launch_pass_cw<160, TERMS>(m_is_f32, p_ring, args...);
    default: return cudaErrorInvalidValue;
  }
}

template <int TERMS, typename... Args>
cudaError_t launch_nt(int K, int m_is_f32, Args... args) {
#define PMF_CASE(N)                                                 \
  case N:                                                           \
    return m_is_f32 ? launch<N, true, TERMS>(args...) : launch<N, false, TERMS>(args...);
  switch (nt_of(K)) {
    PMF_CASE(1) PMF_CASE(2) PMF_CASE(3) PMF_CASE(4)
    default: return cudaErrorInvalidValue;
  }
#undef PMF_CASE
}

// Columns of the bf16 planes: 8 nt_of(K) up to K = 32, then the pass
// form's ND * CW.
int depth_columns(int K) { return K <= 32 ? 8 * nt_of(K) : pass_width(K) * pass_chunks(K); }

// The bf16 planes of the n rows of tab at planes (hi, then lo at TERMS == 3).
void split_planes(const float* tab, int n, int K, int KD, int terms, uint16_t* planes,
                  cudaStream_t stream) {
  const int64_t total = (int64_t)n * KD;
  const int threads = 256;
  const int64_t want = (total + threads - 1) / threads;
  split_planes_kernel<<<(int)(want < 2048 ? want : 2048), threads, 0, stream>>>(
      tab, n, K, KD, terms == 3, planes);
}

// planes: scratch for the tables' planes, TERMS == 3: hi and lo, TERMS ==
// 1: hi only, depth_columns(K) columns each.  The streamed table's (n = hip
// on the user side, rows on the item side) and, past K = 32, the fixed
// table's after them (n = rows on the user side, hip on the item side).
template <int TERMS>
int dense_head_tier(const float* theta, const float* beta, const void* x_hi,
                    const void* x_lo, const void* m, int m_is_f32, int rows, int hip,
                    int K, float rate_floor, int item_side, int n_splits, void* planes,
                    float* partial, float* out, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (K < 1 || n_splits < 1)
    return (int)cudaErrorInvalidValue;
  const int KD = depth_columns(K);
  const int nQ = item_side ? rows : hip, nP = item_side ? hip : rows;
  uint16_t* pl = static_cast<uint16_t*>(planes);
  const float* p_tab = item_side ? beta : theta;
  split_planes(item_side ? theta : beta, nQ, K, KD, TERMS, pl, stream);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const uint16_t* xh = static_cast<const uint16_t*>(x_hi);
  const uint16_t* xl = static_cast<const uint16_t*>(x_lo);
  float* dst = n_splits > 1 ? partial : out;
  if (K <= 32) {
    err = launch_nt<TERMS>(K, m_is_f32, p_tab, pl, xh, xl, m, rows, hip, K, rate_floor,
                           item_side, n_splits, dst, stream);
  } else {
    uint16_t* pp = pl + (int64_t)(TERMS == 3 ? 2 : 1) * nQ * KD;
    split_planes(p_tab, nP, K, KD, TERMS, pp, stream);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const bool ring = pass_smem_bytes(K, m_is_f32, x_lo != nullptr, item_side != 0, TERMS,
                                      false, kStages) > kSmemPerCta;
    err = launch_pass_for<TERMS>(K, m_is_f32, ring, pp, pl, xh, xl, m, rows, hip, K,
                                 rate_floor, item_side, n_splits, dst, stream);
  }
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
// (x_lo may be null), m (rows, hip) bf16 or f32.  hip % 64 == 0, K >= 1.
// planes: scratch for the streamed table's hi and lo planes,
// 2 * n * depth_columns(K) bf16 with n = hip (user side) or rows; past
// K = 32 also the fixed table's, 2 * (rows + hip) * depth_columns(K) in all.
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
// product; planes holds the hi planes only, n * depth_columns(K) (past
// K = 32, (rows + hip) * depth_columns(K)).
extern "C" int pmf_dense_head_tier_fast(const float* theta, const float* beta,
                                        const void* x_hi, const void* x_lo,
                                        const void* m, int m_is_f32, int rows,
                                        int hip, int K, float rate_floor,
                                        int item_side, int n_splits, void* planes,
                                        float* partial, float* out, void* stream_ptr) {
  return dense_head_tier<1>(theta, beta, x_hi, x_lo, m, m_is_f32, rows, hip, K, rate_floor,
                            item_side, n_splits, planes, partial, out, stream_ptr);
}
