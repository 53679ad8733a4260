// K9's stream form, tried past K = 128 on an H100 and not kept in the port
// (PERF.md): a probe-only kernel that scripts/probe_k9.py compiles after
// pmf_tpu_torch/csrc/map_grad.cu, in the same translation unit (it uses
// that file's Pieces, store_row and kFull).
//
// One warp takes a SPAN of consecutive pieces of the step (the pieces whose
// first edge lies in one window of a span length of edges of the step;
// probe_k9.py::spans builds the table), lanes over factors (F = ceil(K /
// 32) a lane).  The warp walks its span's edges, contiguous in `other` /
// `x`, in rounds of at most D edges of one piece: each round's other rows,
// and on a piece's first round its self row, are copied by 4-byte cp.async
// (the tables' rows are K + 1 floats apart, so only 4-byte aligned) into a
// ring of S rounds in the warp's shared memory, S - 1 rounds in flight
// across piece boundaries while one is summed.  The round's piece list
// (piece, edges, first/last round, row, run) rides in the stage beside its
// rows.  Lane l reads factors l, l + 32, ... of each row; the D partial
// dots meet in one transposed reduction (warp_dots, as
// csrc/tail_groups.cuh), the lane holding edge d's dot takes its rating
// from the ring and forms lam, w and nll, and D shuffles share w and nll.
// Inside a piece the sums run in edge order; a piece's sums are added in
// piece order to the sum of its run's pieces that the span holds
// (registers).  Where that is the whole run, the row is stored; otherwise
// that partial goes to scratch (the slot of its first piece, zeros in its
// other pieces' slots), the run's counter moves once for each of its
// pieces, and the span that moves it last adds the run's slots in piece
// order, kMergeLoads loads in flight.  No float atomics: equal bits on a
// repeat.
//
// Measured (PERF.md): at K = 160 it lost to map_grad_wide_kernel on
// the same short pieces (30.6 against 23.1 ms an epoch at best): a round
// of 4 edges took about 0.8 us with or without its copies, and the longest
// span set a launch's end.  At K = 257-512 it ran 1.2-1.4x faster than
// map_grad_general_kernel on pieces of 32 edges.

namespace {

constexpr int kStreamWarps = 4;   // warps a CTA of map_grad_stream_kernel, a span each
constexpr int kStreamStages = 3;  // S: rounds in a warp's ring
constexpr int kMeta = 8;          // ints of a ring stage's piece list
constexpr int kMergeLoads = 8;    // partial rows a merging lane loads at once

// Floats of one warp's ring: S stages of D other rows and one self row (K
// floats each), then the S * D ratings, then kMeta ints a stage.
__host__ __device__ constexpr int stream_ring_floats(int K, int D, int S) {
  return S * (D + 1) * K + S * D + S * kMeta;
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

struct Spans {
  const int32_t* step_span;   // step s owns spans step_span[s] .. step_span[s + 1]
  const int32_t* span_first;  // span j holds pieces span_first[j] .. span_first[j + 1]
};

// The stream form: a warp a span of consecutive pieces of the step (the
// header's design note).  Lane l holds factors l, l + 32, ... (F a lane).
template <int F, int D, int S>
__global__ void __launch_bounds__(kStreamWarps * 32)
map_grad_stream_kernel(const float* __restrict__ self_tab,
                       const float* __restrict__ other_tab, Pieces pc, Spans sp, int step,
                       int K, float lam_floor, int with_nll, float* __restrict__ out,
                       float* scratch, unsigned* counters) {
  static_assert((D & (D - 1)) == 0 && D <= 32 && S >= 2, "D a power of two, S >= 2");
  extern __shared__ float stream_ring[];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int span = sp.step_span[step] + blockIdx.x * kStreamWarps + wid;
  if (span >= sp.step_span[step + 1]) return;  // whole warp leaves together
  const int p0 = pc.step_off[step];
  const int ps = sp.span_first[span];
  const int n_pieces = sp.span_first[span + 1] - ps;
  const int stride = K + 1;
  const int width = K + 1 + with_nll;
  float* __restrict__ ring = stream_ring + (int64_t)wid * stream_ring_floats(K, D, S);
  float* __restrict__ ring_x = ring + S * (D + 1) * K;
  int* __restrict__ ring_meta = reinterpret_cast<int*>(ring_x + S * D);
  const int64_t ebase = pc.piece_ptr[ps];
  const int n_edges = (int)(pc.piece_ptr[ps + n_pieces] - ebase);

  // Lane l holds the piece list of piece 32 mb + l of the span (its first
  // edge relative to the span's), loaded when the issue side reaches it.
  int mb = -1, m_start = 0, m_len = 0, m_row = 0, m_first = 0, m_count = 0;
  // Lane l holds the other id of edge 32 batch + l of the span (ids) and of
  // the batch after it (nids).
  int batch = 0;
  int ids = lane < n_edges ? pc.other[ebase + lane] : 0;
  int nids = 32 + lane < n_edges ? pc.other[ebase + 32 + lane] : 0;
  int ip = 0, ie = 0, issued = 0;  // the next round: edge ie of piece ip
  // The next round's other rows, ratings and, on a piece's first round, its
  // self row into stage issued % S, the round's piece list into the
  // stage's meta ints; one commit group a call (empty past the last round).
  auto issue = [&]() {
    if (ip < n_pieces) {
      if ((ip >> 5) != mb) {
        mb = ip >> 5;
        const int q = 32 * mb + lane;
        if (q < n_pieces) {
          const int64_t a = pc.piece_ptr[ps + q];
          m_start = (int)(a - ebase);
          m_len = (int)(pc.piece_ptr[ps + q + 1] - a);
          m_row = pc.piece_row[ps + q];
          m_first = pc.piece_first[ps + q];
          m_count = pc.piece_count[ps + q];
        }
      }
      const int src = ip & 31;
      const int plen = __shfl_sync(kFull, m_len, src);
      const int prow = __shfl_sync(kFull, m_row, src);
      const int pfirst = __shfl_sync(kFull, m_first, src);
      const int pcount = __shfl_sync(kFull, m_count, src);
      const int e0 = __shfl_sync(kFull, m_start, src) + ie;
      const int n = plen - ie < D ? plen - ie : D;
      const int st = issued % S;
      float* rows = ring + st * (D + 1) * K;
      if ((e0 >> 5) != batch) {  // rounds come in order: e0 is in batch + 1
        batch = e0 >> 5;
        ids = nids;
        const int e = 32 * (batch + 1) + lane;
        nids = e < n_edges ? pc.other[ebase + e] : 0;
      }
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const int e = e0 + d;
        const int oa = __shfl_sync(kFull, ids, e & 31);
        const int ob = __shfl_sync(kFull, nids, e & 31);
        if (d < n) {
          const float* orow = other_tab + (int64_t)((e >> 5) == batch ? oa : ob) * stride;
#pragma unroll
          for (int f = 0; f < F; ++f) {
            const int k = 32 * f + lane;
            if (k < K) cp_async4(rows + d * K + k, orow + k);
          }
        }
      }
      if (ie == 0) {
        const float* srow = self_tab + (int64_t)prow * stride;
#pragma unroll
        for (int f = 0; f < F; ++f) {
          const int k = 32 * f + lane;
          if (k < K) cp_async4(rows + D * K + k, srow + k);
        }
      }
      if (lane < n) cp_async4(ring_x + st * D + lane, pc.x + ebase + e0 + lane);
      const int flags = (ie == 0 ? 1 : 0) | (ie + n == plen ? 2 : 0);
      const int meta[kMeta] = {ip, n, flags, prow, pfirst, pcount, plen, 0};
#pragma unroll
      for (int j = 0; j < kMeta; ++j)
        if (lane == j) ring_meta[st * kMeta + j] = meta[j];
      ie += n;
      if (ie == plen) {
        ++ip;
        ie = 0;
      }
      ++issued;
    }
    cp_async_commit();
  };

  float es[F], acc[F], tot[F];
#pragma unroll
  for (int f = 0; f < F; ++f) es[f] = acc[f] = tot[f] = 0.f;
  float nll = 0.f, tot_nll = 0.f, tot_count = 0.f;
  int chunk = 0;  // the first of the run's pieces that this span holds
#pragma unroll
  for (int q = 0; q < S - 1; ++q) issue();
  for (int r = 0; r < issued; ++r) {
    issue();
    cp_async_wait<S - 1>();  // round r has landed (this lane's copies)
    __syncwarp();            // and every lane's
    const int st = r % S;
    const int* meta = ring_meta + st * kMeta;
    const int ipc = meta[0], n = meta[1], flags = meta[2];
    const float* rows = ring + st * (D + 1) * K;
    if (flags & 1) {  // a piece's first round: its self row, fresh sums
#pragma unroll
      for (int f = 0; f < F; ++f) {
        const int k = 32 * f + lane;
        es[f] = k < K ? rows[D * K + k] : 0.f;
        acc[f] = 0.f;
      }
      nll = 0.f;
    }
    float eo[D][F], part[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
#pragma unroll
      for (int f = 0; f < F; ++f) {
        const int k = 32 * f + lane;
        eo[d][f] = (d < n && k < K) ? rows[d * K + k] : 0.f;
      }
      part[d] = es[0] * eo[d][0];
#pragma unroll
      for (int f = 1; f < F; ++f) part[d] = fmaf(es[f], eo[d][f], part[d]);
    }
    const float dot = warp_dots<D>(part, lane);
    const int dl = lane / (32 / D);  // the edge whose dot this lane holds
    const float xv = dl < n ? ring_x[st * D + dl] : 0.f;
    const float lam = fmaxf(dot, lam_floor);
    const float w = dot >= lam_floor ? 1.f - xv / lam : 0.f;
    const float en = lam - xv * logf(lam);
#pragma unroll
    for (int d = 0; d < D; ++d) {
      if (d < n) {  // warp-uniform
        const float wd = __shfl_sync(kFull, w, d * (32 / D));
        nll += __shfl_sync(kFull, en, d * (32 / D));
#pragma unroll
        for (int f = 0; f < F; ++f) acc[f] = fmaf(wd, eo[d][f], acc[f]);
      }
    }
    if (flags & 2) {  // the piece is done: into the sum of its run's pieces here
      const int row = meta[3], first = meta[4], count = meta[5];
      const float len = (float)meta[6];
      const int p = ps + ipc;
      if (p == first || ipc == 0) {
        chunk = p;
#pragma unroll
        for (int f = 0; f < F; ++f) tot[f] = acc[f];
        tot_nll = nll;
        tot_count = len;
      } else {  // the run's earlier pieces lie in this span: piece order
#pragma unroll
        for (int f = 0; f < F; ++f) tot[f] += acc[f];
        tot_nll += nll;
        tot_count += len;
      }
      if (p == first + count - 1 || ipc == n_pieces - 1) {
        const int m = p - chunk + 1;  // the run's pieces this span holds
        if (m == count) {
          store_row(out + (int64_t)row * width, tot, tot_count, tot_nll, K, with_nll, lane);
        } else {
          // The partial of the m pieces in its first piece's slot, zeros in
          // the slots of the other m - 1, so that the last to arrive adds
          // the run's slots in piece order with independent loads.
          float* slot = scratch + (int64_t)(chunk - p0) * width;
          store_row(slot, tot, tot_count, tot_nll, K, with_nll, lane);
          for (int c = lane; c < (m - 1) * width; c += 32) slot[width + c] = 0.f;
          __threadfence();  // this lane's partial is visible before the count moves
          __syncwarp();
          // One arrival a piece (atomicInc wraps the counter back to 0 for
          // the next launch): the span that makes the run's last one merges.
          int last = 0;
          if (lane == 0)
            for (int i = 0; i < m; ++i)
              last |= atomicInc(counters + (first - p0), (unsigned)(count - 1)) ==
                      (unsigned)(count - 1);
          if (__shfl_sync(kFull, last, 0)) {
            __threadfence();
            const float* part = scratch + (int64_t)(first - p0) * width;
            float* dst = out + (int64_t)row * width;
            for (int c = lane; c < width; c += 32) {
              float s = __ldcg(part + c);
              int q = 1;
              for (; q + kMergeLoads <= count; q += kMergeLoads) {  // loads in flight together
                float v[kMergeLoads];
#pragma unroll
                for (int i = 0; i < kMergeLoads; ++i)
                  v[i] = __ldcg(part + (int64_t)(q + i) * width + c);
#pragma unroll
                for (int i = 0; i < kMergeLoads; ++i) s += v[i];
              }
              for (; q < count; ++q) s += __ldcg(part + (int64_t)q * width + c);
              dst[c] = s;
            }
          }
        }
      }
    }
    __syncwarp();  // every lane has read stage st before round r + S refills it
  }
}

// One direction of step `step` in the stream form at F factors a lane, D
// edges a round, S rounds a ring: kStreamWarps spans a CTA, the ring in
// dynamic shared memory (the attribute raised past the default 48 KB).
template <int F, int D, int S>
int launch_stream(const float* self_tab, const float* other_tab, const Pieces& pc,
                  const Spans& sp, int step, int max_spans, int K, float lam_floor,
                  int with_nll, float* out, float* scratch, unsigned* counters,
                  cudaStream_t st) {
  auto kernel = map_grad_stream_kernel<F, D, S>;
  const int smem = kStreamWarps * 4 * stream_ring_floats(K, D, S);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(max_spans + kStreamWarps - 1) / kStreamWarps, kStreamWarps * 32, smem, st>>>(
      self_tab, other_tab, pc, sp, step, K, lam_floor, with_nll, out, scratch, counters);
  return (int)cudaGetLastError();
}

}  // namespace
