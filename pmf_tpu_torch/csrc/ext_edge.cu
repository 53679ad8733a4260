// K7 and K8 — sparse-tail edge passes of the extended Poisson model
// (x ~ Poisson(phi_u psi_i <theta_u, beta_i>), scalar activity factors).
//
// Replaces: pmf_tpu/ops/pallas/ext_edge.py::_factor_kernel (K7) and
//           pmf_tpu/ops/pallas/ext_edge.py::_scalar_kernel (K8).
//
// Per new-space self row r with tail edges (r, o, x) in CSR, with s the
// other side's scalar expectations:
//   K7  out[r, 0:K]  = sum_e x * e_self[r] * e_other[o] / max(<e_self[r], e_other[o]>, floor)
//       out[r, K:2K] = sum_e s[o] * e_other[o]
//   K8  out[r]       = sum_e s[o] * <e_self_new[r], e_other[o]>
// The allocation divides by the dot WITHOUT the scalars (they cancel in
// the multinomial allocation); only the second half of K7 is weighted.
// K8 runs after the row update with the refreshed self rows and has no
// floor.  Rows without tail edges get zeros.
//
// What bounds them on an H100: instruction issue and L2 gather latency, not
// bytes.  Per edge they move a 4-byte other id (K7 also a 4-byte rating)
// from HBM and one [e | s] record of the other side (K + 1 floats padded
// to 4 * ceil((K + 1) / 4), 96 bytes and 3 sectors at K=20); the records
// (<= ~16 MB at 162k x 24 f32) stay resident in the 50 MB L2, so HBM
// traffic is the CSR arrays plus one read of each table and one write of
// each output row.  The arithmetic (~6K flops per edge for K7, 2K for K8)
// is far below the FP32 line.
//
// Both are modes of the row-group kernel tail_groups.cuh (K1's row
// groups: G lanes a self row, float4 words of tables padded to
// 4 * ceil(columns / 4) floats, the first long_rows rows a warp each), on
// the same [e | s] records, s_o in column K shared from its lane by one
// shuffle an edge; the self rows are padded to 4 * ceil(K / 4).  K7 is
// mode kExt (a log2(G)-step butterfly an edge for the allocation's dot;
// past 32 words a row K1's dot form, tail_dot_kernel),
// K8 mode kScalar: linear in e_other, each lane sums s_o * e_o over its
// words, one multiply-add an element an edge and no butterfly, and dots
// that with its words of e_self_new once at the row's end, one butterfly
// a row; from 37 words a record (K = 144) the sum form, tail_sum_kernel,
// with other-id windows where the records outgrow the L2.  The header
// holds the design and the reckoning.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tail_groups.cuh"

extern "C" int pmf_ext_factor(const float* e_self, const float* es_other,
                              const int64_t* row_ptr, const int32_t* other,
                              const float* x, int n_self, int n_long, int K,
                              float rate_floor, float* out, void* stream) {
  const tail_groups::Tables t{e_self, es_other, nullptr, row_ptr, other, x};
  return tail_groups::launch<tail_groups::kExt>(t, n_self, n_long, K, rate_floor, out,
                                                static_cast<cudaStream_t>(stream));
}

// K8.  n_win > 1: the sum form's other-id windows, as pmf_gauss_bias's
// (no ratings).
extern "C" int pmf_ext_scalar(const float* e_self_new, const float* es_other,
                              const int64_t* row_ptr, const int32_t* other, int n_self,
                              int n_long, int K, int n_win, const int64_t* win_ptr,
                              const int32_t* win_other, float* part, unsigned* count,
                              float* out, void* stream) {
  const tail_groups::Tables t{e_self_new, es_other, nullptr, row_ptr, other, nullptr};
  const tail_groups::Windows win{n_win, win_ptr, win_other, nullptr, part, count};
  return tail_groups::launch<tail_groups::kScalar>(t, n_self, n_long, K, 0.f, out,
                                                   static_cast<cudaStream_t>(stream), win);
}
