// K1 — sparse-tail CAVI edge pass for the Poisson/HPF family.
//
// Replaces: pmf_tpu/ops/pallas/cavi_edge.py::_kernel (modes "cavi" and
// "raw").
//
// Computes, per new-space self row r with tail edges (r, o, x) in CSR:
//   out[r, 0:K]  = sum_e x * e_self[r] * e_other[o] / max(<e_self[r], e_other[o]>, floor)
//   out[r, K:2K] = sum_e e_other[o]
// Rows without tail edges get zeros.  Mode "raw" drops the rating and the
// rate: out[r, 0:K] = sum_e e_self[r] * e_other[o], the statistic the
// tensor-parallel extended-Poisson scalar pass reads when the other table
// arrives pre-scaled.
//
// What bounds it on an H100: instruction issue and L2 gather latency, not
// bytes (the tables stay in the 50 MB L2; HBM moves the 8-byte (id, rating)
// pairs, the tables once and the outputs).  tail_groups.cuh holds the
// kernel, its reckoning and its design: row groups of G lanes within a
// warp, float4 words of tables padded to 4 * ceil(K / 4) floats, a
// log2(G)-step butterfly an edge; past 32 words a row mode "cavi" takes
// its dot form (tail_dot_kernel: a warp a row, rounds of edges staged by
// cp.async, one reduction for a round's dots).  Both modes are instances
// of it; this file holds their entry points.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tail_groups.cuh"

extern "C" int pmf_cavi_edge_raw(const float* e_self, const float* e_other,
                                 const int64_t* row_ptr, const int32_t* other,
                                 int n_self, int n_long, int K, float* out,
                                 void* stream) {
  const tail_groups::Tables t{e_self, e_other, nullptr, row_ptr, other, nullptr};
  return tail_groups::launch<tail_groups::kRaw>(t, n_self, n_long, K, 0.f, out,
                                                static_cast<cudaStream_t>(stream));
}

extern "C" int pmf_cavi_edge(const float* e_self, const float* e_other,
                             const int64_t* row_ptr, const int32_t* other,
                             const float* x, int n_self, int n_long, int K,
                             float rate_floor, float* out, void* stream) {
  const tail_groups::Tables t{e_self, e_other, nullptr, row_ptr, other, x};
  return tail_groups::launch<tail_groups::kCavi>(t, n_self, n_long, K, rate_floor, out,
                                                 static_cast<cudaStream_t>(stream));
}

extern "C" const char* pmf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
