// K4's CTA form, tiles T = 11..15 (K = 161..239), replacing with gj_inverse.cu
// pmf_tpu/ops/pallas/gj_inverse.py::_gj_kernel.  What bounds it and its
// design: gj_tile.cuh.

#include "gj_tile.cuh"

cudaError_t gj_tile_launch_hi(const float* mats, int R, int K, float* out,
                              cudaStream_t stream) {
  static_assert(kTileLoMax == 10 && tile_of(239) == 15, "T = 11..15");
  switch (tile_of(K)) {
    case 11: return launch_tile<11>(mats, R, K, out, stream);
    case 12: return launch_tile<12>(mats, R, K, out, stream);
    case 13: return launch_tile<13>(mats, R, K, out, stream);
    case 14: return launch_tile<14>(mats, R, K, out, stream);
    case 15: return launch_tile<15>(mats, R, K, out, stream);
    default: return cudaErrorInvalidValue;
  }
}
