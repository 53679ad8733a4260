// K4's CTA form, tiles T = 5..10 (K = 65..160), replacing with gj_inverse.cu
// pmf_tpu/ops/pallas/gj_inverse.py::_gj_kernel.  What bounds it and its
// design: gj_tile.cuh.

#include "gj_tile.cuh"

cudaError_t gj_tile_launch_lo(const float* mats, int R, int K, float* out,
                              cudaStream_t stream) {
  static_assert(tile_of(65) == 5 && tile_of(16 * kTileLoMax) == kTileLoMax, "T = 5..10");
  switch (tile_of(K)) {
    case 5: return launch_tile<5>(mats, R, K, out, stream);
    case 6: return launch_tile<6>(mats, R, K, out, stream);
    case 7: return launch_tile<7>(mats, R, K, out, stream);
    case 8: return launch_tile<8>(mats, R, K, out, stream);
    case 9: return launch_tile<9>(mats, R, K, out, stream);
    case 10: return launch_tile<10>(mats, R, K, out, stream);
    default: return cudaErrorInvalidValue;
  }
}
