// The int8 implicit-GEMM 3D conv kernel with an F tile of 128 (int8_conv3d.cuh),
// in a source of its own so that the build compiles it beside the others.

#include "int8_conv3d.cuh"

namespace csec_int8 {

cudaError_t launch_n128(const Conv& p, const CUtensorMap& b_map, dim3 grid, cudaStream_t s) {
  return launch<128>(p, b_map, grid, s);
}

}  // namespace csec_int8
