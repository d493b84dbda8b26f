// The int8 implicit-GEMM 3D conv: the C entry point, the split-K finish and
// the kernel instance with an F tile of 64.  The design, what it replaces and
// what bounds it are in int8_conv3d.cuh.

#include "int8_conv3d.cuh"

namespace csec_int8 {

cudaError_t launch_n64(const Conv& p, const CUtensorMap& b_map, dim3 grid, cudaStream_t s) {
  return launch<64>(p, b_map, grid, s);
}

namespace {

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The tensor map of the packed weights (Fpad rows of Kpad bytes) read in
// boxes of 128 bytes x bn rows with the 128-byte swizzle.  The encoder,
// cuTensorMapEncodeTiled, is fetched once through the CUDA runtime's entry
// point query, so nothing links libcuda.
cudaError_t weight_tensor_map(CUtensorMap* map, const void* wp, int64_t Fpad, int64_t Kpad, int bn) {
  static EncodeTiled encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault);
    if (err != cudaSuccess || !fn) return err != cudaSuccess ? err : cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)Kpad, (cuuint64_t)Fpad};
  const cuuint64_t strides[1] = {(cuuint64_t)Kpad};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)bn};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(wp), dims, strides, box,
                            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The split-K finish: y = dequant(sum of the splits' partial sums) over (M, F).
__global__ void int8_dequant_kernel(const Conv p) {
  const int64_t total = p.M * p.F;
  const bool has_bias = p.bias != nullptr;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += (int64_t)gridDim.x * blockDim.x) {
    int sum = 0;
    for (int z = 0; z < p.splits; ++z) sum += p.acc[z * total + i];
    const int f = (int)(i % p.F);
    p.y[i] = dequant(sum, __ldg(p.scale + f), has_bias ? __ldg(p.bias + f) : 0.0f, has_bias);
  }
}

}  // namespace
}  // namespace csec_int8

using namespace csec_int8;

// x: (N, D, H, W, C) int8 contiguous; wp: (Fpad, Kpad) int8, Fpad >= F,
// Kpad % 128 == 0, Kpad >= kd*kh*kw*Cp, with each tap's channels padded to
// Cp (= C, or a multiple of 16 above C: `padded_channels`); scale: (F,)
// f32; bias: (F,) f32 or null; y: (N, Do, Ho, Wo, F) f32.  vec in
// {16, 8, 4, 1} must divide C and the alignment of x (vec is ignored below
// 8 channels, where Cp == C < 8).  bn in {64, 128, 192, 256} is the F tile;
// splits > 1 splits K into that many parts of ceil(steps / splits) stages,
// none empty, which then need acc, a (splits, M, F) int32 workspace.
// slab = 1 takes the row-slab route (int8_conv3d_slab.cu; bn 64, no
// split), for convs with the layout it reads.  Returns cudaError_t.
extern "C" int int8_conv3d(const void* x, const void* wp, const void* scale, const void* bias, void* y, void* acc,
                           int64_t N, int64_t D, int64_t H, int64_t W, int64_t C,
                           int64_t Do, int64_t Ho, int64_t Wo, int64_t F, int64_t Fpad, int64_t Kpad,
                           int kd, int kh, int kw, int sd, int sh, int sw, int pd, int ph, int pw,
                           int Cp, int vec, int bn, int splits, int slab, void* stream) {
  Conv p;
  p.x = static_cast<const int8_t*>(x);
  p.wp = static_cast<const int8_t*>(wp);
  p.scale = static_cast<const float*>(scale);
  p.bias = static_cast<const float*>(bias);
  p.y = static_cast<float*>(y);
  p.acc = splits > 1 ? static_cast<int*>(acc) : nullptr;
  p.D = (int)D; p.H = (int)H; p.W = (int)W; p.C = (int)C; p.Cp = (int)Cp;
  p.dW = (int)((W - kw) * C);
  p.dH = (int)((H - kh) * W * C);
  p.Do = (int)Do; p.Ho = (int)Ho; p.Wo = (int)Wo; p.F = F; p.Fpad = Fpad; p.Kpad = Kpad;
  p.M = N * Do * Ho * Wo;
  const int64_t K = (int64_t)kd * kh * kw * Cp;
  p.K = (int)K;
  p.kd = kd; p.kh = kh; p.kw = kw; p.khw = kh * kw;
  p.sd = sd; p.sh = sh; p.sw = sw; p.pd = pd; p.ph = ph; p.pw = pw;
  p.vec = Cp % 16 ? 0 : vec;  // 0: the unpadded layout of C < 8, byte by byte
  if (p.M == 0 || F == 0) return (int)cudaSuccess;
  const int64_t steps = Kpad / BK;
  if (Kpad % BK || Kpad < K || K >= (1ll << 30) || Fpad < F || C <= 0 || vec <= 0 || C % vec ||
      (D + kd) * (H + kh) * (W + kw) * C >= (1ll << 31) ||  // a tap's offset within an image fits an int
      p.M >= (1ll << 31) - BM ||                             // and so does every row index
      (Cp != C && (Cp % 16 || Cp < C)) || (Cp % 16 && Cp >= 8) || splits < 1 || splits > steps ||
      (splits > 1 && acc == nullptr))
    return (int)cudaErrorInvalidValue;
  p.steps_per_split = (int)((steps + splits - 1) / splits);
  p.splits = splits;
  const int64_t mtiles = (p.M + BM - 1) / BM, ftiles = (F + bn - 1) / bn;
  if ((steps + p.steps_per_split - 1) / p.steps_per_split != splits || ftiles > 65535 || mtiles > 0x7fffffff ||
      splits > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)mtiles, (unsigned)ftiles, (unsigned)splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap b_map;
  if (slab) {  // the row-slab route: F tiles of 64, no split
    if (!slab_layout_fits(p) || bn != 64 || splits != 1) return (int)cudaErrorInvalidValue;
    const cudaError_t err = weight_tensor_map(&b_map, wp, Fpad, Kpad, 64);
    return (int)(err != cudaSuccess ? err : launch_slab(p, b_map, s));
  }
  cudaError_t err = weight_tensor_map(&b_map, wp, Fpad, Kpad, bn);
  if (err != cudaSuccess) return (int)err;
  switch (bn) {
    case 64: err = launch_n64(p, b_map, grid, s); break;
    case 128: err = launch_n128(p, b_map, grid, s); break;
    case 192: err = launch_n192(p, b_map, grid, s); break;
    case 256: err = launch_n256(p, b_map, grid, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || !p.acc) return (int)err;
  const int64_t total = p.M * F;
  const unsigned blocks = (unsigned)((total + 255) / 256 < 1024 ? (total + 255) / 256 : 1024);
  int8_dequant_kernel<<<blocks, 256, 0, s>>>(p);
  return (int)cudaGetLastError();
}
