// One fused pass from bf16 or f32 to int8, elementwise over a contiguous
// tensor (the port's activations are NDHWC in memory, so the int8 output is
// the int8 conv's NDHWC input):
//   static:  q = round(clip(x * inv, -127, 127))   (inv = 1/max(act_scale, 1e-30))
//   dynamic: q = round(x / sx)                      (sx = max(max|x|, 1e-30)/127)
// rounding half to even (__float2int_rn), as jnp.round and torch.round do.
//
// Replaces no Pallas kernel: the JAX package leaves this pass to XLA, the
// elementwise producers of crowded_scenes_ensemble_classification_tpu/models/
// common.py `quant_conv_general` (line 111) and `static_quant_conv_general`
// (line 176).  The scalar (inv or sx) is read from device memory, so the
// host never waits for it; the dynamic mode's max|x| stays a plain `amax`
// as XLA's reduction is there.  The wrapper and the plain version are in
// ops/kernels/int8_conv.py.
//
// Bound: memory bytes, each element read once (2 or 4 bytes) and written
// once (1 byte).  A thread takes 8 elements with 16- (bf16) or 2x16-byte
// (f32) loads and one 8-byte store where the length and the pointers allow.
// The multiply and divide are __fmul_rn / __fdiv_rn, IEEE round to nearest,
// so the output equals the plain version bit for bit.
//
// The pass may also widen each innermost row from c to cp values, zeros
// past c: below 16 channels the int8 conv takes 16-byte pixels (the I3D
// stems' 4C = 12 and 8), and writing them here costs no pass of its own.
// A thread then takes one row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <bool DYNAMIC>
__device__ __forceinline__ int8_t quantize_one(float v, float s) {
  if (DYNAMIC) return (int8_t)__float2int_rn(__fdiv_rn(v, s));
  const float q = fminf(fmaxf(__fmul_rn(v, s), -127.0f), 127.0f);
  return (int8_t)__float2int_rn(q);
}

template <typename T, bool DYNAMIC, bool VECTOR>
__global__ void quantize_int8_kernel(const T* __restrict__ x, int8_t* __restrict__ y,
                                     const float* __restrict__ scalar, int64_t n) {
  const float s = __ldg(scalar);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  if (VECTOR) {
    const int64_t groups = n / 8;
    for (int64_t gi = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; gi < groups; gi += stride) {
      __align__(16) T v[8];
      if (sizeof(T) == 2) {
        *reinterpret_cast<uint4*>(v) = __ldg(reinterpret_cast<const uint4*>(x) + gi);
      } else {
        reinterpret_cast<uint4*>(v)[0] = __ldg(reinterpret_cast<const uint4*>(x) + 2 * gi);
        reinterpret_cast<uint4*>(v)[1] = __ldg(reinterpret_cast<const uint4*>(x) + 2 * gi + 1);
      }
      __align__(8) int8_t q[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) q[e] = quantize_one<DYNAMIC>(to_float(v[e]), s);
      reinterpret_cast<uint2*>(y)[gi] = *reinterpret_cast<const uint2*>(q);
    }
  } else {
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride)
      y[i] = quantize_one<DYNAMIC>(to_float(x[i]), s);
  }
}

// Rows of c values in, rows of cp int8 out (cp % 4 == 0), zeros past c; a
// thread a row, stored in 4-byte words.
template <typename T, bool DYNAMIC>
__global__ void quantize_int8_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ y,
                                          const float* __restrict__ scalar, int64_t rows, int c, int cp) {
  const float s = __ldg(scalar);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; r < rows; r += stride) {
    const T* src = x + r * c;
    uint32_t* dst = reinterpret_cast<uint32_t*>(y + r * cp);
    for (int j0 = 0; j0 < cp; j0 += 4) {
      uint32_t packed = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int8_t q = j0 + e < c ? quantize_one<DYNAMIC>(to_float(src[j0 + e]), s) : (int8_t)0;
        packed |= (uint32_t)(uint8_t)q << (8 * e);
      }
      dst[j0 / 4] = packed;
    }
  }
}

constexpr int THREADS = 256;
constexpr int64_t MAX_GRID = 132 * 64;  // grid-stride beyond

inline unsigned grid_for(int64_t work) {
  const int64_t blocks = (work + THREADS - 1) / THREADS;
  return (unsigned)(blocks < MAX_GRID ? blocks : MAX_GRID);
}

template <typename T, bool DYNAMIC>
void launch(const void* x, void* y, const void* scalar, int64_t rows, int c, int cp, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  int8_t* yt = static_cast<int8_t*>(y);
  const float* st = static_cast<const float*>(scalar);
  if (cp != c) {
    quantize_int8_rows_kernel<T, DYNAMIC><<<grid_for(rows), THREADS, 0, s>>>(xt, yt, st, rows, c, cp);
    return;
  }
  const int64_t n = rows * c;
  const bool vector = n % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(y) % 8 == 0;
  const unsigned grid = grid_for(vector ? n / 8 : n);
  if (vector) {
    quantize_int8_kernel<T, DYNAMIC, true><<<grid, THREADS, 0, s>>>(xt, yt, st, n);
  } else {
    quantize_int8_kernel<T, DYNAMIC, false><<<grid, THREADS, 0, s>>>(xt, yt, st, n);
  }
}

}  // namespace

// x: rows x c contiguous elements, bf16 (is_bf16 = 1) or f32; y: rows x cp
// int8, 4-byte aligned where cp != c (then cp % 4 == 0 and cp > c); scalar:
// one f32 on the device, inv (dynamic = 0) or sx (dynamic = 1).  Returns
// cudaError_t.
extern "C" int quantize_int8(const void* x, void* y, const void* scalar, int64_t rows, int c, int cp,
                             int is_bf16, int dynamic, void* stream) {
  if (rows == 0) return (int)cudaSuccess;
  if (c <= 0 || cp < c || (cp != c && (cp % 4 || reinterpret_cast<uintptr_t>(y) % 4)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (dynamic) launch<__nv_bfloat16, true>(x, y, scalar, rows, c, cp, s);
    else launch<__nv_bfloat16, false>(x, y, scalar, rows, c, cp, s);
  } else {
    if (dynamic) launch<float, true>(x, y, scalar, rows, c, cp, s);
    else launch<float, false>(x, y, scalar, rows, c, cp, s);
  }
  return (int)cudaGetLastError();
}
