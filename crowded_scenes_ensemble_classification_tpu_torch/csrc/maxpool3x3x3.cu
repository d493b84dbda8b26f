// 3x3x3 stride-1 TF-SAME max pool over a contiguous NTHWC tensor, bf16 or f32.
//
// Replaces the Pallas TPU kernel `_maxpool3_kernel` / `max_pool_3x3x3_same`
// in crowded_scenes_ensemble_classification_tpu/ops/pallas/maxpool.py.  That
// kernel streamed three clamped temporal (H, W, C) slabs through VMEM; here
// each thread owns one output position (b, t, h, w) and one 16-byte vector
// of channels (8 bf16 or 4 f32), takes the max of the 27 taps straight from
// global memory through L1/L2, and treats taps outside the tensor as -inf
// (the SAME padding of nn.max_pool).  Neighbouring threads own neighbouring
// channel vectors, so every tap load is coalesced.
//
// Bound: not by bytes yet.  One read and one write of the tensor are the
// floor (24 MB each way at (8,10,28,28,192) bf16, large enough that launch
// latency does not matter), but this kernel issues 27 16-byte tap loads per
// output vector through L1, plus 64-bit div/mod index math per thread, and
// runs near an eighth of the HBM bandwidth at the main path's shapes.
// Staging an (H, W, C-block) tile per block in shared memory, with 32-bit
// indices, is the later remedy.
//
// The max propagates NaN like jnp.maximum and torch's max_pool3d (fmaxf
// would drop it).  A channel count that is not a multiple of the vector
// width, or a misaligned pointer, takes the scalar kernel with a masked tail.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float nan_max(float m, float v) {
  return (v > m || isnan(v)) ? v : m;
}

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // exact: v is one of the bf16 inputs
}

// VEC elements of T make 16 bytes.  VECTOR selects 16-byte loads (needs
// C % VEC == 0 and an aligned base) or masked scalar loads.
template <typename T, int VEC, bool VECTOR>
__global__ void maxpool3x3x3_kernel(const T* __restrict__ x, T* __restrict__ y,
                                    int64_t B, int64_t Tn, int64_t H, int64_t W,
                                    int64_t C) {
  const int64_t CV = (C + VEC - 1) / VEC;
  const int64_t total = B * Tn * H * W * CV;
  for (int64_t idx = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; idx < total;
       idx += (int64_t)gridDim.x * blockDim.x) {
    const int64_t cv = idx % CV;
    int64_t pos = idx / CV;
    const int64_t w = pos % W;
    pos /= W;
    const int64_t h = pos % H;
    pos /= H;
    const int64_t t = pos % Tn;
    const int64_t b = pos / Tn;
    const int64_t c0 = cv * VEC;

    float m[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) m[i] = -INFINITY;

    for (int dt = -1; dt <= 1; ++dt) {
      const int64_t tt = t + dt;
      if (tt < 0 || tt >= Tn) continue;
      for (int dh = -1; dh <= 1; ++dh) {
        const int64_t hh = h + dh;
        if (hh < 0 || hh >= H) continue;
        for (int dw = -1; dw <= 1; ++dw) {
          const int64_t ww = w + dw;
          if (ww < 0 || ww >= W) continue;
          const T* src = x + (((b * Tn + tt) * H + hh) * W + ww) * C + c0;
          if (VECTOR) {
            uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
            const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
            for (int i = 0; i < VEC; ++i) m[i] = nan_max(m[i], to_f<T>(v[i]));
          } else {
#pragma unroll
            for (int i = 0; i < VEC; ++i)
              if (c0 + i < C) m[i] = nan_max(m[i], to_f<T>(src[i]));
          }
        }
      }
    }

    T* dst = y + (((b * Tn + t) * H + h) * W + w) * C + c0;
    if (VECTOR) {
      uint4 raw;
      T* v = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[i] = from_f<T>(m[i]);
      *reinterpret_cast<uint4*>(dst) = raw;
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        if (c0 + i < C) dst[i] = from_f<T>(m[i]);
    }
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* x, void* y, int64_t B, int64_t Tn, int64_t H,
                   int64_t W, int64_t C, cudaStream_t stream) {
  const int64_t total = B * Tn * H * W * ((C + VEC - 1) / VEC);
  if (total == 0) return cudaSuccess;
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > (int64_t)1 << 30) blocks = (int64_t)1 << 30;  // grid-stride beyond
  const bool vector = (C % VEC == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                      (reinterpret_cast<uintptr_t>(y) % 16 == 0);
  if (vector) {
    maxpool3x3x3_kernel<T, VEC, true><<<(unsigned)blocks, threads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(y), B, Tn, H, W, C);
  } else {
    maxpool3x3x3_kernel<T, VEC, false><<<(unsigned)blocks, threads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(y), B, Tn, H, W, C);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the launch's cudaError_t.
extern "C" int maxpool3x3x3_same(const void* x, void* y, int64_t B, int64_t Tn,
                                 int64_t H, int64_t W, int64_t C, int dtype,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float, 4>(x, y, B, Tn, H, W, C, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16, 8>(x, y, B, Tn, H, W, C, s);
  return (int)cudaErrorInvalidValue;
}
