// Gradient of the 3x3x3 stride-1 TF-SAME max pool over a contiguous NTHWC
// tensor, bf16 or f32: dx[p] = sum of dy[q] over the <= 27 outputs q whose
// window holds p and whose FIRST maximum, in (t, h, w) order, is p.
//
// No Pallas kernel computes this: the JAX package differentiates its pool
// on XLA (jax.vjp of `max_pool_3d`, crowded_scenes_ensemble_classification_tpu/
// models/common.py:28, a select_and_scatter).  Its tie rule is the one
// kept here, and torch's max_pool3d keeps it too: a later tap replaces the
// running maximum only if it is greater (or NaN), so the first maximum wins.
//
// Bound: bytes.  Reading x and dy and writing dx is the floor: 600 MB for
// the 9 Mixed-block pools of one I3D member at B = 16 bf16, 0.18 ms at
// 3.35 TB/s, plus one byte a position for the codes below, written once
// and read once.  This first design is simple and deterministic, with no
// atomics, in two passes:
//
// 1. `maxpool3_bwd_argmax_kernel`: one thread per (b, t, h, w) and unit of
//    channels (16 bytes: 8 bf16 or 4 f32; one element in the scalar
//    variant) scans the 27 taps in (t, h, w) order and writes each channel's
//    argmax code 0..26 (tap (kt, kh, kw) is code 9 kt + 3 kh + kw) as one
//    byte.
// 2. `maxpool3_bwd_gather_kernel`: one thread per input position and unit
//    reads the codes and dy of its 27 neighbours q = p + d, in (t, h, w)
//    order, and sums in f32 the dy whose code names p (d = (dt, dh, dw)
//    reaches p from q by tap 1 - d).  The fixed order makes the result deterministic, and
//    equal in f32 to torch's CPU scatter, which adds in output order.
//
// Both passes read their 27 taps through L1 and L2, like the first forward
// kernel of this repository (csrc/maxpool3x3x3.cu before its redesign); a
// shared-memory tile walking T, as that redesign did, is the next step.
// Index math: one 64-bit base per (b, t) plane, 32-bit offsets inside (the
// launcher refuses a plane of 2^31 elements or more).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

// One thread's unit of channels: LANES elements, loaded as one U, with
// their codes stored as one CodeU of LANES bytes.
template <typename T, bool VECTOR> struct Unit;

template <> struct Unit<__nv_bfloat16, true> {
  using U = uint4;
  using CodeU = uint2;
  static constexpr int LANES = 8;
  __device__ static float lane(const U& v, int l) {
    const uint32_t word = (&v.x)[l >> 1];
    return __uint_as_float((l & 1) ? (word & 0xFFFF0000u) : (word << 16));
  }
  __device__ static U pack(const float* a) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 pair = __floats2bfloat162_rn(a[2 * i], a[2 * i + 1]);  // .x = low half
      w[i] = *reinterpret_cast<const uint32_t*>(&pair);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <> struct Unit<float, true> {
  using U = float4;
  using CodeU = uint32_t;
  static constexpr int LANES = 4;
  __device__ static float lane(const U& v, int l) { return (&v.x)[l]; }
  __device__ static U pack(const float* a) { return make_float4(a[0], a[1], a[2], a[3]); }
};

template <> struct Unit<float, false> {
  using U = float;
  using CodeU = uint8_t;
  static constexpr int LANES = 1;
  __device__ static float lane(const U& v, int) { return v; }
  __device__ static U pack(const float* a) { return a[0]; }
};

template <> struct Unit<__nv_bfloat16, false> {
  using U = __nv_bfloat16;
  using CodeU = uint8_t;
  static constexpr int LANES = 1;
  __device__ static float lane(const U& v, int) { return __bfloat162float(v); }
  __device__ static U pack(const float* a) { return __float2bfloat16(a[0]); }
};

// The thread's position: plane (b, t) from blockIdx.y, then (h, w, unit)
// inside the plane from blockIdx.x; false past the plane's end.
struct Position {
  int t, h, w, c;
  int64_t plane;  // b * Tn + t
};

__device__ __forceinline__ bool decode(Position& p, int Tn, int H, int W, int units, int lanes) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= H * W * units) return false;
  const int u = i % units, hw = i / units;
  p.w = hw % W;
  p.h = hw / W;
  p.c = u * lanes;
  p.plane = blockIdx.y;
  p.t = (int)(p.plane % Tn);
  return true;
}

template <typename T, bool VECTOR>
__global__ void __launch_bounds__(THREADS)
maxpool3_bwd_argmax_kernel(const T* __restrict__ x, uint8_t* __restrict__ codes, int Tn, int H, int W, int C,
                           int units) {
  using Ops = Unit<T, VECTOR>;
  using U = typename Ops::U;
  constexpr int L = Ops::LANES;
  Position p;
  if (!decode(p, Tn, H, W, units, L)) return;
  const int64_t plane_elems = (int64_t)H * W * C;
  float m[L];
  uint8_t code[L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    m[l] = -INFINITY;
    code[l] = 0;  // the window's first tap, as torch starts its argmax
  }
#pragma unroll
  for (int k = 0; k < 27; ++k) {
    const int tt = p.t + k / 9 - 1, hh = p.h + (k / 3) % 3 - 1, ww = p.w + k % 3 - 1;
    if (tt < 0 || tt >= Tn || hh < 0 || hh >= H || ww < 0 || ww >= W) continue;  // -inf padding
    const T* src = x + (p.plane + (k / 9 - 1)) * plane_elems + ((hh * W + ww) * C + p.c);
    const U v = *reinterpret_cast<const U*>(src);
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const float f = Ops::lane(v, l);
      if (f > m[l] || isnan(f)) {
        m[l] = f;
        code[l] = (uint8_t)k;
      }
    }
  }
  typename Ops::CodeU out;
  uint8_t* const bytes = reinterpret_cast<uint8_t*>(&out);
#pragma unroll
  for (int l = 0; l < L; ++l) bytes[l] = code[l];
  *reinterpret_cast<typename Ops::CodeU*>(codes + p.plane * plane_elems + ((p.h * W + p.w) * C + p.c)) = out;
}

template <typename T, bool VECTOR>
__global__ void __launch_bounds__(THREADS)
maxpool3_bwd_gather_kernel(const uint8_t* __restrict__ codes, const T* __restrict__ dy, T* __restrict__ dx,
                           int Tn, int H, int W, int C, int units) {
  using Ops = Unit<T, VECTOR>;
  using U = typename Ops::U;
  constexpr int L = Ops::LANES;
  Position p;
  if (!decode(p, Tn, H, W, units, L)) return;
  const int64_t plane_elems = (int64_t)H * W * C;
  float acc[L];
#pragma unroll
  for (int l = 0; l < L; ++l) acc[l] = 0.0f;
#pragma unroll
  for (int k = 0; k < 27; ++k) {  // neighbour q = p + d, d = (k / 9, k / 3 % 3, k % 3) - 1
    const int dt = k / 9 - 1, dh = (k / 3) % 3 - 1, dw = k % 3 - 1;
    const int tt = p.t + dt, hh = p.h + dh, ww = p.w + dw;
    if (tt < 0 || tt >= Tn || hh < 0 || hh >= H || ww < 0 || ww >= W) continue;
    const int64_t off = (p.plane + dt) * plane_elems + ((hh * W + ww) * C + p.c);
    const typename Ops::CodeU cq = *reinterpret_cast<const typename Ops::CodeU*>(codes + off);
    const U g = *reinterpret_cast<const U*>(dy + off);
    const uint8_t* const cb = reinterpret_cast<const uint8_t*>(&cq);
    const uint8_t want = (uint8_t)(26 - k);  // tap 1 - d of q is p
#pragma unroll
    for (int l = 0; l < L; ++l)
      if (cb[l] == want) acc[l] += Ops::lane(g, l);
  }
  *reinterpret_cast<U*>(dx + p.plane * plane_elems + ((p.h * W + p.w) * C + p.c)) = Ops::pack(acc);
}

template <typename T, bool VECTOR>
cudaError_t launch(const void* x, const void* dy, void* dx, void* codes, int64_t B, int64_t Tn, int64_t H,
                   int64_t W, int64_t C, cudaStream_t stream) {
  using Ops = Unit<T, VECTOR>;
  if (VECTOR && (C % Ops::LANES || (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dy) |
                                    reinterpret_cast<uintptr_t>(dx) | reinterpret_cast<uintptr_t>(codes)) %
                                       16))
    return cudaErrorInvalidValue;
  const int64_t units = (C + Ops::LANES - 1) / Ops::LANES;
  const int64_t per_plane = H * W * units;
  const dim3 grid((unsigned)((per_plane + THREADS - 1) / THREADS), (unsigned)(B * Tn));
  maxpool3_bwd_argmax_kernel<T, VECTOR><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<uint8_t*>(codes), (int)Tn, (int)H, (int)W, (int)C, (int)units);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  maxpool3_bwd_gather_kernel<T, VECTOR><<<grid, THREADS, 0, stream>>>(
      static_cast<const uint8_t*>(codes), static_cast<const T*>(dy), static_cast<T*>(dx), (int)Tn, (int)H, (int)W,
      (int)C, (int)units);
  return cudaGetLastError();
}

}  // namespace

// x, dy, dx (B, T, H, W, C) contiguous; codes: B*T*H*W*C bytes of scratch.
// dtype: 0 = float32, 1 = bfloat16.  vector: 16-byte units (C a multiple
// of 16 bytes, every pointer 16-byte aligned) or single elements.  Returns
// the launches' cudaError_t, and cudaErrorInvalidValue for a shape the
// kernels do not take.
extern "C" int maxpool3x3x3_same_backward(const void* x, const void* dy, void* dx, void* codes, int64_t B,
                                          int64_t Tn, int64_t H, int64_t W, int64_t C, int dtype, int vector,
                                          void* stream) {
  if (B < 1 || Tn < 1 || H < 1 || W < 1 || C < 1 || H * W * C >= (int64_t)1 << 31 || B * Tn > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)(vector ? launch<float, true>(x, dy, dx, codes, B, Tn, H, W, C, s)
                        : launch<float, false>(x, dy, dx, codes, B, Tn, H, W, C, s));
  if (dtype == 1)
    return (int)(vector ? launch<__nv_bfloat16, true>(x, dy, dx, codes, B, Tn, H, W, C, s)
                        : launch<__nv_bfloat16, false>(x, dy, dx, codes, B, Tn, H, W, C, s));
  return (int)cudaErrorInvalidValue;
}
