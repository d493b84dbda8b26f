// Per-clip-gated salt (-> 255) and pepper (-> 0) noise over a (B, L) f32 batch.
//
// Replaces the Pallas TPU kernel `_noise_kernel` / `salt_pepper_pallas` in
// crowded_scenes_ensemble_classification_tpu/ops/pallas/noise.py.  Like it,
// each element gets one 32-bit draw: the low 16 bits against `threshold`
// decide salt, the high 16 bits decide pepper, and pepper is applied after
// salt.  The TPU drew its bits from the core's own generator; here they come
// from Philox4x32-10 (Salmon et al., SC'11), written out below, keyed by the
// 64-bit seed and counted by (element group, clip): element e of clip b of the
// call takes word e % 4 of philox(counter = (e / 4, clip_offset + b, 0, 0),
// key = (seed_lo, seed_hi)).  `clip_offset` is the call's first row in the
// global batch, so a data-parallel position that augments rows [k, k + n)
// passes k and draws the noise the unsharded call draws for those rows.
// `philox_bits` in ops/kernels/noise.py computes the same words in PyTorch,
// so the kernel and its plain version agree bit for bit.
//
// Bound: memory bytes.  Each element is read once and written once (8 bytes
// of traffic for about 10 integer multiplies per 4 elements); one thread
// handles one group of 4 elements with a 16-byte load when the row allows.
// A clip with both gates off skips the generator and only copies.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += kW0;
      k1 += kW1;
    }
    const uint32_t hi0 = __umulhi(kM0, c.x), lo0 = kM0 * c.x;
    const uint32_t hi1 = __umulhi(kM1, c.z), lo1 = kM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

__device__ __forceinline__ float noise_one(float v, uint32_t bits, bool salt,
                                           bool pepper, uint32_t threshold) {
  if (salt && (bits & 0xFFFFu) < threshold) v = 255.0f;
  if (pepper && (bits >> 16) < threshold) v = 0.0f;
  return v;
}

template <bool VECTOR>
__global__ void salt_pepper_kernel(const float* __restrict__ x, float* __restrict__ y,
                                   const uint8_t* __restrict__ salt_gates,
                                   const uint8_t* __restrict__ pepper_gates,
                                   int64_t L, int64_t clip_offset, uint32_t k0,
                                   uint32_t k1, uint32_t threshold) {
  const int64_t b = blockIdx.y;
  const int64_t g = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;  // group of 4
  const int64_t e0 = 4 * g;
  if (e0 >= L) return;
  const float* src = x + b * L + e0;
  float* dst = y + b * L + e0;
  const bool salt = salt_gates[b] != 0, pepper = pepper_gates[b] != 0;

  float v[4];
  if (VECTOR) {
    const float4 in = __ldg(reinterpret_cast<const float4*>(src));
    v[0] = in.x; v[1] = in.y; v[2] = in.z; v[3] = in.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = (e0 + i < L) ? src[i] : 0.0f;
  }
  if (salt || pepper) {
    const uint4 r =
        philox4x32_10(make_uint4((uint32_t)g, (uint32_t)(clip_offset + b), 0u, 0u), k0, k1);
    v[0] = noise_one(v[0], r.x, salt, pepper, threshold);
    v[1] = noise_one(v[1], r.y, salt, pepper, threshold);
    v[2] = noise_one(v[2], r.z, salt, pepper, threshold);
    v[3] = noise_one(v[3], r.w, salt, pepper, threshold);
  }
  if (VECTOR) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (e0 + i < L) dst[i] = v[i];
  }
}

}  // namespace

// x, y: (B, L) contiguous float32; gates: (B,) uint8; clip_offset: the
// global row of clip 0, with clip_offset + B <= 2^32.  Returns cudaError_t.
extern "C" int salt_pepper_f32(const void* x, void* y, const void* salt_gates,
                               const void* pepper_gates, int64_t B, int64_t L,
                               int64_t clip_offset, uint64_t seed, uint32_t threshold,
                               void* stream) {
  if (B == 0 || L == 0) return (int)cudaSuccess;
  if (B > 65535 || clip_offset < 0 || clip_offset + B > (int64_t(1) << 32))
    return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const int64_t groups = (L + 3) / 4;
  const dim3 grid((unsigned)((groups + threads - 1) / threads), (unsigned)B);
  const uint32_t k0 = (uint32_t)(seed & 0xFFFFFFFFu), k1 = (uint32_t)(seed >> 32);
  const bool vector = (L % 4 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                      (reinterpret_cast<uintptr_t>(y) % 16 == 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* yf = static_cast<float*>(y);
  const uint8_t* sg = static_cast<const uint8_t*>(salt_gates);
  const uint8_t* pg = static_cast<const uint8_t*>(pepper_gates);
  if (vector) {
    salt_pepper_kernel<true><<<grid, threads, 0, s>>>(xf, yf, sg, pg, L, clip_offset, k0, k1, threshold);
  } else {
    salt_pepper_kernel<false><<<grid, threads, 0, s>>>(xf, yf, sg, pg, L, clip_offset, k0, k1, threshold);
  }
  return (int)cudaGetLastError();
}
