// int8 x int8 -> int32 3D convolution (implicit GEMM) with the dequantize in
// its epilogue: y[m, f] = float(acc[m, f]) * scale[f] (+ bias[f]), f32 NDHWC.
//
// Replaces no Pallas kernel: the JAX package leaves its int8 contraction to
// XLA, `jax.lax.conv_general_dilated(x8, k8, preferred_element_type=int32)`
// in crowded_scenes_ensemble_classification_tpu/models/common.py
// (`quant_conv_general`, line 111; `static_quant_conv_general`, line 176),
// and PyTorch has no int8 conv3d on CUDA.  The wrapper and the plain version
// (an exact float64 `F.conv3d` on the int8 values) are in
// ops/kernels/int8_conv.py.
//
// GEMM view: M = N*Do*Ho*Wo output positions, N_gemm = F output channels,
// K in (tap, channel) order.  x is int8 NDHWC; the weights are packed once
// per module as (Fpad, Kpad) int8, K contiguous, zero past F and K
// (`pack_int8_weights`).  Where C is not a multiple of 16 but at least 8,
// each tap's channels are padded to Cp = the next multiple of 16 (zero
// weights), so that a 16-byte chunk of K never straddles two taps; below
// 8 channels (C3D's and R3D's C = 3) K is taps*C unpadded.  Strides and
// (before) zero pads are per axis; the output extent carries the (after)
// pads, so TF-SAME's asymmetric pads need nothing more.
//
// Bound: at the I3D shapes the int8 operations (2*M*F*K over 1,979 TOPS)
// bound the big convs and the f32 output bytes the 1x1 ones with few input
// channels.  This first design is simple and right, not yet fast: a block
// computes a 128 x 64 output tile with 8 warps of mma.sync m16n8k32 s8 (each
// warp 32 x 32), K in steps of 64 through two shared-memory buffers that
// are filled from registers loaded during the previous step's products.
// Each thread gathers one 16-byte chunk of K for two rows of the A tile: a
// tap cursor, advanced 64 bytes a step, gives the chunk's tap and channel
// without a division, and the chunk loads as one 16-, two 8-, four 4- or
// sixteen 1-byte loads, whichever C and the alignment allow (`vec`), zero
// where the tap falls in the padding or past C.  Rows of 64 bytes are
// padded to 80 so the fragment loads of a warp hit 32 distinct banks.
// The dequantize is __fmul_rn then __fadd_rn: no FMA contraction, so the
// output equals the plain version bit for bit.  wgmma, TMA and a fused
// quantize/BN epilogue are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 64, BK = 64, THREADS = 256;
constexpr int ROW = BK + 16;  // bytes per shared-memory row

struct Conv {
  const int8_t* x;
  const int8_t* wp;
  const float* scale;
  const float* bias;
  float* y;
  int64_t D, H, W, Do, Ho, Wo, F, Kpad, M;
  int C, Cp, K, kd, kh, kw, khw, sd, sh, sw, pd, ph, pw;  // K = kd*kh*kw*Cp
};

// One output row's input origin.
struct RowOrigin {
  int64_t base;  // offset of image n in x
  int d0, h0, w0;
  bool valid;
};

__device__ __forceinline__ RowOrigin row_origin(const Conv& p, int64_t m) {
  RowOrigin r;
  r.valid = m < p.M;
  const int64_t mm = r.valid ? m : 0;
  const int64_t ow = mm % p.Wo;
  int64_t t = mm / p.Wo;
  const int64_t oh = t % p.Ho;
  t /= p.Ho;
  const int64_t od = t % p.Do;
  const int64_t n = t / p.Do;
  r.base = n * p.D * p.H * p.W * (int64_t)p.C;
  r.d0 = (int)(od * p.sd) - p.pd;
  r.h0 = (int)(oh * p.sh) - p.ph;
  r.w0 = (int)(ow * p.sw) - p.pw;
  return r;
}

// Where a reduction index k lies: channel c of tap (td, th, tw).
struct TapCursor {
  int c, td, th, tw;
};

__device__ __forceinline__ TapCursor cursor_at(const Conv& p, int k) {
  TapCursor q;
  const int tap = k / p.Cp;
  q.c = k - tap * p.Cp;
  q.td = tap / p.khw;
  const int rest = tap - q.td * p.khw;
  q.th = rest / p.kw;
  q.tw = rest - q.th * p.kw;
  return q;
}

// k += step, walking the taps in (td, th, tw) order.
__device__ __forceinline__ void advance(const Conv& p, TapCursor& q, int step) {
  q.c += step;
  while (q.c >= p.Cp) {
    q.c -= p.Cp;
    if (++q.tw == p.kw) {
      q.tw = 0;
      if (++q.th == p.kh) {
        q.th = 0;
        ++q.td;
      }
    }
  }
}

// Address of x at the cursor for this row, or nullptr where the tap lies
// in the padding or past the kernel.
__device__ __forceinline__ const int8_t* tap_address(const Conv& p, const RowOrigin& r, const TapCursor& q) {
  if (!r.valid || q.td >= p.kd) return nullptr;
  const int d = r.d0 + q.td, h = r.h0 + q.th, w = r.w0 + q.tw;
  if (d < 0 || d >= p.D || h < 0 || h >= p.H || w < 0 || w >= p.W) return nullptr;
  return p.x + r.base + ((((int64_t)d * p.H + h) * p.W + w) * p.C + q.c);
}

// 16 bytes of the A tile for one row: channels q.c .. q.c+15 of one tap
// (Cp % 16 == 0), the part below C in VEC-byte loads, zero past it.
template <int VEC>
__device__ __forceinline__ uint4 load_tap_chunk(const Conv& p, const RowOrigin& r, const TapCursor& q) {
  uint4 out = make_uint4(0u, 0u, 0u, 0u);
  const int8_t* src = tap_address(p, r, q);
  if (!src) return out;
  if (VEC == 16) {
    out = __ldg(reinterpret_cast<const uint4*>(src));
  } else if (VEC == 8) {
    uint2 v[2];
#pragma unroll
    for (int s = 0; s < 2; ++s)
      v[s] = q.c + 8 * s < p.C ? __ldg(reinterpret_cast<const uint2*>(src) + s) : make_uint2(0u, 0u);
    out = make_uint4(v[0].x, v[0].y, v[1].x, v[1].y);
  } else if (VEC == 4) {
    uint32_t v[4];
#pragma unroll
    for (int s = 0; s < 4; ++s)
      v[s] = q.c + 4 * s < p.C ? __ldg(reinterpret_cast<const unsigned int*>(src) + s) : 0u;
    out = make_uint4(v[0], v[1], v[2], v[3]);
  } else {
    uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int s = 0; s < 16; ++s)
      if (q.c + s < p.C) v[s >> 2] |= (uint32_t)(uint8_t)__ldg(src + s) << (8 * (s & 3));
    out = make_uint4(v[0], v[1], v[2], v[3]);
  }
  return out;
}

// 16 bytes of the A tile for one row with K = taps*C unpadded (C < 8):
// each byte at its own tap, zero in the padding and past K.
__device__ __forceinline__ uint4 load_flat_chunk(const Conv& p, const RowOrigin& r, int k) {
  uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int s = 0; s < 16; ++s) {
    if (k + s >= p.K) break;
    const int8_t* src = tap_address(p, r, cursor_at(p, k + s));
    if (src) v[s >> 2] |= (uint32_t)(uint8_t)__ldg(src) << (8 * (s & 3));
  }
  return make_uint4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float dequant(int acc, float scale, float bias, bool has_bias) {
  const float v = __fmul_rn(__int2float_rn(acc), scale);
  return has_bias ? __fadd_rn(v, bias) : v;
}

// VEC > 0: the padded (tap, channel) layout loaded VEC bytes at a time;
// VEC == 0: the unpadded layout of C < 8, byte by byte.
template <int VEC>
__global__ void __launch_bounds__(THREADS) int8_conv3d_kernel(const Conv p) {
  __shared__ __align__(16) int8_t As[2][BM][ROW];
  __shared__ __align__(16) int8_t Bs[2][BN][ROW];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;  // warp tile: rows wm*32, channels wn*32
  const int64_t m0 = (int64_t)blockIdx.x * BM;
  const int64_t f0 = (int64_t)blockIdx.y * BN;

  // This thread fills rows tid/4 and tid/4 + 64 of A and row tid/4 of B, at
  // byte kc of each 64-byte K step.
  const int arow = tid >> 2, kc = (tid & 3) * 16;
  const RowOrigin r0 = row_origin(p, m0 + arow), r1 = row_origin(p, m0 + arow + 64);
  const int8_t* bsrc = p.wp + (f0 + arow) * p.Kpad + kc;

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int steps = (int)(p.Kpad / BK);
  TapCursor q = cursor_at(p, kc);
  auto load_a = [&](const RowOrigin& r, int k) {
    return VEC ? load_tap_chunk<VEC ? VEC : 16>(p, r, q) : load_flat_chunk(p, r, k);
  };
  uint4 ra0 = load_a(r0, kc), ra1 = load_a(r1, kc);
  uint4 rb = __ldg(reinterpret_cast<const uint4*>(bsrc));
  for (int it = 0; it < steps; ++it) {
    const int buf = it & 1;
    *reinterpret_cast<uint4*>(&As[buf][arow][kc]) = ra0;
    *reinterpret_cast<uint4*>(&As[buf][arow + 64][kc]) = ra1;
    *reinterpret_cast<uint4*>(&Bs[buf][arow][kc]) = rb;
    __syncthreads();  // with two buffers, one barrier a step suffices
    if (it + 1 < steps) {
      const int k = (it + 1) * BK + kc;
      if (VEC) advance(p, q, BK);
      ra0 = load_a(r0, k);
      ra1 = load_a(r1, k);
      rb = __ldg(reinterpret_cast<const uint4*>(bsrc + (int64_t)(it + 1) * BK));
    }
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = wm * 32 + i * 16 + g;
        a[i][0] = *reinterpret_cast<const uint32_t*>(&As[buf][row][ks + t * 4]);
        a[i][1] = *reinterpret_cast<const uint32_t*>(&As[buf][row + 8][ks + t * 4]);
        a[i][2] = *reinterpret_cast<const uint32_t*>(&As[buf][row][ks + 16 + t * 4]);
        a[i][3] = *reinterpret_cast<const uint32_t*>(&As[buf][row + 8][ks + 16 + t * 4]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = wn * 32 + j * 8 + g;
        b[j][0] = *reinterpret_cast<const uint32_t*>(&Bs[buf][col][ks + t * 4]);
        b[j][1] = *reinterpret_cast<const uint32_t*>(&Bs[buf][col][ks + 16 + t * 4]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
  }

  // Epilogue: accumulator e of tile (i, j) is row g (+8 for e >= 2), column
  // 2t (+1 for odd e) of that 16 x 8 tile.
  const bool has_bias = p.bias != nullptr;
  const bool pairs = (p.F & 1) == 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int64_t f = f0 + wn * 32 + j * 8 + 2 * t;
    if (f >= p.F) continue;
    const bool second = f + 1 < p.F;
    const float s0 = __ldg(p.scale + f), s1 = second ? __ldg(p.scale + f + 1) : 0.0f;
    const float b0 = has_bias ? __ldg(p.bias + f) : 0.0f;
    const float b1 = (has_bias && second) ? __ldg(p.bias + f + 1) : 0.0f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int64_t m = m0 + wm * 32 + i * 16 + g + 8 * half;
        if (m >= p.M) continue;
        const float v0 = dequant(acc[i][j][2 * half], s0, b0, has_bias);
        const float v1 = dequant(acc[i][j][2 * half + 1], s1, b1, has_bias);
        float* dst = p.y + m * p.F + f;
        if (pairs) {
          *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
        } else {
          dst[0] = v0;
          if (second) dst[1] = v1;
        }
      }
    }
  }
}

}  // namespace

// x: (N, D, H, W, C) int8 contiguous; wp: (Fpad, Kpad) int8, Fpad % 64 == 0,
// Kpad % 64 == 0, Kpad >= kd*kh*kw*Cp, with each tap's channels padded to
// Cp (= C, or a multiple of 16 above C: `padded_channels`); scale: (F,)
// f32; bias: (F,) f32 or null; y: (N, Do, Ho, Wo, F) f32.  vec in
// {16, 8, 4, 1} must divide C and the alignment of x.  Returns cudaError_t.
extern "C" int int8_conv3d(const void* x, const void* wp, const void* scale, const void* bias, void* y,
                           int64_t N, int64_t D, int64_t H, int64_t W, int64_t C,
                           int64_t Do, int64_t Ho, int64_t Wo, int64_t F, int64_t Kpad,
                           int kd, int kh, int kw, int sd, int sh, int sw, int pd, int ph, int pw,
                           int Cp, int vec, void* stream) {
  Conv p;
  p.x = static_cast<const int8_t*>(x);
  p.wp = static_cast<const int8_t*>(wp);
  p.scale = static_cast<const float*>(scale);
  p.bias = static_cast<const float*>(bias);
  p.y = static_cast<float*>(y);
  p.D = D; p.H = H; p.W = W; p.C = (int)C; p.Cp = (int)Cp;
  p.Do = Do; p.Ho = Ho; p.Wo = Wo; p.F = F; p.Kpad = Kpad;
  p.M = N * Do * Ho * Wo;
  const int64_t K = (int64_t)kd * kh * kw * Cp;
  p.K = (int)K;
  p.kd = kd; p.kh = kh; p.kw = kw; p.khw = kh * kw;
  p.sd = sd; p.sh = sh; p.sw = sw; p.pd = pd; p.ph = ph; p.pw = pw;
  if (p.M == 0 || F == 0) return (int)cudaSuccess;
  if (Kpad % BK || Kpad < K || K >= (1ll << 30) || C <= 0 || vec <= 0 || C % vec || (Cp != C && (Cp % 16 || Cp < C)))
    return (int)cudaErrorInvalidValue;
  const int64_t fparts = (F + BN - 1) / BN;
  const int64_t mtiles = (p.M + BM - 1) / BM;
  if (fparts > 65535 || mtiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)mtiles, (unsigned)fparts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (Cp % 16 ? 0 : vec) {
    case 16: int8_conv3d_kernel<16><<<grid, THREADS, 0, s>>>(p); break;
    case 8: int8_conv3d_kernel<8><<<grid, THREADS, 0, s>>>(p); break;
    case 4: int8_conv3d_kernel<4><<<grid, THREADS, 0, s>>>(p); break;
    case 1: int8_conv3d_kernel<1><<<grid, THREADS, 0, s>>>(p); break;
    case 0: int8_conv3d_kernel<0><<<grid, THREADS, 0, s>>>(p); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
