// The I3D stem: a 7x7x7 stride-2 TF-SAME convolution, C -> F channels, read
// from its spatial space-to-depth staging.
//
// Replaces the Pallas TPU kernels `stem_conv_7x7x7_s2_v8` in
// crowded_scenes_ensemble_classification_tpu/ops/pallas/stem_conv_v8.py and
// `stem_conv_7x7x7_s2` in .../ops/pallas/stem_conv.py, which compute this
// function.  They padded the s2d channels 24 -> 32 and cut 14-row chunks to
// fit the TPU's (8, 128) tiling; nothing on Hopper needs either.
//
// Input: xs = s2d_stem_stage(x), NTHWC (N, T, H/2+3, W/2+3, C4 = 4C), whose
// channels are (dy, dx, c) of a 2x2 spatial block.  Weights: wk (7, F, 16*C4)
// = s2d_stem_kernel(w) laid out as (dt, f, (dy, dx, ch)).  The stem is then
// a (7, 4, 4) conv with strides (2, 1, 1) and temporal pads (2, 3), done here
// as an implicit GEMM: M = output positions, N = F (all in one block, F <= 64),
// K = 7 * 4 * 4 * C4 (1344 for RGB) over (dt, dy, dx, ch).  The temporal pad
// is a bounds check: a tap outside [0, T) is skipped.
//
// Within one (dt, dy) band the K index (dx, ch) is dx*C4 + ch, and the staged
// element for output column c is at (c + dx)*C4 + ch = c*C4 + (dx*C4 + ch):
// a row of the GEMM's A tile is a contiguous run of the staged slab, rows
// C4 elements apart.  So the mma fragments load straight from the slab in
// shared memory, with no im2col copy.
//
// bf16: a block stages the slab of its 16x16 output tile, 7 temporal taps x
// 19 x 19 positions x C4 channels (60.6 KB for RGB), then, one temporal tap at
// a time, that tap's weights (F x 16*C4, 24.6 KB at F = 64), and runs
// mma.sync m16n8k16 (bf16 in, f32 accumulate); each of the 8 warps owns two
// output rows x 16 columns x all F channels.  f32: a plain FMA kernel, one
// thread per output element, for the f32 parity checks.
//
// Bound: operations.  At the main path's B = 16, 20x224^2, F = 64 the stem is
// 2.64e11 FLOP of the real 7^3 taps (0.267 ms at 989 TFLOP/s bf16) against
// 96 MB in and 257 MB out (0.105 ms at 3.35 TB/s).  This kernel does the
// zero-extended 8x8 spatial taps (1.31x the FLOP) on mma.sync rather than
// wgmma, loads fragments with 32-bit shared loads, stages with plain loads
// and no pipelining, and stores 4-byte pairs: a simple kernel, not yet a
// fast one.  wgmma with TMA-fed stages and a fused BN + ReLU epilogue is the
// later remedy.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int KT = 7;                    // temporal taps
constexpr int TH = 16, TW = 16;          // output rows and columns per block
constexpr int SH = TH + 3, SW = TW + 3;  // staged rows and columns (4 s2d taps)
constexpr int WARPS = 8;                 // warp w owns output rows 2w and 2w+1
constexpr int MAX_NT = 8;                // n-tiles of 8 channels: F <= 64
constexpr int WPAD = 8;                  // weight row pad (bf16): spreads banks

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D += A (16x16, row) * B (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(WARPS * 32, 2)
stem_bf16_kernel(const __nv_bfloat16* __restrict__ xs, const __nv_bfloat16* __restrict__ wk,
                 __nv_bfloat16* __restrict__ y, int T, int H2, int W2, int C4, int F,
                 int tiles_h, int tiles_w) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int To = T / 2, Ho = H2 - 3, Wo = W2 - 3;
  const int KD = 16 * C4;  // K of one temporal tap: (dy, dx, ch)
  const int WROW = KD + WPAD;
  const int plane = SH * SW * C4;
  __nv_bfloat16* slab = reinterpret_cast<__nv_bfloat16*>(smem);  // [KT][SH][SW][C4]
  __nv_bfloat16* ws = slab + KT * plane;                          // [F][WROW]

  int tile = blockIdx.x;
  const int c0 = (tile % tiles_w) * TW;
  tile /= tiles_w;
  const int r0 = (tile % tiles_h) * TH;
  tile /= tiles_h;
  const int to = tile % To;
  const int n = tile / To;

  // Stage the slab.  Each staged row is SW*C4 contiguous elements of xs
  // (even counts at even offsets, so 32-bit words); rows and columns past
  // the tensor feed only outputs that are not stored, and are zeros.
  const int row_words = SW * C4 / 2;
  const int valid_words = min(SW, W2 - c0) * C4 / 2;
  for (int dt = 0; dt < KT; ++dt) {
    const int t_in = 2 * to - 2 + dt;
    if (t_in < 0 || t_in >= T) continue;
    uint32_t* dst = reinterpret_cast<uint32_t*>(slab + dt * plane);
    const __nv_bfloat16* src_t = xs + (((int64_t)n * T + t_in) * H2) * (int64_t)W2 * C4 + (int64_t)c0 * C4;
    for (int i = threadIdx.x; i < SH * row_words; i += blockDim.x) {
      const int rr = i / row_words, wd = i - rr * row_words;
      uint32_t v = 0;
      if (r0 + rr < H2 && wd < valid_words)
        v = __ldg(reinterpret_cast<const uint32_t*>(src_t + (int64_t)(r0 + rr) * W2 * C4) + wd);
      dst[i] = v;
    }
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;  // mma fragment row group, thread in group
  const int nts = F / 8;
  float acc[2][MAX_NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < MAX_NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;

  for (int dt = 0; dt < KT; ++dt) {
    const int t_in = 2 * to - 2 + dt;
    if (t_in < 0 || t_in >= T) continue;  // the same for the whole block
    __syncthreads();                      // the previous tap's weights are consumed
    {
      const uint32_t* src = reinterpret_cast<const uint32_t*>(wk + (int64_t)dt * F * KD);
      uint32_t* dst = reinterpret_cast<uint32_t*>(ws);
      const int kw = KD / 2, rw = WROW / 2;
      for (int i = threadIdx.x; i < F * kw; i += blockDim.x) {
        const int f = i / kw;
        dst[f * rw + (i - f * kw)] = __ldg(src + i);
      }
    }
    __syncthreads();
    const __nv_bfloat16* sl = slab + dt * plane;
#pragma unroll
    for (int dy = 0; dy < 4; ++dy) {
      for (int kk = 2 * t4; kk < 4 * C4; kk += 16) {  // 16-wide K steps of the (dt, dy) band
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          // A row m = output column m of row 2*warp + mt; K column kk.
          const __nv_bfloat16* p = sl + ((2 * warp + mt + dy) * SW + g) * C4 + kk;
          a[mt][0] = lds32(p);               // row g,     k kk, kk+1
          a[mt][1] = lds32(p + 8 * C4);      // row g + 8
          a[mt][2] = lds32(p + 8);           // row g,     k kk+8, kk+9
          a[mt][3] = lds32(p + 8 * C4 + 8);  // row g + 8, k kk+8, kk+9
        }
#pragma unroll
        for (int nt = 0; nt < MAX_NT; ++nt) {
          if (nt < nts) {
            const __nv_bfloat16* q = ws + (nt * 8 + g) * WROW + dy * 4 * C4 + kk;
            const uint32_t b0 = lds32(q), b1 = lds32(q + 8);
            mma_16816(acc[0][nt], a[0], b0, b1);
            mma_16816(acc[1][nt], a[1], b0, b1);
          }
        }
      }
    }
  }

  // acc[mt][nt]: {0,1} at row g, {2,3} at row g+8; channels nt*8 + 2*t4 + {0,1}.
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int ho = r0 + 2 * warp + mt;
    if (ho >= Ho) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int wo = c0 + g + 8 * half;
      if (wo >= Wo) continue;
      __nv_bfloat16* out = y + ((((int64_t)n * To + to) * Ho + ho) * Wo + wo) * F + 2 * t4;
#pragma unroll
      for (int nt = 0; nt < MAX_NT; ++nt)
        if (nt < nts)
          *reinterpret_cast<__nv_bfloat162*>(out + nt * 8) =
              __floats2bfloat162_rn(acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
    }
  }
}

__global__ void stem_f32_kernel(const float* __restrict__ xs, const float* __restrict__ wk,
                                float* __restrict__ y, int64_t N, int T, int H2, int W2,
                                int C4, int F) {
  const int To = T / 2, Ho = H2 - 3, Wo = W2 - 3, KD = 16 * C4;
  const int64_t total = N * To * Ho * Wo * F;
  for (int64_t idx = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; idx < total;
       idx += (int64_t)gridDim.x * blockDim.x) {
    const int f = (int)(idx % F);
    int64_t pos = idx / F;
    const int wo = (int)(pos % Wo);
    pos /= Wo;
    const int ho = (int)(pos % Ho);
    pos /= Ho;
    const int to = (int)(pos % To);
    const int64_t n = pos / To;
    float acc = 0.0f;
    for (int dt = 0; dt < KT; ++dt) {
      const int t_in = 2 * to - 2 + dt;
      if (t_in < 0 || t_in >= T) continue;
      const float* w = wk + ((int64_t)dt * F + f) * KD;
      for (int dy = 0; dy < 4; ++dy) {
        const float* x = xs + (((n * T + t_in) * H2 + ho + dy) * W2 + wo) * C4;
        for (int j = 0; j < 4 * C4; ++j) acc = fmaf(x[j], w[dy * 4 * C4 + j], acc);
      }
    }
    y[idx] = acc;
  }
}

}  // namespace

// xs (N, T, H2, W2, C4) and wk (7, F, 16*C4) contiguous, y (N, T/2, H2-3,
// W2-3, F).  T even, C4 % 4 == 0; bf16 needs F % 8 == 0 and F <= 64.
// dtype: 0 = float32, 1 = bfloat16.  Returns the launch's cudaError_t.
extern "C" int stem_conv_s2d(const void* xs, const void* wk, void* y, int64_t N, int64_t T,
                             int64_t H2, int64_t W2, int64_t C4, int64_t F, int dtype,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T % 2 || C4 % 4 || H2 < 4 || W2 < 4 || F < 1) return (int)cudaErrorInvalidValue;
  const int64_t To = T / 2, Ho = H2 - 3, Wo = W2 - 3;
  if (N == 0 || To == 0) return (int)cudaSuccess;
  if (dtype == 0) {
    const int threads = 256;
    int64_t blocks = (N * To * Ho * Wo * F + threads - 1) / threads;
    if (blocks > (int64_t)1 << 30) blocks = (int64_t)1 << 30;  // grid-stride beyond
    stem_f32_kernel<<<(unsigned)blocks, threads, 0, s>>>(
        static_cast<const float*>(xs), static_cast<const float*>(wk), static_cast<float*>(y),
        N, (int)T, (int)H2, (int)W2, (int)C4, (int)F);
    return (int)cudaGetLastError();
  }
  if (dtype != 1 || F % 8 || F > 8 * MAX_NT) return (int)cudaErrorInvalidValue;
  const int64_t tiles_h = (Ho + TH - 1) / TH, tiles_w = (Wo + TW - 1) / TW;
  const int64_t blocks = N * To * tiles_h * tiles_w;
  if (blocks >= (int64_t)1 << 31) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(KT * SH * SW * C4 + F * (16 * C4 + WPAD)) * sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(stem_bf16_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  stem_bf16_kernel<<<(unsigned)blocks, WARPS * 32, smem, s>>>(
      static_cast<const __nv_bfloat16*>(xs), static_cast<const __nv_bfloat16*>(wk),
      static_cast<__nv_bfloat16*>(y), (int)T, (int)H2, (int)W2, (int)C4, (int)F,
      (int)tiles_h, (int)tiles_w);
  return (int)cudaGetLastError();
}
