// The I3D stem: a 7x7x7 stride-2 TF-SAME convolution, C -> F channels, read
// from its spatial space-to-depth staging.
//
// Replaces the Pallas TPU kernels `stem_conv_7x7x7_s2_v8` in
// crowded_scenes_ensemble_classification_tpu/ops/pallas/stem_conv_v8.py and
// `stem_conv_7x7x7_s2` in .../ops/pallas/stem_conv.py, which compute this
// function.  They padded the s2d channels 24 -> 32 and cut 14-row chunks to
// fit the TPU's (8, 128) tiling; nothing on Hopper needs either.
//
// The staging xs (N, T, H/2+3, W2, C4 = 4C) holds the channels (dy, dx, c)
// of a 2x2 spatial block, and the stem is a (7, 4, 4) conv of it with
// strides (2, 1, 1) and temporal pads (2, 3): an implicit GEMM with
// M = output positions, N = F, K = 7 * 4 * 4 * C4 (1344 for RGB) over
// (dt, dy, dx, ch).  The temporal pad is a bounds check: a tap outside
// [0, T) is skipped.  Within one (dt, dy) band the K index (dx, ch) is
// dx*C4 + ch, and the staged element for output column c is at
// (c + dx)*C4 + ch = c*C4 + (dx*C4 + ch): a row of the GEMM's A tile is a
// contiguous run of the staged slab, rows C4 elements apart.  So the mma
// fragments load straight from the slab in shared memory, with no im2col.
//
// bf16 (the path the models run), on `s2d_stem_stage_even` and
// `pack_stem_weights` of ops/kernels/stem_conv.py:
// - The staging's W2 is padded to even, so every staged row is a multiple
//   of 16 bytes (116 * 24 = 2784 B at 224^2) and the slab moves by 16-byte
//   cp.async.cg copies.  A slab row is SW = 19 positions rounded up to
//   16 bytes (464 B for RGB); the 8 extra bytes come from the next position,
//   or are zero-filled past the row's end.
// - A block computes one F-part of FP = 32 output channels.  Its weights
//   for all 7 temporal taps, packed by the wrapper as (part, dt, 32,
//   16*C4 + 8) so that the copy is the shared-memory image (89,600 B for
//   RGB), are loaded once and stay resident: no per-tap restaging and no
//   barrier pair per tap.
// - Persistent blocks: one per SM, half of them on each F-part.  Each walks
//   the 16x16 output tiles of (n, to) in the same order as its twin on the
//   other part, so the second read of a slab hits L2.  Two slab buffers:
//   the next tile's slab is in flight (cp.async, wait_group 1) while the 8
//   warps run mma.sync m16n8k16 (bf16 in, f32 accumulate) on the current
//   one.  Shared memory: 89,600 + 2 * 7 * 19 * 464 = 213,024 B for RGB.
//   C = 4 (C4 = 16) would need 280,000 B and is refused.
// - Warp w owns 4 output rows (4*(w % 4) ..) x 16 columns x 16 of the
//   part's 32 channels (n-tiles 2*(w / 4), +1).  For each 16-wide K step
//   it loads the A fragments of its 7 slab rows once and uses each for
//   every output row that reads it (slab row 4*(w % 4) + mt + dy): 44
//   32-bit shared loads per 32 mma, where loads per output row would
//   take 80.
//   With C4 = 12 (or 4) fragment row group g takes output columns 2g and
//   2g+1, so the 8 groups of one load fall on 32 distinct banks
//   (consecutive columns would collide 2-way); weight rows are 8 bf16
//   longer than K, 4 banks apart, so B loads are conflict-free too.  Parts
//   of 32 channels run with no per-n-tile test, and the tap loop is
//   unrolled so loads of one tap overlap the mma of the last.
// - Epilogue: per output row the quad (4 threads of a fragment row)
//   transposes its bf16 pairs with 3 shuffles, so each thread stores 16
//   contiguous bytes, 8 channels of one position.
// - What holds it now: 2 warps per scheduler issue mma.sync chains that
//   wait on their own fragment loads, so latency, not the shared-memory
//   pipe or the tensor cores' rate, sets the time (PERF.md, section 6).
//   wgmma's asynchronous issue from shared memory is the remedy.
// f32: a plain FMA kernel, one thread per output element, for the f32
// parity checks.
//
// Bound: operations.  At B = 16, 20x224^2, F = 64 the stem is 2.64e11 FLOP
// of the real 7^3 taps (0.267 ms at 989 TFLOP/s bf16) against 96 MB in and
// 257 MB out (0.105 ms at 3.35 TB/s).  This kernel does the zero-extended
// 8x8 spatial taps (1.31x the FLOP) on mma.sync; wgmma, TMA and reading x
// without the staging copy are the later steps.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int KT = 7;                    // temporal taps
constexpr int TH = 16, TW = 16;          // output rows and columns per tile
constexpr int SH = TH + 3, SW = TW + 3;  // staged rows and columns (4 s2d taps)
constexpr int WARPS = 8;
constexpr int FP = 32;                   // output channels of one F-part (one block)
constexpr int NT = FP / 8;               // its n-tiles of 8 channels
constexpr int WROWS = 4, WNT = 2;        // a warp's output rows and n-tiles
static_assert(WARPS * WROWS * WNT == TH * NT, "the warps cover the tile");
constexpr int WPAD = 8;                  // weight row pad (bf16): rows 4 banks apart

// Bytes of one staged slab row, of one F-part's packed weights, and of a
// block's shared memory (the weights and two slab buffers).
__host__ __device__ constexpr int slab_row_bytes(int c4) { return (SW * c4 * 2 + 15) / 16 * 16; }
__host__ __device__ constexpr int part_weight_bytes(int c4) { return KT * FP * (16 * c4 + WPAD) * 2; }
__host__ __device__ constexpr int slab_bytes(int c4) { return KT * SH * slab_row_bytes(c4); }
__host__ __device__ constexpr int bf16_smem_bytes(int c4) { return part_weight_bytes(c4) + 2 * slab_bytes(c4); }

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// 16-byte global -> shared copy through L2 only; src_bytes = 0 writes zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

// D += A (16x16, row) * B (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct Tile {
  int n, to, r0, c0;
};

__device__ __forceinline__ Tile decode_tile(int tile, int tiles_h, int tiles_w, int To) {
  Tile t;
  t.c0 = (tile % tiles_w) * TW;
  tile /= tiles_w;
  t.r0 = (tile % tiles_h) * TH;
  tile /= tiles_h;
  t.to = tile % To;
  t.n = tile / To;
  return t;
}

// Issue the cp.asyncs of a tile's slab, [KT][SH][slab row], into `dst`:
// one staged row per warp, one 16-byte chunk per lane.  Rows of skipped
// temporal taps are not copied; rows past H2 and chunks past the staged
// row's end are zero-filled (they feed only outputs that are not stored).
template <int C4>
__device__ __forceinline__ void load_slab(uint32_t dst, const char* xs, const Tile& tl, int T, int H2,
                                          int64_t row_bytes, int warp, int lane) {
  constexpr int SROW = slab_row_bytes(C4), CHUNKS = SROW / 16;
  static_assert(CHUNKS <= 32, "one chunk per lane");
  const int64_t col_byte = (int64_t)tl.c0 * C4 * 2 + lane * 16;
  for (int row = warp; row < KT * SH; row += WARPS) {
    const int dt = row / SH, rr = row - dt * SH;
    const int t_in = 2 * tl.to - 2 + dt, r = tl.r0 + rr;
    if (t_in < 0 || t_in >= T || lane >= CHUNKS) continue;
    const bool ok = r < H2 && col_byte < row_bytes;
    const char* src = ok ? xs + (((int64_t)tl.n * T + t_in) * H2 + r) * row_bytes + col_byte : xs;
    cp_async16(dst + row * SROW + lane * 16, src, ok ? 16 : 0);
  }
}

// The tile's GEMM for this warp: acc[mt][j] += output row row0 + mt,
// channels (nt0 + j)*8.. of the part, over every temporal tap inside
// [0, T).  FULL: both n-tiles lie inside F (no per-n-tile test).
template <int C4, bool FULL>
__device__ __forceinline__ void mma_tile(float (&acc)[WROWS][WNT][4], const __nv_bfloat16* slab,
                                         const __nv_bfloat16* ws, int to, int T, int nts, int row0,
                                         int nt0, int col0, int col1, int t4, int g) {
  constexpr int SROWE = slab_row_bytes(C4) / 2, WROW = 16 * C4 + WPAD;
#pragma unroll
  for (int dt = 0; dt < KT; ++dt) {
    const int t_in = 2 * to - 2 + dt;
    if (t_in < 0 || t_in >= T) continue;  // the same for the whole block
    const __nv_bfloat16* sl = slab + (dt * SH + row0) * SROWE;
    const __nv_bfloat16* wd = ws + (dt * FP + nt0 * 8 + g) * WROW;
#pragma unroll
    for (int ks = 0; ks < C4 / 4; ++ks) {  // 16-wide K steps of a (dt, dy) band of 4*C4
      const int kk = 16 * ks + 2 * t4;
      uint32_t a[WROWS + 3][4];  // A fragments of slab rows row0 + s
#pragma unroll
      for (int s = 0; s < WROWS + 3; ++s) {
        const __nv_bfloat16* p = sl + s * SROWE + kk;
        a[s][0] = lds32(p + col0 * C4);      // fragment row g,     k kk, kk+1
        a[s][1] = lds32(p + col1 * C4);      // fragment row g + 8
        a[s][2] = lds32(p + col0 * C4 + 8);  // row g,     k kk+8, kk+9
        a[s][3] = lds32(p + col1 * C4 + 8);  // row g + 8, k kk+8, kk+9
      }
#pragma unroll
      for (int dy = 0; dy < 4; ++dy) {
#pragma unroll
        for (int j = 0; j < WNT; ++j) {
          if (FULL || nt0 + j < nts) {
            const __nv_bfloat16* q = wd + j * 8 * WROW + dy * 4 * C4 + kk;
            const uint32_t b0 = lds32(q), b1 = lds32(q + 8);
#pragma unroll
            for (int mt = 0; mt < WROWS; ++mt) mma_16816(acc[mt][j], a[mt + dy], b0, b1);
          }
        }
      }
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Store a warp's tile.  acc[mt][j] {0,1} sit at fragment row g (output
// column col0), {2,3} at row g + 8 (col1), channels (nt0 + j)*8 + 2*t4 +
// {0,1}.  Per output row the quad holds 2 columns x 2 n-tiles x 4 pairs;
// it transposes them so that thread t4 holds the 4 pairs of column
// t4 >> 1, n-tile t4 & 1: one 16-byte store of 8 channels.
__device__ __forceinline__ void store_tile(const float (&acc)[WROWS][WNT][4], __nv_bfloat16* y,
                                           const Tile& tl, int To, int Ho, int Wo, int F, int part,
                                           int nts, int row0, int nt0, int col0, int col1, int t4) {
  const int wo = tl.c0 + (t4 >> 1 ? col1 : col0), nt = nt0 + (t4 & 1);
#pragma unroll
  for (int mt = 0; mt < WROWS; ++mt) {
    uint32_t v[4], o[4];  // v[2*half + j]: this thread's pair of (column half, n-tile j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[i] = pack_bf16x2(acc[mt][i & 1][2 * (i >> 1)], acc[mt][i & 1][2 * (i >> 1) + 1]);
      o[i] = v[i];  // o[t4] = v[t4] stays; the others come from the quad
    }
#pragma unroll
    for (int s = 1; s < 4; ++s) {
      const int p = t4 ^ s;  // partner: sends its v[t4], which lands in o[p]
      const uint32_t send = p == 0 ? v[0] : p == 1 ? v[1] : p == 2 ? v[2] : v[3];
      const uint32_t got = __shfl_xor_sync(0xffffffffu, send, s);
#pragma unroll
      for (int i = 0; i < 4; ++i) o[i] = i == p ? got : o[i];
    }
    const int ho = tl.r0 + row0 + mt;
    if (ho < Ho && wo < Wo && nt < nts) {
      __nv_bfloat16* out =
          y + ((((int64_t)tl.n * To + tl.to) * Ho + ho) * Wo + wo) * F + part * FP + nt * 8;
      __stcs(reinterpret_cast<uint4*>(out), make_uint4(o[0], o[1], o[2], o[3]));
    }
  }
}

template <int C4>
__global__ void __launch_bounds__(WARPS * 32, 1)
stem_bf16_kernel(const __nv_bfloat16* __restrict__ xs, const __nv_bfloat16* __restrict__ wp,
                 __nv_bfloat16* __restrict__ y, int T, int H2, int W2p, int Ho, int Wo, int F,
                 int parts, int tiles_h, int tiles_w, int tiles) {
  constexpr int WBYTES = part_weight_bytes(C4), SLAB = slab_bytes(C4);
  extern __shared__ __align__(16) unsigned char smem[];
  const int per_part = gridDim.x / parts;
  const int part = blockIdx.x / per_part;
  int tile = blockIdx.x - part * per_part;
  if (tile >= tiles) return;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;  // mma fragment row group, thread in group
  const int row0 = WROWS * (warp % (TH / WROWS)), nt0 = WNT * (warp / (TH / WROWS));
  // Output columns of fragment rows g and g + 8: even and odd columns where
  // C4 % 8 != 0 (32 distinct banks per load), else g and g + 8.
  const int col0 = C4 % 8 ? 2 * g : g, col1 = C4 % 8 ? 2 * g + 1 : g + 8;
  const int nts = min(NT, (F - part * FP) / 8);
  const bool full = nts == NT;
  const int To = T / 2;
  const int64_t row_bytes = (int64_t)W2p * C4 * 2;
  const char* xb = reinterpret_cast<const char*>(xs);
  const uint32_t s_w = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t s_slab = s_w + WBYTES;
  const __nv_bfloat16* ws = reinterpret_cast<const __nv_bfloat16*>(smem);

  // This part's weights, once for the block's life, with the first slab.
  const char* wsrc = reinterpret_cast<const char*>(wp) + (int64_t)part * WBYTES;
  for (int i = threadIdx.x; i < WBYTES / 16; i += blockDim.x) cp_async16(s_w + i * 16, wsrc + i * 16, 16);
  Tile cur = decode_tile(tile, tiles_h, tiles_w, To);
  load_slab<C4>(s_slab, xb, cur, T, H2, row_bytes, warp, lane);
  cp_async_commit();

  for (int k = 0; tile < tiles; ++k, tile += per_part) {
    // The next tile's slab goes into the other buffer, which every warp
    // finished reading before the barrier that ended the last iteration.
    const int next = tile + per_part;
    Tile nxt = cur;
    if (next < tiles) {
      nxt = decode_tile(next, tiles_h, tiles_w, To);
      load_slab<C4>(s_slab + ((k + 1) & 1) * SLAB, xb, nxt, T, H2, row_bytes, warp, lane);
    }
    cp_async_commit();    // possibly empty: one group per iteration
    cp_async_wait_one();  // all but the newest group: this tile's slab (and the weights)
    __syncthreads();

    float acc[WROWS][WNT][4];
#pragma unroll
    for (int mt = 0; mt < WROWS; ++mt)
#pragma unroll
      for (int j = 0; j < WNT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][j][i] = 0.0f;
    const __nv_bfloat16* slab = reinterpret_cast<const __nv_bfloat16*>(smem + WBYTES + (k & 1) * SLAB);
    if (full)
      mma_tile<C4, true>(acc, slab, ws, cur.to, T, nts, row0, nt0, col0, col1, t4, g);
    else if (nt0 < nts)  // a warp whose n-tiles all lie past F has no work
      mma_tile<C4, false>(acc, slab, ws, cur.to, T, nts, row0, nt0, col0, col1, t4, g);
    store_tile(acc, y, cur, To, Ho, Wo, F, part, nts, row0, nt0, col0, col1, t4);
    __syncthreads();
    cur = nxt;
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

template <int C4>
cudaError_t launch_bf16(const void* xs, const void* wp, void* y, int grid, int smem, int T, int H2,
                        int W2p, int Ho, int Wo, int F, int parts, int tiles_h, int tiles_w, int tiles,
                        cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(stem_bf16_kernel<C4>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  stem_bf16_kernel<C4><<<grid, WARPS * 32, smem, s>>>(
      static_cast<const __nv_bfloat16*>(xs), static_cast<const __nv_bfloat16*>(wp),
      static_cast<__nv_bfloat16*>(y), T, H2, W2p, Ho, Wo, F, parts, tiles_h, tiles_w, tiles);
  return cudaGetLastError();
}

}  // namespace

// xs (N, T, H2, W2, C4) and wk (7, F, 16*C4) f32 contiguous, y (N, T/2,
// H2-3, W2-3, F).  T even, C4 % 4 == 0.  Returns the launch's cudaError_t.
extern "C" int stem_conv_s2d_f32(const void* xs, const void* wk, void* y, int64_t N, int64_t T,
                                 int64_t H2, int64_t W2, int64_t C4, int64_t F, void* stream) {
  if (T % 2 || C4 % 4 || H2 < 4 || W2 < 4 || F < 1) return (int)cudaErrorInvalidValue;
  const int64_t To = T / 2, Ho = H2 - 3, Wo = W2 - 3;
  if (N == 0 || To == 0) return (int)cudaSuccess;
  const int threads = 256;
  int64_t blocks = (N * To * Ho * Wo * F + threads - 1) / threads;
  if (blocks > (int64_t)1 << 30) blocks = (int64_t)1 << 30;  // grid-stride beyond
  stem_f32_kernel<<<(unsigned)blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xs), static_cast<const float*>(wk), static_cast<float*>(y), N,
      (int)T, (int)H2, (int)W2, (int)C4, (int)F);
  return (int)cudaGetLastError();
}

// The bf16 kernel's launch on the current device for C4 input channels
// (4, 8 or 12) and F output channels (F % 8 == 0, F <= 2 * FP): the grid
// (one block per SM, split evenly over the F-parts) and the dynamic shared
// memory.  cudaErrorInvalidValue where the kernel does not take the shape
// or the block would need more shared memory than the device allows.
extern "C" int stem_conv_s2d_bf16_config(int64_t C4, int64_t F, int* grid, int* smem) {
  if ((C4 != 4 && C4 != 8 && C4 != 12) || F < 8 || F % 8 || F > 2 * FP)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const int parts = (int)((F + FP - 1) / FP);
  *grid = (sms / parts > 0 ? sms / parts : 1) * parts;
  *smem = bf16_smem_bytes((int)C4);
  return *smem > optin ? (int)cudaErrorInvalidValue : (int)cudaSuccess;
}

// xs (N, T, H2, W2p, C4) bf16 from `s2d_stem_stage_even` (W2p even, so
// rows are whole 16-byte chunks), wp (parts, 7, 32, 16*C4 + 8) bf16 from
// `pack_stem_weights`, y (N, T/2, H2-3, Wo, F) with Wo = W/2 <= W2p - 3;
// all contiguous and 16-byte aligned.  Returns the launch's cudaError_t.
extern "C" int stem_conv_s2d_bf16(const void* xs, const void* wp, void* y, int64_t N, int64_t T,
                                  int64_t H2, int64_t W2p, int64_t C4, int64_t Wo, int64_t F,
                                  void* stream) {
  int grid = 0, smem = 0;
  const int cfg = stem_conv_s2d_bf16_config(C4, F, &grid, &smem);
  if (cfg != (int)cudaSuccess) return cfg;
  if (T % 2 || H2 < 4 || Wo < 1 || W2p < Wo + 3 || (W2p * C4) % 8 ||
      ((uintptr_t)xs | (uintptr_t)wp | (uintptr_t)y) % 16)
    return (int)cudaErrorInvalidValue;
  const int64_t To = T / 2, Ho = H2 - 3;
  const int64_t tiles_h = (Ho + TH - 1) / TH, tiles_w = (Wo + TW - 1) / TW;
  const int64_t tiles = N * To * tiles_h * tiles_w;
  if (tiles >= (int64_t)1 << 31 || N * T * H2 >= (int64_t)1 << 31) return (int)cudaErrorInvalidValue;
  if (tiles == 0) return (int)cudaSuccess;
  const int parts = (int)((F + FP - 1) / FP);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (C4) {
    case 4:
      err = launch_bf16<4>(xs, wp, y, grid, smem, (int)T, (int)H2, (int)W2p, (int)Ho, (int)Wo, (int)F,
                           parts, (int)tiles_h, (int)tiles_w, (int)tiles, s);
      break;
    case 8:
      err = launch_bf16<8>(xs, wp, y, grid, smem, (int)T, (int)H2, (int)W2p, (int)Ho, (int)Wo, (int)F,
                           parts, (int)tiles_h, (int)tiles_w, (int)tiles, s);
      break;
    default:
      err = launch_bf16<12>(xs, wp, y, grid, smem, (int)T, (int)H2, (int)W2p, (int)Ho, (int)Wo, (int)F,
                            parts, (int)tiles_h, (int)tiles_w, (int)tiles, s);
  }
  return (int)err;
}
