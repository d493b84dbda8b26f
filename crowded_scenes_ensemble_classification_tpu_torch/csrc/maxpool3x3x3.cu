// 3x3x3 stride-1 TF-SAME max pool over a contiguous NTHWC tensor, bf16 or f32.
//
// Replaces the Pallas TPU kernel `max_pool_3x3x3_same` (body
// `_maxpool3_kernel`) in crowded_scenes_ensemble_classification_tpu/ops/
// pallas/maxpool.py.  That kernel streamed three clamped temporal
// (H, W, C-block) slabs through VMEM and reduced them with a temporal max,
// then shifted maxes along H and W: the pool is separable, so each input
// element is read at most 3 times.  This kernel keeps that idea and drops
// the TPU's block structure.
//
// Bound: bytes.  One read and one write of the tensor are the floor: 400 MB
// for the 9 Mixed-block pools of one I3D member at B = 16 bf16, 0.119 ms at
// 3.35 TB/s; about 6 maxes per element are far below any compute limit.
// The earlier design (one thread per output and 16-byte channel vector)
// ran at about 12 % of that: 27 separate 16-byte tap loads per output
// through L1, each input fetched up to 27 times, 64-bit div/mod index
// math in every thread, and no reuse between neighbouring outputs.  Here:
//
// - A block owns a tile: one b, an H-range of `ht` output rows, a W-range of
//   `wt` columns (all of W at the I3D shapes) and a C-block of `cv` units,
//   where a unit is one thread's 16 bytes (8 bf16 or 4 f32), or one
//   element in the scalar variant.  Thread (wl, u) owns column w0 + wl and
//   unit u of the C-block.  There is no sequential grid on this card, so the
//   block walks T itself.  For each input plane t it holds rows
//   [h0 - 1, h0 + ht] x columns [w0 - 1, w0 + wt] of x[b, t] in shared
//   memory, so each input element comes from global memory once, plus the
//   2 halo rows of an H-tile (and 2 halo columns where W is tiled).
// - Separable reduction, about 6 maxes per element instead of 26: a thread
//   walks its column down the tile, takes each row's max over w - 1 .. w + 1
//   (3 conflict-free shared loads: neighbouring threads read neighbouring
//   16 bytes) and the max of the last three rows' results, which is that
//   plane's 3x3 spatial max S[t] at one output row.  It keeps P1 = S[t - 1]
//   and P2 = max(S[t - 2], S[t - 1]) per row in registers, so
//   y[t - 1] = max(P2, S[t]) needs no third plane: a rolling temporal
//   window of two registers sets per row.
// - Asynchronous copies: two plane buffers.  Plane t + 1's rows are issued
//   as 16-byte cp.async.cg (L2 only) before the threads reduce plane t, and
//   waited on (wait_group 1) only after it.  Results leave as one 16-byte
//   store per unit and row.
// - 32-bit index math: one 64-bit base per (b, t) plane, 32-bit offsets
//   within it (the launcher refuses a plane of 2^31 elements or more).  The
//   tile decode is one set of 32-bit divisions per block, not per output.
// - Enough blocks: the wrapper's tiler (`max_pool_tiling` in
//   ops/kernels/maxpool.py) picks ht per shape so that the grid fills the
//   SMs, and the shared memory (2 planes of (ht + 2) x (wt + 2) x cv units,
//   69,120 B at the Mixed_3* shapes) leaves room for 3 blocks per SM.
// - Ragged edges by masking in this one kernel: H-tiles and W-tiles past
//   the tensor, a partial last C-block (528 = 8 * 64 + 16), T = 1 and 2.
//   Positions outside the tensor are not copied and count as -inf.  A
//   channel count that is not a multiple of the 16-byte unit, or a
//   misaligned pointer, takes the scalar variant of the same kernel: units
//   of one element, copied by plain loads instead of cp.async.
//
// The max propagates NaN like jnp.maximum and torch's max_pool3d (fmaxf
// would drop it): max.NaN on bf16 pairs, compare-and-select on f32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int HT_MAX = 8;         // output rows of an H-tile, at most
constexpr int THREADS_MAX = 256;  // wt * cv, at most

__device__ __forceinline__ float nan_max(float m, float v) {
  return (v > m || isnan(v)) ? v : m;
}

__device__ __forceinline__ uint32_t bf16x2_max(uint32_t a, uint32_t b) {
  const __nv_bfloat162 r = __hmax2_nan(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                       *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// 16-byte global -> shared copy through L2 only.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

// One thread's unit of channels: U holds LANES elements of T.
template <typename T, bool VECTOR> struct Unit;

template <> struct Unit<__nv_bfloat16, true> {
  using U = uint4;
  static constexpr int LANES = 8;
  __device__ static U neg_inf() { return make_uint4(0xFF80FF80u, 0xFF80FF80u, 0xFF80FF80u, 0xFF80FF80u); }
  __device__ static U max(U a, U b) {
    return make_uint4(bf16x2_max(a.x, b.x), bf16x2_max(a.y, b.y), bf16x2_max(a.z, b.z),
                      bf16x2_max(a.w, b.w));
  }
  __device__ static void copy(U* dst, const __nv_bfloat16* src) { cp_async16(dst, src); }
  __device__ static void store(__nv_bfloat16* dst, U v) { *reinterpret_cast<U*>(dst) = v; }
};

template <> struct Unit<float, true> {
  using U = float4;
  static constexpr int LANES = 4;
  __device__ static U neg_inf() { return make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY); }
  __device__ static U max(U a, U b) {
    return make_float4(nan_max(a.x, b.x), nan_max(a.y, b.y), nan_max(a.z, b.z), nan_max(a.w, b.w));
  }
  __device__ static void copy(U* dst, const float* src) { cp_async16(dst, src); }
  __device__ static void store(float* dst, U v) { *reinterpret_cast<U*>(dst) = v; }
};

template <> struct Unit<float, false> {
  using U = float;
  static constexpr int LANES = 1;
  __device__ static U neg_inf() { return -INFINITY; }
  __device__ static U max(U a, U b) { return nan_max(a, b); }
  __device__ static void copy(U* dst, const float* src) { *dst = *src; }
  __device__ static void store(float* dst, U v) { *dst = v; }
};

template <> struct Unit<__nv_bfloat16, false> {
  using U = __nv_bfloat16;
  static constexpr int LANES = 1;
  __device__ static U neg_inf() { return __float2bfloat16(-INFINITY); }
  __device__ static U max(U a, U b) {
    // exact: the result is one of the two bf16 inputs
    return __float2bfloat16(nan_max(__bfloat162float(a), __bfloat162float(b)));
  }
  __device__ static void copy(U* dst, const __nv_bfloat16* src) { *dst = *src; }
  __device__ static void store(__nv_bfloat16* dst, U v) { *dst = v; }
};

// Grid: one block per tile, the C-block fastest, then the W-tile, the
// H-tile and b (the order of `max_pool_tiling`'s `tile_origin`).  Block:
// wt * cv threads.  Dynamic shared memory: 2 * (ht + 2) * (wt + 2) * cv
// units.  Needs ht <= HT_MAX, H * W * C < 2^31 and, for VECTOR, C % LANES
// == 0 and 16-byte aligned x and y.
template <typename T, bool VECTOR>
__global__ void __launch_bounds__(THREADS_MAX)
maxpool3x3x3_kernel(const T* __restrict__ x, T* __restrict__ y, int Tn, int H, int W, int C,
                    int ht, int wt, int cv, int tiles_h, int tiles_w, int c_blocks) {
  using Ops = Unit<T, VECTOR>;
  using U = typename Ops::U;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  U* const smem = reinterpret_cast<U*>(smem_raw);

  int tile = blockIdx.x;
  const int cb = tile % c_blocks;
  tile /= c_blocks;
  const int tw = tile % tiles_w;
  tile /= tiles_w;
  const int th = tile % tiles_h;
  const int b = tile / tiles_h;
  const int h0 = th * ht, w0 = tw * wt;

  const int u = threadIdx.x % cv, wl = threadIdx.x / cv;
  const int c = (cb * cv + u) * Ops::LANES;  // first channel of this thread's unit
  const int w = w0 + wl;
  const bool c_ok = c < C;  // VECTOR: C % LANES == 0, so a unit is whole or absent
  const bool out_ok = c_ok && w < W;
  const int cols = wt + 2, rows = ht + 2;
  const int plane_units = rows * cols * cv;

  const int64_t plane = (int64_t)H * W * C;
  const T* const xb = x + (int64_t)b * Tn * plane;
  T* const yb = y + (int64_t)b * Tn * plane;

  // Rows h0 - 1 .. h0 + ht, columns w0 - 1 .. w0 + wt of plane t into
  // buffer s; thread (wl, u) copies column wl, and wl + wt where that is
  // one of the 2 halo columns.  Positions outside the tensor are skipped.
  auto copy_plane = [&](int t, int s) {
    if (!c_ok) return;
    const T* const xp = xb + (int64_t)t * plane;
    U* const dst = smem + s * plane_units + u;
    for (int r = 0; r < rows; ++r) {
      const int h = h0 - 1 + r;
      if (h < 0 || h >= H) continue;
      for (int col = wl; col < cols; col += wt) {
        const int ww = w0 - 1 + col;
        if (ww >= 0 && ww < W) Ops::copy(dst + (r * cols + col) * cv, xp + (h * W + ww) * C + c);
      }
    }
  };

  // P1 = S[t - 1] and P2 = max(S[t - 2], S[t - 1]) for each output row.
  U p1[HT_MAX], p2[HT_MAX];
#pragma unroll
  for (int i = 0; i < HT_MAX; ++i) p1[i] = p2[i] = Ops::neg_inf();

  copy_plane(0, 0);
  cp_async_commit();
  for (int t = 0; t < Tn; ++t) {
    if (t + 1 < Tn) copy_plane(t + 1, (t + 1) & 1);
    cp_async_commit();    // possibly empty: one group per iteration
    cp_async_wait_one();  // all but the newest group: plane t
    __syncthreads();
    if (out_ok) {
      const U* const src = smem + (t & 1) * plane_units + wl * cv + u;  // column w - 1
      T* const yp = yb + (int64_t)(t - 1) * plane;
      U above2 = Ops::neg_inf(), above1 = Ops::neg_inf();  // W-maxes of the two rows above
#pragma unroll
      for (int r = 0; r < HT_MAX + 2; ++r) {
        if (r < rows) {
          const int h = h0 - 1 + r;
          U m = Ops::neg_inf();
          if (h >= 0 && h < H) {
            const U* const row = src + r * cols * cv;
            m = row[cv];
            if (w > 0) m = Ops::max(m, row[0]);
            if (w + 1 < W) m = Ops::max(m, row[2 * cv]);
          }
          if (r >= 2 && h - 1 < H) {  // output row h - 1 of this tile
            const U s = Ops::max(Ops::max(above2, above1), m);
            if (t > 0) Ops::store(yp + ((h - 1) * W + w) * C + c, Ops::max(p2[r - 2], s));
            p2[r - 2] = Ops::max(p1[r - 2], s);
            p1[r - 2] = s;
          }
          above2 = above1;
          above1 = m;
        }
      }
    }
    __syncthreads();  // before the next iteration's copy overwrites this buffer
  }

  // y[T - 1] = max(S[T - 2], S[T - 1]) = P2.
  if (out_ok) {
    T* const yp = yb + (int64_t)(Tn - 1) * plane;
#pragma unroll
    for (int i = 0; i < HT_MAX; ++i)
      if (i < ht && h0 + i < H) Ops::store(yp + ((h0 + i) * W + w) * C + c, p2[i]);
  }
}

template <typename T, bool VECTOR>
cudaError_t launch(const void* x, void* y, int64_t B, int64_t Tn, int64_t H, int64_t W, int64_t C,
                   int ht, int wt, int cv, cudaStream_t stream) {
  using Ops = Unit<T, VECTOR>;
  if (VECTOR && (C % Ops::LANES || (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) % 16))
    return cudaErrorInvalidValue;
  const int64_t units = (C + Ops::LANES - 1) / Ops::LANES;
  if (cv > units) return cudaErrorInvalidValue;
  const int64_t tiles_h = (H + ht - 1) / ht, tiles_w = (W + wt - 1) / wt, c_blocks = (units + cv - 1) / cv;
  const int64_t grid = B * tiles_h * tiles_w * c_blocks;
  if (grid >= (int64_t)1 << 31) return cudaErrorInvalidValue;
  const int smem = 2 * (ht + 2) * (wt + 2) * cv * (int)sizeof(typename Ops::U);
  cudaError_t err = cudaFuncSetAttribute(maxpool3x3x3_kernel<T, VECTOR>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  maxpool3x3x3_kernel<T, VECTOR><<<(unsigned)grid, wt * cv, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), (int)Tn, (int)H, (int)W, (int)C, ht, wt, cv,
      (int)tiles_h, (int)tiles_w, (int)c_blocks);
  return cudaGetLastError();
}

}  // namespace

// x, y (B, T, H, W, C) contiguous.  dtype: 0 = float32, 1 = bfloat16.
// vector: 16-byte units (C a multiple of 16 bytes, x and y 16-byte
// aligned) or single elements.  The tile: ht output rows (1..8), wt output
// columns and cv units of channels, wt * cv <= 256 threads; the wrapper's
// `max_pool_tiling` chooses them.  Returns the launch's cudaError_t, and
// cudaErrorInvalidValue for a tiling or shape the kernel does not take.
extern "C" int maxpool3x3x3_same(const void* x, void* y, int64_t B, int64_t Tn, int64_t H,
                                 int64_t W, int64_t C, int dtype, int vector, int ht, int wt,
                                 int cv, void* stream) {
  if (B < 1 || Tn < 1 || H < 1 || W < 1 || C < 1 || H * W * C >= (int64_t)1 << 31 || ht < 1 ||
      ht > HT_MAX || wt < 1 || wt > W || cv < 1 || wt * cv > THREADS_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)(vector ? launch<float, true>(x, y, B, Tn, H, W, C, ht, wt, cv, s)
                        : launch<float, false>(x, y, B, Tn, H, W, C, ht, wt, cv, s));
  if (dtype == 1)
    return (int)(vector ? launch<__nv_bfloat16, true>(x, y, B, Tn, H, W, C, ht, wt, cv, s)
                        : launch<__nv_bfloat16, false>(x, y, B, Tn, H, W, C, ht, wt, cv, s));
  return (int)cudaErrorInvalidValue;
}
