// Gradient of the 3x3x3 stride-1 TF-SAME max pool over a contiguous NTHWC
// tensor, bf16 or f32: dx[p] = sum of dy[q] over the <= 27 outputs q whose
// window holds p and whose FIRST maximum, in (t, h, w) order, is p.
//
// No Pallas kernel computes this: the JAX package differentiates its pool
// on XLA (jax.vjp of `max_pool_3d`, crowded_scenes_ensemble_classification_tpu/
// models/common.py:28, a select_and_scatter).  Its tie rule is the one
// kept here, and torch's max_pool3d keeps it too: a later tap replaces the
// running maximum only if it is greater (or NaN), so the first maximum wins
// and the last NaN does.  An output whose window holds only -inf keeps the
// window's first tap (code 0), as torch starts its argmax there.
//
// Bound: bytes.  Reading x and dy and writing dx once is the floor: 600 MB
// for the 9 Mixed-block pools of one I3D member at B = 16 bf16, 0.179 ms at
// 3.35 TB/s.  The first design (two launches, one thread per position and
// 16-byte unit issuing 27 tap loads through L1, argmax codes written to
// global memory and read back) ran at about 11 % of that.  This one is a
// single pass with the forward kernel's structure (csrc/maxpool3x3x3.cu):
//
// - A block owns a tile: one b, `ht` rows of dx, `wt` columns (all of W at
//   the I3D shapes) and a C-block of `cv` units, a unit being 16 bytes (8
//   bf16 or 4 f32) or, in the scalar variant, one element.  There is no
//   sequential grid on this card, so the block walks T itself; the grid is
//   1-D over tiles, so B * T has no limit of its own.
// - Shared memory holds three rings.  x planes with a halo of 2 rows and
//   columns (an output's window reaches +-1 and the gather needs the
//   outputs +-1): 2 slots.  The argmax codes of the outputs q the tile's
//   gather needs, rows h0 - 1 .. h0 + ht and columns w0 - 1 .. w0 + wt, one
//   byte a channel: 4 slots, and a fifth, never written, that stands for
//   the planes outside T.  dy over the same region: 4 slots.  The codes
//   never reach global memory.  Cells outside the tensor are filled once,
//   before the walk, and never copied over: x with -inf (a padding tap that
//   never replaces, so the scans need no bounds checks), the codes with 0xFF
//   (a code no neighbour asks for), dy with 0.
// - One barrier a step.  Step s waits for its copies, syncs, issues the
//   16-byte cp.async.cg copies of x plane s + 1 and dy plane s - 1, then
//   writes the codes of plane s - 1 (the argmax of x plane s) and sums dx
//   plane s - 3 (from the codes and dy of planes s - 4 .. s - 2): every
//   slot written in a step is one no thread reads in it, so the copies
//   overlap a whole step of work and the two phases share one barrier.
// - A separable argmax that keeps the tie rule: a scan over kw within a row
//   (3 shared loads), then over kh across the last three rows' results,
//   then over kt across planes, each step by "replace if greater or NaN" of
//   a chunk's result over the running one, in (t, h, w) order.  For this
//   rule a chunk's (max, code) combines like the taps themselves, so the
//   result is the 27-tap scan's code, the last NaN included; a chunk wholly
//   in the padding is -inf and never replaces.  Each thread walks its code
//   column down its rows and keeps, per code row, P1 = S[t - 1] and
//   P2 = S[t - 2] (+) S[t - 1] of the spatial results S in registers, so
//   code[t - 1] = P2 (+) S[t] needs no plane of S in shared memory.  bf16
//   lanes go two at a time: a bf16x2 compare gives 16-bit masks that select
//   the max and the code halves together.  Each group of threads walks 3
//   code rows and sums 3 dx rows wherever the tile ends (rows past it keep
//   their fill), so these loops are straight-line code.
// - The gather: dx[b, t] at plane t sums dy[q] over the 27 neighbours q in
//   the fixed order k = 0..26 (dt, then dh, then dw), in f32, rounded once,
//   where code(q) names p: a bf16x2 compare of two lanes' codes sets two
//   predicates, each guarding one lane's f32 add.  A thread owns up to 3
//   rows of a column and loads each neighbour's code and dy once for all of
//   its rows.  The same order as the first design, so the result is the
//   same, bit for bit, and deterministic.
// - Index math: the tile decoded once per block; one 64-bit base per
//   (b, t) plane and 32-bit offsets within it (the launcher refuses a plane
//   of 2^31 elements or more).
// - Every case in this one kernel: f32 and bf16, 16-byte units or the
//   scalar variant (a C that is not a whole number of 16-byte units, or a
//   misaligned pointer: units of one element, copied by plain loads), ragged
//   H and W tiles, a partial last C-block, T = 1 and 2.
//
// The tile (ht, wt, cv and the thread groups) comes from
// `max_pool_backward_tiling` in ops/kernels/maxpool.py.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; tools/time_maxpool_bwd_torch.py):
// about 0.90 ms cold for the 9 shapes, a fifth of the bound, against 1.68 ms
// for the first design.  Its instructions, the gather's 27 compare-and-adds
// a lane the most of them, not its bytes, set the pace (PERF.md, section 6).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS_MAX = 512;  // (wt + 2) * cv * groups, at most
constexpr int CODE_ROWS = 3;      // code rows a thread walks
constexpr int DX_ROWS = 3;        // dx rows a thread sums
constexpr int SMEM_MAX = 232448;  // dynamic shared memory of a block on this card

// 16-byte global -> shared copy through L2 only.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

__device__ __forceinline__ __nv_bfloat162 bf2(uint32_t w) { return *reinterpret_cast<const __nv_bfloat162*>(&w); }

// a0 += g0 where the low bf16 halves of c and want are equal, a1 += g1 where
// the high halves are: one bf16x2 compare into two predicates.
__device__ __forceinline__ void add_where_equal(float& a0, float& a1, uint32_t c, uint32_t want, float g0, float g1) {
  asm("{\n\t.reg .pred p, q;\n\tsetp.eq.bf16x2 p|q, %2, %3;\n\t@p add.f32 %0, %0, %4;\n\t@q add.f32 %1, %1, %5;\n\t}"
      : "+f"(a0), "+f"(a1)
      : "r"(c), "r"(want), "f"(g0), "f"(g1));
}

// One thread's unit of channels: U holds LANES elements; CodeU their codes,
// one byte a lane; Arg a running (max, code) of each lane in registers.
template <typename T, bool VECTOR> struct Unit;

// 8 bf16 lanes, two to a 32-bit word (lane 2i in the low half of word i).
// An Arg keeps the codes in the same halves, biased by 0x3F00: as bf16,
// 0x3F00 + k is a normal number in [0.5, 1), so a bf16x2 compare matches
// codes exactly.
template <> struct Unit<__nv_bfloat16, true> {
  using U = uint4;
  using CodeU = uint2;
  static constexpr int LANES = 8;
  static constexpr uint32_t BIAS = 0x3F003F00u, PAIR = 0x00010001u;
  struct Arg {
    uint32_t v[4], c[4];
  };
  __device__ static U neg_inf() { return make_uint4(0xFF80FF80u, 0xFF80FF80u, 0xFF80FF80u, 0xFF80FF80u); }
  __device__ static U zero() { return make_uint4(0u, 0u, 0u, 0u); }
  __device__ static CodeU no_code() { return make_uint2(0xFFFFFFFFu, 0xFFFFFFFFu); }
  __device__ static void copy(U* dst, const __nv_bfloat16* src) { cp_async16(dst, src); }
  __device__ static void store(__nv_bfloat16* dst, U v) { *reinterpret_cast<U*>(dst) = v; }
  __device__ static uint32_t word(const U& v, int i) { return (&v.x)[i]; }
  __device__ static Arg none() {
    Arg a;
#pragma unroll
    for (int i = 0; i < 4; ++i) a.v[i] = 0xFF80FF80u, a.c[i] = BIAS;
    return a;
  }
  __device__ static Arg first(const U& v) {  // the first tap of a row: (v, 0) from (-inf, 0)
    Arg a;
#pragma unroll
    for (int i = 0; i < 4; ++i) a.v[i] = word(v, i), a.c[i] = BIAS;
    return a;
  }
  // (m, c) of two lanes replaced by (v, k) where v > m or v is NaN.
  __device__ static void take(uint32_t& m, uint32_t& c, uint32_t v, uint32_t k) {
    const uint32_t r = __hgt2_mask(bf2(v), bf2(m)) | __hneu2_mask(bf2(v), bf2(v));
    const __nv_bfloat162 mx = __hmax2_nan(bf2(m), bf2(v));  // the kept value, up to a NaN's payload
    m = *reinterpret_cast<const uint32_t*>(&mx);
    c = (k & r) | (c & ~r);
  }
  __device__ static void tap(Arg& a, const U& v, int k) {
#pragma unroll
    for (int i = 0; i < 4; ++i) take(a.v[i], a.c[i], word(v, i), BIAS + k * PAIR);
  }
  __device__ static void chunk(Arg& a, const Arg& b, int offset) {  // a (+) (b's max, b's code + offset)
#pragma unroll
    for (int i = 0; i < 4; ++i) take(a.v[i], a.c[i], b.v[i], b.c[i] + offset * PAIR);
  }
  __device__ static CodeU codes(const Arg& a) {  // the low byte of each half
    return make_uint2(__byte_perm(a.c[0], a.c[1], 0x6420), __byte_perm(a.c[2], a.c[3], 0x6420));
  }
  // acc[l] += dy[l] where lane l's code is `want`.
  __device__ static void gather(float* acc, const CodeU& cc, const U& g, int want) {
    const uint32_t w2 = BIAS + want * PAIR;
    const uint32_t h[4] = {__byte_perm(cc.x, 0x3F3F3F3Fu, 0x4140), __byte_perm(cc.x, 0x3F3F3F3Fu, 0x4342),
                           __byte_perm(cc.y, 0x3F3F3F3Fu, 0x4140), __byte_perm(cc.y, 0x3F3F3F3Fu, 0x4342)};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      add_where_equal(acc[2 * i], acc[2 * i + 1], h[i], w2, __uint_as_float(word(g, i) << 16),
                      __uint_as_float(word(g, i) & 0xFFFF0000u));
    }
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

// f32 units and the scalar variants: one float and one code a lane.
template <typename T, typename U_, typename CodeU_, int L> struct LaneUnit {
  using U = U_;
  using CodeU = CodeU_;
  static constexpr int LANES = L;
  struct Arg {
    float v[L];
    uint32_t c[L];
  };
  __device__ static float lane(const U& v, int l) {
    if constexpr (L == 1) {
      if constexpr (sizeof(U) == 2) return __bfloat162float(v); else return v;
    } else {
      return (&v.x)[l];
    }
  }
  __device__ static U neg_inf() {
    if constexpr (L == 1) return U(-INFINITY); else return make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
  }
  __device__ static U zero() {
    if constexpr (L == 1) return U(0.0f); else return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  __device__ static CodeU no_code() { return static_cast<CodeU>(~0u); }
  __device__ static void copy(U* dst, const T* src) {
    if constexpr (L == 1) *dst = *src; else cp_async16(dst, src);
  }
  __device__ static void store(T* dst, U v) { *reinterpret_cast<U*>(dst) = v; }
  __device__ static Arg none() {
    Arg a;
#pragma unroll
    for (int l = 0; l < L; ++l) a.v[l] = -INFINITY, a.c[l] = 0;
    return a;
  }
  __device__ static Arg first(const U& v) {
    Arg a;
#pragma unroll
    for (int l = 0; l < L; ++l) a.v[l] = lane(v, l), a.c[l] = 0;
    return a;
  }
  __device__ static void take(Arg& a, int l, float v, uint32_t k) {
    if (v > a.v[l] || isnan(v)) a.v[l] = v, a.c[l] = k;
  }
  __device__ static void tap(Arg& a, const U& v, int k) {
#pragma unroll
    for (int l = 0; l < L; ++l) take(a, l, lane(v, l), k);
  }
  __device__ static void chunk(Arg& a, const Arg& b, int offset) {
#pragma unroll
    for (int l = 0; l < L; ++l) take(a, l, b.v[l], b.c[l] + offset);
  }
  __device__ static CodeU codes(const Arg& a) {
    uint32_t w = 0;
#pragma unroll
    for (int l = 0; l < L; ++l) w |= a.c[l] << (8 * l);
    return static_cast<CodeU>(w);
  }
  __device__ static void gather(float* acc, const CodeU& cc, const U& g, int want) {
#pragma unroll
    for (int l = 0; l < L; ++l)
      if (((static_cast<uint32_t>(cc) >> (8 * l)) & 0xFFu) == static_cast<uint32_t>(want)) acc[l] += lane(g, l);
  }
  __device__ static U pack(const float* a) {
    if constexpr (L == 1) return U(a[0]); else return make_float4(a[0], a[1], a[2], a[3]);
  }
};

template <> struct Unit<float, true> : LaneUnit<float, float4, uint32_t, 4> {};
template <> struct Unit<float, false> : LaneUnit<float, float, uint8_t, 1> {};
template <> struct Unit<__nv_bfloat16, false> : LaneUnit<__nv_bfloat16, __nv_bfloat16, uint8_t, 1> {};

// Rows of the slots.  Every group walks CODE_ROWS code rows and sums
// DX_ROWS dx rows wherever the tile ends, so that its loops have no bounds
// to test; the slots are as deep as the last group reads, and rows past the
// tile keep their fill.
__host__ __device__ inline int x_rows(int groups) { return groups * CODE_ROWS + 2; }
__host__ __device__ inline int q_rows(int ht, int groups) {
  const int a = groups * CODE_ROWS, b = (groups - 1) * ((ht + groups - 1) / groups) + DX_ROWS + 2;
  return a > b ? a : b;
}

// Grid: one block per tile, the C-block fastest, then the W-tile, the
// H-tile and b (the order of `max_pool_backward_tiling`'s `tile_origin`).
// Block: (wt + 2) * cv * groups threads; thread (g, cl, u) owns unit u of
// code column cl and dx column cl - 1 of the tile (both tensor column
// w0 - 1 + cl), code rows [g * CODE_ROWS, ...) and dx rows [g * ceil(ht /
// groups), ...).  Dynamic shared memory: 2 x slots of x_rows x (wt + 4) x cv
// units, 4 dy slots and 5 code slots (the fifth, never written, stands for
// the planes outside T) of q_rows x (wt + 2) x cv units.
template <typename T, bool VECTOR>
__global__ void __launch_bounds__(THREADS_MAX)
maxpool3_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy, T* __restrict__ dx, int Tn, int H, int W,
                    int C, int ht, int wt, int cv, int groups, int tiles_h, int tiles_w, int c_blocks) {
  using Ops = Unit<T, VECTOR>;
  using U = typename Ops::U;
  using CodeU = typename Ops::CodeU;
  using Arg = typename Ops::Arg;
  constexpr int L = Ops::LANES;
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int xcols = wt + 4, qcols = wt + 2;
  const int x_plane = x_rows(groups) * xcols * cv, q_plane = q_rows(ht, groups) * qcols * cv;
  U* const xs = reinterpret_cast<U*>(smem_raw);
  U* const gs = xs + 2 * x_plane;
  CodeU* const cs = reinterpret_cast<CodeU*>(gs + 4 * q_plane);

  int tile = blockIdx.x;
  const int cb = tile % c_blocks;
  tile /= c_blocks;
  const int tw = tile % tiles_w;
  tile /= tiles_w;
  const int th = tile % tiles_h;
  const int b = tile / tiles_h;
  const int h0 = th * ht, w0 = tw * wt;

  const int u = threadIdx.x % cv, cl = threadIdx.x / cv % qcols, g = threadIdx.x / (cv * qcols);
  const int nthreads = qcols * cv * groups;
  const int c = (cb * cv + u) * L;  // first channel of this thread's unit
  const bool c_ok = c < C;          // VECTOR: C % LANES == 0, so a unit is whole or absent
  const int qw = w0 - 1 + cl;       // this thread's code column in the tensor
  const bool q_col = c_ok && qw >= 0 && qw < W;
  const int r0 = g * CODE_ROWS;
  const int dx_rows = (ht + groups - 1) / groups, d0 = g * dx_rows;
  const int nd = (cl >= 1 && cl <= wt && q_col) ? max(0, min(min(dx_rows, DX_ROWS), min(ht, H - h0) - d0)) : 0;
  const int gcl = min(max(cl, 1), wt);  // the gather's column: the edge threads read a real one and store nothing

  const int64_t plane = (int64_t)H * W * C;
  const T* const xb = x + (int64_t)b * Tn * plane + c;
  const T* const gb = dy + (int64_t)b * Tn * plane + c;
  T* const db = dx + (int64_t)b * Tn * plane + c;

  for (int i = threadIdx.x; i < 2 * x_plane; i += nthreads) xs[i] = Ops::neg_inf();
  for (int i = threadIdx.x; i < 4 * q_plane; i += nthreads) gs[i] = Ops::zero();
  for (int i = threadIdx.x; i < 5 * q_plane; i += nthreads) cs[i] = Ops::no_code();
  __syncthreads();  // the fill lands before any copy into the same cells

  // x plane t into slot s: rows h0 - 2 .. h0 + ht + 1, columns w0 - 2 ..
  // w0 + wt + 1; this thread copies rows g, g + groups, ... of columns cl
  // and cl + qcols.  Positions outside the tensor keep their fill.
  auto copy_x = [&](int t, int s) {
    if (!c_ok) return;
    const T* const src = xb + (int64_t)t * plane;
    U* const dst = xs + s * x_plane + u;
    for (int r = g; r < ht + 4; r += groups) {
      const int h = h0 - 2 + r;
      if (h < 0 || h >= H) continue;
      for (int col = cl; col < xcols; col += qcols) {
        const int w = w0 - 2 + col;
        if (w >= 0 && w < W) Ops::copy(dst + (r * xcols + col) * cv, src + (h * W + w) * C);
      }
    }
  };
  // dy plane t into slot s: rows h0 - 1 .. h0 + ht of code column cl.
  auto copy_dy = [&](int t, int s) {
    if (!q_col) return;
    const T* const src = gb + (int64_t)t * plane + qw * C;
    U* const dst = gs + s * q_plane + cl * cv + u;
    for (int r = g; r < ht + 2; r += groups) {
      const int h = h0 - 1 + r;
      if (h >= 0 && h < H) Ops::copy(dst + r * qcols * cv, src + h * W * C);
    }
  };
  // Whether code row r0 + i is one the gather reads, inside the tensor.
  auto code_row_ok = [&](int i) {
    const int h = h0 - 1 + r0 + i;
    return q_col && r0 + i < ht + 2 && h >= 0 && h < H;
  };

  // Per code row of this thread: P1 = S[t - 1], P2 = S[t - 2] (+) S[t - 1].
  Arg p1[CODE_ROWS], p2[CODE_ROWS];
#pragma unroll
  for (int i = 0; i < CODE_ROWS; ++i) p1[i] = p2[i] = Ops::none();

  copy_x(0, 0);
  cp_async_commit();
  for (int s = 0; s <= Tn + 2; ++s) {
    cp_async_wait<0>();  // x plane s and dy plane s - 2, copied in step s - 1
    __syncthreads();     // ... by every thread; step s - 1's reads are done
    if (s + 1 < Tn) copy_x(s + 1, (s + 1) & 1);
    if (s >= 1 && s - 1 < Tn) copy_dy(s - 1, (s - 1) % 4);
    cp_async_commit();

    // The codes of plane s - 1 into code slot (s - 1) % 4, from S[s] (no
    // plane s when s == T).
    CodeU* const cdst = cs + ((s + 3) % 4) * q_plane + (r0 * qcols + cl) * cv + u;
    if (s < Tn) {
      const U* const xsrc = xs + (s & 1) * x_plane + (r0 * xcols + cl) * cv + u;
      Arg above2 = Ops::none(), above1 = Ops::none();  // the row scans of the two x rows above
#pragma unroll
      for (int j = 0; j < CODE_ROWS + 2; ++j) {  // scan over kw of x row r0 + j at columns cl .. cl + 2
        const U* const src = xsrc + j * xcols * cv;
        Arg row = Ops::first(src[0]);
        Ops::tap(row, src[cv], 1);
        Ops::tap(row, src[2 * cv], 2);
        if (j >= 2) {  // code row r0 + j - 2: over kh, then over kt
          const int i = j - 2;
          Arg sp = above2;
          Ops::chunk(sp, above1, 3);
          Ops::chunk(sp, row, 6);
          Arg code = p2[i];
          Ops::chunk(code, sp, 18);
          p2[i] = p1[i];
          Ops::chunk(p2[i], sp, 9);
          p1[i] = sp;
          if (s >= 1 && code_row_ok(i)) cdst[i * qcols * cv] = Ops::codes(code);
        }
        above2 = above1;
        above1 = row;
      }
    } else if (s == Tn) {
#pragma unroll
      for (int i = 0; i < CODE_ROWS; ++i)
        if (code_row_ok(i)) cdst[i * qcols * cv] = Ops::codes(p2[i]);
    }

    // dx plane s - 3 from the codes and dy of planes s - 4 .. s - 2.
    if (s >= 3) {
      const int t = s - 3;
      float acc[DX_ROWS][L];
#pragma unroll
      for (int i = 0; i < DX_ROWS; ++i)
#pragma unroll
        for (int l = 0; l < L; ++l) acc[i][l] = 0.0f;
#pragma unroll
      for (int dt = 0; dt < 3; ++dt) {  // neighbour plane t - 1 + dt; outside T, the never-written code slot
        const int tq = t - 1 + dt;
        const bool in_t = tq >= 0 && tq < Tn;
        const int at0 = (d0 * qcols + gcl - 1) * cv + u;
        const CodeU* const csrc = cs + (in_t ? tq % 4 : 4) * q_plane + at0;
        const U* const gsrc = gs + (in_t ? tq % 4 : 0) * q_plane + at0;
#pragma unroll
        for (int jr = 0; jr < DX_ROWS + 2; ++jr) {  // code row d0 + jr
#pragma unroll
          for (int dw = 0; dw < 3; ++dw) {
            const int at = (jr * qcols + dw) * cv;
            const CodeU cc = csrc[at];
            const U gg = gsrc[at];
#pragma unroll
            for (int i = 0; i < DX_ROWS; ++i)  // dx row d0 + i sees code row d0 + jr at dh = jr - i - 1
              if (jr - i >= 0 && jr - i <= 2)
                Ops::gather(acc[i], cc, gg, 9 * (2 - dt) + 3 * (2 - (jr - i)) + (2 - dw));
          }
        }
      }
      T* const dst = db + (int64_t)t * plane + qw * C;  // dx column w0 + cl - 1 is the code column
#pragma unroll
      for (int i = 0; i < DX_ROWS; ++i)
        if (i < nd) Ops::store(dst + (h0 + d0 + i) * W * C, Ops::pack(acc[i]));
    }
  }
  cp_async_wait<0>();
}

template <typename T, bool VECTOR>
cudaError_t launch(const void* x, const void* dy, void* dx, int64_t B, int64_t Tn, int64_t H, int64_t W, int64_t C,
                   int ht, int wt, int cv, int groups, cudaStream_t stream) {
  using Ops = Unit<T, VECTOR>;
  if (VECTOR && (C % Ops::LANES || (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dy) |
                                    reinterpret_cast<uintptr_t>(dx)) % 16))
    return cudaErrorInvalidValue;
  const int64_t units = (C + Ops::LANES - 1) / Ops::LANES;
  if (cv > units) return cudaErrorInvalidValue;
  const int64_t tiles_h = (H + ht - 1) / ht, tiles_w = (W + wt - 1) / wt, c_blocks = (units + cv - 1) / cv;
  const int64_t grid = B * tiles_h * tiles_w * c_blocks;
  if (grid >= (int64_t)1 << 31) return cudaErrorInvalidValue;
  const int64_t x_plane = (int64_t)x_rows(groups) * (wt + 4) * cv;
  const int64_t q_plane = (int64_t)q_rows(ht, groups) * (wt + 2) * cv;
  const int64_t smem = (2 * x_plane + 4 * q_plane) * (int64_t)sizeof(typename Ops::U) +
                       5 * q_plane * (int64_t)sizeof(typename Ops::CodeU);
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(maxpool3_bwd_kernel<T, VECTOR>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  maxpool3_bwd_kernel<T, VECTOR><<<(unsigned)grid, (wt + 2) * cv * groups, (size_t)smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<T*>(dx), (int)Tn, (int)H, (int)W, (int)C,
      ht, wt, cv, groups, (int)tiles_h, (int)tiles_w, (int)c_blocks);
  return cudaGetLastError();
}

}  // namespace

// x, dy, dx (B, T, H, W, C) contiguous.  dtype: 0 = float32, 1 = bfloat16.
// vector: 16-byte units (C a multiple of 16 bytes, every pointer 16-byte
// aligned) or single elements.  The tile: ht rows, wt columns and cv units
// of channels, walked by `groups` row groups of (wt + 2) * cv threads, at
// most 512 threads, 3 code rows and 3 dx rows a thread, and 232,448 bytes of
// shared memory; `max_pool_backward_tiling` chooses them.  Returns the
// launch's cudaError_t, and cudaErrorInvalidValue for a tiling or shape the
// kernel does not take.
extern "C" int maxpool3x3x3_same_backward(const void* x, const void* dy, void* dx, int64_t B, int64_t Tn, int64_t H,
                                          int64_t W, int64_t C, int dtype, int vector, int ht, int wt, int cv,
                                          int groups, void* stream) {
  if (B < 1 || Tn < 1 || H < 1 || W < 1 || C < 1 || H * W * C >= (int64_t)1 << 31 || ht < 1 || wt < 1 || wt > W ||
      cv < 1 || groups < 1 || (int64_t)(wt + 2) * cv * groups > THREADS_MAX ||
      (ht + 2 + groups - 1) / groups > CODE_ROWS || (ht + groups - 1) / groups > DX_ROWS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)(vector ? launch<float, true>(x, dy, dx, B, Tn, H, W, C, ht, wt, cv, groups, s)
                        : launch<float, false>(x, dy, dx, B, Tn, H, W, C, ht, wt, cv, groups, s));
  if (dtype == 1)
    return (int)(vector ? launch<__nv_bfloat16, true>(x, dy, dx, B, Tn, H, W, C, ht, wt, cv, groups, s)
                        : launch<__nv_bfloat16, false>(x, dy, dx, B, Tn, H, W, C, ht, wt, cv, groups, s));
  return (int)cudaErrorInvalidValue;
}
