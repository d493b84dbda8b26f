// int8 x int8 -> int32 3D convolution (implicit GEMM) with the dequantize in
// its epilogue: y[m, f] = float(acc[m, f]) * scale[f] (+ bias[f]), f32 NDHWC.
//
// Replaces no Pallas kernel: the JAX package leaves its int8 contraction to
// XLA, `jax.lax.conv_general_dilated(x8, k8, preferred_element_type=int32)`
// in crowded_scenes_ensemble_classification_tpu/models/common.py
// (`quant_conv_general`, line 111; `static_quant_conv_general`, line 176),
// and PyTorch has no int8 conv3d on CUDA.  The wrapper, its tile choice
// (`int8_conv_tiling`) and the plain version (an exact float64 `F.conv3d`
// on the int8 values) are in ops/kernels/int8_conv.py.
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
// channels; only wgmma reaches the int8 rate.  The design:
// - A block computes a 128 x BN output tile (BN = 64, 128, 192 or 256,
//   chosen per conv by the wrapper so that F wastes little) with two
//   warpgroups, each issuing wgmma.mma_async m64nBNk32 s8.s8 -> s32 with
//   both operands read from shared memory through matrix descriptors.
// - K moves in stages of BK = 128 bytes, one 128-byte swizzle atom, through
//   a ring of STAGES slots (4-6, as shared memory allows).  B, the packed
//   weights, a plain 2-D (Fpad, Kpad) matrix, arrives by one TMA tile load
//   a stage (a tensor map made on the host; rows past Fpad come as zeros),
//   counted on an mbarrier a slot.  A is the implicit-GEMM gather: every
//   thread fills 4 chunks of 16 bytes a stage with cp.async, chunk j of tile
//   row r at 16-byte unit j ^ (r & 7) of the row, the 128-byte swizzle the
//   descriptors and the tensor map name.  A tap cursor per thread, advanced
//   128 bytes a stage by additions alone, gives each chunk's tap, channel
//   and offset from the row's origin; padded taps and rows past M are
//   zero-filled (src-size 0, the source pointing at x's base).  Where C or
//   x's alignment forbids 16-byte copies, a chunk goes as two 8- or four
//   4-byte cp.async (zero past C), or, below 4, through registers into the
//   same swizzled slot.
// - Loads run STAGES - 2 stages ahead of the products, and one wgmma group
//   stays in flight while the threads issue the next stage's copies:
//   wgmma.wait_group 1 frees the slot read two stages back, and one barrier
//   a stage, after cp.async.wait_group, publishes the next slot and the
//   freed one together.  Chunks gathered through registers are written with
//   st.shared, through the generic proxy, so then fence.proxy.async comes
//   before the barrier too (wgmma reads through the async proxy); after
//   cp.async alone it is left out, as CUTLASS's cp.async + GMMA mainloop
//   leaves it out (on the H100 it cost nothing measurable either way).
// - Per stage a thread spends a bounds test and one addition on each of
//   its chunks: row origins are decoded once, in 32 bits, and the cursor
//   only advances.  With a 64-bit address computed per chunk the stages
//   took 1.4 times as long: 8 warps an SM cannot hide integer chains.
// - The 64-wide tile keeps 4 slots (97 KB) so that two blocks share an SM
//   and one's epilogue overlaps the other's loads; wider tiles run one
//   block an SM (4-6 slots, up to 255 registers).
// - Small-M convs (Mixed_5b/5c: M = 2,352 at B = 16, 19 row tiles) split K
//   over gridDim.z: each split writes its exact int32 partial sums to its
//   own slice of a workspace, and a second kernel adds the slices and
//   dequantizes once (integer sums are exact in any order).
// - Epilogue: __fmul_rn then __fadd_rn (no FMA contraction), so the output
//   equals the plain version bit for bit; the tile is staged through the
//   freed ring so that rows leave as 16-byte coalesced stores.
// - The I3D stems take the row-slab route instead (int8_conv3d_slab.cu):
//   whole input rows in shared memory, read by wgmma through overlapping
//   descriptors, so that A never crosses L2 once per tap.
// What holds the tiled route now (PERF.md, section 6): the operands stream
// from L2, A once per tap (the gather re-reads each input byte for every
// tap that covers it) and B once per row tile; short-K 1x1 convs pay each
// block's prologue and epilogue unoverlapped.  Later work: the row-slab
// form for the 3x3x3 convs (their H and W pads), a persistent grid, TMA
// multicast of B across a cluster, and the quantize/BN folded into the
// epilogue.

// This header holds the tiled kernel's template; int8_conv3d.cu holds the
// entry point and the F tile of 64, int8_conv3d_n{128,192,256}.cu one F
// tile each, and int8_conv3d_slab.cu the row-slab route, so that the build
// compiles them in parallel.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: the encoder is fetched through the runtime, no -lcuda
#include <cuda_runtime.h>
#include <stdint.h>

namespace csec_int8 {

constexpr int BM = 128, BK = 128, THREADS = 256;
constexpr int A_STAGE = BM * BK;  // bytes of one A slot
constexpr int ROW_BYTES = 4096;   // 32 tile rows: a thread's chunks are 32 rows apart

struct Conv {
  const int8_t* x;
  const int8_t* wp;
  const float* scale;
  const float* bias;
  float* y;
  int* acc;  // split-K workspace (splits, M, F) int32; null without split
  int64_t F, Fpad, Kpad, M;  // M < 2^31 - 128: rows are decoded in 32 bits
  int D, H, W, Do, Ho, Wo, C, Cp, K, kd, kh, kw, khw, sd, sh, sw, pd, ph, pw;  // K = kd*kh*kw*Cp
  int dW, dH;  // the tap cursor's offset steps: (W - kw) * C, (H - kh) * W * C
  int vec, steps_per_split, splits;
};

// One output row's input origin: where tap (0, 0, 0) of its window lies.
struct RowOrigin {
  const int8_t* ptr;  // x at (n, d0, h0, w0, 0), possibly in the padding: only ever offset, read where valid
  int d0, h0, w0;     // far outside x for a row past M, so that no tap is valid
};

__device__ __forceinline__ RowOrigin row_origin(const Conv& p, int m) {
  RowOrigin r;
  if (m >= p.M) {
    r.ptr = p.x;
    r.d0 = r.h0 = r.w0 = -(1 << 29);
    return r;
  }
  int t = m / p.Wo;
  const int ow = m - t * p.Wo;
  int u = t / p.Ho;
  const int oh = t - u * p.Ho;
  const int n = u / p.Do;
  const int od = u - n * p.Do;
  r.d0 = od * p.sd - p.pd;
  r.h0 = oh * p.sh - p.ph;
  r.w0 = ow * p.sw - p.pw;
  r.ptr = p.x + ((((int64_t)n * p.D + r.d0) * p.H + r.h0) * p.W + r.w0) * p.C;
  return r;
}

// Where a reduction index k lies: channel c of tap (td, th, tw), at `off`
// bytes from a row's origin, the same for every row.
struct TapCursor {
  int c, td, th, tw, off;
};

__device__ __forceinline__ TapCursor cursor_at(const Conv& p, int k) {
  TapCursor q;
  const int tap = k / p.Cp;
  q.c = k - tap * p.Cp;
  q.td = tap / p.khw;
  const int rest = tap - q.td * p.khw;
  q.th = rest / p.kw;
  q.tw = rest - q.th * p.kw;
  q.off = ((q.td * p.H + q.th) * p.W + q.tw) * p.C + q.c;
  return q;
}

// k += step, walking the taps in (td, th, tw) order; the offset follows by
// additions alone (next tap: C - Cp past the padded channels; next row of
// taps: (W - kw) * C more; next plane: (H - kh) * W * C more).
__device__ __forceinline__ void advance(const Conv& p, TapCursor& q, int step) {
  q.c += step;
  q.off += step;
  while (q.c >= p.Cp) {
    q.c -= p.Cp;
    q.off += p.C - p.Cp;
    if (++q.tw == p.kw) {
      q.tw = 0;
      q.off += p.dW;
      if (++q.th == p.kh) {
        q.th = 0;
        q.off += p.dH;
        ++q.td;
      }
    }
  }
}

// Whether the cursor's tap lies inside x for this row (not in the padding,
// not past the kernel's taps, not a row past M).
__device__ __forceinline__ bool tap_inside(const Conv& p, const RowOrigin& r, const TapCursor& q) {
  return q.td < p.kd && (unsigned)(r.d0 + q.td) < (unsigned)p.D && (unsigned)(r.h0 + q.th) < (unsigned)p.H &&
         (unsigned)(r.w0 + q.tw) < (unsigned)p.W;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes) : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_ca(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src), "n"(N), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

__device__ __forceinline__ void st_shared16(uint32_t dst, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// 16 bytes of one tap's channels q.c .. q.c+15 (Cp % 16 == 0) for one row
// into the slot at dst: VEC-byte copies below C, zero past it and in the
// padding.  VEC 1 gathers through registers.
__device__ __forceinline__ void load_tap_chunk(const Conv& p, const RowOrigin& r, const TapCursor& q, uint32_t dst) {
  const int8_t* src = tap_inside(p, r, q) ? r.ptr + q.off : nullptr;
  switch (p.vec) {
    case 16:
      cp_async16(dst, src ? src : p.x, src ? 16 : 0);
      break;
    case 8:
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const bool ok = src && q.c + 8 * s < p.C;
        cp_async_ca<8>(dst + 8 * s, ok ? src + 8 * s : p.x, ok ? 8 : 0);
      }
      break;
    case 4:
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const bool ok = src && q.c + 4 * s < p.C;
        cp_async_ca<4>(dst + 4 * s, ok ? src + 4 * s : p.x, ok ? 4 : 0);
      }
      break;
    default: {
      uint32_t v[4] = {0u, 0u, 0u, 0u};
      if (src) {
#pragma unroll
        for (int s = 0; s < 16; ++s)
          if (q.c + s < p.C) v[s >> 2] |= (uint32_t)(uint8_t)__ldg(src + s) << (8 * (s & 3));
      }
      st_shared16(dst, make_uint4(v[0], v[1], v[2], v[3]));
    }
  }
}

// 16 bytes of the A tile for one row with K = taps*C unpadded (C < 8):
// each byte at its own tap, zero in the padding and past K.
__device__ __forceinline__ void load_flat_chunk(const Conv& p, const RowOrigin& r, int k, uint32_t dst) {
  uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int s = 0; s < 16; ++s) {
    if (k + s >= p.K) break;
    const TapCursor q = cursor_at(p, k + s);
    if (tap_inside(p, r, q)) v[s >> 2] |= (uint32_t)(uint8_t)__ldg(r.ptr + q.off) << (8 * (s & 3));
  }
  st_shared16(dst, make_uint4(v[0], v[1], v[2], v[3]));
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// wgmma shared-memory matrix descriptor of a K-major tile whose rows are
// 128 bytes, 8-row groups 1,024 bytes apart, 128-byte swizzle (the slot
// must sit at a 1,024-byte boundary): start >> 4, LBO unused for this
// layout, SBO = 1024 >> 4, layout type 1 (SWIZZLE_128B) in bits 62-63.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One TMA tile of the packed weights (128 bytes of K x BN rows from row f)
// into shared memory at dst, 128-byte swizzled as the tensor map says; rows
// past Fpad arrive as zeros.  Completion is counted on the barrier.
__device__ __forceinline__ void tma_load_b(uint32_t dst, const CUtensorMap& map, int k, int f, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(k), "r"(f), "r"(bar)
      : "memory");
}

// Keep the compiler from moving accumulator reads or writes across a wgmma.
template <int R>
__device__ __forceinline__ void fence_operands(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// D (64 x N int32, registers) += A (64 x 32 s8) * B (N x 32 s8)^T, both
// K-major in shared memory.  D fragment: thread t of the warpgroup holds,
// for each 8-column group i, d[4i + e] at row 16*(t/32) + (t%32)/4 (+8 for
// e >= 2), column 8i + 2*(t%4) (+1 for odd e).

__device__ __forceinline__ void wgmma_s8(int (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));  // scale-d = 1: D += A * B
}

__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));  // scale-d = 1: D += A * B
}

__device__ __forceinline__ void wgmma_s8(int (&d)[96], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95])
      : "l"(da), "l"(db), "r"(1));  // scale-d = 1: D += A * B
}

__device__ __forceinline__ void wgmma_s8(int (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));  // scale-d = 1: D += A * B
}

__device__ __forceinline__ float dequant(int acc, float scale, float bias, bool has_bias) {
  const float v = __fmul_rn(__int2float_rn(acc), scale);
  return has_bias ? __fadd_rn(v, bias) : v;
}

// 4 slots for the 64-wide tile leave room for two blocks an SM (97 KB each),
// so that one block's epilogue overlaps the other's loads on short-K convs.
template <int BN>
__host__ __device__ constexpr int ring_stages() {
  return BN == 256 || BN == 64 ? 4 : BN == 192 ? 5 : 6;
}

template <int BN>
__host__ __device__ constexpr int smem_bytes() {
  const int ring = ring_stages<BN>() * (A_STAGE + BN * BK);
  const int tile = BM * (BN + 8) * 4;  // the epilogue's f32 tile
  // + a barrier a slot for B's TMA, + alignment of the ring to 1,024 bytes
  return (ring > tile ? ring : tile) + ring_stages<BN>() * 8 + 1024;
}

template <int BN>
__global__ void __launch_bounds__(THREADS, BN == 64 ? 2 : 1)
    int8_conv3d_wgmma(const Conv p, const __grid_constant__ CUtensorMap b_map) {
  constexpr int STAGES = ring_stages<BN>();
  constexpr int B_STAGE = BN * BK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t a_ring = smem_u32(smem);
  const uint32_t b_ring = a_ring + STAGES * A_STAGE;
  const int ring_bytes = STAGES * (A_STAGE + B_STAGE), tile_bytes = BM * (BN + 8) * 4;
  const uint32_t b_full = a_ring + (ring_bytes > tile_bytes ? ring_bytes : tile_bytes);  // STAGES mbarriers

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int64_t m0 = (int64_t)blockIdx.x * BM;
  const int64_t f0 = (int64_t)blockIdx.y * BN;
  const int total_steps = (int)(p.Kpad / BK);
  const int kt0 = blockIdx.z * p.steps_per_split;
  const int nsteps = min(p.steps_per_split, total_steps - kt0);

  if (tid == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&b_map)) : "memory");
    for (int s = 0; s < STAGES; ++s) mbar_init(b_full + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // This thread copies 16-byte chunk `chunk` of A's tile rows prow + 32 i,
  // i < 4.  All its rows share r & 7, so one swizzled offset serves them
  // all.  Per stage it spends a bounds test and one addition on each chunk:
  // its rows' origins and its tap cursor are set up here and only advanced.
  // Thread 0 also asks the TMA unit for the stage's B tile.
  const int chunk = tid & 7, prow = tid >> 3;
  const uint32_t sw_off = prow * BK + ((chunk ^ (prow & 7)) << 4);
  RowOrigin ro[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) ro[i] = row_origin(p, (int)m0 + prow + 32 * i);
  int k = kt0 * BK + chunk * 16;
  TapCursor q = cursor_at(p, k);
  int kb = kt0 * BK;  // the stage's first byte of K, for B

  auto issue = [&](int slot) {
    if (tid == 0) {
      mbar_expect_tx(b_full + 8 * slot, B_STAGE);
      tma_load_b(b_ring + slot * B_STAGE, b_map, kb, (int)f0, b_full + 8 * slot);
    }
    kb += BK;
    const uint32_t a_dst = a_ring + slot * A_STAGE + sw_off;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (p.vec) {
        load_tap_chunk(p, ro[i], q, a_dst + i * ROW_BYTES);
      } else {
        load_flat_chunk(p, ro[i], k, a_dst + i * ROW_BYTES);
      }
    }
    if (p.vec) advance(p, q, BK);
    k += BK;
  };

  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 2; ++s) {
    if (s < nsteps) issue(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nsteps; ++kt) {
    const int slot = kt % STAGES;
    cp_async_wait<STAGES - 3>();                 // this thread's copies of stage kt have landed
    if (p.vec <= 1) fence_proxy_async();         // register-gathered chunks: st.shared -> wgmma's async proxy
    mbar_wait(b_full + 8 * slot, (kt / STAGES) & 1);  // and stage kt's B tile
    __syncthreads();                             // everyone's; and every wgmma of stage kt - 2 is done
    const int next = kt + STAGES - 2;
    if (next < nsteps) issue(next % STAGES);     // into the slot of stage kt - 2
    cp_async_commit();
    const uint64_t da = smem_desc(a_ring + slot * A_STAGE + wg * 64 * BK);
    const uint64_t db = smem_desc(b_ring + slot * B_STAGE);
    wgmma_fence();
    fence_operands(acc);
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) wgmma_s8(acc, da + 2 * kk, db + 2 * kk);  // +32 bytes of K
    wgmma_commit();
    wgmma_wait<1>();
    fence_operands(acc);
  }
  wgmma_wait<0>();
  fence_operands(acc);

  const int lane = tid & 31;
  const int row = wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);  // and row + 8
  const int col = 2 * (lane & 3);                                   // + 8 i, and + 1
  if (p.acc) {  // split K: this split's exact partial sums; the finish kernel adds them and dequantizes
    int* part = p.acc + blockIdx.z * p.M * p.F;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int64_t m = m0 + row + 8 * half;
      if (m >= p.M) continue;
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        const int64_t f = f0 + 8 * i + col;
        if (f < p.F) part[m * p.F + f] = acc[4 * i + 2 * half];
        if (f + 1 < p.F) part[m * p.F + f + 1] = acc[4 * i + 2 * half + 1];
      }
    }
    return;
  }

  // Dequantize into an f32 tile in the freed ring, rows BN + 8 floats apart
  // (a half-warp's float2 stores then cover 32 banks), then store whole rows.
  constexpr int ST = BN + 8;
  cp_async_wait<0>();
  __syncthreads();
  float* tile = reinterpret_cast<float*>(smem);
  const bool has_bias = p.bias != nullptr;
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    const int64_t f = f0 + 8 * i + col;
    const float s0 = f < p.F ? __ldg(p.scale + f) : 0.0f, s1 = f + 1 < p.F ? __ldg(p.scale + f + 1) : 0.0f;
    const float b0 = has_bias && f < p.F ? __ldg(p.bias + f) : 0.0f;
    const float b1 = has_bias && f + 1 < p.F ? __ldg(p.bias + f + 1) : 0.0f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float2 v = make_float2(dequant(acc[4 * i + 2 * half], s0, b0, has_bias),
                                   dequant(acc[4 * i + 2 * half + 1], s1, b1, has_bias));
      *reinterpret_cast<float2*>(tile + (row + 8 * half) * ST + 8 * i + col) = v;
    }
  }
  __syncthreads();
  if ((p.F & 3) == 0) {
    for (int idx = tid; idx < BM * BN / 4; idx += THREADS) {
      const int r = idx / (BN / 4), c = 4 * (idx % (BN / 4));
      const int64_t m = m0 + r, f = f0 + c;
      if (m < p.M && f < p.F)
        *reinterpret_cast<float4*>(p.y + m * p.F + f) = *reinterpret_cast<const float4*>(tile + r * ST + c);
    }
  } else {
    for (int idx = tid; idx < BM * BN; idx += THREADS) {
      const int r = idx / BN, c = idx % BN;
      const int64_t m = m0 + r, f = f0 + c;
      if (m < p.M && f < p.F) p.y[m * p.F + f] = tile[r * ST + c];
    }
  }
}

template <int BN>
cudaError_t launch(const Conv& p, const CUtensorMap& b_map, dim3 grid, cudaStream_t s) {
  constexpr int bytes = smem_bytes<BN>();
  static bool configured = false;  // the attribute is per function: set it once
  if (!configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(int8_conv3d_wgmma<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  int8_conv3d_wgmma<BN><<<grid, THREADS, bytes, s>>>(p, b_map);
  return cudaGetLastError();
}

// One instance each, in its own source (int8_conv3d*.cu).
cudaError_t launch_n64(const Conv& p, const CUtensorMap& b_map, dim3 grid, cudaStream_t s);
cudaError_t launch_n128(const Conv& p, const CUtensorMap& b_map, dim3 grid, cudaStream_t s);
cudaError_t launch_n192(const Conv& p, const CUtensorMap& b_map, dim3 grid, cudaStream_t s);
cudaError_t launch_n256(const Conv& p, const CUtensorMap& b_map, dim3 grid, cudaStream_t s);

// The row-slab route (int8_conv3d_slab.cu): whether a conv has the layout it
// reads (the wrapper, ops/kernels/int8_conv.py `_fits_row_slab`, chooses
// the route), and its launch.
bool slab_layout_fits(const Conv& p);
cudaError_t launch_slab(const Conv& p, const CUtensorMap& b_map, cudaStream_t s);

}  // namespace csec_int8
