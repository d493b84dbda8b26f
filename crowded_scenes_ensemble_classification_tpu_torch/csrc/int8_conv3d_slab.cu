// The int8 conv's row-slab route, for convs on 16 channels with no spatial
// padding and unit spatial strides whose rows fit two 64-row wgmma tiles:
// the I3D stems on their s2d staging (4C = 12 padded to 16 by the quantize pass;
// a (7, 4, 4) kernel, strides (2, 1, 1), Wo = 112).  The function and its
// plain version are int8_conv3d.cuh's.
//
// The tiled route gathers A, the implicit GEMM's (positions x K) operand,
// into shared memory chunk by chunk: every input byte crosses L2 once per
// tap that covers it, and the stem's 64-wide F tile re-reads B for every
// 128 rows, 5.4 GB a call at B = 16 (PERF.md, section 6).  Here a block
// takes two output rows (n, to, ho0 and ho0 + 1), one a warpgroup, and for
// each temporal tap dt copies the kh + 1 input rows they read, whole, into
// shared memory with one bulk copy each, beside the dt's B slice (TMA, two
// 128-byte boxes, swizzled as the tiled route's).  A is never formed: in an
// input row of 16-byte pixels, positions wo .. wo + 63 under tap (th, dx)
// are 64 consecutive pixels from wo + dx, so an m64 x k32 wgmma operand
// (taps dx, dx + 1) is described in place, K-major without swizzle: core
// matrices of 8 rows x 16 bytes (8 consecutive pixels), 16 bytes apart in
// K (the next pixel: LBO) and 128 bytes apart in M (SBO).  The windows of
// neighbouring positions overlap in shared memory, not in L2 traffic: each
// input row crosses L2 once per (dt, block).  Positions past Wo (112 .. 127
// of the second tile) read whatever lies past the row and are not stored.
// Temporal taps in the padding are skipped whole (they add zero).

#include "int8_conv3d.cuh"

namespace csec_int8 {

namespace {

constexpr int SLAB_STAGES = 4;  // ops/kernels/int8_conv.py `_fits_row_slab` prices the ring with it and slab_geom

struct SlabGeom {
  int a_row_bytes, a_rows, b_boxes, slot_bytes;
};

__host__ __device__ inline SlabGeom slab_geom(const Conv& p) {
  SlabGeom g;
  g.a_row_bytes = ((2 * 64 + p.kw - 1) * 16 + 127) / 128 * 128;  // two m64 tiles of positions and the taps past them
  g.a_rows = 2 + p.kh - 1;
  g.b_boxes = p.kh * p.kw * 16 / BK;
  g.slot_bytes = (g.b_boxes * 64 * BK + g.a_rows * g.a_row_bytes + 1023) / 1024 * 1024;
  return g;
}

__host__ __device__ inline int slab_smem_bytes(const Conv& p) {
  return SLAB_STAGES * slab_geom(p).slot_bytes + SLAB_STAGES * 8 + 1024;
}

// K-major, no swizzle: core matrices of 8 rows x 16 bytes, rows 16 bytes
// apart; lbo between the two core matrices of a k32 step, sbo between
// 8-row groups.
__device__ __forceinline__ uint64_t plain_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, int bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
               "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}

__global__ void __launch_bounds__(THREADS, 2) int8_conv3d_slab(const Conv p, const __grid_constant__ CUtensorMap b_map) {
  const SlabGeom g = slab_geom(p);
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = smem_u32(
      reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023)));
  const uint32_t bars = ring + SLAB_STAGES * g.slot_bytes;

  const int tid = threadIdx.x, wg = tid >> 7;
  const int hpairs = (p.Ho + 1) / 2;
  int b = blockIdx.x;
  const int ho0 = 2 * (b % hpairs);
  b /= hpairs;
  const int to = b % p.Do, n = b / p.Do;
  const int f0 = blockIdx.y * 64;
  const int t0 = to * p.sd - p.pd;
  const int dt_lo = max(0, -t0), nsteps = min(p.kd, p.D - t0) - dt_lo;
  const int row_bytes = p.W * 16;
  const int b_stage = g.b_boxes * 64 * BK;

  if (tid == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&b_map)) : "memory");
    for (int s = 0; s < SLAB_STAGES; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Thread 0 alone loads: stage s is temporal tap dt_lo + s, its B slice
  // and the input rows ho0 .. ho0 + kh of frame t0 + dt (those inside x).
  auto issue = [&](int s) {
    const int slot = s % SLAB_STAGES, dt = dt_lo + s;
    const uint32_t base = ring + slot * g.slot_bytes, bar = bars + 8 * slot;
    const int rows = min(g.a_rows, p.H - ho0);
    mbar_expect_tx(bar, b_stage + rows * row_bytes);
    for (int box = 0; box < g.b_boxes; ++box)
      tma_load_b(base + box * 64 * BK, b_map, dt * p.kh * p.kw * 16 + box * BK, f0, bar);
    const int8_t* src = p.x + (((int64_t)n * p.D + t0 + dt) * p.H + ho0) * row_bytes;
    for (int r = 0; r < rows; ++r) bulk_load(base + b_stage + r * g.a_row_bytes, src + (int64_t)r * row_bytes, row_bytes, bar);
  };

  int acc0[32], acc1[32];  // the row's positions 0-63 and 64-127
#pragma unroll
  for (int i = 0; i < 32; ++i) acc0[i] = acc1[i] = 0;

  if (tid == 0)
    for (int s = 0; s < SLAB_STAGES - 2 && s < nsteps; ++s) issue(s);
  const int pairs = p.kw / 2;
  for (int s = 0; s < nsteps; ++s) {
    const int slot = s % SLAB_STAGES;
    mbar_wait(bars + 8 * slot, (s / SLAB_STAGES) & 1);
    __syncthreads();  // and every wgmma of stage s - 2 is done: its slot is free
    if (tid == 0 && s + SLAB_STAGES - 2 < nsteps) issue(s + SLAB_STAGES - 2);
    const uint32_t base = ring + slot * g.slot_bytes;
    const uint32_t a_base = base + b_stage + wg * g.a_row_bytes;  // this warpgroup's row ho0 + wg, tap th = 0
    wgmma_fence();
    fence_operands(acc0);
    fence_operands(acc1);
    for (int th = 0; th < p.kh; ++th) {
      for (int pp = 0; pp < pairs; ++pp) {
        const int j = th * pairs + pp;  // the k32 step within the stage: taps (th, 2 pp) and (th, 2 pp + 1)
        const uint64_t db = smem_desc(base + (j >> 2) * 64 * BK + (j & 3) * 32);
        const uint32_t a = a_base + th * g.a_row_bytes + 2 * pp * 16;
        wgmma_s8(acc0, plain_desc(a, 16, 128), db);
        wgmma_s8(acc1, plain_desc(a + 64 * 16, 16, 128), db);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_operands(acc0);
    fence_operands(acc1);
  }
  wgmma_wait<0>();
  fence_operands(acc0);
  fence_operands(acc1);

  const int ho = ho0 + wg;
  if (ho >= p.Ho) return;
  const int lane = tid & 31;
  const int row = ((tid >> 5) & 3) * 16 + (lane >> 2);  // and row + 8, in each 64-position tile
  const int col = 2 * (lane & 3);
  const bool has_bias = p.bias != nullptr;
  const int64_t m_row = (((int64_t)n * p.Do + to) * p.Ho + ho) * p.Wo;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t f = f0 + 8 * i + col;
    if (f >= p.F) continue;
    const bool second = f + 1 < p.F;
    const float s0 = __ldg(p.scale + f), s1 = second ? __ldg(p.scale + f + 1) : 0.0f;
    const float b0 = has_bias ? __ldg(p.bias + f) : 0.0f, b1 = has_bias && second ? __ldg(p.bias + f + 1) : 0.0f;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int wo = 64 * t + row + 8 * half;
        if (wo >= p.Wo) continue;
        const int a0 = t ? acc1[4 * i + 2 * half] : acc0[4 * i + 2 * half];
        const int a1 = t ? acc1[4 * i + 2 * half + 1] : acc0[4 * i + 2 * half + 1];
        float* dst = p.y + (m_row + wo) * p.F + f;
        const float v0 = dequant(a0, s0, b0, has_bias), v1 = dequant(a1, s1, b1, has_bias);
        if (second && (p.F & 1) == 0) {
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

bool slab_layout_fits(const Conv& p) {
  return p.C == 16 && p.Cp == 16 && p.vec == 16 && p.sh == 1 && p.sw == 1 && p.ph == 0 && p.pw == 0 &&
         p.Ho == p.H - p.kh + 1 && p.Wo == p.W - p.kw + 1 &&  // no pad after either
         p.kw % 2 == 0 && (p.kh * p.kw) % 8 == 0 && p.Wo <= 128 && p.Kpad == (int64_t)p.kd * p.kh * p.kw * 16;
}

cudaError_t launch_slab(const Conv& p, const CUtensorMap& b_map, cudaStream_t s) {
  const int bytes = slab_smem_bytes(p);
  static int configured = 0;  // the largest dynamic shared memory set so far
  if (bytes > configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(int8_conv3d_slab, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    configured = bytes;
  }
  const int64_t blocks = (int64_t)(p.M / ((int64_t)p.Do * p.Ho * p.Wo)) * p.Do * ((p.Ho + 1) / 2);
  const dim3 grid((unsigned)blocks, (unsigned)((p.F + 63) / 64));
  int8_conv3d_slab<<<grid, THREADS, bytes, s>>>(p, b_map);
  return cudaGetLastError();
}

}  // namespace csec_int8
