// The prefill tile of the quantized matmuls (more than 32 rows) for Hopper
// (sm_90a), shared by qmm_q4_0.cu (K1, K5: packed nibbles) and qmm_int8.cu
// (K6, K6b: unpacked int8 levels).  out[B, N] = x[B, K] @ dequant(W) (+ the
// affine seed xg . gbias).
//
// What bounds it on an H100: by its operations the tile is bound by the
// tensor cores (bf16 at 989 TFLOP/s) from 64 rows up, as long as the loads,
// the dequantization of the weight bytes into bf16 and the seed stay off
// their critical path.  The design:
//  * x enters once, as bf16.  prep_kernel rounds x to bf16 into scratch
//    (for the packed layout in the order the weight bytes give: the 32 low
//    panel columns of a step, then its 32 high panel columns), and appends the
//    seed's A operand: the f32 group sums xg of un-rounded x split into bf16
//    hi and lo parts.
//  * Asynchronous rings: one producer thread keeps A_STAGES x tiles in flight
//    (TMA boxes, 128-byte swizzle), another R_STAGES steps of weight bytes
//    and scale rows (or the bias rows of a seed step), each behind full/empty
//    mbarriers.
//  * Two dequantizing warpgroups, taking alternate steps, turn each step's
//    weight bytes into a 64 x 128 bf16 tile in shared memory (MN-major,
//    128-byte swizzle, the layout wgmma reads B from), rounded exactly as the
//    TPU kernel rounds: bf16((level - zero) * d); a ring of B_SLOTS tiles
//    lets them run ahead of the tensor cores.
//  * One or two consumer warpgroups (64, 128 or 256 rows a unit) run
//    wgmma.mma_async m64n128k16 bf16 -> f32, keeping one step in flight
//    while the next waits; setmaxnreg moves registers from the producer and
//    the dequantizers to them.
//  * The seed is extra K steps of the same mainloop: A holds bf16 hi/lo parts
//    of xg, B the bf16 hi/lo parts of gbias, four products per group
//    (hi.hi + hi.lo + lo.hi + lo.lo), 4/GS of the main work, about 5e-6 of
//    the seed's scale.  No separate pass touches out.
//  * A persistent loop over (N tile, M tile, K split) units fills the 132
//    SMs at every shape (ops/qmm.py::tile_plan picks the unit height and the
//    splits); K splits write partial sums that gemv_reduce adds in a fixed
//    order (bit-identical from run to run, no atomics).
// On an H100 80GB HBM3 at 700 W the tile reaches 26-46% of its bound at 512
// rows (chip_smoke.py): the consumers spend most of a step waiting for the
// x tile, whose TMA copies take far longer to land than the L2 round trip
// (PERF.md, PR 4).
#pragma once

#include <cuda.h>  // CUtensorMap; the driver is reached through the runtime's entry point
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "qmm_common.cuh"

namespace qmm {
namespace tile {

constexpr int TN = 128;          // output columns of a unit
constexpr int STEP = 64;         // logical K rows per pipeline step
constexpr int SEED_G = 16;       // groups per seed step
constexpr int RAW_BYTES = 10240; // weight bytes + scale rows, or 16 bias rows
constexpr int SCALE_OFF = 8192;  // scale rows inside a raw slot
constexpr int B_BYTES = STEP * TN * 2;
constexpr int B_SLOTS = 4;
constexpr int PREP_THREADS = 256;

// BM rows of a unit: NC consumer warpgroups of MT m64 tiles each, then ND
// dequantizing warpgroups (step it goes to warpgroup it % ND: one warp per
// scheduler cannot hide its own latencies), then the producer warpgroup.
// The x ring has A_STAGES slots, the weight ring R_STAGES, the B ring
// B_SLOTS.  A parity wait cannot tell phase n from n - 2, so no thread may
// run two uses of a slot ahead: each dequantizing warpgroup keeps to its own
// slots (R_STAGES % ND == 0, B_SLOTS % ND == 0).  ptxas gives a kernel that
// uses setmaxnreg the registers of its whole block (65,536 / THREADS,
// rounded down to a multiple of 8), and setmaxnreg.inc only takes what the
// block's own warpgroups gave back, so the counts below fit that budget:
// 128*240 + 256*120 + 128*24 of 128 each for 512 threads (BM 64, 128),
// 256*160 + 256*64 + 128*24 of 96 each for 640 threads (BM 256).
template <int BM>
struct Shape {
  static constexpr int NC = BM == 256 ? 2 : 1;
  static constexpr int MT = BM / (64 * NC);
  static constexpr int ND = 2;
  static constexpr int A_STAGES = BM == 64 ? 8 : BM == 128 ? 6 : 3;
  static constexpr int R_STAGES = BM == 64 ? 8 : BM == 128 ? 6 : 4;
  static constexpr int A_BYTES = BM * 128;
  static constexpr int THREADS = (NC + ND + 1) * 128;
  static constexpr int BAR_OFF = A_STAGES * A_BYTES + R_STAGES * RAW_BYTES + B_SLOTS * B_BYTES;
  static constexpr int SMEM = BAR_OFF + 1024 + 1024;  // barriers, alignment slack
  static constexpr int REG_C = NC == 2 ? 160 : 240;
  static constexpr int REG_D = NC == 2 ? 64 : 120;
  static constexpr int REG_P = 24;
  static_assert(R_STAGES % ND == 0 && B_SLOTS % ND == 0, "ring ownership");
  static_assert(SMEM <= 232448, "shared memory");
};

struct Params {
  float* out;
  float* partial;      // [splits, B, N] when splits > 1
  int B, N;
  int main_steps, steps, splits, m_tiles, units;
  int groups;          // groups per plane
  int chunks;          // seed chunks per plane (0: no seed)
  int plane_rows;      // first scale/bias row of plane 1 (packed: G2P)
  float zero;          // the pack zero (packed layouts)
};

// --------------------------------------------------------------- PTX pieces
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait for the phase of the given parity to complete.  A wait of more than
// 10 s can only be a broken pipeline: it traps, so the launch fails with an
// error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  uint64_t t0 = 0;
  for (uint32_t n = 0;; ++n) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if ((n & 1023) == 1023) {
      if (!t0) t0 = global_ns();
      else if (global_ns() - t0 > 10000000000ull) __trap();
    }
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// a 2-D TMA box (c0 the inner coordinate) into shared memory, completing on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"((uint64_t)map), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// a 3-D TMA box (c0 innermost)
__device__ __forceinline__ void tma_load3(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                          int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(dst),
      "l"((uint64_t)map), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// shared-memory matrix descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// A: BM rows x 64 K of bf16, K-major, rows of 128 bytes, 8-row groups 1024
// bytes apart (the layout TMA's 128-byte swizzle writes)
__device__ __forceinline__ uint64_t a_desc(uint32_t addr) { return sw128_desc(addr, 16, 1024); }

// B: 64 K x 128 N of bf16, MN-major: two 64-column blocks of 64 rows x 128
// bytes each (LBO the block stride), 8-row groups 1024 bytes apart (SBO)
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) { return sw128_desc(addr, 8192, 1024); }

// byte offset of B element (k, n) of a slot, n a multiple of 8 (16 bytes)
__device__ __forceinline__ int b_off(int k, int n) {
  return (n >> 6) * 8192 + k * 128 + ((((n & 63) >> 3) ^ (k & 7)) << 4);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

#define QMM_F8(i)                                                                  \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),     \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64] += A(64 x 16, K-major) @ B(16 x 128, MN-major), bf16 in, f32 out
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}"
      : QMM_F8(0), QMM_F8(8), QMM_F8(16), QMM_F8(24), QMM_F8(32), QMM_F8(40), QMM_F8(48),
        QMM_F8(56)
      : "l"(da), "l"(db), "r"(1));
}
#undef QMM_F8

template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(R));
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ------------------------------------------------------------------- prep
// Row m of x [B, K] f32 -> xa [B, KA] bf16: the K main columns (PERM: step
// v's 64 columns are x[32v .. 32v+32) then x[K/2 + 32v .. +32)), then one
// step per seed chunk (plane p, groups 16c .. 16c+16): [hi, hi, lo, lo] of
// xg, the f32 sum of un-rounded x over each group (0 past the plane's
// groups).
__global__ void __launch_bounds__(PREP_THREADS)
prep_kernel(const float* __restrict__ x, __nv_bfloat16* __restrict__ xa, int K, int KA,
            int perm, int planes, int GS, int groups, int chunks) {
  const int m = blockIdx.x;
  const float* xr = x + (size_t)m * K;
  __nv_bfloat16* ar = xa + (size_t)m * KA;
  const int k2 = K / 2;
  for (int o = threadIdx.x * 8; o < K; o += PREP_THREADS * 8) {
    int src = o;
    if (perm) {
      const int v = o / 64, j = o % 64;
      src = j < 32 ? 32 * v + j : k2 + 32 * v + j - 32;
    }
    const float4 a = *reinterpret_cast<const float4*>(xr + src);
    const float4 b = *reinterpret_cast<const float4*>(xr + src + 4);
    *reinterpret_cast<uint4*>(ar + o) = make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w),
                                                   pack_bf16(b.x, b.y), pack_bf16(b.z, b.w));
  }
  const int kp = K / planes;
  const int per_plane = chunks * SEED_G;
  for (int i = threadIdx.x; i < planes * per_plane; i += PREP_THREADS) {
    const int pl = i / per_plane, g = i % per_plane;
    float s = 0.0f;
    if (g < groups) {
      const float4* q = reinterpret_cast<const float4*>(xr + pl * kp + g * GS);
      for (int e = 0; e < GS / 4; ++e) {
        const float4 v = q[e];
        s += v.x; s += v.y; s += v.z; s += v.w;
      }
    }
    const __nv_bfloat16 hi = __float2bfloat16_rn(s);
    const __nv_bfloat16 lo = __float2bfloat16_rn(s - __bfloat162float(hi));
    __nv_bfloat16* d = ar + K + STEP * (pl * chunks + g / SEED_G) + g % SEED_G;
    d[0] = hi; d[16] = hi; d[32] = lo; d[48] = lo;
  }
}

// ------------------------------------------------------------- seed steps
// 16 bias rows f32 [16][TN] (groups g0 ..) -> B rows [hi, lo, hi, lo] of
// them in bf16, against A's [hi, hi, lo, lo] of xg: the four products
// hi.hi + hi.lo + lo.hi + lo.lo of each group.  Groups past the plane's
// are zero.
__device__ __forceinline__ void seed_dequant(const uint8_t* __restrict__ raw,
                                             uint8_t* __restrict__ bs, int t, int g0,
                                             int groups) {
  const int c = (t & 15) * 8, r0 = t >> 4;
  const float* b = reinterpret_cast<const float*>(raw);
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int j = r0 + 8 * p;
    float v[8];
    load8(b + j * TN + c, v);
    if (g0 + j >= groups) {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = 0.0f;
    }
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
      hi[e] = *reinterpret_cast<const uint32_t*>(&h);
      lo[e] = pack_bf16(v[2 * e] - __low2float(h), v[2 * e + 1] - __high2float(h));
    }
    const uint4 h4 = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    const uint4 l4 = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    *reinterpret_cast<uint4*>(bs + b_off(j, c)) = h4;
    *reinterpret_cast<uint4*>(bs + b_off(16 + j, c)) = l4;
    *reinterpret_cast<uint4*>(bs + b_off(32 + j, c)) = h4;
    *reinterpret_cast<uint4*>(bs + b_off(48 + j, c)) = l4;
  }
}

// ----------------------------------------------------------------- kernel
// Deq: the layout's policy.  Deq::MAIN_BYTES, the bytes of a main step's
// weight and scale boxes; Deq::load issues them; Deq::dequant writes the
// step's 64 x TN bf16 B tile (thread t of the dequantizing warpgroup).
template <int BM, class Deq>
__global__ void __launch_bounds__(Shape<BM>::THREADS, 1)
tile_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
            const __grid_constant__ CUtensorMap smap, const __grid_constant__ CUtensorMap bmap,
            const Params p) {
  using S = Shape<BM>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = smem_u32(smem);
  uint8_t* const raw0 = smem + S::A_STAGES * S::A_BYTES;
  uint8_t* const b0 = raw0 + S::R_STAGES * RAW_BYTES;
  const uint32_t bar0 = sbase + S::BAR_OFF;
  // three rings: x tiles (producer warp 0 -> consumers), weight/scale/bias
  // bytes (producer warp 1 -> dequantizer), bf16 B tiles (dequantizer ->
  // consumers); each with full and empty barriers
  auto full_a = [&](int s) { return bar0 + 8 * s; };
  auto empty_a = [&](int s) { return bar0 + 8 * (S::A_STAGES + s); };
  auto full_r = [&](int s) { return bar0 + 8 * (2 * S::A_STAGES + s); };
  auto empty_r = [&](int s) { return bar0 + 8 * (2 * S::A_STAGES + S::R_STAGES + s); };
  auto full_b = [&](int r) { return bar0 + 8 * (2 * S::A_STAGES + 2 * S::R_STAGES + r); };
  auto empty_b = [&](int r) {
    return bar0 + 8 * (2 * S::A_STAGES + 2 * S::R_STAGES + B_SLOTS + r);
  };

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < S::A_STAGES; ++s) {
      mbar_init(full_a(s), 1);
      mbar_init(empty_a(s), S::NC);
    }
    for (int s = 0; s < S::R_STAGES; ++s) {
      mbar_init(full_r(s), 1);
      mbar_init(empty_r(s), 1);
    }
    for (int r = 0; r < B_SLOTS; ++r) {
      mbar_init(full_b(r), 1);
      mbar_init(empty_b(r), S::NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == S::NC + S::ND) {
    // ------------------ producers: warp 0 the x tiles, warp 1 the weights
    // (one thread each, every step in order; the weight stream runs ahead of
    // the x stream on its own ring)
    reg_dealloc<S::REG_P>();
    const int pw = (tid % 128) / 32;
    if (pw > 1 || tid % 32 != 0) return;
    int it = 0;
    for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
      const int split = u % p.splits, tile = u / p.splits;
      const int m0 = (tile % p.m_tiles) * BM, n0 = (tile / p.m_tiles) * TN;
      const int lo = split * p.steps / p.splits, hi = (split + 1) * p.steps / p.splits;
      for (int v = lo; v < hi; ++v, ++it) {
        if (pw == 0) {
          const int s = it % S::A_STAGES;
          mbar_wait(empty_a(s), ((it / S::A_STAGES) & 1) ^ 1);
          mbar_expect_tx(full_a(s), S::A_BYTES);
          tma_load(sbase + s * S::A_BYTES, &xmap, STEP * v, m0, full_a(s));
          continue;
        }
        const int s = it % S::R_STAGES;
        mbar_wait(empty_r(s), ((it / S::R_STAGES) & 1) ^ 1);
        const uint32_t raw = smem_u32(raw0 + s * RAW_BYTES);
        if (v < p.main_steps) {
          mbar_expect_tx(full_r(s), Deq::MAIN_BYTES);
          Deq::load(raw, &wmap, &smap, v, n0, full_r(s));
        } else {
          const int chunk = v - p.main_steps;
          mbar_expect_tx(full_r(s), SEED_G * TN * 4);
          tma_load(raw, &bmap, n0,
                   (chunk / p.chunks) * p.plane_rows + (chunk % p.chunks) * SEED_G, full_r(s));
        }
      }
    }
  } else if (wg >= S::NC) {
    // --------------------------------------------- dequantizing warpgroups
    reg_dealloc<S::REG_D>();
    const int d = wg - S::NC;
    const int t = tid % 128;
    int it = 0;
    for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
      const int split = u % p.splits;
      const int lo = split * p.steps / p.splits, hi = (split + 1) * p.steps / p.splits;
      for (int v = lo; v < hi; ++v, ++it) {
        if (it % S::ND != d) continue;
        const int s = it % S::R_STAGES, r = it % B_SLOTS;
        mbar_wait(full_r(s), (it / S::R_STAGES) & 1);
        mbar_wait(empty_b(r), ((it / B_SLOTS) & 1) ^ 1);
        const uint8_t* raw = raw0 + s * RAW_BYTES;
        uint8_t* bs = b0 + r * B_BYTES;
        if (v < p.main_steps)
          Deq::dequant(raw, bs, t, p.zero);
        else
          seed_dequant(raw, bs, t, ((v - p.main_steps) % p.chunks) * SEED_G, p.groups);
        // each thread makes its stores visible to wgmma (the async proxy),
        // the warpgroup meets at a named barrier, one thread signals: 128
        // arrivals on one mbarrier would serialize
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        asm volatile("bar.sync %0, 128;" ::"r"(1 + d) : "memory");
        if (t == 0) {
          mbar_arrive(full_b(r));
          mbar_arrive(empty_r(s));
        }
      }
    }
  } else {
    // ------------------------------------------------ consumer warpgroups
    reg_alloc<S::REG_C>();
    const int lt = tid % 128;
    float acc[S::MT][64];
    int it = 0;
    for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
      const int split = u % p.splits, tile = u / p.splits;
      const int m0 = (tile % p.m_tiles) * BM, n0 = (tile / p.m_tiles) * TN;
      const int lo = split * p.steps / p.splits, hi = (split + 1) * p.steps / p.splits;
#pragma unroll
      for (int i = 0; i < S::MT; ++i)
#pragma unroll
        for (int e = 0; e < 64; ++e) acc[i][e] = 0.0f;
      int prev_s = -1, prev_r = 0;
      for (int v = lo; v < hi; ++v, ++it) {
        const int s = it % S::A_STAGES, r = it % B_SLOTS;
        mbar_wait(full_a(s), (it / S::A_STAGES) & 1);
        mbar_wait(full_b(r), (it / B_SLOTS) & 1);
        const uint32_t a = sbase + s * S::A_BYTES + wg * S::MT * 8192;
        const uint32_t b = smem_u32(b0 + r * B_BYTES);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int i = 0; i < S::MT; ++i)
            wgmma_m64n128k16(acc[i], a_desc(a + i * 8192 + kk * 32), b_desc(b + kk * 2048));
        wgmma_commit();
        wgmma_wait<1>();
        if (prev_s >= 0 && lt == 0) {
          mbar_arrive(empty_a(prev_s));
          mbar_arrive(empty_b(prev_r));
        }
        prev_s = s;
        prev_r = r;
      }
      wgmma_wait<0>();
      if (prev_s >= 0 && lt == 0) {
        mbar_arrive(empty_a(prev_s));
        mbar_arrive(empty_b(prev_r));
      }
      // the m64nNk16 accumulator: warp w of the group owns rows 16w..16w+15;
      // lane l holds rows l/4 and l/4 + 8, columns 8j + 2(l%4) + {0, 1}
      float* dst = p.splits > 1 ? p.partial + (size_t)split * p.B * p.N : p.out;
      const int w = lt / 32, l = lt % 32;
#pragma unroll
      for (int i = 0; i < S::MT; ++i) {
        const int row = m0 + (wg * S::MT + i) * 64 + 16 * w + l / 4;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int col = n0 + 8 * j + 2 * (l % 4);
          if (col >= p.N) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (row + 8 * h < p.B)
              *reinterpret_cast<float2*>(dst + (size_t)(row + 8 * h) * p.N + col) =
                  make_float2(acc[i][4 * j + 2 * h], acc[i][4 * j + 2 * h + 1]);
        }
      }
    }
  }
}

// ------------------------------------------------------------------- host
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr,
                                                             12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                                    cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiled)ptr;
  }
  return fn;
}

// a row-major tensor [planes, rows, cols] of elem-byte values (planes 1: a
// 2-D map), boxes of box_p x box_r x box_c
inline cudaError_t make_map(CUtensorMap* map, CUtensorMapDataType type, int elem,
                            const void* base, long long cols, long long rows, int box_c,
                            int box_r, CUtensorMapSwizzle swizzle, int planes = 1,
                            int box_p = 1) {
  const EncodeTiled enc = encoder();
  if (!enc) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * elem, (cuuint64_t)(cols * rows * elem)};
  const cuuint32_t box[3] = {(cuuint32_t)box_c, (cuuint32_t)box_r, (cuuint32_t)box_p};
  const cuuint32_t es[3] = {1, 1, 1};
  const CUresult r = enc(map, type, planes > 1 ? 3 : 2, const_cast<void*>(base), dims, strides,
                         box, es, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

inline int sm_count() {
  static int n = 0;
  if (!n) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

// One call of the tile.  w: the weight bytes [w_rows, N] (packed or int8),
// scales/bias: f32 [s_rows, N]; planes 2 for the packed layout (plane 1's
// rows from plane_rows on), else 1; bias NULL for no seed.  xa: bf16 scratch
// [B, ka]; partial: f32 [splits, B, N] when splits > 1.  ka, bm and splits
// come from the caller's plan (ops/qmm.py::tile_plan) and are checked here.
template <class Deq>
cudaError_t launch(const float* x, const void* w, int w_rows, const float* scales, int s_rows,
                   const float* bias, __nv_bfloat16* xa, float* partial, float* out, int B,
                   int K, int N, int planes, int GS, int plane_rows, float zero, int bm,
                   int splits, int ka, cudaStream_t st) {
  const int groups = K / planes / GS;
  const int chunks = bias ? (groups + SEED_G - 1) / SEED_G : 0;
  const int main_steps = K / STEP;
  const int steps = main_steps + planes * chunks;
  if (K % STEP || N % 16 || B < 1 || ka != K + STEP * (steps - main_steps) || splits < 1 ||
      splits > steps || (splits > 1 && !partial) || !xa)
    return cudaErrorInvalidValue;
  prep_kernel<<<B, PREP_THREADS, 0, st>>>(x, xa, K, ka, Deq::PERM, planes, GS, groups, chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  CUtensorMap xmap, wmap, smap, bmap;
  if ((err = make_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, xa, ka, B, STEP, bm,
                      CU_TENSOR_MAP_SWIZZLE_128B)) != cudaSuccess ||
      (err = make_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w, N, w_rows, TN, Deq::W_ROWS,
                      CU_TENSOR_MAP_SWIZZLE_NONE)) != cudaSuccess ||
      (err = make_map(&smap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, scales, N, s_rows / planes,
                      TN, Deq::S_ROWS, CU_TENSOR_MAP_SWIZZLE_NONE, planes, planes)) != cudaSuccess ||
      (err = make_map(&bmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, bias ? bias : scales, N,
                      s_rows, TN, SEED_G, CU_TENSOR_MAP_SWIZZLE_NONE)) != cudaSuccess)
    return err;

  Params p;
  p.out = out;
  p.partial = partial;
  p.B = B;
  p.N = N;
  p.main_steps = main_steps;
  p.steps = steps;
  p.splits = splits;
  p.m_tiles = (B + bm - 1) / bm;
  p.units = p.m_tiles * ((N + TN - 1) / TN) * splits;
  p.groups = groups;
  p.chunks = chunks;
  p.plane_rows = plane_rows;
  p.zero = zero;
  const int grid = p.units < sm_count() ? p.units : sm_count();

  auto run = [&](auto kernel, int threads, int smem) -> cudaError_t {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
    if (e != cudaSuccess) return e;
    kernel<<<grid, threads, smem, st>>>(xmap, wmap, smap, bmap, p);
    return cudaGetLastError();
  };
  if (bm == 64)
    err = run(tile_kernel<64, Deq>, Shape<64>::THREADS, Shape<64>::SMEM);
  else if (bm == 128)
    err = run(tile_kernel<128, Deq>, Shape<128>::THREADS, Shape<128>::SMEM);
  else if (bm == 256)
    err = run(tile_kernel<256, Deq>, Shape<256>::THREADS, Shape<256>::SMEM);
  else
    return cudaErrorInvalidValue;
  if (err != cudaSuccess || splits == 1) return err;
  return gemv_reduce(partial, out, splits, B * N, st);
}

}  // namespace tile
}  // namespace qmm
