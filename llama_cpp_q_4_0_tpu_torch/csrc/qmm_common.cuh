// Pieces shared by the quantized matmul kernels of qmm_q4_0.cu, qmm_int8.cu
// and qmm_q8x.cu (Hopper, sm_90a): exact byte -> float unpacking, bf16
// rounding, the loads of f32, f16 and bf16 scale planes, the decode GEMV
// skeleton of K2, K5, K6, K6b and K7 (one launch a call, split-K reduced
// inside the kernel across a thread-block cluster), and the deterministic
// split-K reduce pass of the prefill tile.  The prefill tile itself is
// qmm_tile.cuh.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <cooperative_groups.h>

namespace qmm {

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Byte j (a value 0..255) of v minus (off - 2^23), exact, without the slow
// int-to-float unit: the byte becomes the low mantissa bits of 2^23, and one
// FADD of off = 2^23 + zero both ends the trick and subtracts a pack zero.
__device__ __forceinline__ float byte_minus(unsigned v, int j, float off) {
  return __int_as_float(__byte_perm(v, 0x4B000000u, 0x7540 + j)) - off;
}

// Signed byte j of v (an int8 level) as an exact float: flipping the sign
// bit maps -128..127 onto 0..255, then the same mantissa trick.
__device__ __forceinline__ float sbyte_to_float(unsigned v, int j) {
  return __int_as_float(__byte_perm(v ^ 0x80808080u, 0x4B000000u, 0x7540 + j))
         - 8388736.0f;
}

// 8 consecutive f32 values (32-byte aligned by the callers' N % 8 == 0 and
// 16-byte aligned bases, or in shared memory)
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// The dtype of a call's scale and bias planes (ops/qmm.py SCALE_CODES), a
// runtime argument of every entry point: f32, or 2-byte f16 or bf16 values
// that the kernels widen to f32 as they load them, exactly, so that the
// arithmetic after the load is the f32 planes' own.  The decode GEMVs load
// their planes once a block and branch on the code there; the prefill
// tile's dequantizers, which load them every step, run a loop compiled for
// each code (qmm_tile.cuh).
enum ScaleCode : int { SCALE_F32 = 0, SCALE_F16 = 1, SCALE_BF16 = 2 };

__host__ __device__ inline int scale_bytes(int code) { return code == SCALE_F32 ? 4 : 2; }

// the 8 plane values from element i of a plane of code SC (i % 8 == 0 and a
// 16-byte aligned base: 32 bytes of f32, 16 of a 2-byte dtype), as f32;
// global or shared memory.  f16 widens through cvt (exact, subnormals
// included), bf16 by a shift into the high half.
template <int SC>
__device__ __forceinline__ void load8s(const void* p, size_t i, float (&v)[8]) {
  if constexpr (SC == SCALE_F32) {
    load8(static_cast<const float*>(p) + i, v);
  } else {
    const uint4 u = *reinterpret_cast<const uint4*>(static_cast<const uint16_t*>(p) + i);
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const unsigned h = e % 2 ? w[e / 2] >> 16 : w[e / 2] & 0xFFFFu;
      v[e] = SC == SCALE_F16 ? __half2float(__ushort_as_half((unsigned short)h))
                             : __uint_as_float(h << 16);
    }
  }
}

// the same with the code known only at run time
__device__ __forceinline__ void load8s(const void* p, size_t i, int code, float (&v)[8]) {
  if (code == SCALE_F32)
    load8s<SCALE_F32>(p, i, v);
  else if (code == SCALE_F16)
    load8s<SCALE_F16>(p, i, v);
  else
    load8s<SCALE_BF16>(p, i, v);
}

// ------------------------------------------------------------------ decode
// The decode GEMV of K2, K5, K6, K6b and K7 (32 rows or fewer): one
// skeleton, gemv_kernel<Body, NB>, with a small layout body (Int8Gemv in
// qmm_int8.cu, PackedGemv in qmm_q4_0.cu, Q8Gemv in qmm_q8x.cu) that stages
// a chunk's x in shared memory and turns the chunk's loaded weight rows into
// products, the way the prefill tile takes Int8Deq and PackedDeq.  A body
// names its chunk height (CH1 at one x row, CHN at more), the chunks a warp
// keeps in flight (BUFS1, BUFSN: two, or one where the registers are worth
// more to the body), the blocks an SM at one x row (OCC1) and the x rows of
// a pass (NBM): K7's chunk is one whole weight group, since its activations
// are quantized a group at a time inside the kernel.
//
// What bounds it on an H100: first the bytes of the levels and planes, read
// once per call (3.35 TB/s); then, once those stream, the issue slots (132
// SMs x 4 schedulers at ~1.75 GHz is about 9 thread instructions a weight
// byte at the memory rate, and a packed byte holds two weights); and at the
// 7B shapes a fixed cost per call (launch, first loads, the reduce) that is
// as large as the streaming itself.  What the skeleton does:
//  * One launch a call.  The K splits of a column tile are the blocks of one
//    thread-block cluster (grid (N tiles, S), cluster (1, S, 1), S <= 8).
//    Each block sums its warps in shared memory in warp order; after
//    cluster.sync() rank q adds its slice of the tile's columns over ranks
//    0..S-1 in rank order, reading the others' sums through distributed
//    shared memory, and writes out once; a second cluster.sync() keeps every
//    block's sums alive until all are read.  No partials in global memory,
//    no atomics, a fixed order (two launches are bit-identical) and no state
//    left between launches (a CUDA graph replays it as it is).
//    ops/qmm.py::gemv_plan picks S so that the grid's clusters fit the card
//    at once where that pays (qmm_*_gemv_clusters asks the card).
//  * Bytes in flight.  Split q covers 32-row steps [q T / S, (q+1) T / S) of
//    the T steps; its rows are cut into chunks of CH rows (the bf16 bodies:
//    16 at one x row, 8 at more; K7: one group), dealt to the warps in turn.
//    A lane owns 8 consecutive columns: a chunk is CH 8-byte level loads
//    (ld.global.nc.L1::no_allocate: read once), the chunk's plane rows
//    (16-byte loads) and its x values, all issued before any is used, and
//    (two register buffers, the bf16 bodies) the next chunk's loads are
//    issued before this one is computed, so a warp keeps 4-8 KB in flight
//    from start to end and no block-wide barrier stands before the first
//    product.  K7 keeps one 8 KB chunk in flight a warp and, at one x row,
//    two blocks an SM instead.
//  * Fewer instructions a weight.  Each warp stages its chunk's x into its
//    own slot of shared memory (Body::stage; stage_bf16 for the bf16 bodies:
//    x rounded to bf16 and summed for the seed, a few shuffles a chunk);
//    lanes read x as broadcasts from there (a float4 for four rows at one x
//    row), not by a shuffle per row and batch row.  The bf16
//    bodies keep the TPU kernel's arithmetic (weight bf16(level * d), x bf16,
//    f32 products and sums) and round each weight with one cvt.rn.bf16x2.f32
//    whose other half is zero, so the result is the f32 value itself: one
//    instruction a weight, where a rounded pair costs three for two (one cvt
//    and two to unpack; measured slower).  The seed enters once a chunk
//    from the chunk's own x sums (a chunk lies in one group, so the sum over
//    a group's chunks is the group's seed).
constexpr int GEMV_WARPS = 8;
constexpr int GEMV_COLS = 8;
constexpr int GEMV_TILE_N = 32 * GEMV_COLS;
constexpr int GEMV_STEP = 32;       // weight rows of a K step
constexpr int GEMV_MAX_SPLITS = 8;  // the portable cluster size

// The two loads below are volatile: a plain asm statement counts as a pure
// function of its operands, so the compiler may run it where the source does
// not, such as the f32 branch of load_plane on a 2-byte plane (reading past
// its end) or a level row past the ragged N edge; such reads fault when they
// reach unmapped memory.

// 8 bytes read once: no L1 allocation
__device__ __forceinline__ uint2 ld_stream8(const uint8_t* p) {
  uint2 v;
  asm volatile("ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];"
               : "=r"(v.x), "=r"(v.y) : "l"(p));
  return v;
}

__device__ __forceinline__ uint4 ld_nc16(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}

// 8 plane values of one row as loaded: f32 in two 16-byte words, a 2-byte
// dtype in the first; widened to f32 only when the chunk is computed
struct PlaneRaw {
  uint4 a, b;
};

__device__ __forceinline__ PlaneRaw load_plane(const void* base, size_t i, int code) {
  PlaneRaw r;
  if (code == SCALE_F32) {
    const float* p = static_cast<const float*>(base) + i;
    r.a = ld_nc16(p);
    r.b = ld_nc16(p + 4);
  } else {
    r.a = ld_nc16(static_cast<const uint16_t*>(base) + i);
    r.b = make_uint4(0u, 0u, 0u, 0u);
  }
  return r;
}

// exact, as load8s
__device__ __forceinline__ void widen_plane(const PlaneRaw& r, int code, float (&v)[8]) {
  const unsigned w[8] = {r.a.x, r.a.y, r.a.z, r.a.w, r.b.x, r.b.y, r.b.z, r.b.w};
  if (code == SCALE_F32) {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = __uint_as_float(w[e]);
  } else if (code == SCALE_BF16) {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[e] = __uint_as_float(e % 2 ? w[e / 2] & 0xFFFF0000u : w[e / 2] << 16);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[e] = __half2float(__ushort_as_half(
          (unsigned short)(e % 2 ? w[e / 2] >> 16 : w[e / 2] & 0xFFFFu)));
  }
}

// bf16(a) as f32 in one instruction: the pair's low half is bf16(0) = 0
__device__ __forceinline__ float bf16_round1(float a) {
  unsigned u;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(u) : "f"(a), "f"(0.0f));
  return __uint_as_float(u);
}

// x of row r (of a chunk) and batch row bb from the warp's staged x at xs
// (batch stride xb): at one batch row a float4 covers four rows, x4 keeps it
template <int NB>
__device__ __forceinline__ float x_at(const float* xs, int xb, int r, int bb, float4& x4) {
  if constexpr (NB == 1) {
    if (r % 4 == 0) x4 = *reinterpret_cast<const float4*>(xs + r);
    return r % 4 == 0 ? x4.x : r % 4 == 1 ? x4.y : r % 4 == 2 ? x4.z : x4.w;
  } else {
    return xs[bb * xb + r];
  }
}

struct GemvArgs {
  const float* x;        // [B, K] f32
  const uint8_t* w;      // levels [K, N] int8 or packed [K2P, N] uint8
  const void* scales;    // [G, N] or [2, G2P, N], dtype scode
  const void* bias;      // the same shape, or NULL
  float* out;            // [B, N]
  int B, K, N;
  int steps;             // 32-row steps of the weight: K / 32 int8, K / 64 packed
  int G2P;               // plane rows of a panel (packed), 0 for int8
  int scode;
  float zero;            // the pack zero (packed)
};

// a chunk's loads: the lane's 8 bytes of each of CH rows, its plane rows
// (scale rows, one a panel, then bias rows), and XL of the chunk's NB x P x
// CH x values (value v = lane + 32 i: row v % CH of panel v / CH % P of
// batch row v / (CH P))
template <int CH, int NPL, int XL>
struct GemvChunk {
  uint2 w[CH];
  PlaneRaw p[NPL];
  float x[XL];
};

// rows row0 .. row0 + CH of the weight at the lane's columns n .. n + 8,
// the planes of their group (chunks never straddle a group) and their x
template <int NB, int PANELS, int GS, int CH, int NPL, int XL>
__device__ __forceinline__ void load_chunk(const GemvArgs& a, int b0, int row0, int n,
                                           bool col_ok, GemvChunk<CH, NPL, XL>& c) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < XL; ++i) {
    const int v = lane + 32 * i, r = v % CH, p = v / CH % PANELS, b = b0 + v / (CH * PANELS);
    c.x[i] = v < NB * PANELS * CH && b < a.B
                 ? __ldg(a.x + (size_t)b * a.K + p * (a.K / 2) + row0 + r)
                 : 0.0f;
  }
  if (!col_ok) {
#pragma unroll
    for (int r = 0; r < CH; ++r) c.w[r] = make_uint2(0u, 0u);
#pragma unroll
    for (int i = 0; i < NPL; ++i) c.p[i] = PlaneRaw{};
    return;
  }
  const uint8_t* p = a.w + (size_t)row0 * a.N + n;
#pragma unroll
  for (int r = 0; r < CH; ++r) c.w[r] = ld_stream8(p + (size_t)r * a.N);
  const int g = row0 / GS;
#pragma unroll
  for (int i = 0; i < NPL; ++i)
    c.p[i] = load_plane(i < PANELS ? a.scales : a.bias,
                        ((size_t)(i % PANELS) * a.G2P + g) * a.N + n, a.scode);
}

// The bf16 bodies' staging of a chunk's x (value v of the lane's XL: row
// v % CH of panel v / CH % P of batch row v / (CH P)): rounded to bf16 into
// the warp's slot xs [NB][P][CH], with its f32 sums over each CH-lane
// segment (one panel of one batch row) in xg [NB][P] for the seed
template <int NB, int P, int CH, int XL>
__device__ __forceinline__ void stage_bf16(const float (&x)[XL], float* xs, float* xg) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < XL; ++i) {
    const int v = lane + 32 * i;
    float sum = x[i];
#pragma unroll
    for (int o = CH / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(FULL, sum, o);
    if (v < NB * P * CH) {
      xs[v] = bf16_round(x[i]);
      if (v % CH == 0) xg[v / CH] = sum;
    }
  }
}

// one loaded chunk: its x staged into the warp's slots xs (NB P CH floats)
// and xg (2 NB P floats) by the body, then the rows' products
template <class Body, int NB, int CH, int XL>
__device__ __forceinline__ void run_chunk(const GemvArgs& a, const GemvChunk<CH, Body::NPL, XL>& c,
                                          float* xs, float* xg, float (&acc)[NB][GEMV_COLS]) {
  __syncwarp();  // the previous chunk's reads of xs and xg are done
  Body::template stage<NB, CH, XL>(c.x, xs, xg);
  __syncwarp();
  float pl[Body::NPL][GEMV_COLS];
#pragma unroll
  for (int i = 0; i < Body::NPL; ++i) widen_plane(c.p[i], a.scode, pl[i]);
  Body::template rows<NB, CH>(c.w, pl, xs, xg, a.zero, acc);
}

template <class Body, int NB>
__global__ void __launch_bounds__(GEMV_WARPS * 32, NB == 1 ? Body::OCC1 : 1)
    gemv_kernel(const GemvArgs a) {
  namespace cg = cooperative_groups;
  constexpr int P = Body::PANELS, GS = Body::GS, NPL = Body::NPL, W = GEMV_WARPS;
  constexpr int CH = NB == 1 ? Body::CH1 : Body::CHN;  // rows of a chunk
  constexpr int BUFS = NB == 1 ? Body::BUFS1 : Body::BUFSN;  // chunks in flight a warp
  constexpr int CPS = GEMV_STEP / CH;                 // chunks of a step
  constexpr int XL = (NB * P * CH + 31) / 32;  // x values a lane loads a chunk
  static_assert(CH <= GS && 32 % CH == 0, "a chunk lies in one group and one step");
  __shared__ __align__(16) float xs[W][NB * P * CH];
  __shared__ __align__(16) float xg[W][2 * NB * P];
  __shared__ float red[W][GEMV_TILE_N];
  __shared__ float sums[NB][GEMV_TILE_N];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks(), q = (int)cluster.block_rank();
  const int t0 = (int)((long long)q * a.steps / S);
  const int t1 = (int)((long long)(q + 1) * a.steps / S);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = blockIdx.x * GEMV_TILE_N + lane * GEMV_COLS;
  const bool col_ok = n < a.N;
  const int c0 = t0 * CPS + warp, c1 = t1 * CPS;  // this warp's chunks: c0, c0 + W, ...

  for (int b0 = 0; b0 < a.B; b0 += NB) {
    float acc[NB][GEMV_COLS];
#pragma unroll
    for (int bb = 0; bb < NB; ++bb)
#pragma unroll
      for (int j = 0; j < GEMV_COLS; ++j) acc[bb][j] = 0.0f;
    if constexpr (BUFS == 2) {
      GemvChunk<CH, NPL, XL> ca, cb;
      if (c0 < c1) load_chunk<NB, P, GS>(a, b0, c0 * CH, n, col_ok, ca);
      for (int c = c0; c < c1; c += 2 * W) {
        if (c + W < c1) load_chunk<NB, P, GS>(a, b0, (c + W) * CH, n, col_ok, cb);
        run_chunk<Body, NB, CH>(a, ca, xs[warp], xg[warp], acc);
        if (c + W >= c1) break;
        if (c + 2 * W < c1) load_chunk<NB, P, GS>(a, b0, (c + 2 * W) * CH, n, col_ok, ca);
        run_chunk<Body, NB, CH>(a, cb, xs[warp], xg[warp], acc);
      }
    } else {  // one buffer: its registers go to the body's x rows, or to a
              // second block an SM
      for (int c = c0; c < c1; c += W) {
        GemvChunk<CH, NPL, XL> ca;
        load_chunk<NB, P, GS>(a, b0, c * CH, n, col_ok, ca);
        run_chunk<Body, NB, CH>(a, ca, xs[warp], xg[warp], acc);
      }
    }

    // the block's warps in warp order ...
#pragma unroll
    for (int bb = 0; bb < NB; ++bb) {
#pragma unroll
      for (int j = 0; j < GEMV_COLS; ++j) red[warp][lane * GEMV_COLS + j] = acc[bb][j];
      __syncthreads();
      float v = 0.0f;
#pragma unroll
      for (int w = 0; w < W; ++w) v += red[w][threadIdx.x];
      sums[bb][threadIdx.x] = v;
      __syncthreads();
    }
    // ... then the cluster's splits in rank order, rank q taking its slice
    // of the columns
    cluster.sync();
    const int lo = q * GEMV_TILE_N / S, width = (q + 1) * GEMV_TILE_N / S - lo;
    for (int i = threadIdx.x; i < NB * width; i += blockDim.x) {
      const int bb = i / width, col = lo + i % width;
      // every rank's read in flight at once; a slot past the cluster reads
      // rank 0 and is dropped (a load of a rank outside the cluster, even
      // one the compiler issues ahead of the select, faults)
      float part[GEMV_MAX_SPLITS];
#pragma unroll
      for (int r = 0; r < GEMV_MAX_SPLITS; ++r)
        part[r] = *cluster.map_shared_rank(&sums[bb][col], r < S ? r : 0);
      float v = 0.0f;
#pragma unroll
      for (int r = 0; r < GEMV_MAX_SPLITS; ++r)
        if (r < S) v += part[r];
      const int b = b0 + bb, nn = blockIdx.x * GEMV_TILE_N + col;
      if (b < a.B && nn < a.N) a.out[(size_t)b * a.N + nn] = v;
    }
    cluster.sync();  // the sums stay until every rank has read them
  }
}

inline cudaLaunchConfig_t gemv_config(int n_tiles, int splits, cudaLaunchAttribute& attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_tiles, splits, 1);
  cfg.blockDim = dim3(GEMV_WARPS * 32, 1, 1);
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = splits;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cfg;
}

// One decode call (1 <= B <= 32) in S = splits K splits: one row a pass at
// B == 1, else passes of Body::NBM rows.  Refuses what it cannot take.
template <class Body>
cudaError_t gemv_launch(const GemvArgs& a, int splits, cudaStream_t st) {
  if (a.B < 1 || a.B > 32 || splits < 1 || splits > GEMV_MAX_SPLITS || splits > a.steps ||
      a.scode < SCALE_F32 || a.scode > SCALE_BF16)
    return cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg =
      gemv_config((a.N + GEMV_TILE_N - 1) / GEMV_TILE_N, splits, attr);
  cfg.stream = st;
  const cudaError_t e = a.B == 1 ? cudaLaunchKernelEx(&cfg, gemv_kernel<Body, 1>, a)
                                 : cudaLaunchKernelEx(&cfg, gemv_kernel<Body, Body::NBM>, a);
  if (e != cudaSuccess) cudaGetLastError();  // this launch's error, not left for the next
  return e;
}

// Clusters of `splits` blocks the card runs at once (rows: 1, or more a pass),
// or -1 on an error: ops/qmm.py::gemv_plan sizes the grid by it.
template <class Body>
int gemv_max_clusters(int splits, int rows) {
  if (splits < 1 || splits > GEMV_MAX_SPLITS) return -1;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = gemv_config(1024, splits, attr);
  int n = 0;
  const cudaError_t e =
      rows == 1 ? cudaOccupancyMaxActiveClusters(&n, (const void*)gemv_kernel<Body, 1>, &cfg)
                : cudaOccupancyMaxActiveClusters(&n, (const void*)gemv_kernel<Body, Body::NBM>,
                                                 &cfg);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return -1;
  }
  return n;
}

// ------------------------------------------------ split-K reduce pass (tile)
// The prefill tile's K splits write [splits, B, N] f32 partial sums;
// gemv_reduce adds them in a fixed order (deterministic, no atomics).

__global__ void gemv_reduce_kernel(const float* __restrict__ partial,
                                   float* __restrict__ out, int n_split, int total) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = 0.0f;
  for (int y = 0; y < n_split; ++y) s += partial[(size_t)y * total + i];
  out[i] = s;
}

inline cudaError_t gemv_reduce(const float* partial, float* out, int n_split,
                               int total, cudaStream_t st) {
  gemv_reduce_kernel<<<(total + 255) / 256, 256, 0, st>>>(partial, out, n_split, total);
  return cudaGetLastError();
}

}  // namespace qmm
