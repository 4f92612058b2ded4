// Unpacked int8 dequantize-matmul for Hopper (sm_90a): out[B,N] = x[B,K] @ dequant(W).
//
// Replaces the TPU kernels of llama_cpp_q_4_0_tpu/ops/pallas/qmm.py:
//   qmm_int8 (bias = NULL)  <- qmm -> _qmm_kernel       (q5_0, q8_0, q6_K)
//   qmm_int8 (with bias)    <- qmm -> _qmm_bias_kernel  (q5_1, q5_K)
// which share one pallas_call; the wrappers in ops/qmm.py count them as two
// kernels (qmm_int8, qmm_int8_bias).
//
// Layout (ops/qtensor.py of the port, unpacked form): levels int8 [K, N]
// (W^T, one signed level per byte), scales [K/GS, N], the affine bias
// [K/GS, N], both f32, f16 or bf16 (the scode argument: ScaleCode of
// qmm_common.cuh), GS = 16 (q6_K) or 32.  W^T[k, n] = level * scale
// (+ bias).  Both forms widen a plane value to f32 as they load it.
// Callers guarantee K % 64 == 0, N % 16 == 0, 16-byte aligned contiguous
// tensors (ops/qmm.py checks).
//
// The arithmetic is the TPU kernel's: each weight is rounded to
// bf16(level * d), x to bf16, and the products accumulate in f32; the bias
// is the full-K seed xg . gbias with xg the f32 group sums of un-rounded x.
//
// What bounds each form on an H100, and what the design does about it:
//  * Prefill (more than 32 rows) is bound by tensor-core operations: it runs
//    the shared Hopper tile of qmm_tile.cuh (TMA rings, dequantizing
//    warpgroups, wgmma consumers, a persistent loop over M, N and K splits)
//    with Int8Deq below as its layout policy, 64 consecutive K rows per
//    step; the bias seed runs as extra K steps of the same mainloop on bf16
//    hi/lo parts of xg and gbias, so no pass after the tile touches out.
//  * Decode (32 rows or fewer) is bound by the bytes of the levels and
//    planes: 8 bits per weight, twice the packed formats'.  Each thread
//    streams 8 consecutive columns (8-byte loads), each warp a 32-row step,
//    each block 8 steps; blocks split K and gemv_reduce sums the splits in a
//    fixed order.  x stays in registers, broadcast by warp shuffles, and the
//    group sums for the seed come from the same registers.
//  * Levels become floats by flipping the sign bit and a byte permute into
//    the mantissa of 2^23 (sbyte_to_float), not through the int-to-float unit.
#include "qmm_common.cuh"
#include "qmm_tile.cuh"

using namespace qmm;

namespace {

// ----------------------------------------------------------------- prefill
// The tile's policy for int8 levels (qmm_tile.cuh): a step is 64 level rows
// and their 64/GS scale rows; thread t writes columns c .. c+8 of rows
// r0 + 8p as bf16(level * d).
template <int GS>
struct Int8Deq {
  static constexpr bool Q8 = false;
  static constexpr int PERM = 0;
  static constexpr int W_ROWS = 64;
  static constexpr int S_ROWS = 64 / GS;
  static constexpr uint32_t main_bytes(int es) { return 64 * tile::TN + S_ROWS * tile::TN * es; }

  __device__ static void load(uint32_t raw, const CUtensorMap* w, const CUtensorMap* s, int v,
                              int n0, uint32_t bar) {
    tile::tma_load(raw, w, n0, 64 * v, bar);
    tile::tma_load(raw + tile::SCALE_OFF, s, n0, S_ROWS * v, bar);
  }

  template <int SC>
  __device__ static void dequant(const uint8_t* __restrict__ raw, uint8_t* __restrict__ bs,
                                 int t, float) {
    const int c = (t & 15) * 8, r0 = t >> 4;
    float s[S_ROWS][8];
#pragma unroll
    for (int g = 0; g < S_ROWS; ++g)
      load8s<SC>(raw + tile::SCALE_OFF, g * tile::TN + c, s[g]);
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const int k = r0 + 8 * p, g = 8 * p / GS;
      const uint2 lv = *reinterpret_cast<const uint2*>(raw + k * tile::TN + c);
      float f[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        f[e] = sbyte_to_float(e < 4 ? lv.x : lv.y, e % 4) * s[g][e];
      *reinterpret_cast<uint4*>(bs + tile::b_off(k, c)) =
          make_uint4(tile::pack_bf16(f[0], f[1]), tile::pack_bf16(f[2], f[3]),
                     tile::pack_bf16(f[4], f[5]), tile::pack_bf16(f[6], f[7]));
    }
  }
};

// ------------------------------------------------------------------ decode
template <int NB, int GS, bool BIAS>
__global__ void __launch_bounds__(GEMV_WARPS * 32)
qmm_int8_gemv_kernel(const float* __restrict__ x, const int8_t* __restrict__ levels,
                     const void* __restrict__ scales, const void* __restrict__ bias,
                     float* __restrict__ partial, int B, int K, int N, int scode) {
  constexpr int NG = 32 / GS;  // groups per 32-row step
  __shared__ float red[GEMV_WARPS][GEMV_TILE_N];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int t = blockIdx.y * GEMV_WARPS + warp;  // 32-row step, warp-uniform
  const bool t_ok = t < K / 32;
  const int n = blockIdx.x * GEMV_TILE_N + lane * GEMV_COLS;
  const bool col_ok = n < N;

  float s[NG][GEMV_COLS], bi[NG][GEMV_COLS];
#pragma unroll
  for (int h = 0; h < NG; ++h)
#pragma unroll
    for (int c = 0; c < GEMV_COLS; ++c) s[h][c] = bi[h][c] = 0.0f;
  if (t_ok && col_ok) {
#pragma unroll
    for (int h = 0; h < NG; ++h) {
      load8s(scales, (size_t)(t * NG + h) * N + n, scode, s[h]);
      if (BIAS) load8s(bias, (size_t)(t * NG + h) * N + n, scode, bi[h]);
    }
  }

  for (int b0 = 0; b0 < B; b0 += NB) {
    float acc[NB][GEMV_COLS];
#pragma unroll
    for (int bb = 0; bb < NB; ++bb)
#pragma unroll
      for (int c = 0; c < GEMV_COLS; ++c) acc[bb][c] = 0.0f;

    if (t_ok) {
      // lane l holds x[b, 32t + l]
      float xr[NB], xg[NB][NG];
#pragma unroll
      for (int bb = 0; bb < NB; ++bb) {
        const int b = b0 + bb;
        const float v = b < B ? x[(size_t)b * K + t * 32 + lane] : 0.0f;
        xr[bb] = bf16_round(v);
        if (BIAS) {
          float sum = v;  // sums over each GS-lane segment
#pragma unroll
          for (int o = GS / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(FULL, sum, o);
#pragma unroll
          for (int h = 0; h < NG; ++h) xg[bb][h] = __shfl_sync(FULL, sum, h * GS);
        }
      }
#pragma unroll
      for (int h = 0; h < NG; ++h) {
        const int8_t* prow = levels + (size_t)(t * 32 + h * GS) * N + n;
#pragma unroll 4
        for (int r = 0; r < GS; ++r) {
          uint2 lv = make_uint2(0u, 0u);
          if (col_ok) lv = *reinterpret_cast<const uint2*>(prow + (size_t)r * N);
          float w[GEMV_COLS];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            w[j] = bf16_round(sbyte_to_float(lv.x, j) * s[h][j]);
            w[4 + j] = bf16_round(sbyte_to_float(lv.y, j) * s[h][4 + j]);
          }
#pragma unroll
          for (int bb = 0; bb < NB; ++bb) {
            const float xv = __shfl_sync(FULL, xr[bb], h * GS + r);
#pragma unroll
            for (int c = 0; c < GEMV_COLS; ++c) acc[bb][c] += xv * w[c];
          }
        }
        if (BIAS) {
#pragma unroll
          for (int bb = 0; bb < NB; ++bb)
#pragma unroll
            for (int c = 0; c < GEMV_COLS; ++c) acc[bb][c] += xg[bb][h] * bi[h][c];
        }
      }
    }
#pragma unroll
    for (int bb = 0; bb < NB; ++bb)
      gemv_block_partial(red, acc[bb], partial, b0 + bb, B, N);
  }
}

template <int GS, bool BIAS>
cudaError_t launch_gemv(const float* x, const int8_t* levels, const void* scales,
                        const void* bias, float* partial, float* out, int B, int K,
                        int N, int scode, cudaStream_t st) {
  const int n_split = gemv_splits(K / 32);
  dim3 grid((N + GEMV_TILE_N - 1) / GEMV_TILE_N, n_split);
  if (B == 1)
    qmm_int8_gemv_kernel<1, GS, BIAS><<<grid, GEMV_WARPS * 32, 0, st>>>(
        x, levels, scales, bias, partial, B, K, N, scode);
  else
    qmm_int8_gemv_kernel<8, GS, BIAS><<<grid, GEMV_WARPS * 32, 0, st>>>(
        x, levels, scales, bias, partial, B, K, N, scode);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return gemv_reduce(partial, out, n_split, B * N, st);
}

// scratch: the decode form's partial sums (B <= 32) or the tile's (splits > 1)
template <int GS>
cudaError_t launch_int8(const float* x, const int8_t* levels, const void* scales,
                        const void* bias, float* scratch, void* xa, float* out, int B, int K,
                        int N, int bm, int splits, int ka, int scode, cudaStream_t st) {
  if (B <= 32) {
    if (scode < SCALE_F32 || scode > SCALE_BF16) return cudaErrorInvalidValue;
    return bias ? launch_gemv<GS, true>(x, levels, scales, bias, scratch, out, B, K, N, scode, st)
                : launch_gemv<GS, false>(x, levels, scales, bias, scratch, out, B, K, N, scode,
                                         st);
  }
  return tile::launch<Int8Deq<GS>>(x, levels, K, scales, K / GS, bias, (__nv_bfloat16*)xa,
                                   scratch, out, B, K, N, 1, GS, 0, 0.0f, bm, splits, ka, scode,
                                   st);
}

}  // namespace

extern "C" {

// Number of K splits of the decode form (B <= 32); the caller allocates
// partial sums of [splits, B, N] f32 for it.
int qmm_int8_splits(int K) { return gemv_splits(K / 32); }

// bias NULL: _qmm_kernel; else _qmm_bias_kernel.  At B <= 32 scratch holds
// the K splits' partial sums (qmm_int8_splits(K) x B x N floats) and xa is
// unused; above, the prefill tile with the seed fused: xa bf16 [B, ka],
// scratch f32 [splits, B, N] when splits > 1 (bm, splits and ka from
// ops/qmm.py::tile_plan).  scode: the dtype of scales and bias (ScaleCode).
int qmm_int8(const void* x, const void* levels, const void* scales, const void* bias,
             void* scratch, void* xa, void* out, int B, int K, int N, int gsize, int bm,
             int splits, int ka, int scode, void* stream) {
  const float* xf = (const float*)x;
  const int8_t* lv = (const int8_t*)levels;
  const cudaStream_t st = (cudaStream_t)stream;
  if (gsize == 32)
    return (int)launch_int8<32>(xf, lv, scales, bias, (float*)scratch, xa, (float*)out, B, K, N,
                                bm, splits, ka, scode, st);
  if (gsize == 16)
    return (int)launch_int8<16>(xf, lv, scales, bias, (float*)scratch, xa, (float*)out, B, K, N,
                                bm, splits, ka, scode, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
