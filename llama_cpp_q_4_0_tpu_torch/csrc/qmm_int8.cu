// Unpacked int8 dequantize-matmul for Hopper (sm_90a): out[B,N] = x[B,K] @ dequant(W).
//
// Replaces the TPU kernels of llama_cpp_q_4_0_tpu/ops/pallas/qmm.py:
//   qmm_int8 (bias = NULL)  <- qmm -> _qmm_kernel       (q5_0, q8_0, q6_K)
//   qmm_int8 (with bias)    <- qmm -> _qmm_bias_kernel  (q5_1, q5_K)
// which share one pallas_call; the wrappers in ops/qmm.py count them as two
// kernels (qmm_int8, qmm_int8_bias).
//
// Layout (ops/qtensor.py of the port, unpacked form): levels int8 [K, N]
// (W^T, one signed level per byte), scales f32 [K/GS, N], the affine bias
// f32 [K/GS, N], GS = 16 (q6_K) or 32.  W^T[k, n] = level * scale (+ bias).
// Callers guarantee K % 64 == 0, N % 16 == 0, 16-byte aligned contiguous
// tensors (ops/qmm.py checks).
//
// The arithmetic is the TPU kernel's: each weight is rounded to
// bf16(level * d), x to bf16, and the products accumulate in f32; the bias
// is the full-K seed xg . gbias with xg the f32 group sums of un-rounded x.
//
// What bounds each form on an H100, and what the design does about it:
//  * Prefill (more than 32 rows) is bound by tensor-core operations.  The
//    tile kernel is the packed prefill kernel's (qmm_q4_0.cu) with 64
//    consecutive K rows per step: the x tile and the dequantized 64x128
//    weight tile sit in shared memory as bf16 and 8 warps run WMMA bf16
//    16x16x16 products into f32 fragments; bias_seed_kernel adds the seed.
//  * Decode (32 rows or fewer) is bound by the bytes of the levels and
//    planes: 8 bits per weight, twice the packed formats'.  Each thread
//    streams 8 consecutive columns (8-byte loads), each warp a 32-row step,
//    each block 8 steps; blocks split K and gemv_reduce sums the splits in a
//    fixed order.  x stays in registers, broadcast by warp shuffles, and the
//    group sums for the seed come from the same registers.
//  * Levels become floats by flipping the sign bit and a byte permute into
//    the mantissa of 2^23 (sbyte_to_float), not through the int-to-float unit.
#include "qmm_common.cuh"

using namespace qmm;

namespace {

// ----------------------------------------------------------------- prefill
template <int GS>
__global__ void __launch_bounds__(TILE_THREADS, 2)
qmm_int8_tile_kernel(const float* __restrict__ x, const int8_t* __restrict__ levels,
                     const float* __restrict__ scales, float* __restrict__ out,
                     int B, int K, int N) {
  __shared__ __align__(128) __nv_bfloat16 As[TM * AP];
  __shared__ __align__(128) __nv_bfloat16 Ws[TK * WP];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int m0 = blockIdx.y * TM;
  const int n0 = blockIdx.x * TN;
  const int wm = (warp / 4) * 64;
  const int wn = (warp % 4) * 32;

  AccFrag acc[4][2];
  tile_zero(acc);

  const int w_row = tid / 8;          // K row inside the step (and + 32)
  const int w_col = (tid % 8) * 16;   // 16-column chunk inside the tile
  const int w_gn = n0 + w_col;

  for (int k0 = 0; k0 < K; k0 += TK) {
    // x: TM rows x 16 float4, 8 float4 per thread
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int idx = tid + i * TILE_THREADS;
      stage_x4(x, As, B, K, m0, idx / 16, idx % 16, k0 + (idx % 16) * 4);
    }
    // weights: 64 rows x 128 columns, two rows of 16 bytes per thread
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int row = w_row + 32 * p;
      uint4 lv = make_uint4(0u, 0u, 0u, 0u);
      float s[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) s[j] = 0.0f;
      if (w_gn < N) {
        const size_t g = (size_t)(k0 + row) / GS;
        lv = *reinterpret_cast<const uint4*>(levels + (size_t)(k0 + row) * N + w_gn);
        load16(scales + g * N + w_gn, s);
      }
      const unsigned words[4] = {lv.x, lv.y, lv.z, lv.w};
      __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(Ws + row * WP + w_col);
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int j = 0; j < 4; j += 2) {
          const int c = 4 * q + j;
          dst[c / 2] = __floats2bfloat162_rn(sbyte_to_float(words[q], j) * s[c],
                                             sbyte_to_float(words[q], j + 1) * s[c + 1]);
        }
    }
    __syncthreads();
    tile_mma(As, Ws, wm, wn, acc);
    __syncthreads();
  }
  tile_store(out, acc, B, N, m0, n0, wm, wn, reinterpret_cast<float*>(As) + warp * 256);
}

// ------------------------------------------------------------------ decode
template <int NB, int GS, bool BIAS>
__global__ void __launch_bounds__(GEMV_WARPS * 32)
qmm_int8_gemv_kernel(const float* __restrict__ x, const int8_t* __restrict__ levels,
                     const float* __restrict__ scales, const float* __restrict__ bias,
                     float* __restrict__ partial, int B, int K, int N) {
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
      load8(scales + (size_t)(t * NG + h) * N + n, s[h]);
      if (BIAS) load8(bias + (size_t)(t * NG + h) * N + n, bi[h]);
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
cudaError_t launch_gemv(const float* x, const int8_t* levels, const float* scales,
                        const float* bias, float* partial, float* out, int B, int K,
                        int N, cudaStream_t st) {
  const int n_split = gemv_splits(K / 32);
  dim3 grid((N + GEMV_TILE_N - 1) / GEMV_TILE_N, n_split);
  if (B == 1)
    qmm_int8_gemv_kernel<1, GS, BIAS><<<grid, GEMV_WARPS * 32, 0, st>>>(
        x, levels, scales, bias, partial, B, K, N);
  else
    qmm_int8_gemv_kernel<8, GS, BIAS><<<grid, GEMV_WARPS * 32, 0, st>>>(
        x, levels, scales, bias, partial, B, K, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return gemv_reduce(partial, out, n_split, B * N, st);
}

template <int GS>
cudaError_t launch_int8(const float* x, const int8_t* levels, const float* scales,
                        const float* bias, float* scratch, float* out, int B, int K,
                        int N, cudaStream_t st) {
  if (B <= 32)
    return bias ? launch_gemv<GS, true>(x, levels, scales, bias, scratch, out, B, K, N, st)
                : launch_gemv<GS, false>(x, levels, scales, bias, scratch, out, B, K, N, st);
  dim3 grid((N + TN - 1) / TN, (B + TM - 1) / TM);
  qmm_int8_tile_kernel<GS><<<grid, TILE_THREADS, 0, st>>>(x, levels, scales, out, B, K, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !bias) return err;
  return bias_seed(x, bias, out, scratch, B, K, N, GS, K / GS, 0, st);
}

}  // namespace

extern "C" {

// Number of K splits of the decode form (B <= 32); the caller allocates
// partial sums of [splits, B, N] f32 for it.
int qmm_int8_splits(int K) { return gemv_splits(K / 32); }

// bias NULL: _qmm_kernel; else _qmm_bias_kernel.  scratch: at B <= 32 the
// K splits' partial sums (qmm_int8_splits(K) x B x N floats); above, with a
// bias, the group sums (B x K/gsize floats); else unused.
int qmm_int8(const void* x, const void* levels, const void* scales, const void* bias,
             void* scratch, void* out, int B, int K, int N, int gsize, void* stream) {
  const float* xf = (const float*)x;
  const int8_t* lv = (const int8_t*)levels;
  const float* sc = (const float*)scales;
  const float* bi = (const float*)bias;
  const cudaStream_t st = (cudaStream_t)stream;
  if (gsize == 32)
    return (int)launch_int8<32>(xf, lv, sc, bi, (float*)scratch, (float*)out, B, K, N, st);
  if (gsize == 16)
    return (int)launch_int8<16>(xf, lv, sc, bi, (float*)scratch, (float*)out, B, K, N, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
