// Packed 4-bit dequantize-matmul for Hopper (sm_90a): out[B,N] = x[B,K] @ dequant(W).
//
// Replaces the TPU kernels of llama_cpp_q_4_0_tpu/ops/pallas/qmm.py:
//   qmm_q4_0         <- qmm_packed -> _qmm_packed_kernel        (prefill, > 32 rows)
//   qmm_q4_0_kfold   <- qmm_packed(kfold=True)
//                       -> _qmm_packed_kfold_kernel              (decode, <= 32 rows)
//   qmm_packed_bias  <- qmm_packed(gbias_t) -> _qmm_packed_bias_kernel
//                       (packed affine formats q4_K, q4_1, q2_K; every row count)
//
// Layout (ops/qtensor.py of the port): packed uint8 [K2P, N], byte [r, n] holds
// row r of W^T in its low nibble and row r + K/2 in its high nibble, each a
// level plus the pack zero; scales (and the affine bias) f32 [2, K2P/GS, N],
// plane 0 for the low panel and plane 1 for the high panel, GS = 32 or 16.
// Rows K/2..K2P are padding: the kernels loop over the real K/2 rows only.
// Callers guarantee K % 64 == 0, N % 16 == 0, 16-byte aligned contiguous
// tensors (ops/qmm.py checks).
//
// What bounds each form on an H100, and what the design does about it:
//  * The prefill form (qmm_q4_0; qmm_packed_bias above 32 rows) is bound by
//    tensor-core operations.  A block owns a 128x128 output tile (8 warps,
//    64x32 each).  Per 32-row packed step it stages 64 logical K rows (both
//    panels) of x as bf16 and the dequantized 64x128 weight tile in shared
//    memory, rounded exactly as the TPU kernel rounds (bf16((nib - zero) * d)),
//    then runs bf16 WMMA 16x16x16 products into f32 accumulators.  The TPU's
//    sequential K grid axis becomes the step loop inside the block.  The
//    affine bias is the TPU kernel's full-K seed xg_lo.gbias_lo +
//    xg_hi.gbias_hi (xg the f32 group sums of x), added by bias_seed_kernel
//    after the tile kernel.  No wgmma, TMA or pipelining yet: two blocks per
//    SM hide each other's loads.
//  * The decode form (qmm_q4_0_kfold; qmm_packed_bias at 32 rows or fewer) is
//    bound by the bytes of the packed weight and its planes, read once per
//    token.  Each thread streams 8 consecutive columns (8-byte loads; a warp
//    covers 256 contiguous bytes of a row), each warp one 32-row step, each
//    block 8 steps; blocks split K so that the card has enough loads in
//    flight, and gemv_reduce sums the K splits in a fixed order.  x stays in
//    registers and is broadcast with warp shuffles; the group sums xg come
//    from the same registers by shuffle reductions.  kfold folds the zero
//    point as the TPU kernel does (weights bf16(nib * d), plus
//    -zero * (xg_lo * d_lo + xg_hi * d_hi) per group); the affine form
//    dequantizes bf16((nib - zero) * d) and adds xg_lo * b_lo + xg_hi * b_hi.
//  * Nibbles become floats by a byte permute into the mantissa of 2^23
//    (byte_to_float) instead of the int-to-float unit, which issues at a
//    fraction of the FMA rate and would otherwise bound the decode form
//    before the memory does (two conversions per weight byte).
#include "qmm_common.cuh"

using namespace qmm;

namespace {

// ----------------------------------------------------------------- prefill
// One 32-row packed step per iteration.  Q4_0 (K1): zero 8 at compile time;
// else (K5) the runtime zero.  A 32-group is uniform across the block (row
// r0 / 32 of each plane); a 16-group's row is r0 / 16 + w_row / 16.  The
// counted step loop and the interleaved low/high scale loads matter: with
// an `r0 += 32` loop and one plane loaded after the other, the same body
// ran K1 3% slower on the 7B shapes.
template <int GS, bool Q4_0>
__global__ void __launch_bounds__(TILE_THREADS, 2)
qmm_packed_tile_kernel(const float* __restrict__ x, const uint8_t* __restrict__ packed,
                       const float* __restrict__ scales, float* __restrict__ out,
                       int B, int K, int N, int G2P, float zero_arg) {
  const float zero = Q4_0 ? 8.0f : zero_arg;
  // x tile [TM][64] bf16: cols 0..31 the low panel, 32..63 the high panel;
  // weight tile [64][TN] bf16: rows 0..31 low nibbles, 32..63 high nibbles
  __shared__ __align__(128) __nv_bfloat16 As[TM * AP];
  __shared__ __align__(128) __nv_bfloat16 Ws[TK * WP];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int m0 = blockIdx.y * TM;
  const int n0 = blockIdx.x * TN;
  const int k2 = K / 2;
  const int wm = (warp / 4) * 64;
  const int wn = (warp % 4) * 32;

  AccFrag acc[4][2];
  tile_zero(acc);

  const int w_row = tid / 8;          // packed row inside the step
  const int w_col = (tid % 8) * 16;   // 16-column chunk inside the tile
  const int w_gn = n0 + w_col;

  const int n_steps = k2 / 32;
  for (int gi = 0; gi < n_steps; ++gi) {
    const int r0 = gi * 32;
    // x: TM rows x 16 float4 (8 per panel), 8 float4 per thread
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int idx = tid + i * TILE_THREADS;
      const int m = idx / 16;
      const int c4 = idx % 16;
      stage_x4(x, As, B, K, m0, m, c4,
               c4 < 8 ? r0 + c4 * 4 : k2 + r0 + (c4 - 8) * 4);
    }
    // weights: 32 packed rows x 128 columns, 16 bytes per thread
    {
      uint4 pk = make_uint4(0u, 0u, 0u, 0u);
      float slo[16], shi[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) slo[j] = shi[j] = 0.0f;
      if (w_gn < N) {
        const int g = GS == 32 ? r0 / 32 : r0 / GS + w_row / GS;
        pk = *reinterpret_cast<const uint4*>(packed + (size_t)(r0 + w_row) * N + w_gn);
        const float4* pl = reinterpret_cast<const float4*>(scales + (size_t)g * N + w_gn);
        const float4* ph =
            reinterpret_cast<const float4*>(scales + ((size_t)G2P + g) * N + w_gn);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 a = pl[q], b = ph[q];
          slo[4 * q] = a.x; slo[4 * q + 1] = a.y; slo[4 * q + 2] = a.z; slo[4 * q + 3] = a.w;
          shi[4 * q] = b.x; shi[4 * q + 1] = b.y; shi[4 * q + 2] = b.z; shi[4 * q + 3] = b.w;
        }
      }
      const unsigned words[4] = {pk.x, pk.y, pk.z, pk.w};
      __nv_bfloat162* dlo = reinterpret_cast<__nv_bfloat162*>(Ws + w_row * WP + w_col);
      __nv_bfloat162* dhi = reinterpret_cast<__nv_bfloat162*>(Ws + (32 + w_row) * WP + w_col);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const unsigned lo = words[q] & 0x0F0F0F0Fu;
        const unsigned hi = (words[q] >> 4) & 0x0F0F0F0Fu;
#pragma unroll
        for (int j = 0; j < 4; j += 2) {
          const int c = 4 * q + j;
          dlo[c / 2] = __floats2bfloat162_rn((byte_to_float(lo, j) - zero) * slo[c],
                                             (byte_to_float(lo, j + 1) - zero) * slo[c + 1]);
          dhi[c / 2] = __floats2bfloat162_rn((byte_to_float(hi, j) - zero) * shi[c],
                                             (byte_to_float(hi, j + 1) - zero) * shi[c + 1]);
        }
      }
    }
    __syncthreads();
    tile_mma(As, Ws, wm, wn, acc);
    __syncthreads();
  }
  // the x tile is free now: per-warp staging for ragged fragments
  tile_store(out, acc, B, N, m0, n0, wm, wn, reinterpret_cast<float*>(As) + warp * 256);
}

// ------------------------------------------------------------------ decode
// FOLD: the kfold form (bf16(nib * d), seed -zero * xg.d); else the affine
// form (bf16((nib - zero) * d), seed xg.bias).
template <int NB, int GS, bool FOLD>
__global__ void __launch_bounds__(GEMV_WARPS * 32)
qmm_packed_gemv_kernel(const float* __restrict__ x, const uint8_t* __restrict__ packed,
                       const float* __restrict__ scales, const float* __restrict__ bias,
                       float* __restrict__ partial, int B, int K, int N, int G2P,
                       float zero) {
  constexpr int NG = 32 / GS;  // groups per 32-row step
  __shared__ float red[GEMV_WARPS][GEMV_TILE_N];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int k2 = K / 2;
  const int t = blockIdx.y * GEMV_WARPS + warp;  // 32-row step, warp-uniform
  const bool t_ok = t < k2 / 32;
  const int n = blockIdx.x * GEMV_TILE_N + lane * GEMV_COLS;
  const bool col_ok = n < N;

  float sl[NG][GEMV_COLS], sh[NG][GEMV_COLS], bl[NG][GEMV_COLS], bh[NG][GEMV_COLS];
#pragma unroll
  for (int h = 0; h < NG; ++h)
#pragma unroll
    for (int c = 0; c < GEMV_COLS; ++c) sl[h][c] = sh[h][c] = bl[h][c] = bh[h][c] = 0.0f;
  if (t_ok && col_ok) {
#pragma unroll
    for (int h = 0; h < NG; ++h) {
      const int g = t * NG + h;
      load8(scales + (size_t)g * N + n, sl[h]);
      load8(scales + ((size_t)G2P + g) * N + n, sh[h]);
      if (!FOLD) {
        load8(bias + (size_t)g * N + n, bl[h]);
        load8(bias + ((size_t)G2P + g) * N + n, bh[h]);
      }
    }
  }

  for (int b0 = 0; b0 < B; b0 += NB) {
    float acc[NB][GEMV_COLS];
#pragma unroll
    for (int bb = 0; bb < NB; ++bb)
#pragma unroll
      for (int c = 0; c < GEMV_COLS; ++c) acc[bb][c] = 0.0f;

    if (t_ok) {
      // lane l holds x[b, 32t + l] (low panel) and x[b, K/2 + 32t + l] (high)
      float xlo[NB], xhi[NB], xg_lo[NB][NG], xg_hi[NB][NG];
#pragma unroll
      for (int bb = 0; bb < NB; ++bb) {
        const int b = b0 + bb;
        const float vlo = b < B ? x[(size_t)b * K + t * 32 + lane] : 0.0f;
        const float vhi = b < B ? x[(size_t)b * K + k2 + t * 32 + lane] : 0.0f;
        xlo[bb] = bf16_round(vlo);
        xhi[bb] = bf16_round(vhi);
        float slo_sum = vlo, shi_sum = vhi;  // sums over each GS-lane segment
#pragma unroll
        for (int o = GS / 2; o > 0; o >>= 1) {
          slo_sum += __shfl_xor_sync(FULL, slo_sum, o);
          shi_sum += __shfl_xor_sync(FULL, shi_sum, o);
        }
#pragma unroll
        for (int h = 0; h < NG; ++h) {
          xg_lo[bb][h] = __shfl_sync(FULL, slo_sum, h * GS);
          xg_hi[bb][h] = __shfl_sync(FULL, shi_sum, h * GS);
        }
      }
#pragma unroll
      for (int h = 0; h < NG; ++h) {
        const uint8_t* prow = packed + (size_t)(t * 32 + h * GS) * N + n;
#pragma unroll 4
        for (int r = 0; r < GS; ++r) {
          uint2 pk = make_uint2(0u, 0u);
          if (col_ok) pk = *reinterpret_cast<const uint2*>(prow + (size_t)r * N);
          float wl[GEMV_COLS], wh[GEMV_COLS];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const unsigned wd = q ? pk.y : pk.x;
            const unsigned lo = wd & 0x0F0F0F0Fu;
            const unsigned hi = (wd >> 4) & 0x0F0F0F0Fu;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int c = 4 * q + j;
              if (FOLD) {
                wl[c] = bf16_round(byte_to_float(lo, j) * sl[h][c]);
                wh[c] = bf16_round(byte_to_float(hi, j) * sh[h][c]);
              } else {
                wl[c] = bf16_round((byte_to_float(lo, j) - zero) * sl[h][c]);
                wh[c] = bf16_round((byte_to_float(hi, j) - zero) * sh[h][c]);
              }
            }
          }
#pragma unroll
          for (int bb = 0; bb < NB; ++bb) {
            const float xl = __shfl_sync(FULL, xlo[bb], h * GS + r);
            const float xh = __shfl_sync(FULL, xhi[bb], h * GS + r);
#pragma unroll
            for (int c = 0; c < GEMV_COLS; ++c) {
              acc[bb][c] += xl * wl[c];
              acc[bb][c] += xh * wh[c];
            }
          }
        }
#pragma unroll
        for (int bb = 0; bb < NB; ++bb)
#pragma unroll
          for (int c = 0; c < GEMV_COLS; ++c) {
            if (FOLD)
              acc[bb][c] += -zero * (xg_lo[bb][h] * sl[h][c] + xg_hi[bb][h] * sh[h][c]);
            else
              acc[bb][c] += xg_lo[bb][h] * bl[h][c] + xg_hi[bb][h] * bh[h][c];
          }
      }
    }
#pragma unroll
    for (int bb = 0; bb < NB; ++bb)
      gemv_block_partial(red, acc[bb], partial, b0 + bb, B, N);
  }
}

template <int GS, bool FOLD>
cudaError_t launch_gemv(const float* x, const uint8_t* packed, const float* scales,
                        const float* bias, float* partial, float* out, int B, int K,
                        int N, int G2P, float zero, cudaStream_t st) {
  const int n_split = gemv_splits(K / 2 / 32);
  dim3 grid((N + GEMV_TILE_N - 1) / GEMV_TILE_N, n_split);
  // one row (a decode step), or rows in passes of 8 (the bucket-8 and -32
  // prefill calls and the output head of a batch)
  if (B == 1)
    qmm_packed_gemv_kernel<1, GS, FOLD><<<grid, GEMV_WARPS * 32, 0, st>>>(
        x, packed, scales, bias, partial, B, K, N, G2P, zero);
  else
    qmm_packed_gemv_kernel<8, GS, FOLD><<<grid, GEMV_WARPS * 32, 0, st>>>(
        x, packed, scales, bias, partial, B, K, N, G2P, zero);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return gemv_reduce(partial, out, n_split, B * N, st);
}

template <int GS, bool Q4_0>
cudaError_t launch_tile(const float* x, const uint8_t* packed, const float* scales,
                        float* out, int B, int K, int N, int G2P, float zero,
                        cudaStream_t st) {
  dim3 grid((N + TN - 1) / TN, (B + TM - 1) / TM);
  qmm_packed_tile_kernel<GS, Q4_0><<<grid, TILE_THREADS, 0, st>>>(
      x, packed, scales, out, B, K, N, G2P, zero);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Number of K splits (blocks along K) of the decode form; the caller
// allocates partial sums of [splits, B, N] f32.
int qmm_packed_splits(int K) { return gemv_splits(K / 2 / 32); }

int qmm_q4_0(const void* x, const void* packed, const void* scales, void* out,
             int B, int K, int N, int G2P, void* stream) {
  return (int)launch_tile<32, true>((const float*)x, (const uint8_t*)packed,
                                    (const float*)scales, (float*)out, B, K, N, G2P,
                                    8.0f, (cudaStream_t)stream);
}

int qmm_q4_0_kfold(const void* x, const void* packed, const void* scales,
                   void* partial, void* out, int B, int K, int N, int G2P,
                   void* stream) {
  return (int)launch_gemv<32, true>((const float*)x, (const uint8_t*)packed,
                                    (const float*)scales, nullptr, (float*)partial,
                                    (float*)out, B, K, N, G2P, 8.0f,
                                    (cudaStream_t)stream);
}

// The affine form: the decode shape at B <= 32 (scratch holds the K splits'
// partial sums, qmm_packed_splits(K) x B x N floats), else the prefill tile
// plus the full-K bias seed (scratch holds the group sums, B x K/gsize).
int qmm_packed_bias(const void* x, const void* packed, const void* scales,
                    const void* bias, void* scratch, void* out, int B, int K, int N,
                    int G2P, int zero, int gsize, void* stream) {
  const float* xf = (const float*)x;
  const uint8_t* pk = (const uint8_t*)packed;
  const float* sc = (const float*)scales;
  const float* bi = (const float*)bias;
  float* o = (float*)out;
  const cudaStream_t st = (cudaStream_t)stream;
  const float z = (float)zero;
  if (gsize != 16 && gsize != 32) return (int)cudaErrorInvalidValue;
  if (B <= 32) {
    return (int)(gsize == 32
        ? launch_gemv<32, false>(xf, pk, sc, bi, (float*)scratch, o, B, K, N, G2P, z, st)
        : launch_gemv<16, false>(xf, pk, sc, bi, (float*)scratch, o, B, K, N, G2P, z, st));
  }
  cudaError_t err = gsize == 32 ? launch_tile<32, false>(xf, pk, sc, o, B, K, N, G2P, z, st)
                                : launch_tile<16, false>(xf, pk, sc, o, B, K, N, G2P, z, st);
  if (err != cudaSuccess) return (int)err;
  return (int)bias_seed(xf, bi, o, (float*)scratch, B, K, N, gsize, K / 2 / gsize,
                        G2P, st);
}

}  // extern "C"
