// Pieces shared by the quantized matmul kernels of qmm_q4_0.cu and
// qmm_int8.cu (Hopper, sm_90a): exact byte -> float unpacking, bf16 rounding,
// the 128x128 WMMA tile step and epilogue of the prefill forms, the
// deterministic split-K reduce of the decode forms, and the full-K affine
// bias seed of the prefill forms.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace qmm {

using namespace nvcuda;

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Byte j (a value 0..255) of v as an exact float without the slow
// int-to-float unit: the byte becomes the low mantissa bits of 2^23.
__device__ __forceinline__ float byte_to_float(unsigned v, int j) {
  return __int_as_float(__byte_perm(v, 0x4B000000u, 0x7540 + j)) - 8388608.0f;
}

// Signed byte j of v (an int8 level) as an exact float: flipping the sign
// bit maps -128..127 onto 0..255, then the same mantissa trick.
__device__ __forceinline__ float sbyte_to_float(unsigned v, int j) {
  return __int_as_float(__byte_perm(v ^ 0x80808080u, 0x4B000000u, 0x7540 + j))
         - 8388736.0f;
}

// 8 consecutive f32 values (32-byte aligned by the callers' N % 8 == 0 and
// 16-byte aligned bases)
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// 16 consecutive f32 values (the prefill tiles' 16-column chunks)
__device__ __forceinline__ void load16(const float* p, float (&v)[16]) {
  const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 a = q[i];
    v[4 * i] = a.x; v[4 * i + 1] = a.y; v[4 * i + 2] = a.z; v[4 * i + 3] = a.w;
  }
}

// ------------------------------------------------------ prefill tile (WMMA)
// A block owns a 128x128 output tile with 8 warps (2 along M x 4 along N,
// 64x32 each) and steps over K 64 rows at a time: x as bf16 in As [128][64]
// and the dequantized weights as bf16 in Ws [64][128].
constexpr int TM = 128;
constexpr int TN = 128;
constexpr int TK = 64;
constexpr int TILE_THREADS = 256;
constexpr int AP = TK + 8;   // padded row stride (elements) of the x tile
constexpr int WP = TN + 8;   // padded row stride of the weight tile

using AccFrag = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__device__ __forceinline__ void tile_zero(AccFrag (&acc)[4][2]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
}

// Row m of x, columns [c0, c0 + 4) as bf16 into As: the x tile's loader.
__device__ __forceinline__ void stage_x4(const float* x, __nv_bfloat16* As,
                                         int B, int K, int m0, int m, int c4,
                                         int col) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (m0 + m < B) v = *reinterpret_cast<const float4*>(x + (size_t)(m0 + m) * K + col);
  __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(As + m * AP + c4 * 4);
  dst[0] = __floats2bfloat162_rn(v.x, v.y);
  dst[1] = __floats2bfloat162_rn(v.z, v.w);
}

// acc += As[wm.., 0..64) @ Ws[0..64, wn..)
__device__ __forceinline__ void tile_mma(const __nv_bfloat16* As,
                                         const __nv_bfloat16* Ws, int wm, int wn,
                                         AccFrag (&acc)[4][2]) {
#pragma unroll
  for (int kk = 0; kk < TK; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[4];
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      wmma::load_matrix_sync(a[i], As + (wm + 16 * i) * AP + kk, AP);
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], Ws + kk * WP + wn + 16 * j, WP);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
  }
}

// Whole 16x16 fragments straight to memory; ragged ones (past row B) through
// a per-warp 16x16 staging tile (`stage`, 256 floats of free shared memory).
__device__ __forceinline__ void tile_store(float* out, AccFrag (&acc)[4][2],
                                           int B, int N, int m0, int n0, int wm,
                                           int wn, float* stage) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int m = m0 + wm + 16 * i;
      const int n = n0 + wn + 16 * j;
      if (m >= B || n >= N) continue;  // warp-uniform
      if (m + 16 <= B) {
        wmma::store_matrix_sync(out + (size_t)m * N + n, acc[i][j], N,
                                wmma::mem_row_major);
      } else {
        wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int mm = m + e / 16;
          if (mm < B) out[(size_t)mm * N + n + e % 16] = stage[e];
        }
        __syncwarp();
      }
    }
}

// ------------------------------------------------------- decode (split-K)
// Decode forms: a block of GEMV_WARPS warps covers GEMV_TILE_N columns (8 per
// lane) and GEMV_WARPS tiles of 32 K rows; each writes its partial sums and
// gemv_reduce adds the K splits in a fixed order (deterministic, no atomics).
constexpr int GEMV_WARPS = 8;
constexpr int GEMV_COLS = 8;
constexpr int GEMV_TILE_N = 32 * GEMV_COLS;

// The block's warps' acc for one output row, summed and written as this
// block's partial: every thread of the block calls it.
__device__ __forceinline__ void gemv_block_partial(float (*red)[GEMV_TILE_N],
                                                   const float (&acc)[GEMV_COLS],
                                                   float* partial, int b, int B,
                                                   int N) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < GEMV_COLS; ++c) red[warp][lane * GEMV_COLS + c] = acc[c];
  __syncthreads();
  float s = 0.0f;
#pragma unroll
  for (int w = 0; w < GEMV_WARPS; ++w) s += red[w][threadIdx.x];
  const int col = blockIdx.x * GEMV_TILE_N + threadIdx.x;
  if (b < B && col < N) partial[((size_t)blockIdx.y * B + b) * N + col] = s;
  __syncthreads();
}

__global__ void gemv_reduce_kernel(const float* __restrict__ partial,
                                   float* __restrict__ out, int n_split, int total) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = 0.0f;
  for (int y = 0; y < n_split; ++y) s += partial[(size_t)y * total + i];
  out[i] = s;
}

inline int gemv_splits(int tiles) { return (tiles + GEMV_WARPS - 1) / GEMV_WARPS; }

inline cudaError_t gemv_reduce(const float* partial, float* out, int n_split,
                               int total, cudaStream_t st) {
  gemv_reduce_kernel<<<(total + 255) / 256, 256, 0, st>>>(partial, out, n_split, total);
  return cudaGetLastError();
}

// ------------------------------------------------- affine bias seed (prefill)
// out[m, n] += sum_g xg[m, g] * bias_row(g)[n], xg[m, g] the f32 sum of the
// un-rounded x[m, g*GS .. (g+1)*GS), computed once into scratch by
// group_sums_kernel.  Logical group g lies in bias row g while g < G2, else
// in row G2P + g - G2 (the high plane of a packed tensor; an unpacked caller
// passes G2 = K / GS).  A block covers 64 rows x 128 columns (each thread
// 4 x 8) and walks the groups 16 at a time through shared memory.  f32 on
// the CUDA cores: the seed is 1/GS of the weight product's operations.
constexpr int SEED_M = 64;
constexpr int SEED_N = 128;
constexpr int SEED_G = 16;

__global__ void group_sums_kernel(const float* __restrict__ x, float* __restrict__ xg,
                                  int B, int K, int GS) {
  const int G = K / GS;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;  // m * G + g
  if (i >= B * G) return;
  const float4* p = reinterpret_cast<const float4*>(x + (size_t)(i / G) * K + (i % G) * GS);
  float s = 0.0f;
  for (int e = 0; e < GS / 4; ++e) {
    const float4 v = p[e];
    s += v.x; s += v.y; s += v.z; s += v.w;
  }
  xg[i] = s;
}

__global__ void __launch_bounds__(256)
bias_seed_kernel(const float* __restrict__ xg, const float* __restrict__ bias,
                 float* __restrict__ out, int B, int G, int N, int G2, int G2P) {
  __shared__ float xg_s[SEED_G][SEED_M];
  __shared__ __align__(16) float b_s[SEED_G][SEED_N];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * SEED_M;
  const int n0 = blockIdx.x * SEED_N;
  const int ty = tid / 16, tx = tid % 16;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int gc = 0; gc < G; gc += SEED_G) {
    {  // group sums: thread -> row tid / 4, groups (tid % 4) * 4 .. + 4
      const int m = m0 + tid / 4;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int gl = (tid % 4) * 4 + i;
        const int g = gc + gl;
        xg_s[gl][tid / 4] = g < G && m < B ? xg[(size_t)m * G + g] : 0.0f;
      }
    }
    {  // bias rows: thread -> row tid / 16, columns (tid % 16) * 8 .. + 8
      const int gl = tid / 16;
      const int g = gc + gl;
      const int n = n0 + tx * 8;
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (g < G && n < N) {
        const int row = g < G2 ? g : G2P + g - G2;
        load8(bias + (size_t)row * N + n, v);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) b_s[gl][tx * 8 + j] = v[j];
    }
    __syncthreads();
#pragma unroll 4
    for (int gl = 0; gl < SEED_G; ++gl) {
      float a[4], b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xg_s[gl][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = b_s[gl][tx * 8 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= B) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + tx * 8 + j;
      if (n < N) out[(size_t)m * N + n] += acc[i][j];
    }
  }
}

// xg: scratch of B * K / GS floats
inline cudaError_t bias_seed(const float* x, const float* bias, float* out, float* xg,
                             int B, int K, int N, int GS, int G2, int G2P,
                             cudaStream_t st) {
  const int G = K / GS;
  group_sums_kernel<<<(B * G + 255) / 256, 256, 0, st>>>(x, xg, B, K, GS);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid((N + SEED_N - 1) / SEED_N, (B + SEED_M - 1) / SEED_M);
  bias_seed_kernel<<<grid, 256, 0, st>>>(xg, bias, out, B, G, N, G2, G2P);
  return cudaGetLastError();
}

}  // namespace qmm
