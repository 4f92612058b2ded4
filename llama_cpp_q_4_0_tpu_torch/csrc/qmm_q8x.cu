// q4_0 matmul with int8 activations for Hopper (sm_90a):
// out[B,N] = sum over 32-groups g of (float)(xq_g . level_g) * d_x[b,g] * d_w[g,n].
//
// Replaces llama_cpp_q_4_0_tpu/ops/pallas/qmm.py::qmm_packed_q8x
// (_qmm_packed_q8x_kernel, with its activation quantizer _quantize_q8x): the
// reference's quantize_row_q8_0 + ggml_vec_dot_q4_0_q8_0 arithmetic.
//
// Layout: packed uint8 [K2P, N] (low nibble row r, high nibble row r + K/2,
// each level + 8), scales f32 [2, K2P/32, N] (ops/qtensor.py).  Three passes,
// all launched by qmm_q8x:
//  1. q8x_quantize_kernel: xq int8 [B, K], d f32 [B, K/32] (logical groups: the
//     low panel's, then the high panel's).  One warp per group: amax by warp
//     shuffles, d = amax / 127, q = C roundf(x * (1/d)) with the product
//     rounded before the tie test (__fmul_rn, never fused), d rounded through
//     fp16: bit-identical to ops/qmm.py quantize_q8x_plain (IEEE division,
//     no fast math).
//  2. the matmul.  Each group's integer dot is exact in int32; it enters f32
//     as (float)dot * d_x * d_w, the order of the TPU kernel (qmm.py:323).
//     * B <= 32 (decode, buckets 8 and 32): a split-K GEMV in the manner of
//       K2, bound by the bytes of the packed weight.  A warp owns one packed
//       32-row step (one group of each panel), a lane 8 columns; every 4 rows
//       the lane's 4 x 8 bytes are transposed by byte permutes so that each
//       word holds 4 K-rows of one column, and __dp4a multiplies them with 4
//       activation bytes.  The pack zero is folded exactly in integers:
//       xq . (nib - 8) = xq . nib - 8 * sum(xq).
//     * B > 32 (prefill buckets 64, 128; 512 under a raised cap): a 64 x 64
//       output tile per block of 4 warps (32 x 32 each), int8 tensor-core
//       mma.sync m16n8k32 with int32 accumulators, one group per mma depth.
//       Per packed step the block stages the two 64 x 32 activation groups
//       and the 64-column weight tile, transposed into K-contiguous signed
//       levels (byte permutes, then nibble - 8), in shared memory; the known
//       fragment layout of mma.sync lets each thread scale its own int32
//       results by the right d_x and d_w.  No pipelining yet.
//  3. (B <= 32) gemv_reduce: the K splits summed in a fixed order.
#include "qmm_common.cuh"

#include <cuda_fp16.h>

using namespace qmm;

namespace {

constexpr int GS = 32;

// ------------------------------------------------------------- quantizer
__global__ void q8x_quantize_kernel(const float* __restrict__ x, int8_t* __restrict__ xq,
                                    float* __restrict__ d, int total) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;  // element; warp = group
  const int lane = threadIdx.x & 31;
  const float v = i < total ? x[i] : 0.0f;
  float amax = fabsf(v);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(FULL, amax, o));
  if (i >= total) return;
  const float dq = amax / 127.0f;
  const float idq = dq > 0.0f ? 1.0f / dq : 0.0f;
  const float s = __fmul_rn(v, idq);
  const float t = truncf(s);
  const float q = fabsf(__fsub_rn(s, t)) == 0.5f ? t + copysignf(1.0f, s) : rintf(s);
  xq[i] = (int8_t)(int)q;
  if (lane == 0) d[i / GS] = __half2float(__float2half_rn(dq));
}

// 4 rows of 4 bytes (one word per row, byte c = column c) -> 4 words, word c
// holding column c's 4 rows (byte r = row r)
__device__ __forceinline__ void transpose4(unsigned a, unsigned b, unsigned c, unsigned d,
                                           unsigned (&out)[4]) {
  const unsigned ab0 = __byte_perm(a, b, 0x5140), ab1 = __byte_perm(a, b, 0x7362);
  const unsigned cd0 = __byte_perm(c, d, 0x5140), cd1 = __byte_perm(c, d, 0x7362);
  out[0] = __byte_perm(ab0, cd0, 0x5410);
  out[1] = __byte_perm(ab0, cd0, 0x7632);
  out[2] = __byte_perm(ab1, cd1, 0x5410);
  out[3] = __byte_perm(ab1, cd1, 0x7632);
}

// ------------------------------------------------------------------ decode
template <int NB>
__global__ void __launch_bounds__(GEMV_WARPS * 32)
q8x_gemv_kernel(const int8_t* __restrict__ xq, const float* __restrict__ dx,
                const uint8_t* __restrict__ packed, const float* __restrict__ scales,
                float* __restrict__ partial, int B, int K, int N, int G2P) {
  __shared__ float red[GEMV_WARPS][GEMV_TILE_N];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int k2 = K / 2;
  const int G = K / GS;
  const int t = blockIdx.y * GEMV_WARPS + warp;  // packed 32-row step = group t
  const bool t_ok = t < k2 / GS;
  const int n = blockIdx.x * GEMV_TILE_N + lane * GEMV_COLS;
  const bool col_ok = n < N;

  float sl[GEMV_COLS], sh[GEMV_COLS];
#pragma unroll
  for (int c = 0; c < GEMV_COLS; ++c) sl[c] = sh[c] = 0.0f;
  if (t_ok && col_ok) {
    load8(scales + (size_t)t * N + n, sl);
    load8(scales + ((size_t)G2P + t) * N + n, sh);
  }

  for (int b0 = 0; b0 < B; b0 += NB) {
    float acc[NB][GEMV_COLS];
#pragma unroll
    for (int bb = 0; bb < NB; ++bb)
#pragma unroll
      for (int c = 0; c < GEMV_COLS; ++c) acc[bb][c] = 0.0f;

    if (t_ok) {
      int il[NB][GEMV_COLS], ih[NB][GEMV_COLS], xsl[NB], xsh[NB];
#pragma unroll
      for (int bb = 0; bb < NB; ++bb) {
        xsl[bb] = xsh[bb] = 0;
#pragma unroll
        for (int c = 0; c < GEMV_COLS; ++c) il[bb][c] = ih[bb][c] = 0;
      }
      const uint8_t* prow = packed + (size_t)t * GS * N + n;
#pragma unroll 2
      for (int r = 0; r < GS; r += 4) {
        uint2 w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          w[i] = make_uint2(0u, 0u);
          if (col_ok) w[i] = *reinterpret_cast<const uint2*>(prow + (size_t)(r + i) * N);
        }
        unsigned cw[GEMV_COLS];
        unsigned half[4];
        transpose4(w[0].x, w[1].x, w[2].x, w[3].x, half);
#pragma unroll
        for (int c = 0; c < 4; ++c) cw[c] = half[c];
        transpose4(w[0].y, w[1].y, w[2].y, w[3].y, half);
#pragma unroll
        for (int c = 0; c < 4; ++c) cw[4 + c] = half[c];
#pragma unroll
        for (int bb = 0; bb < NB; ++bb) {
          const int b = b0 + bb;
          int xl = 0, xh = 0;
          if (b < B) {
            xl = *reinterpret_cast<const int*>(xq + (size_t)b * K + t * GS + r);
            xh = *reinterpret_cast<const int*>(xq + (size_t)b * K + k2 + t * GS + r);
          }
          xsl[bb] = __dp4a(xl, 0x01010101, xsl[bb]);
          xsh[bb] = __dp4a(xh, 0x01010101, xsh[bb]);
#pragma unroll
          for (int c = 0; c < GEMV_COLS; ++c) {
            il[bb][c] = __dp4a(xl, (int)(cw[c] & 0x0F0F0F0Fu), il[bb][c]);
            ih[bb][c] = __dp4a(xh, (int)((cw[c] >> 4) & 0x0F0F0F0Fu), ih[bb][c]);
          }
        }
      }
#pragma unroll
      for (int bb = 0; bb < NB; ++bb) {
        const int b = b0 + bb;
        const float dl = b < B ? dx[(size_t)b * G + t] : 0.0f;
        const float dh = b < B ? dx[(size_t)b * G + k2 / GS + t] : 0.0f;
#pragma unroll
        for (int c = 0; c < GEMV_COLS; ++c) {
          acc[bb][c] += (float)(il[bb][c] - 8 * xsl[bb]) * dl * sl[c];
          acc[bb][c] += (float)(ih[bb][c] - 8 * xsh[bb]) * dh * sh[c];
        }
      }
    }
#pragma unroll
    for (int bb = 0; bb < NB; ++bb)
      gemv_block_partial(red, acc[bb], partial, b0 + bb, B, N);
  }
}

// ----------------------------------------------------------------- prefill
constexpr int QM = 64;          // rows (of x) per block
constexpr int QN = 64;          // output columns per block
constexpr int Q_THREADS = 128;  // 4 warps, 2 x 2, each 32 x 32
constexpr int QS = GS + 16;     // byte stride of a staged K-contiguous row

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(Q_THREADS)
q8x_tile_kernel(const int8_t* __restrict__ xq, const float* __restrict__ dx,
                const uint8_t* __restrict__ packed, const float* __restrict__ scales,
                float* __restrict__ out, int B, int K, int N, int G2P) {
  // panel p (0 low, 1 high): As[p][m][k] activations, Ws[p][n][k] levels,
  // both K-contiguous (the A row-major / B column-major operands of mma)
  __shared__ __align__(16) int8_t As[2][QM * QS];
  __shared__ __align__(16) int8_t Ws[2][QN * QS];
  __shared__ float dxs[2][QM];
  __shared__ float dws[2][QN];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int m0 = blockIdx.y * QM;
  const int n0 = blockIdx.x * QN;
  const int k2 = K / 2;
  const int G = K / GS;
  const int wm = (warp >> 1) * 32;
  const int wn = (warp & 1) * 32;
  const int gid = lane >> 2;  // mma groupID
  const int tig = lane & 3;   // mma threadID_in_group

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  const int rq = tid & 7;   // weight staging: row quad 0..7
  const int co = tid >> 3;  // and column quad 0..15
  const int n_steps = k2 / GS;
  for (int gi = 0; gi < n_steps; ++gi) {
    // activations: 64 rows x (32 low + 32 high) bytes, 2 x 16 bytes per thread
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int idx = tid + h * Q_THREADS;
      const int m = idx >> 2;
      const int part = idx & 3;  // 0, 1 low panel; 2, 3 high panel
      const int p = part >> 1;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + m < B)
        v = *reinterpret_cast<const uint4*>(xq + (size_t)(m0 + m) * K + p * k2 + gi * GS +
                                            (part & 1) * 16);
      *reinterpret_cast<uint4*>(&As[p][m * QS + (part & 1) * 16]) = v;
    }
    {  // 128 threads: the step's d_x of 64 rows and d_w of 64 columns, per panel
      const int p = tid / QM, m = tid % QM;
      dxs[p][m] = m0 + m < B ? dx[(size_t)(m0 + m) * G + p * (k2 / GS) + gi] : 0.0f;
      dws[p][m] = n0 + m < N ? scales[((size_t)p * G2P + gi) * N + n0 + m] : 0.0f;
    }
    {
      // weights: the step's 32 packed rows x 64 columns, one 4 x 4 byte
      // block per thread (rows 4*rq .. +4, columns 4*co .. +4)
      unsigned wrow[4];
      const int c0 = co * 4;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        wrow[i] = 0u;
        if (n0 + c0 < N)
          wrow[i] = *reinterpret_cast<const unsigned*>(
              packed + (size_t)(gi * GS + 4 * rq + i) * N + n0 + c0);
      }
      unsigned cols[4];
      transpose4(wrow[0], wrow[1], wrow[2], wrow[3], cols);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        // levels nib - 8 as signed bytes (per-byte wrap-around subtract)
        const unsigned lo = __vsub4(cols[c] & 0x0F0F0F0Fu, 0x08080808u);
        const unsigned hi = __vsub4((cols[c] >> 4) & 0x0F0F0F0Fu, 0x08080808u);
        *reinterpret_cast<unsigned*>(&Ws[0][(c0 + c) * QS + 4 * rq]) = lo;
        *reinterpret_cast<unsigned*>(&Ws[1][(c0 + c) * QS + 4 * rq]) = hi;
      }
    }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      unsigned a[2][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int8_t* ap = &As[p][(wm + 16 * i + gid) * QS + tig * 4];
        a[i][0] = *reinterpret_cast<const unsigned*>(ap);
        a[i][1] = *reinterpret_cast<const unsigned*>(ap + 8 * QS);
        a[i][2] = *reinterpret_cast<const unsigned*>(ap + 16);
        a[i][3] = *reinterpret_cast<const unsigned*>(ap + 8 * QS + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* bp = &Ws[p][(wn + 8 * j + gid) * QS + tig * 4];
        b[j][0] = *reinterpret_cast<const unsigned*>(bp);
        b[j][1] = *reinterpret_cast<const unsigned*>(bp + 16);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float dx0 = dxs[p][wm + 16 * i + gid];
        const float dx1 = dxs[p][wm + 16 * i + gid + 8];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          int c[4] = {0, 0, 0, 0};
          mma_s8(c, a[i], b[j]);
          const float dw0 = dws[p][wn + 8 * j + 2 * tig];
          const float dw1 = dws[p][wn + 8 * j + 2 * tig + 1];
          acc[i][j][0] += (float)c[0] * dx0 * dw0;
          acc[i][j][1] += (float)c[1] * dx0 * dw1;
          acc[i][j][2] += (float)c[2] * dx1 * dw0;
          acc[i][j][3] += (float)c[3] * dx1 * dw1;
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + wn + 8 * j + 2 * tig;
      if (col >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + 16 * i + gid + 8 * h;
        if (row < B)
          *reinterpret_cast<float2*>(out + (size_t)row * N + col) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
}

cudaError_t quantize(const float* x, int8_t* xq, float* d, int B, int K, cudaStream_t st) {
  const int total = B * K;  // K % 64 == 0: a warp never straddles two rows
  q8x_quantize_kernel<<<(total + 255) / 256, 256, 0, st>>>(x, xq, d, total);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Number of K splits of the decode form; partial holds [splits, B, N] floats.
int qmm_q8x_splits(int K) { return gemv_splits(K / 2 / GS); }

int q8x_quantize(const void* x, void* xq, void* d, int B, int K, void* stream) {
  return (int)quantize((const float*)x, (int8_t*)xq, (float*)d, B, K, (cudaStream_t)stream);
}

// xq: int8 [B, K] and d: f32 [B, K/32] scratch; partial: the decode form's
// [qmm_q8x_splits(K), B, N] f32 scratch (unused above 32 rows).
int qmm_q8x(const void* x, const void* packed, const void* scales, void* xq, void* d,
            void* partial, void* out, int B, int K, int N, int G2P, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  int8_t* q = (int8_t*)xq;
  float* dd = (float*)d;
  const uint8_t* pk = (const uint8_t*)packed;
  const float* sc = (const float*)scales;
  cudaError_t err = quantize((const float*)x, q, dd, B, K, st);
  if (err != cudaSuccess) return (int)err;
  if (B <= 32) {
    const int n_split = gemv_splits(K / 2 / GS);
    dim3 grid((N + GEMV_TILE_N - 1) / GEMV_TILE_N, n_split);
    if (B == 1)
      q8x_gemv_kernel<1><<<grid, GEMV_WARPS * 32, 0, st>>>(q, dd, pk, sc, (float*)partial,
                                                          B, K, N, G2P);
    else
      q8x_gemv_kernel<4><<<grid, GEMV_WARPS * 32, 0, st>>>(q, dd, pk, sc, (float*)partial,
                                                          B, K, N, G2P);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return (int)gemv_reduce((const float*)partial, (float*)out, n_split, B * N, st);
  }
  dim3 grid((N + QN - 1) / QN, (B + QM - 1) / QM);
  q8x_tile_kernel<<<grid, Q_THREADS, 0, st>>>(q, dd, pk, sc, (float*)out, B, K, N, G2P);
  return (int)cudaGetLastError();
}

}  // extern "C"
