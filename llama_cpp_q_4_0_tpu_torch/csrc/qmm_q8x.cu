// Packed 4-bit matmul with int8 activations for Hopper (sm_90a):
// out[B,N] = sum over GS-groups g of (float)(xq_g . level_g) * d_x[b,g] * d_w[g,n],
// level = nibble - zero, for any pack zero and GS = 32 (q4_0: zero 8) or 16
// (q3_K: zero 4 on real weights).
//
// Replaces llama_cpp_q_4_0_tpu/ops/pallas/qmm.py::qmm_packed_q8x
// (_qmm_packed_q8x_kernel, with its activation quantizer _quantize_q8x): the
// reference's quantize_row_q8_0 + ggml_vec_dot_q4_0_q8_0 arithmetic.
//
// Layout: packed uint8 [K2P, N] (low nibble row r, high nibble row r + K/2,
// each level + zero), scales [2, K2P/GS, N] of f32, f16 or bf16 (the scode
// argument: ScaleCode of qmm_common.cuh; both forms widen a value to f32 as
// they load it) (ops/qtensor.py).  Every
// group's integer dot is exact; the activation quantizer (q8_quantize below)
// is bit-identical to ops/qmm.py quantize_q8x_plain: GS lanes per group (a
// warp or a half-warp), amax by shuffles within them, d = amax / 127,
// q = C roundf(x * (1/d)) with the product rounded before the tie test
// (__fmul_rn, never fused), d rounded through fp16 (IEEE division, no fast
// math).  Two forms, both launched by qmm_q8x:
//  * B <= 32 (decode, buckets 8 and 32), three passes:
//    1. q8x_quantize_kernel: xq int8 [B, K], d f32 [B, K/GS] (logical groups:
//       the low panel's, then the high panel's).
//    2. a split-K GEMV, bound by the bytes of the packed weight (its own
//       body, not yet on the decode skeleton of qmm_common.cuh).  A warp owns one packed
//       32-row step (32 / GS groups of each panel, one after the other), a
//       lane 8 columns; every 4 rows the lane's 4 x 8 bytes are transposed by
//       byte permutes so that each word holds 4 K-rows of one column, and
//       __dp4a multiplies them with 4 activation bytes.  The pack zero is
//       folded exactly in integers, per group:
//       xq . (nib - zero) = xq . nib - zero * sum(xq).  Each dot enters f32 as
//       (float)dot * d_x * d_w, the order of the TPU kernel (qmm.py:323).
//    3. gemv_reduce: the K splits summed in a fixed order.
//  * B > 32 (prefill buckets 64, 128; 512 and 2048 under a raised cap): the
//    shared Hopper tile of qmm_tile.cuh in its q8 mode, with Q8Deq below as
//    its policy: the prep pass quantizes x into bf16 levels in the tile's
//    nibble order, bf16 wgmma gives each group dot exactly, and the consumers
//    add fma(dot, d_x * d_w, acc) (why bf16 and not int8 wgmma: the header of
//    qmm_tile.cuh).
#include "qmm_common.cuh"
#include "qmm_tile.cuh"

#include <cuda_fp16.h>

using namespace qmm;

namespace {

// ------------------------------------------------------------- quantizer
// v: this lane's value of its GS-group, GS consecutive lanes (every lane of
// the warp calls it) -> its level q (an integer in -127..127) and the
// group's d, unrounded
template <int GS>
__device__ __forceinline__ float q8_quantize(float v, float& dq) {
  float amax = fabsf(v);
#pragma unroll
  for (int o = GS / 2; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(FULL, amax, o));
  dq = amax / 127.0f;
  const float idq = dq > 0.0f ? 1.0f / dq : 0.0f;
  const float s = __fmul_rn(v, idq);
  const float t = truncf(s);
  return fabsf(__fsub_rn(s, t)) == 0.5f ? t + copysignf(1.0f, s) : rintf(s);
}

template <int GS>
__global__ void q8x_quantize_kernel(const float* __restrict__ x, int8_t* __restrict__ xq,
                                    float* __restrict__ d, int total) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;  // element; GS lanes = group
  float dq;
  const float q = q8_quantize<GS>(i < total ? x[i] : 0.0f, dq);
  if (i >= total) return;
  xq[i] = (int8_t)(int)q;
  if ((threadIdx.x & (GS - 1)) == 0) d[i / GS] = __half2float(__float2half_rn(dq));
}

// The tile's prep pass: element i of xa [B, K] in the nibble order (step v's
// 64 columns are x[32v .. 32v+32) then x[K/2 + 32v .. +32): GS consecutive
// lanes hold one whole group) -> bf16(q); d of the group -> dx[i / GS], so
// dx [B, K/GS] holds step v's 64 / GS groups from column (64 / GS) v on, the
// low panel's then the high panel's.
template <int GS>
__global__ void q8x_prep_kernel(const float* __restrict__ x, __nv_bfloat16* __restrict__ xa,
                                float* __restrict__ dx, int K, int total) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int m = i / K, o = i % K, v = o / 64, j = o % 64;
  const int src = j < 32 ? 32 * v + j : K / 2 + 32 * v + j - 32;
  float dq;
  const float q = q8_quantize<GS>(i < total ? x[(size_t)m * K + src] : 0.0f, dq);
  if (i >= total) return;
  xa[i] = __float2bfloat16_rn(q);
  if ((threadIdx.x & (GS - 1)) == 0) dx[i / GS] = __half2float(__float2half_rn(dq));
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
template <int NB, int GS>
__global__ void __launch_bounds__(GEMV_WARPS * 32)
q8x_gemv_kernel(const int8_t* __restrict__ xq, const float* __restrict__ dx,
                const uint8_t* __restrict__ packed, const void* __restrict__ scales,
                float* __restrict__ partial, int B, int K, int N, int G2P, int zero,
                int scode) {
  constexpr int NG = 32 / GS;  // groups of each panel a 32-row step holds
  __shared__ float red[GEMV_WARPS][GEMV_TILE_N];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int k2 = K / 2;
  const int G = K / GS;
  const int t = blockIdx.y * GEMV_WARPS + warp;  // packed 32-row step
  const bool t_ok = t < k2 / 32;
  const int n = blockIdx.x * GEMV_TILE_N + lane * GEMV_COLS;
  const bool col_ok = n < N;

  float sl[NG][GEMV_COLS], sh[NG][GEMV_COLS];
#pragma unroll
  for (int h = 0; h < NG; ++h)
#pragma unroll
    for (int c = 0; c < GEMV_COLS; ++c) sl[h][c] = sh[h][c] = 0.0f;
  if (t_ok && col_ok) {
#pragma unroll
    for (int h = 0; h < NG; ++h) {
      load8s(scales, (size_t)(t * NG + h) * N + n, scode, sl[h]);
      load8s(scales, ((size_t)G2P + t * NG + h) * N + n, scode, sh[h]);
    }
  }

  for (int b0 = 0; b0 < B; b0 += NB) {
    float acc[NB][GEMV_COLS];
#pragma unroll
    for (int bb = 0; bb < NB; ++bb)
#pragma unroll
      for (int c = 0; c < GEMV_COLS; ++c) acc[bb][c] = 0.0f;

#pragma unroll
    for (int h = 0; h < NG; ++h) {
      if (!t_ok) break;  // warp-uniform
      const int g = t * NG + h;  // the low panel's group (the high one: k2 / GS + g)
      int il[NB][GEMV_COLS], ih[NB][GEMV_COLS], xsl[NB], xsh[NB];
#pragma unroll
      for (int bb = 0; bb < NB; ++bb) {
        xsl[bb] = xsh[bb] = 0;
#pragma unroll
        for (int c = 0; c < GEMV_COLS; ++c) il[bb][c] = ih[bb][c] = 0;
      }
      const uint8_t* prow = packed + (size_t)g * GS * N + n;
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
            xl = *reinterpret_cast<const int*>(xq + (size_t)b * K + g * GS + r);
            xh = *reinterpret_cast<const int*>(xq + (size_t)b * K + k2 + g * GS + r);
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
        const float dl = b < B ? dx[(size_t)b * G + g] : 0.0f;
        const float dh = b < B ? dx[(size_t)b * G + k2 / GS + g] : 0.0f;
#pragma unroll
        for (int c = 0; c < GEMV_COLS; ++c) {
          acc[bb][c] += (float)(il[bb][c] - zero * xsl[bb]) * dl * sl[h][c];
          acc[bb][c] += (float)(ih[bb][c] - zero * xsh[bb]) * dh * sh[h][c];
        }
      }
    }
#pragma unroll
    for (int bb = 0; bb < NB; ++bb)
      gemv_block_partial(red, acc[bb], partial, b0 + bb, B, N);
  }
}

// ----------------------------------------------------------------- prefill
// The tile's q8 policy (qmm_tile.cuh): a step is 32 packed rows, the low
// nibbles giving B rows 0..31 (the step's low groups) and the high nibbles
// rows 32..63 (its high groups), each as bf16(nib - zero), exact; the step's
// QG d_w rows (S_ROWS of each plane, in the tile's group order) are widened
// to f32 (from any of the plane dtypes) beside the B tile for the consumers.
template <int GS>
struct Q8Deq {
  static constexpr bool Q8 = true;
  static constexpr int QG = 64 / GS;
  static constexpr int W_ROWS = 32;
  static constexpr int S_ROWS = 32 / GS;
  static constexpr uint32_t main_bytes(int es) { return 32 * tile::TN + QG * tile::TN * es; }

  // s: the scales as a 3-D map [2, G2P, N], one box for both planes' rows
  __device__ static void load(uint32_t raw, const CUtensorMap* w, const CUtensorMap* s, int v,
                              int n0, uint32_t bar) {
    tile::tma_load(raw, w, n0, 32 * v, bar);
    tile::tma_load3(raw + tile::SCALE_OFF, s, n0, S_ROWS * v, 0, bar);
  }

  // thread t: columns c .. c+8 of packed rows r0 + 8p; a nibble becomes
  // nib - zero as the low mantissa bits of 2^23, minus 2^23 + zero
  template <int SC>
  __device__ static void dequant(const uint8_t* __restrict__ raw, uint8_t* __restrict__ bs,
                                 int t, float zero) {
    const float off = 8388608.0f + zero;
    const int c = (t & 15) * 8, r0 = t >> 4;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int r = r0 + 8 * p;
      const uint2 pk = *reinterpret_cast<const uint2*>(raw + r * tile::TN + c);
      const unsigned w[4] = {pk.x & 0x0F0F0F0Fu, pk.y & 0x0F0F0F0Fu,
                             (pk.x >> 4) & 0x0F0F0F0Fu, (pk.y >> 4) & 0x0F0F0F0Fu};
      float f[16];
#pragma unroll
      for (int e = 0; e < 16; ++e)
        f[e] = __int_as_float(__byte_perm(w[e / 4], 0x4B000000u, 0x7540 + e % 4)) - off;
      *reinterpret_cast<uint4*>(bs + tile::b_off(r, c)) =
          make_uint4(tile::pack_bf16(f[0], f[1]), tile::pack_bf16(f[2], f[3]),
                     tile::pack_bf16(f[4], f[5]), tile::pack_bf16(f[6], f[7]));
      *reinterpret_cast<uint4*>(bs + tile::b_off(32 + r, c)) =
          make_uint4(tile::pack_bf16(f[8], f[9]), tile::pack_bf16(f[10], f[11]),
                     tile::pack_bf16(f[12], f[13]), tile::pack_bf16(f[14], f[15]));
    }
    if constexpr (SC == SCALE_F32) {  // copied as they are, 4 d_w a thread
      if (t < QG * tile::TN / 4)
        reinterpret_cast<float4*>(bs + tile::B_BYTES)[t] =
            reinterpret_cast<const float4*>(raw + tile::SCALE_OFF)[t];
    } else if (t < QG * tile::TN / 8) {  // widened, 8 d_w a thread
      float d[8];
      load8s<SC>(raw + tile::SCALE_OFF, 8 * t, d);
      float4* dst = reinterpret_cast<float4*>(bs + tile::B_BYTES) + 2 * t;
      dst[0] = make_float4(d[0], d[1], d[2], d[3]);
      dst[1] = make_float4(d[4], d[5], d[6], d[7]);
    }
  }

  static cudaError_t prep(const float* x, __nv_bfloat16* xa, float* dx, int B, int K,
                          cudaStream_t st) {
    const int total = B * K;
    q8x_prep_kernel<GS><<<(total + 255) / 256, 256, 0, st>>>(x, xa, dx, K, total);
    return cudaGetLastError();
  }
};

template <int GS>
cudaError_t quantize(const float* x, int8_t* xq, float* d, int B, int K, cudaStream_t st) {
  const int total = B * K;  // K % 64 == 0: a group never straddles two rows
  q8x_quantize_kernel<GS><<<(total + 255) / 256, 256, 0, st>>>(x, xq, d, total);
  return cudaGetLastError();
}

// both forms at one group size (see qmm_q8x below)
template <int GS>
cudaError_t launch(const float* x, const uint8_t* pk, const void* sc, int8_t* q, float* dd,
                   float* partial, void* xa, float* out, int B, int K, int N, int G2P, int zero,
                   int bm, int splits, int ka, int scode, cudaStream_t st) {
  if (B > 32)
    return tile::launch<Q8Deq<GS>>(x, pk, G2P * GS, sc, 2 * G2P, nullptr, (__nv_bfloat16*)xa,
                                    partial, out, B, K, N, 2, GS, G2P, (float)zero, bm, splits,
                                    ka, scode, st, dd);
  if (scode < SCALE_F32 || scode > SCALE_BF16) return cudaErrorInvalidValue;
  cudaError_t err = quantize<GS>(x, q, dd, B, K, st);
  if (err != cudaSuccess) return err;
  const int n_split = gemv_splits(K / 2 / 32);
  dim3 grid((N + GEMV_TILE_N - 1) / GEMV_TILE_N, n_split);
  if (B == 1)
    q8x_gemv_kernel<1, GS><<<grid, GEMV_WARPS * 32, 0, st>>>(q, dd, pk, sc, partial, B, K, N,
                                                            G2P, zero, scode);
  else
    q8x_gemv_kernel<4, GS><<<grid, GEMV_WARPS * 32, 0, st>>>(q, dd, pk, sc, partial, B, K, N,
                                                            G2P, zero, scode);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return gemv_reduce(partial, out, n_split, B * N, st);
}

}  // namespace

extern "C" {

// Number of K splits of the decode form; partial holds [splits, B, N] floats.
int qmm_q8x_splits(int K) { return gemv_splits(K / 2 / 32); }

// Dynamic shared memory of the q8 tile at bm rows per unit and gsize-groups
// (bytes).
int qmm_q8x_tile_smem(int bm, int gsize) {
  if (gsize == 16)
    return bm == 64 ? tile::Shape<64, true, 4>::SMEM
                    : bm == 128 ? tile::Shape<128, true, 4>::SMEM : 0;
  return bm == 64 ? tile::Shape<64, true>::SMEM : bm == 128 ? tile::Shape<128, true>::SMEM : 0;
}

int q8x_quantize(const void* x, void* xq, void* d, int B, int K, int gsize, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (gsize == 32)
    return (int)quantize<32>((const float*)x, (int8_t*)xq, (float*)d, B, K, st);
  if (gsize == 16)
    return (int)quantize<16>((const float*)x, (int8_t*)xq, (float*)d, B, K, st);
  return (int)cudaErrorInvalidValue;
}

// d: f32 [B, K/gsize] scratch.  At 32 rows or fewer xq is int8 [B, K]
// scratch and partial [qmm_q8x_splits(K), B, N] f32 (xa unused); above, the
// tile: xa bf16 [B, ka] scratch, partial f32 [splits, B, N] when splits > 1,
// and bm, splits, ka from ops/qmm.py::tile_plan (xq unused).  scode: the
// scales' dtype (ScaleCode).
int qmm_q8x(const void* x, const void* packed, const void* scales, void* xq, void* d,
            void* partial, void* xa, void* out, int B, int K, int N, int G2P, int zero,
            int gsize, int bm, int splits, int ka, int scode, void* stream) {
  const float* xf = (const float*)x;
  const uint8_t* pk = (const uint8_t*)packed;
  int8_t* q = (int8_t*)xq;
  float* dd = (float*)d;
  float* part = (float*)partial;
  float* o = (float*)out;
  const cudaStream_t st = (cudaStream_t)stream;
  if (gsize == 32)
    return (int)launch<32>(xf, pk, scales, q, dd, part, xa, o, B, K, N, G2P, zero, bm, splits, ka,
                           scode, st);
  if (gsize == 16)
    return (int)launch<16>(xf, pk, scales, q, dd, part, xa, o, B, K, N, G2P, zero, bm, splits, ka,
                           scode, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
