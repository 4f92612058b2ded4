// Packed 4-bit dequantize-matmul for Hopper (sm_90a): out[B,N] = x[B,K] @ dequant(W).
//
// Replaces the TPU kernels of llama_cpp_q_4_0_tpu/ops/pallas/qmm.py:
//   qmm_q4_0         <- qmm_packed -> _qmm_packed_kernel        (prefill, > 32 rows)
//   qmm_q4_0_kfold   <- qmm_packed(kfold=True)
//                       -> _qmm_packed_kfold_kernel              (decode, <= 32 rows)
//                       (both for any pack zero and 16- or 32-groups: q4_0 runs
//                       compile-time (8, 32) instances, q3_K (zero 4, 16-groups)
//                       the runtime-zero ones that K5 shares)
//   qmm_packed_bias  <- qmm_packed(gbias_t) -> _qmm_packed_bias_kernel
//                       (packed affine formats q4_K, q4_1, q2_K; every row count)
//
// Layout (ops/qtensor.py of the port): packed uint8 [K2P, N], byte [r, n] holds
// row r of W^T in its low nibble and row r + K/2 in its high nibble, each a
// level plus the pack zero; scales (and the affine bias) [2, K2P/GS, N] of
// f32, f16 or bf16 (the scode argument: ScaleCode of qmm_common.cuh, one
// dtype for both), plane 0 for the low panel and plane 1 for the high panel,
// GS = 32 or 16.  Every form widens a plane value to f32 as it loads it.
// Rows K/2..K2P are padding: the kernels loop over the real K/2 rows only.
// Callers guarantee K % 64 == 0, N % 16 == 0, 16-byte aligned contiguous
// tensors (ops/qmm.py checks).
//
// What bounds each form on an H100, and what the design does about it:
//  * The prefill form (qmm_q4_0; qmm_packed_bias above 32 rows) is bound by
//    tensor-core operations: it runs the shared Hopper tile of qmm_tile.cuh
//    (TMA rings, dequantizing warpgroups, wgmma consumers, a persistent loop
//    over M, N and K splits).  PackedDeq below is its layout policy: each
//    32-row packed step gives 64 logical K rows, the low nibbles then the
//    high nibbles, rounded exactly as the TPU kernel rounds
//    (bf16((nib - zero) * d)); prep_kernel puts x's two panels in the same
//    order.  The affine bias is the TPU kernel's full-K seed xg_lo.gbias_lo
//    + xg_hi.gbias_hi (xg the f32 group sums of x), run as extra K steps of
//    the same tensor-core mainloop on bf16 hi/lo parts of xg and gbias.
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
#include "qmm_tile.cuh"

using namespace qmm;

namespace {

// ----------------------------------------------------------------- prefill
// The tile's policy for the packed layout (qmm_tile.cuh): a step is 32
// packed rows, whose low nibbles give B rows 0..31 and high nibbles B rows
// 32..63 (x is permuted to match by prep_kernel), with S_ROWS scale rows of
// each plane (two copies a step).  Q4_0 (K1 on q4_0): the pack zero 8 at compile time; else
// (K5, and K1 on other packings such as q3_K) the runtime zero.
template <int GS, bool Q4_0>
struct PackedDeq {
  static constexpr bool Q8 = false;
  static constexpr int PERM = 1;
  static constexpr int W_ROWS = 32;
  static constexpr int S_ROWS = 32 / GS;
  static constexpr uint32_t main_bytes(int es) { return 32 * tile::TN + 2 * S_ROWS * tile::TN * es; }

  // s: the scales as a 3-D map [2, G2P, N], one box for both planes' rows
  __device__ static void load(uint32_t raw, const CUtensorMap* w, const CUtensorMap* s, int v,
                              int n0, uint32_t bar) {
    tile::tma_load(raw, w, n0, 32 * v, bar);
    tile::tma_load3(raw + tile::SCALE_OFF, s, n0, S_ROWS * v, 0, bar);
  }

  // thread t: columns c .. c+8, packed rows r0 + 8p; a nibble becomes
  // (nibble - zero) exactly as the low mantissa bits of 2^23 minus 2^23 + zero
  template <int SC>
  __device__ static void dequant(const uint8_t* __restrict__ raw, uint8_t* __restrict__ bs,
                                 int t, float zero_arg) {
    const float off = 8388608.0f + (Q4_0 ? 8.0f : zero_arg);
    const int c = (t & 15) * 8, r0 = t >> 4;
    const uint8_t* sc = raw + tile::SCALE_OFF;
    float sl[S_ROWS][8], sh[S_ROWS][8];
#pragma unroll
    for (int g = 0; g < S_ROWS; ++g) {
      load8s<SC>(sc, g * tile::TN + c, sl[g]);
      load8s<SC>(sc, (S_ROWS + g) * tile::TN + c, sh[g]);
    }
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int r = r0 + 8 * p, g = 8 * p / GS;
      const uint2 pk = *reinterpret_cast<const uint2*>(raw + r * tile::TN + c);
      const unsigned w[4] = {pk.x & 0x0F0F0F0Fu, pk.y & 0x0F0F0F0Fu,
                             (pk.x >> 4) & 0x0F0F0F0Fu, (pk.y >> 4) & 0x0F0F0F0Fu};
      float f[16];
#pragma unroll
      for (int e = 0; e < 16; ++e)
        f[e] = (__int_as_float(__byte_perm(w[e / 4], 0x4B000000u, 0x7540 + e % 4)) - off) *
               (e < 8 ? sl[g][e] : sh[g][e - 8]);
      *reinterpret_cast<uint4*>(bs + tile::b_off(r, c)) =
          make_uint4(tile::pack_bf16(f[0], f[1]), tile::pack_bf16(f[2], f[3]),
                     tile::pack_bf16(f[4], f[5]), tile::pack_bf16(f[6], f[7]));
      *reinterpret_cast<uint4*>(bs + tile::b_off(32 + r, c)) =
          make_uint4(tile::pack_bf16(f[8], f[9]), tile::pack_bf16(f[10], f[11]),
                     tile::pack_bf16(f[12], f[13]), tile::pack_bf16(f[14], f[15]));
    }
  }
};

// ------------------------------------------------------------------ decode
// FOLD: the kfold form (bf16(nib * d), seed -zero * xg.d); else the affine
// form (bf16((nib - zero) * d), seed xg.bias).
template <int NB, int GS, bool FOLD>
__global__ void __launch_bounds__(GEMV_WARPS * 32)
qmm_packed_gemv_kernel(const float* __restrict__ x, const uint8_t* __restrict__ packed,
                       const void* __restrict__ scales, const void* __restrict__ bias,
                       float* __restrict__ partial, int B, int K, int N, int G2P,
                       float zero, int scode) {
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
      load8s(scales, (size_t)g * N + n, scode, sl[h]);
      load8s(scales, ((size_t)G2P + g) * N + n, scode, sh[h]);
      if (!FOLD) {
        load8s(bias, (size_t)g * N + n, scode, bl[h]);
        load8s(bias, ((size_t)G2P + g) * N + n, scode, bh[h]);
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
cudaError_t launch_gemv(const float* x, const uint8_t* packed, const void* scales,
                        const void* bias, float* partial, float* out, int B, int K,
                        int N, int G2P, float zero, int scode, cudaStream_t st) {
  const int n_split = gemv_splits(K / 2 / 32);
  dim3 grid((N + GEMV_TILE_N - 1) / GEMV_TILE_N, n_split);
  // one row (a decode step), or rows in passes of 8 (the bucket-8 and -32
  // prefill calls and the output head of a batch)
  if (B == 1)
    qmm_packed_gemv_kernel<1, GS, FOLD><<<grid, GEMV_WARPS * 32, 0, st>>>(
        x, packed, scales, bias, partial, B, K, N, G2P, zero, scode);
  else
    qmm_packed_gemv_kernel<8, GS, FOLD><<<grid, GEMV_WARPS * 32, 0, st>>>(
        x, packed, scales, bias, partial, B, K, N, G2P, zero, scode);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return gemv_reduce(partial, out, n_split, B * N, st);
}

// packed [K2P = G2P * GS, N], scales and bias [2 * G2P, N]
template <int GS, bool Q4_0>
cudaError_t launch_tile(const float* x, const uint8_t* packed, const void* scales,
                        const void* bias, void* xa, float* partial, float* out, int B, int K,
                        int N, int G2P, float zero, int bm, int splits, int ka, int scode,
                        cudaStream_t st) {
  return tile::launch<PackedDeq<GS, Q4_0>>(x, packed, G2P * GS, scales, 2 * G2P, bias,
                                           (__nv_bfloat16*)xa, partial, out, B, K, N, 2, GS,
                                           G2P, zero, bm, splits, ka, scode, st);
}

}  // namespace

extern "C" {

// Number of K splits (blocks along K) of the decode form; the caller
// allocates partial sums of [splits, B, N] f32.
int qmm_packed_splits(int K) { return gemv_splits(K / 2 / 32); }

// Dynamic shared memory of the prefill tile at bm rows per unit (bytes), for
// reports: ptxas sees only static shared memory.
int qmm_tile_smem(int bm) {
  return bm == 64 ? tile::Shape<64>::SMEM : bm == 128 ? tile::Shape<128>::SMEM
                                          : bm == 256 ? tile::Shape<256>::SMEM : 0;
}

// The prefill tile (B > 32): xa is bf16 scratch [B, ka], partial f32
// [splits, B, N] when splits > 1; bm, splits and ka from ops/qmm.py::tile_plan.
// q4_0's (zero 8, 32-groups) takes the compile-time instance; any other zero
// and group size the runtime-zero tile with no seed.  scode: the scale
// planes' dtype (ScaleCode), in every entry point below.
int qmm_q4_0(const void* x, const void* packed, const void* scales, void* xa, void* partial,
             void* out, int B, int K, int N, int G2P, int zero, int gsize, int bm, int splits,
             int ka, int scode, void* stream) {
  const float* xf = (const float*)x;
  const uint8_t* pk = (const uint8_t*)packed;
  float* part = (float*)partial;
  float* o = (float*)out;
  const cudaStream_t st = (cudaStream_t)stream;
  const float z = (float)zero;
  if (zero == 8 && gsize == 32)
    return (int)launch_tile<32, true>(xf, pk, scales, nullptr, xa, part, o, B, K, N, G2P, 8.0f,
                                      bm, splits, ka, scode, st);
  if (gsize == 32)
    return (int)launch_tile<32, false>(xf, pk, scales, nullptr, xa, part, o, B, K, N, G2P, z,
                                       bm, splits, ka, scode, st);
  if (gsize == 16)
    return (int)launch_tile<16, false>(xf, pk, scales, nullptr, xa, part, o, B, K, N, G2P, z,
                                       bm, splits, ka, scode, st);
  return (int)cudaErrorInvalidValue;
}

int qmm_q4_0_kfold(const void* x, const void* packed, const void* scales,
                   void* partial, void* out, int B, int K, int N, int G2P, int zero,
                   int gsize, int scode, void* stream) {
  const float* xf = (const float*)x;
  const uint8_t* pk = (const uint8_t*)packed;
  const cudaStream_t st = (cudaStream_t)stream;
  if (scode < SCALE_F32 || scode > SCALE_BF16) return (int)cudaErrorInvalidValue;
  if (gsize == 32)
    return (int)launch_gemv<32, true>(xf, pk, scales, nullptr, (float*)partial, (float*)out, B,
                                      K, N, G2P, (float)zero, scode, st);
  if (gsize == 16)
    return (int)launch_gemv<16, true>(xf, pk, scales, nullptr, (float*)partial, (float*)out, B,
                                      K, N, G2P, (float)zero, scode, st);
  return (int)cudaErrorInvalidValue;
}

// The affine form: the decode shape at B <= 32 (scratch holds the K splits'
// partial sums, qmm_packed_splits(K) x B x N floats, xa unused), else the
// prefill tile with the seed fused (scratch: its partial sums when
// splits > 1; xa, bm, splits, ka as for qmm_q4_0).  scales and bias share
// the dtype scode.
int qmm_packed_bias(const void* x, const void* packed, const void* scales,
                    const void* bias, void* scratch, void* xa, void* out, int B, int K,
                    int N, int G2P, int zero, int gsize, int bm, int splits, int ka,
                    int scode, void* stream) {
  const float* xf = (const float*)x;
  const uint8_t* pk = (const uint8_t*)packed;
  float* o = (float*)out;
  float* part = (float*)scratch;
  const cudaStream_t st = (cudaStream_t)stream;
  const float z = (float)zero;
  if (gsize != 16 && gsize != 32) return (int)cudaErrorInvalidValue;
  if (B <= 32) {
    if (scode < SCALE_F32 || scode > SCALE_BF16) return (int)cudaErrorInvalidValue;
    return (int)(gsize == 32
        ? launch_gemv<32, false>(xf, pk, scales, bias, part, o, B, K, N, G2P, z, scode, st)
        : launch_gemv<16, false>(xf, pk, scales, bias, part, o, B, K, N, G2P, z, scode, st));
  }
  return (int)(gsize == 32
      ? launch_tile<32, false>(xf, pk, scales, bias, xa, part, o, B, K, N, G2P, z, bm, splits,
                               ka, scode, st)
      : launch_tile<16, false>(xf, pk, scales, bias, xa, part, o, B, K, N, G2P, z, bm, splits,
                               ka, scode, st));
}

}  // extern "C"
