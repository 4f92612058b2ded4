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
//    token, and then by issue slots: two weights a byte leave about 5
//    thread instructions a weight of a 9-10 a byte budget.  It runs the
//    decode skeleton of qmm_common.cuh (gemv_kernel: one launch, the K
//    splits of a column tile reduced inside a thread-block cluster, every
//    load of a chunk in flight before any is used and the next chunk's loads
//    issued before this one is computed, x of both panels broadcast from
//    shared memory) with PackedGemv below as its body.  Per 8-byte row
//    word: 3 masks and shifts, 16 byte permutes, 16 FADD that both end the
//    mantissa trick and subtract the zero (off = 2^23 + zero), 16 FMUL, 16
//    bf16 roundings (one cvt each) and 16 FFMA a batch row.  kfold folds the
//    zero point as the TPU kernel does (weights bf16(nib * d), plus
//    -zero * (xg_lo * d_lo + xg_hi * d_hi)); the affine form dequantizes
//    bf16((nib - zero) * d) and adds xg_lo * b_lo + xg_hi * b_hi; both once a
//    chunk, xg the chunk's x sums.
//  * Nibbles become floats by a byte permute into the mantissa of 2^23
//    (byte_minus) instead of the int-to-float unit, which issues at a
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
        f[e] = byte_minus(w[e / 4], e % 4, off) * (e < 8 ? sl[g][e] : sh[g][e - 8]);
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
// The skeleton's body for the packed layout (gemv_kernel, qmm_common.cuh):
// two panels, a packed row r giving K row r (low nibbles) and K/2 + r (high
// nibbles); the chunk's planes are the two scale rows of its group and, for
// the affine form, the two bias rows.  FOLD: the kfold form (bf16(nib * d),
// seed -zero * xg . d); else the affine form (bf16((nib - zero) * d), seed
// xg . bias).
template <int GS_, bool FOLD>
struct PackedGemv {
  static constexpr int PANELS = 2;
  static constexpr int GS = GS_;
  static constexpr int NPL = FOLD ? 2 : 4;
  static constexpr int CH1 = 16, CHN = 8, NBM = 8, BUFS1 = 2, BUFSN = 2, OCC1 = 1;

  template <int NB, int CH, int XL>
  __device__ static void stage(const float (&x)[XL], float* xs, float* xg) {
    stage_bf16<NB, PANELS, CH, XL>(x, xs, xg);
  }

  // the chunk's rows, then its seed from the chunk's x sums
  template <int NB, int CH>
  __device__ static void rows(const uint2 (&w)[CH], const float (&pl)[NPL][GEMV_COLS],
                              const float* xs, const float* xg, float zero,
                              float (&acc)[NB][GEMV_COLS]) {
    constexpr int xb = PANELS * CH, xp = CH;
    const float off = 8388608.0f + (FOLD ? 0.0f : zero);
    float4 xl4, xh4;
#pragma unroll
    for (int r = 0; r < CH; ++r) {
      float wl[GEMV_COLS], wh[GEMV_COLS];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const unsigned wd = q ? w[r].y : w[r].x;
        const unsigned lo = wd & 0x0F0F0F0Fu, hi = (wd >> 4) & 0x0F0F0F0Fu;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = 4 * q + j;
          wl[c] = bf16_round1(byte_minus(lo, j, off) * pl[0][c]);
          wh[c] = bf16_round1(byte_minus(hi, j, off) * pl[1][c]);
        }
      }
#pragma unroll
      for (int bb = 0; bb < NB; ++bb) {
        const float xl = x_at<NB>(xs, xb, r, bb, xl4);
        const float xh = x_at<NB>(xs + xp, xb, r, bb, xh4);
#pragma unroll
        for (int c = 0; c < GEMV_COLS; ++c) {
          acc[bb][c] += xl * wl[c];
          acc[bb][c] += xh * wh[c];
        }
      }
    }
    seed<NB>(pl, xg, PANELS, 1, zero, acc);
  }

  template <int NB>
  __device__ static void seed(const float (&pl)[NPL][GEMV_COLS], const float* xg, int gb, int gp,
                              float zero, float (&acc)[NB][GEMV_COLS]) {
#pragma unroll
    for (int bb = 0; bb < NB; ++bb) {
      const float gl = xg[bb * gb], gh = xg[bb * gb + gp];
#pragma unroll
      for (int c = 0; c < GEMV_COLS; ++c) {
        if (FOLD)
          acc[bb][c] += -zero * (gl * pl[0][c] + gh * pl[1][c]);
        else
          acc[bb][c] += gl * pl[2][c] + gh * pl[3][c];
      }
    }
  }
};

template <int GS, bool FOLD>
cudaError_t launch_gemv(const float* x, const uint8_t* packed, const void* scales,
                        const void* bias, float* out, int B, int K, int N, int G2P, float zero,
                        int splits, int scode, cudaStream_t st) {
  const GemvArgs a{x, packed, scales, bias, out, B, K, N, K / 2 / GEMV_STEP, G2P, scode, zero};
  return gemv_launch<PackedGemv<GS, FOLD>>(a, splits, st);
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

// Clusters of `splits` blocks the decode GEMV runs at once (rows: 1, or 8
// a pass), for ops/qmm.py::gemv_plan; -1 on an error.
int qmm_packed_gemv_clusters(int splits, int rows) {
  return gemv_max_clusters<PackedGemv<32, false>>(splits, rows);
}

// The decode form of K2 (1 <= B <= 32) in `splits` K splits
// (ops/qmm.py::gemv_plan).
int qmm_q4_0_kfold(const void* x, const void* packed, const void* scales, void* out, int B,
                   int K, int N, int G2P, int zero, int gsize, int splits, int scode,
                   void* stream) {
  const float* xf = (const float*)x;
  const uint8_t* pk = (const uint8_t*)packed;
  const cudaStream_t st = (cudaStream_t)stream;
  if (gsize == 32)
    return (int)launch_gemv<32, true>(xf, pk, scales, nullptr, (float*)out, B, K, N, G2P,
                                      (float)zero, splits, scode, st);
  if (gsize == 16)
    return (int)launch_gemv<16, true>(xf, pk, scales, nullptr, (float*)out, B, K, N, G2P,
                                      (float)zero, splits, scode, st);
  return (int)cudaErrorInvalidValue;
}

// The affine form: the decode GEMV at B <= 32 in `splits` K splits
// (ops/qmm.py::gemv_plan; scratch, xa, bm and ka unused), else the prefill
// tile with the seed fused (scratch: its partial sums when splits > 1; xa,
// bm, splits, ka as for qmm_q4_0).  scales and bias share the dtype scode.
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
  if (B <= 32)
    return (int)(gsize == 32
        ? launch_gemv<32, false>(xf, pk, scales, bias, o, B, K, N, G2P, z, splits, scode, st)
        : launch_gemv<16, false>(xf, pk, scales, bias, o, B, K, N, G2P, z, splits, scode, st));
  return (int)(gsize == 32
      ? launch_tile<32, false>(xf, pk, scales, bias, xa, part, o, B, K, N, G2P, z, bm, splits,
                               ka, scode, st)
      : launch_tile<16, false>(xf, pk, scales, bias, xa, part, o, B, K, N, G2P, z, bm, splits,
                               ka, scode, st));
}

}  // extern "C"
