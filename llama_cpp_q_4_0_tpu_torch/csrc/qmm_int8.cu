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
//    planes, 8 bits per weight, twice the packed formats', and then by issue
//    slots (about 6-7 thread instructions a level byte here, against a
//    budget of 9-10).  It runs the decode skeleton of qmm_common.cuh
//    (gemv_kernel: one launch, the K splits of a column tile reduced inside
//    a thread-block cluster, every load of a chunk in flight before any is
//    used and the next chunk's loads issued before this one is computed, x
//    broadcast from shared memory) with Int8Gemv below as its body: per 8-byte
//    row word 2 sign flips, 8 byte permutes, 8 FADD, 8 FMUL, 8 bf16
//    roundings (one cvt each) and 8 FFMA a batch row; the bias seed once a
//    chunk from the chunk's x sums.
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
// The skeleton's body for int8 levels (gemv_kernel, qmm_common.cuh): one
// panel, the scale row (and the bias row) of the chunk's group.
template <int GS_, bool BIAS>
struct Int8Gemv {
  static constexpr int PANELS = 1;
  static constexpr int GS = GS_;
  static constexpr int NPL = BIAS ? 2 : 1;
  static constexpr int CH1 = 16, CHN = 8, NBM = 8, BUFS1 = 2, BUFSN = 2, OCC1 = 1;

  template <int NB, int CH, int XL>
  __device__ static void stage(const float (&x)[XL], float* xs, float* xg) {
    stage_bf16<NB, PANELS, CH, XL>(x, xs, xg);
  }

  // rows of a chunk: acc[bb] += x[bb, r] * bf16(level[r] * d); then the seed
  template <int NB, int CH>
  __device__ static void rows(const uint2 (&w)[CH], const float (&pl)[NPL][GEMV_COLS],
                              const float* xs, const float* xg, float zero,
                              float (&acc)[NB][GEMV_COLS]) {
    constexpr int xb = CH;
    float4 x4;
#pragma unroll
    for (int r = 0; r < CH; ++r) {
      float wf[GEMV_COLS];
#pragma unroll
      for (int j = 0; j < GEMV_COLS; ++j)
        wf[j] = bf16_round1(sbyte_to_float(j < 4 ? w[r].x : w[r].y, j % 4) * pl[0][j]);
#pragma unroll
      for (int bb = 0; bb < NB; ++bb) {
        const float xv = x_at<NB>(xs, xb, r, bb, x4);
#pragma unroll
        for (int j = 0; j < GEMV_COLS; ++j) acc[bb][j] += xv * wf[j];
      }
    }
    seed<NB>(pl, xg, 1, 0, zero, acc);
  }

  // the seed of a chunk: acc[bb] += xg[bb] * bias (xg: the chunk's x sums)
  template <int NB>
  __device__ static void seed(const float (&pl)[NPL][GEMV_COLS], const float* xg, int gb, int,
                              float, float (&acc)[NB][GEMV_COLS]) {
    if constexpr (BIAS) {
#pragma unroll
      for (int bb = 0; bb < NB; ++bb) {
        const float g = xg[bb * gb];
#pragma unroll
        for (int j = 0; j < GEMV_COLS; ++j) acc[bb][j] += g * pl[1][j];
      }
    }
  }
};

// B <= 32: the decode skeleton in `splits` K splits (scratch and xa
// unused); above, the prefill tile (scratch: its partial sums when
// splits > 1)
template <int GS>
cudaError_t launch_int8(const float* x, const int8_t* levels, const void* scales,
                        const void* bias, float* scratch, void* xa, float* out, int B, int K,
                        int N, int bm, int splits, int ka, int scode, cudaStream_t st) {
  if (B <= 32) {
    const GemvArgs a{x, (const uint8_t*)levels, scales, bias, out, B, K, N, K / GEMV_STEP, 0,
                     scode, 0.0f};
    return bias ? gemv_launch<Int8Gemv<GS, true>>(a, splits, st)
                : gemv_launch<Int8Gemv<GS, false>>(a, splits, st);
  }
  return tile::launch<Int8Deq<GS>>(x, levels, K, scales, K / GS, bias, (__nv_bfloat16*)xa,
                                   scratch, out, B, K, N, 1, GS, 0, 0.0f, bm, splits, ka, scode,
                                   st);
}

}  // namespace

extern "C" {

// Clusters of `splits` blocks the decode GEMV runs at once (rows: 1, or 8
// a pass), for ops/qmm.py::gemv_plan; -1 on an error.
int qmm_int8_gemv_clusters(int splits, int rows) {
  return gemv_max_clusters<Int8Gemv<32, true>>(splits, rows);
}

// bias NULL: _qmm_kernel; else _qmm_bias_kernel.  At B <= 32 the decode
// GEMV in `splits` K splits (ops/qmm.py::gemv_plan; scratch, xa, bm and ka
// unused); above, the prefill tile with the seed fused: xa bf16 [B, ka],
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
