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
//  * B <= 32 (decode, buckets 8 and 32): one launch of the decode skeleton of
//    qmm_common.cuh (gemv_kernel: the K splits of a column tile reduced
//    inside a thread-block cluster, every load of a chunk in flight before
//    any is used, the next chunk's loads issued before this one is
//    computed) with Q8Gemv below as its body.  It is bound by the bytes of
//    the packed weight and its scale planes; its body is cheap (byte
//    permutes, masks and __dp4a: the whole one-row kernel is at most 6.4 SASS
//    instructions a packed byte), so what it needs is bytes in flight and no
//    extra passes.  A chunk is one
//    group: each warp quantizes the chunk's x itself (no quantizer pass, no
//    x levels in global memory), and each group's integer dot enters f32
//    once, as the TPU kernel's does.  The quantizer pass q8x_quantize_kernel
//    stays as an entry of its own (q8x_quantize) that the card checks bit for
//    bit against the plain quantizer.
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
// a's 4 signed bytes times b's 4 unsigned bytes, plus c
__device__ __forceinline__ int dp4a_su(int a, unsigned b, int c) {
  int d;
  asm("dp4a.s32.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// The decode skeleton's body for K7 (gemv_kernel, qmm_common.cuh): two
// panels, a packed row r giving K row r (low nibbles) and K/2 + r (high
// nibbles); a chunk is one GS-row group, its planes the group's two scale
// rows.
//  * stage: each GS-lane segment of the warp's x values is one group of one
//    panel of one x row; q8_quantize gives its levels (the quantizer pass's
//    own device function, so they equal quantize_q8x_plain bit for bit),
//    stored as int8 in the warp's slot with the low and high panels' words
//    of each 4 rows side by side (byte (bb, p, r) at 2 CH bb + 8 (r / 4) +
//    4 p + r % 4), and the group's fp16-rounded d_x and integer level sum
//    beside them in xg.
//  * rows: every 4 rows the lane's 4 x 8 bytes are transposed by byte
//    permutes so that each word holds 4 K-rows of one column; per x row one
//    8-byte shared load gives both panels' 4 levels, and __dp4a multiplies
//    them with the low nibbles (masked) and, unsigned, with the high nibbles
//    left in place (masked, so the dot is 16 times the high panel's, shifted
//    back exactly once a group).  The pack zero is folded exactly in
//    integers: xq . (nib - zero) = xq . nib - zero * sum(xq).  Each group
//    and panel enters f32 once, as ((float)dot * d_x) * d_w, unfused, the
//    order of the TPU kernel (qmm.py:323) and of the plain version.
template <int GS_>
struct Q8Gemv {
  static constexpr int PANELS = 2;
  static constexpr int GS = GS_;
  static constexpr int NPL = 2;
  // one chunk in flight a warp: at one x row the body's registers (the
  // chunk's rows, its x and its int8 dots) then fit 128 a thread, two blocks
  // an SM; at more, 8 x rows a pass (one pass at b <= 8) fit 255 with no
  // spill (two chunks in flight spill, and 4 rows a pass take two passes)
  static constexpr int CH1 = GS, CHN = GS, BUFS1 = 1, BUFSN = 1, OCC1 = 2, NBM = 8;

  template <int NB, int CH, int XL>
  __device__ static void stage(const float (&x)[XL], float* xs, float* xg) {
    static_assert(CH == GS && XL * 32 == NB * PANELS * CH, "a chunk is one group");
    int8_t* q = reinterpret_cast<int8_t*>(xs);
    int* xsum = reinterpret_cast<int*>(xg + NB * PANELS);
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int i = 0; i < XL; ++i) {
      const int v = lane + 32 * i, r = v % CH, p = v / CH % PANELS, bb = v / (CH * PANELS);
      float dq;
      const int lv = (int)q8_quantize<GS>(x[i], dq);
      int sum = lv;
#pragma unroll
      for (int o = GS / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(FULL, sum, o);
      q[bb * 2 * CH + (r / 4) * 8 + p * 4 + r % 4] = (int8_t)lv;
      if (r == 0) {
        xg[v / CH] = __half2float(__float2half_rn(dq));
        xsum[v / CH] = sum;
      }
    }
  }

  template <int NB, int CH>
  __device__ static void rows(const uint2 (&w)[CH], const float (&pl)[NPL][GEMV_COLS],
                              const float* xs, const float* xg, float zero,
                              float (&acc)[NB][GEMV_COLS]) {
    constexpr int Q = CH / 4;
    unsigned t[Q][GEMV_COLS];
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      unsigned half[4];
      transpose4(w[4 * j].x, w[4 * j + 1].x, w[4 * j + 2].x, w[4 * j + 3].x, half);
#pragma unroll
      for (int c = 0; c < 4; ++c) t[j][c] = half[c];
      transpose4(w[4 * j].y, w[4 * j + 1].y, w[4 * j + 2].y, w[4 * j + 3].y, half);
#pragma unroll
      for (int c = 0; c < 4; ++c) t[j][4 + c] = half[c];
    }
    const int z = (int)zero;
    const int* xsum = reinterpret_cast<const int*>(xg + NB * PANELS);
    const int2* xw = reinterpret_cast<const int2*>(xs);
#pragma unroll
    for (int bb = 0; bb < NB; ++bb) {
      int il[GEMV_COLS], ih[GEMV_COLS];
#pragma unroll
      for (int c = 0; c < GEMV_COLS; ++c) il[c] = ih[c] = 0;
#pragma unroll
      for (int j = 0; j < Q; ++j) {
        const int2 xv = xw[bb * Q + j];  // the low panel's 4 levels, then the high's
#pragma unroll
        for (int c = 0; c < GEMV_COLS; ++c) {
          il[c] = __dp4a(xv.x, (int)(t[j][c] & 0x0F0F0F0Fu), il[c]);
          ih[c] = dp4a_su(xv.y, t[j][c] & 0xF0F0F0F0u, ih[c]);
        }
      }
      const float dl = xg[2 * bb], dh = xg[2 * bb + 1];
      const int sl = z * xsum[2 * bb], sh = z * xsum[2 * bb + 1];
#pragma unroll
      for (int c = 0; c < GEMV_COLS; ++c) {
        acc[bb][c] += __fmul_rn(__fmul_rn((float)(il[c] - sl), dl), pl[0][c]);
        acc[bb][c] += __fmul_rn(__fmul_rn((float)((ih[c] >> 4) - sh), dh), pl[1][c]);
      }
    }
  }
};

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
cudaError_t launch(const float* x, const uint8_t* pk, const void* sc, float* dd, float* partial,
                   void* xa, float* out, int B, int K, int N, int G2P, int zero, int bm,
                   int splits, int ka, int scode, cudaStream_t st) {
  if (B > 32)
    return tile::launch<Q8Deq<GS>>(x, pk, G2P * GS, sc, 2 * G2P, nullptr, (__nv_bfloat16*)xa,
                                    partial, out, B, K, N, 2, GS, G2P, (float)zero, bm, splits,
                                    ka, scode, st, dd);
  const GemvArgs a{x, pk, sc, nullptr, out, B, K, N, K / 2 / GEMV_STEP, G2P, scode,
                   (float)zero};
  return gemv_launch<Q8Gemv<GS>>(a, splits, st);
}

}  // namespace

extern "C" {

// Clusters of `splits` blocks the decode form runs at once (rows: 1, or
// more a pass), for ops/qmm.py::gemv_plan; -1 on an error.
int qmm_q8x_gemv_clusters(int splits, int rows) {
  return gemv_max_clusters<Q8Gemv<32>>(splits, rows);
}

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

// At 32 rows or fewer the decode GEMV in `splits` K splits
// (ops/qmm.py::gemv_plan), one launch with the activations quantized inside
// it (d, partial, xa, bm and ka unused); above, the tile: d f32 [B, K/gsize]
// and xa bf16 [B, ka] scratch, partial f32 [splits, B, N] when splits > 1,
// and bm, splits, ka from ops/qmm.py::tile_plan.  scode: the scales' dtype
// (ScaleCode).
int qmm_q8x(const void* x, const void* packed, const void* scales, void* d, void* partial,
            void* xa, void* out, int B, int K, int N, int G2P, int zero, int gsize, int bm,
            int splits, int ka, int scode, void* stream) {
  const float* xf = (const float*)x;
  const uint8_t* pk = (const uint8_t*)packed;
  float* dd = (float*)d;
  float* part = (float*)partial;
  float* o = (float*)out;
  const cudaStream_t st = (cudaStream_t)stream;
  if (gsize == 32)
    return (int)launch<32>(xf, pk, scales, dd, part, xa, o, B, K, N, G2P, zero, bm, splits, ka,
                           scode, st);
  if (gsize == 16)
    return (int)launch<16>(xf, pk, scales, dd, part, xa, o, B, K, N, G2P, zero, bm, splits, ka,
                           scode, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
