// Causal flash attention over a whole prompt, for Hopper (sm_90a).
//
// Replaces the TPU kernel that llama_cpp_q_4_0_tpu/ops/layers.py::_flash_prefill
// calls (JAX's bundled jax.experimental.pallas.ops.tpu.flash_attention, causal,
// f32 operands).  Contract (models/transformer.py attention_fn): q [B,T,H,D],
// k and v [B,T,G,D] (the prompt's fresh K/V after the cache round trip), all f32
// and contiguous; out [B,T,H,D] f32 = softmax(q k^T * scale, causal) v.  Query
// head h reads KV head h / (H/G) by index; the repeated K/V is never built.
// Head widths 128 and 256 are compiled (D is a template parameter).
//
// What bounds it on an H100: at the prefill shapes (T = 128..2048) the work is
// the two products, 4*D operations per causal (query, key) pair.  The TPU
// kernel takes f32 operands and the port holds it to 1e-4 of the output scale,
// which one TF32 product (2^-11 relative) would miss, so both products run as
// 3xTF32 on the tensor cores: a = hi + lo with hi = tf32(a), lo = tf32(a - hi)
// (cvt.rna), a.b ~ lo.hi' + hi.lo' + hi.hi' in f32 accumulators, about 2^-21
// relative.  Three TF32 products at 494.7 TFLOP/s still beat one f32 product
// at 67 on the CUDA cores by 2.5x.  The design:
//  * a block owns 64 query rows of one head and walks 32-key tiles up to the
//    diagonal (the heaviest query blocks start first); the scores, the online
//    softmax (running max m, sum l) and the output stay in registers.
//  * one producer thread keeps TMA copies (4-D tensor maps over [B, T, G, D],
//    the KV head read by index, rows past T zero-filled) of K and V tiles in
//    flight into a ring of NBUF slots, each behind full/ready/empty mbarriers;
//  * a converting warpgroup splits each landed tile into tf32 hi/lo planes in
//    shared memory: K in place, in the 128-byte-swizzled K-major layout TMA
//    wrote (what wgmma reads B from), V transposed to V^T [D x 32 keys] since
//    wgmma takes tf32 operands K-major only;
//  * one consumer warpgroup splits Q once, then per tile: S = Q K^T with
//    wgmma m64n32k8 tf32 from shared memory (3 per 8-deep slice), the
//    softmax in the accumulators, and O += P V with wgmma m64n128k8 tf32, P
//    split hi/lo in registers as the A operand.  The accumulator holds keys
//    2q, 2q+1 of each 8-key slice where the A fragment wants q, q+4, so the
//    converter stores V^T's keys of each slice in the order 0 2 4 6 1 3 5 7.
// Shared memory: Q hi/lo (64 x D x 8 bytes) and NBUF slots of BKV x D x 8:
// at D = 128 four slots (two tiles of K and V in flight), at D = 256 one.
#include <math.h>

#include "hopper.cuh"

using namespace hopper;

namespace {

constexpr int BQ = 64;        // query rows per block (one wgmma M)
constexpr int BKV = 32;       // keys per tile (a V^T row is one 128-byte swizzle row)
constexpr int THREADS = 288;  // consumer warpgroup, converting warpgroup, producer warp
constexpr unsigned FULL_MASK = 0xffffffffu;

template <int D>
struct Cfg {
  static constexpr int NBUF = D == 128 ? 4 : 1;
  static constexpr int Q_PLANE = BQ * D * 4;
  static constexpr int PLANE = BKV * D * 4;  // one plane of a slot
  static constexpr int SLOT_OFF = 2 * Q_PLANE;
  static constexpr int BAR_OFF = SLOT_OFF + NBUF * 2 * PLANE;
  static constexpr int SMEM = BAR_OFF + 1024 + 1024;  // barriers, alignment slack
  static_assert(SMEM <= 232448, "shared memory");
};

__device__ __forceinline__ float tf32_rna(float a) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(a));
  return __uint_as_float(r);
}

__device__ __forceinline__ void split4(float4 a, float4& hi, float4& lo) {
  hi = make_float4(tf32_rna(a.x), tf32_rna(a.y), tf32_rna(a.z), tf32_rna(a.w));
  lo = make_float4(tf32_rna(a.x - hi.x), tf32_rna(a.y - hi.y), tf32_rna(a.z - hi.z),
                   tf32_rna(a.w - hi.w));
}

// split n float4s of a plane in place (hi) and into lo, thread t of 128
__device__ __forceinline__ void split_plane(float4* hi, float4* lo, int n, int t) {
  for (int i = t; i < n; i += 128) {
    float4 h, l;
    split4(hi[i], h, l);
    hi[i] = h;
    lo[i] = l;
  }
}

__device__ __forceinline__ void tma_load4(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                          int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"((uint64_t)map), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// K-major tf32 operand, 128-byte swizzle, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t kdesc(uint32_t addr) { return sw128_desc(addr, 16, 1024); }

// s[16] (= or +=) A(64 x 8 tf32, smem) @ B(8 x 32 tf32, smem, K-major)
__device__ __forceinline__ void wgmma_s(float (&s)[16], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}"
      : "+f"(s[0]), "+f"(s[1]), "+f"(s[2]), "+f"(s[3]), "+f"(s[4]), "+f"(s[5]), "+f"(s[6]),
        "+f"(s[7]), "+f"(s[8]), "+f"(s[9]), "+f"(s[10]), "+f"(s[11]), "+f"(s[12]),
        "+f"(s[13]), "+f"(s[14]), "+f"(s[15])
      : "l"(da), "l"(db), "r"(acc));
}

#define FP_F8(i)                                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),     \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64] += A(64 x 8 tf32, registers) @ B(8 x 128 tf32, smem, K-major)
__device__ __forceinline__ void wgmma_o(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, 1, 1, 1;"
      : FP_F8(0), FP_F8(8), FP_F8(16), FP_F8(24), FP_F8(32), FP_F8(40), FP_F8(48), FP_F8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}
#undef FP_F8

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_prefill_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap, float* __restrict__ out, int T,
                     int H, int G, float scale_log2) {
  using C = Cfg<D>;
  constexpr int NB = C::NBUF;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = smem_u32(smem);
  const uint32_t bar0 = sbase + C::BAR_OFF;
  auto full = [&](int s) { return bar0 + 8 * s; };
  auto ready = [&](int s) { return bar0 + 8 * (NB + s); };
  auto empty = [&](int s) { return bar0 + 8 * (2 * NB + s); };
  const uint32_t qbar = bar0 + 8 * 3 * NB;
  auto slot = [&](int s) { return smem + C::SLOT_OFF + s * 2 * C::PLANE; };

  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int kvh = h / (H / G);
  const int n_tiles = (min(q0 + BQ, T) - 1) / BKV + 1;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < NB; ++s) {
      mbar_init(full(s), 1);
      mbar_init(ready(s), 1);
      mbar_init(empty(s), 1);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {
    // ------------------------------------------------------------ producer
    if (tid != 256) return;
    mbar_expect_tx(qbar, C::Q_PLANE);
    for (int bx = 0; bx < D / 32; ++bx)
      tma_load4(sbase + bx * BQ * 128, &qmap, 32 * bx, h, q0, b, qbar);
    for (int i = 0; i < 2 * n_tiles; ++i) {
      const int s = i % NB;
      mbar_wait(empty(s), ((i / NB) & 1) ^ 1);
      mbar_expect_tx(full(s), C::PLANE);
      const uint32_t dst = smem_u32(slot(s));
      for (int bx = 0; bx < D / 32; ++bx)
        tma_load4(dst + bx * BKV * 128, i % 2 ? &vmap : &kmap, 32 * bx, kvh, BKV * (i / 2), b,
                  full(s));
    }
    return;
  }
  if (tid >= 128) {
    // --------------------------------------------------------- converters
    const int t = tid - 128;
    for (int i = 0; i < 2 * n_tiles; ++i) {
      const int s = i % NB;
      mbar_wait(full(s), (i / NB) & 1);
      float4* hi = reinterpret_cast<float4*>(slot(s));
      float4* lo = reinterpret_cast<float4*>(slot(s) + C::PLANE);
      if (i % 2 == 0) {
        split_plane(hi, lo, C::PLANE / 16, t);
      } else {
        // V: chunk c = (key c % BKV, columns 4(c / BKV) ..) of the landed
        // tile, read whole before V^T overwrites the plane
        constexpr int NV = C::PLANE / 16 / 128;
        float4 r[NV];
#pragma unroll
        for (int n = 0; n < NV; ++n) {
          const int c = t + 128 * n, key = c % BKV, dq = c / BKV;
          r[n] = hi[(dq / 8) * BKV * 8 + key * 8 + ((dq % 8) ^ (key % 8))];
        }
        asm volatile("bar.sync 1, 128;" ::: "memory");
        float* hf = reinterpret_cast<float*>(hi);
        float* lf = reinterpret_cast<float*>(lo);
#pragma unroll
        for (int n = 0; n < NV; ++n) {
          const int c = t + 128 * n, key = c % BKV, d0 = 4 * (c / BKV);
          const int k8 = key % 8;
          const int pos = (key & ~7) + (k8 % 2 ? 4 + k8 / 2 : k8 / 2);
          float4 vh, vl;
          split4(r[n], vh, vl);
          const float eh[4] = {vh.x, vh.y, vh.z, vh.w}, el[4] = {vl.x, vl.y, vl.z, vl.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = d0 + e;
            const int off = row * 32 + (((pos / 4) ^ (row % 8)) * 4) + pos % 4;
            hf[off] = eh[e];
            lf[off] = el[e];
          }
        }
      }
      // make the stores visible to wgmma (the async proxy), then one signal
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      asm volatile("bar.sync 1, 128;" ::: "memory");
      if (t == 0) mbar_arrive(ready(s));
    }
    return;
  }

  // ---------------------------------------------------------------- consumer
  const int lt = tid, w = lt / 32, l = lt % 32, qd = l % 4;
  mbar_wait(qbar, 0);
  split_plane(reinterpret_cast<float4*>(smem), reinterpret_cast<float4*>(smem + C::Q_PLANE),
              C::Q_PLANE / 16, lt);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("bar.sync 2, 128;" ::: "memory");

  constexpr int NH = D / 128;
  float o[NH][64], m[2], lsum[2];
#pragma unroll
  for (int n = 0; n < NH; ++n)
#pragma unroll
    for (int e = 0; e < 64; ++e) o[n][e] = 0.0f;
  m[0] = m[1] = -INFINITY;
  lsum[0] = lsum[1] = 0.0f;
  const int r0 = 16 * w + l / 4;  // this thread's rows r0, r0 + 8 of the block

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = BKV * t;
    // ------------------------------------------------- S = Q K^T (3xTF32)
    const int sk = (2 * t) % NB;
    mbar_wait(ready(sk), ((2 * t) / NB) & 1);
    const uint32_t khi = smem_u32(slot(sk)), klo = khi + C::PLANE;
    float s[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) s[e] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < D / 8; ++kc) {
      const uint32_t qa = sbase + (kc / 4) * BQ * 128 + (kc % 4) * 32;
      const uint32_t ka = (kc / 4) * BKV * 128 + (kc % 4) * 32;
      wgmma_s(s, kdesc(qa + C::Q_PLANE), kdesc(khi + ka), kc > 0);
      wgmma_s(s, kdesc(qa), kdesc(klo + ka), 1);
      wgmma_s(s, kdesc(qa), kdesc(khi + ka), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    if (lt == 0) mbar_arrive(empty(sk));

    // ------------------------------------------------------ online softmax
    // s[4j + 2hh + e]: row r0 + 8hh, key k0 + 8j + 2qd + e
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int qi = q0 + r0 + 8 * hh;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kj = k0 + 8 * j + 2 * qd + e;
          float& x = s[4 * j + 2 * hh + e];
          x = (kj <= qi && kj < T) ? x * scale_log2 : -INFINITY;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, 2));
      const float m_new = fmaxf(m[hh], mx);
      const float alpha = exp2f(m[hh] - m_new);  // 0 on the first tile (m = -inf)
      float psum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * j + 2 * hh + e];
          x = exp2f(x - m_new);
          psum += x;
        }
      psum += __shfl_xor_sync(FULL_MASK, psum, 1);
      psum += __shfl_xor_sync(FULL_MASK, psum, 2);
      lsum[hh] = lsum[hh] * alpha + psum;
      m[hh] = m_new;
#pragma unroll
      for (int n = 0; n < NH; ++n)
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          o[n][4 * j + 2 * hh] *= alpha;
          o[n][4 * j + 2 * hh + 1] *= alpha;
        }
    }

    // --------------------------------------------------- O += P V (3xTF32)
    const int sv = (2 * t + 1) % NB;
    mbar_wait(ready(sv), ((2 * t + 1) / NB) & 1);
    const uint32_t vhi = smem_u32(slot(sv)), vlo = vhi + C::PLANE;
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j) {
      // A fragment (rows r0, r0 + 8; slice columns qd, qd + 4) = keys
      // 2qd, 2qd + 1 of the slice: V^T holds them at those positions
      const float pv[4] = {s[4 * j], s[4 * j + 2], s[4 * j + 1], s[4 * j + 3]};
      uint32_t ah[4], al[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float ph = tf32_rna(pv[e]);
        ah[e] = __float_as_uint(ph);
        al[e] = __float_as_uint(tf32_rna(pv[e] - ph));
      }
#pragma unroll
      for (int n = 0; n < NH; ++n) {
        const uint32_t vb = n * 128 * 128 + j * 32;
        wgmma_o(o[n], al, kdesc(vhi + vb));
        wgmma_o(o[n], ah, kdesc(vlo + vb));
        wgmma_o(o[n], ah, kdesc(vhi + vb));
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    if (lt == 0) mbar_arrive(empty(sv));
  }

  // o[n][4j + 2hh + e]: row r0 + 8hh, column 128n + 8j + 2qd + e
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qi = q0 + r0 + 8 * hh;
    if (qi >= T) continue;
    const float inv = 1.0f / lsum[hh];
    float* orow = out + (((size_t)b * T + qi) * H + h) * D + 2 * qd;
#pragma unroll
    for (int n = 0; n < NH; ++n)
#pragma unroll
      for (int j = 0; j < 16; ++j)
        *reinterpret_cast<float2*>(orow + 128 * n + 8 * j) =
            make_float2(o[n][4 * j + 2 * hh] * inv, o[n][4 * j + 2 * hh + 1] * inv);
  }
}

// a 4-D map over a contiguous f32 [B, T, N, D] tensor: boxes of 32 columns
// (128 bytes, swizzled) x 1 head x rows tokens
cudaError_t make_map4(CUtensorMap* map, const void* base, int B, int T, int N, int D, int rows) {
  const EncodeTiled enc = encoder();
  if (!enc) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)N, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 4, (cuuint64_t)N * D * 4,
                                 (cuuint64_t)T * N * D * 4};
  const cuuint32_t box[4] = {32, 1, (cuuint32_t)rows, 1};
  const cuuint32_t es[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(base), dims,
                         strides, box, es, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
int launch(const float* q, const float* k, const float* v, float* out, int B, int T, int H,
           int G, float scale, cudaStream_t stream) {
  // once per process (so later calls stay legal inside CUDA-graph capture)
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(flash_prefill_kernel<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           Cfg<D>::SMEM);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  CUtensorMap qmap, kmap, vmap;
  cudaError_t err;
  if ((err = make_map4(&qmap, q, B, T, H, D, BQ)) != cudaSuccess ||
      (err = make_map4(&kmap, k, B, T, G, D, BKV)) != cudaSuccess ||
      (err = make_map4(&vmap, v, B, T, G, D, BKV)) != cudaSuccess)
    return (int)err;
  // x: (batch, head); y: query blocks, the last (heaviest) first
  dim3 grid(B * H, (T + BQ - 1) / BQ);
  flash_prefill_kernel<D><<<grid, THREADS, Cfg<D>::SMEM, stream>>>(
      qmap, kmap, vmap, out, T, H, G, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// D is the head width: 128 or 256; any other returns cudaErrorInvalidValue.
int flash_prefill(const void* q, const void* k, const void* v, void* out, int B,
                  int T, int H, int G, int D, float scale, void* stream) {
  const float *qf = (const float*)q, *kf = (const float*)k, *vf = (const float*)v;
  const cudaStream_t st = (cudaStream_t)stream;
  if (D == 128) return launch<128>(qf, kf, vf, (float*)out, B, T, H, G, scale, st);
  if (D == 256) return launch<256>(qf, kf, vf, (float*)out, B, T, H, G, scale, st);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of the kernel at head width D (bytes), for reports.
int flash_prefill_smem(int D) {
  return D == 128 ? Cfg<128>::SMEM : D == 256 ? Cfg<256>::SMEM : 0;
}

}  // extern "C"
