// Decode / verify attention over the KV cache for Hopper (sm_90a), split-S
// flash decoding.
//
// Replaces llama_cpp_q_4_0_tpu/ops/pallas/attention.py::mha_decode
// (_mha_decode_kernel).  Contract (ops/mha_decode.py): q [B,T,H,D] f32
// contiguous, T <= 16; K and V [B,S,G,D] int8 (with f32 scales [B,S,G]),
// bf16, f16 or f32, contiguous inside a batch row, any batch stride (the
// cache[:, :w] window of a larger cache); q_positions [B,T] int64 and
// kv_mask [B,S] bool, each with its own batch stride (0 when broadcast).
// out [B,T,H,D] f32.  Query head h reads KV head h / (H/G).  The arithmetic is
// the TPU kernel's f32 chain on the stored values: s = (q . k) * scale * ks,
// NEG = -1e30 where the slot is masked or after the row's position,
// p = exp(s - m) zeroed where masked, l = sum p, p *= vs,
// out = (sum p v) / max(l, 1e-30), so a row with no valid slot gives 0.
//
// What bounds it on an H100: the bytes of the K/V window (one byte a value
// for the int8 cache, plus the scales), read once per step; the operations
// (4*D per query row and slot) are far below the f32 rate at T <= 16.  So
// the design spreads the window over many blocks and reads each K/V byte once:
//  * mha_decode_chunk_kernel: one block per (batch row, KV head, 64-slot chunk,
//    block of 16 query rows).  The query rows of a block are the T x rep
//    heads that share the KV head, so GQA reads each K/V tile once for all
//    of them.  Phase 1: each of the 4 warps scores 16 slots, a lane holding
//    D/32 consecutive values of a K row (coalesced loads of the stored type),
//    4 slots' warp reductions interleaved.  Phase 2: per row, the chunk's
//    max m, p and l by warp reductions.  Phase 3: a thread owns D/128 output
//    columns and accumulates p * v over the chunk for every row.  The chunk's
//    (m, l, acc) go to scratch.
//  * mha_decode_combine_kernel: per (batch row, KV head, query row) the
//    chunks are merged in order (deterministic, no atomics).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CH = 64;        // cache slots per block
constexpr int RB = 16;        // query rows per block
constexpr int THREADS = 128;  // 4 warps
constexpr int WARPS = THREADS / 32;
constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(int8_t v) { return (float)v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

// N consecutive stored values as floats, in one or two vector loads (the
// callers' rows are aligned to N * sizeof(T) bytes)
template <typename T, int N>
__device__ __forceinline__ void load_row(const T* p, float (&out)[N]) {
  constexpr int BYTES = N * (int)sizeof(T);
  static_assert(BYTES == 2 || BYTES == 4 || BYTES == 8 || BYTES % 16 == 0, "row width");
  if constexpr (BYTES >= 16) {
    uint4 raw[BYTES / 16];
#pragma unroll
    for (int i = 0; i < BYTES / 16; ++i) raw[i] = reinterpret_cast<const uint4*>(p)[i];
    const T* v = reinterpret_cast<const T*>(raw);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_f32(v[i]);
  } else if constexpr (BYTES == 8) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_f32(v[i]);
  } else if constexpr (BYTES == 4) {
    const unsigned raw = *reinterpret_cast<const unsigned*>(p);
    const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_f32(v[i]);
  } else {
    const unsigned short raw = *reinterpret_cast<const unsigned short*>(p);
    const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_f32(v[i]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
mha_decode_chunk_kernel(const float* __restrict__ q, const T* __restrict__ kd,
                        const float* __restrict__ ks, const T* __restrict__ vd,
                        const float* __restrict__ vs, const long long* __restrict__ qpos,
                        long long qpos_bs, const uint8_t* __restrict__ mask,
                        long long mask_bs, float* __restrict__ opart,
                        float* __restrict__ mlpart, int T_, int H, int G, int S,
                        long long kv_bs, long long sc_bs, int n_rb, float scale) {
  constexpr bool SCALED = sizeof(T) == 1;
  constexpr int NDL = D / 32;                   // values of a K row per lane
  constexpr int NC = D >= THREADS ? D / THREADS : 1;  // output columns per thread
  __shared__ __align__(16) float Qs[RB][D];
  __shared__ float Ps[RB][CH];
  __shared__ int pos_s[RB];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rep = H / G;
  const int R = T_ * rep;
  const int rb = blockIdx.x % n_rb;
  const int bg = blockIdx.x / n_rb;  // b * G + g
  const int b = bg / G, g = bg % G;
  const int chunk = blockIdx.y;
  const int n_chunks = gridDim.y;
  const int s0 = chunk * CH;
  const int nrows = min(RB, R - rb * RB);
  const T* kb = kd + b * kv_bs + (size_t)g * D;
  const T* vb = vd + b * kv_bs + (size_t)g * D;
  const uint8_t* mb = mask + b * mask_bs;

  for (int i = tid; i < RB * D; i += THREADS) {
    const int r = i / D, rho = rb * RB + r;
    float v = 0.0f;
    if (r < nrows) {
      const int t = rho / rep, h = g * rep + rho % rep;
      v = q[(((size_t)b * T_ + t) * H + h) * D + i % D];
    }
    Qs[r][i % D] = v;
  }
  if (tid < RB) {
    const int rho = rb * RB + tid;
    pos_s[tid] = tid < nrows ? (int)qpos[b * qpos_bs + rho / rep] : -1;
  }
  __syncthreads();

  // phase 1: scores; warp w takes slots s0 + 16w .. + 16, 4 at a time
#pragma unroll 1
  for (int j0 = 0; j0 < CH / WARPS; j0 += 4) {
    float kv[4][NDL];
    int sl[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      sl[u] = s0 + warp * (CH / WARPS) + j0 + u;
      if (sl[u] < S) {
        load_row<T, NDL>(kb + (size_t)sl[u] * G * D + lane * NDL, kv[u]);
      } else {
#pragma unroll
        for (int e = 0; e < NDL; ++e) kv[u][e] = 0.0f;
      }
    }
#pragma unroll 1
    for (int r = 0; r < nrows; ++r) {
      float qv[NDL];
#pragma unroll
      for (int e = 0; e < NDL; ++e) qv[e] = Qs[r][lane * NDL + e];
      float dot[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        dot[u] = 0.0f;
#pragma unroll
        for (int e = 0; e < NDL; ++e) dot[u] += qv[e] * kv[u][e];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int u = 0; u < 4; ++u) dot[u] += __shfl_xor_sync(FULL, dot[u], o);
      if (lane < 4) {
        const int s = s0 + warp * (CH / WARPS) + j0 + lane;  // sl[lane]
        float sc = NEG;
        if (s < S && mb[s] && s <= pos_s[r]) {
          sc = (lane == 0 ? dot[0] : lane == 1 ? dot[1] : lane == 2 ? dot[2] : dot[3]) * scale;
          if (SCALED) sc *= ks[b * sc_bs + (size_t)s * G + g];
        }
        Ps[r][s - s0] = sc;
      }
    }
  }
  __syncthreads();

  // phase 2: the chunk's softmax statistics per row; p (times vs) into Ps
  for (int r = warp; r < nrows; r += WARPS) {
    const int rho = rb * RB + r;
    float sv[2], m = NEG;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sv[i] = Ps[r][lane + 32 * i];
      m = fmaxf(m, sv[i]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, o));
    float l = 0.0f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int s = s0 + lane + 32 * i;
      const bool valid = s < S && mb[s] && s <= pos_s[r];
      const float p = valid ? expf(sv[i] - m) : 0.0f;
      l += p;
      Ps[r][lane + 32 * i] = SCALED && valid ? p * vs[b * sc_bs + (size_t)s * G + g] : p;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(FULL, l, o);
    if (lane == 0) {
      const size_t pidx = ((size_t)bg * n_chunks + chunk) * R + rho;
      mlpart[2 * pidx] = m;
      mlpart[2 * pidx + 1] = l;
    }
  }
  __syncthreads();

  // phase 3: acc[r][d] = sum_s p[r][s] * v[s][d]
  float acc[RB][NC];
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.0f;
  const int n_s = min(CH, S - s0);
  if (tid < D) {
#pragma unroll 4
    for (int j = 0; j < n_s; ++j) {
      float v[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c)
        v[c] = to_f32(vb[(size_t)(s0 + j) * G * D + tid + THREADS * c]);
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        if (r < nrows) {
          const float p = Ps[r][j];
#pragma unroll
          for (int c = 0; c < NC; ++c) acc[r][c] += p * v[c];
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (r < nrows) {
        const size_t pidx = ((size_t)bg * n_chunks + chunk) * R + rb * RB + r;
#pragma unroll
        for (int c = 0; c < NC; ++c) opart[pidx * D + tid + THREADS * c] = acc[r][c];
      }
    }
  }
}

// one block per (b * G + g, query row); D threads
__global__ void mha_decode_combine_kernel(const float* __restrict__ opart,
                                          const float* __restrict__ mlpart,
                                          float* __restrict__ out, int T_, int H, int G,
                                          int D, int n_chunks) {
  const int rep = H / G;
  const int R = T_ * rep;
  const int rho = blockIdx.x % R;
  const int bg = blockIdx.x / R;
  const int b = bg / G, g = bg % G;
  const int d = threadIdx.x;
  float M = NEG;
  for (int c = 0; c < n_chunks; ++c)
    M = fmaxf(M, mlpart[2 * (((size_t)bg * n_chunks + c) * R + rho)]);
  float L = 0.0f, o = 0.0f;
  for (int c = 0; c < n_chunks; ++c) {
    const size_t pidx = ((size_t)bg * n_chunks + c) * R + rho;
    const float w = expf(mlpart[2 * pidx] - M);
    L += mlpart[2 * pidx + 1] * w;
    o += opart[pidx * D + d] * w;
  }
  const int t = rho / rep, h = g * rep + rho % rep;
  out[(((size_t)b * T_ + t) * H + h) * D + d] = o / fmaxf(L, 1e-30f);
}

template <typename T, int D>
cudaError_t launch(const float* q, const void* kd, const float* ks, const void* vd,
                   const float* vs, const long long* qpos, long long qpos_bs,
                   const uint8_t* mask, long long mask_bs, float* opart, float* mlpart,
                   float* out, int B, int T_, int H, int G, int S, long long kv_bs,
                   long long sc_bs, float scale, cudaStream_t st) {
  const int R = T_ * (H / G);
  const int n_rb = (R + RB - 1) / RB;
  const int n_chunks = (S + CH - 1) / CH;
  dim3 grid(B * G * n_rb, n_chunks);
  mha_decode_chunk_kernel<T, D><<<grid, THREADS, 0, st>>>(
      q, (const T*)kd, ks, (const T*)vd, vs, qpos, qpos_bs, mask, mask_bs, opart, mlpart,
      T_, H, G, S, kv_bs, sc_bs, n_rb, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mha_decode_combine_kernel<<<B * G * R, D, 0, st>>>(opart, mlpart, out, T_, H, G, D,
                                                     n_chunks);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const float* q, const void* kd, const float* ks, const void* vd,
                     const float* vs, const long long* qpos, long long qpos_bs,
                     const uint8_t* mask, long long mask_bs, float* opart, float* mlpart,
                     float* out, int B, int T_, int H, int G, int S, long long kv_bs,
                     long long sc_bs, float scale, cudaStream_t st) {
  if (D == 64)
    return launch<T, 64>(q, kd, ks, vd, vs, qpos, qpos_bs, mask, mask_bs, opart, mlpart,
                         out, B, T_, H, G, S, kv_bs, sc_bs, scale, st);
  if (D == 128)
    return launch<T, 128>(q, kd, ks, vd, vs, qpos, qpos_bs, mask, mask_bs, opart, mlpart,
                          out, B, T_, H, G, S, kv_bs, sc_bs, scale, st);
  if (D == 256)
    return launch<T, 256>(q, kd, ks, vd, vs, qpos, qpos_bs, mask, mask_bs, opart, mlpart,
                          out, B, T_, H, G, S, kv_bs, sc_bs, scale, st);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Chunks of the S axis; the caller allocates opart [B*G*chunks*T*(H/G)*D] and
// mlpart [B*G*chunks*T*(H/G)*2] f32 scratch.
int mha_decode_chunks(int S) { return (S + CH - 1) / CH; }

// kv_type: 0 int8 (ks and vs f32 scales), 1 bf16, 2 f16, 3 f32.  kv_bs and
// sc_bs are the batch strides of K/V and of the scales, in elements.
int mha_decode(const void* q, const void* kd, const void* ks, const void* vd,
               const void* vs, const void* qpos, long long qpos_bs, const void* mask,
               long long mask_bs, void* opart, void* mlpart, void* out, int B, int T,
               int H, int G, int S, int D, long long kv_bs, long long sc_bs, int kv_type,
               float scale, void* stream) {
  const float* qf = (const float*)q;
  const float *ksf = (const float*)ks, *vsf = (const float*)vs;
  const long long* qp = (const long long*)qpos;
  const uint8_t* mk = (const uint8_t*)mask;
  float *op = (float*)opart, *ml = (float*)mlpart, *o = (float*)out;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (kv_type) {
    case 0:
      return (int)launch_d<int8_t>(D, qf, kd, ksf, vd, vsf, qp, qpos_bs, mk, mask_bs, op, ml,
                                   o, B, T, H, G, S, kv_bs, sc_bs, scale, st);
    case 1:
      return (int)launch_d<__nv_bfloat16>(D, qf, kd, ksf, vd, vsf, qp, qpos_bs, mk, mask_bs,
                                          op, ml, o, B, T, H, G, S, kv_bs, sc_bs, scale, st);
    case 2:
      return (int)launch_d<__half>(D, qf, kd, ksf, vd, vsf, qp, qpos_bs, mk, mask_bs, op, ml,
                                   o, B, T, H, G, S, kv_bs, sc_bs, scale, st);
    case 3:
      return (int)launch_d<float>(D, qf, kd, ksf, vd, vsf, qp, qpos_bs, mk, mask_bs, op, ml,
                                  o, B, T, H, G, S, kv_bs, sc_bs, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
