// Decode / verify attention over the KV cache for Hopper (sm_90a): one launch
// a call, the window split along S across a thread-block cluster.
//
// Replaces llama_cpp_q_4_0_tpu/ops/pallas/attention.py::mha_decode
// (_mha_decode_kernel).  Contract (ops/mha_decode.py): q [B,T,H,D] f32
// contiguous, T <= 16; K and V [B,S,G,D] int8 (with f32 scales [B,S,G]),
// bf16, f16, f32 or e4m3 (the f8 cache, widened through f16 as each piece
// leaves the ring), contiguous inside a batch row, any batch stride (the
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
// (4*D per query row and slot) are far below the f32 rate at T*rep <= 16.
// At the 7B decode step a call moves a few MB, so what it needs is those
// bytes in flight at once and no second pass.  The design:
//  * One cluster per (batch row, KV head, block of RB query rows), RB = 1,
//    4, 8 or 16 at compile time (ops/mha_decode.py::mha_plan): the query
//    rows of a block are the T x rep heads that share the KV head, so GQA
//    reads each K/V row once for all of them.  The cluster's S <= 8 blocks
//    split the window's slots in rank order; each block keeps its slice's
//    softmax state (m, l, acc) and, after cluster.sync(), rank q merges its
//    share of the output elements over ranks 0..S-1 in rank order, reading
//    the others' state through distributed shared memory; a second
//    cluster.sync() keeps every block's state alive until all are read.  No
//    scratch in global memory, no atomics, a fixed order (two launches and
//    CUDA graph replays are bit-identical), no state left behind.
//  * Bytes in flight: a block's slice streams through a ring of two stages
//    of CHS slots (K rows, then V rows, each padded by 16 bytes so that
//    16-byte shared loads of neighbouring rows fall on different banks),
//    filled by 16-byte cp.async copies issued up front; the mask and scales
//    of a thread's slot are loaded into registers before it waits.
//  * No per-slot warp reduction: a thread scores a whole slot (at 128 slots a
//    chunk; at fewer, 2-8 neighbouring threads share it and add their parts
//    with 1-3 shuffles), reading its K row from shared memory in 16-byte
//    pieces against q broadcast from shared memory, for all RB rows at once;
//    the chunk's statistics take one warp reduction a row.  For p v a thread owns CPT columns (a 16-byte piece of
//    a V row at small RB) of every row and every SG-th slot; the slot groups
//    are summed in a fixed order at the end.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

namespace cg = cooperative_groups;

constexpr int THREADS = 128;  // 4 warps
constexpr int WARPS = THREADS / 32;
constexpr int NST = 2;         // ring stages
constexpr int MAX_SPLITS = 8;  // the portable cluster size
constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

// shapes of one (stored type, head width, rows per block) instance
template <typename T, int D, int RB>
struct Geo {
  static constexpr int SZ = (int)sizeof(T);
  static constexpr int ROW = D * SZ;                 // bytes of a K or V row
  static constexpr int PITCH = ROW + 16;             // a row's pitch in shared memory
  static constexpr int PIECES = ROW / 16;            // 16-byte pieces of a row
  static constexpr int VPP = 16 / SZ;                // values of a piece
  // slots a stage: 16 KB of K rows (and as many of V), 8 KB at 8 or more
  // rows, whose scoring and p v take longer a slot (a sweep of 8-16 KB and
  // 2-4 stages on the H100 measured these fastest at T = 1 and 8)
  static constexpr int STAGE_BYTES = RB >= 8 ? 8192 : 16384;
  static constexpr int CHS = STAGE_BYTES / ROW < 128 ? STAGE_BYTES / ROW : 128;
  static constexpr int STAGE = 2 * CHS * PITCH;      // K rows, then V rows
  // p v: columns a thread (a 16-byte piece at small RB; RB x CPT <= 64
  // registers), column groups and slot groups
  static constexpr int CPT = VPP < 64 / RB ? VPP : 64 / RB;
  static constexpr int NCG = D / CPT;
  static constexpr int SG = THREADS / NCG;
  // dynamic shared memory, byte offsets
  static constexpr int QS = NST * STAGE;             // q rows [RB][D] f32
  static constexpr int PS = QS + RB * D * 4;         // scores, then p [RB][CHS]
  static constexpr int VSC = PS + RB * CHS * 4;      // V scale of each slot
  static constexpr int MSK = VSC + CHS * 4;          // mask of each slot
  static constexpr int ST = MSK + CHS * 4;           // m, l, corr [3][RB]
  static constexpr int POS = ST + 3 * RB * 4;        // positions [RB]
  static constexpr int OACC = (POS + RB * 4 + 15) / 16 * 16;  // the block's acc [RB][D]
  static constexpr int SMEM = OACC + RB * D * 4;
  static_assert(NCG <= THREADS && THREADS % NCG == 0, "column groups");
  static_assert(SG * RB * D * 4 <= NST * STAGE, "the slot-group sums fit the ring");
  static constexpr int TPS = THREADS / CHS;          // threads scoring a slot
  static_assert(CHS <= THREADS && THREADS % CHS == 0 && 32 % TPS == 0, "slots of a stage");
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// N stored values of type T at p (shared memory, N * sizeof(T) in 4, 8 or 16
// bytes, aligned to it) as exact floats
template <typename T, int N>
__device__ __forceinline__ void load_vals(const uint8_t* p, float (&f)[N]) {
  constexpr int BYTES = N * (int)sizeof(T), W = BYTES / 4;
  static_assert(BYTES == 4 || BYTES == 8 || BYTES == 16, "piece width");
  unsigned w[W];
  if constexpr (W == 4) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    w[0] = u.x; w[1] = u.y; w[2] = u.z; w[3] = u.w;
  } else if constexpr (W == 2) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    w[0] = u.x; w[1] = u.y;
  } else {
    w[0] = *reinterpret_cast<const unsigned*>(p);
  }
#pragma unroll
  for (int e = 0; e < N; ++e) {
    if constexpr (std::is_same<T, __nv_fp8_e4m3>::value) {  // e4m3 -> f16, exact
      const __half_raw h = __nv_cvt_fp8_to_halfraw(
          (__nv_fp8_storage_t)((w[e / 4] >> (8 * (e % 4))) & 0xFFu), __NV_E4M3);
      f[e] = __half2float(__half(h));
    } else if constexpr (sizeof(T) == 1) {  // signed byte: sign flip, mantissa of 2^23
      f[e] = __int_as_float(__byte_perm(w[e / 4] ^ 0x80808080u, 0x4B000000u, 0x7540 + e % 4))
             - 8388736.0f;
    } else if constexpr (sizeof(T) == 4) {
      f[e] = __uint_as_float(w[e]);
    } else {
      const unsigned h = e % 2 ? w[e / 2] >> 16 : w[e / 2] & 0xFFFFu;
      if constexpr (std::is_same<T, __half>::value)
        f[e] = __half2float(__ushort_as_half((unsigned short)h));
      else
        f[e] = __uint_as_float(h << 16);
    }
  }
}

struct Args {
  const float* q;
  const uint8_t* kd;
  const float* ks;
  const uint8_t* vd;
  const float* vs;
  const long long* qpos;
  long long qpos_bs;
  const uint8_t* mask;
  long long mask_bs;
  float* out;
  int T, H, G, S, n_rb;
  long long kv_bs, sc_bs;  // batch strides in elements
  float scale;
};

template <typename T, int D, int RB>
__global__ void __launch_bounds__(THREADS) mha_decode_kernel(const Args a) {
  using Gm = Geo<T, D, RB>;
  constexpr bool SCALED = std::is_same<T, int8_t>::value;
  constexpr int CHS = Gm::CHS, PITCH = Gm::PITCH, PIECES = Gm::PIECES, VPP = Gm::VPP;
  constexpr int CPT = Gm::CPT, NCG = Gm::NCG, SG = Gm::SG, TPS = Gm::TPS;
  extern __shared__ __align__(16) uint8_t smem[];
  float* Qs = reinterpret_cast<float*>(smem + Gm::QS);
  float* Ps = reinterpret_cast<float*>(smem + Gm::PS);
  float* vsc = reinterpret_cast<float*>(smem + Gm::VSC);
  int* msk = reinterpret_cast<int*>(smem + Gm::MSK);
  float* m_s = reinterpret_cast<float*>(smem + Gm::ST);
  float* l_s = m_s + RB;
  float* corr_s = l_s + RB;
  int* pos_s = reinterpret_cast<int*>(smem + Gm::POS);
  float* oacc = reinterpret_cast<float*>(smem + Gm::OACC);

  cg::cluster_group cluster = cg::this_cluster();
  const int CS = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rb = blockIdx.y % a.n_rb, bg = blockIdx.y / a.n_rb;
  const int b = bg / a.G, g = bg % a.G;
  const int rep = a.H / a.G, R = a.T * rep;
  const int nrows = min(RB, R - rb * RB);
  const int s_lo = (int)((long long)rank * a.S / CS);
  const int s_hi = (int)((long long)(rank + 1) * a.S / CS);
  const int n_chunks = (s_hi - s_lo + CHS - 1) / CHS;
  const size_t slot_bytes = (size_t)a.G * Gm::ROW;
  const uint8_t* kb = a.kd + (size_t)b * a.kv_bs * Gm::SZ + (size_t)g * Gm::ROW;
  const uint8_t* vb = a.vd + (size_t)b * a.kv_bs * Gm::SZ + (size_t)g * Gm::ROW;
  const uint8_t* mb = a.mask + b * a.mask_bs;

  // chunk c's K and V rows into stage st, one commit group (empty past the end)
  auto issue = [&](int c, int st) {
    if (c < n_chunks) {
      const int base = s_lo + c * CHS, n = min(CHS, s_hi - base);
      uint8_t* ring = smem + st * Gm::STAGE;
      for (int i = tid; i < 2 * n * PIECES; i += THREADS) {
        const int kv = i / (n * PIECES), rem = i % (n * PIECES);
        const int j = rem / PIECES, pc = rem % PIECES;
        cp_async16(ring + (kv * CHS + j) * PITCH + pc * 16,
                   (kv ? vb : kb) + (size_t)(base + j) * slot_bytes + pc * 16);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int st = 0; st < NST; ++st) issue(st, st);

  for (int i = tid; i < RB * D; i += THREADS) {
    const int r = i / D;
    float v = 0.0f;
    if (r < nrows) {
      const int rho = rb * RB + r, t = rho / rep, h = g * rep + rho % rep;
      v = a.q[(((size_t)b * a.T + t) * a.H + h) * D + i % D];
    }
    Qs[i] = v;
  }
  if (tid < RB) {
    pos_s[tid] = tid < nrows ? (int)a.qpos[b * a.qpos_bs + (rb * RB + tid) / rep] : -1;
    m_s[tid] = NEG;
    l_s[tid] = 0.0f;
  }

  const int cgi = tid % NCG, sgi = tid / NCG;
  float acc[RB][CPT];
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int e = 0; e < CPT; ++e) acc[r][e] = 0.0f;

  for (int c = 0; c < n_chunks; ++c) {
    const int base = s_lo + c * CHS, n = min(CHS, s_hi - base);
    const int st = c % NST;
    // the thread's slot (tps neighbouring threads a slot: at least TPS, more
    // while the chunk's slots leave threads idle): its mask and scales,
    // loaded before the wait
    int tps = TPS;
    while (tps < 8 && 2 * tps <= PIECES && 2 * tps * n <= THREADS) tps *= 2;
    const int js = tid / tps, part = tid % tps;
    const bool mine = js < n;
    const int s = base + js;
    const int mv = mine ? (int)mb[s] : 0;
    const float kscale = SCALED && mine ? a.ks[b * a.sc_bs + (size_t)s * a.G + g] : 1.0f;
    const float vscale = SCALED && mine ? a.vs[b * a.sc_bs + (size_t)s * a.G + g] : 1.0f;
    cp_async_wait<NST - 1>();
    __syncthreads();
    const uint8_t* Ks = smem + st * Gm::STAGE;
    const uint8_t* Vs = Ks + CHS * PITCH;

    // scores: a slot for TPS threads (one at 128 slots a stage), every row;
    // the TPS parts of a dot summed by TPS / 2 shuffles
    float dot[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) dot[r] = 0.0f;
    if (mine) {
#pragma unroll 2
      for (int pc = part; pc < PIECES; pc += tps) {
        float kv[VPP];
        load_vals<T, VPP>(Ks + js * PITCH + pc * 16, kv);
#pragma unroll
        for (int r = 0; r < RB; ++r) {
#pragma unroll
          for (int e4 = 0; e4 < VPP; e4 += 4) {
            const float4 q4 = *reinterpret_cast<const float4*>(Qs + r * D + pc * VPP + e4);
            dot[r] += q4.x * kv[e4];
            dot[r] += q4.y * kv[e4 + 1];
            dot[r] += q4.z * kv[e4 + 2];
            dot[r] += q4.w * kv[e4 + 3];
          }
        }
      }
    }
    for (int o = tps / 2; o > 0; o >>= 1)
#pragma unroll
      for (int r = 0; r < RB; ++r) dot[r] += __shfl_xor_sync(FULL, dot[r], o);
    if (mine && part == 0) {
#pragma unroll
      for (int r = 0; r < RB; ++r)
        Ps[r * CHS + js] = mv && s <= pos_s[r] ? dot[r] * a.scale * kscale : NEG;
      msk[js] = mv;
      vsc[js] = vscale;
    }
    __syncthreads();

    // the chunk's statistics, a warp a row: m, corr, l; p (times vs) into Ps
    for (int r = warp; r < nrows; r += WARPS) {
      constexpr int PER = (CHS + 31) / 32;
      float sv[PER], m = NEG;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int j = lane + 32 * i;
        sv[i] = j < n ? Ps[r * CHS + j] : NEG;
        m = fmaxf(m, sv[i]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, o));
      const float m_old = m_s[r], m_new = fmaxf(m_old, m);
      const float corr = expf(m_old - m_new);
      float l = 0.0f;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int j = lane + 32 * i;
        if (j < n) {
          const bool valid = msk[j] && base + j <= pos_s[r];
          const float p = valid ? expf(sv[i] - m_new) : 0.0f;
          l += p;
          Ps[r * CHS + j] = SCALED ? p * vsc[j] : p;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(FULL, l, o);
      if (lane == 0) {
        l_s[r] = l_s[r] * corr + l;
        m_s[r] = m_new;
        corr_s[r] = corr;
      }
    }
    __syncthreads();

    // p v: CPT columns of every row, slots sgi, sgi + SG, ...
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const float cr = r < nrows ? corr_s[r] : 1.0f;
#pragma unroll
      for (int e = 0; e < CPT; ++e) acc[r][e] *= cr;
    }
#pragma unroll 2
    for (int j = sgi; j < n; j += SG) {
      float v[CPT];
      load_vals<T, CPT>(Vs + j * PITCH + cgi * CPT * Gm::SZ, v);
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const float p = Ps[r * CHS + j];
#pragma unroll
        for (int e = 0; e < CPT; ++e) acc[r][e] += p * v[e];
      }
    }
    __syncthreads();  // the stage, Ps and the slot values are free
    issue(c + NST, st);
  }
  cp_async_wait<0>();
  __syncthreads();

  // the slot groups' sums in group order, in the ring's memory
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int e = 0; e < CPT; ++e) red[(sgi * RB + r) * D + cgi * CPT + e] = acc[r][e];
  __syncthreads();
  for (int i = tid; i < RB * D; i += THREADS) {
    float v = 0.0f;
    for (int k = 0; k < SG; ++k) v += red[k * RB * D + i];
    oacc[i] = v;
  }

  // the cluster's ranks merged in rank order, rank q taking its share of
  // the rows' output elements
  cluster.sync();
  const int total = nrows * D;
  const int lo = rank * total / CS, hi = (rank + 1) * total / CS;
  for (int i = lo + tid; i < hi; i += THREADS) {
    const int r = i / D;
    // every rank's read in flight at once; a slot past the cluster reads
    // rank 0 and is dropped
    float mk[MAX_SPLITS], lk[MAX_SPLITS], ok[MAX_SPLITS];
#pragma unroll
    for (int k = 0; k < MAX_SPLITS; ++k) {
      const int src = k < CS ? k : 0;
      mk[k] = *cluster.map_shared_rank(m_s + r, src);
      lk[k] = *cluster.map_shared_rank(l_s + r, src);
      ok[k] = *cluster.map_shared_rank(oacc + i, src);
    }
    float M = NEG;
#pragma unroll
    for (int k = 0; k < MAX_SPLITS; ++k)
      if (k < CS) M = fmaxf(M, mk[k]);
    float L = 0.0f, O = 0.0f;
#pragma unroll
    for (int k = 0; k < MAX_SPLITS; ++k) {
      if (k < CS) {
        const float w = expf(mk[k] - M);
        L += lk[k] * w;
        O += ok[k] * w;
      }
    }
    const int rho = rb * RB + r, t = rho / rep, h = g * rep + rho % rep;
    a.out[(((size_t)b * a.T + t) * a.H + h) * D + i % D] = O / fmaxf(L, 1e-30f);
  }
  cluster.sync();  // the state stays until every rank has read it
}

template <typename T, int D, int RB>
cudaError_t launch(const Args& a, int splits, int B, cudaStream_t st) {
  using Gm = Geo<T, D, RB>;
  static bool sized = false;  // above 48 KB once per instance, before any capture
  cudaError_t e;
  if (!sized) {
    e = cudaFuncSetAttribute(mha_decode_kernel<T, D, RB>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, Gm::SMEM);
    if (e != cudaSuccess) {
      cudaGetLastError();
      return e;
    }
    sized = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, B * a.G * a.n_rb, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = Gm::SMEM;
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = splits;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, mha_decode_kernel<T, D, RB>, a);
  if (e != cudaSuccess) cudaGetLastError();  // this launch's error, not left for the next
  return e;
}

template <typename T, int D>
cudaError_t launch_rb(const Args& a, int rb, int splits, int B, cudaStream_t st) {
  switch (rb) {
    case 1: return launch<T, D, 1>(a, splits, B, st);
    case 4: return launch<T, D, 4>(a, splits, B, st);
    case 8: return launch<T, D, 8>(a, splits, B, st);
    case 16: return launch<T, D, 16>(a, splits, B, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_d(int D, const Args& a, int rb, int splits, int B, cudaStream_t st) {
  if (D == 64) return launch_rb<T, 64>(a, rb, splits, B, st);
  if (D == 128) return launch_rb<T, 128>(a, rb, splits, B, st);
  if (D == 256) return launch_rb<T, 256>(a, rb, splits, B, st);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// kv_type: 0 int8 (ks and vs f32 scales), 1 bf16, 2 f16, 3 f32, 4 e4m3.
// kv_bs and sc_bs are the batch strides of K/V and of the scales, in
// elements.
// splits (the cluster size, 1..8) and rb (query rows a block: 1, 4, 8 or
// 16) from ops/mha_decode.py::mha_plan.
int mha_decode(const void* q, const void* kd, const void* ks, const void* vd,
               const void* vs, const void* qpos, long long qpos_bs, const void* mask,
               long long mask_bs, void* out, int B, int T, int H, int G, int S, int D,
               long long kv_bs, long long sc_bs, int kv_type, float scale, int splits,
               int rb, void* stream) {
  if (B < 1 || T < 1 || G < 1 || H % G || S < 1 || splits < 1 || splits > MAX_SPLITS ||
      (rb != 1 && rb != 4 && rb != 8 && rb != 16))
    return (int)cudaErrorInvalidValue;
  const int rows = T * (H / G);
  const Args a{(const float*)q, (const uint8_t*)kd, (const float*)ks, (const uint8_t*)vd,
               (const float*)vs, (const long long*)qpos, qpos_bs, (const uint8_t*)mask,
               mask_bs, (float*)out, T, H, G, S, (rows + rb - 1) / rb, kv_bs, sc_bs, scale};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (kv_type) {
    case 0: return (int)launch_d<int8_t>(D, a, rb, splits, B, st);
    case 1: return (int)launch_d<__nv_bfloat16>(D, a, rb, splits, B, st);
    case 2: return (int)launch_d<__half>(D, a, rb, splits, B, st);
    case 3: return (int)launch_d<float>(D, a, rb, splits, B, st);
    case 4: return (int)launch_d<__nv_fp8_e4m3>(D, a, rb, splits, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
