// Pieces shared by the quantized matmul kernels of qmm_q4_0.cu, qmm_int8.cu
// and qmm_q8x.cu (Hopper, sm_90a): exact byte -> float unpacking, bf16
// rounding, the loads of f32, f16 and bf16 scale planes, and the
// deterministic split-K reduce of the decode forms (also the one that adds
// the prefill tile's K splits).  The prefill tile itself is qmm_tile.cuh.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace qmm {

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
// 16-byte aligned bases, or in shared memory)
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// The dtype of a call's scale and bias planes (ops/qmm.py SCALE_CODES), a
// runtime argument of every entry point: f32, or 2-byte f16 or bf16 values
// that the kernels widen to f32 as they load them, exactly, so that the
// arithmetic after the load is the f32 planes' own.  The decode GEMVs load
// their planes once a block and branch on the code there; the prefill
// tile's dequantizers, which load them every step, run a loop compiled for
// each code (qmm_tile.cuh).
enum ScaleCode : int { SCALE_F32 = 0, SCALE_F16 = 1, SCALE_BF16 = 2 };

__host__ __device__ inline int scale_bytes(int code) { return code == SCALE_F32 ? 4 : 2; }

// the 8 plane values from element i of a plane of code SC (i % 8 == 0 and a
// 16-byte aligned base: 32 bytes of f32, 16 of a 2-byte dtype), as f32;
// global or shared memory.  f16 widens through cvt (exact, subnormals
// included), bf16 by a shift into the high half.
template <int SC>
__device__ __forceinline__ void load8s(const void* p, size_t i, float (&v)[8]) {
  if constexpr (SC == SCALE_F32) {
    load8(static_cast<const float*>(p) + i, v);
  } else {
    const uint4 u = *reinterpret_cast<const uint4*>(static_cast<const uint16_t*>(p) + i);
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const unsigned h = e % 2 ? w[e / 2] >> 16 : w[e / 2] & 0xFFFFu;
      v[e] = SC == SCALE_F16 ? __half2float(__ushort_as_half((unsigned short)h))
                             : __uint_as_float(h << 16);
    }
  }
}

// the same with the code known only at run time
__device__ __forceinline__ void load8s(const void* p, size_t i, int code, float (&v)[8]) {
  if (code == SCALE_F32)
    load8s<SCALE_F32>(p, i, v);
  else if (code == SCALE_F16)
    load8s<SCALE_F16>(p, i, v);
  else
    load8s<SCALE_BF16>(p, i, v);
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

}  // namespace qmm
