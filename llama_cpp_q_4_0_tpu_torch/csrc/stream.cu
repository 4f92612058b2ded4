// HBM read stream for Hopper (sm_90a): the practical read bandwidth that the
// byte bounds of the decode kernels are set against.
//
// Replaces the TPU kernel of llama_cpp_q_4_0_tpu/cli/benchmark.py::_stream_once
// (inner `kernel`): a grid over tiles of a uint8 [rows, 65536] buffer, each
// tile DMA'd whole into VMEM while the kernel touches only its [8, 128]
// corner, summed into an f32 [8, 128] output.  A GPU thread reads only what
// it loads, so this kernel reads EVERY byte: a block takes one tile of
// `tile_rows` rows per step (tiles b, b + grid, ...), its threads read the
// tile in 16-byte vector loads (4 in flight per thread) and sum all bytes
// with __dp4a into a checksum; the block also adds the tile's [8, 128] corner
// into the TPU kernel's output.  stream_reduce_kernel then sums the blocks'
// checksums and corners in a fixed order.  On a buffer of ones the checksum
// equals the buffer's size and every corner value the number of tiles: both
// exact, so both prove that the reads happened.  Bound: the buffer's bytes
// at the memory rate.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int LANES = 65536;  // bytes per row
constexpr int CORNER = 8 * 128;
constexpr int UNROLL = 4;

__global__ void __launch_bounds__(THREADS)
stream_kernel(const uint8_t* __restrict__ buf, long long n_tiles, long long tile_bytes,
              unsigned long long* __restrict__ sums, float* __restrict__ corners) {
  __shared__ unsigned long long red[THREADS / 32];
  const int tid = threadIdx.x;
  unsigned long long total = 0;
  float corner[CORNER / THREADS];
#pragma unroll
  for (int e = 0; e < CORNER / THREADS; ++e) corner[e] = 0.0f;
  const long long vecs = tile_bytes / 16;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const uint8_t* base = buf + tile * tile_bytes;
    const uint4* v = reinterpret_cast<const uint4*>(base);
    unsigned s = 0;  // at most 255 * tile_bytes / THREADS < 2^32 for tiles < 8 GiB
    long long i = tid;
    for (; i + (UNROLL - 1) * THREADS < vecs; i += UNROLL * THREADS) {
      uint4 w[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) w[u] = v[i + u * THREADS];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        s = __dp4a(w[u].x, 0x01010101u, s);
        s = __dp4a(w[u].y, 0x01010101u, s);
        s = __dp4a(w[u].z, 0x01010101u, s);
        s = __dp4a(w[u].w, 0x01010101u, s);
      }
    }
    for (; i < vecs; i += THREADS) {
      const uint4 w = v[i];
      s = __dp4a(w.x, 0x01010101u, s);
      s = __dp4a(w.y, 0x01010101u, s);
      s = __dp4a(w.z, 0x01010101u, s);
      s = __dp4a(w.w, 0x01010101u, s);
    }
    total += s;
#pragma unroll
    for (int e = 0; e < CORNER / THREADS; ++e) {
      const int c = tid + e * THREADS;
      corner[e] += (float)base[(size_t)(c / 128) * LANES + c % 128];
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) total += __shfl_xor_sync(0xffffffffu, total, o);
  if ((tid & 31) == 0) red[tid >> 5] = total;
  __syncthreads();
  if (tid == 0) {
    unsigned long long t = 0;
    for (int w = 0; w < THREADS / 32; ++w) t += red[w];
    sums[blockIdx.x] = t;
  }
#pragma unroll
  for (int e = 0; e < CORNER / THREADS; ++e)
    corners[(size_t)blockIdx.x * CORNER + tid + e * THREADS] = corner[e];
}

// one block of CORNER threads: the blocks' partials summed in block order
__global__ void stream_reduce_kernel(const unsigned long long* __restrict__ sums,
                                     const float* __restrict__ corners, int n_blocks,
                                     unsigned long long* __restrict__ checksum,
                                     float* __restrict__ corner) {
  const int tid = threadIdx.x;
  float c = 0.0f;
  for (int b = 0; b < n_blocks; ++b) c += corners[(size_t)b * CORNER + tid];
  corner[tid] = c;
  if (tid == 0) {
    unsigned long long t = 0;
    for (int b = 0; b < n_blocks; ++b) t += sums[b];
    *checksum = t;
  }
}

}  // namespace

extern "C" {

// The grid the caller sizes its scratch for: sums [blocks] u64, corners
// [blocks, 8, 128] f32.
int hbm_stream_blocks(long long n_tiles) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long want = 4LL * sms;  // 4 blocks of 512 threads per SM
  return (int)(n_tiles < want ? n_tiles : want);
}

// buf: uint8 [n_tiles * tile_rows, 65536], 16-byte aligned.
int hbm_stream(const void* buf, long long n_tiles, int tile_rows, int n_blocks, void* sums,
               void* corners, void* checksum, void* corner, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (tile_rows < 8 || n_blocks < 1) return (int)cudaErrorInvalidValue;
  stream_kernel<<<n_blocks, THREADS, 0, st>>>((const uint8_t*)buf, n_tiles,
                                              (long long)tile_rows * LANES,
                                              (unsigned long long*)sums, (float*)corners);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stream_reduce_kernel<<<1, CORNER, 0, st>>>((const unsigned long long*)sums,
                                             (const float*)corners, n_blocks,
                                             (unsigned long long*)checksum, (float*)corner);
  return (int)cudaGetLastError();
}

}  // extern "C"
