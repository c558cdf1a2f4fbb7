// Scatter-max of non-negative rows into K interleaved copies of a zeroed
// grid, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` of streammos_tpu/ops/pallas_scatter_vmem.py
// (pallas_call in `scatter_max_vmem`), which `voxel_max_pool(impl="vmem")`
// reaches.
//
// What it computes: feat (B, N, C) with every value >= 0, ids (B, N); for
// every batch b and cell c of [0, num_cells), out[b, c] = max(0, the rows of
// batch b with id c). Ids outside [0, num_cells), of either sign, are the
// sentinel row: dropped.
//
// Bound: every id is read once, the row of each point inside the grid once
// (a point outside returns before its row is loaded), and the grid written
// once (4-17 MB grids at the four cascade sites of a frame, under 41-82 MB
// of rows in bf16), a few flops a byte, so the card's memory rate bounds it. The TPU kernel kept K copies
// of the grid in VMEM so that K read-max-write chains overlap; here the K
// copies live in device memory (K from `_num_copies`: 34-67 MB at those
// sites, against a 50 MB L2), and the updates are atomics that L2
// resolves. The range-skewed scans pile points into near cells, so
// many updates hit the same few rows; point i of a batch updates copy
// i mod K, which spreads that contention over K addresses. Three steps on
// one stream: zero the copies (cudaMemsetAsync), one thread per 32-bit word
// of a row does its atomic max (float32: atomicMax on the bit pattern,
// since for x >= 0 float order is integer order; bfloat16: a compare-and-swap
// loop on the word's channel pair, a max per half), and one pass takes the
// max over the copies into the output. A word is read first and the atomic
// skipped when it would not raise the stored value.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ void atomic_max_word(float*, unsigned* dst, unsigned x) {
  // non-negative floats: bit patterns order as signed ints
  const int xi = (int)x;
  if (xi > *reinterpret_cast<volatile int*>(dst)) atomicMax(reinterpret_cast<int*>(dst), xi);
}

__device__ __forceinline__ __nv_bfloat162 as_bf162(unsigned u) {
  __nv_bfloat162 v;
  memcpy(&v, &u, sizeof(v));
  return v;
}

__device__ __forceinline__ unsigned as_word(__nv_bfloat162 v) {
  unsigned u;
  memcpy(&u, &v, sizeof(u));
  return u;
}

__device__ __forceinline__ void atomic_max_word(__nv_bfloat16*, unsigned* dst, unsigned x) {
  const __nv_bfloat162 xv = as_bf162(x);
  unsigned old = *reinterpret_cast<volatile unsigned*>(dst);
  while (true) {
    // max per half: never smaller than what is stored
    const unsigned want = as_word(__hmax2(as_bf162(old), xv));
    if (want == old) return;
    const unsigned seen = atomicCAS(dst, old, want);
    if (seen == old) return;
    old = seen;  // another thread wrote in between: retry on its value
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
update_kernel(const unsigned* __restrict__ feat, const int* __restrict__ ids,
              unsigned* __restrict__ copies, int N, int num_cells, int words, int K,
              long long total) {
  const long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= total) return;
  const long long p = w / words;  // point b * N + n
  const int j = (int)(w % words);
  const int id = __ldg(ids + p);
  if (id < 0 || id >= num_cells) return;
  const int b = (int)(p / N);
  const int k = (int)(p % N) % K;
  const unsigned x = __ldg(feat + p * words + j);
  unsigned* dst = copies + (((size_t)b * K + k) * num_cells + id) * words + j;
  atomic_max_word(static_cast<T*>(nullptr), dst, x);
}

__device__ __forceinline__ unsigned max_word(float*, unsigned a, unsigned b) {
  return __float_as_uint(fmaxf(__uint_as_float(a), __uint_as_float(b)));
}

__device__ __forceinline__ unsigned max_word(__nv_bfloat16*, unsigned a, unsigned b) {
  return as_word(__hmax2(as_bf162(a), as_bf162(b)));
}

// out[b, c, :] = max over k of copies[b, k, c, :], 16 bytes a thread
template <typename T>
__global__ void __launch_bounds__(THREADS)
merge_kernel(const uint4* __restrict__ copies, uint4* __restrict__ out, int K,
             long long grid_vecs, long long total) {
  const long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= total) return;
  const long long b = w / grid_vecs;
  const long long i = w % grid_vecs;
  const uint4* src = copies + b * K * grid_vecs + i;
  uint4 m = src[0];
  for (int k = 1; k < K; ++k) {
    const uint4 x = src[(long long)k * grid_vecs];
    m.x = max_word(static_cast<T*>(nullptr), m.x, x.x);
    m.y = max_word(static_cast<T*>(nullptr), m.y, x.y);
    m.z = max_word(static_cast<T*>(nullptr), m.z, x.z);
    m.w = max_word(static_cast<T*>(nullptr), m.w, x.w);
  }
  out[w] = m;
}

long long blocks_for(long long threads) { return (threads + THREADS - 1) / THREADS; }

template <typename T>
int launch(const void* feat, const int* ids, void* copies, void* out, int B, int N,
           int num_cells, int C, int K, cudaStream_t stream) {
  const int words = C * (int)sizeof(T) / 4;  // 32-bit words a row
  const size_t grid_bytes = (size_t)num_cells * C * sizeof(T);
  cudaError_t err = cudaMemsetAsync(copies, 0, (size_t)B * K * grid_bytes, stream);
  if (err != cudaSuccess) return (int)err;
  const long long updates = (long long)B * N * words;
  if (updates > 0) {
    const long long blocks = blocks_for(updates);
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    update_kernel<T><<<(unsigned)blocks, THREADS, 0, stream>>>(
        static_cast<const unsigned*>(feat), ids, static_cast<unsigned*>(copies), N, num_cells,
        words, K, updates);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const long long grid_vecs = (long long)(grid_bytes / 16);
  const long long merges = (long long)B * grid_vecs;
  const long long blocks = blocks_for(merges);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  merge_kernel<T><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const uint4*>(copies), static_cast<uint4*>(out), K, grid_vecs, merges);
  return (int)cudaGetLastError();
}

}  // namespace

// feat (B, N, C) float32 or bfloat16, every value >= 0; ids (B, N) int32;
// copies (B, K, num_cells, C) scratch in feat's type; out (B, num_cells, C)
// in feat's type. C * itemsize must be a multiple of 16 bytes and the
// buffers 16-byte aligned. All contiguous on one device. Returns a
// cudaError_t value (0 on success).
extern "C" int streammos_scatter_max_copies(const void* feat, const void* ids, void* copies,
                                            void* out, int B, int N, int num_cells, int C,
                                            int K, int is_bf16, void* stream) {
  const int itemsize = is_bf16 ? 2 : 4;
  if (B < 1 || N < 0 || num_cells < 1 || C < 1 || K < 1 || (C * itemsize) % 16 ||
      (uintptr_t)feat % 16 || (uintptr_t)copies % 16 || (uintptr_t)out % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* i = static_cast<const int*>(ids);
  if (is_bf16) return launch<__nv_bfloat16>(feat, i, copies, out, B, N, num_cells, C, K, s);
  return launch<float>(feat, i, copies, out, B, N, num_cells, C, K, s);
}
