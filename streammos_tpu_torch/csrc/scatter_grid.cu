// Scatter-max of non-negative rows into one zeroed grid, resolved in L2, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` of streammos_tpu/ops/pallas_scatter_vmem.py
// (pallas_call in `scatter_max_vmem`), which `voxel_max_pool(impl="vmem")`
// reaches.
//
// What it computes: feat (B, N, C) with every value >= 0, ids (B, N); for
// every batch b and cell c of [0, num_cells), out[b, c] = max(0, the rows of
// batch b with id c). Ids outside [0, num_cells), of either sign, are the
// sentinel row: dropped, and their rows never read.
//
// Bound: every id is read once, the row of each point inside the grid once,
// and the grid written once (4-17 MB grids at the four cascade sites of a
// frame, under 41-82 MB of rows in bf16), a few flops a byte, so the card's
// memory rate bounds it.
//
// Design: the TPU kernel kept K copies of the grid in VMEM so that K
// read-max-write chains overlap. Here there is one grid, the output itself:
// it is zeroed, and the rows are maxed straight into it with atomics, which
// the 50 MB L2 resolves (the cascade grids fit in it; the rows are loaded as
// streamed so that they do not push it out). No scratch copies, no merge
// pass. One thread owns one 16-byte channel slice of GROUP consecutive
// points (neighbouring threads take neighbouring slices, so a warp reads
// whole rows, GROUP rows in flight a thread). Within the group, rows of the
// same cell are maxed together in registers first, so a run of points in one
// cell makes one update, not GROUP. An update reads the stored 16 bytes
// first (from L2) and is skipped when it would raise nothing: in a cell that
// gathers thousands of points the running max stops rising after a few, so
// the skewed near cells see few atomics. An update that is needed is one
// 16-byte `red.global...max` of four bf16 pairs (sm_90), or, in float32, an
// integer `atomicMax` on each 32-bit word that needs it (for x >= 0 float
// order is integer order). Launches: a memset of the grid, the update pass.
// (Measured on the card and dropped: issuing every stored-value read with
// the row loads, before the first atomic; groups of 4 or 16 points; no
// read-first skip. Each was slower at the cascade sites.)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int THREADS = 256;
constexpr int GROUP = 8;  // consecutive points a thread takes

// threads of the update pass: one a 16-byte slice of GROUP points
__host__ __device__ __forceinline__ long long update_threads(long long points, int nvec) {
  return (points + GROUP - 1) / GROUP * nvec;
}

__device__ __forceinline__ unsigned max_word(float*, unsigned a, unsigned b) {
  return __float_as_uint(fmaxf(__uint_as_float(a), __uint_as_float(b)));
}

__device__ __forceinline__ unsigned max_word(__nv_bfloat16*, unsigned a, unsigned b) {
  __nv_bfloat162 x, y;
  memcpy(&x, &a, sizeof(x));
  memcpy(&y, &b, sizeof(y));
  x = __hmax2(x, y);
  memcpy(&a, &x, sizeof(a));
  return a;
}

template <typename T>
__device__ __forceinline__ uint4 max_vec(uint4 a, uint4 b) {
  return make_uint4(max_word(static_cast<T*>(nullptr), a.x, b.x),
                    max_word(static_cast<T*>(nullptr), a.y, b.y),
                    max_word(static_cast<T*>(nullptr), a.z, b.z),
                    max_word(static_cast<T*>(nullptr), a.w, b.w));
}

// raise dst to at least x, elementwise; seen is a value dst held
__device__ __forceinline__ void raise_to(float*, uint4* dst, uint4 x, uint4 seen) {
  int* d = reinterpret_cast<int*>(dst);
  const int xv[4] = {(int)x.x, (int)x.y, (int)x.z, (int)x.w};
  const int sv[4] = {(int)seen.x, (int)seen.y, (int)seen.z, (int)seen.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (xv[i] > sv[i]) atomicMax(d + i, xv[i]);
}

__device__ __forceinline__ void raise_to(__nv_bfloat16*, uint4* dst, uint4 x, uint4 seen) {
  const uint4 want = max_vec<__nv_bfloat16>(seen, x);
  if (want.x == seen.x && want.y == seen.y && want.z == seen.z && want.w == seen.w) return;
  asm volatile("red.global.v4.bf16x2.max.noftz [%0], {%1, %2, %3, %4};" ::"l"(dst), "r"(x.x),
               "r"(x.y), "r"(x.z), "r"(x.w)
               : "memory");
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
update_kernel(const uint4* __restrict__ feat, const int* __restrict__ ids, uint4* __restrict__ out,
              long long points, int N, int num_cells, int nvec) {
  const long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= update_threads(points, nvec)) return;
  const long long p0 = w / nvec * GROUP;
  const int j = (int)(w % nvec);
  long long key[GROUP];  // b * num_cells + id, or -1 for a dropped point
  uint4 x[GROUP];
#pragma unroll
  for (int u = 0; u < GROUP; ++u) {
    const long long p = p0 + u;
    key[u] = -1;
    if (p < points) {
      const int id = __ldg(ids + p);
      if (id >= 0 && id < num_cells) {
        key[u] = p / N * num_cells + id;
        x[u] = __ldcs(feat + p * nvec + j);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < GROUP; ++u) {
#pragma unroll
    for (int v = u + 1; v < GROUP; ++v) {
      if (key[v] >= 0 && key[v] == key[u]) {
        x[u] = max_vec<T>(x[u], x[v]);
        key[v] = -1;
      }
    }
  }
#pragma unroll
  for (int u = 0; u < GROUP; ++u) {
    if (key[u] < 0) continue;
    uint4* dst = out + key[u] * nvec + j;
    raise_to(static_cast<T*>(nullptr), dst, x[u], __ldcg(dst));
  }
}

template <typename T>
int launch(const void* feat, const int* ids, void* out, int B, int N, int num_cells, int C,
           cudaStream_t stream) {
  const int nvec = C * (int)sizeof(T) / 16;  // 16-byte slices a row
  cudaError_t err =
      cudaMemsetAsync(out, 0, (size_t)B * num_cells * C * sizeof(T), stream);
  if (err != cudaSuccess) return (int)err;
  const long long points = (long long)B * N;
  if (points == 0) return 0;
  const long long threads = update_threads(points, nvec);
  const long long blocks = (threads + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  update_kernel<T><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const uint4*>(feat), ids, static_cast<uint4*>(out), points, N, num_cells,
      nvec);
  return (int)cudaGetLastError();
}

}  // namespace

// The launch shape of `streammos_scatter_max_grid` for `points` (B * N)
// points of C channels of `itemsize` bytes: info receives the copies of the
// grid it keeps (1, the output itself), the points a thread takes and the
// threads of the update pass. Returns 0, or -1 for a shape it does not take.
extern "C" int streammos_scatter_grid_plan(long long points, int C, int itemsize,
                                           long long* info) {
  if (points < 0 || C < 1 || (itemsize != 2 && itemsize != 4) || (C * itemsize) % 16) return -1;
  info[0] = 1;
  info[1] = GROUP;
  info[2] = update_threads(points, C * itemsize / 16);
  return 0;
}

// feat (B, N, C) float32 or bfloat16, every value >= 0; ids (B, N) int32;
// out (B, num_cells, C) in feat's type. C * itemsize must be a multiple of
// 16 bytes and both buffers 16-byte aligned. All contiguous on one device.
// Returns a cudaError_t value (0 on success).
extern "C" int streammos_scatter_max_grid(const void* feat, const void* ids, void* out, int B,
                                          int N, int num_cells, int C, int is_bf16,
                                          void* stream) {
  const int itemsize = is_bf16 ? 2 : 4;
  if (B < 1 || N < 0 || num_cells < 1 || C < 1 || (C * itemsize) % 16 ||
      (uintptr_t)feat % 16 || (uintptr_t)out % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* i = static_cast<const int*>(ids);
  if (is_bf16) return launch<__nv_bfloat16>(feat, i, out, B, N, num_cells, C, s);
  return launch<float>(feat, i, out, B, N, num_cells, C, s);
}
