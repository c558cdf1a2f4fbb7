// Scatter-max of rows already sorted by cell id, for Hopper (sm_90a).
//
// Replaces the TPU kernel built by `_make_kernel` in
// streammos_tpu/ops/pallas_scatter.py (pallas_call in `sorted_scatter_max`),
// which `voxel_max_pool(impl="pallas")` reaches.
//
// What it computes: rows (P, C) sorted by cell id, ids (P,) ascending; for
// every cell c of [0, n_cells), out[c] = max of the rows with id c, or 0 if
// there are none. Negative maxima are kept. The caller finds, for tile t of
// `tile` cells, the rows [starts[t], starts[t+1]) whose ids lie in the tile
// (a searchsorted of the tile bounds, the last bound clamped to n_cells), so
// sentinel and out-of-range ids fall outside every tile.
//
// Bound: the rows of the points inside the grid, with their ids, are read
// once and the grid written once (rows outside fall in no tile and are never
// read; at the full-grid site of a frame in bf16 the grid alone is 406 MB
// and the rows under 246 MB), a few flops a byte, so
// the card's memory rate bounds it. The design moves each byte once and no
// more: one thread owns one 16-byte slice of channels of one tile and walks
// the tile's contiguous rows in order, keeping the running max of the
// current run in registers; when the id changes it writes the run's cell
// and zeroes the empty cells before it, so every cell of the tile is written
// exactly once. Neighbouring threads take neighbouring channel slices of a
// row, so a warp reads and writes whole rows. No atomics, no zero-fill pass,
// no second pass. A run is walked by one thread, so a cell that gathers
// thousands of points (the range-skewed scans pile points into near cells)
// is a serial chain; rows are loaded UNROLL at a time to keep loads in
// flight along it. The TPU kernel's mechanics (ids encoded in bf16 lanes, a
// Hillis-Steele roll scan, one-hot MXU placement, DMA double buffering) are
// not carried over.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;  // rows loaded together by one thread

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

__device__ __forceinline__ float zero_of(float) { return 0.0f; }
__device__ __forceinline__ __nv_bfloat16 zero_of(__nv_bfloat16) { return __float2bfloat16(0.0f); }

__device__ __forceinline__ float vmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ __nv_bfloat16 vmax(__nv_bfloat16 a, __nv_bfloat16 b) {
  return __hmax(a, b);
}

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> pmax(Pack<T, VEC> a, const Pack<T, VEC>& b) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) a.v[i] = vmax(a.v[i], b.v[i]);
  return a;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
sorted_scatter_max_kernel(const T* __restrict__ feats, const int* __restrict__ ids,
                          const int* __restrict__ starts, T* __restrict__ out, int n_cells,
                          int C, int tile, int n_tiles) {
  using P = Pack<T, VEC>;
  const int nvec = C / VEC;
  const long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= (long long)n_tiles * nvec) return;
  const int t = (int)(w / nvec);
  const int ch = (int)(w % nvec) * VEC;
  const int c_end = min((t + 1) * tile, n_cells);
  const int r_end = starts[t + 1];
  int next = t * tile;  // first cell of the tile not written yet
  int cur = -1;         // cell of the current run
  P m;
  P zero;
#pragma unroll
  for (int i = 0; i < VEC; ++i) zero.v[i] = zero_of(T());

  for (int r = starts[t]; r < r_end; r += UNROLL) {
    int idb[UNROLL];
    P xb[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      idb[u] = -1;
      if (r + u < r_end) {
        idb[u] = __ldg(ids + r + u);
        xb[u] = *reinterpret_cast<const P*>(feats + (size_t)(r + u) * C + ch);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int id = idb[u];
      if (id < 0) break;
      if (id == cur) {
        m = pmax(m, xb[u]);
        continue;
      }
      if (cur >= 0) *reinterpret_cast<P*>(out + (size_t)cur * C + ch) = m;
      for (; next < id; ++next) *reinterpret_cast<P*>(out + (size_t)next * C + ch) = zero;
      next = id + 1;
      cur = id;
      m = xb[u];
    }
  }
  if (cur >= 0) *reinterpret_cast<P*>(out + (size_t)cur * C + ch) = m;
  for (; next < c_end; ++next) *reinterpret_cast<P*>(out + (size_t)next * C + ch) = zero;
}

template <typename T, int VEC>
int launch(const void* feats, const int* ids, const int* starts, void* out, int n_cells, int C,
           int tile, cudaStream_t stream) {
  const int n_tiles = (n_cells + tile - 1) / tile;
  const long long threads = (long long)n_tiles * (C / VEC);
  const long long blocks = (threads + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  sorted_scatter_max_kernel<T, VEC><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(feats), ids, starts, static_cast<T*>(out), n_cells, C, tile,
      n_tiles);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* feats, const int* ids, const int* starts, void* out, int n_cells,
             int C, int tile, cudaStream_t stream) {
  constexpr int V16 = 16 / sizeof(T);  // channels in 16 bytes
  const bool aligned = ((uintptr_t)feats % 16 == 0) && ((uintptr_t)out % 16 == 0);
  if (aligned && C % V16 == 0)
    return launch<T, V16>(feats, ids, starts, out, n_cells, C, tile, stream);
  return launch<T, 1>(feats, ids, starts, out, n_cells, C, tile, stream);
}

}  // namespace

// feats (P, C) float32 or bfloat16 rows sorted by cell id; ids (P,) int32
// ascending; starts (ceil(n_cells / tile) + 1,) int32 row bounds of the
// tiles; out (n_cells, C) in feats' type, every cell written. All contiguous
// on one device. Returns a cudaError_t value (0 on success).
extern "C" int streammos_sorted_scatter_max(const void* feats, const void* ids,
                                            const void* starts, void* out, int n_cells, int C,
                                            int tile, int is_bf16, void* stream) {
  if (n_cells < 1 || C < 1 || tile < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* i = static_cast<const int*>(ids);
  const int* st = static_cast<const int*>(starts);
  if (is_bf16) return dispatch<__nv_bfloat16>(feats, i, st, out, n_cells, C, tile, s);
  return dispatch<float>(feats, i, st, out, n_cells, C, tile, s);
}
