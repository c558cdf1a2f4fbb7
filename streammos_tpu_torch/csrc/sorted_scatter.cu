// Scatter-max of rows already sorted by cell id, for Hopper (sm_90a).
//
// Replaces the TPU kernel built by `_make_kernel` in
// streammos_tpu/ops/pallas_scatter.py (pallas_call in `sorted_scatter_max`),
// which `voxel_max_pool(impl="pallas")` reaches.
//
// What it computes: rows (P, C) sorted by cell id, ids (P,) ascending; for
// every cell c of [0, n_cells), out[c] = max of the rows with id c, or 0 if
// there are none. Negative maxima are kept. Ids outside [0, n_cells) (the
// sentinel n_cells sorts to the end) are dropped; a chunk of rows that holds
// only sentinel ids reads none of its rows.
//
// Bound: the rows of the points inside the grid, with their ids, are read
// once and the grid written once (at the full-grid site of a frame in bf16
// the grid is 406 MB and the rows under 246 MB), a few flops a byte, so the
// card's memory rate bounds it.
//
// Design: the work is cut by rows, not by cells, so that no thread walks
// more than ROWS rows however the points pile up (the range-skewed scans put
// thousands of points in a near cell, and a design that gave each thread a
// tile of cells waited on the densest tile's serial chain). One thread owns
// one 16-byte channel slice of one chunk of ROWS consecutive rows; the
// threads of a chunk are neighbours, so a warp reads whole rows, UNROLL rows
// (and their ids) in flight a thread, two blocks resident an SM. A thread keeps the running max of the current run of
// equal ids in registers. A run that starts and ends inside its chunk is
// written to its cell once. A run cut by a chunk boundary leaves its partial
// max in a carry slot (two a chunk: the first run, if it came from the chunk
// before, and the last, if it goes on into the next). The carry slots are
// again rows sorted by cell, with -1 in an unused slot, so the same kernel
// runs over them in chunks of CARRY_ROWS, and so on until one chunk is left:
// a cell that holds 160k rows costs 160k/ROWS partials and a few small
// levels, not one serial chain. A cell is written where its run first fits
// in a chunk, so exactly once, and marked in an occupancy bitmap (one bit a
// cell); a last, cell-parallel pass writes 0 to the unmarked cells, so an
// empty stretch of 10^5 cells costs no one thread more than one slice of
// one cell. Launches: a clear of the bitmap, the levels (5 for 160k rows),
// the zero pass. No atomics on the grid, no copies of it. (Measured on the
// card and dropped: 16 rows a round at one block an SM, 240 registers;
// 4 rows a round at three; an L2 bulk prefetch of each chunk; chunks of
// 32 or 128 rows; carry chunks of 32 or 128 rows.) The TPU kernel's
// mechanics (ids encoded in bf16 lanes, a Hillis-Steele roll scan, one-hot
// MXU placement, DMA double buffering) are not carried over.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = 64;         // rows a chunk of the sorted rows
constexpr int CARRY_ROWS = 16;   // rows a chunk of the carry slots
constexpr int UNROLL = 8;        // rows loaded together by one thread
constexpr int MIN_BLOCKS = 2;    // resident blocks an SM: at most 128 registers
constexpr int MAX_LEVELS = 16;   // 2**31 rows need 10

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

// a row slice, read once: 16 bytes are loaded as streamed (evict-first)
template <typename P>
__device__ __forceinline__ P load_once(const P* p) {
  if constexpr (sizeof(P) == 16) {
    const uint4 v = __ldcs(reinterpret_cast<const uint4*>(p));
    return *reinterpret_cast<const P*>(&v);
  } else {
    return *p;
  }
}

// One level: rows (n, C) with ids (n,), in chunks of R rows. carry and
// carry_ids hold 2 slots a chunk, or are null when there is one chunk.
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
run_kernel(const T* __restrict__ rows, const int* __restrict__ ids, int n, int R,
           T* __restrict__ out, unsigned* __restrict__ occupied, T* __restrict__ carry,
           int* __restrict__ carry_ids, int n_cells, int C) {
  using P = Pack<T, VEC>;
  const int nvec = C / VEC;
  const int chunks = (n + R - 1) / R;
  const long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= (long long)chunks * nvec) return;
  const int k = (int)(w / nvec);
  const int ch = (int)(w % nvec) * VEC;
  const bool lead = ch == 0;  // the thread that writes ids and bits
  const int lo = k * R;
  const int hi = min(lo + R, n);
  const int before = lo > 0 ? __ldg(ids + lo - 1) : -1;
  const int after = hi < n ? __ldg(ids + hi) : -1;
  if (lead && carry_ids != nullptr) {
    carry_ids[2 * k] = -1;
    carry_ids[2 * k + 1] = -1;
  }

  int cur = -1;   // cell of the current run, -1 outside any
  int start = 0;  // its first row
  P m;
  // the run [start, end) of cell cur is complete within this chunk
  auto flush = [&](int end) {
    const bool left = start == lo && cur == before;
    const bool right = end == hi && cur == after;
    if (!left && !right) {
      *reinterpret_cast<P*>(out + (size_t)cur * C + ch) = m;
      if (lead) atomicOr(occupied + (cur >> 5), 1u << (cur & 31));
      return;
    }
    if (left) {
      *reinterpret_cast<P*>(carry + (size_t)(2 * k) * C + ch) = m;
      if (lead) carry_ids[2 * k] = cur;
    }
    if (right) {
      *reinterpret_cast<P*>(carry + (size_t)(2 * k + 1) * C + ch) = m;
      if (lead) carry_ids[2 * k + 1] = cur;
    }
  };

  // a chunk of sentinel rows (sorted to the end) reads nothing more
  if (lo < hi && __ldg(ids + lo) >= n_cells) return;
  for (int r0 = lo; r0 < hi; r0 += UNROLL) {
    int idb[UNROLL];
    P xb[UNROLL];
    // ids and rows together, so a round waits on one round trip
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int r = r0 + u;
      idb[u] = -1;
      if (r < hi) {
        idb[u] = __ldg(ids + r);
        xb[u] = load_once(reinterpret_cast<const P*>(rows + (size_t)r * C + ch));
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (r0 + u >= hi) break;
      const int id = idb[u] >= 0 && idb[u] < n_cells ? idb[u] : -1;
      if (id >= 0 && id == cur) {
        m = pmax(m, xb[u]);
        continue;
      }
      if (cur >= 0) flush(r0 + u);
      cur = id;
      start = r0 + u;
      if (id >= 0) m = xb[u];
    }
  }
  if (cur >= 0) flush(hi);
}

// out[c] = 0 for every cell c not marked in `occupied`
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
zero_kernel(T* __restrict__ out, const unsigned* __restrict__ occupied, int n_cells, int C) {
  using P = Pack<T, VEC>;
  const int nvec = C / VEC;
  const long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= (long long)n_cells * nvec) return;
  const int c = (int)(w / nvec);
  if ((__ldg(occupied + (c >> 5)) >> (c & 31)) & 1u) return;
  P zero;
#pragma unroll
  for (int i = 0; i < VEC; ++i) zero.v[i] = zero_of(T());
  *reinterpret_cast<P*>(out + (size_t)c * C + (w % nvec) * VEC) = zero;
}

size_t align16(size_t b) { return (b + 15) / 16 * 16; }

// The levels and the workspace: the bitmap, then each level's carry ids and
// carry rows (none at the last level).
struct Plan {
  int levels = 0;
  int n[MAX_LEVELS], R[MAX_LEVELS], chunks[MAX_LEVELS];
  size_t ids_at[MAX_LEVELS], rows_at[MAX_LEVELS];
  size_t bytes = 0;
};

Plan make_plan(long long P, int n_cells, int C, int itemsize) {
  Plan p;
  p.bytes = align16((size_t)((n_cells + 31) / 32) * 4);
  long long n = P;
  int R = ROWS;
  while (n > 0 && p.levels < MAX_LEVELS) {
    const int l = p.levels++;
    p.n[l] = (int)n;
    p.R[l] = R;
    p.chunks[l] = (int)((n + R - 1) / R);
    p.ids_at[l] = p.rows_at[l] = 0;
    if (p.chunks[l] == 1) break;
    p.ids_at[l] = p.bytes;
    p.bytes += align16((size_t)p.chunks[l] * 2 * 4);
    p.rows_at[l] = p.bytes;
    p.bytes += align16((size_t)p.chunks[l] * 2 * C * itemsize);
    n = 2LL * p.chunks[l];
    R = CARRY_ROWS;
  }
  return p;
}

long long blocks_for(long long threads) { return (threads + THREADS - 1) / THREADS; }

template <typename T, int VEC>
int launch(const void* feats, const int* ids, int P, void* out, int n_cells, int C, char* work,
           cudaStream_t stream) {
  const Plan plan = make_plan(P, n_cells, C, (int)sizeof(T));
  if (plan.levels == MAX_LEVELS && plan.chunks[MAX_LEVELS - 1] > 1)
    return (int)cudaErrorInvalidValue;
  const int nvec = C / VEC;
  unsigned* occupied = reinterpret_cast<unsigned*>(work);
  cudaError_t err =
      cudaMemsetAsync(occupied, 0, (size_t)((n_cells + 31) / 32) * 4, stream);
  if (err != cudaSuccess) return (int)err;
  const T* rows = static_cast<const T*>(feats);
  const int* lids = ids;
  for (int l = 0; l < plan.levels; ++l) {
    const bool last = plan.chunks[l] == 1;
    T* carry = last ? nullptr : reinterpret_cast<T*>(work + plan.rows_at[l]);
    int* carry_ids = last ? nullptr : reinterpret_cast<int*>(work + plan.ids_at[l]);
    const long long blocks = blocks_for((long long)plan.chunks[l] * nvec);
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    run_kernel<T, VEC><<<(unsigned)blocks, THREADS, 0, stream>>>(
        rows, lids, plan.n[l], plan.R[l], static_cast<T*>(out), occupied, carry, carry_ids,
        n_cells, C);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    rows = carry;
    lids = carry_ids;
  }
  const long long blocks = blocks_for((long long)n_cells * nvec);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  zero_kernel<T, VEC><<<(unsigned)blocks, THREADS, 0, stream>>>(static_cast<T*>(out), occupied,
                                                                n_cells, C);
  return (int)cudaGetLastError();
}

template <typename T>
bool wide(const void* feats, const void* out, int C) {
  constexpr int V16 = 16 / sizeof(T);  // channels in 16 bytes
  return (uintptr_t)feats % 16 == 0 && (uintptr_t)out % 16 == 0 && C % V16 == 0;
}

template <typename T>
int dispatch(const void* feats, const int* ids, int P, void* out, int n_cells, int C,
             char* work, cudaStream_t stream) {
  if (wide<T>(feats, out, C))
    return launch<T, 16 / sizeof(T)>(feats, ids, P, out, n_cells, C, work, stream);
  return launch<T, 1>(feats, ids, P, out, n_cells, C, work, stream);
}

}  // namespace

// The workspace bytes `streammos_sorted_scatter_max` needs for P rows of C
// channels of `itemsize` bytes into n_cells cells; info, when not null,
// receives the number of levels, the first level's chunks, its threads on
// the 16-byte path and its rows a chunk.
extern "C" long long streammos_sorted_scatter_plan(int P, int n_cells, int C, int itemsize,
                                                   int* info) {
  if (P < 0 || n_cells < 1 || C < 1 || (itemsize != 2 && itemsize != 4)) return -1;
  const Plan p = make_plan(P, n_cells, C, itemsize);
  if (info != nullptr) {
    const int v16 = 16 / itemsize;
    info[0] = p.levels;
    info[1] = p.levels ? p.chunks[0] : 0;
    info[2] = p.levels ? p.chunks[0] * (C % v16 == 0 ? C / v16 : C) : 0;
    info[3] = ROWS;
  }
  return (long long)p.bytes;
}

// feats (P, C) float32 or bfloat16 rows sorted by cell id; ids (P,) int32
// ascending; out (n_cells, C) in feats' type, every cell written; work the
// 16-byte aligned workspace of `streammos_sorted_scatter_plan` bytes. All
// contiguous on one device. Returns a cudaError_t value (0 on success).
extern "C" int streammos_sorted_scatter_max(const void* feats, const void* ids, int P, void* out,
                                            int n_cells, int C, void* work, int is_bf16,
                                            void* stream) {
  if (P < 0 || n_cells < 1 || C < 1 || (uintptr_t)work % 16) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* i = static_cast<const int*>(ids);
  char* wk = static_cast<char*>(work);
  if (is_bf16) return dispatch<__nv_bfloat16>(feats, i, P, out, n_cells, C, wk, s);
  return dispatch<float>(feats, i, P, out, n_cells, C, wk, s);
}
