// Folded TTA scatter-max of non-negative rows, for Hopper (sm_90a):
// `voxel_max_pool_tta` on CUDA tensors, in one pass from the points' float32
// coordinates straight into the layout the next consumer reads.
//
// Replaces no TPU kernel: the JAX package's `voxel_max_pool_tta`
// (streammos_tpu/ops/tta_fold.py) is an XLA scatter and its flips. It
// replaces the port's chain of PyTorch ops (the cell ids as about 20
// elementwise ops, a zero grid with a sentinel row, `scatter_reduce_(amax)`,
// then a flip, roll and stack of the variants' grids: about 30 launches a
// site), kept as the plain version `voxel_max_pool_tta_reference`.
//
// What it computes: feat (B, N, V*C), V = 4 variants as v-major blocks of C
// channels, every value >= 0; coords (B, N, >= 2) variant-0 coordinates in
// float32. A point's cell is r = int(coords[0] * sy), q = int(coords[1] *
// sx), each product rounded to float32 and truncated toward zero (the
// card's float-to-int conversion, which saturates: `_cell_ids` on a CUDA
// tensor); the point is kept iff 0 <= r < H and 0 <= q < W, and a dropped
// point's row is never read. Two layouts of the output, zeroed, into which
// every kept row is maxed:
// - variants: (V, B, H, W, C), variant v's channels in its own grid at the
//   cell `orient_grid(., v, kind)` maps (r, q) to. BEV: rows reversed for v
//   >> 1, columns for v & 1. RV: rows kept, columns id, revroll, rev, roll
//   for v = 0..3 (rev q -> W-1-q, roll q -> (q + W/2) mod W, revroll q ->
//   (W/2 - 1 - q) mod W).
// - phase-outer: (B, 4, H/2 + 2, W/2, V*C), the whole row at the canonical
//   cell in `voxel_max_pool(..., phase_split="outer", row_pad=1)`'s layout:
//   plane 2*(r & 1) + (q & 1), row (r >> 1) + 1, column q >> 1; the pad row
//   above and below each plane stays 0.
// Max is exact and does not depend on order, so the output equals the
// plain version's in value (+0 and -0 alike).
//
// Bound: the card's memory. The rows, the coordinates and the grid each
// once (at the five sites of a StreamMOS_seg frame, 160k points, bf16: 492
// MB of rows, 9 MB of coordinates, 444 MB of grids, of which the full grid
// is 406 MB; 944 MB, 0.282 ms at 3.35 TB/s); a max a byte.
//
// Design: scatter_grid.cu's, with the cell ids and the variants'
// orientation inside and without its read before each update (below). One
// thread owns one 16-byte channel slice of GROUP consecutive points:
// neighbouring threads take neighbouring slices, so a warp reads whole
// rows, streamed (they must not push the grid out of L2).
// A slice never crosses a variant's block (C * itemsize is a multiple of 16
// bytes), so it has one destination, and the thread's variant, hence its
// transforms, is fixed. Each thread computes its points' cells from the
// coordinates (a broadcast load within the row's threads) and their
// destinations; rows with one destination are maxed in registers first.
// Each remaining slice is one fire-and-forget 16-byte `red.global...max` of
// four bf16 pairs, or in float32 an integer `atomicMax` on each 32-bit word
// (for x >= 0 float order is integer order), which the L2 resolves; a slice
// or word that is all zero raises nothing over the zeroed grid and is
// skipped. Launches: a memset of the output, the update pass. The cascade
// grids (8-17 MB at Bt = 1) stay in the 50 MB L2; the full grid does not,
// and its zeroing is part of the bound, since the header reads every cell.
// (Measured on the card at the five sites of a StreamMOS_seg step, bf16, Bt
// = 1 and 4, and dropped: scatter_grid.cu's read of the stored slice before
// each update, skipped when it would raise nothing, 3-32% slower at every
// site, since a thread then waits on the read; on top of it, on the full
// grid, evict-first L2 hints on those reads and reductions, 2-4% slower
// again, and all of a thread's reads issued before its first reduction,
// 11-12% slower; evict-first hints on the reductions alone, 2-6% slower
// than none.)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int V_TTA = 4;
constexpr int THREADS = 256;
constexpr int GROUP = 8;  // consecutive points a thread takes

enum Transform { ID = 0, REV = 1, ROLL = 2, REVROLL = 3 };

// variant v's transforms of the rows and the columns; the plain version's
// _BEV_TRANSFORMS and _RV_TRANSFORMS
__device__ __forceinline__ void transforms(int is_rv, int v, int& tr, int& tq) {
  if (!is_rv) {
    tr = (v >> 1) ? REV : ID;
    tq = (v & 1) ? REV : ID;
  } else {
    tr = ID;
    tq = v == 0 ? ID : v == 1 ? REVROLL : v == 2 ? REV : ROLL;
  }
}

// the variant's cell of canonical cell c in [0, size); size is even
__device__ __forceinline__ int orient(int tr, int c, int size) {
  const int half = size >> 1;
  switch (tr) {
    case REV: return size - 1 - c;
    case ROLL: return c < half ? c + half : c - half;
    case REVROLL: return c < half ? half - 1 - c : size + half - 1 - c;
    default: return c;
  }
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

// raise dst, which started at +0, to at least x >= 0, elementwise; a word
// of +0 or -0 raises nothing
__device__ __forceinline__ void raise_to(float*, uint4* dst, uint4 x) {
  int* d = reinterpret_cast<int*>(dst);
  const int xv[4] = {(int)x.x, (int)x.y, (int)x.z, (int)x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (xv[i] > 0) atomicMax(d + i, xv[i]);
}

__device__ __forceinline__ void raise_to(__nv_bfloat16*, uint4* dst, uint4 x) {
  if (((x.x | x.y | x.z | x.w) & 0x7fff7fffu) == 0) return;
  asm volatile("red.global.v4.bf16x2.max.noftz [%0], {%1, %2, %3, %4};" ::"l"(dst), "r"(x.x),
               "r"(x.y), "r"(x.z), "r"(x.w)
               : "memory");
}

struct Shape {
  long long points, threads;  // B * N; threads of the update pass
  int B, N, H, W, is_rv;
  int nvec;              // 16-byte slices of a feature row
  int lanes;             // slices of one variant's C channels
  long long fb, fn;      // feature strides in 16-byte slices
  long long cb, cn, ck;  // coordinate strides in floats
  float sy, sx;
};

template <typename T, bool OUTER>
__global__ void __launch_bounds__(THREADS)
update_kernel(const uint4* __restrict__ feat, const float* __restrict__ coords,
              uint4* __restrict__ out, Shape s) {
  const long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= s.threads) return;
  const long long g = w / s.nvec;
  const int j = (int)(w - g * s.nvec);
  // the slice's variant and its place in that variant's C channels
  const int v = j / s.lanes, lane = j - v * s.lanes;
  int tr = ID, tq = ID;
  if (!OUTER) transforms(s.is_rv, v, tr, tq);
  const int rows = (s.H >> 1) + 2, wh = s.W >> 1;  // phase-outer plane
  const long long p0 = g * GROUP;
  int b = (int)(p0 / s.N), n = (int)(p0 - (long long)b * s.N);
  long long key[GROUP];  // the destination cell, in rows of the output, or -1
  uint4 x[GROUP];
#pragma unroll
  for (int u = 0; u < GROUP; ++u) {
    key[u] = -1;
    if (p0 + u < s.points) {
      const float* c = coords + b * s.cb + n * s.cn;
      const int r = __float2int_rz(__fmul_rn(__ldg(c), s.sy));
      const int q = __float2int_rz(__fmul_rn(__ldg(c + s.ck), s.sx));
      if ((unsigned)r < (unsigned)s.H && (unsigned)q < (unsigned)s.W) {
        if (OUTER)
          key[u] = (((long long)b * 4 + 2 * (r & 1) + (q & 1)) * rows + (r >> 1) + 1) * wh +
                   (q >> 1);
        else
          key[u] = (((long long)v * s.B + b) * s.H + orient(tr, r, s.H)) * s.W +
                   orient(tq, q, s.W);
        x[u] = __ldcs(feat + b * s.fb + n * s.fn + j);
      }
      if (++n == s.N) {
        n = 0;
        ++b;
      }
    }
  }
#pragma unroll
  for (int u = 0; u < GROUP; ++u) {
#pragma unroll
    for (int k = u + 1; k < GROUP; ++k) {
      if (key[k] >= 0 && key[k] == key[u]) {
        x[u] = max_vec<T>(x[u], x[k]);
        key[k] = -1;
      }
    }
  }
  // a row of the output: the whole V*C row (phase-outer), or C channels
  const int row_vec = OUTER ? s.nvec : s.lanes, at = OUTER ? j : lane;
#pragma unroll
  for (int u = 0; u < GROUP; ++u)
    if (key[u] >= 0) raise_to(static_cast<T*>(nullptr), out + key[u] * row_vec + at, x[u]);
}

template <typename T>
int launch(const void* feat, const float* coords, void* out, size_t out_bytes, Shape s,
           int outer, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(out, 0, out_bytes, stream);
  if (err != cudaSuccess) return (int)err;
  if (s.points == 0) return 0;
  s.threads = (s.points + GROUP - 1) / GROUP * s.nvec;
  const long long blocks = (s.threads + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const uint4* f = static_cast<const uint4*>(feat);
  uint4* o = static_cast<uint4*>(out);
  if (outer)
    update_kernel<T, true><<<(unsigned)blocks, THREADS, 0, stream>>>(f, coords, o, s);
  else
    update_kernel<T, false><<<(unsigned)blocks, THREADS, 0, stream>>>(f, coords, o, s);
  return (int)cudaGetLastError();
}

}  // namespace

// feat: (B, N, 4*C) float32 or bfloat16, every value >= 0, the channels
// innermost, strides feat_strides[0..1] in elements, its address and
// strides multiples of 16 bytes. coords: float32 (B, N, >= 2), strides
// coord_strides[0..2] in elements. (H, W) the grid, both even; (sy, sx)
// the coordinates' scale; kind 0 = BEV, 1 = RV. out, contiguous in feat's
// type and 16-byte aligned: (4, B, H, W, C) for outer = 0, (B, 4, H/2 + 2,
// W/2, 4*C) for outer = 1. C * itemsize must be a multiple of 16 bytes.
// Launches a memset of out and the update pass on `stream` and does not
// synchronise. Returns a cudaError_t value (0 on success).
extern "C" int streammos_scatter_tta(const void* feat, const void* coords, void* out, int B,
                                     int N, int H, int W, int C,
                                     const long long* feat_strides,
                                     const long long* coord_strides, float sy, float sx,
                                     int kind, int outer, int is_bf16, void* stream) {
  const int itemsize = is_bf16 ? 2 : 4;
  const long long fb = feat_strides[0], fn = feat_strides[1];
  if (B < 1 || N < 0 || H < 2 || W < 2 || H % 2 || W % 2 || C < 1 || (C * itemsize) % 16 ||
      (fb * itemsize) % 16 || (fn * itemsize) % 16 || (uintptr_t)feat % 16 ||
      (uintptr_t)out % 16 || (kind != 0 && kind != 1) || (outer != 0 && outer != 1))
    return (int)cudaErrorInvalidValue;
  const size_t cells = outer ? (size_t)B * 4 * (H / 2 + 2) * (W / 2) : (size_t)V_TTA * B * H * W;
  Shape s;
  s.points = (long long)B * N;
  s.B = B;
  s.N = N;
  s.H = H;
  s.W = W;
  s.is_rv = kind;
  s.lanes = C * itemsize / 16;
  s.nvec = V_TTA * s.lanes;
  s.fb = fb * itemsize / 16;
  s.fn = fn * itemsize / 16;
  s.cb = coord_strides[0];
  s.cn = coord_strides[1];
  s.ck = coord_strides[2];
  s.sy = sy;
  s.sx = sx;
  // a cell holds all variants' channels (phase-outer) or one variant's
  const size_t out_bytes = cells * (outer ? V_TTA * C : C) * itemsize;
  const float* c = static_cast<const float*>(coords);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch<__nv_bfloat16>(feat, c, out, out_bytes, s, outer, st);
  return launch<float>(feat, c, out, out_bytes, s, outer, st);
}
