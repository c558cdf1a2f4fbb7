// Bilinear gather of the four folded TTA variants' grids at the points, for
// Hopper (sm_90a): `grid_to_point_tta` on CUDA tensors.
//
// Replaces no TPU kernel: the JAX package's `grid_to_point_tta`
// (streammos_tpu/ops/tta_fold.py) is plain XLA. It replaces the port's chain
// of PyTorch ops (an extended table a variant, their stack, four row
// gathers, per-variant weights and blends: about 150 small ops a site),
// which is kept as the plain version `grid_to_point_tta_reference`.
//
// What it computes: grids (V = 4, B, H, W, C), each variant's grid in its
// own orientation; coords (B, N, >= 2) variant-0 coordinates in unscaled
// grid units. For each point, py = coords[0] * sy and px = coords[1] * sx in
// float32, the canonical window y0 = floor(py), x0 = floor(px), and for each
// variant v the two taps of each axis at canonical positions (x0 + s, x0 +
// 1 + s), s = -1 for the reversed transforms and 0 otherwise, weighted
// (1 - f, f), f = px - x0. A tap reads the variant's own cell of that
// canonical position (rev: size-1-q; roll: (q + size/2) mod size; revroll:
// size-1-((q + size/2) mod size)), and is dropped where the plain version's
// `_axis_weights` drops it: outside the grid, and on the wrap seams of the
// rolled axes (roll's second tap at x0 == size/2-1, revroll's first at x0
// == size/2). A point whose window lies outside [-1, H] x [-1, W] (the
// plain version's clamp guard) gets a zero row. out (B, N, V*C), variants
// v-major, in the grid's type.
//
// Arithmetic: the weights and the sum in float32 registers, each step
// rounded once as the plain version's float32 ops round (no contraction
// into FMAs), the four taps summed in the plain version's order; the row is
// rounded to the grid's type once. In float32 that is the plain version's
// arithmetic; in bf16 it is the plain version run in float32 on the same
// bf16 grid, then rounded (the plain bf16 version rounds at each of its 16
// products and sums).
//
// Bound: the card's memory. Each grid is read once and each output row
// written once (at the five sites of a StreamMOS_seg frame, 160k points, bf16:
// 71.3 MB of grids, 6.4 MB of coordinates, 328 MB of rows, so 406 MB, 0.121
// ms at 3.35 TB/s); a few flops a byte. The output is most of it.
//
// Design: a point's V*C output row is V * lanes neighbouring threads, each
// taking two 16-byte slices of one variant's C channels (slices i and i +
// lanes, so every load and store of a warp is contiguous), written with
// streaming stores that keep the grids in L2. Each thread forms its
// point's window and its variant's four tap weights and cells itself, with
// selects rather than branches (the variants of a warp take other
// transforms; the coordinates are a broadcast load), issues its eight
// 16-byte tap loads together, and sums in registers: no table, no
// intermediate in device memory, no atomics, so the result is
// deterministic. Taps read the variant grids through their strides, so the
// conv outputs' channels-last views are read in place. A grid whose
// channels are not its innermost axis (an NCHW conv output viewed as (V, B,
// H, W, C)) is first rewritten channels-last into a scratch buffer by a
// tiled transpose through shared memory (one read, one write of the grid;
// 64 columns by 64 channels a block), which lets the taps load 16 bytes of
// channels at once: two launches at such a site, one at the others.
// (Measured on the card and dropped: one 16-byte slice a thread, with
// 64-bit index arithmetic and branches on the transform, 1.5x slower at
// the five sites; 32 x 32 transpose tiles.)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int V_TTA = 4;
constexpr int THREADS = 256;
constexpr int TILE_COLS = 64;  // transpose tile: TILE_COLS columns x TILE_CH channels
constexpr int TILE_CH = 64;
constexpr int TILE_ROWS = 4;   // threadIdx.y extent of the transpose (x: TILE_COLS)

enum Transform { ID = 0, REV = 1, ROLL = 2, REVROLL = 3 };

// variant v's transforms of axis 1 (rows) and axis 2 (columns); the plain
// version's _BEV_TRANSFORMS and _RV_TRANSFORMS
__device__ __forceinline__ void transforms(int is_rv, int v, int& ty, int& tx) {
  if (!is_rv) {
    ty = (v >> 1) ? REV : ID;
    tx = (v & 1) ? REV : ID;
  } else {
    ty = ID;
    tx = v == 0 ? ID : v == 1 ? REVROLL : v == 2 ? REV : ROLL;
  }
}

struct Taps {
  float w0, w1;  // weights of the two taps, 0 where dropped
  int c0, c1;    // their cells in the variant's orientation (read only if kept)
};

__device__ __forceinline__ int wrap(int m, int size) {
  return m >= size ? m - size : m < 0 ? m + size : m;
}

// one axis: x0 = floor(p) in [-1, size], f = p - x0. The taps sit at
// canonical q0 = x0 - rev and q0 + 1; which are kept is the plain version's
// `_axis_weights` (in range for id/rev; for the rolled transforms x0 in
// range and off the seam); a kept tap reads the variant's own cell:
// rev: size-1-q, roll: (q + size/2) mod size, revroll: size-1-((q +
// size/2) mod size). Selects only: the variants of a warp take other
// transforms.
__device__ __forceinline__ Taps axis_taps(int tr, int size, int x0, float f) {
  const bool rev = tr == REV || tr == REVROLL, rolled = tr == ROLL || tr == REVROLL;
  const int half = size >> 1;
  const int q0 = x0 - (int)rev;
  const bool inb = (unsigned)x0 < (unsigned)size;
  const bool keep0 = rolled ? inb && !(rev && x0 == half) : (unsigned)q0 < (unsigned)size;
  const bool keep1 = rolled ? inb && !(!rev && x0 == half - 1)
                            : (unsigned)(q0 + 1) < (unsigned)size;
  int c0 = rolled ? wrap(q0 + half, size) : q0;
  int c1 = rolled ? wrap(q0 + 1 + half, size) : q0 + 1;
  if (rev) {
    c0 = size - 1 - c0;
    c1 = size - 1 - c1;
  }
  Taps t;
  t.w0 = keep0 ? __fsub_rn(1.0f, f) : 0.0f;
  t.w1 = keep1 ? f : 0.0f;
  t.c0 = c0;
  t.c1 = c1;
  return t;
}

template <typename T> struct Vec;

template <> struct Vec<float> {
  using Bits = uint32_t;
  static constexpr int N = 4;
  static __device__ __forceinline__ void add(float* acc, uint4 r, float w) {
    const unsigned u[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(__uint_as_float(u[i]), w));
  }
  static __device__ __forceinline__ uint4 pack(const float* a) {
    return make_uint4(__float_as_uint(a[0]), __float_as_uint(a[1]), __float_as_uint(a[2]),
                      __float_as_uint(a[3]));
  }
};

template <> struct Vec<__nv_bfloat16> {
  using Bits = uint16_t;
  static constexpr int N = 8;
  static __device__ __forceinline__ void add(float* acc, uint4 r, float w) {
    const unsigned u[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // a word holds elements 2i (low half), 2i+1
      acc[2 * i] = __fadd_rn(acc[2 * i], __fmul_rn(__uint_as_float(u[i] << 16), w));
      acc[2 * i + 1] = __fadd_rn(acc[2 * i + 1], __fmul_rn(__uint_as_float(u[i] & 0xffff0000u), w));
    }
  }
  static __device__ __forceinline__ unsigned pack2(float lo, float hi) {
    const __nv_bfloat16 l = __float2bfloat16_rn(lo), h = __float2bfloat16_rn(hi);
    return (unsigned)__bfloat16_as_ushort(l) | ((unsigned)__bfloat16_as_ushort(h) << 16);
  }
  static __device__ __forceinline__ uint4 pack(const float* a) {
    return make_uint4(pack2(a[0], a[1]), pack2(a[2], a[3]), pack2(a[4], a[5]), pack2(a[6], a[7]));
  }
};

struct Shape {
  unsigned threads;          // threads of the gather (< 2^31)
  int N, H, W, C, is_rv;
  int lanes;                 // threads a variant's row
  long long sv, sb, sh, sw;  // grid strides in elements; channels are innermost
  long long cb, cn, ck;      // coordinate strides in elements
  float sy, sx;
};

// two 16-byte slices of one variant's channels a thread: slices i and i +
// lanes of the row, so each load and store of a warp is contiguous
template <typename T>
__global__ void __launch_bounds__(THREADS)
gather_kernel(const T* __restrict__ grid, const float* __restrict__ coords, T* __restrict__ out,
              Shape s) {
  constexpr int VEC = Vec<T>::N, SLICES = 2;
  const unsigned t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= s.threads) return;
  const unsigned per_point = V_TTA * s.lanes;
  const unsigned p = t / per_point;
  const int j = (int)(t - p * per_point);
  const int v = j / s.lanes, lane = j - v * s.lanes;
  const unsigned b = p / s.N, n = p - b * s.N;
  const float* c = coords + b * s.cb + n * s.cn;
  const float py = __fmul_rn(__ldg(c), s.sy), px = __fmul_rn(__ldg(c + s.ck), s.sx);
  const float fy = floorf(py), fx = floorf(px);
  float acc[SLICES][VEC];
#pragma unroll
  for (int u = 0; u < SLICES; ++u)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[u][e] = 0.0f;
  // the plain version's clamp guard, on the float window (no int overflow)
  if (fy >= -1.0f && fy <= (float)s.H && fx >= -1.0f && fx <= (float)s.W) {
    int ty, tx;
    transforms(s.is_rv, v, ty, tx);
    const Taps ay = axis_taps(ty, s.H, (int)fy, __fsub_rn(py, fy));
    const Taps ax = axis_taps(tx, s.W, (int)fx, __fsub_rn(px, fx));
    const float w[4] = {__fmul_rn(ay.w0, ax.w0), __fmul_rn(ay.w0, ax.w1),
                        __fmul_rn(ay.w1, ax.w0), __fmul_rn(ay.w1, ax.w1)};
    const int ry[4] = {ay.c0, ay.c0, ay.c1, ay.c1};
    const int rx[4] = {ax.c0, ax.c1, ax.c0, ax.c1};
    const T* g = grid + v * s.sv + b * s.sb + lane * VEC;
    uint4 r[4][SLICES];
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // a dropped tap adds t * 0 = 0 in the plain version
      const uint4* row = reinterpret_cast<const uint4*>(g + ry[k] * s.sh + rx[k] * s.sw);
#pragma unroll
      for (int u = 0; u < SLICES; ++u)
        r[k][u] = w[k] != 0.0f ? __ldg(row + u * s.lanes) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int u = 0; u < SLICES; ++u) Vec<T>::add(acc[u], r[k][u], w[k]);
  }
  uint4* o = reinterpret_cast<uint4*>(out + (long long)p * (V_TTA * s.C) + v * s.C + lane * VEC);
#pragma unroll
  for (int u = 0; u < SLICES; ++u) __stcs(o + u * s.lanes, Vec<T>::pack(acc[u]));
}

// dst (V, B, H, W, C) contiguous <- src (V, B, H, W, C) with unit column
// stride, moved as bits (T: an unsigned integer of the element's size).
// A block takes one grid row (v, b, h), TILE_COLS columns and TILE_CH
// channels: it reads TILE_COLS-long runs of each channel and writes
// TILE_CH-long runs of channels of each column.
template <typename T>
__global__ void __launch_bounds__(TILE_COLS * TILE_ROWS)
channels_last_kernel(const T* __restrict__ src, T* __restrict__ dst, int B, int H, int W, int C,
                     long long sv, long long sb, long long sh, long long sc, int col_tiles) {
  __shared__ T tile[TILE_CH][TILE_COLS + 1];
  const unsigned row = blockIdx.x / col_tiles;  // (v * B + b) * H + h
  const int w0 = (int)(blockIdx.x - row * col_tiles) * TILE_COLS, c0 = blockIdx.y * TILE_CH;
  const int h = (int)(row % H);
  const unsigned vb = row / H;
  const T* in = src + (vb / B) * sv + (vb % B) * sb + h * sh;
  for (int i = threadIdx.y; i < TILE_CH; i += TILE_ROWS) {
    const int ch = c0 + i, col = w0 + threadIdx.x;
    if (ch < C && col < W) tile[i][threadIdx.x] = in[ch * sc + col];
  }
  __syncthreads();
  T* o = dst + (long long)row * W * C;
  for (int i = threadIdx.y; i < TILE_COLS; i += TILE_ROWS) {
    const int col = w0 + i, ch = c0 + threadIdx.x;
    if (ch < C && col < W) o[(long long)col * C + ch] = tile[threadIdx.x][i];
  }
}

template <typename T>
int launch(const void* grid, const void* coords, void* out, void* scratch, int B,
           long long points, const long long* gs, Shape s, cudaStream_t stream) {
  using Bits = typename Vec<T>::Bits;
  const T* g = static_cast<const T*>(grid);
  if (gs[4] != 1) {  // channels not innermost: rewrite channels-last first
    const int col_tiles = (s.W + TILE_COLS - 1) / TILE_COLS;
    const long long rows = (long long)V_TTA * B * s.H;
    if (rows * col_tiles > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    const dim3 blocks((unsigned)(rows * col_tiles), (s.C + TILE_CH - 1) / TILE_CH);
    channels_last_kernel<Bits><<<blocks, dim3(TILE_COLS, TILE_ROWS), 0, stream>>>(
        static_cast<const Bits*>(grid), static_cast<Bits*>(scratch), B, s.H, s.W, s.C, gs[0],
        gs[1], gs[2], gs[4], col_tiles);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    g = static_cast<const T*>(scratch);
    s.sw = s.C;
    s.sh = (long long)s.W * s.C;
    s.sb = s.sh * s.H;
    s.sv = s.sb * B;
  }
  s.lanes = s.C / (2 * Vec<T>::N);  // threads a variant's row, two slices each
  const long long threads = points * V_TTA * s.lanes;
  if (threads > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  s.threads = (unsigned)threads;
  gather_kernel<T><<<(s.threads + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      g, static_cast<const float*>(coords), static_cast<T*>(out), s);
  return (int)cudaGetLastError();
}

}  // namespace

// grid: the (V=4, B, H, W, C) variant grids, float32 or bfloat16, strides
// grid_strides[0..4] in elements; either the channels are innermost
// (grid_strides[4] == 1), with the grid's address and strides[0..3]
// multiples of 16 bytes, or the columns are (grid_strides[3] == 1) and
// scratch holds V*B*H*W*C elements of the grid's type, 16-byte aligned.
// coords: float32 (B, N, >= 2), strides coord_strides[0..2] in elements.
// out: (B, N, V*C) contiguous in the grid's type, 16-byte aligned. C *
// itemsize must be a multiple of 32; kind 0 = BEV, 1 = RV; (sy, sx) the
// scale of the coordinates. Launches on `stream` and does not synchronise.
// Returns a cudaError_t value (0 on success).
extern "C" int streammos_grid_gather_tta(const void* grid, const void* coords, void* out,
                                         void* scratch, int B, int N, int H, int W, int C,
                                         const long long* grid_strides,
                                         const long long* coord_strides, float sy, float sx,
                                         int kind, int is_bf16, void* stream) {
  const int itemsize = is_bf16 ? 2 : 4;
  const long long* gs = grid_strides;
  const bool channels_inner = gs[4] == 1;
  const bool aligned = channels_inner
      ? (uintptr_t)grid % 16 == 0 &&
            (gs[0] * itemsize) % 16 == 0 && (gs[1] * itemsize) % 16 == 0 &&
            (gs[2] * itemsize) % 16 == 0 && (gs[3] * itemsize) % 16 == 0
      : gs[3] == 1 && scratch != nullptr && (uintptr_t)scratch % 16 == 0;
  if (B < 1 || N < 0 || H < 1 || W < 1 || C < 1 || (C * itemsize) % 32 || !aligned ||
      (uintptr_t)out % 16 || (kind != 0 && kind != 1))
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  Shape s;
  s.N = N;
  s.H = H;
  s.W = W;
  s.C = C;
  s.is_rv = kind;
  s.sv = gs[0];
  s.sb = gs[1];
  s.sh = gs[2];
  s.sw = gs[3];
  s.cb = coord_strides[0];
  s.cn = coord_strides[1];
  s.ck = coord_strides[2];
  s.sy = sy;
  s.sx = sx;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long points = (long long)B * N;
  if (is_bf16) return launch<__nv_bfloat16>(grid, coords, out, scratch, B, points, gs, s, st);
  return launch<float>(grid, coords, out, scratch, B, points, gs, s, st);
}
