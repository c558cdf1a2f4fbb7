// Fused TTA header for Hopper (sm_90a): the header DownSample2D of all four
// test-time-augmentation variants in one launch, read straight from the
// phase-outer scatter output.
//
// Replaces the TPU kernel `_pair_kernel`, streammos_tpu/ops/fused_header.py:198
// (entered through `fused_header_tta`, pallas_call at :423).
//
// What it computes, per variant v (flip of rows fx = v >> 1, of columns
// fy = v & 1), batch b and canonical-anchored output pixel (a, c):
//   conv = sum_{t, taps, ch} G[b*T+t, phase, 1+a+ro, c+co, v*C+ch] * k3[...]
//   z    = (1x1 conv of G at a full-res position) * ps + pb
//   y    = relu(conv * cs + cb + max over the 3x3 stride-2 window of z)
// with the conv zero-padded and the max taking -inf outside the grid. A
// full-res axis reversal r -> 2*Hh-1-r is, in phase space r = 2h+p, the
// half-res reversal plus a swap of the phase bit, so anchoring a flipped
// variant's output at Hh-1-i puts every variant's taps on the same
// canonical half-res rows (`axis_tap` below; `_axis_taps`,
// `_pool_axis_taps` there):
//   unflipped: (offset -1, phase 1, k 0), (0, 0, 1), (0, 1, 2)
//   flipped:   (offset +1, phase 0, k 0), (0, 1, 1), (0, 0, 2)
// No variant-oriented or full-resolution copy of the grid is ever written.
// The one-row padding above and below each phase plane is never read: rows
// outside the grid are zero by the index test, whatever the padding holds.
//
// Bound in bf16: at the production shape (G 3x4x258x256x256 bf16, of which
// the 403 MB between the padding rows is read; output 4x1x256x256x32,
// 17 MB) the function moves 419.6 MB and does 41.88 GFLOP, so the card's
// memory rate bounds it: 0.1252 ms at 3.35 TB/s. Its intensity, ~100
// FLOP/byte, is under the bf16 ridge (~295), so on the tensor cores the
// bytes bound it. The float32 bound is under the float32 kernel below.
//
// Two kernels, one per dtype, neither a fallback for the other:
//
// * bfloat16 (the main path): `header_bf16_kernel`, an implicit GEMM on the
//   tensor cores. One block of 8 warps per (variant, batch, tile of 8x16
//   anchored output pixels). What it does about what held the first
//   version back:
//   1. Arithmetic: `mma.sync.m16n8k16` on bf16 with float32 accumulators.
//      Conv branch: M = 128 pixels (one output row of 16 a warp), N = Cout
//      (padded to 32), K = 9 taps x T x C; the A rows of a tap are the
//      staged window shifted by the tap, one `ldmatrix` row address a pixel,
//      no im2col. Pool branch: a second GEMM over the staged positions,
//      M = 561 (36 m16 tiles over the 8 warps), K = T x C, its B fragments
//      held in registers across the warp's m tiles.
//   2. Overlap: a ring of 3 stages filled by 16-byte `cp.async`; the loads
//      of step k+2 are in flight while step k's products run. A step is one
//      (frame t, 32-channel chunk): 6 steps at production.
//   3. Occupancy and footprint: G stays bf16 in shared memory; both
//      branches' sums stay in registers across every step (16 conv + up to
//      80 pool floats a thread), so there is no read-modify-write buffer.
//      The float32 z of the pool (affine applied, -inf outside the grid) is
//      written once after the last step, into the ring, for the 3x3 max.
//   4. Bytes staged: only the (2*8+1) x (2*16+1) = 561 full-res positions
//      the tile's taps touch (the 720 of a phase-plane halo window before),
//      as one full-res window whose canonical origin is (2*r0-1+fx,
//      2*c0-1+fy): local row j holds full-res row 2*r0-1+fx+j, so its phase
//      is that row's low bit. Outside the grid a copy reads nothing and
//      fills zeros (cp.async with source size 0). Rows of the window are
//      64 bytes (32 channels), two to a 128-byte line, their 16-byte units
//      XOR-swizzled by the line so that `ldmatrix` has no bank conflict for
//      8 rows at stride 1 (pool, weights) or 2 (the conv's stride).
//   5. Weights: packed once a call by the wrapper into the B operand's
//      K-contiguous layout, conv (T, 9, Cout, C) and 1x1 (T, Cout, C),
//      122 KB in all, so each stage copies its (t, chunk) slice (20.5 KB)
//      beside the window as 64-byte rows, bf16 as stored, no conversion.
//      Every block still reads them once from L2 (~250 MB of L2 reads at
//      production, beside ~440 MB of G from device memory).
//   Shared memory: 3 x 56,448 B = 169,344 B, one block of 256 threads an SM.
//   Variant v reads only its own C channels (a 128-byte run a position at
//   C = 64), so across the four variants G is read about once (1.1x with the
//   halo). Limits: C % 16 == 0, Cout % 8 == 0, Cout <= 32; any Bt, Hh, Wh,
//   the ragged last tiles masked.
//
// * float32 (every float32 config, `compute_dtype="float32"`):
//   `header_f32_kernel`, the same implicit GEMM in 3xTF32 on the tensor
//   cores. A single TF32 product keeps 11 of float32's 24 mantissa bits and
//   misses the float32 tolerance (rtol = atol = 1e-4) many times over at
//   C = 64. So each operand is split, x = hi + lo with hi = tf32(x) and
//   lo = tf32(x - hi), both rounded as cvt.rna.tf32.f32 rounds (to nearest,
//   ties away from zero; done with two integer operations, `to_tf32`), and
//   `mma.sync.m16n8k8.tf32` accumulates a_lo b_hi + a_hi b_lo + a_hi b_hi
//   in float32: about 22 bits a product, the dropped a_lo b_lo below 2^-22
//   of it. The tensor cores' float32 sums round toward zero, so each row of
//   3 conv taps sums into fresh registers that a float32 add folds into the
//   running sums. An m16n8k8 tf32 fragment has, word for word, the layout
//   of an m16n8k16 bf16 one, so the bf16 kernel's tile, `ldmatrix`
//   addressing, window, swizzle and epilogue carry over unchanged; a step is
//   one frame x 16 float32 channels (the same 64-byte rows; 12 steps at
//   production) and the 3-stage ring the same 169,344 B. Both operands are
//   split in registers after `ldmatrix`: staged hi/lo weights would make a
//   stage 76,928 B (three of them nearly fill the 227 KB) and double the B
//   operand's shared-memory reads, and were no faster. C % 4 == 0 copies in
//   16-byte units, any other C one 4-byte copy a channel, past C
//   zero-filled alike. Bound at the production shape in float32: 839.1 MB
//   (805.3 MB of G between the padding rows, 33.6 MB out, 0.25 MB of
//   weights), 0.2505 ms at 3.35 TB/s; 41.88 GFLOP as three TF32 products,
//   0.2538 ms at 495 TFLOP/s, which bounds it (0.625 ms as float32 FMAs on
//   the CUDA cores at 67 TFLOP/s). What keeps it from the bound: the
//   3 x 336 `mma.sync` a warp a step, which issue at well under the dense
//   TF32 rate that `wgmma` would reach, and one block an SM, whose loads and
//   products overlap only in part. Limits: Cout % 8 == 0, Cout <= 32, any C.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int NPH = 4;  // phases: 2 * row bit + column bit

// tap k (0..2) of one axis, canonical-anchored: half-res offset and phase
// bit; the 3x3 kernel index along the axis is k itself
__device__ __forceinline__ void axis_tap(int flip, int k, int& off, int& ph) {
  if (k == 0) {
    off = flip ? 1 : -1;
    ph = flip ? 0 : 1;
  } else {
    off = 0;
    ph = (k == 1) == (flip != 0) ? 1 : 0;
  }
}

// ---------------------------------------------------------------- bfloat16

namespace tc {

constexpr int TR = 8;                          // anchored output rows a block
constexpr int TW = 16;                         // anchored output columns a block
constexpr int WROWS = 2 * TR + 1;              // full-res window rows
constexpr int WCOLS = 2 * TW + 1;              // full-res window columns
constexpr int NPOS = WROWS * WCOLS;            // 561 staged positions
constexpr int NMT = (NPOS + 15) / 16;          // pool GEMM's m16 tiles
constexpr int NWARP = 8;
constexpr int NTHR = 32 * NWARP;
constexpr int MT_PER_WARP = (NMT + NWARP - 1) / NWARP;
constexpr int KCH = 32;                        // channels a step: 4 16-byte units
constexpr int NPAD = 32;                       // B operand's rows (Cout <= 32)
constexpr int NSTAGE = 3;
constexpr int WIN_BYTES = (NPOS + 1) / 2 * 128;
constexpr int W3_BYTES = 9 * NPAD * KCH * 2;
constexpr int W1_BYTES = NPAD * KCH * 2;
constexpr int STAGE_BYTES = WIN_BYTES + W3_BYTES + W1_BYTES;
constexpr int SMEM_BYTES = NSTAGE * STAGE_BYTES;
constexpr int NCOPY = (NPOS * 4 + NTHR - 1) / NTHR;  // window copies a thread
constexpr int ZSTRIDE = NPAD + 8;              // floats a position in z
constexpr int OSTRIDE = NPAD + 8;              // bf16 a pixel in the output tile
static_assert(TR == NWARP, "one output row a warp");
static_assert(TW == 16, "one m16 tile an output row");
static_assert(WIN_BYTES % 128 == 0 && W3_BYTES % 128 == 0 && STAGE_BYTES % 128 == 0,
              "swizzled rows keep 128-byte lines");
static_assert(NPOS * ZSTRIDE * 4 + TR * TW * OSTRIDE * 2 <= SMEM_BYTES,
              "the epilogue reuses the ring");

// byte offset of 16-byte unit `unit` (0..3) of 64-byte row `row`: two rows a
// 128-byte line, the line's 8 units XOR-ed with the line index, so that the
// 8 row addresses of an `ldmatrix` matrix, at row stride 1 or 2, fall on 8
// distinct bank groups. Unit u + 2 is the offset XOR 32.
__device__ __forceinline__ uint32_t swz(int row, int unit) {
  const int line = row >> 1;
  return (uint32_t)(line * 128 + (((((row & 1) << 2) | unit) ^ (line & 7)) << 4));
}

// local window offset (0..2) of kernel tap k along an axis: the tap's
// full-res row 2*(a+off)+ph less the window origin 2*r0-1+flip, less 2*i
__device__ __forceinline__ int local_tap(int flip, int k) {
  int off, ph;
  axis_tap(flip, k, off, ph);
  return 2 * off + ph + 1 - flip;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, float32 sums
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// g (Bt*T, 4, Hh+2, Wh, 4*C); k3p (T, 9, Cout, C); k1p (T, Cout, C);
// out (4, Bt, Hh, Wh, Cout). Grid (tiles, Bt, 4 variants), NTHR threads.
__global__ void __launch_bounds__(NTHR, 1)
header_bf16_kernel(const __nv_bfloat16* __restrict__ g, const __nv_bfloat16* __restrict__ k3p,
                   const __nv_bfloat16* __restrict__ k1p, const float* __restrict__ cs,
                   const float* __restrict__ cb, const float* __restrict__ ps,
                   const float* __restrict__ pb, __nv_bfloat16* __restrict__ out, int Bt,
                   int nT, int Hh, int Wh, int C, int Cout, int tiles_w) {
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  const uint32_t sbase = (uint32_t)__cvta_generic_to_shared(tc_smem);

  const int v = blockIdx.z, b = blockIdx.y;
  const int fx = v >> 1, fy = v & 1;
  const int r0 = (blockIdx.x / tiles_w) * TR;
  const int c0 = (blockIdx.x % tiles_w) * TW;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int VC = NPH * C;
  const int Hp = Hh + 2;
  // canonical full-res row and column of the window's local (0, 0)
  const int R0 = 2 * r0 - 1 + fx, Q0 = 2 * c0 - 1 + fy;
  const int nchunk = (C + KCH - 1) / KCH;
  const int nstep = nT * nchunk;
  const size_t frame = (size_t)NPH * Hp * Wh * VC;

  // this thread's window copies (position i >> 2, 16-byte unit i & 3 =
  // tid & 3): element offset in a frame, or -1 outside the grid
  int woff[NCOPY];
#pragma unroll
  for (int j = 0; j < NCOPY; ++j) {
    const int i = tid + j * NTHR;
    woff[j] = -1;
    if (i < NPOS * 4) {
      const int pos = i >> 2;
      const int r = R0 + pos / WCOLS, q = Q0 + pos % WCOLS;
      if (r >= 0 && r < 2 * Hh && q >= 0 && q < 2 * Wh) {
        const int ph = 2 * (r & 1) + (q & 1);
        woff[j] = ((ph * Hp + (r >> 1) + 1) * Wh + (q >> 1)) * VC + v * C + (i & 3) * 8;
      }
    }
  }

  auto load_step = [&](int s, int stage) {
    const int t = s / nchunk, kc = s % nchunk;
    const int ch = kc * KCH + (tid & 3) * 8;  // this thread's unit's channel
    const bool chok = ch < C;
    const __nv_bfloat16* gt = g + (size_t)(b * nT + t) * frame + kc * KCH;
    const uint32_t st = sbase + stage * STAGE_BYTES;
#pragma unroll
    for (int j = 0; j < NCOPY; ++j) {
      const int i = tid + j * NTHR;
      if (i < NPOS * 4) {
        const bool ok = chok && woff[j] >= 0;
        cp_async16(st + swz(i >> 2, i & 3), ok ? gt + woff[j] : g, ok);
      }
    }
    // weights: B rows (tap, n), n < NPAD, zero beyond Cout and C
    for (int i = tid; i < 9 * NPAD * 4; i += NTHR) {
      const int row = i >> 2, tap = row / NPAD, n = row % NPAD;
      const bool ok = chok && n < Cout;
      const __nv_bfloat16* src = k3p + (((size_t)t * 9 + tap) * Cout + n) * C + ch;
      cp_async16(st + WIN_BYTES + swz(row, i & 3), ok ? src : k3p, ok);
    }
    for (int i = tid; i < NPAD * 4; i += NTHR) {
      const int n = i >> 2;
      const bool ok = chok && n < Cout;
      const __nv_bfloat16* src = k1p + ((size_t)t * Cout + n) * C + ch;
      cp_async16(st + WIN_BYTES + W3_BYTES + swz(n, i & 3), ok ? src : k1p, ok);
    }
  };

  // lane roles in ldmatrix.x4: A matrices (rows 0-7 | 8-15) x (k 0-7 | 8-15);
  // B matrices (k 0-7 | 8-15) x (n-tile 2p | 2p+1)
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_unit = lane >> 4;
  const int b_row = (lane & 7) + (lane >> 4) * 8;
  const int b_unit = (lane >> 3) & 1;

  // A rows of this warp's pool m tiles (past the last position: any staged
  // one, its products unread)
  uint32_t pool_a[MT_PER_WARP];
#pragma unroll
  for (int m = 0; m < MT_PER_WARP; ++m) {
    const int pos = min((warp + m * NWARP) * 16 + a_row, NPOS - 1);
    pool_a[m] = swz(pos, a_unit);
  }
  // conv A row of this lane's pixel at local tap (0, 0): output row `warp`
  const int conv_pos0 = 2 * warp * WCOLS + 2 * a_row;
  int dr[3], dc[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    dr[k] = local_tap(fx, k);
    dc[k] = local_tap(fy, k);
  }

  float cacc[4][4];
  float pacc[MT_PER_WARP][4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      cacc[j][e] = 0.f;
#pragma unroll
      for (int m = 0; m < MT_PER_WARP; ++m) pacc[m][j][e] = 0.f;
    }

  // the ring: steps s+1 and s+2 load while step s computes
#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < nstep) load_step(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < nstep; ++s) {
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();  // step s landed for every thread; step s-1 consumed
    if (s + NSTAGE - 1 < nstep) load_step(s + NSTAGE - 1, (s + NSTAGE - 1) % NSTAGE);
    cp_async_commit();

    const uint32_t st = sbase + (s % NSTAGE) * STAGE_BYTES;
    const uint32_t w3 = st + WIN_BYTES;
    const uint32_t w1 = w3 + W3_BYTES;

    // conv branch: 9 taps x 2 k16 steps of this warp's 16 pixels x 32 n
#pragma unroll
    for (int kr = 0; kr < 3; ++kr) {
#pragma unroll
      for (int kc = 0; kc < 3; ++kc) {
        const int tap = kr * 3 + kc;
        const uint32_t a_off = swz(conv_pos0 + dr[kr] * WCOLS + dc[kc], a_unit);
        const uint32_t b_off0 = swz(tap * NPAD + b_row, b_unit);
        const uint32_t b_off1 = swz(tap * NPAD + 16 + b_row, b_unit);
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          uint32_t a[4], b01[4], b23[4];
          ldsm4(st + (a_off ^ (ks << 5)), a);
          ldsm4(w3 + (b_off0 ^ (ks << 5)), b01);
          ldsm4(w3 + (b_off1 ^ (ks << 5)), b23);
          mma16816(cacc[0], a, b01[0], b01[1]);
          mma16816(cacc[1], a, b01[2], b01[3]);
          mma16816(cacc[2], a, b23[0], b23[1]);
          mma16816(cacc[3], a, b23[2], b23[3]);
        }
      }
    }

    // pool branch: the 1x1 weights' fragments once, then the warp's m tiles
    uint32_t pb01[2][4], pb23[2][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      ldsm4(w1 + (swz(b_row, b_unit) ^ (ks << 5)), pb01[ks]);
      ldsm4(w1 + (swz(16 + b_row, b_unit) ^ (ks << 5)), pb23[ks]);
    }
#pragma unroll
    for (int m = 0; m < MT_PER_WARP; ++m) {
      if (warp + m * NWARP < NMT) {
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          uint32_t a[4];
          ldsm4(st + (pool_a[m] ^ (ks << 5)), a);
          mma16816(pacc[m][0], a, pb01[ks][0], pb01[ks][1]);
          mma16816(pacc[m][1], a, pb01[ks][2], pb01[ks][3]);
          mma16816(pacc[m][2], a, pb23[ks][0], pb23[ks][1]);
          mma16816(pacc[m][3], a, pb23[ks][2], pb23[ks][3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free

  // epilogue 1: z = pool sums * ps + pb at in-grid positions, -inf outside,
  // float32 into the ring
  float* z = reinterpret_cast<float*>(tc_smem);
  const int frow = lane >> 2;          // accumulator rows frow, frow + 8
  const int fcol = 2 * (lane & 3);     // and columns fcol, fcol + 1 of an n tile
#pragma unroll
  for (int m = 0; m < MT_PER_WARP; ++m) {
    const int mt = warp + m * NWARP;
    if (mt >= NMT) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int pos = mt * 16 + frow + 8 * half;
      if (pos >= NPOS) continue;
      const int r = R0 + pos / WCOLS, q = Q0 + pos % WCOLS;
      const bool in = r >= 0 && r < 2 * Hh && q >= 0 && q < 2 * Wh;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = 8 * j + fcol;
        float2 val = make_float2(-INFINITY, -INFINITY);
        if (in && n < Cout) {
          val.x = pacc[m][j][2 * half] * ps[n] + pb[n];
          val.y = pacc[m][j][2 * half + 1] * ps[n + 1] + pb[n + 1];
        }
        *reinterpret_cast<float2*>(z + pos * ZSTRIDE + n) = val;
      }
    }
  }
  __syncthreads();

  // epilogue 2: conv affine + 3x3 stride-2 max of z + ReLU, bf16 into an
  // output tile behind z
  __nv_bfloat16* otile = reinterpret_cast<__nv_bfloat16*>(tc_smem + NPOS * ZSTRIDE * 4);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int jj = frow + 8 * half;  // pixel (warp, jj) of the tile
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = 8 * j + fcol;
      if (n >= Cout) continue;
      float2 mx = make_float2(-INFINITY, -INFINITY);
#pragma unroll
      for (int ddr = 0; ddr < 3; ++ddr)
#pragma unroll
        for (int ddc = 0; ddc < 3; ++ddc) {
          const int pos = (2 * warp + ddr) * WCOLS + 2 * jj + ddc;
          const float2 zz = *reinterpret_cast<const float2*>(z + pos * ZSTRIDE + n);
          mx.x = fmaxf(mx.x, zz.x);
          mx.y = fmaxf(mx.y, zz.y);
        }
      const float y0 = fmaxf(cacc[j][2 * half] * cs[n] + cb[n] + mx.x, 0.f);
      const float y1 = fmaxf(cacc[j][2 * half + 1] * cs[n + 1] + cb[n + 1] + mx.y, 0.f);
      *reinterpret_cast<__nv_bfloat162*>(otile + (warp * TW + jj) * OSTRIDE + n) =
          __floats2bfloat162_rn(y0, y1);
    }
  }
  __syncthreads();

  // store: Cout / 8 16-byte units a pixel, ragged edges masked
  const int upp = Cout / 8;
  for (int i = tid; i < TR * TW * upp; i += NTHR) {
    const int px = i / upp, u = i % upp;
    const int a = r0 + px / TW, c = c0 + px % TW;
    if (a < Hh && c < Wh)
      *reinterpret_cast<uint4*>(out + ((((size_t)v * Bt + b) * Hh + a) * Wh + c) * Cout +
                                u * 8) =
          *reinterpret_cast<const uint4*>(otile + px * OSTRIDE + u * 8);
  }
}

int launch_bf16(const void* g, const void* k3p, const void* k1p, const void* cs,
                const void* cb, const void* ps, const void* pb, void* out, int Bt, int nT,
                int Hh, int Wh, int C, int Cout, cudaStream_t stream) {
  const int tiles_w = (Wh + TW - 1) / TW;
  const int tiles_h = (Hh + TR - 1) / TR;
  cudaError_t err = cudaFuncSetAttribute(
      header_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  header_bf16_kernel<<<dim3(tiles_h * tiles_w, Bt, NPH), NTHR, SMEM_BYTES, stream>>>(
      static_cast<const __nv_bfloat16*>(g), static_cast<const __nv_bfloat16*>(k3p),
      static_cast<const __nv_bfloat16*>(k1p), static_cast<const float*>(cs),
      static_cast<const float*>(cb), static_cast<const float*>(ps),
      static_cast<const float*>(pb), static_cast<__nv_bfloat16*>(out), Bt, nT, Hh, Wh, C,
      Cout, tiles_w);
  return (int)cudaGetLastError();
}

}  // namespace tc

// ----------------------------------------------------------------- float32

namespace f32 {

// the bf16 kernel's tile, window, ring and swizzle: a step's 16 float32
// channels make the same 64-byte rows as its 32 bf16 channels
using tc::NCOPY;
using tc::NMT;
using tc::NPAD;
using tc::NPOS;
using tc::NSTAGE;
using tc::NTHR;
using tc::NWARP;
using tc::MT_PER_WARP;
using tc::SMEM_BYTES;
using tc::STAGE_BYTES;
using tc::TR;
using tc::TW;
using tc::W3_BYTES;
using tc::WCOLS;
using tc::WIN_BYTES;
using tc::ZSTRIDE;
using tc::cp_async16;
using tc::cp_async_commit;
using tc::cp_async_wait;
using tc::ldsm4;
using tc::local_tap;
using tc::swz;

constexpr int KCH = 16;            // float32 channels a step: 4 16-byte units
constexpr int OSTRIDE = NPAD + 4;  // floats a pixel in the output tile
static_assert(NPOS * ZSTRIDE * 4 + TR * TW * OSTRIDE * 4 <= SMEM_BYTES,
              "the epilogue reuses the ring");

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0));
}

// the bits of cvt.rna.tf32.f32 for finite x: the 13 low mantissa bits
// rounded to nearest, ties away from zero (half their range added to the
// magnitude, then cut). Two integer operations, where ptxas expands the cvt
// into a longer sequence with NaN and Inf tests.
__device__ __forceinline__ uint32_t to_tf32(uint32_t x) {
  return (x + 0x1000u) & 0xFFFFE000u;
}
// x = hi + lo to about 22 of float32's 24 bits: hi = tf32(x), lo =
// tf32(x - hi), the subtraction exact
template <int N>
__device__ __forceinline__ void split(const uint32_t (&x)[N], uint32_t (&hi)[N],
                                      uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    hi[i] = to_tf32(x[i]);
    lo[i] = to_tf32(__float_as_uint(__uint_as_float(x[i]) - __uint_as_float(hi[i])));
  }
}

// d += a (16x8, row) * b (8x8, col), tf32 in, float32 sums
__device__ __forceinline__ void mma1688(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 3xTF32: d += a_lo b_hi + a_hi b_lo + a_hi b_hi, the small products first
// (a_lo b_lo, below 2^-22 of the product, is dropped). b holds n-tile p's
// (b0, b1) at [2p], [2p+1], as `ldmatrix.x4` leaves them.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[4],
                                     const uint32_t (&bl)[4], int p) {
  mma1688(d, al, bh[2 * p], bh[2 * p + 1]);
  mma1688(d, ah, bl[2 * p], bl[2 * p + 1]);
  mma1688(d, ah, bh[2 * p], bh[2 * p + 1]);
}

// g (Bt*T, 4, Hh+2, Wh, 4*C); k3p (T, 9, Cout, C); k1p (T, Cout, C);
// out (4, Bt, Hh, Wh, Cout). Grid (tiles, Bt, 4 variants), NTHR threads.
// VEC: C % 4 == 0, 16-byte copies; else one 4-byte copy a channel.
template <bool VEC>
__global__ void __launch_bounds__(NTHR, 1)
header_f32_kernel(const float* __restrict__ g, const float* __restrict__ k3p,
                  const float* __restrict__ k1p, const float* __restrict__ cs,
                  const float* __restrict__ cb, const float* __restrict__ ps,
                  const float* __restrict__ pb, float* __restrict__ out, int Bt, int nT,
                  int Hh, int Wh, int C, int Cout, int tiles_w) {
  extern __shared__ __align__(1024) unsigned char f32_smem[];
  const uint32_t sbase = (uint32_t)__cvta_generic_to_shared(f32_smem);

  const int v = blockIdx.z, b = blockIdx.y;
  const int fx = v >> 1, fy = v & 1;
  const int r0 = (blockIdx.x / tiles_w) * TR;
  const int c0 = (blockIdx.x % tiles_w) * TW;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int VC = NPH * C;
  const int Hp = Hh + 2;
  // canonical full-res row and column of the window's local (0, 0)
  const int R0 = 2 * r0 - 1 + fx, Q0 = 2 * c0 - 1 + fy;
  const int nchunk = (C + KCH - 1) / KCH;
  const int nstep = nT * nchunk;
  const size_t frame = (size_t)NPH * Hp * Wh * VC;

  // element offset in a frame of window position `pos`'s channel 0 of
  // variant v, or -1 outside the grid
  auto pos_offset = [&](int pos) {
    const int r = R0 + pos / WCOLS, q = Q0 + pos % WCOLS;
    if (r < 0 || r >= 2 * Hh || q < 0 || q >= 2 * Wh) return -1;
    const int ph = 2 * (r & 1) + (q & 1);
    return ((ph * Hp + (r >> 1) + 1) * Wh + (q >> 1)) * VC + v * C;
  };

  // VEC: this thread's window copies (position i >> 2, 16-byte unit
  // i & 3 = tid & 3), offsets kept across the steps
  int woff[VEC ? NCOPY : 1];
  if constexpr (VEC) {
#pragma unroll
    for (int j = 0; j < NCOPY; ++j) {
      const int i = tid + j * NTHR;
      woff[j] = i < NPOS * 4 ? pos_offset(i >> 2) : -1;
      if (woff[j] >= 0) woff[j] += (i & 3) * 4;
    }
  }

  auto load_step = [&](int s, int stage) {
    const int t = s / nchunk, kc = s % nchunk;
    const float* gt = g + (size_t)(b * nT + t) * frame + kc * KCH;
    const uint32_t st = sbase + stage * STAGE_BYTES;
    const uint32_t w3 = st + WIN_BYTES, w1 = w3 + W3_BYTES;
    if constexpr (VEC) {
      const bool chok = kc * KCH + (tid & 3) * 4 < C;  // this thread's unit
#pragma unroll
      for (int j = 0; j < NCOPY; ++j) {
        const int i = tid + j * NTHR;
        if (i < NPOS * 4) {
          const bool ok = chok && woff[j] >= 0;
          cp_async16(st + swz(i >> 2, i & 3), ok ? gt + woff[j] : g, ok);
        }
      }
      // weights: B rows (tap, n), n < NPAD, zero beyond Cout and C
      for (int i = tid; i < 9 * NPAD * 4; i += NTHR) {
        const int row = i >> 2, tap = row / NPAD, n = row % NPAD;
        const int ch = kc * KCH + (i & 3) * 4;
        const bool ok = ch < C && n < Cout;
        const float* src = k3p + (((size_t)t * 9 + tap) * Cout + n) * C + ch;
        cp_async16(w3 + swz(row, i & 3), ok ? src : k3p, ok);
      }
      for (int i = tid; i < NPAD * 4; i += NTHR) {
        const int n = i >> 2, ch = kc * KCH + (i & 3) * 4;
        const bool ok = ch < C && n < Cout;
        const float* src = k1p + ((size_t)t * Cout + n) * C + ch;
        cp_async16(w1 + swz(n, i & 3), ok ? src : k1p, ok);
      }
    } else {
      // one channel a copy: element e of a row is 4 * (e & 3) bytes into
      // its 16-byte unit e >> 2
      for (int i = tid; i < NPOS * KCH; i += NTHR) {
        const int pos = i / KCH, e = i % KCH;
        const int off = pos_offset(pos);
        const bool ok = kc * KCH + e < C && off >= 0;
        cp_async4(st + swz(pos, e >> 2) + 4 * (e & 3), ok ? gt + off + e : g, ok);
      }
      for (int i = tid; i < 10 * NPAD * KCH; i += NTHR) {
        const int row = i / KCH, e = i % KCH, n = row % NPAD;
        const int ch = kc * KCH + e;
        const bool ok = ch < C && n < Cout;
        const float* src = row < 9 * NPAD
                               ? k3p + (((size_t)t * 9 + row / NPAD) * Cout + n) * C + ch
                               : k1p + ((size_t)t * Cout + n) * C + ch;
        cp_async4(w3 + swz(row, e >> 2) + 4 * (e & 3), ok ? src : k3p, ok);
      }
    }
  };

  // lane roles in ldmatrix.x4, the bf16 kernel's: an m16n8k8 tf32 fragment
  // has, word for word, the layout of an m16n8k16 bf16 one. A matrices
  // (rows 0-7 | 8-15) x (k 0-3 | 4-7); B matrices (k 0-3 | 4-7) x (n-tile
  // 2p | 2p+1)
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_unit = lane >> 4;
  const int b_row = (lane & 7) + (lane >> 4) * 8;
  const int b_unit = (lane >> 3) & 1;

  // A rows of this warp's pool m tiles (past the last position: any staged
  // one, its products unread)
  uint32_t pool_a[MT_PER_WARP];
#pragma unroll
  for (int m = 0; m < MT_PER_WARP; ++m) {
    const int pos = min((warp + m * NWARP) * 16 + a_row, NPOS - 1);
    pool_a[m] = swz(pos, a_unit);
  }
  // conv A row of this lane's pixel at each tap: output row `warp`
  const int conv_pos0 = 2 * warp * WCOLS + 2 * a_row;
  uint32_t a_offs[9];
#pragma unroll
  for (int kr = 0; kr < 3; ++kr)
#pragma unroll
    for (int kc = 0; kc < 3; ++kc)
      a_offs[kr * 3 + kc] =
          swz(conv_pos0 + local_tap(fx, kr) * WCOLS + local_tap(fy, kc), a_unit);
  // B rows of n 0-15 | 16-31 at k 0-7 | 8-15; tap's rows tap * NPAD + r lie
  // 16 lines on, and the swizzle repeats every 8 lines
  uint32_t b_offs[2][2];
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
#pragma unroll
    for (int h = 0; h < 2; ++h) b_offs[ks][h] = swz(16 * h + b_row, b_unit) ^ (ks << 5);
  constexpr uint32_t TAP_BYTES = NPAD / 2 * 128;

  float cacc[4][4];
  float pacc[MT_PER_WARP][4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      cacc[j][e] = 0.f;
#pragma unroll
      for (int m = 0; m < MT_PER_WARP; ++m) pacc[m][j][e] = 0.f;
    }

  // the ring: steps s+1 and s+2 load while step s computes
#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < nstep) load_step(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < nstep; ++s) {
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();  // step s landed for every thread; step s-1 consumed
    if (s + NSTAGE - 1 < nstep) load_step(s + NSTAGE - 1, (s + NSTAGE - 1) % NSTAGE);
    cp_async_commit();

    const uint32_t st = sbase + (s % NSTAGE) * STAGE_BYTES;
    const uint32_t w3 = st + WIN_BYTES;
    const uint32_t w1 = w3 + W3_BYTES;

    // conv branch: 9 taps x 2 k8 steps of this warp's 16 pixels x 32 n.
    // Each row of 3 taps sums into fresh registers, then into the sums by a
    // float32 add: the tensor cores' float32 accumulation rounds toward
    // zero, and 648 `mma.sync` in series (54 a step, 12 steps) into one
    // large sum drift past the float32 tolerance at production
#pragma unroll
    for (int kr = 0; kr < 3; ++kr) {
      float part[4][4] = {};
#pragma unroll
      for (int kc = 0; kc < 3; ++kc) {
        const int tap = kr * 3 + kc;
        const uint32_t wt = w3 + tap * TAP_BYTES;
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          uint32_t a[4], b01[4], b23[4];
          ldsm4(st + (a_offs[tap] ^ (ks << 5)), a);
          ldsm4(wt + b_offs[ks][0], b01);
          ldsm4(wt + b_offs[ks][1], b23);
          uint32_t ah[4], al[4], b01h[4], b01l[4], b23h[4], b23l[4];
          split(a, ah, al);
          split(b01, b01h, b01l);
          split(b23, b23h, b23l);
          mma3(part[0], ah, al, b01h, b01l, 0);
          mma3(part[1], ah, al, b01h, b01l, 1);
          mma3(part[2], ah, al, b23h, b23l, 0);
          mma3(part[3], ah, al, b23h, b23l, 1);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) cacc[j][e] += part[j][e];
    }

    // pool branch: the 1x1 weights' fragments split once, then the warp's
    // m tiles
    uint32_t pbh[2][2][4], pbl[2][2][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t raw[4];
        ldsm4(w1 + b_offs[ks][h], raw);
        split(raw, pbh[ks][h], pbl[ks][h]);
      }
#pragma unroll
    for (int m = 0; m < MT_PER_WARP; ++m) {
      if (warp + m * NWARP < NMT) {
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          uint32_t a[4], ah[4], al[4];
          ldsm4(st + (pool_a[m] ^ (ks << 5)), a);
          split(a, ah, al);
          mma3(pacc[m][0], ah, al, pbh[ks][0], pbl[ks][0], 0);
          mma3(pacc[m][1], ah, al, pbh[ks][0], pbl[ks][0], 1);
          mma3(pacc[m][2], ah, al, pbh[ks][1], pbl[ks][1], 0);
          mma3(pacc[m][3], ah, al, pbh[ks][1], pbl[ks][1], 1);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free

  // epilogue 1: z = pool sums * ps + pb at in-grid positions, -inf outside
  float* z = reinterpret_cast<float*>(f32_smem);
  const int frow = lane >> 2;          // accumulator rows frow, frow + 8
  const int fcol = 2 * (lane & 3);     // and columns fcol, fcol + 1 of an n tile
#pragma unroll
  for (int m = 0; m < MT_PER_WARP; ++m) {
    const int mt = warp + m * NWARP;
    if (mt >= NMT) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int pos = mt * 16 + frow + 8 * half;
      if (pos >= NPOS) continue;
      const int r = R0 + pos / WCOLS, q = Q0 + pos % WCOLS;
      const bool in = r >= 0 && r < 2 * Hh && q >= 0 && q < 2 * Wh;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = 8 * j + fcol;
        float2 val = make_float2(-INFINITY, -INFINITY);
        if (in && n < Cout) {
          val.x = pacc[m][j][2 * half] * ps[n] + pb[n];
          val.y = pacc[m][j][2 * half + 1] * ps[n + 1] + pb[n + 1];
        }
        *reinterpret_cast<float2*>(z + pos * ZSTRIDE + n) = val;
      }
    }
  }
  __syncthreads();

  // epilogue 2: conv affine + 3x3 stride-2 max of z + ReLU into an output
  // tile behind z
  float* otile = z + NPOS * ZSTRIDE;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int jj = frow + 8 * half;  // pixel (warp, jj) of the tile
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = 8 * j + fcol;
      if (n >= Cout) continue;
      float2 mx = make_float2(-INFINITY, -INFINITY);
#pragma unroll
      for (int ddr = 0; ddr < 3; ++ddr)
#pragma unroll
        for (int ddc = 0; ddc < 3; ++ddc) {
          const int pos = (2 * warp + ddr) * WCOLS + 2 * jj + ddc;
          const float2 zz = *reinterpret_cast<const float2*>(z + pos * ZSTRIDE + n);
          mx.x = fmaxf(mx.x, zz.x);
          mx.y = fmaxf(mx.y, zz.y);
        }
      *reinterpret_cast<float2*>(otile + (warp * TW + jj) * OSTRIDE + n) =
          make_float2(fmaxf(cacc[j][2 * half] * cs[n] + cb[n] + mx.x, 0.f),
                      fmaxf(cacc[j][2 * half + 1] * cs[n + 1] + cb[n + 1] + mx.y, 0.f));
    }
  }
  __syncthreads();

  // store: Cout / 4 16-byte units a pixel, ragged edges masked
  const int upp = Cout / 4;
  for (int i = tid; i < TR * TW * upp; i += NTHR) {
    const int px = i / upp, u = i % upp;
    const int a = r0 + px / TW, c = c0 + px % TW;
    if (a < Hh && c < Wh)
      *reinterpret_cast<float4*>(out + ((((size_t)v * Bt + b) * Hh + a) * Wh + c) * Cout +
                                 u * 4) =
          *reinterpret_cast<const float4*>(otile + px * OSTRIDE + u * 4);
  }
}

template <bool VEC>
int launch(const void* g, const void* k3p, const void* k1p, const void* cs, const void* cb,
           const void* ps, const void* pb, void* out, int Bt, int nT, int Hh, int Wh, int C,
           int Cout, cudaStream_t stream) {
  // the shared-memory opt-in once per device, not at every launch
  static std::atomic<unsigned long long> opted_in{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (!(opted_in.load(std::memory_order_relaxed) & bit)) {
    err = cudaFuncSetAttribute(header_f32_kernel<VEC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    opted_in.fetch_or(bit, std::memory_order_relaxed);
  }
  const int tiles_w = (Wh + TW - 1) / TW;
  const int tiles_h = (Hh + TR - 1) / TR;
  header_f32_kernel<VEC><<<dim3(tiles_h * tiles_w, Bt, NPH), NTHR, SMEM_BYTES, stream>>>(
      static_cast<const float*>(g), static_cast<const float*>(k3p),
      static_cast<const float*>(k1p), static_cast<const float*>(cs),
      static_cast<const float*>(cb), static_cast<const float*>(ps),
      static_cast<const float*>(pb), static_cast<float*>(out), Bt, nT, Hh, Wh, C, Cout,
      tiles_w);
  return (int)cudaGetLastError();
}

int launch_f32(const void* g, const void* k3p, const void* k1p, const void* cs, const void* cb,
               const void* ps, const void* pb, void* out, int Bt, int nT, int Hh, int Wh,
               int C, int Cout, cudaStream_t stream) {
  if (C % 4 == 0)
    return launch<true>(g, k3p, k1p, cs, cb, ps, pb, out, Bt, nT, Hh, Wh, C, Cout, stream);
  return launch<false>(g, k3p, k1p, cs, cb, ps, pb, out, Bt, nT, Hh, Wh, C, Cout, stream);
}

}  // namespace f32

}  // namespace

// g (Bt*T, 4, Hh+2, Wh, 4*C) phase-outer, row-padded; cs, cb, ps, pb (Cout,)
// float32 conv and pool eval-BN affines; out (4, Bt, Hh, Wh, Cout) in g's
// type; k3 (T, 9, Cout, C) and k1 (T, Cout, C) in g's type, packed
// K-contiguous (`pack_header_weights`); Cout % 8 == 0, Cout <= 32, 16-byte
// aligned pointers, frames of fewer than 2^31 elements. bfloat16
// (is_bf16 = 1): C % 16 == 0; float32: any C. All contiguous on one
// device. Returns a cudaError_t value (0 on success).
extern "C" int streammos_fused_header_tta(const void* g, const void* k3, const void* k1,
                                          const void* cs, const void* cb, const void* ps,
                                          const void* pb, void* out, int Bt, int nT, int Hh,
                                          int Wh, int C, int Cout, int is_bf16,
                                          void* stream) {
  if (Bt < 1 || nT < 1 || Hh < 1 || Wh < 1 || C < 1 || Cout < 8 || Cout % 8 || Cout > 32)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    // the window offsets are 32-bit within one frame
    if (C % 16 || (size_t)NPH * (Hh + 2) * Wh * NPH * C >= ((size_t)1 << 31))
      return (int)cudaErrorInvalidValue;
    return tc::launch_bf16(g, k3, k1, cs, cb, ps, pb, out, Bt, nT, Hh, Wh, C, Cout, s);
  }
  if ((size_t)NPH * (Hh + 2) * Wh * NPH * C >= ((size_t)1 << 31))
    return (int)cudaErrorInvalidValue;
  return f32::launch_f32(g, k3, k1, cs, cb, ps, pb, out, Bt, nT, Hh, Wh, C, Cout, s);
}
