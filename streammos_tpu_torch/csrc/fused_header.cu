// Fused TTA header for Hopper (sm_90a): the header DownSample2D of all four
// test-time-augmentation variants in one launch, read straight from the
// phase-outer scatter output.
//
// Replaces the TPU kernel `_pair_kernel` of streammos_tpu/ops/fused_header.py
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
// canonical half-res rows (`_axis_taps`, `_pool_axis_taps` there):
//   unflipped: (offset -1, phase 1, k 0), (0, 0, 1), (0, 1, 2)
//   flipped:   (offset +1, phase 0, k 0), (0, 1, 1), (0, 0, 2)
// No variant-oriented or full-resolution copy of the grid is ever written.
// The one-row padding above and below each phase plane is never read: rows
// outside the grid are zero by the index test, whatever the padding holds.
//
// Bound: at the production shape (G 3x4x258x256x256 bf16, of which the
// 403 MB between the padding rows is read; output 4x1x256x256x32, 17 MB)
// the function moves ~420 MB and does ~42 GFLOP, so the card's memory rate
// bounds it (~0.125 ms at 3.35 TB/s). This first version
// does its arithmetic in float32 on the CUDA cores and does not reach that
// bound: each block stages a (TR+2) x (TW+2) half-res window of one
// variant's channels in shared memory, channel chunk by channel chunk, so
// G is read ~1.4x (halo) and only once per variant's channel block, and the
// pool branch's 1x1 conv values for the tile plus its one-pixel halo are
// accumulated in shared memory, never in device memory. Tensor cores
// (wgmma), TMA and a deeper pipeline are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int TR = 8;          // anchored output rows per block
constexpr int TW = 16;         // anchored output columns per block
constexpr int WR = TR + 2;     // staged window rows (one halo row each side)
constexpr int WC = TW + 2;     // staged window columns
constexpr int NPH = 4;         // phases: 2 * row bit + column bit
constexpr int OPT = 8;         // output channels per thread
constexpr int MAX_COUT = 32;   // 4 channel groups: 512 threads per block

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// tap t (0..2) of one axis, canonical-anchored: half-res offset and phase
// bit; the 3x3 kernel index along the axis is t itself
__device__ __forceinline__ void axis_tap(int flip, int t, int& off, int& ph) {
  if (t == 0) {
    off = flip ? 1 : -1;
    ph = flip ? 0 : 1;
  } else {
    off = 0;
    ph = (t == 1) == (flip != 0) ? 1 : 0;
  }
}

template <typename T, int CK>
__global__ void __launch_bounds__(TR * TW * (MAX_COUT / OPT))
fused_header_kernel(const T* __restrict__ g, const T* __restrict__ k3,
                    const T* __restrict__ k1, const float* __restrict__ cs,
                    const float* __restrict__ cb, const float* __restrict__ ps,
                    const float* __restrict__ pb, T* __restrict__ out, int Bt,
                    int nT, int Hh, int Wh, int C, int Cout, int tiles_w) {
  extern __shared__ float smem[];
  float* s_in = smem;                      // [NPH][CK][WR][WC]
  float* s_k3 = s_in + NPH * CK * WR * WC;  // [3][3][CK][Cout]
  float* s_k1 = s_k3 + 9 * CK * Cout;       // [CK][Cout]
  float* s_z = s_k1 + CK * Cout;            // [NPH][WR][WC][Cout]

  const int NG = Cout / OPT;
  const int v = blockIdx.z;
  const int b = blockIdx.y;
  const int fx = v >> 1, fy = v & 1;
  const int r0 = (blockIdx.x / tiles_w) * TR;
  const int c0 = (blockIdx.x % tiles_w) * TW;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int grp = tid % NG;  // this thread's channel group
  const int pix = tid / NG;  // and pixel of the tile
  const int pr = pix / TW, pc = pix % TW;
  const int VC = NPH * C;
  const int Hp = Hh + 2;
  const int TC = nT * C;

  for (int i = tid; i < NPH * WR * WC * Cout; i += nthr) s_z[i] = 0.f;

  float acc[OPT];
#pragma unroll
  for (int o = 0; o < OPT; ++o) acc[o] = 0.f;

  for (int t = 0; t < nT; ++t) {
    const T* gt = g + (size_t)(b * nT + t) * NPH * Hp * Wh * VC;
    for (int cbase = 0; cbase < C; cbase += CK) {
      __syncthreads();  // the previous chunk is consumed
      // stage the window of half-res rows r0-1..r0+TR, columns c0-1..c0+TW
      for (int i = tid; i < NPH * WR * WC * CK; i += nthr) {
        const int ck = i % CK;
        int rest = i / CK;
        const int wc = rest % WC;
        rest /= WC;
        const int wr = rest % WR;
        const int ph = rest / WR;
        const int h = r0 - 1 + wr, w = c0 - 1 + wc;
        float val = 0.f;
        if (h >= 0 && h < Hh && w >= 0 && w < Wh)
          val = to_f(gt[(((size_t)ph * Hp + h + 1) * Wh + w) * VC + v * C + cbase + ck]);
        s_in[((ph * CK + ck) * WR + wr) * WC + wc] = val;
      }
      for (int i = tid; i < 9 * CK * Cout; i += nthr) {
        const int o = i % Cout;
        const int rest = i / Cout;
        const int ck = rest % CK, tap = rest / CK;
        s_k3[i] = to_f(k3[((size_t)tap * TC + t * C + cbase + ck) * Cout + o]);
      }
      for (int i = tid; i < CK * Cout; i += nthr) {
        const int o = i % Cout, ck = i / Cout;
        s_k1[i] = to_f(k1[((size_t)t * C + cbase + ck) * Cout + o]);
      }
      __syncthreads();

      // conv branch: 3x3 taps of this thread's pixel
      for (int rt = 0; rt < 3; ++rt) {
        int ro, rp;
        axis_tap(fx, rt, ro, rp);
        const int lr = pr + 1 + ro;
        for (int ct = 0; ct < 3; ++ct) {
          int co, cp;
          axis_tap(fy, ct, co, cp);
          const int lc = pc + 1 + co;
          const float* xin = s_in + ((2 * rp + cp) * CK * WR + lr) * WC + lc;
          const float* wk = s_k3 + (rt * 3 + ct) * CK * Cout + grp * OPT;
#pragma unroll
          for (int ck = 0; ck < CK; ++ck) {
            const float x = xin[ck * WR * WC];
#pragma unroll
            for (int o = 0; o < OPT; ++o) acc[o] = fmaf(x, wk[ck * Cout + o], acc[o]);
          }
        }
      }

      // pool branch: 1x1 conv at every in-grid position of the window
      for (int i = tid; i < NPH * WR * WC * NG; i += nthr) {
        const int gg = i % NG;
        const int pos = i / NG;  // (ph * WR + wr) * WC + wc
        const int wc = pos % WC, wr = (pos / WC) % WR, ph = pos / (WC * WR);
        const int h = r0 - 1 + wr, w = c0 - 1 + wc;
        if (h < 0 || h >= Hh || w < 0 || w >= Wh) continue;
        const float* xin = s_in + (ph * CK * WR + wr) * WC + wc;
        const float* wk = s_k1 + gg * OPT;
        float z[OPT];
#pragma unroll
        for (int o = 0; o < OPT; ++o) z[o] = 0.f;
#pragma unroll
        for (int ck = 0; ck < CK; ++ck) {
          const float x = xin[ck * WR * WC];
#pragma unroll
          for (int o = 0; o < OPT; ++o) z[o] = fmaf(x, wk[ck * Cout + o], z[o]);
        }
        float* zs = s_z + pos * Cout + gg * OPT;
#pragma unroll
        for (int o = 0; o < OPT; ++o) zs[o] += z[o];
      }
    }
  }
  __syncthreads();

  // epilogue: affines, pool max over in-grid taps, sum, ReLU
  const int ar = r0 + pr, ac = c0 + pc;
  if (ar >= Hh || ac >= Wh) return;
  float pooled[OPT];
#pragma unroll
  for (int o = 0; o < OPT; ++o) pooled[o] = -INFINITY;
  for (int rt = 0; rt < 3; ++rt) {
    int ro, rp;
    axis_tap(fx, rt, ro, rp);
    if (ar + ro < 0 || ar + ro >= Hh) continue;
    for (int ct = 0; ct < 3; ++ct) {
      int co, cp;
      axis_tap(fy, ct, co, cp);
      if (ac + co < 0 || ac + co >= Wh) continue;
      const float* zs =
          s_z + (((2 * rp + cp) * WR + pr + 1 + ro) * WC + pc + 1 + co) * Cout + grp * OPT;
#pragma unroll
      for (int o = 0; o < OPT; ++o) {
        const int oc = grp * OPT + o;
        pooled[o] = fmaxf(pooled[o], zs[o] * ps[oc] + pb[oc]);
      }
    }
  }
  T* dst = out + ((((size_t)v * Bt + b) * Hh + ar) * Wh + ac) * Cout + grp * OPT;
#pragma unroll
  for (int o = 0; o < OPT; ++o) {
    const int oc = grp * OPT + o;
    dst[o] = from_f<T>(fmaxf(acc[o] * cs[oc] + cb[oc] + pooled[o], 0.f));
  }
}

template <typename T, int CK>
int launch(const void* g, const void* k3, const void* k1, const void* cs, const void* cb,
           const void* ps, const void* pb, void* out, int Bt, int nT, int Hh, int Wh, int C,
           int Cout, cudaStream_t stream) {
  const int tiles_w = (Wh + TW - 1) / TW;
  const int tiles_h = (Hh + TR - 1) / TR;
  const size_t smem =
      sizeof(float) * ((size_t)NPH * CK * WR * WC + 10 * CK * Cout + (size_t)NPH * WR * WC * Cout);
  auto kernel = fused_header_kernel<T, CK>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(tiles_h * tiles_w, Bt, NPH);
  const dim3 block(TR * TW * (Cout / OPT));
  kernel<<<grid, block, smem, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(k3), static_cast<const T*>(k1),
      static_cast<const float*>(cs), static_cast<const float*>(cb),
      static_cast<const float*>(ps), static_cast<const float*>(pb), static_cast<T*>(out), Bt,
      nT, Hh, Wh, C, Cout, tiles_w);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_ck(const void* g, const void* k3, const void* k1, const void* cs, const void* cb,
                const void* ps, const void* pb, void* out, int Bt, int nT, int Hh, int Wh,
                int C, int Cout, cudaStream_t stream) {
  if (C % 16 == 0)
    return launch<T, 16>(g, k3, k1, cs, cb, ps, pb, out, Bt, nT, Hh, Wh, C, Cout, stream);
  if (C % 8 == 0)
    return launch<T, 8>(g, k3, k1, cs, cb, ps, pb, out, Bt, nT, Hh, Wh, C, Cout, stream);
  return launch<T, 1>(g, k3, k1, cs, cb, ps, pb, out, Bt, nT, Hh, Wh, C, Cout, stream);
}

}  // namespace

// g (Bt*T, 4, Hh+2, Wh, 4*C) phase-outer, row-padded; k3 (3, 3, T*C, Cout)
// and k1 (1, 1, T*C, Cout) in g's type; cs, cb, ps, pb (Cout,) float32 conv
// and pool eval-BN affines; out (4, Bt, Hh, Wh, Cout) in g's type. All
// contiguous on one device. Returns a cudaError_t value (0 on success).
extern "C" int streammos_fused_header_tta(const void* g, const void* k3, const void* k1,
                                          const void* cs, const void* cb, const void* ps,
                                          const void* pb, void* out, int Bt, int nT, int Hh,
                                          int Wh, int C, int Cout, int is_bf16,
                                          void* stream) {
  if (Bt < 1 || nT < 1 || Hh < 1 || Wh < 1 || C < 1 || Cout < OPT || Cout % OPT ||
      Cout > MAX_COUT)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch_ck<__nv_bfloat16>(g, k3, k1, cs, cb, ps, pb, out, Bt, nT, Hh, Wh, C, Cout,
                                      s);
  return dispatch_ck<float>(g, k3, k1, cs, cb, ps, pb, out, Bt, nT, Hh, Wh, C, Cout, s);
}
