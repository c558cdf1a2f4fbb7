// Eval BatchNorm epilogue for Hopper (sm_90a): `bn_act` on CUDA tensors,
// the per-channel affine of a BN in eval mode, the optional per-(sample,
// channel) gate, the optional residual and the activation in one pass.
//
// Replaces no TPU kernel: the JAX package's eval BN (streammos_tpu/nn/
// blocks.py, `BN` and `FoldedBatchNorm`) is plain XLA, which fuses it into
// its neighbours. It replaces the port's chain of PyTorch ops of each eval
// BN: five launches for scale and shift on the (C,) buffers, two casts, two
// `repeat`s on the folded point layout, one `addcmul` over the activation,
// then one pass each for the gate, the residual add and the activation (the
// leaky ReLU three). The plain version is `bn_act_reference`
// (ops/bn_act.py).
//
// What it computes, element i of x in channel c(i) = (i / inner) % C:
//   s = weight[c] / sqrt(running_var[c] + eps)
//   b = bias[c] - running_mean[c] * s
//   y[i] = act((x[i] * s + b) * gate[n(i) * C + c] + r[i])
// n(i) = i / per_sample; the gate and r optional; act none, ReLU, or leaky
// ReLU (y >= 0 ? y : 0.01 y). Every operation in float32, rounded to
// nearest as its own PyTorch op rounds (`__fmul_rn` and friends, so nvcc
// contracts nothing into an FMA), then y rounded once to x's type. s and b
// are read from BN's float32 buffers where they lie at each launch, so a
// CUDA graph replay sees weights written in place. Layouts, by `inner`:
// NCHW-contiguous (inner = H * W), channels-last-contiguous and the folded
// point layout (..., fold * C) (inner = 1); r and y in x's layout.
//
// Bound: the card's memory, about 0.3 FLOP a byte: x read, r read, y
// written once each (2 or 3 x 2 bytes an element in bf16); s and b are a
// few hundred floats.
//
// Design: a grid-stride pass over 16-byte vectors (8 bf16 or 4 float32 of
// consecutive elements), one load of x and of r and one store a vector,
// neighbouring threads on neighbouring vectors. Each block first computes
// the C scales and shifts into shared memory. A vector's first channel
// comes from two divisions by `inner` and C, done as a multiply-high and a
// shift with magic numbers made on the host (32-bit element indices: the
// host cuts a tensor of more than 2^30 elements into launches of whole
// samples, at most 2^30 elements each); the channel of each further element
// follows by counting, so C need not divide the vector (the point MLP's
// input BN has C = 7, fold 4). Enough blocks to fill every SM eight times
// over. Pointers that are not 16-byte aligned take the same kernel one
// element a thread. (Measured on the card at the 58 sites of a
// StreamMOS_seg step and dropped: a thread loading four vectors before it
// computes the first, 108 registers, 1.8x slower at Bt = 1 and 4.)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;
constexpr int MAX_C = 4096;                  // 32 KB of shared scales and shifts
constexpr long long CHUNK = 1LL << 30;       // elements a launch at most

enum Act { NONE = 0, RELU = 1, LEAKY = 2 };

// n / d for n < 2^31 and 1 <= d <= 2^31, as a multiply-high, an add and a
// shift (Granlund and Montgomery; PyTorch's IntDivider<unsigned>)
struct Div {
  unsigned d, m, s;
};

Div make_div(unsigned d) {
  unsigned s = 0;
  while (s < 31 && (1u << s) < d) ++s;
  const uint64_t one = 1;
  return {d, (unsigned)(((one << 32) * ((one << s) - d)) / d + 1), s};
}

__device__ __forceinline__ unsigned quot(const Div& v, unsigned n) {
  return (__umulhi(n, v.m) + n) >> v.s;
}

struct Params {
  const void* x;
  const void* r;  // null: no residual
  const void* g;  // null: no gate
  void* y;
  const float* weight;
  const float* bias;
  const float* mean;
  const float* var;
  float eps;
  unsigned n;  // elements of this launch
  unsigned C, inner, per_sample;
  Div by_inner, by_c, by_sample;
  int act;
};

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f(float v, float& o) { o = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16& o) { o = __float2bfloat16_rn(v); }

__device__ __forceinline__ float activate(float v, int act) {
  if (act == RELU) return v < 0.f ? 0.f : v;  // NaN stays NaN, as torch.relu
  if (act == LEAKY) return v >= 0.f ? v : __fmul_rn(0.01f, v);
  return v;
}

// one element in channel c of sample n
template <typename T>
__device__ __forceinline__ float epilogue(float xv, const float* ss, const float* sh, unsigned c,
                                          unsigned n, const Params& p, const T* g, float rv) {
  float t = __fadd_rn(__fmul_rn(xv, ss[c]), sh[c]);
  if (g) t = __fmul_rn(t, to_f(g[(size_t)n * p.C + c]));
  if (p.r) t = __fadd_rn(t, rv);
  return activate(t, p.act);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS) bn_act_kernel(Params p) {
  extern __shared__ float smem[];
  float* ss = smem;
  float* sh = smem + p.C;
  for (unsigned c = threadIdx.x; c < p.C; c += THREADS) {
    const float s = __fdiv_rn(p.weight[c], __fsqrt_rn(__fadd_rn(p.var[c], p.eps)));
    ss[c] = s;
    sh[c] = __fsub_rn(p.bias[c], __fmul_rn(p.mean[c], s));
  }
  __syncthreads();
  const T* x = static_cast<const T*>(p.x);
  const T* r = static_cast<const T*>(p.r);
  const T* g = static_cast<const T*>(p.g);
  T* y = static_cast<T*>(p.y);
  const unsigned nvec = (p.n + VEC - 1) / VEC;
  for (unsigned v = blockIdx.x * THREADS + threadIdx.x; v < nvec; v += gridDim.x * THREADS) {
    const unsigned e = v * VEC;
    const unsigned q = quot(p.by_inner, e);
    unsigned at = e - q * p.inner;  // position within the run of one channel
    unsigned c = q - quot(p.by_c, q) * p.C;
    unsigned n = 0, in_sample = 0;
    if (g) {
      n = quot(p.by_sample, e);
      in_sample = e - n * p.per_sample;
    }
    if (e + VEC <= p.n) {
      const Pack<T, VEC> xv = *reinterpret_cast<const Pack<T, VEC>*>(x + e);
      Pack<T, VEC> rv;
      if (r) rv = *reinterpret_cast<const Pack<T, VEC>*>(r + e);
      Pack<T, VEC> out;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        from_f(epilogue<T>(to_f(xv.v[j]), ss, sh, c, n, p, g, r ? to_f(rv.v[j]) : 0.f),
               out.v[j]);
        if (++at == p.inner) {
          at = 0;
          if (++c == p.C) c = 0;
        }
        if (g && ++in_sample == p.per_sample) {
          in_sample = 0;
          ++n;
        }
      }
      *reinterpret_cast<Pack<T, VEC>*>(y + e) = out;
    } else {  // the ragged end of the last vector
      for (unsigned i = e; i < p.n; ++i) {
        from_f(epilogue<T>(to_f(x[i]), ss, sh, c, n, p, g, r ? to_f(r[i]) : 0.f), y[i]);
        if (++at == p.inner) {
          at = 0;
          if (++c == p.C) c = 0;
        }
        if (g && ++in_sample == p.per_sample) {
          in_sample = 0;
          ++n;
        }
      }
    }
  }
}

int sm_count() {
  static int count[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (count[dev] == 0 &&
      cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 132;
  return count[dev];
}

template <typename T, int VEC>
int launch(const Params& p, cudaStream_t stream) {
  const long long nvec = ((long long)p.n + VEC - 1) / VEC;
  long long blocks = (nvec + THREADS - 1) / THREADS;
  const long long most = (long long)sm_count() * BLOCKS_PER_SM;
  if (blocks > most) blocks = most;
  bn_act_kernel<T, VEC><<<(unsigned)blocks, THREADS, 2 * p.C * sizeof(float), stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// x, r (or null), y: `total` elements of float32 or bfloat16 (is_bf16) in
// one layout, element i in channel (i / inner) % C. g (or null): the gate,
// (total / per_sample, C) contiguous in x's type; per_sample then a
// multiple of inner * C. weight, bias, running_mean, running_var: (C,)
// contiguous float32 on the card. act: 0 none, 1 ReLU, 2 leaky ReLU
// (0.01). Launches on `stream` (several launches for more than 2^30
// elements, each of whole samples) and does not synchronise. Returns a
// cudaError_t value (0 on success).
extern "C" int streammos_bn_act(const void* x, const void* r, const void* g, void* y,
                                const void* weight, const void* bias, const void* mean,
                                const void* var, float eps, long long total, long long inner,
                                int C, long long per_sample, int act, int is_bf16,
                                void* stream) {
  const int item = is_bf16 ? 2 : 4;
  const long long vec = 16 / item;
  const long long unit = g ? per_sample : inner * C;  // a launch holds whole units
  if (total < 0 || inner < 1 || C < 1 || C > MAX_C || per_sample < 1 || act < NONE ||
      act > LEAKY || (g && per_sample % (inner * C)) || (g && total % per_sample) ||
      unit > CHUNK)
    return (int)cudaErrorInvalidValue;
  const bool aligned = (uintptr_t)x % 16 == 0 && (uintptr_t)y % 16 == 0 &&
                       (uintptr_t)r % 16 == 0;
  long long a = unit, b = vec;  // whole units and whole vectors: lcm(unit, vec)
  while (b) {
    const long long t = a % b;
    a = b;
    b = t;
  }
  const long long whole = unit / a * vec;
  if (whole > CHUNK) return (int)cudaErrorInvalidValue;
  const long long chunk = CHUNK / whole * whole;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Params p;
  p.weight = static_cast<const float*>(weight);
  p.bias = static_cast<const float*>(bias);
  p.mean = static_cast<const float*>(mean);
  p.var = static_cast<const float*>(var);
  p.eps = eps;
  p.C = (unsigned)C;
  p.inner = (unsigned)(inner < CHUNK ? inner : CHUNK);
  p.per_sample = (unsigned)(per_sample < CHUNK ? per_sample : CHUNK);
  p.by_inner = make_div(p.inner);
  p.by_c = make_div(p.C);
  p.by_sample = make_div(p.per_sample);
  p.act = act;
  for (long long start = 0; start < total; start += chunk) {
    const long long n = total - start < chunk ? total - start : chunk;
    const size_t off = (size_t)start * item;
    p.x = static_cast<const char*>(x) + off;
    p.r = r ? static_cast<const char*>(r) + off : nullptr;
    p.g = g ? static_cast<const char*>(g) + (size_t)(start / per_sample) * C * item : nullptr;
    p.y = static_cast<char*>(y) + off;
    p.n = (unsigned)n;
    int err;
    if (is_bf16)
      err = aligned ? launch<__nv_bfloat16, 8>(p, st) : launch<__nv_bfloat16, 1>(p, st);
    else
      err = aligned ? launch<float, 4>(p, st) : launch<float, 1>(p, st);
    if (err != 0) return err;
  }
  return 0;
}
