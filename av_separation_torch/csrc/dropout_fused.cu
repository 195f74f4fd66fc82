// The model's residual, positional-encoding and FFN dropout sites, fused:
// each site's uint8 draw, keep mask, survivor scale, activation and
// residual add in one kernel forward and one backward, float32 and bf16,
// for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package leaves this chain to XLA's
// fusion (av_separation_tpu/ops/dropout.py, ops/activations.py).  In the
// port it replaces PyTorch's chain at each site: a compare to a bool mask,
// the activation, a product, a `where` and the residual add; backward a
// product and a `where`, and for GELU the derivative's ten float32 ops and
// two casts besides.
//
// Epilogues (EPI), forward, with keep = bits >= n and s the survivor scale:
//   0 dropout        out = keep ? x*s : 0
//   1 dropout_add    out = res + (keep ? x*s : 0)
//   2 relu_dropout   out = keep ? relu(x)*s : 0
//   3 gelu_dropout   out = keep ? gelu(x)*s : 0
//   4 silu_dropout   out = keep ? silu(x)*s : 0
// backward, dx from the gradient g of out:
//   0, 1             dx = keep ? g*s : 0     (the residual's gradient is g)
//   2                dx = out > 0 ? g*s : 0  (from the saved output)
//   3                dx = keep ? (g*gelu'(x))*s : 0
//   4                dx = keep ? (g*silu'(x))*s : 0
//
// Numbers.  A value is rounded to x's dtype wherever the PyTorch chain
// (the plain version, ops/kernels/dropout_fused.py) rounds it: x*s, then
// the add; gelu(x) and gelu'(x), silu(x) and silu'(x); g*gelu'(x) or
// g*silu'(x), then *s.  Products and sums are __fmul_rn / __fadd_rn, which
// nvcc never contracts into an FMA, so gelu'(x) and silu'(x) repeat the
// chain's float32 sequences op for op, with erff and expf; gelu(x) and
// silu(x) are PyTorch's own expressions.  A dropped element is
// selected away, never multiplied by 0: a dropped NaN gives 0.
//
// Design.  Memory-bound: a few operations a byte.  A thread takes one
// 16-byte vector of x, res and the output a step (4 float32 or 8 bf16
// elements) and its draws in one 4- or 8-byte load, so every load and
// store of a warp covers 512 contiguous bytes; a grid-stride loop over
// the flat tensor, on one wave of the blocks the SMs hold at once (15-40
// registers: 6-8 blocks of 256 threads an SM); no shared memory.  Sixteen
// contiguous elements a thread (one 16-byte load of the draw) measured
// 58-68% of the bytes' bound in float32 on an H100, the warp's accesses
// 64 bytes apart; one vector a step reads 80-87% in both dtypes.  The
// draw may be a column block of a wider draw (a TP rank's share): its
// rows lie `ld` bytes apart.  Where a row is not a whole number of
// vectors, or a pointer not aligned to them, the same loop takes one
// element a step (VEC false).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr int kThreads = 256;

enum { kDropout = 0, kDropoutAdd = 1, kRelu = 2, kGelu = 3, kSilu = 4 };

// float(1 / sqrt(2)) and float(1 / sqrt(2 pi)): the chain's scalars as a
// float32 tensor op rounds them.
constexpr float kRsqrt2 = 0x1.6a09e6p-1f;
constexpr float kRsqrt2Pi = 0x1.988454p-2f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T, held as a float.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// PyTorch's exact GELU: x * 0.5 * (1 + erf(x * (1 / sqrt 2))).
__device__ __forceinline__ float gelu(float v) {
  return __fmul_rn(__fmul_rn(v, 0.5f),
                   __fadd_rn(1.0f, erff(__fmul_rn(v, kRsqrt2))));
}

// ops/kernels/dropout_fused.py:gelu_grad, one float32 op at a time:
// 0.5 * (1 + erf(x c1)) + x * (exp((-0.5 x) x) c2).
__device__ __forceinline__ float gelu_grad(float v) {
  const float cdf =
      __fmul_rn(0.5f, __fadd_rn(1.0f, erff(__fmul_rn(v, kRsqrt2))));
  const float pdf =
      __fmul_rn(expf(__fmul_rn(__fmul_rn(-0.5f, v), v)), kRsqrt2Pi);
  return __fadd_rn(cdf, __fmul_rn(v, pdf));
}

// PyTorch's SiLU: x / (1 + exp(-x)).
__device__ __forceinline__ float silu(float v) {
  return __fdiv_rn(v, __fadd_rn(1.0f, expf(-v)));
}

// ops/kernels/dropout_fused.py:silu_grad, one float32 op at a time:
// sig = 1 / (1 + exp(-x)); sig * (1 + x * (1 - sig)).
__device__ __forceinline__ float silu_grad(float v) {
  const float sig = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-v)));
  return __fmul_rn(sig, __fadd_rn(1.0f, __fmul_rn(v, __fsub_rn(1.0f, sig))));
}

// relu as torch.relu (clamp_min): a NaN passes.
__device__ __forceinline__ float relu(float v) {
  return (v > 0.0f || v != v) ? v : 0.0f;
}

template <typename T, int EPI>
__device__ __forceinline__ float fwd_one(float x, float res, bool keep,
                                         float s) {
  float a = x;
  if (EPI == kRelu) a = relu(x);
  if (EPI == kGelu) a = round_to<T>(gelu(x));
  if (EPI == kSilu) a = round_to<T>(silu(x));
  const float out = keep ? round_to<T>(__fmul_rn(a, s)) : 0.0f;
  return EPI == kDropoutAdd ? round_to<T>(__fadd_rn(res, out)) : out;
}

// `saved` is the forward's output for relu, x for GELU and SiLU, unused
// otherwise.
template <typename T, int EPI>
__device__ __forceinline__ float bwd_one(float g, float saved, bool keep,
                                         float s) {
  if (EPI == kRelu) keep = saved > 0.0f;
  if (EPI == kGelu)
    g = round_to<T>(__fmul_rn(g, round_to<T>(gelu_grad(saved))));
  if (EPI == kSilu)
    g = round_to<T>(__fmul_rn(g, round_to<T>(silu_grad(saved))));
  return keep ? round_to<T>(__fmul_rn(g, s)) : 0.0f;
}

// Elements a 16-byte vector holds: 4 float32, 8 bf16.
template <typename T>
constexpr int kVec = 16 / static_cast<int>(sizeof(T));

// One 16-byte vector from / to 16-byte aligned memory, as floats.
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  const float4 w = *reinterpret_cast<const float4*>(p);
  v[0] = w.x;
  v[1] = w.y;
  v[2] = w.z;
  v[3] = w.w;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* v) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    // A bf16 is the high half of its float.
    v[2 * j] = __uint_as_float(u[j] << 16);
    v[2 * j + 1] = __uint_as_float(u[j] & 0xffff0000u);
  }
}

__device__ __forceinline__ void store_vec(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// The values are bf16 already (round_to): their high halves, exactly.
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* v) {
  uint32_t u[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    u[j] = (__float_as_uint(v[2 * j]) >> 16) |
           (__float_as_uint(v[2 * j + 1]) & 0xffff0000u);
  *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
}

// The keep flags of the V draws at p: one 4-byte (V 4) or 8-byte load.
template <int V>
__device__ __forceinline__ void keep_vec(const uint8_t* p, int n,
                                         bool* keep) {
  uint32_t u[V / 4];
  if constexpr (V == 4) {
    u[0] = *reinterpret_cast<const uint32_t*>(p);
  } else {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    u[0] = w.x;
    u[1] = w.y;
  }
#pragma unroll
  for (int j = 0; j < V; ++j)
    keep[j] = static_cast<int>((u[j / 4] >> (8 * (j % 4))) & 0xffu) >= n;
}

// The draw's offset of element e: row e / cols, `ld` bytes a row (e
// itself for a whole draw; a 32-bit division where e fits).
__device__ __forceinline__ long long bits_at(long long e, long long cols,
                                             long long ld) {
  if (ld == cols) return e;
  long long row;
  if (e <= 0xffffffffLL && cols <= 0xffffffffLL)
    row = static_cast<unsigned>(e) / static_cast<unsigned>(cols);
  else
    row = e / cols;
  return row * ld + (e - row * cols);
}

template <typename T, int EPI, bool VEC>
__global__ void __launch_bounds__(kThreads)
    dropout_fused_fwd_kernel(const T* __restrict__ x, const T* __restrict__ res,
                             const uint8_t* __restrict__ bits,
                             T* __restrict__ out, long long numel,
                             long long cols, long long ld, int n, float s) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if constexpr (VEC) {
    constexpr int V = kVec<T>;
    for (; i < numel / V; i += stride) {
      const long long e = i * V;
      float xv[V], rv[V], ov[V];
      bool keep[V];
      load_vec(x + e, xv);
      if (EPI == kDropoutAdd) load_vec(res + e, rv);
      keep_vec<V>(bits + bits_at(e, cols, ld), n, keep);
#pragma unroll
      for (int j = 0; j < V; ++j)
        ov[j] = fwd_one<T, EPI>(xv[j], EPI == kDropoutAdd ? rv[j] : 0.0f,
                                keep[j], s);
      store_vec(out + e, ov);
    }
  } else {
    for (; i < numel; i += stride) {
      const float r = EPI == kDropoutAdd ? to_f(res[i]) : 0.0f;
      const bool keep = bits[bits_at(i, cols, ld)] >= n;
      out[i] = from_f<T>(fwd_one<T, EPI>(to_f(x[i]), r, keep, s));
    }
  }
}

template <typename T, int EPI, bool VEC>
__global__ void __launch_bounds__(kThreads)
    dropout_fused_bwd_kernel(const T* __restrict__ g,
                             const T* __restrict__ saved,
                             const uint8_t* __restrict__ bits,
                             T* __restrict__ dx, long long numel,
                             long long cols, long long ld, int n, float s) {
  constexpr bool kReadsSaved = EPI == kRelu || EPI == kGelu || EPI == kSilu;
  constexpr bool kReadsBits = EPI != kRelu;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if constexpr (VEC) {
    constexpr int V = kVec<T>;
    for (; i < numel / V; i += stride) {
      const long long e = i * V;
      float gv[V], sv[V], dv[V];
      bool keep[V];
      load_vec(g + e, gv);
      if (kReadsSaved) load_vec(saved + e, sv);
      if (kReadsBits) keep_vec<V>(bits + bits_at(e, cols, ld), n, keep);
#pragma unroll
      for (int j = 0; j < V; ++j)
        dv[j] = bwd_one<T, EPI>(gv[j], kReadsSaved ? sv[j] : 0.0f,
                                kReadsBits ? keep[j] : false, s);
      store_vec(dx + e, dv);
    }
  } else {
    for (; i < numel; i += stride) {
      const float sv = kReadsSaved ? to_f(saved[i]) : 0.0f;
      const bool keep = kReadsBits && bits[bits_at(i, cols, ld)] >= n;
      dx[i] = from_f<T>(bwd_one<T, EPI>(to_f(g[i]), sv, keep, s));
    }
  }
}

struct Args {
  const void* a;      // x (forward) or g (backward)
  const void* b;      // res (forward) or the saved tensor (backward)
  const uint8_t* bits;
  void* out;
  long long numel, cols, ld;
  int n;
  float s;
  int sms;
  cudaStream_t stream;
};

// One wave of resident blocks, each looping over its share: a grid the
// card cannot hold at once leaves its last partial wave running alone.
// `resident` caches the blocks an SM holds of `kernel`, one per instance.
template <typename K>
int wave(K kernel, int& resident, long long steps, int sms) {
  if (resident == 0 &&
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel,
                                                    kThreads, 0) != cudaSuccess)
    resident = 1;
  const long long most = 1LL * resident * sms;
  const long long need = (steps + kThreads - 1) / kThreads;
  return static_cast<int>(need < most ? need : most);
}

template <typename T, int EPI, bool BWD, bool VEC>
cudaError_t launch(const Args& a) {
  static int resident = 0;
  const T* in = static_cast<const T*>(a.a);
  const T* other = static_cast<const T*>(a.b);
  T* out = static_cast<T*>(a.out);
  const long long steps = VEC ? a.numel / kVec<T> : a.numel;
  if constexpr (BWD) {
    const auto k = dropout_fused_bwd_kernel<T, EPI, VEC>;
    k<<<wave(k, resident, steps, a.sms), kThreads, 0, a.stream>>>(
        in, other, a.bits, out, a.numel, a.cols, a.ld, a.n, a.s);
  } else {
    const auto k = dropout_fused_fwd_kernel<T, EPI, VEC>;
    k<<<wave(k, resident, steps, a.sms), kThreads, 0, a.stream>>>(
        in, other, a.bits, out, a.numel, a.cols, a.ld, a.n, a.s);
  }
  return cudaGetLastError();
}

template <typename T, bool BWD, bool VEC>
cudaError_t by_epilogue(int epi, const Args& a) {
  switch (epi) {
    case kDropout: return launch<T, kDropout, BWD, VEC>(a);
    // The backward of dropout_add is dropout's.
    case kDropoutAdd:
      return launch<T, BWD ? kDropout : kDropoutAdd, BWD, VEC>(a);
    case kRelu: return launch<T, kRelu, BWD, VEC>(a);
    case kGelu: return launch<T, kGelu, BWD, VEC>(a);
    case kSilu: return launch<T, kSilu, BWD, VEC>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <bool BWD>
cudaError_t dispatch(int dtype, int epi, int vec, const Args& a) {
  if (dtype == 0)
    return vec ? by_epilogue<float, BWD, true>(epi, a)
               : by_epilogue<float, BWD, false>(epi, a);
  if (dtype == 1)
    return vec ? by_epilogue<__nv_bfloat16, BWD, true>(epi, a)
               : by_epilogue<__nv_bfloat16, BWD, false>(epi, a);
  return cudaErrorInvalidValue;
}

bool bad_args(int dtype, int epi, long long numel, long long cols,
              long long ld, int n, int vec, int sms) {
  const int v = dtype == 0 ? kVec<float> : kVec<__nv_bfloat16>;
  return dtype < 0 || dtype > 1 || epi < 0 || epi > kSilu || numel <= 0 ||
         cols <= 0 || ld < cols || sms <= 0 || n < 1 || n > 255 ||
         (vec && (cols % v || ld % v));
}

}  // namespace

// out = epilogue(x, res) on `numel` elements of x's dtype (0 float32,
// 1 bf16), keep = bits >= n with bits' rows `ld` bytes apart, `cols`
// elements a row; `sms` the card's SMs; vec: a 16-byte vector a thread
// a step (cols and ld whole vectors, x, res and out 16-byte aligned, bits
// aligned to a vector's draws).
extern "C" int avsep_dropout_fwd(int dtype, int epi, const void* x,
                                 const void* res, const void* bits, void* out,
                                 long long numel, long long cols, long long ld,
                                 int n, float scale, int vec, int sms,
                                 int device, void* stream) {
  if (bad_args(dtype, epi, numel, cols, ld, n, vec, sms))
    return cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  const cudaError_t err = guard.error();
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{x, res, static_cast<const uint8_t*>(bits), out, numel, cols,
               ld, n, scale, sms, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch<false>(dtype, epi, vec, a));
}

// dx from g, the backward of epilogue `epi`: `saved` is the forward's
// output (relu_dropout) or its x (gelu_dropout, silu_dropout), unused
// otherwise.
extern "C" int avsep_dropout_bwd(int dtype, int epi, const void* g,
                                 const void* saved, const void* bits, void* dx,
                                 long long numel, long long cols, long long ld,
                                 int n, float scale, int vec, int sms,
                                 int device, void* stream) {
  if (bad_args(dtype, epi, numel, cols, ld, n, vec, sms))
    return cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  const cudaError_t err = guard.error();
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{g, saved, static_cast<const uint8_t*>(bits), dx, numel, cols,
               ld, n, scale, sms, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch<true>(dtype, epi, vec, a));
}

extern "C" const char* avsep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
