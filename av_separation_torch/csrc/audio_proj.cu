// Fused audio input projection forward, float32, for Hopper (sm_90a).
//
// Replaces: av_separation_tpu/ops/pallas/audio_proj.py `_proj_kernel`
// (called from `_fwd_impl`).  Computes, with torch's zero padding of both
// convolutions,
//     h[t] = relu(b1 + sum_tap x[t + tap - 1] @ W1[tap])  for t in [0, T),
//            and h = 0 outside [0, T)                      (audio_proj.py:51-56)
//     y[t] = relu(b2 + sum_tap h[t + tap - 1] @ W2[tap])
// and emits y and h, both (B, T, D).  x is (B, T, F), W1 (3, F, D),
// W2 (3, D, D) (flax conv layout, tap-major).
//
// Bound on the H100 at the scaled serving shape (B=8, T=501, F=257, D=512):
// 2*B*T*3*(F + D)*D = 9.5 GFLOP against 25 MB (x, W1, W2, y, h), so at
// 67 TFLOP/s float32 and 3.35 TB/s it is bound by operations: 141 us vs
// 7.5 us.
//
// Design: the TPU kernel kept W1 and W2 (1.6 MB and 3.1 MB) resident in VMEM;
// they cannot fit in shared memory.  A block owns 32 output frames of one
// utterance: it stages the 36 input frames it needs (tile + 2-frame halo on
// each side, zero outside [0, T)) and keeps the 34 hidden frames of the tile
// plus its 1-frame halo in shared memory (107 KB at D=512), so the hidden
// activation never round-trips through device memory before conv2.  Weights
// stream from L2 as float4 rows: each thread owns 4 output channels and half
// of the tile's frames, so each weight float4 feeds 17 (conv1) or 16 (conv2)
// frames of FMAs, against broadcast reads of the staged activations.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;              // output frames per block
constexpr int kInRows = kTile + 4;     // input frames incl. the 2-frame halos
constexpr int kHidRows = kTile + 2;    // hidden frames incl. the 1-frame halos
constexpr int kHidPer = kHidRows / 2;  // hidden frames per thread (17)
constexpr int kOutPer = kTile / 2;     // output frames per thread (16)

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ void fma4(float4& acc, float a, float4 w) {
  acc.x = fmaf(a, w.x, acc.x);
  acc.y = fmaf(a, w.y, acc.y);
  acc.z = fmaf(a, w.z, acc.z);
  acc.w = fmaf(a, w.w, acc.w);
}

// acc[i] += sum_tap sum_c src[(i0 + i + tap) * stride + c] * w[tap][c][col4]
// over NR rows; src rows are 16-byte aligned in shared memory.
template <int NR>
__device__ __forceinline__ void conv3_rows(float4 (&acc)[NR], const float* src,
                                           int stride, int i0, const float* w,
                                           int cin, int cout, int col) {
#pragma unroll 1
  for (int tap = 0; tap < 3; ++tap) {
    const float* wt = w + (size_t)tap * cin * cout + col;
    const float* s = src + (i0 + tap) * stride;
    int c = 0;
#pragma unroll 1
    for (; c + 4 <= cin; c += 4) {
      const float4 w0 = ldg4(wt + (size_t)(c + 0) * cout);
      const float4 w1 = ldg4(wt + (size_t)(c + 1) * cout);
      const float4 w2 = ldg4(wt + (size_t)(c + 2) * cout);
      const float4 w3 = ldg4(wt + (size_t)(c + 3) * cout);
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const float4 xv = ld4(s + i * stride + c);
        fma4(acc[i], xv.x, w0);
        fma4(acc[i], xv.y, w1);
        fma4(acc[i], xv.z, w2);
        fma4(acc[i], xv.w, w3);
      }
    }
    for (; c < cin; ++c) {
      const float4 wv = ldg4(wt + (size_t)c * cout);
#pragma unroll
      for (int i = 0; i < NR; ++i) fma4(acc[i], s[i * stride + c], wv);
    }
  }
}

__device__ __forceinline__ float4 bias_relu(float4 a, float4 b) {
  return make_float4(fmaxf(a.x + b.x, 0.f), fmaxf(a.y + b.y, 0.f),
                     fmaxf(a.z + b.z, 0.f), fmaxf(a.w + b.w, 0.f));
}

__global__ void __launch_bounds__(512) audio_proj_kernel(const float* __restrict__ x,
                                  const float* __restrict__ w1,
                                  const float* __restrict__ b1,
                                  const float* __restrict__ w2,
                                  const float* __restrict__ b2,
                                  float* __restrict__ y,
                                  float* __restrict__ hid,
                                  int T, int F, int D, int xs) {
  extern __shared__ float4 smem4[];
  float* sX = reinterpret_cast<float*>(smem4);  // (kInRows, xs)
  float* sH = sX + kInRows * xs;                // (kHidRows, D)

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kTile;
  const int groups = D / 4;
  const int col = (threadIdx.x % groups) * 4;
  const int half = threadIdx.x / groups;  // 0 or 1, uniform per warp

  // Input frames t0-2 .. t0+kTile+1, zero outside [0, T) and in the pad
  // columns [F, xs).
  const float* xb = x + (size_t)b * T * F;
  for (int i = threadIdx.x; i < kInRows * xs; i += blockDim.x) {
    const int r = i / xs, c = i % xs;
    const int t = t0 - 2 + r;
    sX[i] = (c < F && t >= 0 && t < T) ? xb[(size_t)t * F + c] : 0.f;
  }
  __syncthreads();

  // conv1 + relu on the tile's hidden frames t0-1 .. t0+kTile.
  {
    float4 acc[kHidPer];
#pragma unroll
    for (int i = 0; i < kHidPer; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    const int i0 = half * kHidPer;
    conv3_rows<kHidPer>(acc, sX, xs, i0, w1, F, D, col);
    const float4 bias = ldg4(b1 + col);
    float* hb = hid + (size_t)b * T * D;
#pragma unroll
    for (int i = 0; i < kHidPer; ++i) {
      const int j = i0 + i;
      const int t = t0 - 1 + j;
      // torch zero-pads the HIDDEN activation for conv2: rows outside
      // [0, T) are 0, not relu(b1).
      float4 hv = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t >= 0 && t < T) hv = bias_relu(acc[i], bias);
      *reinterpret_cast<float4*>(sH + j * D + col) = hv;
      if (j >= 1 && j <= kTile && t < T)
        *reinterpret_cast<float4*>(hb + (size_t)t * D + col) = hv;
    }
  }
  __syncthreads();

  // conv2 + relu on the tile's output frames t0 .. t0+kTile-1.
  {
    float4 acc[kOutPer];
#pragma unroll
    for (int i = 0; i < kOutPer; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    const int i0 = half * kOutPer;
    conv3_rows<kOutPer>(acc, sH, D, i0, w2, D, D, col);
    const float4 bias = ldg4(b2 + col);
    float* yb = y + (size_t)b * T * D;
#pragma unroll
    for (int i = 0; i < kOutPer; ++i) {
      const int t = t0 + i0 + i;
      if (t < T)
        *reinterpret_cast<float4*>(yb + (size_t)t * D + col) =
            bias_relu(acc[i], bias);
    }
  }
}

}  // namespace

extern "C" int avsep_audio_proj_fwd(const void* x, const void* w1,
                                    const void* b1, const void* w2,
                                    const void* b2, void* y, void* h,
                                    int B, int T, int F, int D, int device,
                                    void* stream) {
  if (D % 8 != 0 || D < 64 || D > 1024) return cudaErrorInvalidValue;
  const int xs = (F + 3) / 4 * 4;
  const size_t smem = sizeof(float) * ((size_t)kInRows * xs
                                       + (size_t)kHidRows * D);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(
      audio_proj_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + kTile - 1) / kTile, B);
  audio_proj_kernel<<<grid, D / 2, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<float*>(y),
      static_cast<float*>(h), T, F, D, xs);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* avsep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
