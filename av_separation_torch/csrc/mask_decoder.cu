// Fused separation mask decoder forward, float32, for Hopper (sm_90a).
//
// Replaces: av_separation_tpu/ops/pallas/decoder.py `_decoder_kernel`
// (called from `_decoder_pallas_fwd`).  Computes
//     a      = gelu(x @ W1 + b1)            exact erf GELU (CUDA erff)
//     masks  = sigmoid(a @ W2 + b2)         columns o = s * F + f
//     sep    = masks * mixed
// and writes masks and sep directly in the reference layout (B, S, F, T).
// x is (B, T, d), W1 (d, 2d), W2 (2d, S*F), mixed (B, F, T).  The Pallas
// kernel carried an Abramowitz-Stegun erf (decoder.py:35-48, error up to
// 1.5e-7) because Mosaic has no erf; this one uses erff.  The TPU's
// 128-column padding per speaker (decoder.py:117-125) is not needed.
//
// Bound on the H100 at the scaled serving shape (B=8, T=501, d=512, S=2,
// F=257): 2*B*T*(d*2d + 2d*S*F) = 8.5 GFLOP against 33 MB (x, W1, W2,
// mixed, masks, sep), so at 67 TFLOP/s float32 and 3.35 TB/s it is bound
// by operations: 126 us vs 10 us.
//
// Design: a block owns 16 frames of one utterance.  Their GELU activation
// (16 x 2d) stays in shared memory, so neither it nor the pre-sigmoid
// logits touch device memory.  Weights stream from L2 as coalesced rows.
// The (.., F, T) store is transposed: each chunk of mask columns is staged
// in shared memory as (column, frame) and written with consecutive threads
// along T, so a warp writes runs of 16 consecutive frames instead of one
// float per column row.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 16;          // frames per block
constexpr int kStageS = kTile + 1;  // staged column stride (bank spread)

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

// blockDim.x = d / 2.  Shared memory: a union region (x tile, later the
// staged masks) followed by the activation tile a (kTile, 2d).
__global__ void __launch_bounds__(512)
mask_decoder_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                    const float* __restrict__ b1, const float* __restrict__ w2,
                    const float* __restrict__ b2,
                    const float* __restrict__ mixed,
                    float* __restrict__ masks, float* __restrict__ sep,
                    int T, int d, int F, int SF, int union_floats) {
  extern __shared__ float4 smem4[];
  float* sX = reinterpret_cast<float*>(smem4);  // (kTile, d)
  float* sStage = sX;                           // (2 * blockDim, kStageS)
  float* sA = sX + union_floats;                // (kTile, 2d)

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kTile;
  const int d2 = 2 * d;

  const float* xb = x + (size_t)b * T * d;
  for (int i = tid; i < kTile * (d / 4); i += nt) {
    const int r = i / (d / 4), c = (i % (d / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t0 + r < T) v = ldg4(xb + (size_t)(t0 + r) * d + c);
    *reinterpret_cast<float4*>(sX + r * d + c) = v;
  }
  __syncthreads();

  // a = gelu(x @ W1 + b1); thread owns hidden columns [4 tid, 4 tid + 4).
  {
    const int col = tid * 4;
    float4 acc[kTile];
#pragma unroll
    for (int r = 0; r < kTile; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 1
    for (int k = 0; k < d; k += 4) {
      float4 w[4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) w[kk] = ldg4(w1 + (size_t)(k + kk) * d2 + col);
#pragma unroll
      for (int r = 0; r < kTile; ++r) {
        const float4 xv = ld4(sX + r * d + k);
        const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          acc[r].x = fmaf(xs[kk], w[kk].x, acc[r].x);
          acc[r].y = fmaf(xs[kk], w[kk].y, acc[r].y);
          acc[r].z = fmaf(xs[kk], w[kk].z, acc[r].z);
          acc[r].w = fmaf(xs[kk], w[kk].w, acc[r].w);
        }
      }
    }
    const float4 bias = ldg4(b1 + col);
#pragma unroll
    for (int r = 0; r < kTile; ++r) {
      *reinterpret_cast<float4*>(sA + r * d2 + col) = make_float4(
          gelu(acc[r].x + bias.x), gelu(acc[r].y + bias.y),
          gelu(acc[r].z + bias.z), gelu(acc[r].w + bias.w));
    }
  }
  __syncthreads();  // a is complete; the x tile is dead from here on

  // masks = sigmoid(a @ W2 + b2) in chunks of 2 * blockDim columns; thread
  // owns columns c0 + tid and c0 + nt + tid.
  const int chunk = 2 * nt;
  float* mb = masks + (size_t)b * SF * T;
  float* sb = sep + (size_t)b * SF * T;
  const float* mixb = mixed + (size_t)b * F * T;
  for (int c0 = 0; c0 < SF; c0 += chunk) {
    const int oa = c0 + tid;
    const int ob = c0 + nt + tid;
    const bool va = oa < SF;
    const bool vb = ob < SF;
    // A warp whose columns all lie past SF skips the product.
    if (c0 + (tid & ~31) < SF) {
      float acc_a[kTile], acc_b[kTile];
#pragma unroll
      for (int r = 0; r < kTile; ++r) acc_a[r] = acc_b[r] = 0.f;
#pragma unroll 1
      for (int k = 0; k < d2; k += 4) {
        float wa[4], wb[4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float* row = w2 + (size_t)(k + kk) * SF;
          wa[kk] = va ? __ldg(row + oa) : 0.f;
          wb[kk] = vb ? __ldg(row + ob) : 0.f;
        }
#pragma unroll
        for (int r = 0; r < kTile; ++r) {
          const float4 av = ld4(sA + r * d2 + k);
          const float as[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            acc_a[r] = fmaf(as[kk], wa[kk], acc_a[r]);
            acc_b[r] = fmaf(as[kk], wb[kk], acc_b[r]);
          }
        }
      }
      const float bias_a = va ? __ldg(b2 + oa) : 0.f;
      const float bias_b = vb ? __ldg(b2 + ob) : 0.f;
#pragma unroll
      for (int r = 0; r < kTile; ++r) {
        sStage[tid * kStageS + r] = 1.f / (1.f + expf(-(acc_a[r] + bias_a)));
        sStage[(nt + tid) * kStageS + r] =
            1.f / (1.f + expf(-(acc_b[r] + bias_b)));
      }
    }
    __syncthreads();
    // Transposed store: consecutive threads walk T within a column.
    const int width = min(chunk, SF - c0);
    for (int i = tid; i < width * kTile; i += nt) {
      const int r = i % kTile;
      const int oc = i / kTile;
      const int t = t0 + r;
      if (t >= T) continue;
      const int o = c0 + oc;
      const float m = sStage[oc * kStageS + r];
      const size_t idx = (size_t)o * T + t;
      mb[idx] = m;
      sb[idx] = m * __ldg(mixb + (size_t)(o % F) * T + t);
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int avsep_mask_decoder_fwd(const void* x, const void* w1,
                                      const void* b1, const void* w2,
                                      const void* b2, const void* mixed,
                                      void* masks, void* sep, int B, int T,
                                      int d, int S, int F, int device,
                                      void* stream) {
  if (d % 8 != 0 || d < 64 || d > 1024) return cudaErrorInvalidValue;
  const int nt = d / 2;
  const int SF = S * F;
  const int x_floats = kTile * d;
  const int stage_floats = 2 * nt * kStageS;
  const int union_floats = x_floats > stage_floats ? x_floats : stage_floats;
  const size_t smem =
      sizeof(float) * ((size_t)union_floats + (size_t)kTile * 2 * d);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(
      mask_decoder_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + kTile - 1) / kTile, B);
  mask_decoder_kernel<<<grid, nt, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(mixed),
      static_cast<float*>(masks), static_cast<float*>(sep), T, d, F, SF,
      union_floats);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* avsep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
