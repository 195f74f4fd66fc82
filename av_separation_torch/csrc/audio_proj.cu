// Audio input projection forward, float32 on the tensor cores in 3xTF32,
// for Hopper (sm_90a).
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
// 2*B*T*3*(F + D)*D = 9.5 GFLOP against 25 MB (x, W1, W2, y, h).  Float32
// products at float32 accuracy run on the tensor cores in 3xTF32 at
// 495/3 = 165 TFLOP/s: 57 us, against 7.5 us of bytes, so bound by
// operations.
//
// Design: one launch a conv, each an implicit GEMM.
// - Why two launches.  A fused kernel (the TPU kernel's shape: the hidden
//   tile with its halo kept in shared memory between the convs, one block
//   an SM) was built and measured first, on an H100 at 700 W: 0.35 ms at
//   the scaled shape against cuDNN's 0.37, and 2-3x cuDNN at three_speaker
//   and multihost.  The hidden tile takes the shared memory that a larger
//   output-channel tile needs.  h is an output the backward reads anyway,
//   so conv2 reads it back (8 MB at the scaled shape, from L2) at no extra
//   write; its zero padding outside [0, T) is conv2's zero-filled copies.
// - Implicit GEMM: M frames, K = 3 taps x C_in, N = D, as mma.sync.m16n8k8
//   TF32 products in 3xTF32 (`split`, `mma_3xtf32` in mma_3xtf32.cuh), as
//   the flash kernels.  The taps are row offsets into the staged input
//   rows (A row r, tap k reads staged row r + k): no im2col copy.
// - Tiles.  A block computes BM frames of one utterance x 128 channels
//   (BM = 128, or 64 or 32 where that fills the card better) with 8 warps of
//   (BM / 2) x 32.  Input channels go 16 at a time through a 3-stage ring
//   of cp.async copies: BM + 2 input rows (zero outside [0, T)) and the 3
//   taps' 16 weight rows (W[tap][c] is D contiguous floats: a k-major
//   tile), one barrier a stage.  110 KB of shared memory: two blocks an SM.
// - Ragged edges.  F = 257 is padded to a multiple of 8 (264) with zeros, in
//   the staged x and the W1 rows (src-size 0); x rows are 1,028 bytes, only
//   4-byte aligned, so conv1 stages x with 4-byte copies and conv2 stages h
//   with 16-byte ones.
// - Stores.  y and h go from the C fragments straight to device memory:
//   each quarter-warp writes 32 contiguous bytes of a row, whole sectors.
// - Bank conflicts.  Weight rows are 136 floats apart (8 mod 32): B loads
//   (k = t, n = g) hit bank 8t + g; staged input rows 20 apart: A loads hit
//   20g + t; 32 distinct banks a load.
#include <cuda_runtime.h>

#include "mma_3xtf32.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps: 2 over frames, 4 over channels
constexpr int kBN = 128;       // output channels a block
constexpr int kBK = 16;        // input channels a ring stage
constexpr int kAS = kBK + 4;   // staged input row stride (floats)
constexpr int kBS = kBN + 8;   // weight row stride (floats)
constexpr int kStages = 3;

template <int BM>
struct Tile {
  static constexpr int kMT = BM / 32;  // m16 tiles a warp
  static constexpr int kA = (BM + 2) * kAS;
  static constexpr int kStage = kA + 3 * kBK * kBS;  // input rows, W rows
  static constexpr size_t kBytes = sizeof(float) * kStages * kStage;
};

__device__ __forceinline__ float relu(float v) { return fmaxf(v, 0.f); }

// out[b, t0 + r, n0 + c] = relu(bias + sum_tap sum_ci src[b, t0 + r + tap
// - 1, ci] W[tap, ci, n0 + c]) for the block's BM frames and 128 channels;
// src (B, T, cin), zero outside [0, T).  VEC: src rows are 16-byte aligned.
template <int BM, bool VEC>
__device__ __forceinline__ void conv_block(const float* __restrict__ src,
                                           const float* __restrict__ W,
                                           const float* __restrict__ bias,
                                           float* __restrict__ out, int T,
                                           int cin, int D) {
  constexpr int kMT = Tile<BM>::kMT;
  constexpr int kStage = Tile<BM>::kStage;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int t0 = blockIdx.x * BM, n0 = blockIdx.y * kBN, b = blockIdx.z;
  const float* sb = src + (size_t)b * T * cin;
  const int kc = (cin + 7) / 8 * 8;  // K a tap, padded to a multiple of 8
  const int nk = (kc + kBK - 1) / kBK;

  auto load = [&](int j) {
    float* sa = smem + (j % kStages) * kStage;
    float* sw = sa + Tile<BM>::kA;
    const int c0 = j * kBK;
    // Input frames t0 - 1 .. t0 + BM, channels c0 .. c0 + 15.
    if (VEC) {
      for (int i = tid; i < (BM + 2) * (kBK / 4); i += kThreads) {
        const int r = i / (kBK / 4), c = (i % (kBK / 4)) * 4;
        const int tt = t0 - 1 + r;
        const bool ok = tt >= 0 && tt < T && c0 + c < cin;
        cp_async16(sa + r * kAS + c,
                   ok ? sb + (size_t)tt * cin + c0 + c : src, ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < (BM + 2) * kBK; i += kThreads) {
        const int r = i / kBK, c = i % kBK;
        const int tt = t0 - 1 + r;
        const bool ok = tt >= 0 && tt < T && c0 + c < cin;
        cp_async4(sa + r * kAS + c, ok ? sb + (size_t)tt * cin + c0 + c : src,
                  ok ? 4 : 0);
      }
    }
    // W rows (tap, c0 .. c0 + 15), channels n0 .. n0 + 127.
#pragma unroll
    for (int i = tid; i < 3 * kBK * (kBN / 4); i += kThreads) {
      const int r = i / (kBN / 4), c = (i % (kBN / 4)) * 4;
      const int tap = r / kBK, ci = c0 + r % kBK;
      const bool ok = ci < cin && n0 + c < D;
      cp_async16(sw + r * kBS + c,
                 ok ? W + ((size_t)tap * cin + ci) * D + n0 + c : W,
                 ok ? 16 : 0);
    }
  };

  float acc[kMT][4][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;

  const bool active = t0 + wm * (BM / 2) < T && n0 + wn * 32 < D;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
  for (int j = 0; j < nk; ++j) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage j landed; the slot of stage j - 1 is free
    if (j + kStages - 1 < nk) load(j + kStages - 1);
    cp_async_commit();
    const float* sa = smem + (j % kStages) * kStage;
    const float* sw = sa + Tile<BM>::kA;
    const int c0 = j * kBK;
    if (active) {
      // One tap at a time at BM 128 (unrolled, conv2 spilled there).
#pragma unroll(BM == 128 ? 1 : 3)
      for (int tap = 0; tap < 3; ++tap) {
#pragma unroll
        for (int kk = 0; kk < kBK / 8; ++kk) {
          if (c0 + kk * 8 >= kc) break;
          unsigned ab[kMT][4], as[kMT][4];
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt)
            load_a_frag(sa + (wm * (BM / 2) + mt * 16 + tap) * kAS + kk * 8,
                        kAS, g, t, ab[mt], as[mt]);
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            const float* bp =
                sw + (tap * kBK + kk * 8 + t) * kBS + wn * 32 + n * 8 + g;
            unsigned bb[2], bs[2];
            split(bp[0], bb[0], bs[0]);
            split(bp[4 * kBS], bb[1], bs[1]);
#pragma unroll
            for (int mt = 0; mt < kMT; ++mt)
              mma_3xtf32(acc[mt][n], ab[mt], as[mt], bb, bs);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  float* ob = out + (size_t)b * T * D;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const int col = n0 + wn * 32 + n * 8 + 2 * t;
    if (col >= D) continue;  // D is a multiple of 8: col + 1 < D too
    const float c0 = bias[col], c1 = bias[col + 1];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int tt = t0 + wm * (BM / 2) + mt * 16 + g + 8 * hf;
        if (tt < T)
          *reinterpret_cast<float2*>(ob + (size_t)tt * D + col) =
              make_float2(relu(acc[mt][n][2 * hf] + c0),
                          relu(acc[mt][n][2 * hf + 1] + c1));
      }
    }
  }
}

// h = relu(conv3(x, W1) + b1): x rows of F floats, 4-byte aligned.
template <int BM>
__global__ void __launch_bounds__(kThreads, 2)
audio_proj_conv1_kernel(const float* __restrict__ x,
                        const float* __restrict__ w1,
                        const float* __restrict__ b1, float* __restrict__ h,
                        int T, int F, int D) {
  conv_block<BM, false>(x, w1, b1, h, T, F, D);
}

// y = relu(conv3(h, W2) + b2): h rows of D floats, 16-byte aligned.
template <int BM>
__global__ void __launch_bounds__(kThreads, 2)
audio_proj_conv2_kernel(const float* __restrict__ h,
                        const float* __restrict__ w2,
                        const float* __restrict__ b2, float* __restrict__ y,
                        int T, int D) {
  conv_block<BM, true>(h, w2, b2, y, T, D, D);
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int BM>
cudaError_t launch(const float* x, const float* w1, const float* b1,
                   const float* w2, const float* b2, float* y, float* h,
                   int B, int T, int F, int D, cudaStream_t s) {
  constexpr size_t kBytes = Tile<BM>::kBytes;
  cudaError_t err = prepare(audio_proj_conv1_kernel<BM>, kBytes);
  if (err != cudaSuccess) return err;
  err = prepare(audio_proj_conv2_kernel<BM>, kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + BM - 1) / BM, (D + kBN - 1) / kBN, B);
  audio_proj_conv1_kernel<BM><<<grid, kThreads, kBytes, s>>>(x, w1, b1, h, T,
                                                             F, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  audio_proj_conv2_kernel<BM><<<grid, kThreads, kBytes, s>>>(h, w2, b2, y, T,
                                                             D);
  return cudaGetLastError();
}

}  // namespace

// rows: the frames a block computes, 128, 64 or 32 (`gemm_rows` in
// ops/kernels/__init__.py).
extern "C" int avsep_audio_proj_fwd(const void* x, const void* w1,
                                    const void* b1, const void* w2,
                                    const void* b2, void* y, void* h,
                                    int B, int T, int F, int D, int rows,
                                    int device, void* stream) {
  // Any width from 64 up, in steps of 8 (the wrapper pads others): the
  // grid tiles the channels, and the k loop runs over any count.
  if (D % 8 != 0 || D < 64) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* xf = static_cast<const float*>(x);
  const auto* w1f = static_cast<const float*>(w1);
  const auto* b1f = static_cast<const float*>(b1);
  const auto* w2f = static_cast<const float*>(w2);
  const auto* b2f = static_cast<const float*>(b2);
  auto* yo = static_cast<float*>(y);
  auto* ho = static_cast<float*>(h);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == 128)
    err = launch<128>(xf, w1f, b1f, w2f, b2f, yo, ho, B, T, F, D, s);
  else if (rows == 64)
    err = launch<64>(xf, w1f, b1f, w2f, b2f, yo, ho, B, T, F, D, s);
  else if (rows == 32)
    err = launch<32>(xf, w1f, b1f, w2f, b2f, yo, ho, B, T, F, D, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* avsep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
