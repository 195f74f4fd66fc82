// Audio input projection forward, float32 on the tensor cores in 3xTF32,
// with a float32 or bfloat16 input and outputs, for Hopper (sm_90a).
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
// operations; with a bf16 x, y and h (float32 math and weights) the bytes
// drop to 4.5 us and the bound stays the products'.
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
// - bfloat16 (the Pallas kernel at a bf16 x, audio_proj.py:39-58, :87):
//   the math stays float32 (x cast up, float32 weights) and y and h are
//   stored in bf16.  x is staged as float32 (plain loads and a convert:
//   its 514-byte rows fit no 4-byte copy), and a bf16 value is exact in
//   TF32, so conv1's 3xTF32 product needs two products, x w_big +
//   x w_small.  conv2 reads the float32 h, as the Pallas kernel's does:
//   conv1 writes it to a float32 scratch beside the bf16 h, which is only
//   the backward's residual.
// - Bank conflicts.  Weight rows are 136 floats apart (8 mod 32): B loads
//   (k = t, n = g) hit bank 8t + g; staged input rows 20 apart: A loads hit
//   20g + t; 32 distinct banks a load.
#include <cuda_bf16.h>
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

// How conv_block stages its input rows.
enum Src { kF32Rows4, kF32Rows16, kBf16Rows };

// out[b, t0 + r, n0 + c] = relu(bias + sum_tap sum_ci src[b, t0 + r + tap
// - 1, ci] W[tap, ci, n0 + c]) for the block's BM frames and 128 channels;
// src (B, T, cin), zero outside [0, T): float32 rows 4-byte or 16-byte
// aligned, or bf16 rows.  The result goes to `out` (float32) where OUT_F32
// and to `outh` (bf16, rounded to nearest) where OUT_BF16.
template <int BM, Src SRC, bool OUT_F32, bool OUT_BF16>
__device__ __forceinline__ void conv_block(const void* __restrict__ src_,
                                           const float* __restrict__ W,
                                           const float* __restrict__ bias,
                                           float* __restrict__ out,
                                           __nv_bfloat16* __restrict__ outh,
                                           int T, int cin, int D) {
  constexpr int kMT = Tile<BM>::kMT;
  constexpr int kStage = Tile<BM>::kStage;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int t0 = blockIdx.x * BM, n0 = blockIdx.y * kBN, b = blockIdx.z;
  const float* src = static_cast<const float*>(src_);
  const float* sb = src + (size_t)b * T * cin;
  const __nv_bfloat16* sbh =
      static_cast<const __nv_bfloat16*>(src_) + (size_t)b * T * cin;
  const int kc = (cin + 7) / 8 * 8;  // K a tap, padded to a multiple of 8
  const int nk = (kc + kBK - 1) / kBK;

  auto load = [&](int j) {
    float* sa = smem + (j % kStages) * kStage;
    float* sw = sa + Tile<BM>::kA;
    const int c0 = j * kBK;
    // Input frames t0 - 1 .. t0 + BM, channels c0 .. c0 + 15.
    if (SRC == kBf16Rows) {
      // Plain loads, converted to float32 as they are staged.
      for (int i = tid; i < (BM + 2) * kBK; i += kThreads) {
        const int r = i / kBK, c = i % kBK;
        const int tt = t0 - 1 + r;
        const bool ok = tt >= 0 && tt < T && c0 + c < cin;
        sa[r * kAS + c] =
            ok ? __bfloat162float(sbh[(size_t)tt * cin + c0 + c]) : 0.f;
      }
    } else if (SRC == kF32Rows16) {
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
          for (int mt = 0; mt < kMT; ++mt) {
            const float* ap =
                sa + (wm * (BM / 2) + mt * 16 + tap) * kAS + kk * 8;
            if (SRC == kBf16Rows) {
              // A bf16 value is its own TF32 big part; no small part.
              ab[mt][0] = __float_as_uint(ap[g * kAS + t]);
              ab[mt][1] = __float_as_uint(ap[(g + 8) * kAS + t]);
              ab[mt][2] = __float_as_uint(ap[g * kAS + t + 4]);
              ab[mt][3] = __float_as_uint(ap[(g + 8) * kAS + t + 4]);
            } else {
              load_a_frag(ap, kAS, g, t, ab[mt], as[mt]);
            }
          }
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            const float* bp =
                sw + (tap * kBK + kk * 8 + t) * kBS + wn * 32 + n * 8 + g;
            unsigned bb[2], bs[2];
            split(bp[0], bb[0], bs[0]);
            split(bp[4 * kBS], bb[1], bs[1]);
#pragma unroll
            for (int mt = 0; mt < kMT; ++mt) {
              if (SRC == kBf16Rows) {
                mma_tf32(acc[mt][n], ab[mt], bs);
                mma_tf32(acc[mt][n], ab[mt], bb);
              } else {
                mma_3xtf32(acc[mt][n], ab[mt], as[mt], bb, bs);
              }
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  float* ob = out + (size_t)b * T * D;
  __nv_bfloat16* obh = outh + (size_t)b * T * D;
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
        if (tt >= T) continue;
        const float v0 = relu(acc[mt][n][2 * hf] + c0);
        const float v1 = relu(acc[mt][n][2 * hf + 1] + c1);
        if (OUT_F32)
          *reinterpret_cast<float2*>(ob + (size_t)tt * D + col) =
              make_float2(v0, v1);
        if (OUT_BF16)
          *reinterpret_cast<__nv_bfloat162*>(obh + (size_t)tt * D + col) =
              __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// h = relu(conv3(x, W1) + b1).  BF16: x is bf16, h goes to the float32
// scratch h32 (conv2's input) and to the bf16 h; else x rows of F floats,
// 4-byte aligned, and h (float32) is conv2's input itself.
template <int BM, bool BF16>
__global__ void __launch_bounds__(kThreads, 2)
audio_proj_conv1_kernel(const void* __restrict__ x,
                        const float* __restrict__ w1,
                        const float* __restrict__ b1,
                        float* __restrict__ h32,
                        __nv_bfloat16* __restrict__ hb, int T, int F,
                        int D) {
  conv_block<BM, BF16 ? kBf16Rows : kF32Rows4, true, BF16>(x, w1, b1, h32,
                                                           hb, T, F, D);
}

// y = relu(conv3(h, W2) + b2): h rows of D floats, 16-byte aligned; y in
// float32 or (BF16) bf16.
template <int BM, bool BF16>
__global__ void __launch_bounds__(kThreads, 2)
audio_proj_conv2_kernel(const float* __restrict__ h,
                        const float* __restrict__ w2,
                        const float* __restrict__ b2, float* __restrict__ y,
                        __nv_bfloat16* __restrict__ yb, int T, int D) {
  conv_block<BM, kF32Rows16, !BF16, BF16>(h, w2, b2, y, yb, T, D, D);
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int BM, bool BF16>
cudaError_t launch(const void* x, const float* w1, const float* b1,
                   const float* w2, const float* b2, void* y, void* h,
                   float* h32, int B, int T, int F, int D, cudaStream_t s) {
  constexpr size_t kBytes = Tile<BM>::kBytes;
  cudaError_t err = prepare(audio_proj_conv1_kernel<BM, BF16>, kBytes);
  if (err != cudaSuccess) return err;
  err = prepare(audio_proj_conv2_kernel<BM, BF16>, kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + BM - 1) / BM, (D + kBN - 1) / kBN, B);
  // At float32, h is conv2's float32 input; at bf16, h32 is.
  float* hf = BF16 ? h32 : static_cast<float*>(h);
  auto* hb = static_cast<__nv_bfloat16*>(h);
  audio_proj_conv1_kernel<BM, BF16><<<grid, kThreads, kBytes, s>>>(
      x, w1, b1, hf, hb, T, F, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  audio_proj_conv2_kernel<BM, BF16><<<grid, kThreads, kBytes, s>>>(
      hf, w2, b2, static_cast<float*>(y), static_cast<__nv_bfloat16*>(y), T,
      D);
  return cudaGetLastError();
}

template <bool BF16>
cudaError_t dispatch(const void* x, const float* w1, const float* b1,
                     const float* w2, const float* b2, void* y, void* h,
                     float* h32, int B, int T, int F, int D, int rows,
                     cudaStream_t s) {
  switch (rows) {
    case 128:
      return launch<128, BF16>(x, w1, b1, w2, b2, y, h, h32, B, T, F, D, s);
    case 64:
      return launch<64, BF16>(x, w1, b1, w2, b2, y, h, h32, B, T, F, D, s);
    case 32:
      return launch<32, BF16>(x, w1, b1, w2, b2, y, h, h32, B, T, F, D, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// rows: the frames a block computes, 128, 64 or 32 (`gemm_rows` in
// ops/kernels/__init__.py).  dtype 0: x, y and h float32 (h32 unused);
// dtype 1: x, y and h bf16, h32 a float32 (B, T, D) scratch.
extern "C" int avsep_audio_proj_fwd(const void* x, const void* w1,
                                    const void* b1, const void* w2,
                                    const void* b2, void* y, void* h,
                                    void* h32, int B, int T, int F, int D,
                                    int rows, int dtype, int device,
                                    void* stream) {
  // Any width from 64 up, in steps of 8 (the wrapper pads others): the
  // grid tiles the channels, and the k loop runs over any count.
  if (D % 8 != 0 || D < 64) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* w1f = static_cast<const float*>(w1);
  const auto* b1f = static_cast<const float*>(b1);
  const auto* w2f = static_cast<const float*>(w2);
  const auto* b2f = static_cast<const float*>(b2);
  auto* scratch = static_cast<float*>(h32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = dispatch<false>(x, w1f, b1f, w2f, b2f, y, h, scratch, B, T, F, D,
                          rows, s);
  else if (dtype == 1 && h32 != nullptr)
    err = dispatch<true>(x, w1f, b1f, w2f, b2f, y, h, scratch, B, T, F, D,
                         rows, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* avsep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
