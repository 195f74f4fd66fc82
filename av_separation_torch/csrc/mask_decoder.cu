// Separation mask decoder forward, float32 on the tensor cores in 3xTF32,
// for Hopper (sm_90a).
//
// Replaces: av_separation_tpu/ops/pallas/decoder.py `_decoder_kernel`
// (called from `_decoder_pallas_fwd`).  Computes
//     a      = gelu(x W1^T + b1)            exact erf GELU (CUDA erff)
//     masks  = sigmoid(a W2^T + b2)         columns o = s * F + f
//     sep    = masks * mixed
// and writes masks and sep directly in the reference layout (B, S, F, T).
// x is (B, T, d), mixed (B, F, T); W1 (2d, d) and W2 (S*F, 2d) are the torch
// Linear weights as they are, (out, in), so the model copies no weight per
// forward.  The Pallas kernel carried an Abramowitz-Stegun erf
// (decoder.py:35-48) because Mosaic has no erf; this one uses erff.  The
// TPU's 128-column padding per speaker (decoder.py:117-125) is not needed.
//
// Bound on the H100 at the scaled serving shape (B=8, T=501, d=512, S=2,
// F=257): 2*B*T*(d*2d + 2d*S*F) = 8.5 GFLOP against 33 MB (x, W1, W2,
// mixed, masks, sep).  Float32 products at float32 accuracy run on the
// tensor cores in 3xTF32 at 495/3 = 165 TFLOP/s: 51 us, against 10 us of
// bytes, so bound by operations.
//
// Design: two launches of one tiled GEMM.
// - Why two.  A fused kernel (the TPU kernel's shape: the GELU tile of 32
//   frames kept in shared memory between the GEMMs, one block an SM) was
//   built and measured first, on an H100 at 700 W: 0.27 ms at the scaled
//   shape against cuBLAS's 0.26, and 5x cuBLAS at three_speaker's 504
//   rows, where it fills 16 SMs.  The GELU tile takes the shared memory
//   that a larger output tile needs.  Here the hidden activation goes to a
//   scratch buffer (16 MB at the scaled shape, within the 50 MB L2) and each
//   GEMM tiles (rows x columns) over the whole card.
// - Products.  mma.sync.m16n8k8 TF32 in 3xTF32 (`split`, `mma_3xtf32` in
//   mma_3xtf32.cuh), as the flash kernels; 1xTF32 would not hold the masks'
//   1e-5.  The (out, in) weight rows are k-contiguous: they are the "col"
//   B operand of mma row.col as they lie.
// - Tiles.  A block computes BM x 128 outputs (BM = 128, or 64 or 32 where
//   that fills the card better) with 8 warps of (BM / 2) x 32; k goes in tiles
//   of 32 through a 3-stage ring of cp.async 16-byte copies of the A rows
//   and the weight rows, one barrier a tile, so two copies run under the
//   products.  110 KB of shared memory: two blocks an SM.
// - Ragged edges.  Rows past M, weight rows past the output count (S*F =
//   514, 771, 1028 are not multiples of 8) are zero-filled by the copies
//   (src-size 0); k-steps past d or 2d (multiples of 8) are skipped; a warp
//   with no valid row or column skips the products.
// - Epilogues.  The first adds b1 and applies GELU and stores the hidden
//   rows (each quarter-warp 32 contiguous bytes).  The second adds b2,
//   applies the sigmoid and stages the tile in the idle ring as (column,
//   row), so the (.., F, T) store of masks and sep and the read of `mixed`
//   run along T: 128-byte runs a warp.
// - Bank conflicts.  Ring rows are 36 floats apart: the A loads and the B
//   loads hit bank 4g + t, 32 distinct banks a load.
#include <cuda_runtime.h>
#include <math.h>

#include "mma_3xtf32.cuh"
#include "device_guard.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps: 2 over rows, 4 over columns
constexpr int kBN = 128;       // output columns a block
constexpr int kBK = 32;        // k a ring stage
constexpr int kS = kBK + 4;    // ring row stride (floats)
constexpr int kStages = 3;

template <int BM>
struct Tile {
  static constexpr int kMT = BM / 32;  // m16 tiles a warp
  static constexpr int kStage = (BM + kBN) * kS;  // A rows, then W rows
  static constexpr size_t kBytes = sizeof(float) * kStages * kStage;
};

__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

__device__ __forceinline__ float sigmoid(float v) {
  return 1.f / (1.f + expf(-v));
}

// acc = A[m0 + warp rows, 0:K] W[n0 + warp columns, 0:K]^T for A (M, K)
// and W (N, K) row-major.  Ends with every copy landed and a barrier, so
// the ring is free.
template <int BM>
__device__ __forceinline__ void gemm_tile(float (&acc)[BM / 32][4][4],
                                          const float* __restrict__ A,
                                          const float* __restrict__ W, int M,
                                          int N, int K, int m0, int n0,
                                          float* smem) {
  constexpr int kMT = Tile<BM>::kMT;
  constexpr int kStage = Tile<BM>::kStage;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;

  const int nk = (K + kBK - 1) / kBK;
  auto load = [&](int j) {
    float* st = smem + (j % kStages) * kStage;
    const int k0 = j * kBK;
#pragma unroll
    for (int i = tid; i < (BM + kBN) * (kBK / 4); i += kThreads) {
      const int r = i / (kBK / 4), c = (i % (kBK / 4)) * 4;
      const bool is_a = r < BM;
      const int row = is_a ? m0 + r : n0 + r - BM;
      const float* base = is_a ? A : W;
      const bool ok = row < (is_a ? M : N) && k0 + c < K;
      cp_async16(st + r * kS + c, ok ? base + (size_t)row * K + k0 + c : base,
                 ok ? 16 : 0);
    }
  };

  const bool active = m0 + wm * (BM / 2) < M && n0 + wn * 32 < N;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
  for (int j = 0; j < nk; ++j) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile j landed; the slot of tile j - 1 is free
    if (j + kStages - 1 < nk) load(j + kStages - 1);
    cp_async_commit();
    const float* sa = smem + (j % kStages) * kStage;
    const float* sb = sa + BM * kS;
    const int k0 = j * kBK;
    if (active) {
#pragma unroll
      for (int kk = 0; kk < kBK / 8; ++kk) {
        if (k0 + kk * 8 >= K) break;
        unsigned ab[kMT][4], as[kMT][4];
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
          load_a_frag(sa + (wm * (BM / 2) + mt * 16) * kS + kk * 8, kS, g, t,
                      ab[mt], as[mt]);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const float* br = sb + (wn * 32 + n * 8 + g) * kS + kk * 8 + t;
          unsigned bb[2], bs[2];
          split(br[0], bb[0], bs[0]);
          split(br[4], bb[1], bs[1]);
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt)
            mma_3xtf32(acc[mt][n], ab[mt], as[mt], bb, bs);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// hidden (M, 2d) = gelu(x W1^T + b1), M = B * T.
template <int BM>
__global__ void __launch_bounds__(kThreads, 2)
mask_decoder_hidden_kernel(const float* __restrict__ x,
                           const float* __restrict__ w1,
                           const float* __restrict__ b1,
                           float* __restrict__ hidden, int M, int d) {
  constexpr int kMT = Tile<BM>::kMT;
  extern __shared__ float4 smem4[];
  const int N = 2 * d;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * kBN;
  float acc[kMT][4][4];
  gemm_tile<BM>(acc, x, w1, M, N, d, m0, n0, reinterpret_cast<float*>(smem4));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const int col = n0 + wn * 32 + n * 8 + 2 * t;
    if (col >= N) continue;  // N is a multiple of 16: col + 1 < N too
    const float c0 = b1[col], c1 = b1[col + 1];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = m0 + wm * (BM / 2) + mt * 16 + g + 8 * hf;
        if (row < M)
          *reinterpret_cast<float2*>(hidden + (size_t)row * N + col) =
              make_float2(gelu(acc[mt][n][2 * hf] + c0),
                          gelu(acc[mt][n][2 * hf + 1] + c1));
      }
    }
  }
}

// masks = sigmoid(hidden W2^T + b2), sep = masks * mixed, in (B, S*F, T).
template <int BM>
__global__ void __launch_bounds__(kThreads, 2)
mask_decoder_mask_kernel(const float* __restrict__ hidden,
                         const float* __restrict__ w2,
                         const float* __restrict__ b2,
                         const float* __restrict__ mixed,
                         float* __restrict__ masks, float* __restrict__ sep,
                         int T, int M, int d, int F, int SF) {
  constexpr int kMT = Tile<BM>::kMT;
  constexpr int kSS = BM + 1;  // staged column stride
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * kBN;
  float acc[kMT][4][4];
  gemm_tile<BM>(acc, hidden, w2, M, SF, 2 * d, m0, n0, smem);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int cl = wn * 32 + n * 8 + 2 * t + e;
      if (n0 + cl >= SF) continue;
      const float bias = b2[n0 + cl];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const int rl = wm * (BM / 2) + mt * 16 + g;
        smem[cl * kSS + rl] = sigmoid(acc[mt][n][e] + bias);
        smem[cl * kSS + rl + 8] = sigmoid(acc[mt][n][2 + e] + bias);
      }
    }
  }
  __syncthreads();
  // Consecutive threads walk the rows (frames) of one column.
  const int width = min(kBN, SF - n0);
  for (int i = tid; i < width * BM; i += kThreads) {
    const int rl = i % BM, cl = i / BM;
    const int m = m0 + rl;
    if (m >= M) continue;
    const int b = m / T, tt = m - b * T;
    const int o = n0 + cl;
    const float v = smem[cl * kSS + rl];
    const size_t idx = ((size_t)b * SF + o) * T + tt;
    masks[idx] = v;
    sep[idx] = v * mixed[((size_t)b * F + o % F) * T + tt];
  }
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int BM>
cudaError_t launch_hidden(const float* x, const float* w1, const float* b1,
                          float* hidden, int M, int d, cudaStream_t s) {
  cudaError_t err = prepare(mask_decoder_hidden_kernel<BM>, Tile<BM>::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + BM - 1) / BM, (2 * d + kBN - 1) / kBN);
  mask_decoder_hidden_kernel<BM><<<grid, kThreads, Tile<BM>::kBytes, s>>>(
      x, w1, b1, hidden, M, d);
  return cudaGetLastError();
}

template <int BM>
cudaError_t launch_mask(const float* hidden, const float* w2, const float* b2,
                        const float* mixed, float* masks, float* sep, int T,
                        int M, int d, int F, int SF, cudaStream_t s) {
  cudaError_t err = prepare(mask_decoder_mask_kernel<BM>, Tile<BM>::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + BM - 1) / BM, (SF + kBN - 1) / kBN);
  mask_decoder_mask_kernel<BM><<<grid, kThreads, Tile<BM>::kBytes, s>>>(
      hidden, w2, b2, mixed, masks, sep, T, M, d, F, SF);
  return cudaGetLastError();
}

}  // namespace

// hidden: scratch of B * T * 2d floats.  rows1, rows2: the block rows of
// the two launches, 128, 64 or 32 (`gemm_rows` in ops/kernels/__init__.py).
extern "C" int avsep_mask_decoder_fwd(const void* x, const void* w1,
                                      const void* b1, const void* w2,
                                      const void* b2, const void* mixed,
                                      void* hidden, void* masks, void* sep,
                                      int B, int T, int d, int S, int F,
                                      int rows1, int rows2, int device,
                                      void* stream) {
  // Any width from 64 up, in steps of 8 (the wrapper pads others): the
  // grid tiles the channels, and the k loop runs over any count.
  if (d % 8 != 0 || d < 64) return cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * T;
  const auto* xf = static_cast<const float*>(x);
  const auto* w1f = static_cast<const float*>(w1);
  const auto* b1f = static_cast<const float*>(b1);
  auto* hf = static_cast<float*>(hidden);
  if (rows1 == 128)
    err = launch_hidden<128>(xf, w1f, b1f, hf, M, d, s);
  else if (rows1 == 64)
    err = launch_hidden<64>(xf, w1f, b1f, hf, M, d, s);
  else if (rows1 == 32)
    err = launch_hidden<32>(xf, w1f, b1f, hf, M, d, s);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* w2f = static_cast<const float*>(w2);
  const auto* b2f = static_cast<const float*>(b2);
  const auto* mf = static_cast<const float*>(mixed);
  auto* mo = static_cast<float*>(masks);
  auto* so = static_cast<float*>(sep);
  if (rows2 == 128)
    err = launch_mask<128>(hf, w2f, b2f, mf, mo, so, T, M, d, F, S * F, s);
  else if (rows2 == 64)
    err = launch_mask<64>(hf, w2f, b2f, mf, mo, so, T, M, d, F, S * F, s);
  else if (rows2 == 32)
    err = launch_mask<32>(hf, w2f, b2f, mf, mo, so, T, M, d, F, S * F, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* avsep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
