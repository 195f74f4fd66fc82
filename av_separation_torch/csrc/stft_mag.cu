// Fused STFT magnitude as a matrix DFT, float32, for Hopper (sm_90a).
//
// Replaces: av_separation_tpu/ops/pallas/stft.py `_stft_kernel` (called from
// `stft_magnitude_pallas`) for n_fft above 4096, at any n_fft, hop and
// number of signals: the route for n_fft above 4096, chosen by shape in
// ops/kernels/stft.py, launches counted as `stft_mag_dft_fwd`.  Every n_fft
// in [2, 4096] takes the FFT of stft_fft.cu.  Computes, with the
// reference's semantics
// (symmetric Hann window, frame i starting at sample i*hop, no centering,
// samples past N read as zero),
//     mag[b, k, i] = | sum_n audio[b, i*hop + n] * w[n] * exp(-2 pi j k n / n_fft) |
// for k in [0, F), F = n_fft/2 + 1, and i in [0, T).  audio is (B, N),
// mag (B, F, T).  The windowed bases cos_b / sin_b are (n_fft, F_pad) float32
// (built in float64 on the host, zero in the pad columns [F, F_pad)).
//
// Bound on the H100, for the function and not this algorithm: the audio
// read once and the spectra written once against a real FFT's
// 2.5 n_fft log2(n_fft) FLOPs a frame.  That is bound by bytes: at n_fft
// 400, hop 160 on 24 x 64,000 samples (T 401, F 201), 13.9 MB at
// 3.35 TB/s, 4.1 us.  This
// matrix DFT does 4 n_fft F FLOPs a frame (O(n_fft^2)), so at 67 TFLOP/s
// float32 it stays far above that bound; it is kept for the n_fft above
// 4096, where the FFT's block no longer fits shared memory (the Pallas
// kernel itself holds 2 n_fft F_pad float32 bases in VMEM there).
//
// Design: a block owns a tile of kTile = 32 frames and a group of frequency
// bins (one bin per thread, at most 128 threads).  Each thread keeps its
// bin's re and im for the tile's 32 frames in registers and reads its basis
// rows once a tile (coalesced, lanes over bins: frames start hop floats
// apart, and a hop that is a multiple of 32 would put lanes over frames on
// one bank).  Frame samples are broadcasts: every lane reads the same one.
// Three kinds of block, chosen per call by `dft_plan` in ops/kernels/stft.py:
// - kStagedVec: 32 frames of one signal whose audio span,
//   31*hop + n_fft samples, fits in shared memory: staged once (zero past
//   N), as the Pallas kernel DMAs its span into VMEM, then read four
//   samples at a time (float4: n_fft and hop are multiples of 4).  8 FMAs a
//   broadcast load.
// - kStaged: the same, one sample at a time (n_fft or hop not a multiple
//   of 4).
// - kGlobal: 32 consecutive frames of the flattened (signal, frame) index,
//   read from global memory (through L1): where the span does not fit in
//   shared memory (a large hop), or a signal has fewer than 32 frames (one
//   frame each over many signals), so that a tile still shares each basis
//   row between 32 frames.  Each frame's offset and length sit in shared
//   memory.
// Signals fold into grid x with the tiles, so any number of them runs.  The
// magnitudes go through shared memory so that each warp stores 32 frames of
// one bin: along T, coalesced when the frames are of one signal.  Frames
// past T (the last tile) are computed on zeros and not stored.
#include <cuda_runtime.h>

#include "device_guard.cuh"

namespace {

constexpr int kTile = 32;         // frames per block (one per lane at store)
constexpr int kStageStride = 33;  // staged row stride: conflict-free both ways
constexpr int kStagedVec = 0, kStaged = 1, kGlobal = 2;

template <int KIND>
__global__ void __launch_bounds__(128) stft_mag_kernel(
    const float* __restrict__ audio, const float* __restrict__ cos_b,
    const float* __restrict__ sin_b, float* __restrict__ mag, int B, int N,
    int T, int n_fft, int hop, int F, int F_pad, int tiles) {
  extern __shared__ float4 smem4[];
  float* sA = reinterpret_cast<float*>(smem4);  // audio span, then the stage
  __shared__ long long sOff[kTile];  // kGlobal: a frame's first sample
  __shared__ int sLen[kTile];        // kGlobal: its samples before N

  const int k0 = blockIdx.y * blockDim.x;
  const int k = k0 + threadIdx.x;  // < F_pad: the pad columns are zero
  // Staged: signal b, frames t0 .. t0 + 31.  Global: flattened frames
  // f0 .. f0 + 31 (frame f is frame f % T of signal f / T).
  const long long f0 = (long long)blockIdx.x * kTile;
  const int b = KIND == kGlobal ? 0 : blockIdx.x / tiles;
  const int t0 = KIND == kGlobal ? 0 : (blockIdx.x - b * tiles) * kTile;

  if (KIND == kGlobal) {
    if (threadIdx.x < kTile) {
      const long long f = f0 + threadIdx.x;
      const long long fb = f / T, start = (f - fb * T) * (long long)hop;
      const bool ok = fb < B && start < N;
      sOff[threadIdx.x] = ok ? fb * N + start : 0;
      sLen[threadIdx.x] = ok ? (int)(N - start) : 0;
    }
  } else {
    // Stage samples [t0*hop, t0*hop + span) of signal b, zero past N.
    const int span = (kTile - 1) * hop + n_fft;
    const long long g0 = (long long)t0 * hop;
    const float* src = audio + (size_t)b * N;
    for (int i = threadIdx.x; i < span; i += blockDim.x) {
      const long long g = g0 + i;
      sA[i] = g < N ? src[g] : 0.f;
    }
  }
  __syncthreads();

  float re[kTile], im[kTile];
#pragma unroll
  for (int t = 0; t < kTile; ++t) {
    re[t] = 0.f;
    im[t] = 0.f;
  }
  if (KIND == kStagedVec) {
    const float4* sA4 = reinterpret_cast<const float4*>(sA);
    const int hop4 = hop / 4;
#pragma unroll 1
    for (int n = 0; n < n_fft; n += 4) {
      const float* cp = cos_b + (size_t)n * F_pad + k;
      const float* sp = sin_b + (size_t)n * F_pad + k;
      const float c0 = __ldg(cp), c1 = __ldg(cp + F_pad),
                  c2 = __ldg(cp + 2 * F_pad), c3 = __ldg(cp + 3 * F_pad);
      const float s0 = __ldg(sp), s1 = __ldg(sp + F_pad),
                  s2 = __ldg(sp + 2 * F_pad), s3 = __ldg(sp + 3 * F_pad);
      const int n4 = n / 4;
#pragma unroll
      for (int t = 0; t < kTile; ++t) {
        const float4 x = sA4[t * hop4 + n4];  // the same address in every lane
        re[t] = fmaf(x.x, c0, re[t]);
        im[t] = fmaf(x.x, s0, im[t]);
        re[t] = fmaf(x.y, c1, re[t]);
        im[t] = fmaf(x.y, s1, im[t]);
        re[t] = fmaf(x.z, c2, re[t]);
        im[t] = fmaf(x.z, s2, im[t]);
        re[t] = fmaf(x.w, c3, re[t]);
        im[t] = fmaf(x.w, s3, im[t]);
      }
    }
  } else {
#pragma unroll 1
    for (int n = 0; n < n_fft; ++n) {
      const float c = __ldg(cos_b + (size_t)n * F_pad + k);
      const float s = __ldg(sin_b + (size_t)n * F_pad + k);
#pragma unroll
      for (int t = 0; t < kTile; ++t) {
        float x;
        if (KIND == kStaged)
          x = sA[t * hop + n];  // the same address in every lane
        else
          x = n < sLen[t] ? __ldg(audio + sOff[t] + n) : 0.f;
        re[t] = fmaf(x, c, re[t]);
        im[t] = fmaf(x, s, im[t]);
      }
    }
  }
  __syncthreads();  // every lane is done with the audio span

  // Stage row threadIdx.x = this bin's 32 magnitudes (bank (row + t) % 32).
  float* stage = sA;
#pragma unroll
  for (int t = 0; t < kTile; ++t)
    stage[threadIdx.x * kStageStride + t] =
        sqrtf(re[t] * re[t] + im[t] * im[t]);
  __syncthreads();

  // Each warp stores whole rows: lane = frame.
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int nwarps = blockDim.x / 32;
  long long fb = b, ft = t0 + lane;  // the lane's signal and frame
  if (KIND == kGlobal) {
    const long long f = f0 + lane;
    fb = f / T;
    ft = f - fb * T;
  }
  if (fb >= B || ft >= T) return;
  float* dst = mag + (size_t)fb * F * T + ft;
  for (int r = warp; r < (int)blockDim.x; r += nwarps) {
    const int kr = k0 + r;
    if (kr < F) dst[(size_t)kr * T] = stage[r * kStageStride + lane];
  }
}

template <int KIND>
cudaError_t launch(dim3 grid, int threads, size_t smem, cudaStream_t s,
                   const float* audio, const float* cos_b,
                   const float* sin_b, float* mag, int B, int N, int T,
                   int n_fft, int hop, int F, int F_pad, int tiles) {
  cudaError_t err = cudaFuncSetAttribute(
      stft_mag_kernel<KIND>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  stft_mag_kernel<KIND><<<grid, threads, smem, s>>>(
      audio, cos_b, sin_b, mag, B, N, T, n_fft, hop, F, F_pad, tiles);
  return cudaGetLastError();
}

}  // namespace

// Launch over B signals of N samples, T frames each.  threads_per_block is
// a multiple of 32 in [32, 128] and divides F_pad; kind is 0 (staged,
// float4: n_fft and hop multiples of 4), 1 (staged) or 2 (global), as
// `dft_plan` in ops/kernels/stft.py chooses it.  Returns a cudaError_t
// (0 on success).
extern "C" int avsep_stft_mag_fwd(const void* audio, const void* cos_b,
                                  const void* sin_b, void* mag, int B, int N,
                                  int T, int n_fft, int hop, int F, int F_pad,
                                  int threads_per_block, int kind, int device,
                                  void* stream) {
  if (n_fft < 2 || hop < 1 || B < 1 || N < 1 || T < 1 ||
      F != n_fft / 2 + 1 || threads_per_block % 32 != 0 ||
      threads_per_block < 32 || threads_per_block > 128 ||
      F_pad % threads_per_block != 0 || F_pad < F || kind < 0 || kind > 2 ||
      (kind == kStagedVec && (n_fft % 4 != 0 || hop % 4 != 0)))
    return cudaErrorInvalidValue;
  const long long span = (long long)(kTile - 1) * hop + n_fft;
  const long long stage = (long long)threads_per_block * kStageStride;
  const long long floats = kind == kGlobal || span < stage ? stage : span;
  const long long tiles = (T + kTile - 1) / kTile;
  const long long blocks =
      kind == kGlobal ? ((long long)B * T + kTile - 1) / kTile : B * tiles;
  if (floats * 4 > 232448 - 384 || blocks > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(blocks), F_pad / threads_per_block);
  const size_t smem = sizeof(float) * (size_t)floats;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const float*>(audio);
  const auto* cb = static_cast<const float*>(cos_b);
  const auto* sb = static_cast<const float*>(sin_b);
  auto* m = static_cast<float*>(mag);
  const int nt = static_cast<int>(tiles);
  if (kind == kStagedVec)
    err = launch<kStagedVec>(grid, threads_per_block, smem, s, a, cb, sb, m,
                             B, N, T, n_fft, hop, F, F_pad, nt);
  else if (kind == kStaged)
    err = launch<kStaged>(grid, threads_per_block, smem, s, a, cb, sb, m, B,
                          N, T, n_fft, hop, F, F_pad, nt);
  else
    err = launch<kGlobal>(grid, threads_per_block, smem, s, a, cb, sb, m, B,
                          N, T, n_fft, hop, F, F_pad, nt);
  return static_cast<int>(err);
}

extern "C" const char* avsep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
