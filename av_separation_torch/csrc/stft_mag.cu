// Fused STFT magnitude as a matrix DFT, float32, for Hopper (sm_90a).
//
// Replaces: av_separation_tpu/ops/pallas/stft.py `_stft_kernel` (called from
// `stft_magnitude_pallas`) for n_fft above 4096 (a multiple of 4, at a hop
// that is one): the route for n_fft above 4096, chosen by shape in
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
// Design: a block owns one signal, a tile of kTile = 32 frames and a group of
// frequency bins (one bin per thread, at most 128 threads).  It stages the
// audio span of its tile, (kTile-1)*hop + n_fft samples, into shared memory
// once (zero past N), as the Pallas kernel DMAs its span into VMEM, so each
// sample is fetched once per tile and not n_fft/hop times.  Lanes lie over
// frequency bins, not frames: frames start hop floats apart, and hop = 128 is
// a multiple of the 32 banks, so lanes over frames would all hit one bank.
// With lanes over bins the basis rows load coalesced (from L2: 1.1 MB, read
// by every block) and the frame samples are shared-memory broadcasts, four
// at a time (float4: hop and n_fft are multiples of 4).  Each thread keeps
// its bin's re and im for the tile's 32 frames in registers: 8 float32 FMAs
// per broadcast load, no TF32.  The magnitudes go through shared memory
// (the audio span's space, reused) so that each warp stores 32 consecutive
// frames of one bin: coalesced along T, with no separate transpose.  Frames
// past T (the last tile) are computed on zeros and not stored.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;         // frames per block (one per lane at store)
constexpr int kStageStride = 33;  // staged row stride: conflict-free both ways

__global__ void __launch_bounds__(128) stft_mag_kernel(
    const float* __restrict__ audio, const float* __restrict__ cos_b,
    const float* __restrict__ sin_b, float* __restrict__ mag, int N, int T,
    int n_fft, int hop, int F, int F_pad) {
  extern __shared__ float4 smem4[];
  float* sA = reinterpret_cast<float*>(smem4);  // audio span, then the stage

  const int b = blockIdx.z;
  const int t0 = blockIdx.x * kTile;
  const int k0 = blockIdx.y * blockDim.x;
  const int k = k0 + threadIdx.x;  // < F_pad: the pad columns are zero

  // Stage samples [t0*hop, t0*hop + span) of signal b, zero past N.
  const int span = (kTile - 1) * hop + n_fft;
  const long long g0 = (long long)t0 * hop;
  const float* src = audio + (size_t)b * N;
  for (int i = threadIdx.x; i < span; i += blockDim.x) {
    const long long g = g0 + i;
    sA[i] = g < N ? src[g] : 0.f;
  }
  __syncthreads();

  float re[kTile], im[kTile];
#pragma unroll
  for (int t = 0; t < kTile; ++t) {
    re[t] = 0.f;
    im[t] = 0.f;
  }
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
  __syncthreads();  // every lane is done with the audio span

  // Stage row threadIdx.x = this bin's 32 magnitudes (bank (row + t) % 32).
  float* stage = sA;
#pragma unroll
  for (int t = 0; t < kTile; ++t)
    stage[threadIdx.x * kStageStride + t] =
        sqrtf(re[t] * re[t] + im[t] * im[t]);
  __syncthreads();

  // Each warp stores whole rows: lane = frame, 32 consecutive floats of T.
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int nwarps = blockDim.x / 32;
  const int t = t0 + lane;
  float* dst = mag + (size_t)b * F * T;
  for (int r = warp; r < (int)blockDim.x; r += nwarps) {
    const int kr = k0 + r;
    if (kr < F && t < T)
      dst[(size_t)kr * T + t] = stage[r * kStageStride + lane];
  }
}

}  // namespace

// Launch over B signals; threads_per_block is a multiple of 32 in [32, 128]
// and divides F_pad.  Returns a cudaError_t (0 on success).
extern "C" int avsep_stft_mag_fwd(const void* audio, const void* cos_b,
                                  const void* sin_b, void* mag, int B, int N,
                                  int T, int n_fft, int hop, int F, int F_pad,
                                  int threads_per_block, int device,
                                  void* stream) {
  if (n_fft % 4 != 0 || hop % 4 != 0 || n_fft < 4 || hop < 4 ||
      F != n_fft / 2 + 1 || threads_per_block % 32 != 0 ||
      threads_per_block < 32 || threads_per_block > 128 ||
      F_pad % threads_per_block != 0 || F_pad < F)
    return cudaErrorInvalidValue;
  const int span = (kTile - 1) * hop + n_fft;
  const int stage = threads_per_block * kStageStride;
  const size_t smem = sizeof(float) * (size_t)(span > stage ? span : stage);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(stft_mag_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((T + kTile - 1) / kTile, F_pad / threads_per_block, B);
  stft_mag_kernel<<<grid, threads_per_block, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(audio), static_cast<const float*>(cos_b),
      static_cast<const float*>(sin_b), static_cast<float*>(mag), N, T, n_fft,
      hop, F, F_pad);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* avsep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
