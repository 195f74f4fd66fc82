// STFT magnitude as a shared-memory FFT, float32, for Hopper (sm_90a).
//
// Replaces: av_separation_tpu/ops/pallas/stft.py `_stft_kernel` (called from
// `stft_magnitude_pallas`) for power-of-two n_fft in [8, 4096]; every config
// of the repository uses n_fft 512.  Other n_fft keep the matrix DFT of
// stft_mag.cu, chosen by shape in ops/kernels/stft.py.  Semantics are those
// of the Pallas kernel: symmetric Hann window, frame i starting at sample
// i*hop, no centering, samples past N read as zero; audio (B, N) float32,
// mag (B, F, T) float32, F = n_fft/2 + 1.
//
// Bound on the H100 at the scaled device batch (24 signals of 64,000
// samples, n_fft 512, hop 128, T 501): a real FFT needs 2.5 n_fft
// log2(n_fft) FLOPs a frame, 0.139 GFLOP in all (2 us at 67 TFLOP/s), against
// 18.5 MB of audio in and spectra out (5.5 us at 3.35 TB/s): bound by bytes.
// The matrix DFT of stft_mag.cu does 4 n_fft F FLOPs a frame, 50x more.
//
// Design: a block owns one signal and a tile of `tf` frames.  It stages the
// tile's audio span, (tf-1)*hop + n_fft samples, into shared memory once
// with cp.async (16-byte copies when the rows allow it, else 4-byte; the
// src-size 0 form zero-fills samples past N).  Each frame is windowed and
// packed as a half-length complex sequence z[n] = x[2n] + i x[2n+1]
// (M = n_fft/2 points), transformed by a Stockham FFT in shared memory:
// radix-4 stages (4 for M = 256), after one radix-2 stage when log2(M) is
// odd; ping-pong between two buffers, one __syncthreads a stage, no bit
// reversal, and each butterfly reads z[j + r M/4], so a warp reads
// consecutive words.  Then a split step gives the M+1 bins of the real
// transform:
//     X[k] = (Z[k] + Z*[M-k]) / 2 - i W^k (Z[k] - Z*[M-k]) / 2,  Z[M] = Z[0],
// with W = exp(-2 pi i / n_fft).  Twiddles and the window are float32
// tables built on the host in float64.  Magnitudes go to a (bin, frame)
// stage at row stride tf+1 (odd, conflict-free), from which each warp
// stores consecutive frames of one bin: coalesced along T.  The wrapper
// sizes `tf` (a power of two <= 8) to fit shared memory and to give the
// grid at least two blocks per SM where the batch allows.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// W^idx, W = exp(-2 pi i / n_fft), for idx in [0, 2M) from the table of
// W^0 .. W^M.
__device__ __forceinline__ float2 twiddle_at(const float2* sW, int idx,
                                             int M) {
  const float2 w = sW[idx <= M ? idx : idx - M];
  return idx <= M ? w : make_float2(-w.x, -w.y);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Floats of each of the two work regions: the staged span, the FFT's
// ping-pong buffer (tf frames of M complex) and the (bin, frame) stage all
// fit; rounded up to 4 floats so the next region stays 16-byte aligned.
__host__ __device__ inline int region_floats(int n_fft, int hop, int tf) {
  const int f = n_fft / 2 + 1;
  int r = n_fft * tf;
  const int span = (tf - 1) * hop + n_fft;
  if (span > r) r = span;
  if (f * (tf + 1) > r) r = f * (tf + 1);
  return (r + 3) & ~3;
}

__host__ __device__ inline size_t smem_bytes(int n_fft, int hop, int tf) {
  // two regions, M+1 complex twiddles, n_fft window samples
  return sizeof(float) * (2 * (size_t)region_floats(n_fft, hop, tf) +
                          2 * (size_t)(n_fft / 2 + 1) + n_fft);
}

__global__ void __launch_bounds__(kThreads) stft_fft_kernel(
    const float* __restrict__ audio, const float* __restrict__ window,
    const float2* __restrict__ twiddle, float* __restrict__ mag, int N, int T,
    int n_fft, int log2m, int hop, int tf, int log2tf, int vec) {
  extern __shared__ float4 smem4[];
  const int M = n_fft >> 1;
  const int F = M + 1;
  const int R = region_floats(n_fft, hop, tf);
  float* regA = reinterpret_cast<float*>(smem4);
  float* regB = regA + R;
  float2* sW = reinterpret_cast<float2*>(regB + R);      // M + 1
  float* sWin = reinterpret_cast<float*>(sW + M + 1);    // n_fft

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * tf;
  const long long g0 = (long long)t0 * hop;
  const float* src = audio + (size_t)b * N;

  // Stage the span [g0, g0 + span) into region B, zero past N.
  const int span = (tf - 1) * hop + n_fft;
  float* sSpan = regB;
  if (vec) {
    for (int c = tid; c < span / 4; c += kThreads) {
      const long long g = g0 + 4 * c;
      const bool ok = g < N;  // N % 4 == 0: a chunk is all in or all out
      cp_async16(sSpan + 4 * c, ok ? src + g : src, ok ? 16 : 0);
    }
  } else {
    for (int i = tid; i < span; i += kThreads) {
      const long long g = g0 + i;
      const bool ok = g < N;
      cp_async4(sSpan + i, ok ? src + g : src, ok ? 4 : 0);
    }
  }
  for (int i = tid; i <= M; i += kThreads) sW[i] = twiddle[i];
  for (int i = tid; i < n_fft; i += kThreads) sWin[i] = window[i];
  cp_async_wait_all();
  __syncthreads();

  // Window and pack frame f into region A: z[n] = w x[2n] + i w x[2n+1].
  {
    const float2* span2 = reinterpret_cast<const float2*>(sSpan);
    const float2* win2 = reinterpret_cast<const float2*>(sWin);
    float2* z = reinterpret_cast<float2*>(regA);
    const int hop2 = hop >> 1;
    for (int i = tid; i < (tf << log2m); i += kThreads) {
      const int f = i >> log2m, n = i & (M - 1);
      const float2 x = span2[f * hop2 + n];
      const float2 w = win2[n];
      z[i] = make_float2(x.x * w.x, x.y * w.y);
    }
  }
  __syncthreads();

  // Stockham FFT, A -> B -> A ...: radix-4 stages, after one radix-2 stage
  // when log2(M) is odd.  A stage of radix R reads z[j + r M/R] (a warp
  // reads consecutive words), multiplies by W_{R ns}^{k r}, k = j mod ns,
  // takes the R-point DFT and writes (j - k) R + k + r ns.
  float2* in = reinterpret_cast<float2*>(regA);
  float2* out = reinterpret_cast<float2*>(regB);
  int log2ns = 0;
  if (log2m & 1) {
    const int half = M >> 1;
    for (int i = tid; i < (tf << (log2m - 1)); i += kThreads) {
      const int f = i >> (log2m - 1), j = i & (half - 1);
      const float2* fin = in + (f << log2m);
      float2* fout = out + (f << log2m);
      const float2 v0 = fin[j], v1 = fin[j + half];
      fout[2 * j] = make_float2(v0.x + v1.x, v0.y + v1.y);
      fout[2 * j + 1] = make_float2(v0.x - v1.x, v0.y - v1.y);
    }
    __syncthreads();
    float2* tmp = in;
    in = out;
    out = tmp;
    log2ns = 1;
  }
  const int quarter = M >> 2;
  for (; log2ns < log2m; log2ns += 2) {
    const int ns = 1 << log2ns;
    for (int i = tid; i < (tf << (log2m - 2)); i += kThreads) {
      const int f = i >> (log2m - 2), j = i & (quarter - 1);
      const float2* fin = in + (f << log2m);
      float2* fout = out + (f << log2m);
      const int k = j & (ns - 1);
      // W_{4 ns}^{k r} = W^{r t}, t = k M / (2 ns); W^{M + x} = -W^x.
      const int t = k << (log2m - 1 - log2ns);
      const float2 v0 = fin[j];
      const float2 v1 = cmul(fin[j + quarter], twiddle_at(sW, t, M));
      const float2 v2 = cmul(fin[j + 2 * quarter], twiddle_at(sW, 2 * t, M));
      const float2 v3 = cmul(fin[j + 3 * quarter], twiddle_at(sW, 3 * t, M));
      const float2 a0 = make_float2(v0.x + v2.x, v0.y + v2.y);
      const float2 a1 = make_float2(v0.x - v2.x, v0.y - v2.y);
      const float2 a2 = make_float2(v1.x + v3.x, v1.y + v3.y);
      const float2 a3 = make_float2(v1.y - v3.y, v3.x - v1.x);  // -i (v1-v3)
      const int d = ((j - k) << 2) + k;
      fout[d] = make_float2(a0.x + a2.x, a0.y + a2.y);
      fout[d + ns] = make_float2(a1.x + a3.x, a1.y + a3.y);
      fout[d + 2 * ns] = make_float2(a0.x - a2.x, a0.y - a2.y);
      fout[d + 3 * ns] = make_float2(a1.x - a3.x, a1.y - a3.y);
    }
    __syncthreads();
    float2* tmp = in;
    in = out;
    out = tmp;
  }

  // Split into the F bins of the real transform and take the magnitude;
  // k runs fastest, so the stage writes at stride tf + 1 hit distinct banks.
  const float2* Z = in;
  float* sMag = reinterpret_cast<float*>(out);
  const int ms = tf + 1;
  for (int i = tid; i < tf * F; i += kThreads) {
    const int f = i / F, k = i - f * F;
    const float2* zf = Z + (f << log2m);
    const float2 zk = zf[k & (M - 1)];
    const float2 zm = zf[(M - k) & (M - 1)];
    const float ar = zk.x + zm.x, ai = zk.y - zm.y;  // Z[k] + Z*[M-k]
    const float br = zk.x - zm.x, bi = zk.y + zm.y;  // Z[k] - Z*[M-k]
    const float2 w = sW[k];
    const float wbr = w.x * br - w.y * bi, wbi = w.x * bi + w.y * br;
    const float xr = 0.5f * (ar + wbi), xi = 0.5f * (ai - wbr);
    sMag[k * ms + f] = sqrtf(xr * xr + xi * xi);
  }
  __syncthreads();

  // Store: consecutive threads take consecutive frames of one bin.
  float* dst = mag + (size_t)b * F * T;
  for (int i = tid; i < (F << log2tf); i += kThreads) {
    const int k = i >> log2tf, f = i & (tf - 1);
    const int t = t0 + f;
    if (t < T) dst[(size_t)k * T + t] = sMag[k * ms + f];
  }
}

int ilog2(int x) {
  int r = 0;
  while ((1 << r) < x) ++r;
  return (1 << r) == x ? r : -1;
}

}  // namespace

// Launch over B signals of N samples; window is n_fft floats, twiddle
// n_fft/2 + 1 complex (float2) values exp(-2 pi i k / n_fft).  `tf` (frames
// a block) is a power of two in [1, 32]; `vec` asks for 16-byte copies and
// needs N % 4 == 0 and a 16-byte aligned audio pointer.  Returns a
// cudaError_t (0 on success).
extern "C" int avsep_stft_fft_fwd(const void* audio, const void* window,
                                  const void* twiddle, void* mag, int B, int N,
                                  int T, int n_fft, int hop, int tf, int vec,
                                  int device, void* stream) {
  const int log2n = ilog2(n_fft);
  const int log2tf = ilog2(tf);
  if (log2n < 3 || log2n > 12 || log2tf < 0 || tf > 32 || hop % 4 != 0 ||
      hop < 4 || B < 1 || B > 65535 || N < 1 || T < 1 ||
      (vec && (N % 4 != 0 ||
               reinterpret_cast<uintptr_t>(audio) % 16 != 0)))
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(n_fft, hop, tf);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(stft_fft_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((T + tf - 1) / tf, B);
  stft_fft_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(audio), static_cast<const float*>(window),
      static_cast<const float2*>(twiddle), static_cast<float*>(mag), N, T,
      n_fft, log2n - 1, hop, tf, log2tf, vec);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* avsep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
