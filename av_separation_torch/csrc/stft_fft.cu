// STFT magnitude as a shared-memory FFT, float32, for Hopper (sm_90a).
//
// Replaces: av_separation_tpu/ops/pallas/stft.py `_stft_kernel` (called from
// `stft_magnitude_pallas`) for every n_fft in [8, 4096] that is a multiple
// of 4 and whose half M = n_fft/2 has no prime factor above 5: the powers of
// two (every config of the repository uses n_fft 512) and the speech
// front ends' 400 (M = 200), 480, 320.  Other n_fft keep the matrix DFT of
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
// (M = n_fft/2 points), transformed by a mixed-radix Stockham FFT in
// shared memory, one stage a radix of the host's plan (`Plan`: one radix-2
// stage when M's power of two has an odd exponent, then radix 4, then 3,
// then 5; for M = 256 four radix-4 stages, for M = 200 the radices 2, 4, 5,
// 5); ping-pong between two buffers, one __syncthreads a stage, no digit
// reversal, and each butterfly reads z[j + r M/R], so a warp reads
// consecutive words.  A power-of-two M indexes its stages by shifts and
// masks; the mixed-radix plan divides by per-stage constants (M/R, the
// stride ns) computed on the host (`FastDiv`: a multiply and a shift), not
// `%`.  Then
// a split step gives the M+1 bins of the real transform:
//     X[k] = (Z[k] + Z*[M-k]) / 2 - i W^k (Z[k] - Z*[M-k]) / 2,  Z[M] = Z[0],
// with W = exp(-2 pi i / n_fft).  Twiddles and the window are float32
// tables built on the host in float64; the radix-3 and radix-5 butterflies'
// constants are float64 values rounded to float32.  Magnitudes go to a
// (bin, frame) stage at row stride tf+1 (odd, conflict-free), from which
// each warp stores consecutive frames of one bin: coalesced along T.  The
// wrapper sizes `tf` (a power of two <= 8) to fit shared memory and to give
// the grid at least two blocks per SM where the batch allows.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_3xtf32.cuh"  // the cp.async copies

namespace {

constexpr int kThreads = 256;
constexpr int kMaxStages = 12;  // M <= 2048: at most 11 radices

// n / d for 0 <= n < 2^16 and d <= 2^12 as (n m) >> 31 with
// m = ceil(2^31 / d): the error n (m d - 2^31) / (d 2^31) < 1/d is too
// small to reach the next integer (d a power of two: m is exact).
struct FastDiv {
  unsigned m;
  static FastDiv of(unsigned d) { return {((1u << 31) + d - 1) / d}; }
  __device__ __forceinline__ int div(int n) const {
    return static_cast<int>(
        (static_cast<unsigned long long>(static_cast<unsigned>(n)) * m) >> 31);
  }
};

// One Stockham stage of the plan, its constants computed on the host.
struct Stage {
  int radix;
  int ns;      // product of the earlier stages' radices
  int tw;      // twiddle step 2M / (radix ns)
  FastDiv mr;  // by M / radix
  FastDiv by_ns;
};

struct Plan {
  int n;
  FastDiv m, f;  // by M and by F = M + 1
  Stage stage[kMaxStages];
};

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

// The R-point DFT in place, X[m] = sum_r v[r] exp(-2 pi i m r / R).
template <int R>
__device__ __forceinline__ void butterfly(float2 (&v)[R]);

template <>
__device__ __forceinline__ void butterfly<2>(float2 (&v)[2]) {
  const float2 a = v[0], b = v[1];
  v[0] = make_float2(a.x + b.x, a.y + b.y);
  v[1] = make_float2(a.x - b.x, a.y - b.y);
}

template <>
__device__ __forceinline__ void butterfly<4>(float2 (&v)[4]) {
  const float2 a0 = make_float2(v[0].x + v[2].x, v[0].y + v[2].y);
  const float2 a1 = make_float2(v[0].x - v[2].x, v[0].y - v[2].y);
  const float2 a2 = make_float2(v[1].x + v[3].x, v[1].y + v[3].y);
  const float2 a3 = make_float2(v[1].y - v[3].y, v[3].x - v[1].x);  // -i(v1-v3)
  v[0] = make_float2(a0.x + a2.x, a0.y + a2.y);
  v[1] = make_float2(a1.x + a3.x, a1.y + a3.y);
  v[2] = make_float2(a0.x - a2.x, a0.y - a2.y);
  v[3] = make_float2(a1.x - a3.x, a1.y - a3.y);
}

// sin(2 pi / 3), cos and sin of 2 pi / 5 and 4 pi / 5, float64 rounded to
// float32.
constexpr float kS3 = 0.8660254037844386f;
constexpr float kC5a = 0.30901699437494745f;
constexpr float kC5b = -0.8090169943749475f;
constexpr float kS5a = 0.9510565162951535f;
constexpr float kS5b = 0.5877852522924731f;

template <>
__device__ __forceinline__ void butterfly<3>(float2 (&v)[3]) {
  const float2 t = make_float2(v[1].x + v[2].x, v[1].y + v[2].y);
  const float2 d = make_float2(v[1].x - v[2].x, v[1].y - v[2].y);
  const float2 c = make_float2(v[0].x - 0.5f * t.x, v[0].y - 0.5f * t.y);
  const float2 m = make_float2(kS3 * d.y, -kS3 * d.x);  // -i sin(2pi/3) d
  v[0] = make_float2(v[0].x + t.x, v[0].y + t.y);
  v[1] = make_float2(c.x + m.x, c.y + m.y);
  v[2] = make_float2(c.x - m.x, c.y - m.y);
}

template <>
__device__ __forceinline__ void butterfly<5>(float2 (&v)[5]) {
  const float2 a1 = make_float2(v[1].x + v[4].x, v[1].y + v[4].y);
  const float2 b1 = make_float2(v[1].x - v[4].x, v[1].y - v[4].y);
  const float2 a2 = make_float2(v[2].x + v[3].x, v[2].y + v[3].y);
  const float2 b2 = make_float2(v[2].x - v[3].x, v[2].y - v[3].y);
  const float2 c1 = make_float2(v[0].x + kC5a * a1.x + kC5b * a2.x,
                                v[0].y + kC5a * a1.y + kC5b * a2.y);
  const float2 c2 = make_float2(v[0].x + kC5b * a1.x + kC5a * a2.x,
                                v[0].y + kC5b * a1.y + kC5a * a2.y);
  // -i (s1 b1 + s2 b2) and -i (s2 b1 - s1 b2)
  const float2 e1 = make_float2(kS5a * b1.y + kS5b * b2.y,
                                -(kS5a * b1.x + kS5b * b2.x));
  const float2 e2 = make_float2(kS5b * b1.y - kS5a * b2.y,
                                -(kS5b * b1.x - kS5a * b2.x));
  v[0] = make_float2(v[0].x + a1.x + a2.x, v[0].y + a1.y + a2.y);
  v[1] = make_float2(c1.x + e1.x, c1.y + e1.y);
  v[4] = make_float2(c1.x - e1.x, c1.y - e1.y);
  v[2] = make_float2(c2.x + e2.x, c2.y + e2.y);
  v[3] = make_float2(c2.x - e2.x, c2.y - e2.y);
}

// One butterfly of a Stockham stage of radix R: reads fin[r mr]
// (mr = M/R), multiplies by W^{r t}, t = k 2M/(R ns) (W the n_fft-th root,
// r t < 2M), takes the R-point DFT and writes fout[r ns].
template <int R>
__device__ __forceinline__ void radix_step(const float2* fin, float2* fout,
                                           const float2* sW, int mr, int ns,
                                           int t, int M) {
  float2 v[R];
  v[0] = fin[0];
#pragma unroll
  for (int r = 1; r < R; ++r)
    v[r] = cmul(fin[r * mr], twiddle_at(sW, r * t, M));
  butterfly<R>(v);
#pragma unroll
  for (int r = 0; r < R; ++r) fout[r * ns] = v[r];
}

// One Stockham stage of radix R over tf frames of M points, after stages
// whose radices multiply to ns: butterfly j of a frame (k = j mod ns)
// reads z[j + r M/R] and writes (j - k) R + k + r ns.  A stage of the
// mixed-radix plan divides by its host-computed constants.
template <int R>
__device__ __forceinline__ void stage(const float2* in, float2* out,
                                      const float2* sW, int M, const Stage st,
                                      int tf, int tid) {
  const int mr = M / R, ns = st.ns;
  for (int i = tid; i < tf * mr; i += kThreads) {
    const int f = st.mr.div(i), j = i - f * mr;
    const int q = st.by_ns.div(j), k = j - q * ns;
    radix_step<R>(in + f * M + j, out + f * M + q * ns * R + k, sW, mr, ns,
                  k * st.tw, M);
  }
}

// The same stage for a power-of-two M (R = 2 or 4, M = 2^log2m,
// ns = 2^log2ns), indexed by shifts and masks (the divisions cost 8% at
// the scaled device batch on an H100).
template <int R>
__device__ __forceinline__ void stage_pow2(const float2* in, float2* out,
                                           const float2* sW, int M, int log2m,
                                           int log2ns, int tf, int tid) {
  constexpr int kLog2R = R == 4 ? 2 : 1;
  const int log2mr = log2m - kLog2R, ns = 1 << log2ns;
  for (int i = tid; i < (tf << log2mr); i += kThreads) {
    const int f = i >> log2mr, j = i & ((1 << log2mr) - 1);
    const int k = j & (ns - 1);
    radix_step<R>(in + (f << log2m) + j,
                  out + (f << log2m) + ((j - k) << kLog2R) + k, sW,
                  1 << log2mr, ns, k << (log2m + 1 - kLog2R - log2ns), M);
  }
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

// POW2: M is a power of two, and the plan's stages (one radix 2 when
// log2(M) is odd, then radix 4) are indexed by shifts.
template <bool POW2>
__global__ void __launch_bounds__(kThreads) stft_fft_kernel(
    const float* __restrict__ audio, const float* __restrict__ window,
    const float2* __restrict__ twiddle, float* __restrict__ mag, int N, int T,
    int n_fft, int hop, int tf, int log2tf, int vec, const Plan plan) {
  extern __shared__ float4 smem4[];
  const int M = n_fft >> 1;
  const int F = M + 1;
  const int R = region_floats(n_fft, hop, tf);
  float* regA = reinterpret_cast<float*>(smem4);
  float* regB = regA + R;
  float2* sW = reinterpret_cast<float2*>(regB + R);      // M + 1
  float* sWin = reinterpret_cast<float*>(sW + M + 1);    // n_fft
  const int log2m = __ffs(M) - 1;                        // when POW2

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
  // The plan's stages into shared memory, each by its own thread (static
  // indices keep the kernel parameter out of local memory).
  __shared__ Stage sStage[kMaxStages];
  if (!POW2) {
#pragma unroll
    for (int s = 0; s < kMaxStages; ++s)
      if (tid == s) sStage[s] = plan.stage[s];
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // Window and pack frame f into region A: z[n] = w x[2n] + i w x[2n+1].
  {
    const float2* span2 = reinterpret_cast<const float2*>(sSpan);
    const float2* win2 = reinterpret_cast<const float2*>(sWin);
    float2* z = reinterpret_cast<float2*>(regA);
    const int hop2 = hop >> 1;
    for (int i = tid; i < tf * M; i += kThreads) {
      const int f = POW2 ? i >> log2m : plan.m.div(i), n = i - f * M;
      const float2 x = span2[f * hop2 + n];
      const float2 w = win2[n];
      z[i] = make_float2(x.x * w.x, x.y * w.y);
    }
  }
  __syncthreads();

  // Stockham FFT, A -> B -> A ..., one stage a radix of the plan.
  float2* in = reinterpret_cast<float2*>(regA);
  float2* out = reinterpret_cast<float2*>(regB);
  for (int s = 0, log2ns = 0; s < plan.n; ++s) {
    if (POW2) {
      if (log2ns == 0 && (log2m & 1)) {
        stage_pow2<2>(in, out, sW, M, log2m, log2ns, tf, tid);
        log2ns += 1;
      } else {
        stage_pow2<4>(in, out, sW, M, log2m, log2ns, tf, tid);
        log2ns += 2;
      }
    } else {
      // By value, so in registers: the stage's stores to shared memory
      // cannot alias it.
      const Stage st = sStage[s];
      if (st.radix == 4)
        stage<4>(in, out, sW, M, st, tf, tid);
      else if (st.radix == 2)
        stage<2>(in, out, sW, M, st, tf, tid);
      else if (st.radix == 3)
        stage<3>(in, out, sW, M, st, tf, tid);
      else
        stage<5>(in, out, sW, M, st, tf, tid);
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
    const int f = plan.f.div(i), k = i - f * F;
    const float2* zf = Z + f * M;
    const float2 zk = zf[k == M ? 0 : k];
    const float2 zm = zf[k == 0 ? 0 : M - k];
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

}  // namespace

// Launch over B signals of N samples; window is n_fft floats, twiddle
// n_fft/2 + 1 complex (float2) values exp(-2 pi i k / n_fft); `radices`
// (n_stages of 2, 3, 4, 5) multiply to n_fft/2, and for a power of two are
// one 2 when log2(n_fft/2) is odd, then 4s.  `tf` (frames a block) is a
// power of two in [1, 32]; `vec` asks for 16-byte copies and needs
// N % 4 == 0 and a 16-byte aligned audio pointer.  Returns a cudaError_t
// (0 on success).
extern "C" int avsep_stft_fft_fwd(const void* audio, const void* window,
                                  const void* twiddle, void* mag, int B, int N,
                                  int T, int n_fft, int hop, int tf, int vec,
                                  const int* radices, int n_stages, int device,
                                  void* stream) {
  Plan plan = {};
  plan.n = n_stages;
  const int M = n_fft / 2;
  const bool pow2 = M > 0 && (M & (M - 1)) == 0;
  int ns = 1;
  bool ok = n_stages >= 1 && n_stages <= kMaxStages && M >= 4;
  for (int s = 0; ok && s < n_stages; ++s) {
    const int r = radices[s];
    ok = r >= 2 && r <= 5 && M % (ns * r) == 0 &&
         (!pow2 || r == ((s == 0 && (__builtin_ctz(M) & 1)) ? 2 : 4));
    if (!ok) break;
    plan.stage[s] = {r, ns, 2 * M / (r * ns), FastDiv::of(M / r),
                     FastDiv::of(ns)};
    ns *= r;
  }
  plan.m = FastDiv::of(M);
  plan.f = FastDiv::of(M + 1);
  int log2tf = 0;
  while ((1 << log2tf) < tf) ++log2tf;
  if (!ok || ns != M || n_fft < 8 || n_fft > 4096 ||
      n_fft % 4 != 0 || tf < 1 || tf > 32 || (1 << log2tf) != tf ||
      hop % 4 != 0 || hop < 4 || B < 1 || B > 65535 || N < 1 || T < 1 ||
      (vec && (N % 4 != 0 ||
               reinterpret_cast<uintptr_t>(audio) % 16 != 0)))
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(n_fft, hop, tf);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto kernel = pow2 ? stft_fft_kernel<true> : stft_fft_kernel<false>;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((T + tf - 1) / tf, B);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(audio), static_cast<const float*>(window),
      static_cast<const float2*>(twiddle), static_cast<float*>(mag), N, T,
      n_fft, hop, tf, log2tf, vec, plan);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* avsep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
