// STFT magnitude as an FFT, float32, for Hopper (sm_90a).
//
// Replaces: av_separation_tpu/ops/pallas/stft.py `_stft_kernel` (called from
// `stft_magnitude_pallas`) for every n_fft >= 2, at any hop and any number
// of signals.  Semantics are those of the Pallas kernel: symmetric Hann
// window, frame i starting at sample i*hop, no centering, samples past N
// read as zero; audio (B, N) float32, mag (B, F, T) float32,
// F = n_fft/2 + 1.  Two regimes, chosen by shape in ops/kernels/stft.py (not
// a fallback: an error in either raises):
//   (A) `stft_fft_kernel`, one block a tile of frames, the whole transform
//       in shared memory: every n_fft whose block fits 227 KB
//       (`avsep_stft_fft_fwd`, launches counted as `stft_mag_fwd`);
//   (B) `stft_4step_kernel`, the four-step FFT through a global scratch:
//       every larger transform (`avsep_stft_4step_fwd`, launches counted
//       as `stft_mag_4step_fwd`).
//
// Bound on the H100, for the function and not this algorithm: the audio
// read once and the spectra written once, against a real FFT's
// 2.5 n_fft log2(n_fft) FLOPs a frame at 67 TFLOP/s.  At the scaled device
// batch (24 signals of 64,000 samples, n_fft 512, hop 128, T 501): 18.5 MB
// (5.5 us at 3.35 TB/s) against 0.139 GFLOP (2 us): bound by bytes, as is
// every shape of the repository.  A matrix DFT does 4 n_fft F FLOPs a
// frame, 50x more at n_fft 512 and 1,300x more at n_fft 32768.
//
// The transform.  Each frame is windowed and packed into complex sequences
// of L points:
//   - even n_fft: z[n] = x[2n] + i x[2n+1], L = n_fft/2, one frame a
//     sequence, and after the FFT a split step gives the M+1 = L+1 bins:
//       X[k] = (Z[k] + Z*[M-k]) / 2 - i W^k (Z[k] - Z*[M-k]) / 2,
//     Z[M] = Z[0], W = exp(-2 pi i / n_fft);
//   - odd n_fft: frames 2s and 2s+1 as the real and imaginary parts of one
//     sequence of L = n_fft points (the second zero past T or at a tile of
//     one frame), separated after the FFT:
//       X1[k] = (Z[k] + Z*[L-k]) / 2,  X2[k] = (Z[k] - Z*[L-k]) / 2i.
// A 7-smooth L is a Stockham FFT, one stage a radix of the host's plan: a
// power of two 2^e in radix-8 stages after one radix-2 or radix-4 stage for
// e mod 3 (L = 256: 4, 8, 8); another length one radix-2 stage when its
// power of two has an odd exponent, then radix 4, 3, 5 and 7 (224: 2, 4, 4,
// 7; 441: 3, 3, 7, 7).  Any other L takes the first of three transforms
// that applies (ops/kernels/stft.py `fft_plan`):
//   - kRader (n_fft <= 4096): a prime L whose L - 1 = M is 7-smooth (257,
//     401, 31).  With g a primitive root mod L, the gather a[q] = z[g^q] and
//     b[m] = W_L^(g^-m): X[g^-p] = z[0] + (a (*) b)[p], a cyclic
//     convolution of M points on the same stages: M-point FFT; times the
//     host's FFT(b) / M; conjugate; M-point FFT again (the inverse, as
//     conj(FFT(conj y))); X[k] = z[0] + conj(V[p(k)]) read through the
//     host's table p(k), and X[0] = z[0] + A[0], the first FFT's DC bin;
//   - kPrime (n_fft <= 4096): every prime factor of L at most 31, the same
//     stages and then direct radix-11, -13, -17, -19, -23, -29 and -31
//     stages (551 = 19 29: two stages, no convolution).  A prime stage is
//     the p-point DFT in registers in its symmetric form, the (p - 1) / 2
//     pairs v_j +- v_{p-j} against cos and sin of 2 pi j k / p;
//   - kBluestein: any other L, the chirp-z transform: with the chirp
//     c[n] = exp(i pi n^2 / L), X[k] = c*[k] sum_n (z[n] c*[n]) c[k-n], a
//     circular convolution of P points, the smallest 7-smooth P >= 2L - 1
//     (525 for L 257, 1120 for 551, 4116 for 2049): multiply by c*[n] and
//     zero-pad to P; P-point FFT; multiply by the transform of the chirp
//     (host float64, divided by P); conjugate; P-point FFT again;
//     X[k] = c*[k] conj(V[k]), taken as the split step reads it.  The
//     chirp's phase n^2 mod 2L is computed in integers on the host, so no
//     float32 angle grows with n.
// Every stage ping-pongs between two buffers with one __syncthreads, no
// digit reversal; each butterfly reads z[j + r len/R], so a warp reads
// consecutive words.  A power-of-two L (or Bluestein's P) indexes its
// stages by shifts and masks; every other plan divides by per-stage
// constants computed on the host (`FastDiv`: a multiply and a shift), not
// `%`.  Twiddles (of order 2L,
// or 2 half of the FFT's length: an odd P has no half-period sign and takes
// the table of order 2P), window, chirp, Rader's tables and the transforms
// are float32 tables built on the host in float64 (Rader's permutations in
// integers); the radix-3, -5, -7, -8 and prime butterflies' constants are
// float64 values rounded to float32.
//
// (A) A block owns one signal and a tile of `tf` frames (the grid folds
// signals and tiles into x, so any number of signals runs).  Up to n_fft
// 4096 (256 threads) it stages the tile's audio span, (tf-1)*hop + n_fft
// samples, and the window into shared memory once with cp.async (16-byte
// copies when hop and N are multiples of 4 and the rows are 16-byte
// aligned, the span's ragged tail by 4-byte copies; else 4-byte copies
// throughout; the src-size 0 form zero-fills samples past N).  Above 4096
// (`WIDE`, 512 threads) nothing is staged: each sample and window value is
// read once, from global memory through L2, straight into the first work
// region, which frees the span and the window's share of shared memory;
// the twiddle (and split) tables come by cp.async meanwhile (1-3% faster
// on an H100 than plain copies; four of the pack's loads issued together
// a thread measured 1-5% slower: more registers, fewer blocks an SM).
// Magnitudes go to a (bin, frame) stage at row stride tf+1 (odd,
// conflict-free), from which each warp stores consecutive frames of one
// bin: coalesced along T when tf > 1; at one frame a block a warp's stores
// land T floats apart, and L2 merges the sectors of neighbouring blocks'
// frames.  The wrapper sizes `tf` (a power of two <= 8) so that four
// blocks share an SM where they can (else two, else one) and the grid
// gives every SM two blocks where the batch allows; above 4096 two frames
// where they fit (one block an SM at n_fft 8192), else one.  Reach, from
// the plan arithmetic (two work regions, the twiddle table of half + 1
// values, the Rader and Bluestein split table, Rader's z[0] and X[0] of
// each sequence, the staged window up to 4096, the 240-byte stage table):
// every n_fft in [2, 4096]; above, one frame a block (two for odd n_fft)
// fits 227 KB for a power-of-two L up to 8192 (n_fft 16384: two 64 KB
// regions and a 64 KB twiddle table, 196,888 bytes), a 7-smooth L up to
// 9,604 (even n_fft up to 19,208, odd up to 9,375), and Bluestein at P up
// to 8192 for an even n_fft up to 8,190; 2,150 of the n_fft in
// (4096, 65536].
//
// (B) The four-step (Bailey) FFT of P = n1 n2 points (P = L, or Bluestein's
// power of two): with n = n2 a + c and k = k1 + n1 k2,
//   Z[k1 + n1 k2] = sum_c W_n2^(c k2) W_P^(c k1) sum_a z[n2 a + c] W_n1^(a k1).
// Each pass is a launch of the same Stockham stages over sequences in
// shared memory; passes meet in a global scratch of P complex values a
// sequence, which the wrapper allocates for a chunk of sequences that stays
// in L2 (32 MiB) and walks chunk by chunk, so any number of frames runs.
//   - kColumns: the windowed, packed sequence straight from the audio
//     (under Bluestein times c*[n], zero from L to P), a block's C columns c
//     (a power of two) read row by row (consecutive columns, coalesced)
//     and kept so in shared memory, point a of column c at [a][c]; the
//     n1-point FFTs run in that layout (`stage_cols`: a warp's threads take
//     consecutive columns at one butterfly, so consecutive words and one
//     twiddle; sequences of n1 = 8 points laid one after another would put
//     a half-warp's reads on two banks); times W_P^(c k1); written back
//     row by row to the scratch as [k1][c].
//   - kRowsLast (no Bluestein): the rows' n2-point FFTs give Z[k1 + n1 k2]
//     at row k1.  The split needs Z[k] and Z[L-k], which lie in rows k1 and
//     (n1 - k1) mod n1: a block owns such pairs of rows, and the split (or
//     the separation of an odd n_fft's two frames) and the magnitude fuse
//     into its store.
//   - kRowsMiddle (Bluestein): the rows' n2-point FFTs give V in the
//     [k1][k2] layout; times the chirp's transform (the host's table in
//     that layout, read contiguously) and conjugated; then the first half
//     of the inverse in the transposed decomposition (input index
//     k1 + n1 k2, output m = m2 + n2 m1): the rows' n2-point FFTs, times
//     W_P^(k1 m2), written back in place.
//   - kColumnsLast (Bluestein): the columns' n1-point FFTs (in the column
//     layout) give the inverse's output at m = m2 + n2 m1, in natural
//     order, so no transpose is ever made.  Z[m] and Z[L-m] lie in
//     columns m2 and (r - m2) mod n2 (r = L mod n2): a block owns such
//     pairs of columns, and the post-multiply by c*[m], the split and the
//     magnitude fuse into its store.
// The pairs of the last pass are the orbits of x -> (a - x) mod A on its
// axis (rows: a = 0, A = n1; columns: a = r, A = n2): a block owns a run of
// representatives, x in [0, a/2] or in [a + 1, a + 1 + ceil((A-a-1)/2)),
// and loads each with its partner (2^k pairs a block).  The four-step
// twiddles W_P^m come from sincospif(2m / P) in float32 (exact argument
// for a power-of-two P (Bluestein's is one here); else within 2^-24 of
// it); the stages' tables are
// the host's, copied by cp.async while the pass loads its data.  The
// host picks n2, the largest divisor of P up to 2048, and n1 = P / n2 up
// to 8192 (every P up to 2^24 that is a power of two; every 7-smooth
// length with such a split), about 4096 points a block, 256 threads.
// The (B) rows lose to torch.stft at 8194 and 32768 (PERF.md).
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"
#include "mma_3xtf32.cuh"  // the cp.async copies

namespace {

constexpr int kThreads = 256;      // (A) up to n_fft 4096, and (B)
constexpr int kWideThreads = 512;  // (A) above n_fft 4096
constexpr int kStagedMax = 4096;   // (A) stages span and window up to here
constexpr int kMaxStages = 12;     // L <= 9604, sub-lengths <= 8192: <= 8
constexpr int kMaxSmem = 232448;
constexpr int kMaxPad = 8192;      // (A) Bluestein's P
constexpr int kMaxPrime = 31;      // (A) the largest direct prime radix
constexpr int kMaxRow = 2048;      // (B) n2
constexpr int kMaxColumn = 8192;   // (B) n1

// The transforms: a power-of-two L, a 7-smooth L (mixed radix),
// Bluestein's chirp-z over a 7-smooth P, an L of prime factors up to 31
// (mixed and prime radices), Rader's convolution over L - 1 for a prime L.
enum { kPow2 = 0, kMixed = 1, kBluestein = 2, kPrime = 3, kRader = 4 };

// n / d as (n m) >> 31 with m = ceil(2^31 / d): the error
// n (m d - 2^31) / (d 2^31) stays below 1/d, too small to reach the next
// integer, while n (m d - 2^31) < 2^31, so wherever n d <= 2^31 (every
// division here: n < 2^17, d < 2^14; the host checks each range).
struct FastDiv {
  unsigned m;
  static FastDiv of(unsigned d) { return {((1u << 31) + d - 1) / d}; }
  __device__ __forceinline__ int div(int n) const {
    return static_cast<int>(
        (static_cast<unsigned long long>(static_cast<unsigned>(n)) * m) >> 31);
  }
};

// One Stockham stage of the mixed-radix plan, its constants computed on the
// host.
struct Stage {
  int radix;
  int ns;      // product of the earlier stages' radices
  int tw;      // twiddle step 2 half / (radix ns)
  FastDiv mr;  // by len / radix
  FastDiv by_ns;
};
static_assert(sizeof(Stage) == 20, "ops/kernels/stft.py STAGE_TABLE_BYTES");

// What a launch of (A) computes, by value in the kernel's parameters.
struct Geometry {
  int N, T, n_fft, hop, tf, log2tf, vec;
  int L;        // the transform's length: n_fft / 2 (even), n_fft (odd)
  int len;      // the FFT's length: L, L - 1 (Rader) or Bluestein's P
  int log2len;  // when len is a power of two
  int half;     // the twiddle table holds W^0 .. W^half, W = exp(-pi i/half)
  int log2q;    // log2(2 half) when len is a power of two
  int seq;      // sequences a block: tf (even n_fft), ceil(tf / 2) (odd)
  int F;        // n_fft / 2 + 1
  int tiles;    // frame tiles a signal
  int region;   // floats of each work region
  int n_stages;
  FastDiv by_len, by_f;
  Stage stage[kMaxStages];
};

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 conjugate(float2 a) {
  return make_float2(a.x, -a.y);
}

// One 8-byte asynchronous copy, global to shared memory.
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

// W^idx for idx in [0, 2 half) from the table of W^0 .. W^half.
__device__ __forceinline__ float2 twiddle_at(const float2* sW, int idx,
                                             int half) {
  const float2 w = sW[idx <= half ? idx : idx - half];
  return idx <= half ? w : make_float2(-w.x, -w.y);
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

// sin(2 pi / 3); cos and sin of 2 pi / 5 and 4 pi / 5; of 2 pi j / 7 for
// j = 1, 2, 3; sin(pi / 4): float64 rounded to float32.
constexpr float kS3 = 0.8660254037844386f;
constexpr float kC5a = 0.30901699437494745f;
constexpr float kC5b = -0.8090169943749475f;
constexpr float kS5a = 0.9510565162951535f;
constexpr float kS5b = 0.5877852522924731f;
constexpr float kC7a = 0.6234898018587336f;
constexpr float kC7b = -0.22252093395631434f;
constexpr float kC7c = -0.9009688679024191f;
constexpr float kS7a = 0.7818314824680298f;
constexpr float kS7b = 0.9749279121818236f;
constexpr float kS7c = 0.43388373911755823f;
constexpr float kS8 = 0.7071067811865476f;

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

// Radix 7 from the pairs a_j = v_j + v_{7-j}, b_j = v_j - v_{7-j}:
// X_m = c_m - i s_m and X_{7-m} = c_m + i s_m, with
// c_m = v_0 + sum_j cos(2 pi m j / 7) a_j, s_m = sum_j sin(2 pi m j / 7) b_j.
template <>
__device__ __forceinline__ void butterfly<7>(float2 (&v)[7]) {
  const float2 a1 = make_float2(v[1].x + v[6].x, v[1].y + v[6].y);
  const float2 b1 = make_float2(v[1].x - v[6].x, v[1].y - v[6].y);
  const float2 a2 = make_float2(v[2].x + v[5].x, v[2].y + v[5].y);
  const float2 b2 = make_float2(v[2].x - v[5].x, v[2].y - v[5].y);
  const float2 a3 = make_float2(v[3].x + v[4].x, v[3].y + v[4].y);
  const float2 b3 = make_float2(v[3].x - v[4].x, v[3].y - v[4].y);
  const float2 x0 = v[0];
  const float2 c1 = make_float2(x0.x + kC7a * a1.x + kC7b * a2.x + kC7c * a3.x,
                                x0.y + kC7a * a1.y + kC7b * a2.y + kC7c * a3.y);
  const float2 c2 = make_float2(x0.x + kC7b * a1.x + kC7c * a2.x + kC7a * a3.x,
                                x0.y + kC7b * a1.y + kC7c * a2.y + kC7a * a3.y);
  const float2 c3 = make_float2(x0.x + kC7c * a1.x + kC7a * a2.x + kC7b * a3.x,
                                x0.y + kC7c * a1.y + kC7a * a2.y + kC7b * a3.y);
  const float2 s1 = make_float2(kS7a * b1.x + kS7b * b2.x + kS7c * b3.x,
                                kS7a * b1.y + kS7b * b2.y + kS7c * b3.y);
  const float2 s2 = make_float2(kS7b * b1.x - kS7c * b2.x - kS7a * b3.x,
                                kS7b * b1.y - kS7c * b2.y - kS7a * b3.y);
  const float2 s3 = make_float2(kS7c * b1.x - kS7a * b2.x + kS7b * b3.x,
                                kS7c * b1.y - kS7a * b2.y + kS7b * b3.y);
  v[0] = make_float2(x0.x + a1.x + a2.x + a3.x, x0.y + a1.y + a2.y + a3.y);
  v[1] = make_float2(c1.x + s1.y, c1.y - s1.x);  // c - i s
  v[6] = make_float2(c1.x - s1.y, c1.y + s1.x);  // c + i s
  v[2] = make_float2(c2.x + s2.y, c2.y - s2.x);
  v[5] = make_float2(c2.x - s2.y, c2.y + s2.x);
  v[3] = make_float2(c3.x + s3.y, c3.y - s3.x);
  v[4] = make_float2(c3.x - s3.y, c3.y + s3.x);
}

// Radix 8 as two radix-4 DFTs of the even and odd terms, E and O:
// X_m = E_m + W8^m O_m, X_{m+4} = E_m - W8^m O_m, W8 = exp(-pi i / 4).
template <>
__device__ __forceinline__ void butterfly<8>(float2 (&v)[8]) {
  float2 e[4] = {v[0], v[2], v[4], v[6]};
  float2 o[4] = {v[1], v[3], v[5], v[7]};
  butterfly<4>(e);
  butterfly<4>(o);
  const float2 t[4] = {
      o[0],
      make_float2(kS8 * (o[1].x + o[1].y), kS8 * (o[1].y - o[1].x)),
      make_float2(o[2].y, -o[2].x),
      make_float2(kS8 * (o[3].y - o[3].x), -kS8 * (o[3].x + o[3].y))};
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    v[m] = make_float2(e[m].x + t[m].x, e[m].y + t[m].y);
    v[m + 4] = make_float2(e[m].x - t[m].x, e[m].y - t[m].y);
  }
}

// cos and then sin of 2 pi k / p for k = 1 .. (p - 1) / 2, for each direct
// prime radix p = 11, 13, 17, 19, 23, 29, 31 in turn: float64 rounded to
// float32.  Every index is a constant of the unrolled butterfly, so each
// value is an operand of its multiply-add, not a load.
__constant__ float kPrimeTrig[136] = {
    // 11: cos, then sin
    0.8412535328311812f, 0.41541501300188644f, -0.142314838273285f,
    -0.654860733945285f, -0.9594929736144974f,
    0.5406408174555976f, 0.9096319953545183f, 0.9898214418809328f,
    0.7557495743542583f, 0.28173255684142967f,
    // 13: cos, then sin
    0.8854560256532099f, 0.5680647467311559f, 0.120536680255323f,
    -0.35460488704253545f, -0.7485107481711012f, -0.970941817426052f,
    0.4647231720437685f, 0.8229838658936564f, 0.992708874098054f,
    0.9350162426854148f, 0.6631226582407952f, 0.23931566428755768f,
    // 17: cos, then sin
    0.9324722294043558f, 0.7390089172206591f, 0.4457383557765383f,
    0.09226835946330202f, -0.2736629900720829f, -0.6026346363792563f,
    -0.850217135729614f, -0.9829730996839018f,
    0.3612416661871529f, 0.6736956436465572f, 0.8951632913550623f,
    0.9957341762950345f, 0.961825643172819f, 0.7980172272802396f,
    0.5264321628773561f, 0.18374951781657037f,
    // 19: cos, then sin
    0.9458172417006346f, 0.7891405093963936f, 0.5469481581224269f,
    0.24548548714079924f, -0.08257934547233227f, -0.4016954246529694f,
    -0.6772815716257409f, -0.879473751206489f, -0.9863613034027223f,
    0.32469946920468346f, 0.6142127126896678f, 0.8371664782625285f,
    0.9694002659393304f, 0.9965844930066698f, 0.9157733266550574f,
    0.7357239106731318f, 0.4759473930370737f, 0.16459459028073403f,
    // 23: cos, then sin
    0.9629172873477992f, 0.8544194045464886f, 0.6825531432186541f,
    0.4600650377311522f, 0.20345601305263375f, -0.06824241336467088f,
    -0.33487961217098616f, -0.5766803221148671f, -0.7757112907044197f,
    -0.917211301505453f, -0.9906859460363306f,
    0.2697967711570243f, 0.5195839500354336f, 0.730835964278124f,
    0.8878852184023752f, 0.9790840876823229f, 0.9976687691905392f,
    0.9422609221188205f, 0.8169698930104421f, 0.631087944326053f,
    0.3984010898462414f, 0.1361666490962471f,
    // 29: cos, then sin
    0.9766205557100867f, 0.907575419670957f, 0.7960930657056438f,
    0.6473862847818277f, 0.46840844069979015f, 0.26752833852922075f,
    0.05413890858541761f, -0.16178199655276473f, -0.37013815533991423f,
    -0.5611870653623823f, -0.7259954919231306f, -0.8568571761675893f,
    -0.9476531711828025f, -0.9941379571543596f,
    0.21497044021102407f, 0.4198891015602646f, 0.6051742151937652f,
    0.7621620551276365f, 0.8835120444460229f, 0.963549992519223f,
    0.9985334138511238f, 0.9868265225415261f, 0.9289767198167915f,
    0.8276889981568906f, 0.6876994588534235f, 0.5155538571770216f,
    0.3193015301359798f, 0.10811901842394192f,
    // 31: cos, then sin
    0.9795299412524945f, 0.9189578116202306f, 0.8207634412072763f,
    0.6889669190756866f, 0.5289640103269624f, 0.3473052528448203f,
    0.1514277775045767f, -0.05064916883871264f, -0.2506525322587204f,
    -0.4403941515576344f, -0.6121059825476626f, -0.7587581226927909f,
    -0.8743466161445821f, -0.9541392564000488f, -0.994869323391895f,
    0.20129852008866006f, 0.39435585511331855f, 0.5712682150947923f,
    0.7247927872291199f, 0.8486442574947509f, 0.9377521321470804f,
    0.9884683243281114f, 0.9987165071710528f, 0.9680771188662043f,
    0.8978045395707416f, 0.7907757369376989f, 0.6513724827222223f,
    0.48530196253108104f, 0.29936312297335804f, 0.10116832198743272f,
};

// Where radix R's values start in kPrimeTrig.
__host__ __device__ constexpr int trig_offset(int R) {
  int at = 0;
  for (int p = 11; p <= kMaxPrime; p += 2) {
    const bool prime = p % 3 && p % 5 && p % 7;
    if (prime && p == R) return at;
    if (prime) at += p - 1;
  }
  return -1;
}

// One butterfly of a Stockham stage of a prime radix R (11 .. 31): reads
// fin[r mr] times W^(r t), as `radix_step` does, and writes the R-point DFT
// to fout[r ns] from the pairs a_j = v_j + v_(R-j), b_j = v_j - v_(R-j),
// j = 1 .. H = (R - 1) / 2: X_0 = v_0 + sum_j a_j; X_m = c_m - i s_m and
// X_(R-m) = c_m + i s_m, with c_m = v_0 + sum_j cos(2 pi m j / R) a_j and
// s_m = sum_j sin(2 pi m j / R) b_j.  The pairs form as the inputs arrive
// and each pair of outputs is stored once summed: 2H complex values live.
template <int R>
__device__ __forceinline__ void prime_step(const float2* fin, float2* fout,
                                           const float2* sW, int mr, int ns,
                                           int t, int half) {
  constexpr int H = (R - 1) / 2, kC = trig_offset(R), kS = kC + H;
  static_assert(kC >= 0 && R <= kMaxPrime, "a direct prime radix");
  const float2 x0 = fin[0];
  float2 a[H], b[H];
#pragma unroll
  for (int j = 1; j <= H; ++j) {
    const float2 u = cmul(fin[j * mr], twiddle_at(sW, j * t, half));
    const float2 w = cmul(fin[(R - j) * mr], twiddle_at(sW, (R - j) * t, half));
    a[j - 1] = make_float2(u.x + w.x, u.y + w.y);
    b[j - 1] = make_float2(u.x - w.x, u.y - w.y);
  }
  float2 sum = x0;
#pragma unroll
  for (int j = 0; j < H; ++j)
    sum = make_float2(sum.x + a[j].x, sum.y + a[j].y);
  fout[0] = sum;
#pragma unroll
  for (int m = 1; m <= H; ++m) {
    float2 c = x0, d = make_float2(0.f, 0.f);
#pragma unroll
    for (int j = 1; j <= H; ++j) {
      // cos is even and sin odd in e = m j mod R about R / 2.
      const int e = (m * j) % R;
      const float cv = kPrimeTrig[kC + (e <= H ? e : R - e) - 1];
      const float sv = e <= H ? kPrimeTrig[kS + e - 1]
                              : -kPrimeTrig[kS + R - e - 1];
      c = make_float2(c.x + cv * a[j - 1].x, c.y + cv * a[j - 1].y);
      d = make_float2(d.x + sv * b[j - 1].x, d.y + sv * b[j - 1].y);
    }
    fout[m * ns] = make_float2(c.x + d.y, c.y - d.x);        // c - i s
    fout[(R - m) * ns] = make_float2(c.x - d.y, c.y + d.x);  // c + i s
  }
}

// One butterfly of a Stockham stage of radix R: reads fin[r mr]
// (mr = len/R), multiplies by W^{r t} (W = exp(-pi i / half), r t <
// 2 half), takes the R-point DFT and writes fout[r ns].
template <int R>
__device__ __forceinline__ void radix_step(const float2* fin, float2* fout,
                                           const float2* sW, int mr, int ns,
                                           int t, int half) {
  float2 v[R];
  v[0] = fin[0];
#pragma unroll
  for (int r = 1; r < R; ++r)
    v[r] = cmul(fin[r * mr], twiddle_at(sW, r * t, half));
  butterfly<R>(v);
#pragma unroll
  for (int r = 0; r < R; ++r) fout[r * ns] = v[r];
}

// One Stockham stage of radix R over `seq` sequences of `len` points,
// after stages whose radices multiply to ns: butterfly j of a sequence
// (k = j mod ns) reads z[j + r len/R] and writes (j - k) R + k + r ns.  A
// stage of the mixed-radix plan divides by its host-computed constants.
template <int R, int NT>
__device__ __forceinline__ void stage(const float2* in, float2* out,
                                      const float2* sW, int len, int half,
                                      const Stage st, int seq, int tid) {
  const int mr = len / R, ns = st.ns;
  for (int i = tid; i < seq * mr; i += NT) {
    const int f = st.mr.div(i), j = i - f * mr;
    const int q = st.by_ns.div(j), k = j - q * ns;
    if constexpr (R > 8)
      prime_step<R>(in + f * len + j, out + f * len + q * ns * R + k, sW, mr,
                    ns, k * st.tw, half);
    else
      radix_step<R>(in + f * len + j, out + f * len + q * ns * R + k, sW,
                    mr, ns, k * st.tw, half);
  }
}

// A stage of a direct prime radix (kPrime's plans).
template <int NT>
__device__ __forceinline__ void prime_stage(const float2* in, float2* out,
                                            const float2* sW, int len,
                                            int half, const Stage st,
                                            int seq, int tid) {
  switch (st.radix) {
    case 11: stage<11, NT>(in, out, sW, len, half, st, seq, tid); break;
    case 13: stage<13, NT>(in, out, sW, len, half, st, seq, tid); break;
    case 17: stage<17, NT>(in, out, sW, len, half, st, seq, tid); break;
    case 19: stage<19, NT>(in, out, sW, len, half, st, seq, tid); break;
    case 23: stage<23, NT>(in, out, sW, len, half, st, seq, tid); break;
    case 29: stage<29, NT>(in, out, sW, len, half, st, seq, tid); break;
    default: stage<31, NT>(in, out, sW, len, half, st, seq, tid); break;
  }
}

// The same stage for a power-of-two length (R = 2, 4 or 8, len = 2^log2len,
// ns = 2^log2ns, the table of order 2 half = 2^log2q), indexed by shifts
// and masks (the divisions cost 8% at the scaled device batch on an H100).
template <int R, int NT>
__device__ __forceinline__ void stage_pow2(const float2* in, float2* out,
                                           const float2* sW, int log2len,
                                           int log2q, int half, int log2ns,
                                           int seq, int tid) {
  constexpr int kLog2R = R == 8 ? 3 : R == 4 ? 2 : 1;
  const int log2mr = log2len - kLog2R, ns = 1 << log2ns;
  for (int i = tid; i < (seq << log2mr); i += NT) {
    const int f = i >> log2mr, j = i & ((1 << log2mr) - 1);
    const int k = j & (ns - 1);
    radix_step<R>(in + (f << log2len) + j,
                  out + (f << log2len) + ((j - k) << kLog2R) + k, sW,
                  1 << log2mr, ns, k << (log2q - kLog2R - log2ns), half);
  }
}

// The FFT of every sequence, `in` -> `out` -> `in` ..., one stage a radix;
// on return `in` holds the transform.
template <int KIND, int NT>
__device__ __forceinline__ void fft(float2*& in, float2*& out,
                                    const float2* sW, const Stage* sStage,
                                    int n_stages, int len, int log2len,
                                    int log2q, int half, int seq, int tid) {
  // Bluestein's P is 7-smooth, at times a power of two: then its stages
  // are kPow2's (a branch uniform over the launch).
  const bool shifts = KIND == kPow2 || (KIND == kBluestein && log2len >= 0);
  for (int s = 0, log2ns = 0; s < n_stages; ++s) {
    if (shifts) {
      const int first = log2ns == 0 ? log2len % 3 : 0;
      if (first == 1) {
        stage_pow2<2, NT>(in, out, sW, log2len, log2q, half, log2ns, seq,
                          tid);
        log2ns += 1;
      } else if (first == 2) {
        stage_pow2<4, NT>(in, out, sW, log2len, log2q, half, log2ns, seq,
                          tid);
        log2ns += 2;
      } else {
        stage_pow2<8, NT>(in, out, sW, log2len, log2q, half, log2ns, seq,
                          tid);
        log2ns += 3;
      }
    } else {
      // By value, so in registers: the stage's stores to shared memory
      // cannot alias it.
      const Stage st = sStage[s];
      if (st.radix == 4)
        stage<4, NT>(in, out, sW, len, half, st, seq, tid);
      else if (st.radix == 2)
        stage<2, NT>(in, out, sW, len, half, st, seq, tid);
      else if (st.radix == 3)
        stage<3, NT>(in, out, sW, len, half, st, seq, tid);
      else if (st.radix == 5)
        stage<5, NT>(in, out, sW, len, half, st, seq, tid);
      else if (KIND == kMixed || st.radix == 7)
        stage<7, NT>(in, out, sW, len, half, st, seq, tid);
      else if (KIND != kPrime || st.radix == 8)
        stage<8, NT>(in, out, sW, len, half, st, seq, tid);
      else
        prime_stage<NT>(in, out, sW, len, half, st, seq, tid);
    }
    __syncthreads();
    float2* tmp = in;
    in = out;
    out = tmp;
  }
}

// Z[k] of a sequence's transform: the FFT's output itself, or under
// Bluestein c*[k] conj(V[k]) (chirp[k] = c*[k]).
template <bool BLUE>
__device__ __forceinline__ float2 z_at(const float2* zf, int k,
                                       const float2* __restrict__ chirp) {
  const float2 v = zf[k];
  return BLUE ? cmul(__ldg(chirp + k), conjugate(v)) : v;
}

// |X[k]| of the split step from Z[k] and Z[M-k], w = exp(-2 pi i k/n_fft).
__device__ __forceinline__ float split_mag(float2 zk, float2 zm, float2 w) {
  const float ar = zk.x + zm.x, ai = zk.y - zm.y;  // Z[k] + Z*[M-k]
  const float br = zk.x - zm.x, bi = zk.y + zm.y;  // Z[k] - Z*[M-k]
  const float wbr = w.x * br - w.y * bi, wbi = w.x * bi + w.y * br;
  const float xr = 0.5f * (ar + wbi), xi = 0.5f * (ai - wbr);
  return sqrtf(xr * xr + xi * xi);
}

// The magnitudes of bin k of a sequence's transform zf: the split step's
// |X[k]| (even n_fft; .y unused), or the two frames' |X1[k]|, |X2[k]|
// (odd).  sSplit holds exp(-2 pi i k / n_fft).
template <bool BLUE, bool ODD>
__device__ __forceinline__ float2 bin_mags(const float2* zf, int k, int L,
                                           const float2* sSplit,
                                           const float2* __restrict__ chirp) {
  if (!ODD) {
    const float2 zk = z_at<BLUE>(zf, k == L ? 0 : k, chirp);
    const float2 zm = z_at<BLUE>(zf, k == 0 ? 0 : L - k, chirp);
    return make_float2(split_mag(zk, zm, sSplit[k]), 0.f);
  }
  const float2 a = z_at<BLUE>(zf, k, chirp);
  const float2 c = z_at<BLUE>(zf, k == 0 ? 0 : L - k, chirp);
  const float pr = a.x + c.x, pi = a.y - c.y;  // Z[k] + Z*[L-k]
  const float qr = a.x - c.x, qi = a.y + c.y;  // Z[k] - Z*[L-k]
  return make_float2(0.5f * sqrtf(pr * pr + pi * pi),
                     0.5f * sqrtf(qr * qr + qi * qi));
}

// The magnitudes of bin k under Rader, as `bin_mags` reads them: X[j] =
// z[0] + conj(V[p(j)]) from the second FFT's output zf (bins[j] = p(j)),
// and X[0] = z[0] + A[0].
template <bool ODD>
__device__ __forceinline__ float2 rader_mags(const float2* zf, int k, int L,
                                             const float2* sSplit,
                                             const int* __restrict__ bins,
                                             float2 z0, float2 x0) {
  const auto X = [=](int j) {
    if (j == 0) return x0;
    const float2 v = zf[__ldg(bins + j)];
    return make_float2(z0.x + v.x, z0.y - v.y);
  };
  if (!ODD)
    return make_float2(
        split_mag(X(k == L ? 0 : k), X(k == 0 ? 0 : L - k), sSplit[k]), 0.f);
  const float2 a = X(k), c = X(k == 0 ? 0 : L - k);
  const float pr = a.x + c.x, pi = a.y - c.y;  // X[k] + X*[L-k]
  const float qr = a.x - c.x, qi = a.y + c.y;  // X[k] - X*[L-k]
  return make_float2(0.5f * sqrtf(pr * pr + pi * pi),
                     0.5f * sqrtf(qr * qr + qi * qi));
}

// Floats of each of the two work regions of (A): the staged span (up to
// n_fft 4096), the FFT's ping-pong buffer (seq sequences of len complex)
// and the (bin, frame) stage all fit; rounded up to 4 floats so the next
// region stays 16-byte aligned.
inline int region_floats(int n_fft, int hop, int tf, int seq, int len) {
  const int f = n_fft / 2 + 1;
  long long r = 2LL * seq * len;
  const long long span = (long long)(tf - 1) * hop + n_fft;
  if (n_fft <= kStagedMax && span > r) r = span;
  if ((long long)f * (tf + 1) > r) r = (long long)f * (tf + 1);
  r = (r + 3) & ~3LL;
  return r > kMaxSmem ? kMaxSmem : static_cast<int>(r);
}

// ODD: n_fft is odd (two frames a sequence).  KIND: kPow2 (stages by
// shifts), kMixed, kPrime, kRader or kBluestein (stages by FastDiv, by
// shifts at a power-of-two P; kPrime and kRader up to n_fft 4096).  WIDE:
// n_fft above 4096 (512 threads, nothing staged).  perm: Rader's gather
// g^q (M ints), then p(k) for the L bins.
// Three blocks an SM for the even prime instance: at its own choice ptxas
// takes 128 registers for radix 29 and 31 (two blocks), and the 80 that
// three allow hold them without a spill (at four, 64, they spill; the odd
// instance spills at 80, so it keeps its 128).  0: no minimum, ptxas's own
// choice (40 and 48 registers for the kPow2 and kMixed instances, the same
// as with no second bound).
__host__ __device__ constexpr int min_blocks(int kind, bool odd) {
  return kind == kPrime && !odd ? 3 : 0;
}

template <int KIND, bool ODD, bool WIDE>
__global__ void __launch_bounds__(WIDE ? kWideThreads : kThreads,
                                  min_blocks(KIND, ODD))
    stft_fft_kernel(const float* __restrict__ audio,
                    const float* __restrict__ window,
                    const float2* __restrict__ twiddle,
                    const float2* __restrict__ split,
                    const float2* __restrict__ chirp,
                    const float2* __restrict__ chirp_fft,
                    float* __restrict__ mag, const Geometry g,
                    const int* __restrict__ perm) {
  constexpr int NT = WIDE ? kWideThreads : kThreads;
  constexpr bool kBlue = KIND == kBluestein;
  constexpr bool kRad = KIND == kRader;
  constexpr bool kShifts = KIND == kPow2;
  constexpr bool kOwnSplit = (kBlue || kRad) && !ODD;  // else the split is sW
  extern __shared__ float4 smem4[];
  const int n_fft = g.n_fft, hop = g.hop, tf = g.tf, F = g.F;
  float* regA = reinterpret_cast<float*>(smem4);
  float* regB = regA + g.region;
  float2* sW = reinterpret_cast<float2*>(regB + g.region);  // half + 1
  float2* sSplit = kOwnSplit ? sW + g.half + 1 : sW;        // F (even)
  // Rader: z[0] of each sequence, then X[0] (2 seq values).
  float2* sDc = kOwnSplit ? sSplit + F : sW + g.half + 1;
  float* sWin = reinterpret_cast<float*>(kRad ? sDc + 2 * g.seq : sDc);

  const int tid = threadIdx.x;
  const int b = blockIdx.x / g.tiles;
  const int t0 = (blockIdx.x - b * g.tiles) * tf;
  const long long g0 = (long long)t0 * hop;
  const float* src = audio + (size_t)b * g.N;

  // Stage the span [g0, g0 + span) into region B, zero past N (not above
  // 4096: WIDE, whose tables come by cp.async while the pack reads).
  const int span = (tf - 1) * hop + n_fft;
  float* sSpan = regB;
  if (!WIDE) {
    int scalar_from = 0;
    if (g.vec) {
      // g0 and N are multiples of 4: a chunk is all in or all out.
      const int chunks = span >> 2;
      for (int c = tid; c < chunks; c += NT) {
        const long long at = g0 + 4 * c;
        const bool ok = at < g.N;
        cp_async16(sSpan + 4 * c, ok ? src + at : src, ok ? 16 : 0);
      }
      scalar_from = chunks << 2;
    }
    for (int i = scalar_from + tid; i < span; i += NT) {
      const long long at = g0 + i;
      const bool ok = at < g.N;
      cp_async4(sSpan + i, ok ? src + at : src, ok ? 4 : 0);
    }
  }
  if (WIDE) {
    for (int i = tid; i <= g.half; i += NT) cp_async8(sW + i, twiddle + i);
    if (kOwnSplit)
      for (int i = tid; i < F; i += NT) cp_async8(sSplit + i, split + i);
    cp_async_commit();
  } else {
    for (int i = tid; i <= g.half; i += NT) sW[i] = twiddle[i];
    if (kOwnSplit)
      for (int i = tid; i < F; i += NT) sSplit[i] = split[i];
    for (int i = tid; i < n_fft; i += NT) sWin[i] = window[i];
  }
  // The plan's stages into shared memory, each by its own thread (static
  // indices keep the kernel parameter out of local memory).
  __shared__ Stage sStage[kMaxStages];
  if (KIND != kPow2) {
#pragma unroll
    for (int s = 0; s < kMaxStages; ++s)
      if (tid == s) sStage[s] = g.stage[s];
  }
  if (!WIDE) {
    cp_async_commit();
    cp_async_wait<0>();
  }
  __syncthreads();

  // Window and pack into region A: seq sequences of len points (under
  // Bluestein times the chirp c*[n], zero from L to P; under Rader the
  // gather z[g^q], and z[0] of each sequence apart).
  {
    float2* z = reinterpret_cast<float2*>(regA);
    const int L = g.L, len = g.len;
    if (kRad) {
      const bool pairs = !ODD && (hop & 1) == 0;  // as below
      const auto packed = [=](int s, int n) {
        float2 v = make_float2(0.f, 0.f);
        if (!ODD) {
          const float* x = sSpan + s * hop + 2 * n;
          const float2 w = reinterpret_cast<const float2*>(sWin)[n];
          const float2 xv = pairs ? *reinterpret_cast<const float2*>(x)
                                  : make_float2(x[0], x[1]);
          v = make_float2(xv.x * w.x, xv.y * w.y);
        } else {
          const float w = sWin[n];
          const int f = 2 * s;
          v.x = sSpan[f * hop + n] * w;
          if (f + 1 < tf) v.y = sSpan[(f + 1) * hop + n] * w;
        }
        return v;
      };
      for (int i = tid; i < g.seq * len; i += NT) {
        const int s = g.by_len.div(i);
        z[i] = packed(s, __ldg(perm + (i - s * len)));
      }
      for (int s = tid; s < g.seq; s += NT) sDc[s] = packed(s, 0);
    } else if (WIDE) {
      // Each sample and window value read once from global memory, zero
      // past N.
      const int N = g.N;
      const auto sample = [=](int i) {
        const long long at = g0 + i;
        return at < N ? __ldg(src + at) : 0.f;
      };
      for (int i = tid; i < g.seq * len; i += NT) {
        const int s = kShifts ? i >> g.log2len : g.by_len.div(i);
        const int n = i - s * len;
        float2 v = make_float2(0.f, 0.f);
        if (!kBlue || n < L) {
          if (!ODD) {
            const int at = s * hop + 2 * n;
            v = make_float2(sample(at) * __ldg(window + 2 * n),
                            sample(at + 1) * __ldg(window + 2 * n + 1));
          } else {
            const float w = __ldg(window + n);
            const int f = 2 * s;
            v.x = sample(f * hop + n) * w;
            if (f + 1 < tf) v.y = sample((f + 1) * hop + n) * w;
          }
          if (kBlue) v = cmul(v, __ldg(chirp + n));
        }
        z[i] = v;
      }
    } else {
      const bool pairs = !ODD && (hop & 1) == 0;  // float2 reads of (x0, x1)
      for (int i = tid; i < g.seq * len; i += NT) {
        const int s = kShifts ? i >> g.log2len : g.by_len.div(i);
        const int n = i - s * len;
        float2 v = make_float2(0.f, 0.f);
        if (!kBlue || n < L) {
          if (!ODD) {
            const float* x = sSpan + s * hop + 2 * n;
            const float2 w = reinterpret_cast<const float2*>(sWin)[n];
            const float2 xv =
                pairs ? *reinterpret_cast<const float2*>(x)
                      : make_float2(x[0], x[1]);
            v = make_float2(xv.x * w.x, xv.y * w.y);
          } else {
            const float w = sWin[n];
            const int f = 2 * s;
            v.x = sSpan[f * hop + n] * w;
            if (f + 1 < tf) v.y = sSpan[(f + 1) * hop + n] * w;
          }
          if (kBlue) v = cmul(v, __ldg(chirp + n));
        }
        z[i] = v;
      }
    }
  }
  if (WIDE) cp_async_wait<0>();
  __syncthreads();

  float2* in = reinterpret_cast<float2*>(regA);
  float2* out = reinterpret_cast<float2*>(regB);
  // The FFT; under Bluestein and Rader twice, around the product with the
  // host's table.  A loop, not two calls: one copy of the stages' code
  // (on an H100 build Rader's instances take 40 and 44 registers, not 56
  // and 48, Bluestein's 40, not 44; 1-2% less time).
#pragma unroll 1
  for (int pass = 0;; ++pass) {
    fft<KIND, NT>(in, out, sW, sStage, g.n_stages, g.len, g.log2len,
                  g.log2q, g.half, g.seq, tid);
    if (!(kBlue || kRad) || pass == 1) break;
    // conj(V * chirp_fft): the second FFT then gives the conjugated
    // inverse transform.  Rader keeps X[0] = z[0] + A[0] first.
    for (int i = tid; i < g.seq * g.len; i += NT) {
      const int s = g.by_len.div(i), q = i - s * g.len;
      const float2 a = in[i];
      if (kRad && q == 0)
        sDc[g.seq + s] = make_float2(sDc[s].x + a.x, sDc[s].y + a.y);
      in[i] = conjugate(cmul(a, __ldg(chirp_fft + q)));
    }
    __syncthreads();
  }

  // The F bins of each frame and their magnitudes; k runs fastest, so the
  // stage writes at stride tf + 1 hit distinct banks.
  const float2* Z = in;
  float* sMag = reinterpret_cast<float*>(out);
  const int ms = tf + 1;
  const auto put = [=](int s, int k, float2 m) {
    if (!ODD) {
      sMag[k * ms + s] = m.x;
    } else {
      sMag[k * ms + 2 * s] = m.x;
      if (2 * s + 1 < tf) sMag[k * ms + 2 * s + 1] = m.y;
    }
  };
  for (int i = tid; i < g.seq * F; i += NT) {
    const int s = g.by_f.div(i), k = i - s * F;
    if (kRad)
      put(s, k, rader_mags<ODD>(Z + s * g.len, k, g.L, sSplit, perm + g.len,
                                sDc[s], sDc[g.seq + s]));
    else
      put(s, k, bin_mags<kBlue, ODD>(Z + s * g.len, k, g.L, sSplit, chirp));
  }
  __syncthreads();

  // Store: consecutive threads take consecutive frames of one bin.
  float* dst = mag + (size_t)b * F * g.T;
  for (int i = tid; i < (F << g.log2tf); i += NT) {
    const int k = i >> g.log2tf, f = i & (tf - 1);
    const int t = t0 + f;
    if (t < g.T) dst[(size_t)k * g.T + t] = sMag[k * ms + f];
  }
}

// ---------------------------------------------------------------------------
// (B) The four-step FFT: one launch a pass over a chunk of sequences.
// ---------------------------------------------------------------------------

enum { kColumns = 0, kRowsLast = 1, kRowsMiddle = 2, kColumnsLast = 3 };

// What one launch of a pass of (B) computes, by value in its parameters.
struct FourStep {
  int N, T, n_fft, hop;
  int L;          // the transform's length
  int P;          // the FFT's length: L, or Bluestein's pad
  int n1, n2;     // P = n1 n2: columns of n1 points, rows of n2
  int F;
  int S;          // sequences a signal: T (even n_fft), ceil(T / 2) (odd)
  int odd, blue;
  long long seq0;  // the launch's first sequence of the B S
  int groups;      // blocks a sequence
  int width;       // columns (kColumns: a power of two), rows, or pairs
  int log2width;
  int reps;        // the last pass: representatives of the pairs
  int a, q;        // the last pass: L = q A + a, A = n1 (rows), n2 (columns)
  int region;      // float2 of each work region
  // The pass's FFT of `len` points (n1 or n2), its table of order 2 len.
  int len, log2len, log2q, n_stages, pow2;
  Stage stage[kMaxStages];
};

// W_P^m = exp(-2 pi i m / P) for m in [0, P), P < 2^24.
__device__ __forceinline__ float2 unit_root(int m, int P) {
  float s, c;
  sincospif(2.0f * static_cast<float>(m) / static_cast<float>(P), &s, &c);
  return make_float2(c, -s);
}

// The row passes' FFT: sequences of len points, one after another.
__device__ __forceinline__ void pass_fft(const FourStep& g, float2*& in,
                                         float2*& out, const float2* sW,
                                         const Stage* sStage, int seq,
                                         int tid) {
  if (g.pow2)
    fft<kPow2, kThreads>(in, out, sW, sStage, g.n_stages, g.len, g.log2len,
                         g.log2q, g.len, seq, tid);
  else
    fft<kMixed, kThreads>(in, out, sW, sStage, g.n_stages, g.len,
                          g.log2len, g.log2q, g.len, seq, tid);
}

// One Stockham stage of radix R over 2^log2seq sequences laid out column
// by column (point j of sequence f at j 2^log2seq + f): a warp's threads
// take consecutive sequences at one butterfly, so they touch consecutive
// words and share one twiddle.
template <int R>
__device__ __forceinline__ void stage_cols(const float2* in, float2* out,
                                           const float2* sW, int len,
                                           int half, const Stage st,
                                           int log2seq, int tid) {
  const int mr = len / R, ns = st.ns, seq = 1 << log2seq;
  for (int i = tid; i < (mr << log2seq); i += kThreads) {
    const int f = i & (seq - 1), j = i >> log2seq;
    const int q = st.by_ns.div(j), k = j - q * ns;
    radix_step<R>(in + (j << log2seq) + f,
                  out + ((q * ns * R + k) << log2seq) + f, sW, mr << log2seq,
                  ns << log2seq, k * st.tw, half);
  }
}

// The column passes' FFT of len points (table of order 2 len) over
// 2^log2seq sequences in that layout; on return `in` holds the transform.
__device__ __forceinline__ void fft_cols(float2*& in, float2*& out,
                                         const float2* sW,
                                         const Stage* sStage, int n_stages,
                                         int len, int log2seq, int tid) {
  for (int s = 0; s < n_stages; ++s) {
    const Stage st = sStage[s];
    if (st.radix == 8)
      stage_cols<8>(in, out, sW, len, len, st, log2seq, tid);
    else if (st.radix == 4)
      stage_cols<4>(in, out, sW, len, len, st, log2seq, tid);
    else if (st.radix == 2)
      stage_cols<2>(in, out, sW, len, len, st, log2seq, tid);
    else if (st.radix == 3)
      stage_cols<3>(in, out, sW, len, len, st, log2seq, tid);
    else if (st.radix == 5)
      stage_cols<5>(in, out, sW, len, len, st, log2seq, tid);
    else
      stage_cols<7>(in, out, sW, len, len, st, log2seq, tid);
    __syncthreads();
    float2* tmp = in;
    in = out;
    out = tmp;
  }
}

// The axis index (row or column) of the last pass's sequence `sl`: the
// representative of pair sl / 2, or (odd sl) its partner (a - x) mod A.
__device__ __forceinline__ int axis_of(int a, int A, int u0, int sl) {
  const int u = u0 + (sl >> 1), h0 = a / 2 + 1;
  const int x = u < h0 ? u : a + 1 + (u - h0);
  if (!(sl & 1)) return x;
  const int y = a - x;
  return y < 0 ? y + A : y;
}

template <int PASS>
__global__ void __launch_bounds__(kThreads) stft_4step_kernel(
    const float* __restrict__ audio, const float* __restrict__ window,
    const float2* __restrict__ twiddle, const float2* __restrict__ split,
    const float2* __restrict__ chirp, const float2* __restrict__ chirp_fft,
    float2* __restrict__ scratch, float* __restrict__ mag,
    const FourStep g) {
  constexpr int NT = kThreads;
  extern __shared__ float4 smem4[];
  float2* regA = reinterpret_cast<float2*>(smem4);
  float2* regB = regA + g.region;
  float2* sW = regB + g.region;  // len + 1 values of order 2 len
  __shared__ Stage sStage[kMaxStages];

  const int tid = threadIdx.x;
  const int local = blockIdx.x / g.groups;
  const int grp = blockIdx.x - local * g.groups;
  const long long gs = g.seq0 + local;
  const int b = static_cast<int>(gs / g.S);
  const int s = static_cast<int>(gs - (long long)b * g.S);
  float2* seq_scratch = scratch + (size_t)local * g.P;
  const int n1 = g.n1, n2 = g.n2;

  for (int i = tid; i <= g.len; i += NT) cp_async8(sW + i, twiddle + i);
  cp_async_commit();
#pragma unroll
  for (int st = 0; st < kMaxStages; ++st)
    if (tid == st) sStage[st] = g.stage[st];

  float2* in = regA;
  float2* out = regB;
  if (PASS == kColumns) {
    // The block's C columns (a power of two) row by row, point a of
    // column c at [a][c]: consecutive columns, coalesced.
    const int C = g.width, lc = g.log2width;
    const int c0 = grp * C;
    const float* src = audio + (size_t)b * g.N;
    const long long t0 = g.odd ? 2LL * s : s;
    const long long base = t0 * g.hop;
    const bool second = g.odd && t0 + 1 < g.T;
    for (int i = tid; i < n1 * C; i += NT) {
      const int c = i & (C - 1), r = i >> lc, col = c0 + c;
      const int n = r * n2 + col;
      float2 v = make_float2(0.f, 0.f);
      if (col < n2 && n < g.L) {
        if (!g.odd) {
          const long long at = base + 2LL * n;
          const float2 w = __ldg(reinterpret_cast<const float2*>(window) + n);
          v = make_float2(at < g.N ? __ldg(src + at) * w.x : 0.f,
                          at + 1 < g.N ? __ldg(src + at + 1) * w.y : 0.f);
        } else {
          const float w = __ldg(window + n);
          const long long at = base + n, at2 = at + g.hop;
          v.x = at < g.N ? __ldg(src + at) * w : 0.f;
          if (second && at2 < g.N) v.y = __ldg(src + at2) * w;
        }
        if (g.blue) v = cmul(v, __ldg(chirp + n));
      }
      regA[i] = v;
    }
    cp_async_wait<0>();
    __syncthreads();
    fft_cols(in, out, sW, sStage, g.n_stages, n1, lc, tid);
    // Times W_P^(col k1), written row by row as [k1][col].
    for (int i = tid; i < n1 * C; i += NT) {
      const int c = i & (C - 1), k1 = i >> lc, col = c0 + c;
      if (col < n2)
        seq_scratch[(size_t)k1 * n2 + col] =
            cmul(in[i], unit_root(col * k1, g.P));
    }
    return;
  }

  if (PASS == kRowsMiddle) {
    const int r0 = grp * g.width;
    const int rows = min(g.width, n1 - r0);
    float2* rows_at = seq_scratch + (size_t)r0 * n2;
    const float2* cf = chirp_fft + (size_t)r0 * n2;  // [k1][k2]
    for (int i = tid; i < rows * n2; i += NT) regA[i] = rows_at[i];
    cp_async_wait<0>();
    __syncthreads();
    pass_fft(g, in, out, sW, sStage, rows, tid);
    for (int i = tid; i < rows * n2; i += NT)
      in[i] = conjugate(cmul(in[i], __ldg(cf + i)));
    __syncthreads();
    pass_fft(g, in, out, sW, sStage, rows, tid);
    for (int i = tid; i < rows * n2; i += NT) {
      const int r = i / n2, m2 = i - r * n2;
      rows_at[i] = cmul(in[i], unit_root((r0 + r) * m2, g.P));
    }
    return;
  }

  // The last pass: `width` pairs of rows (kRowsLast: sequences one after
  // another) or of columns (kColumnsLast: 2 width sequences, a power of
  // two, column by column), each of Q points along the other axis.
  constexpr bool kRows = PASS == kRowsLast;
  const int A = kRows ? n1 : n2, Q = kRows ? n2 : n1;
  const int u0 = grp * g.width;
  const int nseq = 2 * min(g.width, g.reps - u0);
  const int a = g.a, log2slots = g.log2width + 1;
  if (kRows) {
    for (int i = tid; i < nseq * Q; i += NT) {
      const int sl = i / Q, p = i - sl * Q;
      regA[i] = seq_scratch[(size_t)axis_of(a, A, u0, sl) * n2 + p];
    }
  } else {
    for (int i = tid; i < (n1 << log2slots); i += NT) {
      const int sl = i & ((1 << log2slots) - 1), p = i >> log2slots;
      regA[i] = sl < nseq
                    ? seq_scratch[(size_t)p * n2 + axis_of(a, A, u0, sl)]
                    : make_float2(0.f, 0.f);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  if (kRows)
    pass_fft(g, in, out, sW, sStage, nseq, tid);
  else
    fft_cols(in, out, sW, sStage, g.n_stages, n1, log2slots, tid);

  // Z[j] at (x, p), j = x + A p; its partner Z[L - j] at ((a - x) mod A,
  // q - p - [x > a]) in the pair's other sequence; Z[0] is its own.  Bins
  // j < L (even n_fft, and bin L from Z[0]) or j < F (odd: two frames).
  const auto at = [=](int sl, int p) {
    return kRows ? sl * Q + p : (p << log2slots) + sl;
  };
  const int jmax = g.odd ? g.F : g.L;
  float* dst = mag + (size_t)b * g.F * g.T;
  for (int i = tid; i < nseq * Q; i += NT) {
    const int sl = kRows ? i / Q : i % nseq;
    const int p = kRows ? i - sl * Q : i / nseq;
    const int x = axis_of(a, A, u0, sl);
    if ((sl & 1) && x == axis_of(a, A, u0, sl ^ 1)) continue;  // once
    const int j = x + A * p;
    if (j >= jmax) continue;
    float2 zk = in[at(sl, p)], zm = zk;
    int jm = 0;
    if (j > 0) {
      const int pm = g.q - p - (x > a ? 1 : 0);
      zm = in[at(sl ^ 1, pm)];
      jm = g.L - j;
    }
    if (g.blue) {
      zk = cmul(__ldg(chirp + j), conjugate(zk));
      zm = cmul(__ldg(chirp + jm), conjugate(zm));
    }
    if (!g.odd) {
      dst[(size_t)j * g.T + s] = split_mag(zk, zm, __ldg(split + j));
      if (j == 0)
        dst[(size_t)g.L * g.T + s] = split_mag(zk, zk, __ldg(split + g.L));
    } else {
      const float pr = zk.x + zm.x, pi = zk.y - zm.y;  // Z[k] + Z*[L-k]
      const float qr = zk.x - zm.x, qi = zk.y + zm.y;  // Z[k] - Z*[L-k]
      dst[(size_t)j * g.T + 2 * s] = 0.5f * sqrtf(pr * pr + pi * pi);
      if (2 * s + 1 < g.T)
        dst[(size_t)j * g.T + 2 * s + 1] = 0.5f * sqrtf(qr * qr + qi * qi);
    }
  }
}

int log2_exact(int n) {  // log2(n) for a power of two n >= 1, else -1
  if (n < 1 || (n & (n - 1)) != 0) return -1;
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
}

// FastDiv by d exact over [0, top] (the bound in FastDiv's note).
bool exact(unsigned d, long long top) {
  if (d < 1) return false;
  const unsigned long long m = ((1ull << 31) + d - 1) / d;
  return top * (long long)(m * d - (1ull << 31)) < (1ll << 31);
}

bool is_prime(int n) {
  if (n < 2) return false;
  for (int d = 2; d * d <= n; ++d)
    if (n % d == 0) return false;
  return true;
}

// The stages of an FFT of `len` points (table of order 2 half) over `seq`
// sequences from the host's radices: false unless they multiply to len in
// the order the kernels run them (kPow2 and kBluestein at a power of two:
// one 2 or one 4 for log2(len) mod 3, then 8s; kMixed: radices 2, 3, 4, 5
// and 7; kRader and kBluestein: also 8; kPrime: also the primes 11 to 31)
// and every division of a FastDiv stage is exact.
bool plan_stages(Stage* out, int len, int half, const int* radices,
                 int n_stages, int seq, int kind) {
  if (n_stages < 0 || n_stages > kMaxStages) return false;
  const int log2len = log2_exact(len);
  if ((kind == kPow2 && log2len < 0) || (kind == kMixed && log2len >= 0))
    return false;
  const bool shifts = kind == kPow2 || (kind == kBluestein && log2len >= 0);
  int ns = 1;
  for (int s = 0; s < n_stages; ++s) {
    const int r = radices[s];
    const int first = log2len % 3;
    const bool ok =
        shifts  ? r == (s > 0 || first == 0 ? 8 : first == 1 ? 2 : 4)
        : r > 8 ? kind == kPrime && r <= kMaxPrime && is_prime(r)
                : r >= 2 && r != 6 && (r != 8 || kind != kMixed);
    if (len % (ns * r) != 0 || !ok) return false;
    out[s] = {r, ns, 2 * half / (r * ns), FastDiv::of(len / r),
              FastDiv::of(ns)};
    if (kind != kPow2 && (!exact(len / r, (long long)seq * len / r) ||
                          !exact(ns, len / r)))
      return false;
    ns *= r;
  }
  return ns == len;
}

}  // namespace

// (A): launch over B signals of N samples.  window is n_fft floats;
// twiddle half + 1 complex (float2) values exp(-pi i j / half), half = L
// (kPow2, kMixed, kPrime), len / 2 for an even FFT length len under kRader
// (len = L - 1) and kBluestein (len = pad = P), else len; split (even n_fft
// under kRader and kBluestein) n_fft/2 + 1 values exp(-2 pi i k / n_fft),
// else unused; under kBluestein chirp (L values exp(-i pi (n^2 mod 2L) /
// L)) and chirp_fft (P values: the P-point FFT of the chirp's conjugate over
// |m| < L, divided by P); under kRader chirp_fft (L - 1 values: the FFT of
// b[m] = W_L^(g^-m), divided by L - 1) and perm (2L - 1 ints: g^q mod L for
// q < L - 1, then for each k < L the p with g^-p = k); else unused.
// `radices` (n_stages) multiply to the FFT's length in the order
// `plan_stages` takes; `kind` is the transform (kPrime and kRader up to
// n_fft 4096), `pad` Bluestein's P (a 7-smooth P >= 2L - 1, at most 8192),
// else 0.  `tf` (frames a block) is a power of two in [1, 32]; `vec` asks
// for 16-byte copies (n_fft <= 4096) and needs hop % 4 == 0, N % 4 == 0 and
// a 16-byte aligned audio pointer.  Returns a cudaError_t (0 on success);
// cudaErrorInvalidValue where the block would not fit.
extern "C" int avsep_stft_fft_fwd(const void* audio, const void* window,
                                  const void* twiddle, const void* split,
                                  const void* chirp, const void* chirp_fft,
                                  const void* perm, void* mag, int B, int N,
                                  int T, int n_fft, int hop, int tf, int vec,
                                  const int* radices, int n_stages, int kind,
                                  int pad, int device, void* stream) {
  if (n_fft < 2 || hop < 1 || B < 1 || N < 1 || T < 1 || tf < 1 ||
      tf > 32 || log2_exact(tf) < 0 || kind < kPow2 || kind > kRader ||
      (vec && (n_fft > kStagedMax || hop % 4 != 0 || N % 4 != 0 ||
               reinterpret_cast<uintptr_t>(audio) % 16 != 0)))
    return cudaErrorInvalidValue;
  const bool odd = n_fft & 1, wide = n_fft > kStagedMax;
  const bool blue = kind == kBluestein, rader = kind == kRader;
  Geometry g = {};
  g.N = N;
  g.T = T;
  g.n_fft = n_fft;
  g.hop = hop;
  g.tf = tf;
  g.log2tf = log2_exact(tf);
  g.vec = vec;
  g.L = odd ? n_fft : n_fft / 2;
  g.len = blue ? pad : rader ? g.L - 1 : g.L;
  g.log2len = log2_exact(g.len);
  g.half = !blue && !rader ? g.L : g.len % 2 == 0 ? g.len / 2 : g.len;
  g.log2q = log2_exact(2 * g.half);
  g.seq = odd ? (tf + 1) / 2 : tf;
  g.F = n_fft / 2 + 1;
  g.n_stages = n_stages;
  if ((blue != (pad != 0)) || ((kind == kPrime || rader) && wide) ||
      (blue && (pad < 2 * g.L - 1 || pad > kMaxPad || chirp == nullptr ||
                chirp_fft == nullptr || (odd && wide))) ||
      (rader && (g.L < 3 || !is_prime(g.L) || chirp_fft == nullptr ||
                 perm == nullptr)) ||
      ((blue || rader) && !odd && split == nullptr))
    return cudaErrorInvalidValue;
  if (!plan_stages(g.stage, g.len, g.half, radices, n_stages, g.seq, kind))
    return cudaErrorInvalidValue;
  g.by_len = FastDiv::of(g.len);
  g.by_f = FastDiv::of(g.F);
  if (!exact(g.len, (long long)g.seq * g.len) ||
      !exact(g.F, (long long)g.seq * g.F))
    return cudaErrorInvalidValue;
  g.region = region_floats(n_fft, hop, tf, g.seq, g.len);
  const long long tiles = (T + tf - 1) / tf;
  if (tiles * B > 0x7fffffffLL) return cudaErrorInvalidValue;
  g.tiles = static_cast<int>(tiles);
  const size_t own_split = (blue || rader) && !odd ? g.F : 0;
  const size_t smem =
      sizeof(float) * (2 * (size_t)g.region + (wide ? 0 : n_fft)) +
      sizeof(float2) * (g.half + 1 + own_split + (rader ? 2 * g.seq : 0));
  if (smem + sizeof(Stage) * kMaxStages > kMaxSmem)
    return cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return static_cast<int>(err);
  using Kernel = void (*)(const float*, const float*, const float2*,
                          const float2*, const float2*, const float2*, float*,
                          const Geometry, const int*);
  // The 13 instances: above n_fft 4096 (WIDE) no kPrime, kRader or odd
  // kBluestein; kPow2 has no odd n_fft.
  const Kernel narrow[5][2] = {
      {stft_fft_kernel<kPow2, false, false>, nullptr},
      {stft_fft_kernel<kMixed, false, false>,
       stft_fft_kernel<kMixed, true, false>},
      {stft_fft_kernel<kBluestein, false, false>,
       stft_fft_kernel<kBluestein, true, false>},
      {stft_fft_kernel<kPrime, false, false>,
       stft_fft_kernel<kPrime, true, false>},
      {stft_fft_kernel<kRader, false, false>,
       stft_fft_kernel<kRader, true, false>}};
  const Kernel broad[3][2] = {
      {stft_fft_kernel<kPow2, false, true>, nullptr},
      {stft_fft_kernel<kMixed, false, true>,
       stft_fft_kernel<kMixed, true, true>},
      {stft_fft_kernel<kBluestein, false, true>, nullptr}};
  const Kernel kernel = wide ? broad[kind][odd] : narrow[kind][odd];
  if (kernel == nullptr) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned>(tiles * B), wide ? kWideThreads : kThreads,
           smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(audio), static_cast<const float*>(window),
      static_cast<const float2*>(twiddle), static_cast<const float2*>(split),
      static_cast<const float2*>(chirp),
      static_cast<const float2*>(chirp_fft), static_cast<float*>(mag), g,
      static_cast<const int*>(perm));
  return static_cast<int>(cudaGetLastError());
}

// (B): the passes over sequences [seq0, seq0 + seqs) of B signals' S
// sequences each (S = T, or ceil(T / 2) for an odd n_fft), through
// `scratch` (seqs P complex values).  P = pad (Bluestein) or L = n1 n2;
// n1 <= 8192, n2 <= 2048.  window n_fft floats; twiddle1 / twiddle2 the
// n1 + 1 and n2 + 1 values exp(-pi i j / n) of the column and row FFTs;
// split (even n_fft) the F values exp(-2 pi i k / n_fft); under Bluestein
// chirp (L values, as for (A)) and chirp_fft (P values in the [k1][k2]
// layout: entry k1 n2 + k2 holds the transform at k1 + n1 k2).  radices1 /
// radices2 plan the n1- and n2-point FFTs as for (A).  `cols` (a power of
// two) columns a block of the first pass, `rows` rows a block of
// Bluestein's middle pass, `pairs` pairs a block of the last pass.
// Returns a cudaError_t (0 on success).
extern "C" int avsep_stft_4step_fwd(
    const void* audio, const void* window, const void* twiddle1,
    const void* twiddle2, const void* split, const void* chirp,
    const void* chirp_fft, void* scratch, void* mag, int B, int N, int T,
    int n_fft, int hop, int n1, int n2, const int* radices1, int n_stages1,
    const int* radices2, int n_stages2, int pad, int cols, int rows,
    int pairs, long long seq0, int seqs, int device, void* stream) {
  const bool odd = n_fft & 1;
  const int L = odd ? n_fft : n_fft / 2, P = pad ? pad : L;
  const int S = odd ? (T + 1) / 2 : T;
  if (n_fft < 2 || hop < 1 || B < 1 || N < 1 || T < 1 || n1 < 2 ||
      n2 < 2 || n1 > kMaxColumn || n2 > kMaxRow ||
      (long long)n1 * n2 != P || P >= (1 << 24) ||
      (pad && (log2_exact(pad) < 0 || pad < 2 * L - 1 || chirp == nullptr ||
               chirp_fft == nullptr)) ||
      (!odd && split == nullptr) || cols < 1 || log2_exact(cols) < 0 ||
      rows < 1 || pairs < 1 || log2_exact(pairs) < 0 || seqs < 1 ||
      seq0 < 0 ||
      seq0 + seqs > (long long)B * S)
    return cudaErrorInvalidValue;
  // Each pass: its FFT (length, radices, sequences a block) and work region.
  const bool cols_last = pad != 0;
  FourStep g[3] = {};
  int passes[3] = {kColumns, cols_last ? kRowsMiddle : kRowsLast,
                   kColumnsLast};
  const int n_passes = cols_last ? 3 : 2;
  for (int p = 0; p < n_passes; ++p) {
    FourStep& f = g[p];
    f.N = N;
    f.T = T;
    f.n_fft = n_fft;
    f.hop = hop;
    f.L = L;
    f.P = P;
    f.n1 = n1;
    f.n2 = n2;
    f.F = n_fft / 2 + 1;
    f.S = S;
    f.odd = odd;
    f.blue = pad != 0;
    f.seq0 = seq0;
    const int pass = passes[p];
    const bool on_columns = pass == kColumns || pass == kColumnsLast;
    f.len = on_columns ? n1 : n2;
    f.log2len = log2_exact(f.len);
    f.log2q = f.log2len < 0 ? -1 : f.log2len + 1;
    f.pow2 = f.log2len >= 0;
    f.n_stages = on_columns ? n_stages1 : n_stages2;
    int seq = 0;
    if (pass == kColumns) {
      f.width = cols;
      f.log2width = log2_exact(cols);
      f.groups = (n2 + cols - 1) / cols;
      seq = cols;
      f.region = n1 * cols;
    } else if (pass == kRowsMiddle) {
      f.width = rows;
      f.groups = (n1 + rows - 1) / rows;
      seq = rows;
      f.region = rows * n2;
    } else {
      const int A = pass == kRowsLast ? n1 : n2;
      f.a = L % A;
      f.q = L / A;
      f.reps = f.a / 2 + 1 + (A - f.a) / 2;  // + ceil((A - a - 1) / 2)
      f.width = pairs;
      f.log2width = log2_exact(pairs);
      f.groups = (f.reps + pairs - 1) / pairs;
      seq = 2 * pairs;
      f.region = seq * (pass == kRowsLast ? n2 : n1);
    }
    if (!plan_stages(f.stage, f.len, f.len, on_columns ? radices1 : radices2,
                     f.n_stages, seq, f.pow2 ? kPow2 : kMixed) ||
        (long long)f.groups * seqs > 0x7fffffffLL ||
        (2 * (size_t)f.region + f.len + 1) * sizeof(float2) +
                sizeof(Stage) * kMaxStages > kMaxSmem)
      return cudaErrorInvalidValue;
  }
  const DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return static_cast<int>(err);
  const float2* tables[3] = {static_cast<const float2*>(twiddle1),
                             static_cast<const float2*>(twiddle2),
                             static_cast<const float2*>(twiddle1)};
  for (int p = 0; p < n_passes; ++p) {
    const auto kernel =
        passes[p] == kColumns      ? stft_4step_kernel<kColumns>
        : passes[p] == kRowsLast   ? stft_4step_kernel<kRowsLast>
        : passes[p] == kRowsMiddle ? stft_4step_kernel<kRowsMiddle>
                                   : stft_4step_kernel<kColumnsLast>;
    const size_t smem = (2 * (size_t)g[p].region + g[p].len + 1) *
                        sizeof(float2);
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    kernel<<<static_cast<unsigned>((long long)g[p].groups * seqs), kThreads,
             smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(audio), static_cast<const float*>(window),
        tables[p], static_cast<const float2*>(split),
        static_cast<const float2*>(chirp),
        static_cast<const float2*>(chirp_fft),
        static_cast<float2*>(scratch), static_cast<float*>(mag), g[p]);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

extern "C" const char* avsep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
