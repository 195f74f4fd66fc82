// The conformer's GLU and depthwise convolution over time
// (models/layers.py ConformerConvModule), forward and backward, float32 and
// bf16, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package has no conformer block.  In the
// port it replaces PyTorch's chain F.glu, then a grouped conv1d (cuDNN),
// with the transposes between (B, T, C) and (B, C, T) around it.
//
// Forward, u (B, T, 2d) the pointwise projection's output, a = u[.., :d],
// b = u[.., d:], P = (K - 1) / 2, zero outside [0, T):
//   g[t, c]  = a[t, c] * sigmoid(b[t, c])                        (F.glu)
//   y[t, c]  = sum_k w[c, k] g[t + k - P, c]  + bias[c]
// Backward, from dy (B, T, d):
//   dg[t, c] = sum_k w[c, k] dy[t - k + P, c]
//   da = dg * s,  db = (dg * a) * (s * (1 - s)),  s = sigmoid(b)
//   dw[c, k] = sum over (batch, t) of dy[t, c] g[t + k - P, c];  dbias = sum dy
//
// Numbers.  u, w, bias and dy are read in the compute dtype and widened;
// sigmoid is 1 / (1 + expf(-b)) as PyTorch computes it; g, the products and
// the sums are float32, with FMAs.  g is never rounded to the compute dtype
// (the plain chain's bf16 F.glu would round it; the plain version and the
// benchmark's reference follow the kernel).  y, du, dw and dbias are rounded
// once, where they are stored.  dw and dbias are summed in a fixed order: a
// thread's rows, the block's four row groups in turn, then the blocks'
// partials in block order by a second kernel; no atomics.
//
// Design.  Memory-bound: about 10 FLOPs a byte at K 31 in bf16 (the card's
// balance is ~295).  A block takes 64 channels of a tile of 64 time steps.
// Its 256 threads load the tile's rows and their K - 1 halo rows, a warp a
// row: two adjacent channels a thread of a and of b (the warp's 128 contiguous
// bytes of each in bf16), a warp's loads of all its rows (forward) or of four
// (backward) in flight at once, GLU applied, kept in shared memory in
// float32; the slab's taps are staged there too.  Then thread (c, q) = (tid % 64,
// tid / 64) computes the 16 consecutive outputs 16 q .. 16 q + 15 of channel
// c: it reads the 16 + K - 1 shared rows once each, sliding them over 16
// accumulators with the K taps in registers (K is a template argument: the
// loops unroll), so a shared read serves up to 16 products and a warp's reads
// are 32 consecutive floats.  The backward block keeps dy's and g's tiles with
// their halos and a and sigmoid(b) of its own rows in shared memory (79 KB at
// K 31: two blocks an SM, as its registers allow), computes dg and dw from
// one pass over the rows (32 + 2K registers of sums and taps), and loops over
// a fixed share of the (batch row, tile) items, so that its dw and dbias
// partials are one of a few dozen a slab of channels, not one an item.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCh = 64;                  // channels a block
constexpr int kTile = 64;                // time steps a tile
constexpr int kRows = 16;                // consecutive outputs a thread
constexpr int kGroups = kTile / kRows;   // row groups: thread (c, q)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// PyTorch's sigmoid: 1 / (1 + exp(-x)), the quotient correctly rounded
// (__frcp_rn rounds 1 / x as the division does).
__device__ __forceinline__ float sigmoid(float v) {
  return __frcp_rn(__fadd_rn(1.0f, expf(-v)));
}

// Two adjacent channels as loaded: their bits (bf16: one word) or values.
template <typename T>
struct Pair;
template <>
struct Pair<float> {
  using Raw = float2;
  static __device__ __forceinline__ Raw load(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  static __device__ __forceinline__ float2 widen(Raw r) { return r; }
};
template <>
struct Pair<__nv_bfloat16> {
  using Raw = uint32_t;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
  }
  // A bf16 is the high half of its float.
  static __device__ __forceinline__ float2 widen(Raw w) {
    return make_float2(__uint_as_float(w << 16),
                       __uint_as_float(w & 0xffff0000u));
  }
};

// Rows [t0 - P, t0 + kTile + P) of g for channels [c0, c0 + kCh), zero
// outside [0, T) and past d, into `g` (float32, kCh a row).  With DY, dy's
// rows into `dys` alike, and a and sigmoid(b) of the tile's own rows
// [t0, t0 + kTile) into `as` and `ss`.  A warp a row, two channels a
// thread; a warp's loads of CHUNK rows are issued before any is used, so
// that each warp keeps several rows in flight.
template <typename T, int K, int CHUNK, bool DY>
__device__ __forceinline__ void load_tile(const T* __restrict__ u,
                                          const T* __restrict__ dy, float* g,
                                          float* dys, float* as, float* ss,
                                          long long b, int t0, int c0,
                                          int n_t, int d) {
  using Raw = typename Pair<T>::Raw;
  constexpr int P = (K - 1) / 2;
  constexpr int R = kTile + K - 1;
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int cp = c0 + 2 * lane;
  for (int r0 = warp; r0 < R; r0 += CHUNK * kWarps) {
    Raw a[CHUNK], s[CHUNK], e[CHUNK];
    bool in[CHUNK];
#pragma unroll
    for (int i = 0; i < CHUNK; ++i) {
      const int r = r0 + i * kWarps, t = t0 - P + r;
      in[i] = r < R && cp < d && t >= 0 && t < n_t;
      if (in[i]) {
        const T* row = u + (b * n_t + t) * 2LL * d;
        a[i] = Pair<T>::load(row + cp);
        s[i] = Pair<T>::load(row + d + cp);
        if (DY) e[i] = Pair<T>::load(dy + (b * n_t + t) * d + cp);
      }
    }
#pragma unroll
    for (int i = 0; i < CHUNK; ++i) {
      const int r = r0 + i * kWarps;
      if (r >= R) break;
      float2 av = make_float2(0.0f, 0.0f), sg = av, dv = av;
      if (in[i]) {
        av = Pair<T>::widen(a[i]);
        const float2 bv = Pair<T>::widen(s[i]);
        sg = make_float2(sigmoid(bv.x), sigmoid(bv.y));
        if (DY) dv = Pair<T>::widen(e[i]);
      }
      *reinterpret_cast<float2*>(g + r * kCh + 2 * lane) =
          make_float2(__fmul_rn(av.x, sg.x), __fmul_rn(av.y, sg.y));
      if (DY) {
        *reinterpret_cast<float2*>(dys + r * kCh + 2 * lane) = dv;
        if (r >= P && r < P + kTile) {
          *reinterpret_cast<float2*>(as + (r - P) * kCh + 2 * lane) = av;
          *reinterpret_cast<float2*>(ss + (r - P) * kCh + 2 * lane) = sg;
        }
      }
    }
  }
}

// Rows a warp loads at once: all its rows of a forward tile at the largest
// K built, 31 (the taps are not yet in registers), four in the backward
// (its sums and taps are).
constexpr int kWarpsOf = kThreads / 32;
constexpr int kFwdChunk = (kTile + 31 - 1 + kWarpsOf - 1) / kWarpsOf;
constexpr int kBwdChunk = 4;

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
    glu_dwconv_fwd_kernel(const T* __restrict__ u, const T* __restrict__ w,
                          const T* __restrict__ bias, T* __restrict__ y,
                          int n_t, int d) {
  __shared__ float g[(kTile + K - 1) * kCh];
  __shared__ float ws[kCh * K];
  const int t0 = blockIdx.x * kTile, c0 = blockIdx.y * kCh;
  const long long b = blockIdx.z;
  // The slab's taps, one contiguous run of w, staged through shared memory
  // (a thread's own K taps lie K elements apart: read directly, a warp's
  // loads would touch 16 lines each).
  const int n_w = (d - c0 < kCh ? d - c0 : kCh) * K;
  for (int i = threadIdx.x; i < n_w; i += kThreads)
    ws[i] = to_f(w[c0 * K + i]);
  load_tile<T, K, kFwdChunk, false>(u, nullptr, g, nullptr, nullptr, nullptr,
                                    b, t0, c0, n_t, d);
  const int c = threadIdx.x % kCh, q = threadIdx.x / kCh;
  const bool in = c0 + c < d;
  const float bc = in ? to_f(bias[c0 + c]) : 0.0f;
  __syncthreads();
  float wk[K];
#pragma unroll
  for (int k = 0; k < K; ++k) wk[k] = in ? ws[c * K + k] : 0.0f;
  float acc[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) acc[j] = 0.0f;
  const float* col = g + q * kRows * kCh + c;
  // Output j takes taps k = r - j from shared row r (its window's k-th).
#pragma unroll
  for (int r = 0; r < kRows + K - 1; ++r) {
    const float v = col[r * kCh];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int k = r - j;
      if (k >= 0 && k < K) acc[j] = __fmaf_rn(wk[k], v, acc[j]);
    }
  }
  if (!in) return;
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int t = t0 + q * kRows + j;
    if (t < n_t) y[(b * n_t + t) * d + c0 + c] = from_f<T>(__fadd_rn(acc[j], bc));
  }
}

// The backward's dynamic shared memory, floats: g's and dy's tiles with
// their halos, a and sigmoid(b) of the tile's own rows; the four row
// groups' dw / dbias sums reuse it at the end.
template <int K>
constexpr int bwd_smem_floats() {
  constexpr int tiles = 2 * (kTile + K - 1) * kCh + 2 * kTile * kCh;
  constexpr int reduce = kGroups * (K + 1) * kCh;
  return tiles > reduce ? tiles : reduce;
}

// One block a slab of channels (grid x) and a share of the (batch row,
// tile) items (grid y: items y, y + gridDim.y, ...).  Writes du and the
// block's dw / dbias partial: partial[(blockIdx.y * (K + 1) + k) * d + c],
// k = K for dbias.
template <typename T, int K>
__global__ void __launch_bounds__(kThreads, 2)
    glu_dwconv_bwd_kernel(const T* __restrict__ u, const T* __restrict__ w,
                          const T* __restrict__ dy, T* __restrict__ du,
                          float* __restrict__ partial, int n_b, int n_t,
                          int d) {
  constexpr int P = (K - 1) / 2;
  constexpr int R = kTile + K - 1;
  extern __shared__ float smem[];
  float* gs = smem;
  float* dys = gs + R * kCh;
  float* as = dys + R * kCh;
  float* ss = as + kTile * kCh;
  const int c0 = blockIdx.x * kCh;
  const int tiles = (n_t + kTile - 1) / kTile;
  const long long items = static_cast<long long>(n_b) * tiles;
  const int c = threadIdx.x % kCh, q = threadIdx.x / kCh;
  const bool in = c0 + c < d;
  float wk[K], dw[K], db = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    wk[k] = in ? to_f(w[(c0 + c) * K + k]) : 0.0f;
    dw[k] = 0.0f;
  }
  for (long long it = blockIdx.y; it < items; it += gridDim.y) {
    const long long b = it / tiles;
    const int t0 = static_cast<int>(it % tiles) * kTile;
    __syncthreads();  // the previous item's reads of the tiles are done
    load_tile<T, K, kBwdChunk, true>(u, dy, gs, dys, as, ss, b, t0, c0, n_t,
                                     d);
    __syncthreads();
    const float* gcol = gs + q * kRows * kCh + c;
    const float* dcol = dys + q * kRows * kCh + c;
    float dyj[kRows], dg[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      dyj[j] = dcol[(j + P) * kCh];  // dy of the thread's own rows
      dg[j] = 0.0f;
    }
    // Shared row r: dy at t0 + 16 q + r - P feeds dg of output j through
    // tap K - 1 + j - r; g at the same row feeds dw[r - j] through dy of j.
#pragma unroll
    for (int r = 0; r < kRows + K - 1; ++r) {
      const float dv = dcol[r * kCh], gv = gcol[r * kCh];
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int kd = K - 1 + j - r, kw = r - j;
        if (kd >= 0 && kd < K) dg[j] = __fmaf_rn(wk[kd], dv, dg[j]);
        if (kw >= 0 && kw < K) dw[kw] = __fmaf_rn(dyj[j], gv, dw[kw]);
      }
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) db = __fadd_rn(db, dyj[j]);  // 0 past T
    if (in) {
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int t = t0 + q * kRows + j;
        if (t >= n_t) continue;
        const long long row = (b * n_t + t) * 2LL * d;
        const float a = as[(q * kRows + j) * kCh + c];
        const float s = ss[(q * kRows + j) * kCh + c];
        du[row + c0 + c] = from_f<T>(__fmul_rn(dg[j], s));
        du[row + d + c0 + c] = from_f<T>(__fmul_rn(
            __fmul_rn(dg[j], a), __fmul_rn(s, __fsub_rn(1.0f, s))));
      }
    }
  }
  // The four row groups' sums in turn: red[(q (K + 1) + k) kCh + c].
  __syncthreads();
  float* red = smem;
#pragma unroll
  for (int k = 0; k < K; ++k) red[(q * (K + 1) + k) * kCh + c] = dw[k];
  red[(q * (K + 1) + K) * kCh + c] = db;
  __syncthreads();
  for (int i = threadIdx.x; i < (K + 1) * kCh; i += kThreads) {
    const int k = i / kCh, cc = i % kCh;
    float s = red[k * kCh + cc];
#pragma unroll
    for (int g = 1; g < kGroups; ++g)
      s = __fadd_rn(s, red[(g * (K + 1) + k) * kCh + cc]);
    if (c0 + cc < d)
      partial[(static_cast<long long>(blockIdx.y) * (K + 1) + k) * d + c0 +
              cc] = s;
  }
}

// dw (d, K) and dbias (d) from the `groups` partials, summed in block order.
template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
    glu_dwconv_bwd_reduce_kernel(const float* __restrict__ partial,
                                 T* __restrict__ dw, T* __restrict__ dbias,
                                 int groups, int d) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= (K + 1) * d) return;
  const int k = i / d, c = i % d;
  float s = 0.0f;
  for (int p = 0; p < groups; ++p)
    s = __fadd_rn(s, partial[(static_cast<long long>(p) * (K + 1) + k) * d + c]);
  if (k < K)
    dw[c * K + k] = from_f<T>(s);
  else
    dbias[c] = from_f<T>(s);
}

struct Args {
  const void* u;
  const void* w;
  const void* bias;  // forward
  const void* dy;    // backward
  void* out;         // y (forward) or du
  float* partial;
  void* dw;
  void* dbias;
  int n_b, n_t, d, groups, sms;
  cudaStream_t stream;
};

template <typename T, int K>
cudaError_t fwd(const Args& a) {
  const dim3 grid((a.n_t + kTile - 1) / kTile, (a.d + kCh - 1) / kCh, a.n_b);
  glu_dwconv_fwd_kernel<T, K><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.u), static_cast<const T*>(a.w),
      static_cast<const T*>(a.bias), static_cast<T*>(a.out), a.n_t, a.d);
  return cudaGetLastError();
}

// The backward's item groups (grid y): one wave of the blocks the card
// holds at once, over the slabs, at most one a (batch row, tile) item.
// The backward kernel's dynamic shared memory above 48 KB, allowed once an
// instance.
template <typename T, int K>
cudaError_t bwd_smem_allowed() {
  static cudaError_t err = cudaFuncSetAttribute(
      glu_dwconv_bwd_kernel<T, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bwd_smem_floats<K>() * static_cast<int>(sizeof(float)));
  return err;
}

template <typename T, int K>
int groups_of(const Args& a) {
  static int resident = 0;
  if (resident == 0 &&
      (bwd_smem_allowed<T, K>() != cudaSuccess ||
       cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &resident, glu_dwconv_bwd_kernel<T, K>, kThreads,
           bwd_smem_floats<K>() * sizeof(float)) != cudaSuccess))
    resident = 1;
  if (resident < 1) resident = 1;
  const long long slabs = (a.d + kCh - 1) / kCh;
  const long long items =
      static_cast<long long>(a.n_b) * ((a.n_t + kTile - 1) / kTile);
  long long g = static_cast<long long>(resident) * a.sms / slabs;
  if (g < 1) g = 1;
  if (g > items) g = items;
  return static_cast<int>(g);
}

template <typename T, int K>
cudaError_t bwd(const Args& a) {
  const cudaError_t allowed = bwd_smem_allowed<T, K>();
  if (allowed != cudaSuccess) return allowed;
  const dim3 grid((a.d + kCh - 1) / kCh, a.groups);
  glu_dwconv_bwd_kernel<T, K>
      <<<grid, kThreads, bwd_smem_floats<K>() * sizeof(float), a.stream>>>(
      static_cast<const T*>(a.u), static_cast<const T*>(a.w),
      static_cast<const T*>(a.dy), static_cast<T*>(a.out), a.partial, a.n_b,
      a.n_t, a.d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = (K + 1) * a.d;
  glu_dwconv_bwd_reduce_kernel<T, K>
      <<<(n + kThreads - 1) / kThreads, kThreads, 0, a.stream>>>(
          a.partial, static_cast<T*>(a.dw), static_cast<T*>(a.dbias), a.groups,
          a.d);
  return cudaGetLastError();
}

// What each entry point does for one (dtype, K): 0 forward, 1 backward,
// 2 the backward's groups (returned, not an error code).
template <typename T, int K>
int run(int what, const Args& a) {
  if (what == 0) return static_cast<int>(fwd<T, K>(a));
  if (what == 1) return static_cast<int>(bwd<T, K>(a));
  return groups_of<T, K>(a);
}

// The kernels are built for the K of config.py's CONV_KERNELS.
#define AVSEP_GLU_DWCONV_KS(X) X(7) X(31)

template <typename T>
int by_k(int k, int what, const Args& a, bool* known) {
  *known = true;
  switch (k) {
#define AVSEP_CASE(kk) \
  case kk:             \
    return run<T, kk>(what, a);
    AVSEP_GLU_DWCONV_KS(AVSEP_CASE)
#undef AVSEP_CASE
    default:
      *known = false;
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int dispatch(int dtype, int k, int what, const Args& a, bool* known) {
  if (dtype == 0) return by_k<float>(k, what, a, known);
  if (dtype == 1) return by_k<__nv_bfloat16>(k, what, a, known);
  *known = false;
  return static_cast<int>(cudaErrorInvalidValue);
}

bool bad_args(int dtype, int n_b, int n_t, int d) {
  return dtype < 0 || dtype > 1 || n_b < 1 || n_b > 65535 || n_t < 1 ||
         d < 2 || d % 2 != 0;
}

}  // namespace

// y (B, T, d) = depthwise_conv_K(glu(u)) + bias for u (B, T, 2d), w (d, K),
// bias (d), all of dtype 0 (float32) or 1 (bf16), contiguous; u and y
// aligned to two elements.
extern "C" int avsep_glu_dwconv_fwd(int dtype, int k, const void* u,
                                    const void* w, const void* bias, void* y,
                                    int n_b, int n_t, int d, int device,
                                    void* stream) {
  if (bad_args(dtype, n_b, n_t, d)) return cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  const cudaError_t err = guard.error();
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a{};
  a.u = u;
  a.w = w;
  a.bias = bias;
  a.out = y;
  a.n_b = n_b;
  a.n_t = n_t;
  a.d = d;
  a.stream = static_cast<cudaStream_t>(stream);
  bool known = false;
  return dispatch(dtype, k, 0, a, &known);
}

// The item groups of the backward at these shapes on a card of `sms` SMs:
// the partial buffer holds groups x (K + 1) x d floats.  Negative for a
// dtype or K not built.
extern "C" int avsep_glu_dwconv_groups(int dtype, int k, int n_b, int n_t,
                                       int d, int sms, int device) {
  if (bad_args(dtype, n_b, n_t, d) || sms < 1) return -1;
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return -1;
  Args a{};
  a.n_b = n_b;
  a.n_t = n_t;
  a.d = d;
  a.sms = sms;
  bool known = false;
  const int g = dispatch(dtype, k, 2, a, &known);
  return known ? g : -1;
}

// du (B, T, 2d), dw (d, K) and dbias (d) from dy (B, T, d): `partial` is
// a float32 scratch of groups x (K + 1) x d (avsep_glu_dwconv_groups).
extern "C" int avsep_glu_dwconv_bwd(int dtype, int k, const void* u,
                                    const void* w, const void* dy, void* du,
                                    float* partial, void* dw, void* dbias,
                                    int n_b, int n_t, int d, int groups,
                                    int device, void* stream) {
  if (bad_args(dtype, n_b, n_t, d) || groups < 1 || groups > 65535)
    return cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  const cudaError_t err = guard.error();
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a{};
  a.u = u;
  a.w = w;
  a.dy = dy;
  a.out = du;
  a.partial = partial;
  a.dw = dw;
  a.dbias = dbias;
  a.n_b = n_b;
  a.n_t = n_t;
  a.d = d;
  a.groups = groups;
  a.stream = static_cast<cudaStream_t>(stream);
  bool known = false;
  return dispatch(dtype, k, 1, a, &known);
}

extern "C" const char* avsep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
