// Flash attention forward, float32, for Hopper (sm_90a).
//
// Replaces: av_separation_tpu/ops/pallas/attention.py `_fwd_hpacked_kernel`
// (packed (B, T, H*dh) layout, called from `_flash_hpacked_call`) and
// `_fwd_packed_kernel` (split (B*H, T, dh) layout, `_flash_packed_call`).
// One kernel serves both layouts: q/k/v/o are addressed through
// (batch, head, time) strides with the head dim contiguous.  It also covers
// the multi-block `_fwd_kernel` (Tk > 512), since the keys are always
// streamed in tiles.
//
// Computes O = softmax(Q K^T * scale) V per (batch, head) and the row
// logsumexp lse = m + log(l) in float32, as the Pallas kernels emit it.
// Attention dropout as in `_fwd_hpacked_kernel` (attention.py:389-398): l
// sums the undropped p, dropped p are zeroed before PV, and
// o = acc / (l * (1 - rate)); the keep test is the Pallas hash
// (dropout_hash.cuh), so the backward kernels regenerate the same mask.  At
// rate 0 the hash is skipped and the arithmetic is unchanged.
//
// Bound on the H100 at the scaled serving shapes (B=8, H=4, dh=128, float32):
// audio self-attention (Tq = Tk = 501) is 4*B*H*Tq*Tk*dh = 4.1 GFLOP against
// 33 MB of q/k/v/o, so at 67 TFLOP/s (float32, no tensor cores) and
// 3.35 TB/s it is bound by operations (61 us vs 10 us).  Visual
// self-attention (200 x 200) is 0.66 GFLOP: 10 us vs 4 us of bytes.
//
// Design: the TPU kernel kept whole (T <= 512, dh) K/V rows in VMEM; at
// dh=128 float32 that is 512 KB, more than a block's 227 KB of shared
// memory.  Here a block owns 32 query rows of one (batch, head) (8 rows per
// warp) and walks the keys in tiles of 64 held in shared memory, with the
// online-softmax rescale in registers, so Tk has no cap.  Scores: each lane
// owns two keys of the tile; QK^T reads float4 K rows from a padded tile
// (stride dh+4: conflict-free) against broadcast Q rows.  PV: each lane owns
// dh/32 output columns; P goes through a per-warp shared buffer.  Simple
// SIMT float32 FMAs: `wgmma` has no float32 mode, and TF32 would not hold
// the float32 reference's tolerances.
#include <cuda_runtime.h>
#include <math.h>

#include "dropout_hash.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 8;
constexpr int kBlockQ = kWarps * kRowsPerWarp;  // 32 query rows per block
constexpr int kBlockK = 64;                     // keys per shared tile
constexpr int kThreads = kWarps * 32;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  float* lse;
  int H, Tq, Tk;
  long long sqb, sqh, sqt;
  long long skb, skh, skt;
  long long svb, svh, svt;
  long long sob, soh, sot;
  float scale;
  float keep;  // 1 - rate
  DropoutHash drop;
};

template <int DH>
struct Layout {
  static constexpr int kQS = DH + 4;       // Q row stride (floats)
  static constexpr int kKS = DH + 4;       // K row stride: conflict-free float4
  static constexpr int kVS = DH;           // V rows are read along dh
  static constexpr int kPS = kBlockK + 4;  // P row stride
  static constexpr size_t kFloats =
      kBlockQ * kQS + kBlockK * kKS + kBlockK * kVS + kBlockQ * kPS;
  static constexpr size_t kBytes = kFloats * sizeof(float);
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const Params p) {
  using L = Layout<DH>;
  constexpr int kV4 = DH / 4;     // float4 per row
  constexpr int kCols = DH / 32;  // output columns per lane
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + kBlockQ * L::kQS;
  float* sV = sK + kBlockK * L::kKS;
  float* sP = sV + kBlockK * L::kVS;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int q0 = blockIdx.x * kBlockQ;

  const float* qb = p.q + b * p.sqb + h * p.sqh;
  const float* kb = p.k + b * p.skb + h * p.skh;
  const float* vb = p.v + b * p.svb + h * p.svh;

  for (int i = tid; i < kBlockQ * kV4; i += kThreads) {
    const int r = i / kV4, c = (i % kV4) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < p.Tq) val = ld4(qb + (q0 + r) * p.sqt + c);
    st4(sQ + r * L::kQS + c, val);
  }

  float acc[kRowsPerWarp][kCols];
  float m_i[kRowsPerWarp];
  float l_i[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m_i[r] = -INFINITY;
    l_i[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }

  const float* qw = sQ + warp * kRowsPerWarp * L::kQS;
  float* pw = sP + warp * kRowsPerWarp * L::kPS;
  const int n_tiles = (p.Tk + kBlockK - 1) / kBlockK;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // the previous tile is consumed; Q is visible
    for (int i = tid; i < kBlockK * kV4; i += kThreads) {
      const int r = i / kV4, c = (i % kV4) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vv = kv;
      if (k0 + r < p.Tk) {
        kv = ld4(kb + (k0 + r) * p.skt + c);
        vv = ld4(vb + (k0 + r) * p.svt + c);
      }
      st4(sK + r * L::kKS + c, kv);
      st4(sV + r * L::kVS + c, vv);
    }
    __syncthreads();

    // S = Q K^T for this warp's rows; lane owns keys lane and lane + 32.
    float s[kRowsPerWarp][2];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r][0] = s[r][1] = 0.f;
    const float* ka = sK + lane * L::kKS;
    const float* kbb = sK + (lane + 32) * L::kKS;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      const float4 x = ld4(ka + d);
      const float4 y = ld4(kbb + d);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qv = ld4(qw + r * L::kQS + d);
        s[r][0] = dot4(qv, x, s[r][0]);
        s[r][1] = dot4(qv, y, s[r][1]);
      }
    }

    // Online softmax; keys past Tk score -inf and weigh 0.
    const bool va = k0 + lane < p.Tk;
    const bool vbk = k0 + lane + 32 < p.Tk;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float sa = va ? s[r][0] * p.scale : -INFINITY;
      const float sb = vbk ? s[r][1] * p.scale : -INFINITY;
      const float m_new = fmaxf(m_i[r], warp_max(fmaxf(sa, sb)));
      const float alpha = expf(m_i[r] - m_new);
      float pa = expf(sa - m_new);
      float pb = expf(sb - m_new);
      l_i[r] = l_i[r] * alpha + warp_sum(pa + pb);
      m_i[r] = m_new;
      if (p.drop.on) {
        const HashRow hr = hash_row(p.drop, bh, q0 + warp * kRowsPerWarp + r);
        if (!hash_keep(p.drop, hr, k0 + lane)) pa = 0.f;
        if (!hash_keep(p.drop, hr, k0 + lane + 32)) pb = 0.f;
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] *= alpha;
      pw[r * L::kPS + lane] = pa;
      pw[r * L::kPS + lane + 32] = pb;
    }
    __syncwarp();

    // O += P V; lane owns columns [lane * kCols, lane * kCols + kCols).
#pragma unroll 2
    for (int j = 0; j < kBlockK; j += 4) {
      float4 pj[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) pj[r] = ld4(pw + r * L::kPS + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vrow = sV + (j + jj) * L::kVS + lane * kCols;
        float vv[kCols];
        if constexpr (kCols == 4) {
          const float4 t = ld4(vrow);
          vv[0] = t.x; vv[1] = t.y; vv[2] = t.z; vv[3] = t.w;
        } else {
#pragma unroll
          for (int c = 0; c < kCols; ++c) vv[c] = vrow[c];
        }
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const float pr = jj == 0 ? pj[r].x : jj == 1 ? pj[r].y
                         : jj == 2 ? pj[r].z : pj[r].w;
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(pr, vv[c], acc[r][c]);
        }
      }
    }
    __syncwarp();
  }

  float* ob = p.o + b * p.sob + h * p.soh;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int t = q0 + warp * kRowsPerWarp + r;
    if (t >= p.Tq) continue;
    const float inv = 1.f / (l_i[r] * p.keep);
    float* orow = ob + t * p.sot + lane * kCols;
    if constexpr (kCols == 4) {
      st4(orow, make_float4(acc[r][0] * inv, acc[r][1] * inv,
                            acc[r][2] * inv, acc[r][3] * inv));
    } else {
#pragma unroll
      for (int c = 0; c < kCols; ++c) orow[c] = acc[r][c] * inv;
    }
    if (lane == 0) p.lse[(long long)bh * p.Tq + t] = m_i[r] + logf(l_i[r]);
  }
}

template <int DH>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = Layout<DH>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Tq + kBlockQ - 1) / kBlockQ, B * p.H);
  flash_fwd_kernel<DH><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int avsep_flash_attn_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int B, int H, int Tq, int Tk, int dh,
    long long sqb, long long sqh, long long sqt,
    long long skb, long long skh, long long skt,
    long long svb, long long svh, long long svt,
    long long sob, long long soh, long long sot,
    float scale, float keep, unsigned threshold, unsigned seed, int hq,
    int hk, int dropout, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.o = static_cast<float*>(o);
  p.lse = static_cast<float*>(lse);
  p.H = H; p.Tq = Tq; p.Tk = Tk;
  p.sqb = sqb; p.sqh = sqh; p.sqt = sqt;
  p.skb = skb; p.skh = skh; p.skt = skt;
  p.svb = svb; p.svh = svh; p.svt = svt;
  p.sob = sob; p.soh = soh; p.sot = sot;
  p.scale = scale;
  p.keep = keep;
  p.drop.seed = seed;
  p.drop.threshold = threshold;
  p.drop.hq = hq;
  p.drop.hk = hk;
  p.drop.on = dropout;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32: err = launch<32>(p, B, s); break;
    case 128: err = launch<128>(p, B, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* avsep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
