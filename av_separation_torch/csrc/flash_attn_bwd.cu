// Flash attention backward, float32, for Hopper (sm_90a).
//
// Replaces: av_separation_tpu/ops/pallas/attention.py `_bwd_hpacked_kernel`
// (packed (B, T, H*dh) layout, `_flash_hpacked_bwd_rule`),
// `_bwd_packed_kernel` (split (B*H, T, dh) layout, `_flash_packed_bwd_rule`)
// and the multi-block `_delta_kernel` / `_dq_kernel` / `_dkv_kernel`
// (`_flash_bwd_rule`, T > 512).  Tensors are addressed through
// (batch, head, time) strides with the head dim contiguous, as in the
// forward.
//
// The Pallas arithmetic, in float32:
//   delta = rowsum(dO * O)
//   p  = exp(q.k * scale - lse)
//   dp = dO.v, masked and divided by (1 - rate) where kept
//   pd = keep ? p / (1 - rate) : 0,   dV = pd^T dO
//   ds = p (dp - delta) scale,        dQ = ds K,   dK = ds^T Q
// with the keep mask regenerated from the Pallas hash (dropout_hash.cuh),
// so it is the forward's mask bit for bit.
//
// Bound on the H100 at the scaled training shapes (B=8, H=4, dh=128,
// Tq = Tk = 501): the least work is 5 products of 2*B*H*Tq*Tk*dh FLOPs
// (QK^T, dO V^T, dV, dQ, dK), 10.3 GFLOP, against 57 MB of q, k, v, o, dO,
// lse in and dQ, dK, dV out: 154 us of float32 FMAs at 67 TFLOP/s against
// 17 us of bytes at 3.35 TB/s, so bound by operations.
//
// Design (FlashAttention-2 style, no atomics, so two runs give bit-identical
// gradients): the TPU kernel held whole (T <= 512, dh) rows of every operand
// in VMEM; at dh=128 in float32 one 512-row operand is 256 KB, more than a
// block's 227 KB of shared memory.  So keys and queries are tiled, which
// serves any T and makes the same three kernels the counterparts of the
// single-block and the multi-block Pallas backward alike:
//   delta_kernel  one warp per query row: delta = sum(dO * O).
//   dkv_kernel    a block owns 32 keys of one (batch, head) and walks the
//                 query tiles of 32 rows.  Phase A: each lane owns one key,
//                 each warp 8 rows; s and dp come from float4 K/V rows of a
//                 padded tile (stride dh+4, conflict-free) against broadcast
//                 Q/dO rows, and pd and ds go to shared memory.  Phase B:
//                 each warp owns 8 keys, each lane dh/32 columns of the dK
//                 and dV accumulators (64 registers at dh=128).
//   dq_kernel     a block owns 32 query rows and walks the key tiles of 64,
//                 as the forward does: s and dp per (row, key), ds through a
//                 per-warp shared buffer, then dQ += ds K with each lane
//                 owning dh/32 columns.
// The dQ kernel recomputes QK^T and dO V^T: 7 products in all against the
// 5 of the bound.  Simple SIMT float32 FMAs: `wgmma` has no float32 mode and
// TF32 would not hold the float32 reference's tolerances.
#include <cuda_runtime.h>
#include <math.h>

#include "dropout_hash.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

// dq_kernel tiles (the forward's).
constexpr int kQRowsPerWarp = 8;
constexpr int kQBlock = kWarps * kQRowsPerWarp;  // 32 query rows per block
constexpr int kQKeys = 64;                       // keys per shared tile

// dkv_kernel tiles.
constexpr int kKBlock = 32;                      // keys per block
constexpr int kKRowsPerWarp = 8;                 // phase A rows per warp
constexpr int kKQTile = kWarps * kKRowsPerWarp;  // 32 query rows per tile
constexpr int kKKeysPerWarp = kKBlock / kWarps;  // phase B keys per warp

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const float* o;
  const float* dout;
  const float* lse;
  float* delta;
  float* dq;
  float* dk;
  float* dv;
  int H, Tq, Tk;
  // (batch, head, time) strides of q, k, v, o, dO, dQ, dK, dV.
  long long sq[3], sk[3], sv[3], so[3], sdo[3], sdq[3], sdk[3], sdv[3];
  float scale;
  float keep;  // 1 - rate
  DropoutHash drop;
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ const float* head(const float* base,
                                             const long long* s, int b,
                                             int h) {
  return base + b * s[0] + h * s[1];
}

__device__ __forceinline__ float* head(float* base, const long long* s, int b,
                                       int h) {
  return base + b * s[0] + h * s[1];
}

// Rows [t0, t0 + rows) of a (T, DH) operand into a shared tile of stride
// `ld`, zero past T.
template <int DH>
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src,
                                          long long st, int t0, int rows,
                                          int T) {
  constexpr int kV4 = DH / 4;
  for (int i = threadIdx.x; i < rows * kV4; i += kThreads) {
    const int r = i / kV4, c = (i % kV4) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t0 + r < T) val = ld4(src + (t0 + r) * st + c);
    st4(dst + r * ld + c, val);
  }
}

// kCols consecutive floats from shared memory (float4 when kCols == 4).
template <int kCols>
__device__ __forceinline__ void ld_cols(const float* p, float (&out)[kCols]) {
  if constexpr (kCols == 4) {
    const float4 t = ld4(p);
    out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
  } else {
#pragma unroll
    for (int c = 0; c < kCols; ++c) out[c] = p[c];
  }
}

template <int kCols>
__device__ __forceinline__ void st_cols(float* p, const float (&in)[kCols]) {
  if constexpr (kCols == 4) {
    st4(p, make_float4(in[0], in[1], in[2], in[3]));
  } else {
#pragma unroll
    for (int c = 0; c < kCols; ++c) p[c] = in[c];
  }
}

__device__ __forceinline__ float f4(float4 v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// ---------------------------------------------------------------------------
// delta = rowsum(dO * O): one warp per query row.
// ---------------------------------------------------------------------------
template <int DH>
__global__ void __launch_bounds__(kThreads) delta_kernel(const Params p) {
  const int lane = threadIdx.x & 31;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int t = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (t >= p.Tq) return;
  const float* orow = head(p.o, p.so, b, h) + t * p.so[2];
  const float* drow = head(p.dout, p.sdo, b, h) + t * p.sdo[2];
  float acc = 0.f;
#pragma unroll
  for (int d = lane; d < DH; d += 32) acc = fmaf(drow[d], orow[d], acc);
  acc = warp_sum(acc);
  if (lane == 0) p.delta[(long long)bh * p.Tq + t] = acc;
}

// ---------------------------------------------------------------------------
// dK, dV: a block owns kKBlock keys and walks the query tiles.
// ---------------------------------------------------------------------------
template <int DH>
struct DkvLayout {
  static constexpr int kS = DH + 4;      // operand row stride (floats)
  static constexpr int kPS = kKBlock;    // pd / ds row stride
  static constexpr size_t kFloats = 2 * kKBlock * kS + 2 * kKQTile * kS +
                                    2 * kKQTile * kPS + 2 * kKQTile;
  static constexpr size_t kBytes = kFloats * sizeof(float);
};

template <int DH>
__global__ void __launch_bounds__(kThreads) dkv_kernel(const Params p) {
  using L = DkvLayout<DH>;
  constexpr int kCols = DH / 32;
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);
  float* sV = sK + kKBlock * L::kS;
  float* sQ = sV + kKBlock * L::kS;
  float* sO = sQ + kKQTile * L::kS;  // dO rows
  float* sP = sO + kKQTile * L::kS;  // pd (dropout-scaled p)
  float* sD = sP + kKQTile * L::kPS;  // ds
  float* sLse = sD + kKQTile * L::kPS;
  float* sDelta = sLse + kKQTile;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int k0 = blockIdx.x * kKBlock;

  load_rows<DH>(sK, L::kS, head(p.k, p.sk, b, h), p.sk[2], k0, kKBlock, p.Tk);
  load_rows<DH>(sV, L::kS, head(p.v, p.sv, b, h), p.sv[2], k0, kKBlock, p.Tk);
  const float* qb = head(p.q, p.sq, b, h);
  const float* ob = head(p.dout, p.sdo, b, h);
  const float* lse = p.lse + (long long)bh * p.Tq;
  const float* delta = p.delta + (long long)bh * p.Tq;

  float acc_k[kKKeysPerWarp][kCols];
  float acc_v[kKKeysPerWarp][kCols];
#pragma unroll
  for (int kk = 0; kk < kKKeysPerWarp; ++kk)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc_k[kk][c] = acc_v[kk][c] = 0.f;

  const int key = k0 + lane;  // phase A: this lane's key
  const bool key_ok = key < p.Tk;
  const float* kr = sK + lane * L::kS;
  const float* vr = sV + lane * L::kS;
  const int n_tiles = (p.Tq + kKQTile - 1) / kKQTile;

  for (int qt = 0; qt < n_tiles; ++qt) {
    const int t0 = qt * kKQTile;
    __syncthreads();  // the previous tile is consumed
    load_rows<DH>(sQ, L::kS, qb, p.sq[2], t0, kKQTile, p.Tq);
    load_rows<DH>(sO, L::kS, ob, p.sdo[2], t0, kKQTile, p.Tq);
    if (tid < kKQTile) {
      const bool ok = t0 + tid < p.Tq;
      sLse[tid] = ok ? lse[t0 + tid] : 0.f;
      sDelta[tid] = ok ? delta[t0 + tid] : 0.f;
    }
    __syncthreads();

    // Phase A: s = q.k and dp = dO.v for this lane's key and the warp's rows.
    float s[kKRowsPerWarp], dp[kKRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kKRowsPerWarp; ++r) s[r] = dp[r] = 0.f;
    const float* qw = sQ + warp * kKRowsPerWarp * L::kS;
    const float* ow = sO + warp * kKRowsPerWarp * L::kS;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      const float4 x = ld4(kr + d);
      const float4 y = ld4(vr + d);
#pragma unroll
      for (int r = 0; r < kKRowsPerWarp; ++r) {
        s[r] = dot4(ld4(qw + r * L::kS + d), x, s[r]);
        dp[r] = dot4(ld4(ow + r * L::kS + d), y, dp[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kKRowsPerWarp; ++r) {
      const int row = warp * kKRowsPerWarp + r;
      const int t = t0 + row;
      const float pr =
          (key_ok && t < p.Tq) ? expf(s[r] * p.scale - sLse[row]) : 0.f;
      float pd = pr, dpr = dp[r];
      if (p.drop.on) {
        const bool keep = hash_keep(p.drop, hash_row(p.drop, bh, t), key);
        pd = keep ? pr / p.keep : 0.f;
        dpr = keep ? dpr / p.keep : 0.f;
      }
      sP[row * L::kPS + lane] = pd;
      sD[row * L::kPS + lane] = pr * (dpr - sDelta[row]) * p.scale;
    }
    __syncthreads();

    // Phase B: dV += pd^T dO, dK += ds^T Q for the warp's keys.
#pragma unroll 2
    for (int row = 0; row < kKQTile; ++row) {
      float dov[kCols], qv[kCols];
      ld_cols<kCols>(sO + row * L::kS + lane * kCols, dov);
      ld_cols<kCols>(sQ + row * L::kS + lane * kCols, qv);
      const float* prow = sP + row * L::kPS + warp * kKKeysPerWarp;
      const float* drow = sD + row * L::kPS + warp * kKKeysPerWarp;
#pragma unroll
      for (int k4 = 0; k4 < kKKeysPerWarp; k4 += 4) {
        const float4 pv = ld4(prow + k4);
        const float4 dv = ld4(drow + k4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pw = f4(pv, i), dw = f4(dv, i);
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            acc_v[k4 + i][c] = fmaf(pw, dov[c], acc_v[k4 + i][c]);
            acc_k[k4 + i][c] = fmaf(dw, qv[c], acc_k[k4 + i][c]);
          }
        }
      }
    }
  }

  float* dkb = head(p.dk, p.sdk, b, h);
  float* dvb = head(p.dv, p.sdv, b, h);
#pragma unroll
  for (int kk = 0; kk < kKKeysPerWarp; ++kk) {
    const int kt = k0 + warp * kKKeysPerWarp + kk;
    if (kt >= p.Tk) continue;
    st_cols<kCols>(dkb + kt * p.sdk[2] + lane * kCols, acc_k[kk]);
    st_cols<kCols>(dvb + kt * p.sdv[2] + lane * kCols, acc_v[kk]);
  }
}

// ---------------------------------------------------------------------------
// dQ: a block owns kQBlock query rows and walks the key tiles.
// ---------------------------------------------------------------------------
template <int DH>
struct DqLayout {
  static constexpr int kS = DH + 4;         // operand row stride (floats)
  static constexpr int kDS = kQKeys + 4;    // ds row stride
  static constexpr size_t kFloats =
      2 * kQBlock * kS + 2 * kQKeys * kS + kQBlock * kDS;
  static constexpr size_t kBytes = kFloats * sizeof(float);
};

template <int DH>
__global__ void __launch_bounds__(kThreads) dq_kernel(const Params p) {
  using L = DqLayout<DH>;
  constexpr int kCols = DH / 32;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sO = sQ + kQBlock * L::kS;  // dO rows
  float* sK = sO + kQBlock * L::kS;
  float* sV = sK + kQKeys * L::kS;
  float* sDS = sV + kQKeys * L::kS;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x * kQBlock;

  load_rows<DH>(sQ, L::kS, head(p.q, p.sq, b, h), p.sq[2], q0, kQBlock, p.Tq);
  load_rows<DH>(sO, L::kS, head(p.dout, p.sdo, b, h), p.sdo[2], q0, kQBlock,
                p.Tq);
  const float* kb = head(p.k, p.sk, b, h);
  const float* vb = head(p.v, p.sv, b, h);

  float lse_r[kQRowsPerWarp], delta_r[kQRowsPerWarp];
  float acc[kQRowsPerWarp][kCols];
#pragma unroll
  for (int r = 0; r < kQRowsPerWarp; ++r) {
    const int t = q0 + warp * kQRowsPerWarp + r;
    const bool ok = t < p.Tq;
    lse_r[r] = ok ? p.lse[(long long)bh * p.Tq + t] : 0.f;
    delta_r[r] = ok ? p.delta[(long long)bh * p.Tq + t] : 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }

  const float* qw = sQ + warp * kQRowsPerWarp * L::kS;
  const float* ow = sO + warp * kQRowsPerWarp * L::kS;
  float* dsw = sDS + warp * kQRowsPerWarp * L::kDS;
  const int n_tiles = (p.Tk + kQKeys - 1) / kQKeys;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kQKeys;
    __syncthreads();  // the previous tile is consumed; Q/dO are visible
    load_rows<DH>(sK, L::kS, kb, p.sk[2], k0, kQKeys, p.Tk);
    load_rows<DH>(sV, L::kS, vb, p.sv[2], k0, kQKeys, p.Tk);
    __syncthreads();

    // s and dp for the warp's rows; lane owns keys lane and lane + 32.
    float s[kQRowsPerWarp][2], dp[kQRowsPerWarp][2];
#pragma unroll
    for (int r = 0; r < kQRowsPerWarp; ++r)
      s[r][0] = s[r][1] = dp[r][0] = dp[r][1] = 0.f;
    const float* ka = sK + lane * L::kS;
    const float* kc = sK + (lane + 32) * L::kS;
    const float* va = sV + lane * L::kS;
    const float* vc = sV + (lane + 32) * L::kS;
#pragma unroll 2
    for (int d = 0; d < DH; d += 4) {
      const float4 x = ld4(ka + d), y = ld4(kc + d);
      const float4 vx = ld4(va + d), vy = ld4(vc + d);
#pragma unroll
      for (int r = 0; r < kQRowsPerWarp; ++r) {
        const float4 qv = ld4(qw + r * L::kS + d);
        const float4 ov = ld4(ow + r * L::kS + d);
        s[r][0] = dot4(qv, x, s[r][0]);
        s[r][1] = dot4(qv, y, s[r][1]);
        dp[r][0] = dot4(ov, vx, dp[r][0]);
        dp[r][1] = dot4(ov, vy, dp[r][1]);
      }
    }

    const bool ok_a = k0 + lane < p.Tk;
    const bool ok_b = k0 + lane + 32 < p.Tk;
#pragma unroll
    for (int r = 0; r < kQRowsPerWarp; ++r) {
      const float pa = ok_a ? expf(s[r][0] * p.scale - lse_r[r]) : 0.f;
      const float pb = ok_b ? expf(s[r][1] * p.scale - lse_r[r]) : 0.f;
      float dpa = dp[r][0], dpb = dp[r][1];
      if (p.drop.on) {
        const HashRow hr =
            hash_row(p.drop, bh, q0 + warp * kQRowsPerWarp + r);
        dpa = hash_keep(p.drop, hr, k0 + lane) ? dpa / p.keep : 0.f;
        dpb = hash_keep(p.drop, hr, k0 + lane + 32) ? dpb / p.keep : 0.f;
      }
      dsw[r * L::kDS + lane] = pa * (dpa - delta_r[r]) * p.scale;
      dsw[r * L::kDS + lane + 32] = pb * (dpb - delta_r[r]) * p.scale;
    }
    __syncwarp();

    // dQ += ds K; lane owns columns [lane * kCols, lane * kCols + kCols).
#pragma unroll 2
    for (int j = 0; j < kQKeys; j += 4) {
      float4 dj[kQRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kQRowsPerWarp; ++r) dj[r] = ld4(dsw + r * L::kDS + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float kv[kCols];
        ld_cols<kCols>(sK + (j + jj) * L::kS + lane * kCols, kv);
#pragma unroll
        for (int r = 0; r < kQRowsPerWarp; ++r) {
          const float w = f4(dj[r], jj);
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(w, kv[c], acc[r][c]);
        }
      }
    }
    __syncwarp();
  }

  float* dqb = head(p.dq, p.sdq, b, h);
#pragma unroll
  for (int r = 0; r < kQRowsPerWarp; ++r) {
    const int t = q0 + warp * kQRowsPerWarp + r;
    if (t >= p.Tq) continue;
    st_cols<kCols>(dqb + t * p.sdq[2] + lane * kCols, acc[r]);
  }
}

template <typename Kernel>
cudaError_t launch_one(Kernel kernel, dim3 grid, size_t smem,
                       cudaStream_t stream, const Params& p) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const int bh = B * p.H;
  cudaError_t err = launch_one(delta_kernel<DH>,
                               dim3((p.Tq + kWarps - 1) / kWarps, bh), 0,
                               stream, p);
  if (err != cudaSuccess) return err;
  err = launch_one(dkv_kernel<DH>, dim3((p.Tk + kKBlock - 1) / kKBlock, bh),
                   DkvLayout<DH>::kBytes, stream, p);
  if (err != cudaSuccess) return err;
  return launch_one(dq_kernel<DH>, dim3((p.Tq + kQBlock - 1) / kQBlock, bh),
                    DqLayout<DH>::kBytes, stream, p);
}

}  // namespace

extern "C" int avsep_flash_attn_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int H, int Tq, int Tk, int dh,
    const long long* strides,  // 3 each for q, k, v, o, dO, dQ, dK, dV
    float scale, float keep, unsigned threshold, unsigned seed, int hq,
    int hk, int dropout, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.o = static_cast<const float*>(o);
  p.dout = static_cast<const float*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.dq = static_cast<float*>(dq);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  p.H = H; p.Tq = Tq; p.Tk = Tk;
  long long* dst[8] = {p.sq, p.sk, p.sv, p.so, p.sdo, p.sdq, p.sdk, p.sdv};
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 3; ++j) dst[i][j] = strides[3 * i + j];
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
