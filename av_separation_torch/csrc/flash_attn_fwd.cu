// Flash attention forward in float32 on the tensor cores in 3xTF32, for
// Hopper (sm_90a).  (bfloat16 runs on flash_fwd_wgmma.cu at every head dim.)
//
// Replaces: av_separation_tpu/ops/pallas/attention.py `_fwd_hpacked_kernel`
// (packed (B, T, H*dh) layout, called from `_flash_hpacked_call`),
// `_fwd_packed_kernel` (split (B*H, T, dh) layout, `_flash_packed_call`)
// and the multi-block `_fwd_kernel` (Tk > 512, `_flash_call`).  One kernel
// serves all three: q/k/v/o are addressed through (batch, head, time)
// strides with the head dim contiguous, and the keys are always streamed in
// tiles, so Tk has no cap.
//
// Computes O = softmax(Q K^T * scale) V per (batch, head) and the row
// logsumexp lse = m + log(l) in float32, as the Pallas kernels emit it.
// Attention dropout as in `_fwd_hpacked_kernel` (attention.py:389-398): l
// sums the undropped p, dropped p are zeroed before PV, and
// o = acc / (l * (1 - rate)); the keep test is the Pallas hash
// (dropout_hash.cuh), keyed by (row, key) and the Pallas tile sizes, not by
// this kernel's tiles, so the backward kernels regenerate the same mask.
//
// Bound on the H100 at the scaled serving shapes (B=8, H=4, dh=128):
// audio self-attention (Tq = Tk = 501) is 4*B*H*Tq*Tk*dh = 4.1 GFLOP of
// float32 products against 33 MB of q/k/v/o.  Float32 products at float32
// accuracy run on the tensor cores in 3xTF32 (three TF32 products each), at
// 495/3 = 165 TFLOP/s: 25 us, against 10 us of bytes, so bound by
// operations.  In bfloat16 the same 4.1 GFLOP take 4.2 us at 989 TFLOP/s
// against 4.9 us for the 16 MB of bf16 q/k/v/o: bound by bytes.
//
// Design:
// - Products.  Both QK^T and PV are mma.sync.m16n8k8 TF32 products in
//   3xTF32, CUTLASS's OpMultiplyAddFastF32 (the route of SDPA's float32
//   kernel): each operand x splits into a TF32 big part and a TF32 small
//   part (`split` in mma_3xtf32.cuh), and the sum takes small*big +
//   big*small + big*big.  1xTF32 (10 mantissa bits) would not hold the
//   float32 reference's 2e-5; `wgmma` in TF32 needs K-major operands, and
//   V as the B operand of PV is not.
// - Tiles.  Each warp owns 16 query rows of one (batch, head), and a block
//   64 rows (4 row warps).  Keys come in 32-key tiles through a 2-stage
//   ring of cp.async 16-byte copies (src-size 0 zero-fills keys past Tk),
//   so the copy of stage j+1 runs under the products of stage j.  When the
//   grid has more blocks than SMs (audio self-attention and fusion: 256),
//   a block is 4 warps and 101 KB of shared memory at dh 128, 2 blocks an
//   SM.  When it has at most one a SM (visual self-attention at T 200 and
//   the long T 1024 shape: 128 blocks), a block is 8 warps: two groups of 4
//   take alternate 32-key tiles of each 64-key stage (169 KB), and the
//   second group hands its (m, l, O) to the first, which merges them.  A
//   finer row tile would not help there: 6,400 rows over 132 SMs still
//   leave some SM 64 rows.  The score tile S (16 x 32) and the O
//   accumulator (16 x dh) live in registers; the online softmax runs on
//   the fragments, a row's max over the four lanes that share it; l is
//   summed per lane and reduced once at the end.
// - P into PV without a shuffle.  The m16n8k8 fragments (lane = 4g + t):
//   A holds (g, t), (g+8, t), (g, t+4), (g+8, t+4); B holds (k=t, n=g),
//   (k=t+4, n=g); C holds (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1).  The
//   keys of PV are a sum, so their order is free: A's k = t and k = t+4
//   stand for keys 2t and 2t+1, which is where S's C fragment already has
//   them, and V's B fragment reads key rows 2t and 2t+1 to match.
// - Bank conflicts.  Q, K and V rows are dh+4 floats apart: the A loads of
//   Q and the B loads of K hit bank 4g + t, the B loads of V (rows 2t,
//   2t+1) bank 8t + g (+4): 32 distinct banks per load.
// - Head dims in (128, 256] (`flash_fwd_kernel_pair`): dh is zero-padded
//   to 256 by the wrapper.  One 8-warp block owns 64 rows, warps w and
//   w + 4 the same 16 rows and one 128-column half each (Q, K and V
//   staged at full width): each warp computes its partial S over its 128
//   columns, the two add each other's through the block's shared memory
//   at a named barrier of 64 threads (no distributed shared memory, no
//   cluster barrier), and each takes P V over its own 128 columns of V,
//   so a warp holds the O accumulators of dh 128: 4 chunk products a tile
//   pair (the column split it replaces, a block a 128-column group
//   recomputing the whole S, took 6).  211 KB of shared memory, one
//   8-warp block an SM.
// - Head dims above 256 (any multiple of 128,
//   `flash_fwd_kernel_cluster`): full-width Q and K tiles no longer fit a
//   block, so a thread-block cluster of nc = dh / 128 blocks (grid z,
//   cluster dims (1, 1, nc); cluster.cuh) shares 64 query rows, block c
//   holding chunk c of Q, K, V and O (above dh 2048, where a cluster
//   cannot hold nc blocks, block r owns chunks r, r + C, ... of a cluster
//   of C: their partials added to its own, their O accumulators in a
//   scratch buffer, their operands read from global memory).  Each block
//   computes its partial S_c = Q_c K_c^T for a 32-key tile, the cluster
//   sums the nc partials in block order through distributed shared memory
//   (one cluster barrier a tile), and each block runs the same softmax
//   and O_c += P V_c: 2 nc
//   chunk products a tile pair, none computed twice (the chunked kernel
//   it replaces took nc (nc + 1), re-reading Q from L2 for every tile).
//   101 KB of shared memory a block, two blocks an SM: Q_c and a 2-stage
//   ring of K_c / V_c tiles, the partials in the consumed K_c tile.
// - Output.  Each warp writes its O rows into its own (now unused) Q rows
//   of shared memory and stores them as 16-byte row chunks, packed
//   (B, T, H, dh) memory through the o strides.
#include <cuda_runtime.h>
#include <math.h>

#include "chunk_frags.cuh"
#include "cluster.cuh"
#include "dropout_hash.cuh"
#include "grid_fold.cuh"
#include "mma_3xtf32.cuh"
#include "mma_bf16.cuh"  // load_tile, store2
#include "device_guard.cuh"

namespace {

constexpr int kRowWarps = 4;              // warps over the query rows
constexpr int kBlockQ = 16 * kRowWarps;   // 64 query rows per block
constexpr int kBlockK = 32;               // keys per warp per tile
constexpr int kGroup = 128;  // columns of a half (dh 256) or chunk (above)

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int H, Tq, Tk;
  long long sqb, sqh, sqt;
  long long skb, skh, skt;
  long long svb, svh, svt;
  long long sob, soh, sot;
  float scale;
  float keep;  // 1 - rate
  DropoutHash drop;
  int nc;          // column chunks above dh 256 (cluster.cuh)
  float* scratch;  // the accumulators of a block's chunks after its first
};

// D: the head dim (32, 64 or 128).  SPLIT warp groups of 4 share the
// block's 64 rows and take SPLIT consecutive 32-key tiles of each stage,
// one each.
template <int D, int SPLIT>
struct Layout {
  static constexpr int kThreads = 32 * kRowWarps * SPLIT;
  static constexpr int kS = D + 4;  // row stride of the Q, K and V tiles
  static constexpr int kKeys = kBlockK * SPLIT;  // keys per stage
  static constexpr int kQ = kBlockQ * kS;
  static constexpr int kK = kKeys * kS;
  static constexpr int kStage = 2 * kK;  // K rows, then V rows
  static constexpr size_t kBytes = (kQ + 2 * kStage) * sizeof(float);
  // The split block's hand-over (O fragments, m and l of the second
  // group) goes through the idle ring.
  static_assert(SPLIT == 1 || 2 * kStage >=
                kRowWarps * (32 * 4 * (D / 8) + 4 * 32),
                "hand-over does not fit the ring");
};

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int D, int SPLIT>
__global__ void __launch_bounds__(Layout<D, SPLIT>::kThreads, 3 - SPLIT)
flash_fwd_kernel(const Params p) {
  using L = Layout<D, SPLIT>;
  constexpr int kS = L::kS;
  constexpr int kThreads = L::kThreads;
  constexpr int kDN = D / 8;        // 8-wide column tiles of O
  constexpr int kKN = kBlockK / 8;  // 8-key tiles of S
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sKV = sQ + L::kQ;  // stage s: K at sKV + s kStage, V after it

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rw = warp % kRowWarps;  // which 16 rows
  const int part = warp / kRowWarps;  // which 32-key tile of a stage
  const int g = lane >> 2, t = lane & 3;
  const TileOf at = unfold((p.Tq + kBlockQ - 1) / kBlockQ);
  const int bh = at.pair;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int q0 = at.tile * kBlockQ;

  const float* qb = static_cast<const float*>(p.q) + b * p.sqb + h * p.sqh;
  const float* kb = static_cast<const float*>(p.k) + b * p.skb + h * p.skh;
  const float* vb = static_cast<const float*>(p.v) + b * p.svb + h * p.svh;
  const int n_stages = (p.Tk + L::kKeys - 1) / L::kKeys;

  load_tile<float, D, kS, kBlockQ, kThreads>(sQ, qb, p.sqt, q0, p.Tq, tid);
  load_tile<float, D, kS, L::kKeys, kThreads>(sKV, kb, p.skt, 0, p.Tk,
                                               tid);
  load_tile<float, D, kS, L::kKeys, kThreads>(sKV + L::kK, vb, p.svt, 0,
                                               p.Tk, tid);
  cp_async_commit();

  float o[kDN][4];
#pragma unroll
  for (int n = 0; n < kDN; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // rows g and g + 8
  float l0 = 0.f, l1 = 0.f;              // this lane's part of the row sums
  const int row0 = q0 + rw * 16 + g;
  HashRow hr0 = {0u, 0u}, hr1 = {0u, 0u};
  if (p.drop.on) {
    hr0 = hash_row(p.drop, bh, row0);
    hr1 = hash_row(p.drop, bh, row0 + 8);
  }
  const float* qw = sQ + rw * 16 * kS;

  for (int j = 0; j < n_stages; ++j) {
    if (j + 1 < n_stages) {
      float* next = sKV + ((j + 1) & 1) * L::kStage;
      const int r0 = (j + 1) * L::kKeys;
      load_tile<float, D, kS, L::kKeys, kThreads>(next, kb, p.skt, r0,
                                                   p.Tk, tid);
      load_tile<float, D, kS, L::kKeys, kThreads>(next + L::kK, vb, p.svt,
                                                   r0, p.Tk, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = j * L::kKeys + part * kBlockK;
    const float* sK = sKV + (j & 1) * L::kStage + part * kBlockK * kS;
    const float* sV =
        sKV + (j & 1) * L::kStage + L::kK + part * kBlockK * kS;

    if (k0 < p.Tk) {
      // S = Q K^T for this warp's 16 rows and its 32 keys.
      float s[kKN][4];
#pragma unroll
      for (int n = 0; n < kKN; ++n)
        s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll 4
      for (int kk = 0; kk < D / 8; ++kk) {
        unsigned ab[4], as[4];
        load_a_frag(qw + kk * 8, kS, g, t, ab, as);
#pragma unroll
        for (int n = 0; n < kKN; ++n) {
          const float* kr = sK + (n * 8 + g) * kS + kk * 8 + t;
          unsigned bb[2], bs[2];
          split(kr[0], bb[0], bs[0]);
          split(kr[4], bb[1], bs[1]);
          mma_3xtf32(s[n], ab, as, bb, bs);
        }
      }

      // Online softmax on the fragments; keys past Tk score -inf, weigh 0.
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int n = 0; n < kKN; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool valid = k0 + n * 8 + 2 * t + e < p.Tk;
          s[n][e] = valid ? s[n][e] * p.scale : -INFINITY;
          s[n][2 + e] = valid ? s[n][2 + e] * p.scale : -INFINITY;
          mx0 = fmaxf(mx0, s[n][e]);
          mx1 = fmaxf(mx1, s[n][2 + e]);
        }
      }
      mx0 = quad_max(mx0);
      mx1 = quad_max(mx1);
      const float alpha0 = expf(m0 - mx0), alpha1 = expf(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      l0 *= alpha0;
      l1 *= alpha1;
#pragma unroll
      for (int n = 0; n < kKN; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float p0 = expf(s[n][e] - m0);
          float p1 = expf(s[n][2 + e] - m1);
          l0 += p0;
          l1 += p1;
          if (p.drop.on) {
            const int key = k0 + n * 8 + 2 * t + e;
            if (!hash_keep(p.drop, hr0, key)) p0 = 0.f;
            if (!hash_keep(p.drop, hr1, key)) p1 = 0.f;
          }
          s[n][e] = p0;
          s[n][2 + e] = p1;
        }
      }
#pragma unroll
      for (int n = 0; n < kDN; ++n) {
        o[n][0] *= alpha0;
        o[n][1] *= alpha0;
        o[n][2] *= alpha1;
        o[n][3] *= alpha1;
      }

      // O += P V: A's k = t, t + 4 are keys 2t, 2t + 1 of each 8-key
      // tile.
#pragma unroll
      for (int n = 0; n < kKN; ++n) {
        unsigned ab[4], as[4];
        split(s[n][0], ab[0], as[0]);
        split(s[n][2], ab[1], as[1]);
        split(s[n][1], ab[2], as[2]);
        split(s[n][3], ab[3], as[3]);
        const float* vr = sV + (n * 8 + 2 * t) * kS + g;
#pragma unroll
        for (int dn = 0; dn < kDN; ++dn) {
          unsigned bb[2], bs[2];
          split(vr[dn * 8], bb[0], bs[0]);
          split(vr[kS + dn * 8], bb[1], bs[1]);
          mma_3xtf32(o[dn], ab, as, bb, bs);
        }
      }

    }
    __syncthreads();  // the stage just read is the next copy's target
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  if (SPLIT == 2) {
    // The second group hands its O fragments, m and l over through the idle
    // ring; the first merges them: m = max of the two, each side rescaled
    // by exp(m_side - m).  A group that saw no key has m = -inf, l = 0.
    constexpr int kX = 32 * 4 * kDN;
    float* xo = reinterpret_cast<float*>(sKV) + rw * (kX + 4 * 32);
    if (part == 1) {
#pragma unroll
      for (int n = 0; n < kDN; ++n)
        *reinterpret_cast<float4*>(xo + (n * 32 + lane) * 4) =
            make_float4(o[n][0], o[n][1], o[n][2], o[n][3]);
      xo[kX + lane] = m0;
      xo[kX + 32 + lane] = m1;
      xo[kX + 64 + lane] = l0;
      xo[kX + 96 + lane] = l1;
    }
    __syncthreads();
    if (part == 1) return;
    const float pm0 = xo[kX + lane], pm1 = xo[kX + 32 + lane];
    const float mn0 = fmaxf(m0, pm0), mn1 = fmaxf(m1, pm1);
    const float a0 = expf(m0 - mn0), a1 = expf(m1 - mn1);
    const float c0 = expf(pm0 - mn0), c1 = expf(pm1 - mn1);
#pragma unroll
    for (int n = 0; n < kDN; ++n) {
      const float4 x =
          *reinterpret_cast<const float4*>(xo + (n * 32 + lane) * 4);
      o[n][0] = o[n][0] * a0 + x.x * c0;
      o[n][1] = o[n][1] * a0 + x.y * c0;
      o[n][2] = o[n][2] * a1 + x.z * c1;
      o[n][3] = o[n][3] * a1 + x.w * c1;
    }
    l0 = l0 * a0 + xo[kX + 64 + lane] * c0;
    l1 = l1 * a1 + xo[kX + 96 + lane] * c1;
    m0 = mn0;
    m1 = mn1;
  }

  const float inv0 = 1.f / (l0 * p.keep), inv1 = 1.f / (l1 * p.keep);
  // This warp's Q rows are its alone: stage O there, then store 16-byte
  // row chunks.
  float* ow = sQ + rw * 16 * kS;
#pragma unroll
  for (int n = 0; n < kDN; ++n) {
    store2(ow + g * kS + n * 8 + 2 * t, o[n][0] * inv0, o[n][1] * inv0);
    store2(ow + (g + 8) * kS + n * 8 + 2 * t, o[n][2] * inv1,
           o[n][3] * inv1);
  }
  __syncwarp();
  float* ob = static_cast<float*>(p.o) + b * p.sob + h * p.soh;
  constexpr int kChunks = D / 4;
#pragma unroll 4
  for (int i = lane; i < 16 * kChunks; i += 32) {
    const int r = i / kChunks, c = (i % kChunks) * 4;
    const int row = q0 + rw * 16 + r;
    if (row < p.Tq)
      *reinterpret_cast<float4*>(ob + row * p.sot + c) =
          *reinterpret_cast<const float4*>(ow + r * kS + c);
  }
  if (t == 0) {
    if (row0 < p.Tq) p.lse[(long long)bh * p.Tq + row0] = m0 + logf(l0);
    if (row0 + 8 < p.Tq)
      p.lse[(long long)bh * p.Tq + row0 + 8] = m1 + logf(l1);
  }
}

// cudaFuncSetAttribute (the dynamic shared memory a block takes) once per
// kernel instance (`done`: one bit a device) and device.
template <typename Kernel>
cudaError_t set_smem_once(Kernel kernel, size_t bytes, unsigned* done) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess || (*done & (1u << (device & 31)))) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess) *done |= 1u << (device & 31);
  return err;
}

// Head dim 256 (any dh in (128, 256], zero-padded by the wrapper): one
// 8-warp block owns 64 query rows, warps w and w + 4 (half 0 and half 1)
// the same 16 rows, half c columns [128 c, 128 c + 128) of Q, K, V and O.
// For each 32-key tile each warp computes its partial S_c = Q_c K_c^T over
// its 128 columns, stores it, and meets its partner at named barrier
// 1 + w (`pair_sync`); both then hold S = S_0 + S_1 (`pair_sum`, the same
// float in both), run the same online softmax and take O_c += P V_c over
// their own columns: 4 chunk products a tile pair, none repeated.  Q and
// a 2-stage cp.async ring of 32-key K and V tiles at full width, and the
// partials, in 211 KB: one block, 8 warps an SM.
struct PairLayout {
  static constexpr int kThreads = 2 * 32 * kRowWarps;
  static constexpr int kS = 2 * kGroup + 4;           // float row stride
  static constexpr int kQ = kBlockQ * kS;
  static constexpr int kKV = kBlockK * kS;            // K or V of a tile
  static constexpr int kStage = 2 * kKV;              // K, then V
  static constexpr int kKN = kBlockK / 8;             // 8-key tiles of S
  static constexpr int kX = 2 * kRowWarps * kKN * 32 * 4;  // partials
  static constexpr size_t kBytes = (kQ + 2 * kStage + kX) * sizeof(float);
  static_assert(kBytes <= 232448, "shared memory");
};

__global__ void __launch_bounds__(PairLayout::kThreads, 1)
flash_fwd_kernel_pair(const Params p) {
  using L = PairLayout;
  constexpr int kS = L::kS;
  constexpr int kThreads = L::kThreads;
  constexpr int kDN = kGroup / 8;
  constexpr int kKN = L::kKN;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sKV = sQ + L::kQ;  // stage s: K at sKV + s kStage, V after it
  float* sX = sKV + 2 * L::kStage;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rw = warp % kRowWarps;    // which 16 rows
  const int half = warp / kRowWarps;  // which 128 columns
  const int g = lane >> 2, t = lane & 3;
  const int col0 = half * kGroup;
  const TileOf at = unfold((p.Tq + kBlockQ - 1) / kBlockQ);
  const int bh = at.pair;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int q0 = at.tile * kBlockQ;
  constexpr int kW = 2 * kGroup;
  const float* kb = static_cast<const float*>(p.k) + b * p.skb + h * p.skh;
  const float* vb = static_cast<const float*>(p.v) + b * p.svb + h * p.svh;
  const int n_tiles = (p.Tk + kBlockK - 1) / kBlockK;

  load_tile<float, kW, kS, kBlockQ, kThreads>(
      sQ, static_cast<const float*>(p.q) + b * p.sqb + h * p.sqh, p.sqt, q0,
      p.Tq, tid);
  load_tile<float, kW, kS, kBlockK, kThreads>(sKV, kb, p.skt, 0, p.Tk, tid);
  load_tile<float, kW, kS, kBlockK, kThreads>(sKV + L::kKV, vb, p.svt, 0,
                                              p.Tk, tid);
  cp_async_commit();

  float o[kDN][4];
#pragma unroll
  for (int n = 0; n < kDN; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;
  float l0 = 0.f, l1 = 0.f;
  const int row0 = q0 + rw * 16 + g;
  HashRow hr0 = {0u, 0u}, hr1 = {0u, 0u};
  if (p.drop.on) {
    hr0 = hash_row(p.drop, bh, row0);
    hr1 = hash_row(p.drop, bh, row0 + 8);
  }
  const float* qw = sQ + rw * 16 * kS + col0;
  // This warp's partials and its partner's: float4 (n, lane) of each.
  float* xw = sX + (half * kRowWarps + rw) * kKN * 32 * 4;
  const float* xp = sX + ((1 - half) * kRowWarps + rw) * kKN * 32 * 4;

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      float* next = sKV + ((j + 1) & 1) * L::kStage;
      const int r0 = (j + 1) * kBlockK;
      load_tile<float, kW, kS, kBlockK, kThreads>(next, kb, p.skt, r0, p.Tk,
                                                  tid);
      load_tile<float, kW, kS, kBlockK, kThreads>(next + L::kKV, vb, p.svt,
                                                  r0, p.Tk, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* sK = sKV + (j & 1) * L::kStage + col0;
    const float* sV = sK + L::kKV;

    // The partial S_c = Q_c K_c^T of this warp's 16 rows and the tile.
    float s[kKN][4];
#pragma unroll
    for (int n = 0; n < kKN; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < kGroup / 8; ++kk) {
      unsigned ab[4], as[4];
      load_a_frag(qw + kk * 8, kS, g, t, ab, as);
#pragma unroll
      for (int n = 0; n < kKN; ++n) {
        const float* kr = sK + (n * 8 + g) * kS + kk * 8 + t;
        unsigned bb[2], bs[2];
        split(kr[0], bb[0], bs[0]);
        split(kr[4], bb[1], bs[1]);
        mma_3xtf32(s[n], ab, as, bb, bs);
      }
    }
    // S = S_0 + S_1.
    put_partials<kKN>(xw, &s[0][0], 32, lane);
    pair_sync(rw);
    pair_sum<kKN>(&s[0][0], xp, 32, lane);

    // Online softmax on the fragments; keys past Tk score -inf, weigh 0.
    const int k0 = j * kBlockK;
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < kKN; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool valid = k0 + n * 8 + 2 * t + e < p.Tk;
        s[n][e] = valid ? s[n][e] * p.scale : -INFINITY;
        s[n][2 + e] = valid ? s[n][2 + e] * p.scale : -INFINITY;
        mx0 = fmaxf(mx0, s[n][e]);
        mx1 = fmaxf(mx1, s[n][2 + e]);
      }
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    const float alpha0 = expf(m0 - mx0), alpha1 = expf(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    l0 *= alpha0;
    l1 *= alpha1;
#pragma unroll
    for (int n = 0; n < kKN; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float p0 = expf(s[n][e] - m0);
        float p1 = expf(s[n][2 + e] - m1);
        l0 += p0;
        l1 += p1;
        if (p.drop.on) {
          const int key = k0 + n * 8 + 2 * t + e;
          if (!hash_keep(p.drop, hr0, key)) p0 = 0.f;
          if (!hash_keep(p.drop, hr1, key)) p1 = 0.f;
        }
        s[n][e] = p0;
        s[n][2 + e] = p1;
      }
    }
#pragma unroll
    for (int n = 0; n < kDN; ++n) {
      o[n][0] *= alpha0;
      o[n][1] *= alpha0;
      o[n][2] *= alpha1;
      o[n][3] *= alpha1;
    }

    // O_c += P V_c: A's k = t, t + 4 are keys 2t, 2t + 1 of each 8-key tile.
#pragma unroll
    for (int n = 0; n < kKN; ++n) {
      unsigned ab[4], as[4];
      split(s[n][0], ab[0], as[0]);
      split(s[n][2], ab[1], as[1]);
      split(s[n][1], ab[2], as[2]);
      split(s[n][3], ab[3], as[3]);
      const float* vr = sV + (n * 8 + 2 * t) * kS + g;
#pragma unroll
      for (int dn = 0; dn < kDN; ++dn) {
        unsigned bb[2], bs[2];
        split(vr[dn * 8], bb[0], bs[0]);
        split(vr[kS + dn * 8], bb[1], bs[1]);
        mma_3xtf32(o[dn], ab, as, bb, bs);
      }
    }
    __syncthreads();  // the stage and the partials just read are refilled
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float inv0 = 1.f / (l0 * p.keep), inv1 = 1.f / (l1 * p.keep);
  // This warp's half of its Q rows is its alone: stage O_c there, then
  // store 16-byte row chunks of its 128 columns.
  float* ow = sQ + rw * 16 * kS + col0;
#pragma unroll
  for (int n = 0; n < kDN; ++n) {
    store2(ow + g * kS + n * 8 + 2 * t, o[n][0] * inv0, o[n][1] * inv0);
    store2(ow + (g + 8) * kS + n * 8 + 2 * t, o[n][2] * inv1,
           o[n][3] * inv1);
  }
  __syncwarp();
  float* ob = static_cast<float*>(p.o) + b * p.sob + h * p.soh + col0;
  constexpr int kChunks = kGroup / 4;
#pragma unroll 4
  for (int i = lane; i < 16 * kChunks; i += 32) {
    const int r = i / kChunks, c = (i % kChunks) * 4;
    const int row = q0 + rw * 16 + r;
    if (row < p.Tq)
      *reinterpret_cast<float4*>(ob + row * p.sot + c) =
          *reinterpret_cast<const float4*>(ow + r * kS + c);
  }
  if (t == 0 && half == 0) {
    if (row0 < p.Tq) p.lse[(long long)bh * p.Tq + row0] = m0 + logf(l0);
    if (row0 + 8 < p.Tq)
      p.lse[(long long)bh * p.Tq + row0 + 8] = m1 + logf(l1);
  }
}

// Head dims above 256 (any multiple of 128): a cluster of nc = dh / 128
// blocks shares 64 query rows, block c (its rank, blockIdx.z) owning
// column chunk c of Q, K, V and O.  For each 32-key tile
// the block computes the partial S_c = Q_c K_c^T over its own 128 columns
// only, puts it in its exchange buffer, and after one cluster barrier sums
// the nc partials in rank order (its own from its shared memory, the
// others' from the cluster's): every block then holds the same S and runs
// the same online softmax, and O_c += P V_c takes its own V columns.
// 2 nc chunk products a tile pair, none repeated.  Q_c stays in shared
// memory; K_c and V_c stream through a 2-stage cp.async ring, the next
// tile's copy issued after the barrier (which every thread passes only
// once done with the stage it refills).  The exchange buffer is the K_c
// tile just consumed, so buffers alternate with the stages and one
// barrier a tile suffices (tile j + 2 refills a stage only after every
// block has passed tile j + 1's barrier, so after reading tile j's
// partials); a block takes 101 KB, two an SM, so one block's barrier and
// loads from the cluster run under the other's products.
// Above 128 kClusterMax (kMulti) a cluster of C = cluster_blocks(nc) blocks
// shares the rows, block r owning chunks r + i C (cluster.cuh): it adds
// the partials of its chunks after the first to its partial S in chunk
// order, and keeps their O accumulators in the scratch buffer, their
// operands read from global memory (chunk_frags.cuh); still 2 nc chunk
// products a tile pair.
constexpr int kClusterKeys = 32;  // keys a tile above dh 256

struct ClusterLayout {
  static constexpr int kS = kGroup + 4;                // float row stride
  static constexpr int kQ = kBlockQ * kS;               // Q_c
  static constexpr int kKV = kClusterKeys * kS;         // K_c or V_c
  static constexpr int kStage = 2 * kKV;                // K_c, then V_c
  static constexpr int kStages = 2;
  static constexpr int kKN = kClusterKeys / 8;          // 8-key tiles of S
  static constexpr int kX = kRowWarps * kKN * 32 * 4;   // partials (floats)
  static constexpr size_t kBytes = (kQ + kStages * kStage) * sizeof(float);
  static_assert(kX <= kKV && 2 * kBytes <= 232448, "shared memory");
};

template <bool kMulti>
__global__ void __launch_bounds__(32 * kRowWarps, 2)
flash_fwd_kernel_cluster(const Params p) {
  using L = ClusterLayout;
  constexpr int kS = L::kS;
  constexpr int kThreads = 32 * kRowWarps;
  constexpr int kDN = kGroup / 8;
  constexpr int kKN = L::kKN;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sKV = sQ + L::kQ;  // stage s: K_c at sKV + s kStage, V_c after it

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int rw = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int cs = gridDim.z;  // blocks of the cluster
  const unsigned rank = cluster_rank();
  const int col0 = rank * kGroup;
  const TileOf at = unfold((p.Tq + kBlockQ - 1) / kBlockQ);
  const int bh = at.pair;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int q0 = at.tile * kBlockQ;
  const float* kb =
      static_cast<const float*>(p.k) + b * p.skb + h * p.skh + col0;
  const float* vb =
      static_cast<const float*>(p.v) + b * p.svb + h * p.svh + col0;
  const int n_tiles = (p.Tk + kClusterKeys - 1) / kClusterKeys;
  // The block's chunks after its first (kMulti): rank + i cs, i < chunks.
  const int chunks = chunks_per_block(p.nc);
  const GlobalRows<float> gq = {
      static_cast<const float*>(p.q) + b * p.sqb + h * p.sqh, p.sqt, p.Tq};
  const GlobalRows<float> gk = {kb - col0, p.skt, p.Tk};
  const GlobalRows<float> gv = {vb - col0, p.svt, p.Tk};

  load_tile<float, kGroup, kS, kBlockQ, kThreads>(
      sQ, static_cast<const float*>(p.q) + b * p.sqb + h * p.sqh + col0,
      p.sqt, q0, p.Tq, tid);
  load_tile<float, kGroup, kS, kClusterKeys, kThreads>(sKV, kb, p.skt, 0,
                                                       p.Tk, tid);
  load_tile<float, kGroup, kS, kClusterKeys, kThreads>(sKV + L::kKV, vb,
                                                       p.svt, 0, p.Tk, tid);
  cp_async_commit();

  float o[kDN][4];
#pragma unroll
  for (int n = 0; n < kDN; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;
  float l0 = 0.f, l1 = 0.f;
  const int row0 = q0 + rw * 16 + g;
  HashRow hr0 = {0u, 0u}, hr1 = {0u, 0u};
  if (p.drop.on) {
    hr0 = hash_row(p.drop, bh, row0);
    hr1 = hash_row(p.drop, bh, row0 + 8);
  }
  const float* qw = sQ + rw * 16 * kS;
  // This warp's partials: float4 (n, lane) of the buffer.
  const int xoff = rw * kKN * 32 + lane;

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<0>();
    __syncthreads();
    float* sK = sKV + (j & 1) * L::kStage;
    const float* sV = sK + L::kKV;

    // The partial S_c = Q_c K_c^T of this warp's 16 rows and the tile.
    float s[kKN][4];
#pragma unroll
    for (int n = 0; n < kKN; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < kGroup / 8; ++kk) {
      unsigned ab[4], as[4];
      load_a_frag(qw + kk * 8, kS, g, t, ab, as);
#pragma unroll
      for (int n = 0; n < kKN; ++n) {
        const float* kr = sK + (n * 8 + g) * kS + kk * 8 + t;
        unsigned bb[2], bs[2];
        split(kr[0], bb[0], bs[0]);
        split(kr[4], bb[1], bs[1]);
        mma_3xtf32(s[n], ab, as, bb, bs);
      }
    }
    if constexpr (kMulti) {
      // The partials of the block's other chunks, added in chunk order.
      for (int i = 1; i < chunks && rank + i * cs < p.nc; ++i) {
        const int cc = (rank + i * cs) * kGroup;
#pragma unroll 1
        for (int kk = 0; kk < kGroup / 8; ++kk) {
          float a[4];
          unsigned ab[4], as[4];
          gfrag_a(gq, q0 + rw * 16, cc + kk * 8, g, t, a);
#pragma unroll
          for (int e = 0; e < 4; ++e) split(a[e], ab[e], as[e]);
#pragma unroll
          for (int n = 0; n < kKN; ++n) {
            float bv[2];
            unsigned bb[2], bs[2];
            gfrag_b_rows(gk, j * kClusterKeys + n * 8, cc + kk * 8, g, t,
                         bv);
            split(bv[0], bb[0], bs[0]);
            split(bv[1], bb[1], bs[1]);
            mma_3xtf32(s[n], ab, as, bb, bs);
          }
        }
      }
    }
    // Every warp is done with K_c: its tile takes the partials.
    __syncthreads();
    float* xb = sK;
    put_partials<kKN>(xb, &s[0][0], 32, xoff);
    cluster_sync();
    // Every thread of the block is past tile j - 1, and every block past
    // reading its partials: refill its stage.
    if (j + 1 < n_tiles) {
      float* next = sKV + ((j + 1) & 1) * L::kStage;
      const int r0 = (j + 1) * kClusterKeys;
      load_tile<float, kGroup, kS, kClusterKeys, kThreads>(next, kb, p.skt,
                                                           r0, p.Tk, tid);
      load_tile<float, kGroup, kS, kClusterKeys, kThreads>(
          next + L::kKV, vb, p.svt, r0, p.Tk, tid);
    }
    cp_async_commit();
    // S: the cs partials in rank order.
    cluster_sum<kKN>(&s[0][0], xb, 32, xoff, cs, rank);

    // Online softmax on the fragments; keys past Tk score -inf, weigh 0.
    const int k0 = j * kClusterKeys;
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < kKN; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool valid = k0 + n * 8 + 2 * t + e < p.Tk;
        s[n][e] = valid ? s[n][e] * p.scale : -INFINITY;
        s[n][2 + e] = valid ? s[n][2 + e] * p.scale : -INFINITY;
        mx0 = fmaxf(mx0, s[n][e]);
        mx1 = fmaxf(mx1, s[n][2 + e]);
      }
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    const float alpha0 = expf(m0 - mx0), alpha1 = expf(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    l0 *= alpha0;
    l1 *= alpha1;
#pragma unroll
    for (int n = 0; n < kKN; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float p0 = expf(s[n][e] - m0);
        float p1 = expf(s[n][2 + e] - m1);
        l0 += p0;
        l1 += p1;
        if (p.drop.on) {
          const int key = k0 + n * 8 + 2 * t + e;
          if (!hash_keep(p.drop, hr0, key)) p0 = 0.f;
          if (!hash_keep(p.drop, hr1, key)) p1 = 0.f;
        }
        s[n][e] = p0;
        s[n][2 + e] = p1;
      }
    }
#pragma unroll
    for (int n = 0; n < kDN; ++n) {
      o[n][0] *= alpha0;
      o[n][1] *= alpha0;
      o[n][2] *= alpha1;
      o[n][3] *= alpha1;
    }

    // O_c += P V_c: A's k = t, t + 4 are keys 2t, 2t + 1 of each 8-key tile.
#pragma unroll
    for (int n = 0; n < kKN; ++n) {
      unsigned ab[4], as[4];
      split(s[n][0], ab[0], as[0]);
      split(s[n][2], ab[1], as[1]);
      split(s[n][1], ab[2], as[2]);
      split(s[n][3], ab[3], as[3]);
      const float* vr = sV + (n * 8 + 2 * t) * kS + g;
#pragma unroll
      for (int dn = 0; dn < kDN; ++dn) {
        unsigned bb[2], bs[2];
        split(vr[dn * 8], bb[0], bs[0]);
        split(vr[kS + dn * 8], bb[1], bs[1]);
        mma_3xtf32(o[dn], ab, as, bb, bs);
      }
    }
    if constexpr (kMulti) {
      // O_c' += P V_c' for the block's other chunks c', their accumulators
      // through the scratch buffer (zero before the first tile).
      for (int i = 1; i < chunks && rank + i * cs < p.nc; ++i) {
        const int cc = (rank + i * cs) * kGroup;
        float4* acc = extra_acc(p.scratch, i, chunks, kDN);
#pragma unroll 1
        for (int dn = 0; dn < kDN; ++dn) {
          float d[4] = {0.f, 0.f, 0.f, 0.f};
          if (j > 0) load4(d, acc + dn * kThreads);
          d[0] *= alpha0;
          d[1] *= alpha0;
          d[2] *= alpha1;
          d[3] *= alpha1;
#pragma unroll
          for (int n = 0; n < kKN; ++n) {
            unsigned ab[4], as[4], bb[2], bs[2];
            split(s[n][0], ab[0], as[0]);
            split(s[n][2], ab[1], as[1]);
            split(s[n][1], ab[2], as[2]);
            split(s[n][3], ab[3], as[3]);
            float bv[2];
            gfrag_b_cols(gv, k0 + n * 8, cc + dn * 8, g, t, bv);
            split(bv[0], bb[0], bs[0]);
            split(bv[1], bb[1], bs[1]);
            mma_3xtf32(d, ab, as, bb, bs);
          }
          store4(acc + dn * kThreads, d);
        }
      }
    }
  }
  // No block leaves while another may still read its exchange buffer.
  cluster_sync();

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float inv0 = 1.f / (l0 * p.keep), inv1 = 1.f / (l1 * p.keep);
  if constexpr (kMulti) {
    // The other chunks' O rows, straight from the fragments.
    float* orow = static_cast<float*>(p.o) + b * p.sob + h * p.soh;
    for (int i = 1; i < chunks && rank + i * cs < p.nc; ++i) {
      const int cc = (rank + i * cs) * kGroup;
      const float4* acc = extra_acc(p.scratch, i, chunks, kDN);
#pragma unroll 1
      for (int dn = 0; dn < kDN; ++dn) {
        float d[4];
        load4(d, acc + dn * kThreads);
        const int col = cc + dn * 8 + 2 * t;
        if (row0 < p.Tq)
          store2(orow + row0 * p.sot + col, d[0] * inv0, d[1] * inv0);
        if (row0 + 8 < p.Tq)
          store2(orow + (row0 + 8) * p.sot + col, d[2] * inv1, d[3] * inv1);
      }
    }
  }
  // This warp's Q rows are its alone: stage O there, then store 16-byte
  // row chunks of the block's 128 columns.
  float* ow = sQ + rw * 16 * kS;
#pragma unroll
  for (int n = 0; n < kDN; ++n) {
    store2(ow + g * kS + n * 8 + 2 * t, o[n][0] * inv0, o[n][1] * inv0);
    store2(ow + (g + 8) * kS + n * 8 + 2 * t, o[n][2] * inv1,
           o[n][3] * inv1);
  }
  __syncwarp();
  float* ob = static_cast<float*>(p.o) + b * p.sob + h * p.soh + col0;
  constexpr int kChunks = kGroup / 4;
#pragma unroll 4
  for (int i = lane; i < 16 * kChunks; i += 32) {
    const int r = i / kChunks, c = (i % kChunks) * 4;
    const int row = q0 + rw * 16 + r;
    if (row < p.Tq)
      *reinterpret_cast<float4*>(ob + row * p.sot + c) =
          *reinterpret_cast<const float4*>(ow + r * kS + c);
  }
  if (t == 0 && col0 == 0) {
    if (row0 < p.Tq) p.lse[(long long)bh * p.Tq + row0] = m0 + logf(l0);
    if (row0 + 8 < p.Tq)
      p.lse[(long long)bh * p.Tq + row0 + 8] = m1 + logf(l1);
  }
}

template <bool kMulti>
cudaError_t launch_cluster_fwd(const Params& p, int B, cudaStream_t stream) {
  static unsigned done = 0;
  return launch_cluster(
      flash_fwd_kernel_cluster<kMulti>,
      folded_grid((p.Tq + kBlockQ - 1) / kBlockQ, (long long)B * p.H, 1,
                  cluster_blocks(p.nc)),
      32 * kRowWarps, ClusterLayout::kBytes, stream, &done, p);
}

// The scratch buffer of the cluster kernel's extra chunks (cluster.cuh).
long long fwd_scratch_bytes(int B, int H, int Tq, int dh) {
  if (dh <= 256 || dh % kGroup) return 0;
  return extra_acc_bytes((long long)((Tq + kBlockQ - 1) / kBlockQ) * B * H,
                         dh / kGroup, 32 * kRowWarps, kGroup / 8);
}

template <int D, int SPLIT>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  using L = Layout<D, SPLIT>;
  static unsigned done = 0;
  cudaError_t err =
      set_smem_once(flash_fwd_kernel<D, SPLIT>, L::kBytes, &done);
  if (err != cudaSuccess) return err;
  const dim3 grid =
      folded_grid((p.Tq + kBlockQ - 1) / kBlockQ, (long long)B * p.H);
  flash_fwd_kernel<D, SPLIT><<<grid, L::kThreads, L::kBytes, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t launch_pair(const Params& p, int B, cudaStream_t stream) {
  using L = PairLayout;
  static unsigned done = 0;
  cudaError_t err = set_smem_once(flash_fwd_kernel_pair, L::kBytes, &done);
  if (err != cudaSuccess) return err;
  const dim3 grid =
      folded_grid((p.Tq + kBlockQ - 1) / kBlockQ, (long long)B * p.H);
  flash_fwd_kernel_pair<<<grid, L::kThreads, L::kBytes, stream>>>(p);
  return cudaGetLastError();
}

// The head dims the wrapper pads to: 32 (demo), 64 (the reference's
// default model), 128 (the rest), 256 (any dh in (128, 256], on the
// 8-warp pair kernel), and above 256 any multiple of 128
// (`launch_cluster_fwd`; above 128 kClusterMax a block owns several
// chunks).  Up to 128, a grid of at most one 4-warp block an SM leaves
// half the warps the SMs could hold idle: split each block's keys over
// two warp groups instead.
cudaError_t dispatch(const Params& p, int B, int dh, int sms,
                     cudaStream_t s) {
  if (dh > 256) {
    if (dh % kGroup) return cudaErrorInvalidValue;
    return p.nc > kClusterMax ? launch_cluster_fwd<true>(p, B, s)
                              : launch_cluster_fwd<false>(p, B, s);
  }
  const long long blocks =
      (long long)((p.Tq + kBlockQ - 1) / kBlockQ) * B * p.H;
  const bool split = blocks <= sms;
  switch (dh) {
    case 32:
      return split ? launch<32, 2>(p, B, s) : launch<32, 1>(p, B, s);
    case 64:
      return split ? launch<64, 2>(p, B, s) : launch<64, 1>(p, B, s);
    case 128:
      return split ? launch<128, 2>(p, B, s) : launch<128, 1>(p, B, s);
    case 256:
      return launch_pair(p, B, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// One m16n8k8 product in 3xTF32 by one warp, for checking the fragment
// layouts on the card: a (16, 8) and b (8, 8) row-major, c = a b (16, 8).
__global__ void mma_3xtf32_probe_kernel(const float* a, const float* b,
                                        float* c) {
  const int lane = threadIdx.x;
  const int g = lane >> 2, t = lane & 3;
  unsigned ab[4], as[4], bb[2], bs[2];
  split(a[g * 8 + t], ab[0], as[0]);
  split(a[(g + 8) * 8 + t], ab[1], as[1]);
  split(a[g * 8 + t + 4], ab[2], as[2]);
  split(a[(g + 8) * 8 + t + 4], ab[3], as[3]);
  split(b[t * 8 + g], bb[0], bs[0]);
  split(b[(t + 4) * 8 + g], bb[1], bs[1]);
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  mma_3xtf32(d, ab, as, bb, bs);
  c[g * 8 + 2 * t] = d[0];
  c[g * 8 + 2 * t + 1] = d[1];
  c[(g + 8) * 8 + 2 * t] = d[2];
  c[(g + 8) * 8 + 2 * t + 1] = d[3];
}

}  // namespace

// dtype: 0 float32 (q, k, v, o and lse); bfloat16 runs on
// flash_fwd_wgmma.cu at every head dim, so 1 is refused here.
extern "C" int avsep_flash_attn_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int B, int H, int Tq, int Tk, int dh,
    long long sqb, long long sqh, long long sqt,
    long long skb, long long skh, long long skt,
    long long svb, long long svh, long long svt,
    long long sob, long long soh, long long sot,
    float scale, float keep, unsigned threshold, unsigned seed, int hq,
    int hk, int dropout, int dtype, int device, void* stream,
    void* scratch) {
  const DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p;
  p.nc = dh / kGroup;
  p.scratch = static_cast<float*>(scratch);
  if (fwd_scratch_bytes(B, H, Tq, dh) > 0 && scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
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
  static int sm_counts[32] = {0};  // read once per device
  int& sms = sm_counts[device & 31];
  if (sms == 0) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  err = dtype == 0 ? dispatch(p, B, dh, sms, s) : cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// Shared memory of a block of the cluster kernel (bytes).
extern "C" int avsep_flash_attn_fwd_cluster_smem() {
  return static_cast<int>(ClusterLayout::kBytes);
}

// Shared memory of a block of the pair kernel at dh 256 (bytes).
extern "C" int avsep_flash_attn_fwd_pair_smem() {
  return static_cast<int>(PairLayout::kBytes);
}

// Bytes of the scratch buffer a call at these sizes takes (`scratch`, float
// aligned); 0 up to dh 128 kClusterMax.
extern "C" long long avsep_flash_attn_fwd_scratch(int B, int H, int Tq,
                                                  int dh) {
  return fwd_scratch_bytes(B, H, Tq, dh);
}

extern "C" int avsep_mma_3xtf32_probe(const void* a, const void* b, void* c,
                                      int device, void* stream) {
  const DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return static_cast<int>(err);
  mma_3xtf32_probe_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(c));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* avsep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
