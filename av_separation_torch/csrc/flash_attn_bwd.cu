// Flash attention backward, float32 on the tensor cores in 3xTF32 and
// bfloat16 above head dim 256 in bf16 `mma.sync` products, for Hopper
// (sm_90a).
//
// Replaces: av_separation_tpu/ops/pallas/attention.py `_bwd_hpacked_kernel`
// (packed (B, T, H*dh) layout, `_flash_hpacked_bwd_rule`),
// `_bwd_packed_kernel` (split (B*H, T, dh) layout, `_flash_packed_bwd_rule`)
// and the multi-block `_delta_kernel` / `_dq_kernel` / `_dkv_kernel`
// (`_flash_bwd_rule`, T > 512).  Tensors are addressed through
// (batch, head, time) strides with the head dim contiguous, as in the
// forward; queries and keys are always streamed in tiles, so T has no cap.
//
// The Pallas arithmetic, in float32:
//   delta = rowsum(dO * O)
//   p  = exp(q.k * scale - lse)
//   dp = dO.v, masked and divided by (1 - rate) where kept
//   pd = keep ? p / (1 - rate) : 0,   dV = pd^T dO
//   ds = p (dp - delta) scale,        dQ = ds K,   dK = ds^T Q
// with the keep mask regenerated from the Pallas hash (dropout_hash.cuh),
// keyed by (query row, key) and the Pallas tile sizes, never by this
// kernel's tiles, so it is the forward's mask and the JAX mask bit for bit.
//
// Bound on the H100 at the scaled training shapes (B=8, H=4, dh=128,
// Tq = Tk = 501): the least work is 5 products of 2*B*H*Tq*Tk*dh FLOPs
// (QK^T, dO V^T, dV, dQ, dK), 10.3 GFLOP, against 57 MB of q, k, v, o, dO,
// lse in and dQ, dK, dV out.  Float32 products at float32 accuracy run on
// the tensor cores in 3xTF32 at 495/3 = 165 TFLOP/s: 62 us, against 17 us
// of bytes at 3.35 TB/s, so bound by operations (in bfloat16: 10.4 us at
// 989 TFLOP/s against 9.8 us for 33 MB, still operations).  These do 7
// products (the dQ kernel recomputes QK^T and dO V^T), so as to need no
// atomics: two runs give bit-identical gradients.
//
// Design:
// - Products.  Every product is an mma.sync.m16n8k8 TF32 product in
//   3xTF32 (big*small + small*big + big*big, `split` and `mma_3xtf32` in
//   mma_3xtf32.cuh, as the forward).  3xTF32 keeps ~2^-20 relative per
//   operand against 1xTF32's 2^-11: in a numpy emulation of these tiles at
//   the audio self-attention shape (tests/test_torch_kernel_design.py) it
//   holds dQ, dK, dV within 2e-5 of the plain float32 version, and 1xTF32
//   misses by two orders of magnitude.  `wgmma` has no TF32 route for the
//   operands that are not K-major here (dO and Q as the B operands of dV
//   and dK, K of dQ).
// - delta kernel: one warp per query row, delta = sum(dO * O).
// - dK/dV kernel: a block owns 64 keys of one (batch, head), K and V in
//   shared memory, and walks the query tiles of 16 rows through a 2-stage
//   cp.async ring of Q and dO rows, their lse and delta, and the row part
//   of the dropout hash.  Each warp owns 16 keys.  It computes S^T = K Q^T
//   and dP^T = V dO^T with K and V as the A operands and the Q and dO rows
//   as the B operands (read as the forward reads K), forms P^T, Pd^T and
//   dS^T in the C fragments, and accumulates dV += Pd^T dO and
//   dK += dS^T Q with the C fragment as the A operand: the forward's "P
//   into PV without a shuffle" with keys and queries swapped (A's k = t,
//   t + 4 stand for queries 2t, 2t + 1, and the dO and Q rows 2t, 2t + 1
//   are read as the forward reads V).  The fragment's rows are keys and its
//   columns queries, so the hash's row part is taken per column and its key
//   part once per lane (`hash_col`).
// - dQ kernel: a block owns 64 query rows (16 a warp), Q and dO in shared
//   memory, and walks the key tiles of 16 through a 2-stage ring of K and
//   V rows: S = Q K^T, dP = dO V^T, ds in the C fragment, then dQ += ds K
//   with ds as the A operand and K read as the forward reads V.
// - Registers.  A dK/dV warp carries 16 x dh accumulators of each, 128
//   floats a thread at dh 128; the K and V A fragments are re-read from
//   shared memory for every query tile rather than held.  The ring is
//   addressed in elements of T, the stage's lse / delta / hash words
//   behind its rows: addressed in bytes, the float32 8-warp instance at dh
//   128 spilled 40 bytes at 254 registers.
// - Filling 132 SMs.  Audio self-attention and fusion give 256 blocks of
//   4 warps (101 KB of shared memory at dh 128, 2 blocks an SM).  A grid of
//   at most one block an SM (visual self-attention at T 200, the long T 1024
//   shape: 128) takes 8-warp blocks instead: two groups of 4 walk alternate
//   tiles (query tiles in dK/dV, key tiles in dQ), and the second hands its
//   accumulators to the first through the idle ring, which adds them in a
//   fixed order.
// - bfloat16 runs here only above dh 256 (up to 256 it runs on
//   flash_bwd_wgmma.cu), at the Pallas rules at bf16 (attention.py:238-263,
//   :418-443, :711-810): the same kernels with bf16 operands in
//   mma.sync.m16n8k16 products and float32 accumulators; delta =
//   sum(dO * O) in float32; pd rounded to bf16 for dV = pd^T dO, ds to
//   bf16 for dQ = ds K and dK = ds^T Q.  A 16-query (16-key) tile is one
//   k16 step; two C fragments are its A fragment as they stand
//   (mma_bf16.cuh).  dQ, dK and dV are stored in bf16.
// - Head dims in (128, 256] (`flash_bwd_*_kernel_pair`, as the forward):
//   dh is padded to 256; one 8-warp dK/dV (dQ) block owns 64 keys (rows),
//   warps w and w + 4 the same 16 and one 128-column half each (K, V, Q
//   and dO staged at full width).  Each warp computes its partial S^T and
//   dP^T (S and dP) over its 128 columns, the two add each other's
//   through shared memory at a named barrier, and each accumulates only
//   its own columns, so a warp holds the accumulators of dh 128: 8 + 6 =
//   14 chunk products a tile pair (the column split it replaces took
//   22).  212 KB (211 KB) of shared memory: one 8-warp block an SM.
// - Head dims above 256 (any multiple of 128,
//   `flash_bwd_*_kernel_cluster`): a thread-block cluster of nc = dh / 128
//   blocks (grid z; cluster.cuh) shares a block's 64 keys (dK/dV) or rows
//   (dQ), block c holding chunk c of every operand and gradient (above dh
//   2048 block r owns chunks r, r + C, ... of a cluster of C, their
//   accumulators in a scratch buffer).  Each
//   block computes its partials S^T_c and dP^T_c (S_c and dP_c) for a
//   32-row (32-key) tile, the cluster sums the nc partials in block order
//   through distributed shared memory (one cluster barrier a tile), and
//   each block forms the same P, Pd, dS and takes its own columns of dV,
//   dK (dQ): 4 nc + 3 nc = 7 nc chunk products a tile pair, the count of
//   the kernels up to dh 256 (the chunked kernels they replace took
//   nc (4 nc + 3)).  The order of every sum is fixed: no atomics, two
//   runs bit-identical.  bf16 keeps mma.sync.m16n8k16 here.
// - Rows past T are zero-filled by the copies; a query past Tq gets lse
//   +inf in the dK/dV kernel (p = 0), a key past Tk gets p = 0 in the dQ
//   kernel, and neither is stored.
// - Bank conflicts.  Operand rows are dh+4 floats apart: the A loads and
//   the B loads of rows n*8 + g hit bank 4g + t, the B loads of rows 2t,
//   2t + 1 bank 8t + g (+4): 32 distinct banks per load.
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "chunk_frags.cuh"
#include "cluster.cuh"
#include "dropout_hash.cuh"
#include "grid_fold.cuh"
#include "mma_3xtf32.cuh"
#include "mma_bf16.cuh"
#include "device_guard.cuh"

namespace {

constexpr int kWarps = 4;               // warps of a group
constexpr int kBlock = 16 * kWarps;     // keys (dK/dV) or rows (dQ) a block
constexpr int kTile = 16;               // query (dK/dV) or key (dQ) tile
constexpr int kDeltaThreads = 128;
constexpr int kGroup = 128;             // columns of a half or a chunk

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;
  float* delta;
  void* dq;
  void* dk;
  void* dv;
  int H, Tq, Tk;
  // (batch, head, time) strides of q, k, v, o, dO, dQ, dK, dV (elements).
  long long sq[3], sk[3], sv[3], so[3], sdo[3], sdq[3], sdk[3], sdv[3];
  float scale;
  float keep;  // 1 - rate
  DropoutHash drop;
  int nc;          // column chunks above dh 256 (cluster.cuh)
  float* scratch;  // the accumulators of a block's chunks after its first
};

template <typename T>
__device__ __forceinline__ const T* head(const void* base, const long long* s,
                                         int b, int h) {
  return static_cast<const T*>(base) + b * s[0] + h * s[1];
}

template <typename T>
__device__ __forceinline__ T* head(void* base, const long long* s, int b,
                                   int h) {
  return static_cast<T*>(base) + b * s[0] + h * s[1];
}

// The 3xTF32 A fragment of rows [0, 16) and columns [c, c + 8) of a tile
// at row stride S.  (`load_a_frag` in mma_3xtf32.cuh does the same; with
// it the 8-warp dK/dV kernel at dh 128, at 255 registers, spilled 40
// bytes.)
template <int S>
__device__ __forceinline__ void load_a(const float* tile, int c, int g, int t,
                                       unsigned (&ab)[4], unsigned (&as)[4]) {
  const float* a = tile + g * S + c + t;
  split(a[0], ab[0], as[0]);
  split(a[8 * S], ab[1], as[1]);
  split(a[4], ab[2], as[2]);
  split(a[8 * S + 4], ab[3], as[3]);
}

// A C fragment (rows g, g + 8; columns 2t, 2t + 1) as the A fragment of
// the next product: its columns are that product's k, taken in the order
// k = t -> column 2t, k = t + 4 -> column 2t + 1.
__device__ __forceinline__ void c_as_a(const float (&c)[4], unsigned (&ab)[4],
                                       unsigned (&as)[4]) {
  split(c[0], ab[0], as[0]);
  split(c[2], ab[1], as[1]);
  split(c[1], ab[2], as[2]);
  split(c[3], ab[3], as[3]);
}

// Accumulators (16 x N*8 a warp, as C fragments) to rows [r0, r0 + 16) of
// a (time, dh) output: staged in `st`, this warp's own 16 rows of a shared
// tile at row stride S, in T, then stored as 16-byte row chunks.
template <typename T, int N, int S>
__device__ __forceinline__ void store_rows(const float (&acc)[N][4], T* st,
                                           T* out, long long stride, int r0,
                                           int n, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int d = 0; d < N; ++d) {
    store2(st + g * S + d * 8 + 2 * t, acc[d][0], acc[d][1]);
    store2(st + (g + 8) * S + d * 8 + 2 * t, acc[d][2], acc[d][3]);
  }
  __syncwarp();
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = N * 8 / kVec;
#pragma unroll 4
  for (int i = lane; i < 16 * kChunks; i += 32) {
    const int r = i / kChunks, c = (i % kChunks) * kVec;
    if (r0 + r < n)
      *reinterpret_cast<float4*>(out + (r0 + r) * stride + c) =
          *reinterpret_cast<const float4*>(st + r * S + c);
  }
}

// A split block's second warp group hands one set of accumulators to the
// first through `x` (4 * 32 * N floats a warp) between two
// __syncthreads; the first adds them.
template <int N>
__device__ __forceinline__ void hand_over(const float (&acc)[N][4], float* x,
                                          int lane) {
#pragma unroll
  for (int n = 0; n < N; ++n)
    *reinterpret_cast<float4*>(x + (n * 32 + lane) * 4) =
        make_float4(acc[n][0], acc[n][1], acc[n][2], acc[n][3]);
}

template <int N>
__device__ __forceinline__ void take_over(float (&acc)[N][4], const float* x,
                                          int lane) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const float4 y = *reinterpret_cast<const float4*>(x + (n * 32 + lane) * 4);
    acc[n][0] += y.x;
    acc[n][1] += y.y;
    acc[n][2] += y.z;
    acc[n][3] += y.w;
  }
}

// ---------------------------------------------------------------------------
// delta = rowsum(dO * O) in float32: one warp per query row.
// ---------------------------------------------------------------------------
template <typename T, int DQK>
__global__ void __launch_bounds__(kDeltaThreads)
flash_bwd_delta_kernel(const Params p) {
  const int lane = threadIdx.x & 31;
  constexpr int kRows = kDeltaThreads / 32;
  const TileOf at = unfold((p.Tq + kRows - 1) / kRows);
  const int bh = at.pair;
  const int b = bh / p.H, h = bh % p.H;
  const int t = at.tile * kRows + (threadIdx.x >> 5);
  if (t >= p.Tq) return;
  const T* orow = head<T>(p.o, p.so, b, h) + t * p.so[2];
  const T* drow = head<T>(p.dout, p.sdo, b, h) + t * p.sdo[2];
  float acc = 0.f;
#pragma unroll
  for (int d = lane; d < DQK; d += 32)
    acc = fmaf(to_float(drow[d]), to_float(orow[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) p.delta[(long long)bh * p.Tq + t] = acc;
}

// The same at a run-time head dim (above 256).
template <typename T>
__global__ void __launch_bounds__(kDeltaThreads)
flash_bwd_delta_kernel_wide(const Params p, int dh) {
  const int lane = threadIdx.x & 31;
  constexpr int kRows = kDeltaThreads / 32;
  const TileOf at = unfold((p.Tq + kRows - 1) / kRows);
  const int bh = at.pair;
  const int b = bh / p.H, h = bh % p.H;
  const int t = at.tile * kRows + (threadIdx.x >> 5);
  if (t >= p.Tq) return;
  const T* orow = head<T>(p.o, p.so, b, h) + t * p.so[2];
  const T* drow = head<T>(p.dout, p.sdo, b, h) + t * p.sdo[2];
  float acc = 0.f;
  for (int d = lane; d < dh; d += 32)
    acc = fmaf(to_float(drow[d]), to_float(orow[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) p.delta[(long long)bh * p.Tq + t] = acc;
}

// ---------------------------------------------------------------------------
// dK, dV: a block owns kBlock keys and walks the query tiles (head dims
// 32, 64 and 128).
// ---------------------------------------------------------------------------
template <int D, int SPLIT>
struct DkvLayout {
  static constexpr int kThreads = 32 * kWarps * SPLIT;
  static constexpr int kS = D + 4;  // operand row stride
  static constexpr int kRows = kTile * SPLIT;  // query rows a stage
  static constexpr int kKV = kBlock * kS;    // one of K, V (floats)
  // A stage (floats): Q rows, dO rows, then lse, delta and the hash's row
  // part (tile and row terms) of each row (4-byte words).
  static constexpr int kOperands = 2 * kRows * kS;
  static constexpr int kStage = kOperands + 4 * kRows;
  static constexpr size_t kBytes = (2 * kKV + 2 * kStage) * sizeof(float);
  // The split block hands dK, then dV (4 * 32 * D / 8 floats a warp each)
  // over through the idle ring.
  static_assert(SPLIT == 1 || 2 * kStage >= kWarps * 32 * 4 * (D / 8),
                "hand-over does not fit the ring");
};

template <int D, int SPLIT>
__global__ void __launch_bounds__(DkvLayout<D, SPLIT>::kThreads, 3 - SPLIT)
flash_bwd_dkv_kernel(const Params p) {
  using L = DkvLayout<D, SPLIT>;
  constexpr int kS = L::kS;
  constexpr int kRows = L::kRows;
  constexpr int kThreads = L::kThreads;
  constexpr int kDN = D / 8;       // 8-wide column tiles of dK, dV
  constexpr int kQN = kTile / 8;   // 8-query tiles of S^T
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);
  float* sV = sK + L::kKV;
  float* sRing = sV + L::kKV;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int kw = warp % kWarps;    // which 16 keys
  const int part = warp / kWarps;  // which query tile of a stage
  const int g = lane >> 2, t = lane & 3;
  const TileOf at = unfold((p.Tk + kBlock - 1) / kBlock);
  const int bh = at.pair;
  const int b = bh / p.H, h = bh % p.H;
  const int k0 = at.tile * kBlock;

  const float* qb = head<float>(p.q, p.sq, b, h);
  const float* ob = head<float>(p.dout, p.sdo, b, h);
  const float* lse = p.lse + (long long)bh * p.Tq;
  const float* delta = p.delta + (long long)bh * p.Tq;
  const int n_stages = (p.Tq + kRows - 1) / kRows;

  auto load_stage = [&](int j) {
    float* st = sRing + (j & 1) * L::kStage;
    const int r0 = j * kRows;
    load_tile<float, D, kS, kRows, kThreads>(st, qb, p.sq[2], r0, p.Tq, tid);
    load_tile<float, D, kS, kRows, kThreads>(st + kRows * kS, ob, p.sdo[2],
                                             r0, p.Tq, tid);
    if (tid < kRows) {
      float* sl = st + L::kOperands;
      const int row = r0 + tid;
      if (row < p.Tq) {
        cp_async4(sl + tid, lse + row, 4);
        cp_async4(sl + kRows + tid, delta + row, 4);
      } else {
        sl[tid] = INFINITY;  // p = exp(s - inf) = 0
        sl[kRows + tid] = 0.f;
      }
      if (p.drop.on) {
        const HashRow hr = hash_row(
            p.drop, unfold_again((p.Tk + kBlock - 1) / kBlock).pair, row);
        reinterpret_cast<unsigned*>(sl)[2 * kRows + tid] = hr.tile;
        reinterpret_cast<unsigned*>(sl)[3 * kRows + tid] = hr.row;
      }
    }
  };

  load_tile<float, D, kS, kBlock, kThreads>(
      sK, head<float>(p.k, p.sk, b, h), p.sk[2], k0, p.Tk, tid);
  load_tile<float, D, kS, kBlock, kThreads>(
      sV, head<float>(p.v, p.sv, b, h), p.sv[2], k0, p.Tk, tid);
  load_stage(0);
  cp_async_commit();

  float dk[kDN][4], dv[kDN][4];
#pragma unroll
  for (int n = 0; n < kDN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  HashCol hc0 = {0u, 0u}, hc1 = {0u, 0u};
  if (p.drop.on) {
    hc0 = hash_col(p.drop, k0 + kw * 16 + g);
    hc1 = hash_col(p.drop, k0 + kw * 16 + g + 8);
  }
  const float* kt = sK + kw * 16 * kS;
  const float* vt = sV + kw * 16 * kS;
  const float inv_keep = 1.f / p.keep;

  for (int j = 0; j < n_stages; ++j) {
    if (j + 1 < n_stages) {
      load_stage(j + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* st = sRing + (j & 1) * L::kStage;
    const int c0 = part * kTile;  // this group's rows of the stage

    if (j * kRows + c0 < p.Tq) {
      const float* sQ = st + c0 * kS;
      const float* sO = st + (kRows + c0) * kS;
      const float* sl = st + L::kOperands + c0;
      const unsigned* sh = reinterpret_cast<const unsigned*>(sl);

      // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys.
      float s[kQN][4], dp[kQN][4];
#pragma unroll
      for (int n = 0; n < kQN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
      // Two k-steps at a time, one in the split block (the second
      // spilled there).
#pragma unroll(SPLIT == 1 ? 2 : 1)
      for (int kk = 0; kk < D / 8; ++kk) {
        unsigned ab[4], as[4];
        load_a<kS>(kt, kk * 8, g, t, ab, as);
#pragma unroll
        for (int n = 0; n < kQN; ++n) {
          const float* qr = sQ + (n * 8 + g) * kS + kk * 8 + t;
          unsigned bb[2], bs[2];
          split(qr[0], bb[0], bs[0]);
          split(qr[4], bb[1], bs[1]);
          mma_3xtf32(s[n], ab, as, bb, bs);
        }
        load_a<kS>(vt, kk * 8, g, t, ab, as);
#pragma unroll
        for (int n = 0; n < kQN; ++n) {
          const float* orow = sO + (n * 8 + g) * kS + kk * 8 + t;
          unsigned bb[2], bs[2];
          split(orow[0], bb[0], bs[0]);
          split(orow[4], bb[1], bs[1]);
          mma_3xtf32(dp[n], ab, as, bb, bs);
        }
      }

      // P^T, then Pd^T into s and dS^T into dp; rows g, g + 8 are keys,
      // column 2t + e of tile n is query c0 + n * 8 + 2t + e.
#pragma unroll
      for (int n = 0; n < kQN; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n * 8 + 2 * t + e;
          const float l = sl[col], dl = sl[kRows + col];
          const float p0 = expf(s[n][e] * p.scale - l);
          const float p1 = expf(s[n][2 + e] * p.scale - l);
          float pd0 = p0, pd1 = p1, d0 = dp[n][e], d1 = dp[n][2 + e];
          if (p.drop.on) {
            const HashRow hr = {sh[2 * kRows + col], sh[3 * kRows + col]};
            const bool keep0 = hash_keep(p.drop, hr, hc0);
            const bool keep1 = hash_keep(p.drop, hr, hc1);
            pd0 = keep0 ? p0 * inv_keep : 0.f;
            d0 = keep0 ? d0 * inv_keep : 0.f;
            pd1 = keep1 ? p1 * inv_keep : 0.f;
            d1 = keep1 ? d1 * inv_keep : 0.f;
          }
          s[n][e] = pd0;
          s[n][2 + e] = pd1;
          dp[n][e] = p0 * (d0 - dl) * p.scale;
          dp[n][2 + e] = p1 * (d1 - dl) * p.scale;
        }
      }

      // dV += Pd^T dO, dK += dS^T Q: the C fragments as A operands, the
      // dO and Q rows n * 8 + 2t, + 1 as B.
#pragma unroll
      for (int n = 0; n < kQN; ++n) {
        unsigned ab[4], as[4];
        c_as_a(s[n], ab, as);
        const float* orow = sO + (n * 8 + 2 * t) * kS + g;
#pragma unroll
        for (int dn = 0; dn < kDN; ++dn) {
          unsigned bb[2], bs[2];
          split(orow[dn * 8], bb[0], bs[0]);
          split(orow[kS + dn * 8], bb[1], bs[1]);
          mma_3xtf32(dv[dn], ab, as, bb, bs);
        }
        c_as_a(dp[n], ab, as);
        const float* qr = sQ + (n * 8 + 2 * t) * kS + g;
#pragma unroll
        for (int dn = 0; dn < kDN; ++dn) {
          unsigned bb[2], bs[2];
          split(qr[dn * 8], bb[0], bs[0]);
          split(qr[kS + dn * 8], bb[1], bs[1]);
          mma_3xtf32(dk[dn], ab, as, bb, bs);
        }
      }

    }
    __syncthreads();  // the stage just read is the next copy's target
  }

  if (SPLIT == 2) {
    // dK, then dV, through the idle ring, added in a fixed order.
    float* x = sRing + kw * 32 * 4 * kDN;
    if (part == 1) hand_over(dk, x, lane);
    __syncthreads();
    if (part == 0) take_over(dk, x, lane);
    __syncthreads();
    if (part == 1) hand_over(dv, x, lane);
    __syncthreads();
    if (part == 1) return;
    take_over(dv, x, lane);
  }
  const TileOf end = unfold_again((p.Tk + kBlock - 1) / kBlock);
  const int eb = end.pair / p.H, eh = end.pair % p.H;
  const int ek = end.tile * kBlock + kw * 16;
  store_rows<float, kDN, kS>(dk, sK + kw * 16 * kS,
                             head<float>(p.dk, p.sdk, eb, eh), p.sdk[2], ek,
                             p.Tk, lane);
  store_rows<float, kDN, kS>(dv, sV + kw * 16 * kS,
                             head<float>(p.dv, p.sdv, eb, eh), p.sdv[2], ek,
                             p.Tk, lane);
}

// ---------------------------------------------------------------------------
// dQ: a block owns kBlock query rows and walks the key tiles (head dims
// 32, 64 and 128).
// ---------------------------------------------------------------------------
template <int D, int SPLIT>
struct DqLayout {
  static constexpr int kThreads = 32 * kWarps * SPLIT;
  static constexpr int kS = D + 4;  // operand row stride
  static constexpr int kKeys = kTile * SPLIT;  // keys a stage
  static constexpr int kQ = kBlock * kS;      // one of Q, dO
  static constexpr int kKV = kKeys * kS;      // one of K, V of a stage
  static constexpr size_t kBytes = (2 * kQ + 4 * kKV) * sizeof(float);
  static_assert(SPLIT == 1 || 4 * kKV >= kWarps * 32 * 4 * (D / 8),
                "hand-over does not fit the ring");
};

template <int D, int SPLIT>
__global__ void __launch_bounds__(DqLayout<D, SPLIT>::kThreads, 3 - SPLIT)
flash_bwd_dq_kernel(const Params p) {
  using L = DqLayout<D, SPLIT>;
  constexpr int kS = L::kS;
  constexpr int kThreads = L::kThreads;
  constexpr int kDN = D / 8;       // 8-wide column tiles of dQ
  constexpr int kKN = kTile / 8;   // 8-key tiles of S
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sO = sQ + L::kQ;   // dO rows
  float* sKV = sO + L::kQ;  // stage s: K at sKV + 2 s kKV, V after it

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rw = warp % kWarps;    // which 16 rows
  const int part = warp / kWarps;  // which key tile of a stage
  const int g = lane >> 2, t = lane & 3;
  const TileOf at = unfold((p.Tq + kBlock - 1) / kBlock);
  const int bh = at.pair;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = at.tile * kBlock;

  const float* kb = head<float>(p.k, p.sk, b, h);
  const float* vb = head<float>(p.v, p.sv, b, h);
  const int n_stages = (p.Tk + L::kKeys - 1) / L::kKeys;

  load_tile<float, D, kS, kBlock, kThreads>(
      sQ, head<float>(p.q, p.sq, b, h), p.sq[2], q0, p.Tq, tid);
  load_tile<float, D, kS, kBlock, kThreads>(
      sO, head<float>(p.dout, p.sdo, b, h), p.sdo[2], q0, p.Tq, tid);
  load_tile<float, D, kS, L::kKeys, kThreads>(sKV, kb, p.sk[2], 0, p.Tk,
                                              tid);
  load_tile<float, D, kS, L::kKeys, kThreads>(sKV + L::kKV, vb, p.sv[2], 0,
                                              p.Tk, tid);
  cp_async_commit();

  const int row0 = q0 + rw * 16 + g;  // and row0 + 8
  const long long base = (long long)bh * p.Tq;
  const float lse0 = row0 < p.Tq ? p.lse[base + row0] : 0.f;
  const float lse1 = row0 + 8 < p.Tq ? p.lse[base + row0 + 8] : 0.f;
  const float dl0 = row0 < p.Tq ? p.delta[base + row0] : 0.f;
  const float dl1 = row0 + 8 < p.Tq ? p.delta[base + row0 + 8] : 0.f;
  HashRow hr0 = {0u, 0u}, hr1 = {0u, 0u};
  if (p.drop.on) {
    hr0 = hash_row(p.drop, bh, row0);
    hr1 = hash_row(p.drop, bh, row0 + 8);
  }
  float dq[kDN][4];
#pragma unroll
  for (int n = 0; n < kDN; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
  const float* qw = sQ + rw * 16 * kS;
  const float* ow = sO + rw * 16 * kS;
  const float inv_keep = 1.f / p.keep;

  for (int j = 0; j < n_stages; ++j) {
    if (j + 1 < n_stages) {
      float* next = sKV + ((j + 1) & 1) * 2 * L::kKV;
      const int r0 = (j + 1) * L::kKeys;
      load_tile<float, D, kS, L::kKeys, kThreads>(next, kb, p.sk[2], r0,
                                                  p.Tk, tid);
      load_tile<float, D, kS, L::kKeys, kThreads>(next + L::kKV, vb,
                                                  p.sv[2], r0, p.Tk, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int kt0 = j * L::kKeys + part * kTile;
    const float* sK = sKV + (j & 1) * 2 * L::kKV + part * kTile * kS;
    const float* sV = sK + L::kKV;

    if (kt0 < p.Tk) {
      // S = Q K^T and dP = dO V^T for this warp's 16 rows and the tile.
      float s[kKN][4], dp[kKN][4];
#pragma unroll
      for (int n = 0; n < kKN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll 2
      for (int kk = 0; kk < D / 8; ++kk) {
        unsigned qab[4], qas[4], oab[4], oas[4];
        load_a<kS>(qw, kk * 8, g, t, qab, qas);
        load_a<kS>(ow, kk * 8, g, t, oab, oas);
#pragma unroll
        for (int n = 0; n < kKN; ++n) {
          const float* kr = sK + (n * 8 + g) * kS + kk * 8 + t;
          const float* vr = sV + (n * 8 + g) * kS + kk * 8 + t;
          unsigned bb[2], bs[2];
          split(kr[0], bb[0], bs[0]);
          split(kr[4], bb[1], bs[1]);
          mma_3xtf32(s[n], qab, qas, bb, bs);
          split(vr[0], bb[0], bs[0]);
          split(vr[4], bb[1], bs[1]);
          mma_3xtf32(dp[n], oab, oas, bb, bs);
        }
      }

      // ds into s; keys past Tk weigh 0.
#pragma unroll
      for (int n = 0; n < kKN; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = kt0 + n * 8 + 2 * t + e;
          const bool valid = key < p.Tk;
          const float p0 = valid ? expf(s[n][e] * p.scale - lse0) : 0.f;
          const float p1 = valid ? expf(s[n][2 + e] * p.scale - lse1) : 0.f;
          float d0 = dp[n][e], d1 = dp[n][2 + e];
          if (p.drop.on) {
            const HashCol hc = hash_col(p.drop, key);
            d0 = hash_keep(p.drop, hr0, hc) ? d0 * inv_keep : 0.f;
            d1 = hash_keep(p.drop, hr1, hc) ? d1 * inv_keep : 0.f;
          }
          s[n][e] = p0 * (d0 - dl0) * p.scale;
          s[n][2 + e] = p1 * (d1 - dl1) * p.scale;
        }
      }

      // dQ += ds K: ds as the A operand, K rows n * 8 + 2t, + 1 as B.
#pragma unroll
      for (int n = 0; n < kKN; ++n) {
        unsigned ab[4], as[4];
        c_as_a(s[n], ab, as);
        const float* kr = sK + (n * 8 + 2 * t) * kS + g;
#pragma unroll
        for (int dn = 0; dn < kDN; ++dn) {
          unsigned bb[2], bs[2];
          split(kr[dn * 8], bb[0], bs[0]);
          split(kr[kS + dn * 8], bb[1], bs[1]);
          mma_3xtf32(dq[dn], ab, as, bb, bs);
        }
      }

    }
    __syncthreads();  // the stage just read is the next copy's target
  }

  if (SPLIT == 2) {
    float* x = sKV + rw * (32 * 4 * kDN);
    if (part == 1) hand_over(dq, x, lane);
    __syncthreads();
    if (part == 1) return;
    take_over(dq, x, lane);
  }
  // This warp's Q rows are its alone now: stage dQ there.
  store_rows<float, kDN, kS>(dq, sQ + rw * 16 * kS,
                             head<float>(p.dq, p.sdq, b, h), p.sdq[2],
                             q0 + rw * 16, p.Tq, lane);
}

// ---------------------------------------------------------------------------
// Head dim 256 (any dh in (128, 256], zero-padded by the wrapper): one
// 8-warp block owns 64 keys (dK/dV) or query rows (dQ), warps w and w + 4
// (half 0 and half 1) the same 16, half c columns [128 c, 128 c + 128) of
// every operand and gradient.  For each 16-row (16-key) tile each warp
// computes its partials S^T_c and dP^T_c (S_c and dP_c) over its 128
// columns, stores them and meets its partner at named barrier 1 + w
// (`pair_sync`); both then hold S = S_0 + S_1 and dP = dP_0 + dP_1
// (`pair_sum`, the same floats in both), form the same P, Pd and dS, and
// take their own columns of dV, dK (dQ): 8 + 6 = 14 chunk products a tile
// pair, none repeated; no atomics.  The operands at full width and the
// partials take 212 KB (dK/dV) or 211 KB (dQ): one block, 8 warps an SM.
// ---------------------------------------------------------------------------
constexpr int kPairThreads = 2 * 32 * kWarps;
constexpr int kPairS = 2 * kGroup + 4;  // float row stride
constexpr int kPairW = 2 * kGroup;      // the padded head dim

// dK/dV: K and V of the block's 64 keys stay; 16-row tiles of Q and dO,
// with the rows' lse, delta and hash words, stream through the ring.
struct PairDkvLayout {
  static constexpr int kKV = kBlock * kPairS;          // K or V
  static constexpr int kOperands = 2 * kTile * kPairS;  // Q, dO rows
  static constexpr int kStage = kOperands + 4 * kTile;
  static constexpr int kQN = kTile / 8;                // 8-query tiles
  // The partials of every warp: S^T, then dP^T, float4 (n, lane) each.
  static constexpr int kWarpX = 2 * kQN * 32 * 4;
  static constexpr int kX = 2 * kWarps * kWarpX;
  static constexpr size_t kBytes =
      (2 * kKV + 2 * kStage + kX) * sizeof(float);
  static_assert(kBytes <= 232448 && kStage * sizeof(float) % 16 == 0,
                "shared memory");
};

__global__ void __launch_bounds__(kPairThreads, 1)
flash_bwd_dkv_kernel_pair(const Params p) {
  using L = PairDkvLayout;
  constexpr int kS = kPairS;
  constexpr int kDN = kGroup / 8;
  constexpr int kQN = L::kQN;
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);
  float* sV = sK + L::kKV;
  float* ring = sV + L::kKV;
  float* sX = ring + 2 * L::kStage;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int kw = warp % kWarps;    // which 16 keys
  const int half = warp / kWarps;  // which 128 columns
  const int g = lane >> 2, t = lane & 3;
  const int col0 = half * kGroup;
  const TileOf at = unfold((p.Tk + kBlock - 1) / kBlock);
  const int bh = at.pair;
  const int b = bh / p.H, h = bh % p.H;
  const int k0 = at.tile * kBlock;
  const float* qb = head<float>(p.q, p.sq, b, h);
  const float* ob = head<float>(p.dout, p.sdo, b, h);
  const float* lse = p.lse + (long long)bh * p.Tq;
  const float* delta = p.delta + (long long)bh * p.Tq;
  const int n_tiles = (p.Tq + kTile - 1) / kTile;

  auto load_stage = [&](int j) {
    float* st = ring + (j & 1) * L::kStage;
    const int r0 = j * kTile;
    load_tile<float, kPairW, kS, kTile, kPairThreads>(st, qb, p.sq[2], r0,
                                                      p.Tq, tid);
    load_tile<float, kPairW, kS, kTile, kPairThreads>(
        st + kTile * kS, ob, p.sdo[2], r0, p.Tq, tid);
    if (tid < kTile) {
      float* sl = st + L::kOperands;
      const int row = r0 + tid;
      if (row < p.Tq) {
        cp_async4(sl + tid, lse + row, 4);
        cp_async4(sl + kTile + tid, delta + row, 4);
      } else {
        sl[tid] = INFINITY;  // p = exp(s - inf) = 0
        sl[kTile + tid] = 0.f;
      }
      if (p.drop.on) {
        const HashRow hr = hash_row(
            p.drop, unfold_again((p.Tk + kBlock - 1) / kBlock).pair, row);
        reinterpret_cast<unsigned*>(sl)[2 * kTile + tid] = hr.tile;
        reinterpret_cast<unsigned*>(sl)[3 * kTile + tid] = hr.row;
      }
    }
  };

  load_tile<float, kPairW, kS, kBlock, kPairThreads>(
      sK, head<float>(p.k, p.sk, b, h), p.sk[2], k0, p.Tk, tid);
  load_tile<float, kPairW, kS, kBlock, kPairThreads>(
      sV, head<float>(p.v, p.sv, b, h), p.sv[2], k0, p.Tk, tid);
  load_stage(0);
  cp_async_commit();

  float dk[kDN][4], dv[kDN][4];
#pragma unroll
  for (int n = 0; n < kDN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  HashCol hc0 = {0u, 0u}, hc1 = {0u, 0u};
  if (p.drop.on) {
    hc0 = hash_col(p.drop, k0 + kw * 16 + g);
    hc1 = hash_col(p.drop, k0 + kw * 16 + g + 8);
  }
  const float* kt = sK + kw * 16 * kS + col0;
  const float* vt = sV + kw * 16 * kS + col0;
  const float inv_keep = 1.f / p.keep;
  // This warp's partials and its partner's: S^T, then dP^T.
  float* xw = sX + (half * kWarps + kw) * L::kWarpX;
  const float* xp = sX + ((1 - half) * kWarps + kw) * L::kWarpX;

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      load_stage(j + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* st = ring + (j & 1) * L::kStage;
    const float* sQ = st + col0;
    const float* sO = st + kTile * kS + col0;

    // The partials S^T_c = K_c Q_c^T and dP^T_c = V_c dO_c^T of this
    // warp's 16 keys and the tile's 16 queries.
    float s[kQN][4], dp[kQN][4];
#pragma unroll
    for (int n = 0; n < kQN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < kGroup / 8; ++kk) {
      unsigned ab[4], as[4];
      load_a<kS>(kt, kk * 8, g, t, ab, as);
#pragma unroll
      for (int n = 0; n < kQN; ++n) {
        const float* qr = sQ + (n * 8 + g) * kS + kk * 8 + t;
        unsigned bb[2], bs[2];
        split(qr[0], bb[0], bs[0]);
        split(qr[4], bb[1], bs[1]);
        mma_3xtf32(s[n], ab, as, bb, bs);
      }
      load_a<kS>(vt, kk * 8, g, t, ab, as);
#pragma unroll
      for (int n = 0; n < kQN; ++n) {
        const float* orow = sO + (n * 8 + g) * kS + kk * 8 + t;
        unsigned bb[2], bs[2];
        split(orow[0], bb[0], bs[0]);
        split(orow[4], bb[1], bs[1]);
        mma_3xtf32(dp[n], ab, as, bb, bs);
      }
    }
    // S^T = S^T_0 + S^T_1, dP^T = dP^T_0 + dP^T_1.
    put_partials<kQN>(xw, &s[0][0], 32, lane);
    put_partials<kQN>(xw + kQN * 32 * 4, &dp[0][0], 32, lane);
    pair_sync(kw);
    pair_sum<kQN>(&s[0][0], xp, 32, lane);
    pair_sum<kQN>(&dp[0][0], xp + kQN * 32 * 4, 32, lane);

    // P^T, then Pd^T into s and dS^T into dp; rows g, g + 8 are keys,
    // column 2t + e of tile n is query n * 8 + 2t + e of the tile.
    const float* sl = st + L::kOperands;
    const unsigned* sh = reinterpret_cast<const unsigned*>(sl);
#pragma unroll
    for (int n = 0; n < kQN; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n * 8 + 2 * t + e;
        const float l = sl[col], dl = sl[kTile + col];
        const float p0 = expf(s[n][e] * p.scale - l);
        const float p1 = expf(s[n][2 + e] * p.scale - l);
        float pd0 = p0, pd1 = p1, d0 = dp[n][e], d1 = dp[n][2 + e];
        if (p.drop.on) {
          const HashRow hr = {sh[2 * kTile + col], sh[3 * kTile + col]};
          const bool keep0 = hash_keep(p.drop, hr, hc0);
          const bool keep1 = hash_keep(p.drop, hr, hc1);
          pd0 = keep0 ? p0 * inv_keep : 0.f;
          d0 = keep0 ? d0 * inv_keep : 0.f;
          pd1 = keep1 ? p1 * inv_keep : 0.f;
          d1 = keep1 ? d1 * inv_keep : 0.f;
        }
        s[n][e] = pd0;
        s[n][2 + e] = pd1;
        dp[n][e] = p0 * (d0 - dl) * p.scale;
        dp[n][2 + e] = p1 * (d1 - dl) * p.scale;
      }
    }

    // dV_c += Pd^T dO_c, dK_c += dS^T Q_c: the C fragments as A operands,
    // the dO_c and Q_c rows n * 8 + 2t, + 1 as B.
#pragma unroll
    for (int n = 0; n < kQN; ++n) {
      unsigned ab[4], as[4];
      c_as_a(s[n], ab, as);
      const float* orow = sO + (n * 8 + 2 * t) * kS + g;
#pragma unroll
      for (int dn = 0; dn < kDN; ++dn) {
        unsigned bb[2], bs[2];
        split(orow[dn * 8], bb[0], bs[0]);
        split(orow[kS + dn * 8], bb[1], bs[1]);
        mma_3xtf32(dv[dn], ab, as, bb, bs);
      }
      c_as_a(dp[n], ab, as);
      const float* qr = sQ + (n * 8 + 2 * t) * kS + g;
#pragma unroll
      for (int dn = 0; dn < kDN; ++dn) {
        unsigned bb[2], bs[2];
        split(qr[dn * 8], bb[0], bs[0]);
        split(qr[kS + dn * 8], bb[1], bs[1]);
        mma_3xtf32(dk[dn], ab, as, bb, bs);
      }
    }
    __syncthreads();  // the stage and the partials just read are refilled
  }

  // Each warp's half of its K and V rows is its alone: stage dK_c and
  // dV_c there.
  const TileOf end = unfold_again((p.Tk + kBlock - 1) / kBlock);
  const int eb = end.pair / p.H, eh = end.pair % p.H;
  const int ek = end.tile * kBlock + kw * 16;
  store_rows<float, kDN, kS>(dk, sK + kw * 16 * kS + col0,
                             head<float>(p.dk, p.sdk, eb, eh) + col0,
                             p.sdk[2], ek, p.Tk, lane);
  store_rows<float, kDN, kS>(dv, sV + kw * 16 * kS + col0,
                             head<float>(p.dv, p.sdv, eb, eh) + col0,
                             p.sdv[2], ek, p.Tk, lane);
}

// dQ: Q and dO of the block's 64 rows stay; 16-key tiles of K and V
// stream through the ring.
struct PairDqLayout {
  static constexpr int kQ = kBlock * kPairS;     // Q or dO
  static constexpr int kKV = kTile * kPairS;     // K or V of a tile
  static constexpr int kStage = 2 * kKV;
  static constexpr int kKN = kTile / 8;          // 8-key tiles
  static constexpr int kWarpX = 2 * kKN * 32 * 4;  // S, then dP
  static constexpr int kX = 2 * kWarps * kWarpX;
  static constexpr size_t kBytes =
      (2 * kQ + 2 * kStage + kX) * sizeof(float);
  static_assert(kBytes <= 232448, "shared memory");
};

__global__ void __launch_bounds__(kPairThreads, 1)
flash_bwd_dq_kernel_pair(const Params p) {
  using L = PairDqLayout;
  constexpr int kS = kPairS;
  constexpr int kDN = kGroup / 8;
  constexpr int kKN = L::kKN;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sO = sQ + L::kQ;
  float* ring = sO + L::kQ;  // stage s: K at ring + s kStage, V after it
  float* sX = ring + 2 * L::kStage;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rw = warp % kWarps;    // which 16 rows
  const int half = warp / kWarps;  // which 128 columns
  const int g = lane >> 2, t = lane & 3;
  const int col0 = half * kGroup;
  const TileOf at = unfold((p.Tq + kBlock - 1) / kBlock);
  const int bh = at.pair;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = at.tile * kBlock;
  const float* kb = head<float>(p.k, p.sk, b, h);
  const float* vb = head<float>(p.v, p.sv, b, h);
  const int n_tiles = (p.Tk + kTile - 1) / kTile;

  load_tile<float, kPairW, kS, kBlock, kPairThreads>(
      sQ, head<float>(p.q, p.sq, b, h), p.sq[2], q0, p.Tq, tid);
  load_tile<float, kPairW, kS, kBlock, kPairThreads>(
      sO, head<float>(p.dout, p.sdo, b, h), p.sdo[2], q0, p.Tq, tid);
  load_tile<float, kPairW, kS, kTile, kPairThreads>(ring, kb, p.sk[2], 0,
                                                    p.Tk, tid);
  load_tile<float, kPairW, kS, kTile, kPairThreads>(ring + L::kKV, vb,
                                                    p.sv[2], 0, p.Tk, tid);
  cp_async_commit();

  const int row0 = q0 + rw * 16 + g;  // and row0 + 8
  const long long base = (long long)bh * p.Tq;
  const float lse0 = row0 < p.Tq ? p.lse[base + row0] : 0.f;
  const float lse1 = row0 + 8 < p.Tq ? p.lse[base + row0 + 8] : 0.f;
  const float dl0 = row0 < p.Tq ? p.delta[base + row0] : 0.f;
  const float dl1 = row0 + 8 < p.Tq ? p.delta[base + row0 + 8] : 0.f;
  HashRow hr0 = {0u, 0u}, hr1 = {0u, 0u};
  if (p.drop.on) {
    hr0 = hash_row(p.drop, bh, row0);
    hr1 = hash_row(p.drop, bh, row0 + 8);
  }
  float dq[kDN][4];
#pragma unroll
  for (int n = 0; n < kDN; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
  const float* qw = sQ + rw * 16 * kS + col0;
  const float* ow = sO + rw * 16 * kS + col0;
  const float inv_keep = 1.f / p.keep;
  // This warp's partials and its partner's: S, then dP.
  float* xw = sX + (half * kWarps + rw) * L::kWarpX;
  const float* xp = sX + ((1 - half) * kWarps + rw) * L::kWarpX;

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      float* next = ring + ((j + 1) & 1) * L::kStage;
      const int r0 = (j + 1) * kTile;
      load_tile<float, kPairW, kS, kTile, kPairThreads>(next, kb, p.sk[2],
                                                        r0, p.Tk, tid);
      load_tile<float, kPairW, kS, kTile, kPairThreads>(
          next + L::kKV, vb, p.sv[2], r0, p.Tk, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* sK = ring + (j & 1) * L::kStage + col0;
    const float* sV = sK + L::kKV;

    // The partials S_c = Q_c K_c^T and dP_c = dO_c V_c^T of this warp's
    // 16 rows and the tile's 16 keys.
    float s[kKN][4], dp[kKN][4];
#pragma unroll
    for (int n = 0; n < kKN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < kGroup / 8; ++kk) {
      unsigned qab[4], qas[4], oab[4], oas[4];
      load_a<kS>(qw, kk * 8, g, t, qab, qas);
      load_a<kS>(ow, kk * 8, g, t, oab, oas);
#pragma unroll
      for (int n = 0; n < kKN; ++n) {
        const float* kr = sK + (n * 8 + g) * kS + kk * 8 + t;
        const float* vr = sV + (n * 8 + g) * kS + kk * 8 + t;
        unsigned bb[2], bs[2];
        split(kr[0], bb[0], bs[0]);
        split(kr[4], bb[1], bs[1]);
        mma_3xtf32(s[n], qab, qas, bb, bs);
        split(vr[0], bb[0], bs[0]);
        split(vr[4], bb[1], bs[1]);
        mma_3xtf32(dp[n], oab, oas, bb, bs);
      }
    }
    // S = S_0 + S_1, dP = dP_0 + dP_1.
    put_partials<kKN>(xw, &s[0][0], 32, lane);
    put_partials<kKN>(xw + kKN * 32 * 4, &dp[0][0], 32, lane);
    pair_sync(rw);
    pair_sum<kKN>(&s[0][0], xp, 32, lane);
    pair_sum<kKN>(&dp[0][0], xp + kKN * 32 * 4, 32, lane);

    // ds into s; keys past Tk weigh 0.
    const int kt0 = j * kTile;
#pragma unroll
    for (int n = 0; n < kKN; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = kt0 + n * 8 + 2 * t + e;
        const bool valid = key < p.Tk;
        const float p0 = valid ? expf(s[n][e] * p.scale - lse0) : 0.f;
        const float p1 = valid ? expf(s[n][2 + e] * p.scale - lse1) : 0.f;
        float d0 = dp[n][e], d1 = dp[n][2 + e];
        if (p.drop.on) {
          const HashCol hc = hash_col(p.drop, key);
          d0 = hash_keep(p.drop, hr0, hc) ? d0 * inv_keep : 0.f;
          d1 = hash_keep(p.drop, hr1, hc) ? d1 * inv_keep : 0.f;
        }
        s[n][e] = p0 * (d0 - dl0) * p.scale;
        s[n][2 + e] = p1 * (d1 - dl1) * p.scale;
      }
    }

    // dQ_c += ds K_c: ds as the A operand, K_c rows n * 8 + 2t, + 1 as B.
#pragma unroll
    for (int n = 0; n < kKN; ++n) {
      unsigned ab[4], as[4];
      c_as_a(s[n], ab, as);
      const float* kr = sK + (n * 8 + 2 * t) * kS + g;
#pragma unroll
      for (int dn = 0; dn < kDN; ++dn) {
        unsigned bb[2], bs[2];
        split(kr[dn * 8], bb[0], bs[0]);
        split(kr[kS + dn * 8], bb[1], bs[1]);
        mma_3xtf32(dq[dn], ab, as, bb, bs);
      }
    }
    __syncthreads();  // the stage and the partials just read are refilled
  }

  // This warp's half of its Q rows is its alone: stage dQ_c there.
  store_rows<float, kDN, kS>(dq, sQ + rw * 16 * kS + col0,
                             head<float>(p.dq, p.sdq, b, h) + col0, p.sdq[2],
                             q0 + rw * 16, p.Tq, lane);
}

// ---------------------------------------------------------------------------
// Head dims above 256 (any multiple of 128): a cluster of nc = dh / 128
// blocks along grid z (cluster.cuh), block c (its rank) owning column chunk
// c of every operand and of the gradients.  Each
// block computes the partial S (S^T) and dP (dP^T) over its own 128
// columns, puts them in its exchange buffer, and after one cluster barrier
// sums the nc partials in rank order (its own from its shared memory, the
// others' from the cluster's, `cluster_sum`): every block then holds the
// same S and dP, forms the same P, Pd and dS,
// and takes its own columns of the gradient products.  A tile pair costs
// the dK/dV blocks 4 nc chunk products (S^T, dP^T, dV, dK) and the dQ
// blocks 3 nc (S, dP, dQ): 7 nc, none repeated; no atomics.  The streamed
// operands come through a 2-stage cp.async ring whose next stage is issued
// right after the barrier (every thread of the block is then past the
// stage it refills); the exchange buffers alternate by tile, so one
// barrier a tile suffices.  Above 128 kClusterMax (kMulti) a cluster of
// C = cluster_blocks(nc) blocks shares the tile, block r owning chunks
// r + i C (cluster.cuh): it adds the partials of its chunks after the
// first to its partials in chunk order, and keeps their gradient
// accumulators in the scratch buffer (which the dK/dV and dQ launches
// share, one after the other), their operands read from global memory
// (chunk_frags.cuh); still 7 nc chunk products a tile pair.
// ---------------------------------------------------------------------------
constexpr int kClusterTile = 32;  // query rows (dK/dV) or keys (dQ) a tile

// Another chunk's partial over 8 of its columns [c, c + 8), in 3xTF32: for
// a warp's 16 rows [r0, r0 + 16) of `a` (the A operand's rows) and N 8-row
// tiles from row n0 of `b` (the B operand's rows), into acc[N].
template <int N>
__device__ __forceinline__ void chunk_partial_f32(
    float (&acc)[N][4], const GlobalRows<float>& a, const GlobalRows<float>& b,
    int r0, int n0, int c, int g, int t) {
  float x[4];
  unsigned ab[4], as[4];
  gfrag_a(a, r0, c, g, t, x);
#pragma unroll
  for (int e = 0; e < 4; ++e) split(x[e], ab[e], as[e]);
#pragma unroll
  for (int n = 0; n < N; ++n) {
    float y[2];
    unsigned bb[2], bs[2];
    gfrag_b_rows(b, n0 + n * 8, c, g, t, y);
    split(y[0], bb[0], bs[0]);
    split(y[1], bb[1], bs[1]);
    mma_3xtf32(acc[n], ab, as, bb, bs);
  }
}

// The same over 16 columns [c, c + 16) in bf16.
template <int N>
__device__ __forceinline__ void chunk_partial_bf16(
    float (&acc)[N][4], const GlobalRows<bf16>& a, const GlobalRows<bf16>& b,
    int r0, int n0, int c, int g, int t) {
  unsigned x[4];
  gfrag_a(a, r0, c, g, t, x);
#pragma unroll
  for (int n = 0; n < N; ++n) {
    unsigned y[2];
    gfrag_b_rows(b, n0 + n * 8, c, g, t, y);
    mma_bf16(acc[n], x, y);
  }
}

// Rows [0, n) of the (time, dh) operand at `base` (strides s) of this
// block's (batch, head): the block index read afresh (`unfold_again`, over
// `tiles` row tiles a pair), so that a kernel at its register cap holds
// none of it across its tile loop.
template <typename T>
__device__ __forceinline__ GlobalRows<T> rows_of(const void* base,
                                                 const long long* s, int n,
                                                 int tiles, int H) {
  const int bh = unfold_again(tiles).pair;
  return {head<T>(base, s, bh / H, bh % H), s[2], n};
}

// A float4 of this block's shared memory, loaded where the code stands:
// the compiler may not hoist it out of a loop and hold it (or what is
// made of it) in registers.
__device__ __forceinline__ void ld_shared4_here(float (&d)[4],
                                                const float4* p) {
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p)))
               : "memory");
}

// A gradient's accumulators of another chunk, C fragments of its 8 DN
// columns [c0, c0 + 8 DN) in the scratch buffer (float4 dn at
// acc[dn * blockDim.x]; zero before the first tile), += C B over the N
// 8-column C fragments of a tile's 8 N queries or keys (as A: `c_as_a` /
// `c_pair_as_a`), which `put_partials` parked in shared memory (fragment
// n at c[32 n]), and rows [k0, k0 + 8 N) of `b`.  One k step at a time
// across the columns, its A fragment read back from shared memory for
// each product, so that none is held across the column loop (the dQ
// kernel holds its first chunk's accumulators beside it).
template <typename T, int N, int DN>
__device__ __forceinline__ void chunk_products(float4* acc, bool first,
                                               const float4* c,
                                               const GlobalRows<T>& b,
                                               int k0, int c0, int g, int t) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int kSteps = kF32 ? N : N / 2;
#pragma unroll
  for (int n = 0; n < kSteps; ++n) {
#pragma unroll 1
    for (int dn = 0; dn < DN; ++dn) {
      unsigned ab[4], as[4];
      if constexpr (kF32) {
        float f[4];
        ld_shared4_here(f, c + 32 * n);
        c_as_a(f, ab, as);
      } else {
        float f0[4], f1[4];
        ld_shared4_here(f0, c + 64 * n);
        ld_shared4_here(f1, c + 64 * n + 32);
        c_pair_as_a(f0, f1, ab);
      }
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      if (!first || n > 0) load4(d, acc + dn * blockDim.x);
      if constexpr (kF32) {
        float y[2];
        unsigned bb[2], bs[2];
        gfrag_b_cols(b, k0 + n * 8, c0 + dn * 8, g, t, y);
        split(y[0], bb[0], bs[0]);
        split(y[1], bb[1], bs[1]);
        mma_3xtf32(d, ab, as, bb, bs);
      } else {
        unsigned bb[2];
        gfrag_b_cols(b, k0 + n * 16, c0 + dn * 8, g, t, bb);
        mma_bf16(d, ab, bb);
      }
      store4(acc + dn * blockDim.x, d);
    }
  }
}

// A warp's accumulators of another chunk (N float4 a thread in the
// scratch buffer, C fragments of rows [r0, r0 + 16)) into columns
// [c, c + 8 N) of a (time, dh) output of T, rows past n not stored.
template <typename T, int N>
__device__ __forceinline__ void store_chunk(const float4* acc, T* out,
                                            long long stride, int r0, int n,
                                            int c, int g, int t) {
#pragma unroll 1
  for (int dn = 0; dn < N; ++dn) {
    float d[4];
    load4(d, acc + dn * blockDim.x);
    const int col = c + dn * 8 + 2 * t;
    if (r0 + g < n) store2(out + (r0 + g) * stride + col, d[0], d[1]);
    if (r0 + g + 8 < n)
      store2(out + (r0 + g + 8) * stride + col, d[2], d[3]);
  }
}

// dK/dV: a cluster owns 64 keys; K_c and V_c stay in shared memory, and
// 32-row tiles of Q_c and dO_c, with the rows' lse, delta and hash words,
// stream through the ring.
template <typename T>
struct ClusterDkvLayout {
  static constexpr int kS = kGroup + 16 / sizeof(T);  // operand row stride
  static constexpr int kKV = kBlock * kS;             // K_c or V_c
  static constexpr int kRows = kClusterTile * kS;     // Q_c or dO_c
  static constexpr int kOperands = 2 * kRows;
  static constexpr int kStage = kOperands + 4 * kClusterTile * (4 / sizeof(T));
  static constexpr int kQN = kClusterTile / 8;        // 8-query tiles
  // One exchange buffer: S^T, then dP^T partials (floats).
  static constexpr int kX = 2 * kWarps * kQN * 32 * 4;
  static constexpr size_t kBytes =
      (2 * kKV + 2 * kStage) * sizeof(T) + 2 * kX * sizeof(float);
  static_assert(kBytes <= 232448 && kStage * sizeof(T) % 16 == 0,
                "shared memory");
};

template <typename T, bool kMulti>
__global__ void __launch_bounds__(32 * kWarps, 1)
flash_bwd_dkv_kernel_cluster(const Params p) {
  using L = ClusterDkvLayout<T>;
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int kS = L::kS;
  constexpr int kThreads = 32 * kWarps;
  constexpr int kDN = kGroup / 8;
  constexpr int kQN = L::kQN;
  extern __shared__ float4 smem4[];
  T* sK = reinterpret_cast<T*>(smem4);
  T* sV = sK + L::kKV;
  T* ring = sV + L::kKV;
  float* sX = reinterpret_cast<float*>(ring + 2 * L::kStage);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int kw = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int cs = gridDim.z;  // blocks of the cluster
  const unsigned rank = cluster_rank();
  const int col0 = rank * kGroup;
  const TileOf at = unfold((p.Tk + kBlock - 1) / kBlock);
  const int bh = at.pair;
  const int b = bh / p.H, h = bh % p.H;
  const int k0 = at.tile * kBlock;
  const T* qb = head<T>(p.q, p.sq, b, h) + col0;
  const T* ob = head<T>(p.dout, p.sdo, b, h) + col0;
  const float* lse = p.lse + (long long)bh * p.Tq;
  const float* delta = p.delta + (long long)bh * p.Tq;
  const int n_tiles = (p.Tq + kClusterTile - 1) / kClusterTile;
  // The block's chunks after its first (kMulti): rank + i cs, i < chunks.
  const int chunks = chunks_per_block(p.nc);

  auto load_stage = [&](int j) {
    T* st = ring + (j & 1) * L::kStage;
    const int r0 = j * kClusterTile;
    load_tile<T, kGroup, kS, kClusterTile, kThreads>(st, qb, p.sq[2], r0,
                                                     p.Tq, tid);
    load_tile<T, kGroup, kS, kClusterTile, kThreads>(st + L::kRows, ob,
                                                     p.sdo[2], r0, p.Tq, tid);
    if (tid < kClusterTile) {
      float* sl = reinterpret_cast<float*>(st + L::kOperands);
      const int row = r0 + tid;
      if (row < p.Tq) {
        cp_async4(sl + tid, lse + row, 4);
        cp_async4(sl + kClusterTile + tid, delta + row, 4);
      } else {
        sl[tid] = INFINITY;  // p = exp(s - inf) = 0
        sl[kClusterTile + tid] = 0.f;
      }
      if (p.drop.on) {
        const HashRow hr = hash_row(
            p.drop, unfold_again((p.Tk + kBlock - 1) / kBlock).pair, row);
        reinterpret_cast<unsigned*>(sl)[2 * kClusterTile + tid] = hr.tile;
        reinterpret_cast<unsigned*>(sl)[3 * kClusterTile + tid] = hr.row;
      }
    }
  };

  load_tile<T, kGroup, kS, kBlock, kThreads>(
      sK, head<T>(p.k, p.sk, b, h) + col0, p.sk[2], k0, p.Tk, tid);
  load_tile<T, kGroup, kS, kBlock, kThreads>(
      sV, head<T>(p.v, p.sv, b, h) + col0, p.sv[2], k0, p.Tk, tid);
  load_stage(0);
  cp_async_commit();

  float dk[kDN][4], dv[kDN][4];
#pragma unroll
  for (int n = 0; n < kDN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  HashCol hc0 = {0u, 0u}, hc1 = {0u, 0u};
  if (p.drop.on) {
    hc0 = hash_col(p.drop, k0 + kw * 16 + g);
    hc1 = hash_col(p.drop, k0 + kw * 16 + g + 8);
  }
  const T* kt = sK + kw * 16 * kS;
  const T* vt = sV + kw * 16 * kS;
  const float inv_keep = 1.f / p.keep;
  // This warp's partials: float4 (n, lane) of S^T, then of dP^T.
  const int xoff = kw * kQN * 32 + lane;

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<0>();
    __syncthreads();
    const T* st = ring + (j & 1) * L::kStage;
    const T* sQ = st;
    const T* sO = st + L::kRows;
    float* xb = sX + (j & 1) * L::kX;

    // The partials S^T_c = K_c Q_c^T and dP^T_c = V_c dO_c^T of this
    // warp's 16 keys and the tile's 32 queries.
    float s[kQN][4], dp[kQN][4];
#pragma unroll
    for (int n = 0; n < kQN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    if constexpr (kF32) {
#pragma unroll 2
      for (int kk = 0; kk < kGroup / 8; ++kk) {
        unsigned ab[4], as[4];
        load_a<kS>(kt, kk * 8, g, t, ab, as);
#pragma unroll
        for (int n = 0; n < kQN; ++n) {
          const float* qr = sQ + (n * 8 + g) * kS + kk * 8 + t;
          unsigned bb[2], bs[2];
          split(qr[0], bb[0], bs[0]);
          split(qr[4], bb[1], bs[1]);
          mma_3xtf32(s[n], ab, as, bb, bs);
        }
        load_a<kS>(vt, kk * 8, g, t, ab, as);
#pragma unroll
        for (int n = 0; n < kQN; ++n) {
          const float* orow = sO + (n * 8 + g) * kS + kk * 8 + t;
          unsigned bb[2], bs[2];
          split(orow[0], bb[0], bs[0]);
          split(orow[4], bb[1], bs[1]);
          mma_3xtf32(dp[n], ab, as, bb, bs);
        }
      }
    } else {
#pragma unroll 2
      for (int kk = 0; kk < kGroup / 16; ++kk) {
        unsigned a[4];
        load_a_bf16<kS>(kt, kk * 16, g, t, a);
#pragma unroll
        for (int n = 0; n < kQN; ++n) {
          unsigned bb[2];
          load_b_rows<kS>(sQ, n * 8, kk * 16, g, t, bb);
          mma_bf16(s[n], a, bb);
        }
        load_a_bf16<kS>(vt, kk * 16, g, t, a);
#pragma unroll
        for (int n = 0; n < kQN; ++n) {
          unsigned bb[2];
          load_b_rows<kS>(sO, n * 8, kk * 16, g, t, bb);
          mma_bf16(dp[n], a, bb);
        }
      }
    }
    if constexpr (kMulti) {
      // The partials of the block's other chunks, added in chunk order:
      // S^T, then dP^T.
      const int r0 = j * kClusterTile;
      const int tiles = (p.Tk + kBlock - 1) / kBlock;
      const int kr = unfold_again(tiles).tile * kBlock + kw * 16;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const GlobalRows<T> ga = rows_of<T>(half ? p.v : p.k,
                                            half ? p.sv : p.sk, p.Tk, tiles,
                                            p.H);
        const GlobalRows<T> gb = rows_of<T>(half ? p.dout : p.q,
                                            half ? p.sdo : p.sq, p.Tq, tiles,
                                            p.H);
        float (&acc)[kQN][4] = half ? dp : s;
        for (int i = 1; i < chunks && rank + i * cs < p.nc; ++i) {
          const int cc = (rank + i * cs) * kGroup;
          if constexpr (kF32) {
#pragma unroll 1
            for (int kk = 0; kk < kGroup / 8; ++kk)
              chunk_partial_f32<kQN>(acc, ga, gb, kr, r0, cc + kk * 8, g, t);
          } else {
#pragma unroll 1
            for (int kk = 0; kk < kGroup / 16; ++kk)
              chunk_partial_bf16<kQN>(acc, ga, gb, kr, r0, cc + kk * 16, g,
                                      t);
          }
        }
      }
    }
    put_partials<kQN>(xb, &s[0][0], 32, xoff);
    put_partials<kQN>(xb + L::kX / 2, &dp[0][0], 32, xoff);
    cluster_sync();
    // Every thread of the block is past tile j - 1: refill its stage.
    if (j + 1 < n_tiles) load_stage(j + 1);
    cp_async_commit();
    cluster_sum<kQN>(&s[0][0], xb, 32, xoff, cs, rank);
    cluster_sum<kQN>(&dp[0][0], xb + L::kX / 2, 32, xoff, cs, rank);

    // P^T, then Pd^T into s and dS^T into dp; rows g, g + 8 are keys,
    // column 2t + e of tile n is query n * 8 + 2t + e of the tile.
    const float* sl = reinterpret_cast<const float*>(st + L::kOperands);
    const unsigned* sh = reinterpret_cast<const unsigned*>(sl);
#pragma unroll
    for (int n = 0; n < kQN; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n * 8 + 2 * t + e;
        const float l = sl[col], dl = sl[kClusterTile + col];
        const float p0 = expf(s[n][e] * p.scale - l);
        const float p1 = expf(s[n][2 + e] * p.scale - l);
        float pd0 = p0, pd1 = p1, d0 = dp[n][e], d1 = dp[n][2 + e];
        if (p.drop.on) {
          const HashRow hr = {sh[2 * kClusterTile + col],
                              sh[3 * kClusterTile + col]};
          const bool keep0 = hash_keep(p.drop, hr, hc0);
          const bool keep1 = hash_keep(p.drop, hr, hc1);
          pd0 = keep0 ? p0 * inv_keep : 0.f;
          d0 = keep0 ? d0 * inv_keep : 0.f;
          pd1 = keep1 ? p1 * inv_keep : 0.f;
          d1 = keep1 ? d1 * inv_keep : 0.f;
        }
        s[n][e] = pd0;
        s[n][2 + e] = pd1;
        dp[n][e] = p0 * (d0 - dl) * p.scale;
        dp[n][2 + e] = p1 * (d1 - dl) * p.scale;
      }
    }

    // dV_c += Pd^T dO_c, dK_c += dS^T Q_c: the C fragments as A operands,
    // the dO_c and Q_c rows as B.  (kMulti: below, every chunk alike.)
    if constexpr (kF32 && !kMulti) {
#pragma unroll
      for (int n = 0; n < kQN; ++n) {
        unsigned ab[4], as[4];
        c_as_a(s[n], ab, as);
        const float* orow = sO + (n * 8 + 2 * t) * kS + g;
#pragma unroll
        for (int dn = 0; dn < kDN; ++dn) {
          unsigned bb[2], bs[2];
          split(orow[dn * 8], bb[0], bs[0]);
          split(orow[kS + dn * 8], bb[1], bs[1]);
          mma_3xtf32(dv[dn], ab, as, bb, bs);
        }
        c_as_a(dp[n], ab, as);
        const float* qr = sQ + (n * 8 + 2 * t) * kS + g;
#pragma unroll
        for (int dn = 0; dn < kDN; ++dn) {
          unsigned bb[2], bs[2];
          split(qr[dn * 8], bb[0], bs[0]);
          split(qr[kS + dn * 8], bb[1], bs[1]);
          mma_3xtf32(dk[dn], ab, as, bb, bs);
        }
      }
    } else if constexpr (!kMulti) {
#pragma unroll
      for (int kb2 = 0; kb2 < kQN / 2; ++kb2) {
        unsigned a[4];
        c_pair_as_a(s[2 * kb2], s[2 * kb2 + 1], a);
#pragma unroll
        for (int dn = 0; dn < kDN; ++dn) {
          unsigned bb[2];
          load_b_cols<kS>(sO, kb2 * 16, dn * 8, g, t, bb);
          mma_bf16(dv[dn], a, bb);
        }
        c_pair_as_a(dp[2 * kb2], dp[2 * kb2 + 1], a);
#pragma unroll
        for (int dn = 0; dn < kDN; ++dn) {
          unsigned bb[2];
          load_b_cols<kS>(sQ, kb2 * 16, dn * 8, g, t, bb);
          mma_bf16(dk[dn], a, bb);
        }
      }
    }
    if constexpr (kMulti) {
      // dV_c += Pd^T dO_c, dK_c += dS^T Q_c for every chunk c the block
      // owns, its first too, their accumulators in the scratch buffer
      // (place i for chunk i; zero before the first tile: dV at float4
      // dn, dK at kDN + dn) and the dO_c and Q_c rows read from global
      // memory: the 128 accumulators a thread of the one-chunk kernel
      // holds, beside this kernel's other work, spilled.  Pd^T and dS^T
      // wait in this thread's places of the other exchange buffer, which
      // every block of the cluster has finished reading (it passed this
      // tile's barrier) and this block refills next tile.
      float* park = sX + ((j + 1) & 1) * L::kX;
      put_partials<kQN>(park, &s[0][0], 32, xoff);
      put_partials<kQN>(park + L::kX / 2, &dp[0][0], 32, xoff);
      const int r0 = j * kClusterTile;
      const int tiles = (p.Tk + kBlock - 1) / kBlock;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const GlobalRows<T> gb = rows_of<T>(half ? p.q : p.dout,
                                            half ? p.sq : p.sdo, p.Tq, tiles,
                                            p.H);
        const float4* c =
            reinterpret_cast<const float4*>(park + half * L::kX / 2) + xoff;
        for (int i = 0; i < chunks && rank + i * cs < p.nc; ++i)
          chunk_products<T, kQN, kDN>(
              acc_place(p.scratch, i, chunks, 2 * kDN) + half * kDN * kThreads,
              j == 0, c, gb, r0, (rank + i * cs) * kGroup, g, t);
      }
    }
  }
  // No block leaves while another may still read its exchange buffer.
  cluster_sync();

  // Each warp's K_c and V_c rows are its alone: stage dK and dV there.
  const TileOf end = unfold_again((p.Tk + kBlock - 1) / kBlock);
  const int eb = end.pair / p.H, eh = end.pair % p.H;
  const int ek = end.tile * kBlock + kw * 16;
  if constexpr (kMulti) {
    for (int i = 0; i < chunks && rank + i * cs < p.nc; ++i) {
      const int cc = (rank + i * cs) * kGroup;
      const float4* acc = acc_place(p.scratch, i, chunks, 2 * kDN);
      store_chunk<T, kDN>(acc + kDN * kThreads, head<T>(p.dk, p.sdk, eb, eh),
                          p.sdk[2], ek, p.Tk, cc, g, t);
      store_chunk<T, kDN>(acc, head<T>(p.dv, p.sdv, eb, eh), p.sdv[2], ek,
                          p.Tk, cc, g, t);
    }
  } else {
    store_rows<T, kDN, kS>(dk, sK + kw * 16 * kS,
                           head<T>(p.dk, p.sdk, eb, eh) + col0, p.sdk[2], ek,
                           p.Tk, lane);
    store_rows<T, kDN, kS>(dv, sV + kw * 16 * kS,
                           head<T>(p.dv, p.sdv, eb, eh) + col0, p.sdv[2], ek,
                           p.Tk, lane);
  }
}

// dQ: a cluster owns 64 query rows; Q_c and dO_c stay in shared memory,
// and 32-key tiles of K_c and V_c stream through the ring.
template <typename T>
struct ClusterDqLayout {
  static constexpr int kS = kGroup + 16 / sizeof(T);
  static constexpr int kQ = kBlock * kS;          // Q_c or dO_c
  static constexpr int kKV = kClusterTile * kS;   // K_c or V_c of a tile
  static constexpr int kStage = 2 * kKV;
  static constexpr int kKN = kClusterTile / 8;    // 8-key tiles
  static constexpr int kX = 2 * kWarps * kKN * 32 * 4;  // S, then dP
  static constexpr size_t kBytes =
      (2 * kQ + 2 * kStage) * sizeof(T) + 2 * kX * sizeof(float);
  static_assert(kBytes <= 232448, "shared memory");
};

template <typename T, bool kMulti>
__global__ void __launch_bounds__(32 * kWarps, 1)
flash_bwd_dq_kernel_cluster(const Params p) {
  using L = ClusterDqLayout<T>;
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int kS = L::kS;
  constexpr int kThreads = 32 * kWarps;
  constexpr int kDN = kGroup / 8;
  constexpr int kKN = L::kKN;
  extern __shared__ float4 smem4[];
  T* sQ = reinterpret_cast<T*>(smem4);
  T* sO = sQ + L::kQ;
  T* ring = sO + L::kQ;  // stage s: K_c at ring + s kStage, V_c after it
  float* sX = reinterpret_cast<float*>(ring + 2 * L::kStage);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int rw = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int cs = gridDim.z;  // blocks of the cluster
  const unsigned rank = cluster_rank();
  const int col0 = rank * kGroup;
  const TileOf at = unfold((p.Tq + kBlock - 1) / kBlock);
  const int bh = at.pair;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = at.tile * kBlock;
  const T* kb = head<T>(p.k, p.sk, b, h) + col0;
  const T* vb = head<T>(p.v, p.sv, b, h) + col0;
  const int n_tiles = (p.Tk + kClusterTile - 1) / kClusterTile;
  // The block's chunks after its first (kMulti): rank + i cs, i < chunks.
  const int chunks = chunks_per_block(p.nc);
  const GlobalRows<T> gk = {kb - col0, p.sk[2], p.Tk};
  const GlobalRows<T> gv = {vb - col0, p.sv[2], p.Tk};
  const GlobalRows<T> gq = {head<T>(p.q, p.sq, b, h), p.sq[2], p.Tq};
  const GlobalRows<T> gdo = {head<T>(p.dout, p.sdo, b, h), p.sdo[2], p.Tq};

  auto load_stage = [&](int j) {
    T* st = ring + (j & 1) * L::kStage;
    const int r0 = j * kClusterTile;
    load_tile<T, kGroup, kS, kClusterTile, kThreads>(st, kb, p.sk[2], r0,
                                                     p.Tk, tid);
    load_tile<T, kGroup, kS, kClusterTile, kThreads>(st + L::kKV, vb,
                                                     p.sv[2], r0, p.Tk, tid);
  };

  load_tile<T, kGroup, kS, kBlock, kThreads>(
      sQ, head<T>(p.q, p.sq, b, h) + col0, p.sq[2], q0, p.Tq, tid);
  load_tile<T, kGroup, kS, kBlock, kThreads>(
      sO, head<T>(p.dout, p.sdo, b, h) + col0, p.sdo[2], q0, p.Tq, tid);
  load_stage(0);
  cp_async_commit();

  const int row0 = q0 + rw * 16 + g;  // and row0 + 8
  const long long base = (long long)bh * p.Tq;
  const float lse0 = row0 < p.Tq ? p.lse[base + row0] : 0.f;
  const float lse1 = row0 + 8 < p.Tq ? p.lse[base + row0 + 8] : 0.f;
  const float dl0 = row0 < p.Tq ? p.delta[base + row0] : 0.f;
  const float dl1 = row0 + 8 < p.Tq ? p.delta[base + row0 + 8] : 0.f;
  HashRow hr0 = {0u, 0u}, hr1 = {0u, 0u};
  if (p.drop.on) {
    hr0 = hash_row(p.drop, bh, row0);
    hr1 = hash_row(p.drop, bh, row0 + 8);
  }
  float dq[kDN][4];
#pragma unroll
  for (int n = 0; n < kDN; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
  const T* qw = sQ + rw * 16 * kS;
  const T* ow = sO + rw * 16 * kS;
  const float inv_keep = 1.f / p.keep;
  const int xoff = rw * kKN * 32 + lane;

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<0>();
    __syncthreads();
    const T* sK = ring + (j & 1) * L::kStage;
    const T* sV = sK + L::kKV;
    float* xb = sX + (j & 1) * L::kX;

    // The partials S_c = Q_c K_c^T and dP_c = dO_c V_c^T of this warp's
    // 16 rows and the tile's 32 keys.
    float s[kKN][4], dp[kKN][4];
#pragma unroll
    for (int n = 0; n < kKN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    if constexpr (kF32) {
#pragma unroll 2
      for (int kk = 0; kk < kGroup / 8; ++kk) {
        unsigned qab[4], qas[4], oab[4], oas[4];
        load_a<kS>(qw, kk * 8, g, t, qab, qas);
        load_a<kS>(ow, kk * 8, g, t, oab, oas);
#pragma unroll
        for (int n = 0; n < kKN; ++n) {
          const float* kr = sK + (n * 8 + g) * kS + kk * 8 + t;
          const float* vr = sV + (n * 8 + g) * kS + kk * 8 + t;
          unsigned bb[2], bs[2];
          split(kr[0], bb[0], bs[0]);
          split(kr[4], bb[1], bs[1]);
          mma_3xtf32(s[n], qab, qas, bb, bs);
          split(vr[0], bb[0], bs[0]);
          split(vr[4], bb[1], bs[1]);
          mma_3xtf32(dp[n], oab, oas, bb, bs);
        }
      }
    } else {
#pragma unroll 2
      for (int kk = 0; kk < kGroup / 16; ++kk) {
        unsigned qa[4], oa[4];
        load_a_bf16<kS>(qw, kk * 16, g, t, qa);
        load_a_bf16<kS>(ow, kk * 16, g, t, oa);
#pragma unroll
        for (int n = 0; n < kKN; ++n) {
          unsigned bb[2];
          load_b_rows<kS>(sK, n * 8, kk * 16, g, t, bb);
          mma_bf16(s[n], qa, bb);
          load_b_rows<kS>(sV, n * 8, kk * 16, g, t, bb);
          mma_bf16(dp[n], oa, bb);
        }
      }
    }
    if constexpr (kMulti) {
      // The partials of the block's other chunks, added in chunk order.
      const int kt = j * kClusterTile, qr = q0 + rw * 16;
      for (int i = 1; i < chunks && rank + i * cs < p.nc; ++i) {
        const int cc = (rank + i * cs) * kGroup;
        if constexpr (kF32) {
#pragma unroll 1
          for (int kk = 0; kk < kGroup / 8; ++kk) {
            chunk_partial_f32<kKN>(s, gq, gk, qr, kt, cc + kk * 8, g, t);
            chunk_partial_f32<kKN>(dp, gdo, gv, qr, kt, cc + kk * 8, g, t);
          }
        } else {
#pragma unroll 1
          for (int kk = 0; kk < kGroup / 16; ++kk) {
            chunk_partial_bf16<kKN>(s, gq, gk, qr, kt, cc + kk * 16, g, t);
            chunk_partial_bf16<kKN>(dp, gdo, gv, qr, kt, cc + kk * 16, g, t);
          }
        }
      }
    }
    put_partials<kKN>(xb, &s[0][0], 32, xoff);
    put_partials<kKN>(xb + L::kX / 2, &dp[0][0], 32, xoff);
    cluster_sync();
    if (j + 1 < n_tiles) load_stage(j + 1);
    cp_async_commit();
    cluster_sum<kKN>(&s[0][0], xb, 32, xoff, cs, rank);
    cluster_sum<kKN>(&dp[0][0], xb + L::kX / 2, 32, xoff, cs, rank);

    // ds into s; keys past Tk weigh 0.
    const int kt0 = j * kClusterTile;
#pragma unroll
    for (int n = 0; n < kKN; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = kt0 + n * 8 + 2 * t + e;
        const bool valid = key < p.Tk;
        const float p0 = valid ? expf(s[n][e] * p.scale - lse0) : 0.f;
        const float p1 = valid ? expf(s[n][2 + e] * p.scale - lse1) : 0.f;
        float d0 = dp[n][e], d1 = dp[n][2 + e];
        if (p.drop.on) {
          const HashCol hc = hash_col(p.drop, key);
          d0 = hash_keep(p.drop, hr0, hc) ? d0 * inv_keep : 0.f;
          d1 = hash_keep(p.drop, hr1, hc) ? d1 * inv_keep : 0.f;
        }
        s[n][e] = p0 * (d0 - dl0) * p.scale;
        s[n][2 + e] = p1 * (d1 - dl1) * p.scale;
      }
    }

    // dQ_c += ds K_c: ds as the A operand, K_c rows as B.
    if constexpr (kF32) {
#pragma unroll
      for (int n = 0; n < kKN; ++n) {
        unsigned ab[4], as[4];
        c_as_a(s[n], ab, as);
        const float* kr = sK + (n * 8 + 2 * t) * kS + g;
#pragma unroll
        for (int dn = 0; dn < kDN; ++dn) {
          unsigned bb[2], bs[2];
          split(kr[dn * 8], bb[0], bs[0]);
          split(kr[kS + dn * 8], bb[1], bs[1]);
          mma_3xtf32(dq[dn], ab, as, bb, bs);
        }
      }
    } else {
#pragma unroll
      for (int kb2 = 0; kb2 < kKN / 2; ++kb2) {
        unsigned a[4];
        c_pair_as_a(s[2 * kb2], s[2 * kb2 + 1], a);
#pragma unroll
        for (int dn = 0; dn < kDN; ++dn) {
          unsigned bb[2];
          load_b_cols<kS>(sK, kb2 * 16, dn * 8, g, t, bb);
          mma_bf16(dq[dn], a, bb);
        }
      }
    }
    if constexpr (kMulti) {
      // dQ_c' += ds K_c' for the block's other chunks c', their
      // accumulators through the scratch buffer (zero before the first
      // tile); ds waits in the other exchange buffer, as in dK/dV.
      float* park = sX + ((j + 1) & 1) * L::kX;
      put_partials<kKN>(park, &s[0][0], 32, xoff);
      for (int i = 1; i < chunks && rank + i * cs < p.nc; ++i)
        chunk_products<T, kKN, kDN>(extra_acc(p.scratch, i, chunks, kDN),
                                    j == 0,
                                    reinterpret_cast<const float4*>(park) +
                                        xoff,
                                    gk, kt0, (rank + i * cs) * kGroup, g, t);
    }
  }
  cluster_sync();

  // This warp's Q_c rows are its alone now: stage dQ there.
  store_rows<T, kDN, kS>(dq, sQ + rw * 16 * kS,
                         head<T>(p.dq, p.sdq, b, h) + col0, p.sdq[2],
                         q0 + rw * 16, p.Tq, lane);
  if constexpr (kMulti) {
    for (int i = 1; i < chunks && rank + i * cs < p.nc; ++i)
      store_chunk<T, kDN>(extra_acc(p.scratch, i, chunks, kDN),
                          head<T>(p.dq, p.sdq, b, h), p.sdq[2], q0 + rw * 16,
                          p.Tq, (rank + i * cs) * kGroup, g, t);
  }
}

// Sets the kernel's shared-memory attribute the first time it launches on
// a device (`done`: one per kernel instance), then launches it.
template <typename Kernel, typename... Args>
cudaError_t launch_one(Kernel kernel, dim3 grid, int threads, size_t smem,
                       cudaStream_t stream, unsigned* done, Args... args) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (smem > 48 * 1024 && !(*done & (1u << (device & 31)))) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    *done |= 1u << (device & 31);
  }
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <int D, int SPLIT>
cudaError_t launch_dkv(const Params& p, long long bh, cudaStream_t stream) {
  using L = DkvLayout<D, SPLIT>;
  static unsigned done = 0;
  return launch_one(flash_bwd_dkv_kernel<D, SPLIT>,
                    folded_grid((p.Tk + kBlock - 1) / kBlock, bh),
                    L::kThreads, L::kBytes, stream, &done, p);
}

template <int D, int SPLIT>
cudaError_t launch_dq(const Params& p, long long bh, cudaStream_t stream) {
  using L = DqLayout<D, SPLIT>;
  static unsigned done = 0;
  return launch_one(flash_bwd_dq_kernel<D, SPLIT>,
                    folded_grid((p.Tq + kBlock - 1) / kBlock, bh),
                    L::kThreads, L::kBytes, stream, &done, p);
}

template <typename T>
cudaError_t launch_delta(const Params& p, long long bh, int dh,
                         cudaStream_t stream) {
  static unsigned done = 0;
  const dim3 grid = folded_grid(
      (p.Tq + kDeltaThreads / 32 - 1) / (kDeltaThreads / 32), bh);
  switch (dh) {
    case 32:
      return launch_one(flash_bwd_delta_kernel<T, 32>, grid, kDeltaThreads,
                        0, stream, &done, p);
    case 64:
      return launch_one(flash_bwd_delta_kernel<T, 64>, grid, kDeltaThreads,
                        0, stream, &done, p);
    case 128:
      return launch_one(flash_bwd_delta_kernel<T, 128>, grid, kDeltaThreads,
                        0, stream, &done, p);
    case 256:
      return launch_one(flash_bwd_delta_kernel<T, 256>, grid, kDeltaThreads,
                        0, stream, &done, p);
    default:  // above 256: a multiple of 128
      return dh % kGroup
                 ? cudaErrorInvalidValue
                 : launch_one(flash_bwd_delta_kernel_wide<T>, grid,
                              kDeltaThreads, 0, stream, &done, p, dh);
  }
}

// Head dims above 256: the delta kernel at a run-time width, then the
// cluster dK/dV and dQ kernels, a cluster of dh / 128 blocks each.
template <typename T, bool kMulti>
cudaError_t launch_cluster_bwd(const Params& p, int B, int dh,
                               cudaStream_t stream) {
  const long long bh = (long long)B * p.H;
  const int cs = cluster_blocks(p.nc);
  static unsigned done_dkv = 0, done_dq = 0;
  cudaError_t err = launch_delta<T>(p, bh, dh, stream);
  if (err != cudaSuccess) return err;
  err = launch_cluster(flash_bwd_dkv_kernel_cluster<T, kMulti>,
                       folded_grid((p.Tk + kBlock - 1) / kBlock, bh, 1, cs),
                       32 * kWarps, ClusterDkvLayout<T>::kBytes, stream,
                       &done_dkv, p);
  if (err != cudaSuccess) return err;
  return launch_cluster(flash_bwd_dq_kernel_cluster<T, kMulti>,
                        folded_grid((p.Tq + kBlock - 1) / kBlock, bh, 1, cs),
                        32 * kWarps, ClusterDqLayout<T>::kBytes, stream,
                        &done_dq, p);
}

template <typename T>
cudaError_t launch_cluster_bwd(const Params& p, int B, int dh,
                               cudaStream_t stream) {
  if (dh <= 256 || dh % kGroup) return cudaErrorInvalidValue;
  return p.nc > kClusterMax ? launch_cluster_bwd<T, true>(p, B, dh, stream)
                            : launch_cluster_bwd<T, false>(p, B, dh, stream);
}

// The scratch buffer of the cluster kernels' chunks (cluster.cuh), shared
// by the dK/dV launch (every chunk a block owns, dK and dV: 2 * 16 float4
// a thread) and the dQ launch after it (the chunks after the first, 16).
long long bwd_scratch_bytes(int B, int H, int Tq, int Tk, int dh) {
  if (dh <= 256 || dh % kGroup) return 0;
  const long long bh = (long long)B * H;
  const int nc = dh / kGroup;
  const long long dkv = acc_places_bytes((Tk + kBlock - 1) / kBlock * bh,
                                         nc, chunks_per_block(nc),
                                         32 * kWarps, 2 * kGroup / 8);
  const long long dq = extra_acc_bytes((Tq + kBlock - 1) / kBlock * bh,
                                       dh / kGroup, 32 * kWarps, kGroup / 8);
  return dkv > dq ? dkv : dq;
}

// Head dims 32, 64 and 128: a grid of at most one 4-warp block an SM
// leaves half the warps the SMs could hold idle: split each block's walk
// over two warp groups instead.
template <int D>
cudaError_t launch(const Params& p, int B, int sms, cudaStream_t stream) {
  const long long bh = (long long)B * p.H;
  cudaError_t err = launch_delta<float>(p, bh, D, stream);
  if (err != cudaSuccess) return err;
  const long long dkv_blocks = (long long)((p.Tk + kBlock - 1) / kBlock) * bh;
  err = dkv_blocks <= sms ? launch_dkv<D, 2>(p, bh, stream)
                          : launch_dkv<D, 1>(p, bh, stream);
  if (err != cudaSuccess) return err;
  const long long dq_blocks = (long long)((p.Tq + kBlock - 1) / kBlock) * bh;
  return dq_blocks <= sms ? launch_dq<D, 2>(p, bh, stream)
                          : launch_dq<D, 1>(p, bh, stream);
}

// Head dim 256: the delta kernel, then the 8-warp pair kernels.
cudaError_t launch_pair(const Params& p, int B, cudaStream_t stream) {
  const long long bh = (long long)B * p.H;
  static unsigned done_dkv = 0, done_dq = 0;
  cudaError_t err = launch_delta<float>(p, bh, 256, stream);
  if (err != cudaSuccess) return err;
  err = launch_one(flash_bwd_dkv_kernel_pair,
                   folded_grid((p.Tk + kBlock - 1) / kBlock, bh),
                   kPairThreads, PairDkvLayout::kBytes, stream, &done_dkv, p);
  if (err != cudaSuccess) return err;
  return launch_one(flash_bwd_dq_kernel_pair,
                    folded_grid((p.Tq + kBlock - 1) / kBlock, bh),
                    kPairThreads, PairDqLayout::kBytes, stream, &done_dq, p);
}

// Float32 at the head dims the wrapper pads to: 32 (demo), 64 (the
// reference's default model), 128 (the rest), 256 (any dh in (128, 256],
// on the pair kernels), and above 256 any multiple of 128.  (bfloat16 up
// to dh 256 runs on csrc/flash_bwd_wgmma.cu; here only above.)
cudaError_t dispatch(const Params& p, int B, int dh, int sms,
                     cudaStream_t s) {
  if (dh > 256) return launch_cluster_bwd<float>(p, B, dh, s);
  switch (dh) {
    case 32: return launch<32>(p, B, sms, s);
    case 64: return launch<64>(p, B, sms, s);
    case 128: return launch<128>(p, B, sms, s);
    case 256: return launch_pair(p, B, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (q, k, v, o, dO and dQ, dK, dV; lse and
// delta are float32 at both).
extern "C" int avsep_flash_attn_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int H, int Tq, int Tk, int dh,
    const long long* strides,  // 3 each for q, k, v, o, dO, dQ, dK, dV
    float scale, float keep, unsigned threshold, unsigned seed, int hq,
    int hk, int dropout, int dtype, int device, void* stream,
    void* scratch) {
  const DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bwd_scratch_bytes(B, H, Tq, Tk, dh) > 0 && scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.nc = dh / kGroup;
  p.scratch = static_cast<float*>(scratch);
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
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
  static int sm_counts[32] = {0};  // read once per device
  int& sms = sm_counts[device & 31];
  if (sms == 0) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (dtype == 0)
    err = dispatch(p, B, dh, sms, s);
  else if (dtype == 1)
    err = launch_cluster_bwd<bf16>(p, B, dh, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// Bytes of the scratch buffer a call at these sizes takes (`scratch`, float
// aligned); 0 up to dh 128 kClusterMax.
extern "C" long long avsep_flash_attn_bwd_scratch(int B, int H, int Tq,
                                                  int Tk, int dh) {
  return bwd_scratch_bytes(B, H, Tq, Tk, dh);
}

// Shared memory of a block of the cluster kernels (bytes): kernel 0 dK/dV,
// 1 dQ; dtype 0 float32, 1 bfloat16.
extern "C" int avsep_flash_attn_bwd_cluster_smem(int kernel, int dtype) {
  const size_t bytes[2][2] = {
      {ClusterDkvLayout<float>::kBytes, ClusterDkvLayout<bf16>::kBytes},
      {ClusterDqLayout<float>::kBytes, ClusterDqLayout<bf16>::kBytes}};
  return kernel >= 0 && kernel < 2 && dtype >= 0 && dtype < 2
             ? static_cast<int>(bytes[kernel][dtype])
             : -1;
}

// Shared memory of a block of the pair kernels at dh 256 (bytes): kernel 0
// dK/dV, 1 dQ.
extern "C" int avsep_flash_attn_bwd_pair_smem(int kernel) {
  return kernel == 0   ? static_cast<int>(PairDkvLayout::kBytes)
         : kernel == 1 ? static_cast<int>(PairDqLayout::kBytes)
                       : -1;
}

extern "C" const char* avsep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
