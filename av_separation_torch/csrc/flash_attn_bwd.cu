// Flash attention backward, float32 on the tensor cores in 3xTF32 and
// bfloat16 above head dim 256 in bf16 products, for Hopper (sm_90a).
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
// - Head dims above 128 (a column split, as the forward): dh is padded to
//   256 and each dK/dV (dQ) block owns one group of 128 output columns
//   (blockIdx.z).  It recomputes S and dP over all 256 columns (K, V, Q
//   and dO staged at full width) and accumulates only its own columns, so
//   a warp holds the accumulators of dh 128.  200 KB of shared memory at
//   float32: one 4-warp block an SM.
// - Head dims above 256 (any multiple of 128, `flash_bwd_*_kernel_wide`):
//   the same column split, but S^T and dP^T (S and dP) are summed over
//   128-column chunks that stream through the ring with the tile's rows;
//   a last step stages the rows' own columns (Q and dO for dK/dV, K for
//   dQ).  K and V (Q and dO) are re-read from L2 for every tile.
// - Rows past T are zero-filled by the copies; a query past Tq gets lse
//   +inf in the dK/dV kernel (p = 0), a key past Tk gets p = 0 in the dQ
//   kernel, and neither is stored.
// - Bank conflicts.  Operand rows are dh+4 floats apart: the A loads and
//   the B loads of rows n*8 + g hit bank 4g + t, the B loads of rows 2t,
//   2t + 1 bank 8t + g (+4): 32 distinct banks per load.
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

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
constexpr int kGroup = 128;             // output columns a block above 128

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
// dK, dV: a block owns kBlock keys (and DV output columns) and walks the
// query tiles.
// ---------------------------------------------------------------------------
template <typename T, int DQK, int DV, int SPLIT>
struct DkvLayout {
  static constexpr int kThreads = 32 * kWarps * SPLIT;
  static constexpr int kS = DQK + 16 / sizeof(T);  // operand row stride
  static constexpr int kRows = kTile * SPLIT;  // query rows a stage
  static constexpr int kKV = kBlock * kS;    // one of K, V (elements)
  // A stage (elements of T): Q rows, dO rows, then lse, delta and the
  // hash's row part (tile and row terms) of each row (4-byte words).
  static constexpr int kOperands = 2 * kRows * kS;  // elements of T
  static constexpr int kStage = kOperands + 4 * kRows * (4 / sizeof(T));
  static constexpr size_t kBytes = (2 * kKV + 2 * kStage) * sizeof(T);
  // The split block hands dK, then dV (4 * 32 * DV / 8 floats a warp
  // each) over through the idle ring: bf16's ring holds one at a time.
  static_assert(SPLIT == 1 || 2 * kStage * sizeof(T) >=
                kWarps * 32 * 4 * (DV / 8) * sizeof(float),
                "hand-over does not fit the ring");
};

template <typename T, int DQK, int DV, int SPLIT>
__global__ void __launch_bounds__(DkvLayout<T, DQK, DV, SPLIT>::kThreads,
                                  DQK > DV ? 1 : 3 - SPLIT)
flash_bwd_dkv_kernel(const Params p) {
  using L = DkvLayout<T, DQK, DV, SPLIT>;
  constexpr int kS = L::kS;
  constexpr int kRows = L::kRows;
  constexpr int kThreads = L::kThreads;
  constexpr int kDN = DV / 8;      // 8-wide column tiles of dK, dV
  constexpr int kQN = kTile / 8;   // 8-query tiles of S^T
  extern __shared__ float4 smem4[];
  T* sK = reinterpret_cast<T*>(smem4);
  T* sV = sK + L::kKV;
  T* sRing = sV + L::kKV;

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
  // This block's columns of dK, dV (a constant 0 up to dh 128).
  const int col0 = DQK > DV ? blockIdx.z * DV : 0;

  const T* qb = head<T>(p.q, p.sq, b, h);
  const T* ob = head<T>(p.dout, p.sdo, b, h);
  const float* lse = p.lse + (long long)bh * p.Tq;
  const float* delta = p.delta + (long long)bh * p.Tq;
  const int n_stages = (p.Tq + kRows - 1) / kRows;

  auto load_stage = [&](int j) {
    T* st = sRing + (j & 1) * L::kStage;
    const int r0 = j * kRows;
    load_tile<T, DQK, kS, kRows, kThreads>(st, qb, p.sq[2], r0, p.Tq, tid);
    load_tile<T, DQK, kS, kRows, kThreads>(st + kRows * kS, ob, p.sdo[2], r0,
                                           p.Tq, tid);
    if (tid < kRows) {
      float* sl =
          reinterpret_cast<float*>(st + L::kOperands);
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

  load_tile<T, DQK, kS, kBlock, kThreads>(sK, head<T>(p.k, p.sk, b, h),
                                          p.sk[2], k0, p.Tk, tid);
  load_tile<T, DQK, kS, kBlock, kThreads>(sV, head<T>(p.v, p.sv, b, h),
                                          p.sv[2], k0, p.Tk, tid);
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

  for (int j = 0; j < n_stages; ++j) {
    if (j + 1 < n_stages) {
      load_stage(j + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* st = sRing + (j & 1) * L::kStage;
    const int c0 = part * kTile;  // this group's rows of the stage

    if (j * kRows + c0 < p.Tq) {
      const T* sQ = st + c0 * kS;
      const T* sO = st + (kRows + c0) * kS;
      const float* sl = reinterpret_cast<const float*>(
                            st + L::kOperands) + c0;
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
      for (int kk = 0; kk < DQK / 8; ++kk) {
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
        const float* orow = sO + (n * 8 + 2 * t) * kS + col0 + g;
#pragma unroll
        for (int dn = 0; dn < kDN; ++dn) {
          unsigned bb[2], bs[2];
          split(orow[dn * 8], bb[0], bs[0]);
          split(orow[kS + dn * 8], bb[1], bs[1]);
          mma_3xtf32(dv[dn], ab, as, bb, bs);
        }
        c_as_a(dp[n], ab, as);
        const float* qr = sQ + (n * 8 + 2 * t) * kS + col0 + g;
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
    float* x = reinterpret_cast<float*>(sRing) + kw * 32 * 4 * kDN;
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
  store_rows<T, kDN, kS>(dk, sK + kw * 16 * kS,
                         head<T>(p.dk, p.sdk, eb, eh) + col0, p.sdk[2], ek,
                         p.Tk, lane);
  store_rows<T, kDN, kS>(dv, sV + kw * 16 * kS,
                         head<T>(p.dv, p.sdv, eb, eh) + col0, p.sdv[2], ek,
                         p.Tk, lane);
}

// ---------------------------------------------------------------------------
// dQ: a block owns kBlock query rows (and DV output columns) and walks the
// key tiles.
// ---------------------------------------------------------------------------
template <typename T, int DQK, int DV, int SPLIT>
struct DqLayout {
  static constexpr int kThreads = 32 * kWarps * SPLIT;
  static constexpr int kS = DQK + 16 / sizeof(T);  // operand row stride
  static constexpr int kKeys = kTile * SPLIT;  // keys a stage
  static constexpr int kQ = kBlock * kS;      // one of Q, dO
  static constexpr int kKV = kKeys * kS;      // one of K, V of a stage
  static constexpr size_t kBytes = (2 * kQ + 4 * kKV) * sizeof(T);
  static_assert(SPLIT == 1 || 4 * kKV * sizeof(T) >=
                kWarps * 32 * 4 * (DV / 8) * sizeof(float),
                "hand-over does not fit the ring");
};

template <typename T, int DQK, int DV, int SPLIT>
__global__ void __launch_bounds__(DqLayout<T, DQK, DV, SPLIT>::kThreads,
                                  DQK > DV ? 1 : 3 - SPLIT)
flash_bwd_dq_kernel(const Params p) {
  using L = DqLayout<T, DQK, DV, SPLIT>;
  constexpr int kS = L::kS;
  constexpr int kThreads = L::kThreads;
  constexpr int kDN = DV / 8;      // 8-wide column tiles of dQ
  constexpr int kKN = kTile / 8;   // 8-key tiles of S
  extern __shared__ float4 smem4[];
  T* sQ = reinterpret_cast<T*>(smem4);
  T* sO = sQ + L::kQ;   // dO rows
  T* sKV = sO + L::kQ;  // stage s: K at sKV + 2 s kKV, V after it

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
  // This block's columns of dQ (a constant 0 up to dh 128).
  const int col0 = DQK > DV ? blockIdx.z * DV : 0;

  const T* kb = head<T>(p.k, p.sk, b, h);
  const T* vb = head<T>(p.v, p.sv, b, h);
  const int n_stages = (p.Tk + L::kKeys - 1) / L::kKeys;

  load_tile<T, DQK, kS, kBlock, kThreads>(sQ, head<T>(p.q, p.sq, b, h),
                                          p.sq[2], q0, p.Tq, tid);
  load_tile<T, DQK, kS, kBlock, kThreads>(sO, head<T>(p.dout, p.sdo, b, h),
                                          p.sdo[2], q0, p.Tq, tid);
  load_tile<T, DQK, kS, L::kKeys, kThreads>(sKV, kb, p.sk[2], 0, p.Tk, tid);
  load_tile<T, DQK, kS, L::kKeys, kThreads>(sKV + L::kKV, vb, p.sv[2], 0,
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
  const T* qw = sQ + rw * 16 * kS;
  const T* ow = sO + rw * 16 * kS;
  const float inv_keep = 1.f / p.keep;

  for (int j = 0; j < n_stages; ++j) {
    if (j + 1 < n_stages) {
      T* next = sKV + ((j + 1) & 1) * 2 * L::kKV;
      const int r0 = (j + 1) * L::kKeys;
      load_tile<T, DQK, kS, L::kKeys, kThreads>(next, kb, p.sk[2], r0, p.Tk,
                                                tid);
      load_tile<T, DQK, kS, L::kKeys, kThreads>(next + L::kKV, vb, p.sv[2],
                                                r0, p.Tk, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int kt0 = j * L::kKeys + part * kTile;
    const T* sK = sKV + (j & 1) * 2 * L::kKV + part * kTile * kS;
    const T* sV = sK + L::kKV;

    if (kt0 < p.Tk) {
      // S = Q K^T and dP = dO V^T for this warp's 16 rows and the tile.
      float s[kKN][4], dp[kKN][4];
#pragma unroll
      for (int n = 0; n < kKN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll 2
      for (int kk = 0; kk < DQK / 8; ++kk) {
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
        const float* kr = sK + (n * 8 + 2 * t) * kS + col0 + g;
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
    float* x = reinterpret_cast<float*>(sKV) + rw * (32 * 4 * kDN);
    if (part == 1) hand_over(dq, x, lane);
    __syncthreads();
    if (part == 1) return;
    take_over(dq, x, lane);
  }
  // This warp's Q rows are its alone now: stage dQ there.
  store_rows<T, kDN, kS>(dq, sQ + rw * 16 * kS,
                         head<T>(p.dq, p.sdq, b, h) + col0, p.sdq[2],
                         q0 + rw * 16, p.Tq, lane);
}

// ---------------------------------------------------------------------------
// Head dims above 256 (any multiple of 128): the column split of dh 256,
// with S^T (S) and dP^T (dP) summed over 128-column chunks that stream
// through the ring instead of being staged at full width.
// ---------------------------------------------------------------------------
// dK/dV: a block owns 64 keys and one group of 128 output columns.  For
// each 16-row query tile, steps c < nc stage chunk c of K, V, Q and dO;
// step nc stages the block's columns of Q and dO with the rows' lse, delta
// and hash words.  K and V are re-read from L2 for every query tile.
template <typename T>
struct WideDkvLayout {
  static constexpr int kS = kGroup + 16 / sizeof(T);
  static constexpr int kKV = kBlock * kS;   // a chunk of K or V
  static constexpr int kRows = kTile * kS;  // a chunk of Q or dO
  static constexpr int kOperands = 2 * kKV + 2 * kRows;
  static constexpr int kStage = kOperands + 4 * kTile * (4 / sizeof(T));
  static constexpr size_t kBytes = 2 * kStage * sizeof(T);
};

template <typename T>
__global__ void __launch_bounds__(32 * kWarps, 1)
flash_bwd_dkv_kernel_wide(const Params p, int nc) {
  using L = WideDkvLayout<T>;
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int kS = L::kS;
  constexpr int kThreads = 32 * kWarps;
  constexpr int kDN = kGroup / 8;
  constexpr int kQN = kTile / 8;
  extern __shared__ float4 smem4[];
  T* ring = reinterpret_cast<T*>(smem4);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int kw = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const TileOf at = unfold((p.Tk + kBlock - 1) / kBlock);
  const int bh = at.pair;
  const int b = bh / p.H, h = bh % p.H;
  const int k0 = at.tile * kBlock;
  const int col0 = blockIdx.z * kGroup;
  const T* qb = head<T>(p.q, p.sq, b, h);
  const T* ob = head<T>(p.dout, p.sdo, b, h);
  const T* kb = head<T>(p.k, p.sk, b, h);
  const T* vb = head<T>(p.v, p.sv, b, h);
  const float* lse = p.lse + (long long)bh * p.Tq;
  const float* delta = p.delta + (long long)bh * p.Tq;
  const int n_tiles = (p.Tq + kTile - 1) / kTile;
  const int n_steps = n_tiles * (nc + 1);

  auto load_step = [&](int i) {
    T* st = ring + (i & 1) * L::kStage;
    const int j = i / (nc + 1), c = i % (nc + 1);
    const int r0 = j * kTile;
    const int cc = c < nc ? c * kGroup : col0;
    if (c < nc) {
      // The block's keys, decoded afresh (the kernel is at its register
      // cap; k0 held across the loop spilled).
      const int kt = unfold_again((p.Tk + kBlock - 1) / kBlock).tile * kBlock;
      load_tile<T, kGroup, kS, kBlock, kThreads>(st, kb + cc, p.sk[2], kt,
                                                 p.Tk, tid);
      load_tile<T, kGroup, kS, kBlock, kThreads>(st + L::kKV, vb + cc,
                                                 p.sv[2], kt, p.Tk, tid);
    }
    T* rows = st + 2 * L::kKV;
    load_tile<T, kGroup, kS, kTile, kThreads>(rows, qb + cc, p.sq[2], r0,
                                              p.Tq, tid);
    load_tile<T, kGroup, kS, kTile, kThreads>(rows + L::kRows, ob + cc,
                                              p.sdo[2], r0, p.Tq, tid);
    if (c == nc && tid < kTile) {
      float* sl = reinterpret_cast<float*>(st + L::kOperands);
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
    cp_async_commit();
  };

  float dk[kDN][4], dv[kDN][4], s[kQN][4], dp[kQN][4];
#pragma unroll
  for (int n = 0; n < kDN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  HashCol hc0 = {0u, 0u}, hc1 = {0u, 0u};
  if (p.drop.on) {
    hc0 = hash_col(p.drop, k0 + kw * 16 + g);
    hc1 = hash_col(p.drop, k0 + kw * 16 + g + 8);
  }
  const float inv_keep = 1.f / p.keep;

  load_step(0);
  for (int i = 0; i < n_steps; ++i) {
    if (i + 1 < n_steps) {
      load_step(i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* st = ring + (i & 1) * L::kStage;
    const int c = i % (nc + 1);
    const T* sQ = st + 2 * L::kKV;
    const T* sO = sQ + L::kRows;
    if (c == 0) {
#pragma unroll
      for (int n = 0; n < kQN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    }
    if (c < nc) {
      const T* kt = st + kw * 16 * kS;
      const T* vt = st + L::kKV + kw * 16 * kS;
      if constexpr (kF32) {
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
    } else {
      // S^T and dP^T are whole: P^T, Pd^T, dS^T, then dV and dK from the
      // block's own columns of dO and Q.
      const float* sl = reinterpret_cast<const float*>(st + L::kOperands);
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
      if constexpr (kF32) {
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
      } else {
        unsigned a[4];
        c_pair_as_a(s[0], s[1], a);
#pragma unroll
        for (int dn = 0; dn < kDN; ++dn) {
          unsigned bb[2];
          load_b_cols<kS>(sO, 0, dn * 8, g, t, bb);
          mma_bf16(dv[dn], a, bb);
        }
        c_pair_as_a(dp[0], dp[1], a);
#pragma unroll
        for (int dn = 0; dn < kDN; ++dn) {
          unsigned bb[2];
          load_b_cols<kS>(sQ, 0, dn * 8, g, t, bb);
          mma_bf16(dk[dn], a, bb);
        }
      }
    }
    __syncthreads();  // the stage just read is the next copy's target
  }

  // The ring is idle: each warp stages dK and dV in 16 rows of its own.
  const TileOf end = unfold_again((p.Tk + kBlock - 1) / kBlock);
  const int eb = end.pair / p.H, eh = end.pair % p.H;
  const int ek = end.tile * kBlock + kw * 16;
  store_rows<T, kDN, kS>(dk, ring + kw * 16 * kS,
                         head<T>(p.dk, p.sdk, eb, eh) + col0, p.sdk[2], ek,
                         p.Tk, lane);
  store_rows<T, kDN, kS>(dv, ring + (kWarps + kw) * 16 * kS,
                         head<T>(p.dv, p.sdv, eb, eh) + col0, p.sdv[2], ek,
                         p.Tk, lane);
}

// dQ: a block owns 64 query rows and one group of 128 output columns.  For
// each 16-key tile, steps c < nc stage chunk c of Q, dO, K and V; step nc
// stages the tile's K rows of the block's columns.  Q and dO are re-read
// from L2 for every key tile.
template <typename T>
struct WideDqLayout {
  static constexpr int kS = kGroup + 16 / sizeof(T);
  static constexpr int kQ = kBlock * kS;   // a chunk of Q or dO
  static constexpr int kKV = kTile * kS;   // a chunk of K or V
  static constexpr int kStage = 2 * kQ + 2 * kKV;
  static constexpr size_t kBytes = 2 * kStage * sizeof(T);
};

template <typename T>
__global__ void __launch_bounds__(32 * kWarps, 1)
flash_bwd_dq_kernel_wide(const Params p, int nc) {
  using L = WideDqLayout<T>;
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int kS = L::kS;
  constexpr int kThreads = 32 * kWarps;
  constexpr int kDN = kGroup / 8;
  constexpr int kKN = kTile / 8;
  extern __shared__ float4 smem4[];
  T* ring = reinterpret_cast<T*>(smem4);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int rw = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const TileOf at = unfold((p.Tq + kBlock - 1) / kBlock);
  const int bh = at.pair;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = at.tile * kBlock;
  const int col0 = blockIdx.z * kGroup;
  const T* qb = head<T>(p.q, p.sq, b, h);
  const T* ob = head<T>(p.dout, p.sdo, b, h);
  const T* kb = head<T>(p.k, p.sk, b, h);
  const T* vb = head<T>(p.v, p.sv, b, h);
  const int n_tiles = (p.Tk + kTile - 1) / kTile;
  const int n_steps = n_tiles * (nc + 1);

  auto load_step = [&](int i) {
    T* st = ring + (i & 1) * L::kStage;
    const int j = i / (nc + 1), c = i % (nc + 1);
    const int r0 = j * kTile;
    if (c < nc) {
      // The block's rows, decoded afresh (as the dK/dV kernel's keys).
      const int qt = unfold_again((p.Tq + kBlock - 1) / kBlock).tile * kBlock;
      load_tile<T, kGroup, kS, kBlock, kThreads>(st, qb + c * kGroup,
                                                 p.sq[2], qt, p.Tq, tid);
      load_tile<T, kGroup, kS, kBlock, kThreads>(st + L::kQ, ob + c * kGroup,
                                                 p.sdo[2], qt, p.Tq, tid);
      load_tile<T, kGroup, kS, kTile, kThreads>(st + 2 * L::kQ,
                                                kb + c * kGroup, p.sk[2], r0,
                                                p.Tk, tid);
      load_tile<T, kGroup, kS, kTile, kThreads>(
          st + 2 * L::kQ + L::kKV, vb + c * kGroup, p.sv[2], r0, p.Tk, tid);
    } else {
      load_tile<T, kGroup, kS, kTile, kThreads>(st + 2 * L::kQ, kb + col0,
                                                p.sk[2], r0, p.Tk, tid);
    }
    cp_async_commit();
  };

  const int row0 = q0 + rw * 16 + g;
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
  float dq[kDN][4], s[kKN][4], dp[kKN][4];
#pragma unroll
  for (int n = 0; n < kDN; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
  const float inv_keep = 1.f / p.keep;

  load_step(0);
  for (int i = 0; i < n_steps; ++i) {
    if (i + 1 < n_steps) {
      load_step(i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* st = ring + (i & 1) * L::kStage;
    const int j = i / (nc + 1), c = i % (nc + 1);
    const T* sK = st + 2 * L::kQ;
    if (c == 0) {
#pragma unroll
      for (int n = 0; n < kKN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    }
    if (c < nc) {
      const T* qw = st + rw * 16 * kS;
      const T* ow = st + L::kQ + rw * 16 * kS;
      const T* sV = sK + L::kKV;
      if constexpr (kF32) {
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
    } else {
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
        unsigned a[4];
        c_pair_as_a(s[0], s[1], a);
#pragma unroll
        for (int dn = 0; dn < kDN; ++dn) {
          unsigned bb[2];
          load_b_cols<kS>(sK, 0, dn * 8, g, t, bb);
          mma_bf16(dq[dn], a, bb);
        }
      }
    }
    __syncthreads();  // the stage just read is the next copy's target
  }

  store_rows<T, kDN, kS>(dq, ring + rw * 16 * kS,
                         head<T>(p.dq, p.sdq, b, h) + col0, p.sdq[2],
                         q0 + rw * 16, p.Tq, lane);
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

template <typename T, int DQK, int DV, int SPLIT>
cudaError_t launch_dkv(const Params& p, long long bh, cudaStream_t stream) {
  using L = DkvLayout<T, DQK, DV, SPLIT>;
  static unsigned done = 0;
  return launch_one(flash_bwd_dkv_kernel<T, DQK, DV, SPLIT>,
                    folded_grid((p.Tk + kBlock - 1) / kBlock, bh, 1,
                                DQK / DV),
                    L::kThreads, L::kBytes, stream, &done, p);
}

template <typename T, int DQK, int DV, int SPLIT>
cudaError_t launch_dq(const Params& p, long long bh, cudaStream_t stream) {
  using L = DqLayout<T, DQK, DV, SPLIT>;
  static unsigned done = 0;
  return launch_one(flash_bwd_dq_kernel<T, DQK, DV, SPLIT>,
                    folded_grid((p.Tq + kBlock - 1) / kBlock, bh, 1,
                                DQK / DV),
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
// chunked dK/dV and dQ kernels, one block per 128 output columns.
template <typename T>
cudaError_t launch_wide(const Params& p, int B, int dh, cudaStream_t stream) {
  const long long bh = (long long)B * p.H;
  const int nc = dh / kGroup;
  static unsigned done_dkv = 0, done_dq = 0;
  cudaError_t err = launch_delta<T>(p, bh, dh, stream);
  if (err != cudaSuccess) return err;
  err = launch_one(flash_bwd_dkv_kernel_wide<T>,
                   folded_grid((p.Tk + kBlock - 1) / kBlock, bh, 1, nc),
                   32 * kWarps,
                   WideDkvLayout<T>::kBytes, stream, &done_dkv, p, nc);
  if (err != cudaSuccess) return err;
  return launch_one(flash_bwd_dq_kernel_wide<T>,
                    folded_grid((p.Tq + kBlock - 1) / kBlock, bh, 1, nc),
                    32 * kWarps,
                    WideDqLayout<T>::kBytes, stream, &done_dq, p, nc);
}

// A grid of at most one 4-warp block an SM leaves half the warps the SMs
// could hold idle: split each block's walk over two warp groups instead
// (not above 128, whose block holds an SM's shared memory).
template <typename T, int DQK, int DV>
cudaError_t launch(const Params& p, int B, int sms, cudaStream_t stream) {
  const long long bh = (long long)B * p.H;
  cudaError_t err = launch_delta<T>(p, bh, DQK, stream);
  if (err != cudaSuccess) return err;
  if constexpr (DQK > DV) {
    err = launch_dkv<T, DQK, DV, 1>(p, bh, stream);
    if (err != cudaSuccess) return err;
    return launch_dq<T, DQK, DV, 1>(p, bh, stream);
  } else {
    const long long dkv_blocks =
        (long long)((p.Tk + kBlock - 1) / kBlock) * bh;
    err = dkv_blocks <= sms ? launch_dkv<T, DQK, DV, 2>(p, bh, stream)
                            : launch_dkv<T, DQK, DV, 1>(p, bh, stream);
    if (err != cudaSuccess) return err;
    const long long dq_blocks =
        (long long)((p.Tq + kBlock - 1) / kBlock) * bh;
    return dq_blocks <= sms ? launch_dq<T, DQK, DV, 2>(p, bh, stream)
                            : launch_dq<T, DQK, DV, 1>(p, bh, stream);
  }
}

// The head dims the wrapper pads to: 32 (demo), 64 (the reference's
// default model), 128 (the rest), 256 (any dh in (128, 256], as two column
// groups).
template <typename T>
cudaError_t dispatch(const Params& p, int B, int dh, int sms,
                     cudaStream_t s) {
  if (dh > 256) return launch_wide<T>(p, B, dh, s);
  switch (dh) {
    case 32: return launch<T, 32, 32>(p, B, sms, s);
    case 64: return launch<T, 64, 64>(p, B, sms, s);
    case 128: return launch<T, 128, 128>(p, B, sms, s);
    case 256: return launch<T, 256, kGroup>(p, B, sms, s);
    default: return cudaErrorInvalidValue;
  }
}

// bfloat16 up to dh 256 runs on csrc/flash_bwd_wgmma.cu; here only above.
template <>
cudaError_t dispatch<bf16>(const Params& p, int B, int dh, int sms,
                           cudaStream_t s) {
  (void)sms;
  if (dh <= 256) return cudaErrorInvalidValue;
  return launch_wide<bf16>(p, B, dh, s);
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
    int hk, int dropout, int dtype, int device, void* stream) {
  const DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p;
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
    err = dispatch<float>(p, B, dh, sms, s);
  else if (dtype == 1)
    err = dispatch<bf16>(p, B, dh, sms, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* avsep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
