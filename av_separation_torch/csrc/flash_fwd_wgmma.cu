// Flash attention forward in bfloat16 for Hopper (sm_90a): warpgroup
// products (`wgmma`) on tiles that TMA brings into a shared-memory ring
// guarded by mbarriers, at head dims 32, 64, 128 and 256, and above 256 on
// a thread-block cluster whose blocks own 128-column chunks
// (`flash_fwd_kernel_wgmma_cluster`, below).  Float32 runs on
// csrc/flash_attn_fwd.cu.
//
// Replaces: av_separation_tpu/ops/pallas/attention.py `_fwd_hpacked_kernel`
// (packed (B, T, H*dh)), `_fwd_packed_kernel` (split (B*H, T, dh)) and the
// multi-block `_fwd_kernel` (Tk > 512), at the JAX package's bf16 rules
// (attention.py:206-218, :389-398, :600-645).  q, k, v are addressed by
// 4-D tensor maps (dh, H, T, B) over the caller's strides, so every layout
// reaches one kernel; keys stream in tiles, so Tk has no cap.
//
// Arithmetic, as the mma.sync kernel it replaces: products of bf16
// operands summed in float32; the online softmax in float32, in the exp2
// domain (s * scale * log2(e) in one multiply, p = exp2(s2 - m2)); p
// rounded to bf16 before P V, l summing the unrounded p; dropped p zeroed
// before P V (the keep test of dropout_hash.cuh, keyed by the Pallas tile
// sizes, so the backward and the JAX kernels see the same mask);
// o = acc / (l (1 - rate)) stored in bf16; lse = (m2 + log2 l) ln 2 in
// float32 (natural log, as the Pallas kernels emit it).
//
// Bound on the H100 at the scaled audio self-attention (B 8, H 4, T 501,
// dh 128): 4.1 GFLOP of bf16 products, 4.2 us at 989 TFLOP/s, against
// 16 MB of q, k, v, o: 4.9 us at 3.35 TB/s, so bound by bytes.
//
// Design:
// - Warp roles.  Warpgroup 0 is the producer: one thread of its first
//   warp starts every TMA copy (its other warps exit; a 32-thread producer
//   buys no registers, since ptxas sizes the cap as for whole
//   warpgroups).  Warpgroups 1..NC are consumers of 64 query rows each.
//   The producer loads the block's Q panels once, then streams 64-key K
//   and V panels through a ring of 2-4 stages: a stage's `full` barrier
//   completes on the copies' bytes, its `empty` barrier on one arrival of
//   each consumer warp once its products have read the stage.  Keys past
//   Tk arrive as zeros from the TMA unit and score -inf.
// - Registers.  ptxas allocates every warp at the cap the launch bounds
//   set (it does not raise a consumer's code past it after `setmaxnreg`,
//   so no instance asks for it): 168 a thread with two consumer
//   warpgroups, 255 with one (dh 256: O is 128 floats a thread).  No
//   instance spills.
// - Products.  S = Q K^T is m64n64k16 with both operands K-major in
//   shared memory (dh / 16 steps).  The softmax runs on the accumulator
//   fragments (a row's max and sum over the four lanes that share it).
//   O += P V takes P from registers (accumulator chunks 2j, 2j + 1 are the
//   k16 A fragment as they stand) and V as an MN-major B operand (the
//   transpose bit): one n64 product per 64 columns of dh (n32 at dh 32).
//   The whole head dim is one block's, dh 256 included (128 accumulators
//   a thread).
// - Overlap.  Two consumer warpgroups share a block of 128 rows (and each
//   K and V stage), so one's softmax and hash run while the other's
//   products do; the ring holds up to 4 stages so the copies run ahead.
//   Issuing S of tile j + 1 before P V of tile j inside a warpgroup (the
//   softmax of j + 1 under that P V) measured slower on the H100 (audio
//   self 0.0208 against 0.0173 ms), so each warpgroup runs its tile in
//   order.
//   NC = 1 (64-row blocks) where that grid gives each block an SM of its
//   own (T 1024 at B2 H4, the visual self-attention at T 200), and at dh
//   256.
// - Dropout.  A 64-key tile lies in one Pallas key tile (hk is a multiple
//   of 128), so the hash's key-tile term is taken once a tile and its row
//   part once a row.
// - Host.  The shared-memory attribute is set once per instance and
//   device, the SM count read once per device; the three tensor maps are
//   encoded per call (avsep_tma_encode_us times one encode).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <chrono>
#include <type_traits>

#include "chunk_frags.cuh"
#include "cluster.cuh"
#include "dropout_hash.cuh"
#include "grid_fold.cuh"
#include "wgmma_tma.cuh"
#include "device_guard.cuh"

namespace {

constexpr int kBlockK = 64;  // keys a stage

struct Params {
  void* o;
  float* lse;
  int H, Tq, Tk;
  long long sob, soh, sot;
  float scale_log2;  // scale * log2(e)
  float keep;        // 1 - rate
  DropoutHash drop;
};

// Above dh 128 kClusterMax, the chunks a cluster block owns after its
// first (cluster.cuh): q, k, v and their (batch, head, time) strides, and
// the scratch buffer of their accumulators.  Only the cluster kernel's
// multi-chunk instance takes them: with them in Params the one-chunk
// instance compiled to 219 registers in place of 229 and ran 8-16% slower
// (tools/torch_flash_rows.py, in turns on the H100).
struct MultiParams : Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  long long sqb, sqh, sqt, skb, skh, skt, svb, svh, svt;
  int nc;  // column chunks
  float* scratch;
};

// The block's Q panels, then as many K / V stages as fit, up to 4.
template <int DH, int NC>
struct FwdLayout {
  using P = Panel<DH>;
  static constexpr int kThreads = 128 * (NC + 1);
  static constexpr int kQ = NC * P::kBytes;
  static constexpr int kStage = 2 * P::kBytes;  // K panel, then V panel
  static constexpr int kFit = (232448 - 1024 - 8 * 9 - kQ) / kStage;
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr int kBarOffset = kQ + kStages * kStage;
  // 1024 bytes of slack to align the panels, then the barriers.
  static constexpr size_t kBytes = 1024 + kBarOffset + 8 * (1 + 2 * kStages);
  static_assert(kStages >= 2 && kBytes <= 232448, "shared memory");
};

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int DH, int NC>
__global__ void __launch_bounds__(128 * (NC + 1), 1)
flash_fwd_kernel_wgmma(const __grid_constant__ CUtensorMap mq,
                       const __grid_constant__ CUtensorMap mk,
                       const __grid_constant__ CUtensorMap mv,
                       const Params p) {
  using L = FwdLayout<DH, NC>;
  using P = Panel<DH>;
  extern __shared__ char smem_raw[];
  char* smem = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  char* sQ = smem;
  char* sKV = smem + L::kQ;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBarOffset);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + L::kStages;

  const TileOf at =
      unfold((p.Tq + kPanelRows * NC - 1) / (kPanelRows * NC));
  const int bh = at.pair;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = at.tile * kPanelRows * NC;
  const int n_tiles = (p.Tk + kBlockK - 1) / kBlockK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * NC);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // Producer.
    if (threadIdx.x == 0) {
      tma_prefetch_desc(&mq);
      tma_prefetch_desc(&mk);
      tma_prefetch_desc(&mv);
      mbar_expect_tx(q_full, L::kQ);
      for (int c = 0; c < NC; ++c)
        tma_panel<DH>(sQ + c * P::kBytes, &mq, q_full, 0, h,
                      q0 + c * kPanelRows, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % L::kStages;
        mbar_wait(&empty[s], ((j / L::kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], L::kStage);
        char* st = sKV + s * L::kStage;
        tma_panel<DH>(st, &mk, &full[s], 0, h, j * kBlockK, b);
        tma_panel<DH>(st + P::kBytes, &mv, &full[s], 0, h, j * kBlockK, b);
      }
    }
  } else {
    // Consumers: warpgroup c owns query rows [q0 + 64 c, q0 + 64 c + 64).
    const int c = wg - 1;
    const int lane = threadIdx.x & 31;
    const int w = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, t = lane & 3;
    const int row0 = q0 + c * kPanelRows + 16 * w + g;  // and row0 + 8
    const uint32_t q_addr = smem_u32(sQ + c * P::kBytes);

    HashRow hr0 = {0u, 0u}, hr1 = {0u, 0u};
    if (p.drop.on) {
      hr0 = hash_row(p.drop, bh, row0);
      hr1 = hash_row(p.drop, bh, row0 + 8);
    }
    float o[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY;  // running max, exp2 domain
    float l0 = 0.f, l1 = 0.f;              // this lane's part of the sums

    mbar_wait(q_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % L::kStages;
      mbar_wait(&full[s], (j / L::kStages) & 1);
      const uint32_t k_addr = smem_u32(sKV + s * L::kStage);
      const uint32_t v_addr = k_addr + P::kBytes;

      float sc[32];
      wgmma_fence();
      product_ss<DH>(sc, q_addr, k_addr);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // Online softmax on the fragments: register 4n + 2hh + e is row
      // row0 + 8 hh, key k0 + 8n + 2t + e.
      const int k0 = j * kBlockK;
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool valid = k0 + 8 * n + 2 * t + e < p.Tk;
          sc[4 * n + e] = valid ? sc[4 * n + e] * p.scale_log2 : -INFINITY;
          sc[4 * n + 2 + e] =
              valid ? sc[4 * n + 2 + e] * p.scale_log2 : -INFINITY;
          mx0 = fmaxf(mx0, sc[4 * n + e]);
          mx1 = fmaxf(mx1, sc[4 * n + 2 + e]);
        }
      }
      mx0 = quad_max(mx0);
      mx1 = quad_max(mx1);
      const float alpha0 = exp2f(m0 - mx0), alpha1 = exp2f(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      l0 *= alpha0;
      l1 *= alpha1;
      const unsigned ktile =
          static_cast<unsigned>(k0 / p.drop.hk) * 0x27D4EB2Fu;
      const int kbase = k0 % p.drop.hk;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float p0 = exp2f(sc[4 * n + e] - m0);
          float p1 = exp2f(sc[4 * n + 2 + e] - m1);
          l0 += p0;
          l1 += p1;
          if (p.drop.on) {
            const HashCol hc = {
                static_cast<unsigned>(kbase + 8 * n + 2 * t + e) * 0x61C88647u,
                ktile};
            if (!hash_keep(p.drop, hr0, hc)) p0 = 0.f;
            if (!hash_keep(p.drop, hr1, hc)) p1 = 0.f;
          }
          sc[4 * n + e] = p0;
          sc[4 * n + 2 + e] = p1;
        }
      }
#pragma unroll
      for (int n = 0; n < DH / 8; ++n) {
        o[4 * n + 0] *= alpha0;
        o[4 * n + 1] *= alpha0;
        o[4 * n + 2] *= alpha1;
        o[4 * n + 3] *= alpha1;
      }

      // O += bf16(P) V over the tile's 64 keys (four k16 steps).
      unsigned a[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) acc_as_a(sc, kk, a[kk]);
      wgmma_fence();
      product_rs<DH, DH>(o, a, v_addr, 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    const float inv0 = 1.f / (l0 * p.keep), inv1 = 1.f / (l1 * p.keep);
    bf16* ob = static_cast<bf16*>(p.o) + b * p.sob + h * p.soh;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      const int col = 8 * n + 2 * t;
      if (row0 < p.Tq)
        *reinterpret_cast<__nv_bfloat162*>(ob + row0 * p.sot + col) =
            __floats2bfloat162_rn(o[4 * n] * inv0, o[4 * n + 1] * inv0);
      if (row0 + 8 < p.Tq)
        *reinterpret_cast<__nv_bfloat162*>(ob + (row0 + 8) * p.sot + col) =
            __floats2bfloat162_rn(o[4 * n + 2] * inv1, o[4 * n + 3] * inv1);
    }
    if (t == 0) {
      constexpr float kLn2 = 0.6931471805599453f;
      if (row0 < p.Tq)
        p.lse[(long long)bh * p.Tq + row0] = (m0 + log2f(l0)) * kLn2;
      if (row0 + 8 < p.Tq)
        p.lse[(long long)bh * p.Tq + row0 + 8] = (m1 + log2f(l1)) * kLn2;
    }
  }
}

// Above head dim 256 (any multiple of 128): a cluster of nc = dh / 128
// blocks shares 64 query rows, block c (its rank,
// blockIdx.z) owning column chunk c of Q, K, V and O.  One warpgroup a
// block, its thread 0 issuing the TMA copies.  For each 64-key tile the
// block computes the partial S_c = Q_c K_c^T (m64n64k16 over its own 128
// columns) and puts it in the K_c panel it has just consumed.  The
// partials are summed once, spread over the cluster: of a thread's 8
// float4 of S, float4 i is summed (in rank order) by block i % nc
// (`reduce_slots`), which writes the sum over its own partial, and every
// block gathers the 8 sums (`gather_slots`), so every block holds the same
// S and runs the same online softmax; then O_c += P V_c on the block's own
// V panel.  2 nc chunk products a tile pair.  The gather of tile j waits
// for the barrier of tile j + 1, so one cluster barrier a tile orders both
// halves: iteration j computes S_j's partial, passes the barrier, reduces
// its slots of S_j and gathers S_{j-1}, then runs the softmax and P V of
// tile j - 1 (cluster.cuh).  Against every block summing all nc partials,
// the loads from other blocks fall from 8 (nc - 1) to about
// 16 (nc - 1) / nc float4 a thread and tile.  K_c and V_c panels stream
// through a 3-stage ring: a stage serves S_j and the exchange in iteration
// j, the gather and P V in iteration j + 1, and takes tile j + 3 after the
// barrier of iteration j + 2.  A block takes 113 KB, two an SM, so one
// block's barrier and loads from the cluster run under the other's
// products.  Above 128 kClusterMax (kMulti) a cluster of
// C = cluster_blocks(nc) blocks shares the rows, block r owning chunks
// r + i C (cluster.cuh): it adds the partials of its chunks after the
// first to its partial S in chunk order, on mma.sync.m16n8k16 with their
// operands read from global memory (chunk_frags.cuh), and keeps their O
// accumulators in the scratch buffer; still 2 nc chunk products a tile
// pair.
constexpr int kChunk = 128;  // head-dim columns a block of a cluster

struct ClusterLayout {
  using P = Panel<kChunk>;
  static constexpr int kThreads = 128;
  static constexpr int kQ = P::kBytes;          // Q_c
  static constexpr int kStage = 2 * P::kBytes;  // K_c panel, then V_c
  static constexpr int kStages = 3;
  static constexpr int kBarOffset = kQ + kStages * kStage;
  static constexpr int kUsed = kBarOffset + 8 * kStages;
  // The panels need 1024-byte alignment; the rest of two blocks' share of
  // an SM (233,472 bytes less 1 KB each kept by the card) is the slack for
  // aligning the dynamic shared memory's start.
  static constexpr size_t kBytes = (233472 - 2 * 1024) / 2;
  static_assert(kThreads * 8 * 16 <= P::kBytes && kUsed < kBytes,
                "shared memory");
};

template <bool kMulti>
using ClusterParams = std::conditional_t<kMulti, MultiParams, Params>;

template <bool kMulti>
__global__ void __launch_bounds__(128, 2)
flash_fwd_kernel_wgmma_cluster(const __grid_constant__ CUtensorMap mq,
                               const __grid_constant__ CUtensorMap mk,
                               const __grid_constant__ CUtensorMap mv,
                               const ClusterParams<kMulti> p) {
  using L = ClusterLayout;
  using P = Panel<kChunk>;
  extern __shared__ char smem_raw[];
  char* smem = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  if (smem + L::kUsed > smem_raw + L::kBytes) __trap();
  char* sQ = smem;
  char* sKV = smem + L::kQ;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBarOffset);

  const int tid = threadIdx.x;
  const int cs = gridDim.z;  // blocks of the cluster
  const unsigned rank = cluster_rank();
  const int col0 = rank * kChunk;
  const TileOf at = unfold((p.Tq + kPanelRows - 1) / kPanelRows);
  const int bh = at.pair;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = at.tile * kPanelRows;
  const int n_tiles = (p.Tk + kBlockK - 1) / kBlockK;

  // Tile jj's K_c and V_c panels into their stage (thread 0).
  auto load_tile_kv = [&](int jj) {
    const int ss = jj % L::kStages;
    char* st = sKV + ss * L::kStage;
    mbar_expect_tx(&full[ss], L::kStage + (jj == 0 ? L::kQ : 0));
    tma_panel<kChunk>(st, &mk, &full[ss], col0, h, jj * kBlockK, b);
    tma_panel<kChunk>(st + P::kBytes, &mv, &full[ss], col0, h, jj * kBlockK,
                      b);
  };
  if (tid == 0) {
    for (int s = 0; s < L::kStages; ++s) mbar_init(&full[s], 1);
    mbar_fence_init();
    tma_prefetch_desc(&mq);
    tma_prefetch_desc(&mk);
    tma_prefetch_desc(&mv);
    load_tile_kv(0);  // with Q_c, on the same barrier
    tma_panel<kChunk>(sQ, &mq, &full[0], col0, h, q0, b);
  }
  __syncthreads();

  const int lane = tid & 31;
  const int w = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + 16 * w + g;  // and row0 + 8
  const uint32_t q_addr = smem_u32(sQ);
  HashRow hr0 = {0u, 0u}, hr1 = {0u, 0u};
  if (p.drop.on) {
    hr0 = hash_row(p.drop, bh, row0);
    hr1 = hash_row(p.drop, bh, row0 + 8);
  }
  float o[kChunk / 2];
#pragma unroll
  for (int i = 0; i < kChunk / 2; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max, exp2 domain
  float l0 = 0.f, l1 = 0.f;              // this lane's part of the sums

  // Iteration j: S_j's partial into its K_c panel (j < n_tiles); the
  // barrier; tile j + 1's copy; the reduction of this block's slots of S_j
  // and the gather of S_{j-1}'s sums; the softmax and P V of tile j - 1
  // (j >= 1).
  for (int j = 0; j <= n_tiles; ++j) {
    float sc[32];
    float* xs = reinterpret_cast<float*>(sKV + (j % L::kStages) * L::kStage);
    if (j < n_tiles) {
      mbar_wait(&full[j % L::kStages], (j / L::kStages) & 1);
      wgmma_fence();
      product_ss<kChunk>(sc, q_addr, smem_u32(xs));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      if constexpr (kMulti) {
        // The partials of the block's other chunks (rank + i cs, i <
        // chunks), added in chunk order: accumulator register 4n + 2hh + e
        // is the m16n8 C fragment's.
        const int chunks = chunks_per_block(p.nc);
        const GlobalRows<bf16> gq = {p.q + b * p.sqb + h * p.sqh, p.sqt,
                                     p.Tq};
        const GlobalRows<bf16> gk = {p.k + b * p.skb + h * p.skh, p.skt,
                                     p.Tk};
        for (int i = 1; i < chunks && rank + i * cs < p.nc; ++i) {
          const int cc = (rank + i * cs) * kChunk;
#pragma unroll 1
          for (int kk = 0; kk < kChunk / 16; ++kk) {
            unsigned a[4];
            gfrag_a(gq, q0 + 16 * w, cc + 16 * kk, g, t, a);
#pragma unroll
            for (int n = 0; n < 8; ++n) {
              unsigned bb[2];
              gfrag_b_rows(gk, j * kBlockK + 8 * n, cc + 16 * kk, g, t, bb);
              float d[4] = {sc[4 * n], sc[4 * n + 1], sc[4 * n + 2],
                            sc[4 * n + 3]};
              mma_bf16(d, a, bb);
#pragma unroll
              for (int e = 0; e < 4; ++e) sc[4 * n + e] = d[e];
            }
          }
        }
      }
      __syncthreads();  // every warp's products have read the K_c panel
      put_partials<8>(xs, sc, L::kThreads, tid);
    }
    // The exchange's reads and writes of the panels come before the TMA
    // copies that will refill them (another proxy).
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    cluster_sync();
    // Tile j + 1 into the stage of tile j - 2, whose panels every block of
    // the cluster is done with.
    if (tid == 0 && j + 1 < n_tiles) load_tile_kv(j + 1);
    if (j < n_tiles) reduce_slots<8>(xs, xs, L::kThreads, tid, cs, rank);
    if (j == 0) continue;
    const char* prev = sKV + ((j - 1) % L::kStages) * L::kStage;
    gather_slots<8>(sc, reinterpret_cast<const float*>(prev), L::kThreads,
                    tid, 0, cs, rank);

    // Online softmax of tile j - 1 on the fragments: register 4n + 2hh + e
    // is row row0 + 8 hh, key k0 + 8n + 2t + e.
    const int k0 = (j - 1) * kBlockK;
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool valid = k0 + 8 * n + 2 * t + e < p.Tk;
        sc[4 * n + e] = valid ? sc[4 * n + e] * p.scale_log2 : -INFINITY;
        sc[4 * n + 2 + e] =
            valid ? sc[4 * n + 2 + e] * p.scale_log2 : -INFINITY;
        mx0 = fmaxf(mx0, sc[4 * n + e]);
        mx1 = fmaxf(mx1, sc[4 * n + 2 + e]);
      }
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    const float alpha0 = exp2f(m0 - mx0), alpha1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    l0 *= alpha0;
    l1 *= alpha1;
    const unsigned ktile =
        static_cast<unsigned>(k0 / p.drop.hk) * 0x27D4EB2Fu;
    const int kbase = k0 % p.drop.hk;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float p0 = exp2f(sc[4 * n + e] - m0);
        float p1 = exp2f(sc[4 * n + 2 + e] - m1);
        l0 += p0;
        l1 += p1;
        if (p.drop.on) {
          const HashCol hc = {
              static_cast<unsigned>(kbase + 8 * n + 2 * t + e) * 0x61C88647u,
              ktile};
          if (!hash_keep(p.drop, hr0, hc)) p0 = 0.f;
          if (!hash_keep(p.drop, hr1, hc)) p1 = 0.f;
        }
        sc[4 * n + e] = p0;
        sc[4 * n + 2 + e] = p1;
      }
    }
#pragma unroll
    for (int n = 0; n < kChunk / 8; ++n) {
      o[4 * n + 0] *= alpha0;
      o[4 * n + 1] *= alpha0;
      o[4 * n + 2] *= alpha1;
      o[4 * n + 3] *= alpha1;
    }

    // O_c += bf16(P) V_c over tile j - 1's 64 keys (four k16 steps).
    unsigned a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc_as_a(sc, kk, a[kk]);
    wgmma_fence();
    product_rs<kChunk, kChunk>(o, a, smem_u32(prev) + P::kBytes, 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    if constexpr (kMulti) {
      // O_c' += bf16(P) V_c' for the block's other chunks c', their
      // accumulators through the scratch buffer (zero before tile 0).
      const int chunks = chunks_per_block(p.nc);
      const GlobalRows<bf16> gv = {p.v + b * p.svb + h * p.svh, p.svt,
                                   p.Tk};
      for (int i = 1; i < chunks && rank + i * cs < p.nc; ++i) {
        const int cc = (rank + i * cs) * kChunk;
        float4* acc = extra_acc(p.scratch, i, chunks, kChunk / 8);
#pragma unroll 1
        for (int dn = 0; dn < kChunk / 8; ++dn) {
          float d[4] = {0.f, 0.f, 0.f, 0.f};
          if (j > 1) load4(d, acc + dn * L::kThreads);
          d[0] *= alpha0;
          d[1] *= alpha0;
          d[2] *= alpha1;
          d[3] *= alpha1;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            unsigned bb[2];
            gfrag_b_cols(gv, k0 + 16 * kk, cc + 8 * dn, g, t, bb);
            mma_bf16(d, a[kk], bb);
          }
          store4(acc + dn * L::kThreads, d);
        }
      }
    }
  }
  // No block leaves while another may still read its shared memory.
  cluster_sync();

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float inv0 = 1.f / (l0 * p.keep), inv1 = 1.f / (l1 * p.keep);
  if constexpr (kMulti) {
    const int chunks = chunks_per_block(p.nc);
    bf16* orow = static_cast<bf16*>(p.o) + b * p.sob + h * p.soh;
    for (int i = 1; i < chunks && rank + i * cs < p.nc; ++i) {
      const int cc = (rank + i * cs) * kChunk;
      const float4* acc = extra_acc(p.scratch, i, chunks, kChunk / 8);
#pragma unroll 1
      for (int dn = 0; dn < kChunk / 8; ++dn) {
        float d[4];
        load4(d, acc + dn * L::kThreads);
        const int col = cc + 8 * dn + 2 * t;
        if (row0 < p.Tq)
          *reinterpret_cast<__nv_bfloat162*>(orow + row0 * p.sot + col) =
              __floats2bfloat162_rn(d[0] * inv0, d[1] * inv0);
        if (row0 + 8 < p.Tq)
          *reinterpret_cast<__nv_bfloat162*>(orow + (row0 + 8) * p.sot +
                                             col) =
              __floats2bfloat162_rn(d[2] * inv1, d[3] * inv1);
      }
    }
  }
  bf16* ob = static_cast<bf16*>(p.o) + b * p.sob + h * p.soh + col0;
#pragma unroll
  for (int n = 0; n < kChunk / 8; ++n) {
    const int col = 8 * n + 2 * t;
    if (row0 < p.Tq)
      *reinterpret_cast<__nv_bfloat162*>(ob + row0 * p.sot + col) =
          __floats2bfloat162_rn(o[4 * n] * inv0, o[4 * n + 1] * inv0);
    if (row0 + 8 < p.Tq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (row0 + 8) * p.sot + col) =
          __floats2bfloat162_rn(o[4 * n + 2] * inv1, o[4 * n + 3] * inv1);
  }
  if (t == 0 && rank == 0) {
    constexpr float kLn2 = 0.6931471805599453f;
    if (row0 < p.Tq)
      p.lse[(long long)bh * p.Tq + row0] = (m0 + log2f(l0)) * kLn2;
    if (row0 + 8 < p.Tq)
      p.lse[(long long)bh * p.Tq + row0 + 8] = (m1 + log2f(l1)) * kLn2;
  }
}

template <bool kMulti>
cudaError_t launch_cluster_fwd(const CUtensorMap& mq, const CUtensorMap& mk,
                               const CUtensorMap& mv,
                               const ClusterParams<kMulti>& p, int B, int nc,
                               cudaStream_t stream) {
  static unsigned done = 0;
  return launch_cluster(
      flash_fwd_kernel_wgmma_cluster<kMulti>,
      folded_grid((p.Tq + kPanelRows - 1) / kPanelRows, (long long)B * p.H,
                  1, cluster_blocks(nc)),
      ClusterLayout::kThreads, ClusterLayout::kBytes, stream, &done, mq, mk,
      mv, p);
}

// The scratch buffer of the cluster kernel's extra chunks (cluster.cuh).
long long fwd_scratch_bytes(int B, int H, int Tq, int dh) {
  if (dh <= 256 || dh % kChunk) return 0;
  return extra_acc_bytes(
      (long long)((Tq + kPanelRows - 1) / kPanelRows) * B * H, dh / kChunk,
      ClusterLayout::kThreads, kChunk / 8);
}

template <int DH, int NC>
cudaError_t launch(const CUtensorMap& mq, const CUtensorMap& mk,
                   const CUtensorMap& mv, const Params& p, int B, int device,
                   cudaStream_t stream) {
  using L = FwdLayout<DH, NC>;
  static unsigned done = 0;
  cudaError_t err = set_smem_once(flash_fwd_kernel_wgmma<DH, NC>, L::kBytes,
                                  device, &done);
  if (err != cudaSuccess) return err;
  const dim3 grid =
      folded_grid((p.Tq + kPanelRows * NC - 1) / (kPanelRows * NC),
                  (long long)B * p.H);
  flash_fwd_kernel_wgmma<DH, NC>
      <<<grid, L::kThreads, L::kBytes, stream>>>(mq, mk, mv, p);
  return cudaGetLastError();
}

// One consumer warpgroup a block (64 rows) where that grid gives each
// block an SM of its own, and at dh 256 (its 128 O accumulators take ~233
// registers); else two (128 rows: the two share each K and V stage).
template <int DH>
cudaError_t dispatch(const CUtensorMap& mq, const CUtensorMap& mk,
                     const CUtensorMap& mv, const Params& p, int B,
                     int device, cudaStream_t s) {
  if constexpr (DH == 256) {
    return launch<DH, 1>(mq, mk, mv, p, B, device, s);
  } else {
    const long long blocks1 =
        (long long)((p.Tq + kPanelRows - 1) / kPanelRows) * B * p.H;
    return blocks1 <= sm_count(device)
               ? launch<DH, 1>(mq, mk, mv, p, B, device, s)
               : launch<DH, 2>(mq, mk, mv, p, B, device, s);
  }
}

}  // namespace

// q, k, v, o bf16 with (batch, head, time) strides in elements; lse
// float32 (B, H, Tq).
extern "C" int avsep_flash_fwd_wgmma(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int H, int Tq, int Tk, int dh, long long sqb, long long sqh,
    long long sqt, long long skb, long long skh, long long skt,
    long long svb, long long svh, long long svt, long long sob,
    long long soh, long long sot, float scale, float keep,
    unsigned threshold, unsigned seed, int hq, int hk, int dropout,
    int device, void* stream, void* scratch) {
  const DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (fwd_scratch_bytes(B, H, Tq, dh) > 0 && scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mq, mk, mv;
  if (!encode_map(&mq, q, dh, H, Tq, B, sqh, sqt, sqb) ||
      !encode_map(&mk, k, dh, H, Tk, B, skh, skt, skb) ||
      !encode_map(&mv, v, dh, H, Tk, B, svh, svt, svb))
    return static_cast<int>(cudaErrorInvalidValue);
  MultiParams p;
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.H = H; p.Tq = Tq; p.Tk = Tk;
  p.sob = sob; p.soh = soh; p.sot = sot;
  p.scale_log2 = scale * 1.4426950408889634f;
  p.keep = keep;
  p.drop.seed = seed;
  p.drop.threshold = threshold;
  p.drop.hq = hq;
  p.drop.hk = hk;
  p.drop.on = dropout;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.sqb = sqb; p.sqh = sqh; p.sqt = sqt;
  p.skb = skb; p.skh = skh; p.skt = skt;
  p.svb = svb; p.svh = svh; p.svt = svt;
  p.nc = dh / kChunk;
  p.scratch = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32: return static_cast<int>(dispatch<32>(mq, mk, mv, p, B, device, s));
    case 64: return static_cast<int>(dispatch<64>(mq, mk, mv, p, B, device, s));
    case 128:
      return static_cast<int>(dispatch<128>(mq, mk, mv, p, B, device, s));
    case 256:
      return static_cast<int>(dispatch<256>(mq, mk, mv, p, B, device, s));
    default:
      return static_cast<int>(
          dh <= 256 || dh % kChunk ? cudaErrorInvalidValue
          : p.nc > kClusterMax
              ? launch_cluster_fwd<true>(mq, mk, mv, p, B, p.nc, s)
              : launch_cluster_fwd<false>(mq, mk, mv, p, B, p.nc, s));
  }
}

// Shared memory of a block of the cluster kernel (bytes).
extern "C" int avsep_flash_fwd_wgmma_cluster_smem() {
  return static_cast<int>(ClusterLayout::kBytes);
}

// Bytes of the scratch buffer a call at these sizes takes (`scratch`, float
// aligned); 0 up to dh 128 kClusterMax.
extern "C" long long avsep_flash_fwd_wgmma_scratch(int B, int H, int Tq,
                                                   int dh) {
  return fwd_scratch_bytes(B, H, Tq, dh);
}

// Host microseconds of one tensor-map encode, the mean of `iters`; -1
// where the encode fails.
extern "C" double avsep_tma_encode_us(const void* base, int dh, int H, int T,
                                      int B, long long sh, long long st,
                                      long long sb, int iters) {
  CUtensorMap map;
  if (!encode_map(&map, base, dh, H, T, B, sh, st, sb)) return -1.0;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < iters; ++i)
    encode_map(&map, base, dh, H, T, B, sh, st, sb);
  const auto t1 = std::chrono::steady_clock::now();
  return std::chrono::duration<double, std::micro>(t1 - t0).count() / iters;
}

extern "C" const char* avsep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
