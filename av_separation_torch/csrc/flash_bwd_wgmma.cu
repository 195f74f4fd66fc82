// Flash attention backward in bfloat16 for Hopper (sm_90a): warpgroup
// products (`wgmma`) on tiles that TMA brings into a shared-memory ring
// guarded by mbarriers.  The bf16 instances of csrc/flash_attn_bwd.cu at
// head dims 32, 64, 128 and 256 (the float32 instances, and bf16 above 256,
// stay there).
//
// Replaces: av_separation_tpu/ops/pallas/attention.py `_bwd_hpacked_kernel`
// (packed (B, T, H*dh)), `_bwd_packed_kernel` (split (B*H, T, dh)) and the
// multi-block `_delta_kernel` / `_dq_kernel` / `_dkv_kernel` (T > 512), at
// the Pallas bf16 rules (attention.py:238-263, :418-443, :711-810):
//   delta = rowsum(dO * O) in float32
//   p  = exp(q.k * scale - lse)            (here exp2(s * scale log2 e -
//                                            lse log2 e))
//   dp = dO.v, masked and divided by (1 - rate) where kept
//   pd = keep ? p / (1 - rate) : 0,   dV = bf16(pd)^T dO
//   ds = p (dp - delta) scale,        dQ = bf16(ds) K,  dK = bf16(ds)^T Q
// products of bf16 operands summed in float32, dq, dk, dv stored in bf16,
// the keep mask regenerated from the Pallas hash (dropout_hash.cuh) keyed
// by the Pallas tile sizes: the forward's mask and the JAX mask.
//
// Bound on the H100 at the scaled shape (B 8, H 4, T 501, dh 128): 5
// products of 2 B H Tq Tk dh, 10.3 GFLOP, 10.4 us at 989 TFLOP/s, against
// 33 MB in and out, 9.8 us at 3.35 TB/s: operations.  These kernels do 7
// products (the dQ kernel recomputes q k^T and dO v^T), 14.6 us, so as to
// need no atomics: two runs give bit-identical gradients.
//
// Design (the building blocks and fragment maps are wgmma_tma.cuh's):
// - delta kernel: one warp per query row, as in flash_attn_bwd.cu.
// - dK/dV kernel: warpgroup 0 produces (one thread starts the TMA
//   copies); a block owns 64 keys.  Its K and V panels are loaded once;
//   64-row Q and dO panels stream through a ring of 2-4 stages (full
//   barriers on the copies' bytes and on the producer warp's 32 lanes,
//   which stage the rows' lse log2(e) and delta beside them; empty
//   barriers on one arrival of each consumer warp).  Consumer warpgroup 1
//   forms S^T = K Q^T (an m64n64k16 product, both operands K-major), P^T
//   and the keep bits (the hash's key part once per row, its query part
//   once a tile and column) and accumulates dV += bf16(Pd^T) dO; it hands
//   P^T to warpgroup 2 through the stage's shared memory (a dropped
//   element's sign bit set) with a named barrier a stage.  Warpgroup 2
//   forms dP^T = V dO^T and dS^T and accumulates dK += bf16(dS^T) Q.  The
//   register products take the fragments as A operands and dO and Q as
//   MN-major B operands (the transpose bit).  So S^T, its exponentials
//   and the hash are formed once, and the two warpgroups' products run
//   side by side: one warpgroup holding dK, dV, S^T and dP^T needs ~234
//   registers, past the 168 two warpgroups a block leave.
// - dQ kernel: the same producer; warpgroup c owns 64 query rows (two a
//   block, or one where that grid gives each block an SM), Q and dO
//   loaded once, 64-key K and V panels through the ring: S = Q K^T and
//   dP = dO V^T (SS), dS in registers, dQ += bf16(dS) K with K MN-major.
//   Each warpgroup runs its tiles in order: issuing the next tile's S and
//   dP before this tile's dQ product measured slower (as the forward).
// - Registers.  ptxas allocates every warp at the cap the launch bounds
//   set (it does not raise a consumer's code past it after `setmaxnreg`,
//   so no instance asks for it): 168 a thread in the 384-thread blocks,
//   255 in the 256-thread ones (dh 256's dQ: 128 accumulators).  At dh
//   256 a dK/dV block owns one group of 128 output columns (blockIdx.z)
//   and forms S^T and dP^T over all 256.  No instance spills.
// - Rows past T arrive as zeros from the TMA unit; a query past Tq gets
//   lse +inf in the dK/dV kernel (p = 0), a key past Tk gets p = 0 in the
//   dQ kernel, and neither is stored.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "dropout_hash.cuh"
#include "grid_fold.cuh"
#include "wgmma_tma.cuh"
#include "device_guard.cuh"

namespace {

constexpr int kTile = 64;  // query (dK/dV) or key (dQ) rows a stage
constexpr int kDeltaThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const bf16* o;
  const bf16* dout;
  const float* lse;
  float* delta;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  int H, Tq, Tk;
  // (batch, head, time) strides (elements) of o, dO, dQ, dK, dV.
  long long so[3], sdo[3], sdq[3], sdk[3], sdv[3];
  float scale;       // softmax scale
  float scale_log2;  // scale * log2(e)
  float keep;        // 1 - rate
  DropoutHash drop;
};

// ---------------------------------------------------------------------------
// delta = rowsum(dO * O) in float32: one warp per query row.
// ---------------------------------------------------------------------------
template <int DH>
__global__ void __launch_bounds__(kDeltaThreads)
flash_bwd_delta_kernel(const Params p) {
  const int lane = threadIdx.x & 31;
  constexpr int kRows = kDeltaThreads / 32;
  const TileOf at = unfold((p.Tq + kRows - 1) / kRows);
  const int bh = at.pair;
  const int b = bh / p.H, h = bh % p.H;
  const int t = at.tile * kRows + (threadIdx.x >> 5);
  if (t >= p.Tq) return;
  const bf16* orow = p.o + b * p.so[0] + h * p.so[1] + t * p.so[2];
  const bf16* drow = p.dout + b * p.sdo[0] + h * p.sdo[1] + t * p.sdo[2];
  float acc = 0.f;
#pragma unroll
  for (int d = lane; d < DH; d += 32)
    acc = fmaf(__bfloat162float(drow[d]), __bfloat162float(orow[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) p.delta[(long long)bh * p.Tq + t] = acc;
}

// Shared memory of a kernel with NC panels of each of two tensors loaded
// once and a ring of two panels a stage, as many stages as fit, up to 4.
// The dK/dV ring (DKV) also holds, per stage, the 64 rows' lse log2(e) and
// delta and the P^T tile (64 x 64 float32) its dV warpgroup hands to its
// dK warpgroup.
template <int DH, int NC, bool DKV = false>
struct Layout {
  using P = Panel<DH>;
  static constexpr int kThreads = 128 * (NC + 1);
  static constexpr int kFixed = 2 * NC * P::kBytes;
  static constexpr int kStage = 2 * P::kBytes;
  static constexpr int kRowBytes = DKV ? 2 * kTile * 4 : 0;
  static constexpr int kPBytes = DKV ? kPanelRows * kTile * 4 : 0;
  static constexpr int kFit = (232448 - 1024 - 8 * 9 - kFixed) /
                              (kStage + kRowBytes + kPBytes);
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr int kRowsOffset = kFixed + kStages * kStage;
  static constexpr int kPOffset = kRowsOffset + kStages * kRowBytes;
  static constexpr int kBarOffset = kPOffset + kStages * kPBytes;
  static constexpr size_t kBytes = 1024 + kBarOffset + 8 * (1 + 2 * kStages);
  static_assert(kStages >= 2 && kBytes <= 232448, "shared memory");
};

// Named barriers (ids 1..4, one a stage) between a block's two consumer
// warpgroups: the one that writes arrives, the one that reads waits.
__device__ __forceinline__ void pair_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void pair_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ char* aligned_smem(char* raw) {
  return reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
}

// Barriers: fixed (1), full[stages] (`full_count` arrivals each),
// empty[stages] (one arrival of each of the 4 nc consumer warps).
__device__ __forceinline__ void init_barriers(uint64_t* bars, int stages,
                                              int nc, int full_count) {
  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int s = 0; s < stages; ++s) {
      mbar_init(&bars[1 + s], full_count);
      mbar_init(&bars[1 + stages + s], 4 * nc);
    }
    mbar_fence_init();
  }
  __syncthreads();
}

// The producer warp: NC panels of each of ma, mb at rows fixed0 (64 a
// panel), then panels of mc, md at rows 64 j for j < n_tiles through the
// ring; lane 0 starts the copies.  With ROWS (the dK/dV ring) every lane
// also writes two of the stage's rows of lse log2(e) and delta (+inf and 0
// past Tq) and arrives on the stage's full barrier.
template <int DH, int NC, bool ROWS>
__device__ __forceinline__ void produce(char* smem, uint64_t* bars,
                                        const CUtensorMap* ma,
                                        const CUtensorMap* mb,
                                        const CUtensorMap* mc,
                                        const CUtensorMap* md, int fixed0,
                                        int n_tiles, int h, int b,
                                        const Params& p, int bh) {
  using L = Layout<DH, NC, ROWS>;
  using P = Panel<DH>;
  const int lane = threadIdx.x & 31;
  if (!ROWS && lane != 0) return;
  if (lane == 0) {
    tma_prefetch_desc(ma);
    tma_prefetch_desc(mb);
    tma_prefetch_desc(mc);
    tma_prefetch_desc(md);
    mbar_expect_tx(bars, L::kFixed);
    for (int c = 0; c < NC; ++c) {
      tma_panel<DH>(smem + c * P::kBytes, ma, bars, 0, h,
                    fixed0 + c * kPanelRows, b);
      tma_panel<DH>(smem + (NC + c) * P::kBytes, mb, bars, 0, h,
                    fixed0 + c * kPanelRows, b);
    }
  }
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + L::kStages;
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % L::kStages;
    mbar_wait(&empty[s], ((j / L::kStages) & 1) ^ 1);
    if (lane == 0) {
      mbar_expect_tx(&full[s], L::kStage);
      char* st = smem + L::kFixed + s * L::kStage;
      tma_panel<DH>(st, mc, &full[s], 0, h, j * kTile, b);
      tma_panel<DH>(st + P::kBytes, md, &full[s], 0, h, j * kTile, b);
    }
    if constexpr (ROWS) {
      float* rows =
          reinterpret_cast<float*>(smem + L::kRowsOffset + s * L::kRowBytes);
      const long long base = (long long)bh * p.Tq;
      for (int r = lane; r < kTile; r += 32) {
        const int q = j * kTile + r;
        rows[r] = q < p.Tq ? p.lse[base + q] * kLog2e : INFINITY;
        rows[kTile + r] = q < p.Tq ? p.delta[base + q] : 0.f;
      }
      mbar_arrive(&full[s]);
    }
  }
}

// Accumulators (64 rows by NOUT columns of a warpgroup) to rows
// row0, row0 + 8 of a bf16 (time, dh) output at columns [col0, ...).
template <int NOUT>
__device__ __forceinline__ void store_acc(const float (&acc)[NOUT / 2],
                                          bf16* out, long long stride,
                                          int row0, int n, int t) {
#pragma unroll
  for (int i = 0; i < NOUT / 8; ++i) {
    const int col = 8 * i + 2 * t;
    if (row0 < n)
      *reinterpret_cast<__nv_bfloat162*>(out + row0 * stride + col) =
          __floats2bfloat162_rn(acc[4 * i], acc[4 * i + 1]);
    if (row0 + 8 < n)
      *reinterpret_cast<__nv_bfloat162*>(out + (row0 + 8) * stride + col) =
          __floats2bfloat162_rn(acc[4 * i + 2], acc[4 * i + 3]);
  }
}

// ---------------------------------------------------------------------------
// dK, dV: a block owns 64 keys and DV output columns.  Consumer warpgroup
// 1 forms S^T, P^T and the keep bits and accumulates dV; it hands P^T to
// warpgroup 2 through shared memory (the sign bit marking a dropped
// element), which forms dP^T and dS^T and accumulates dK.
// Fixed panels: K, V; ring: Q, dO (and lse, delta, P^T).
// ---------------------------------------------------------------------------
template <int DH, int DV, bool DK>
__device__ __forceinline__ void dkv_consume(char* smem, uint64_t* bars,
                                            const Params& p, int b, int h,
                                            int bh, int k0, int n_tiles) {
  using L = Layout<DH, 1, true>;
  using P = Panel<DH>;
  const int tid = threadIdx.x & 127;
  const int lane = threadIdx.x & 31;
  const int w = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int key0 = k0 + 16 * w + g;  // and key0 + 8
  const int col0 = blockIdx.z * DV;  // output columns
  const int chunk0 = col0 / P::kCW;
  const uint32_t k_addr = smem_u32(smem);
  const uint32_t v_addr = smem_u32(smem + P::kBytes);
  const float inv_keep = 1.f / p.keep;
  HashCol hc0 = {0u, 0u}, hc1 = {0u, 0u};
  if (!DK && p.drop.on) {
    hc0 = hash_col(p.drop, key0);
    hc1 = hash_col(p.drop, key0 + 8);
  }
  const unsigned seed_term = p.drop.seed * 0x9E3779B9u ^
                             static_cast<unsigned>(bh) * 0x85EBCA6Bu;

  float acc[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;

  mbar_wait(bars, 0);
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + L::kStages;
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % L::kStages;
    mbar_wait(&full[s], (j / L::kStages) & 1);
    const uint32_t q_addr = smem_u32(smem + L::kFixed + s * L::kStage);
    const uint32_t do_addr = q_addr + P::kBytes;
    const float* rows = reinterpret_cast<const float*>(
        smem + L::kRowsOffset + s * L::kRowBytes);
    // P^T of the stage, register i of thread tid at [i][tid]: each
    // thread of the dK warpgroup reads what the same thread of the dV
    // warpgroup wrote (the two fragments map alike).
    float* pt = reinterpret_cast<float*>(smem + L::kPOffset + s * L::kPBytes);

    // S^T = K Q^T (dV warpgroup) or dP^T = V dO^T (dK warpgroup).
    float x[32];
    wgmma_fence();
    product_ss<DH>(x, DK ? v_addr : k_addr, DK ? do_addr : q_addr);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(x);

    // Register 4n + 2hh + e: key key0 + 8 hh, query q0 + 8n + 2t + e.
    // A 64-row tile lies in one Pallas query tile (hq >= Tq, or 512).
    if constexpr (DK) {
      pair_sync(1 + s);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float dl = rows[kTile + 8 * n + 2 * t + e];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int i = 4 * n + 2 * hh + e;
            const float y = pt[i * 128 + tid];
            const bool kept = !(__float_as_uint(y) >> 31);
            // Without dropout every element is kept and inv_keep is 1.
            x[i] = fabsf(y) * ((kept ? x[i] * inv_keep : 0.f) - dl) *
                   p.scale;
          }
        }
      }
    } else {
      const int q0 = j * kTile;
      const unsigned rtile =
          seed_term ^ static_cast<unsigned>(q0 / p.drop.hq) * 0xC2B2AE35u;
      const int rbase = q0 % p.drop.hq;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * n + 2 * t + e;
          const float l2 = rows[col];
          const HashRow hr = {
              rtile, static_cast<unsigned>(rbase + col) * 0x01000193u};
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int i = 4 * n + 2 * hh + e;
            const float pr = exp2f(x[i] * p.scale_log2 - l2);
            const bool kept =
                !p.drop.on || hash_keep(p.drop, hr, hh ? hc1 : hc0);
            pt[i * 128 + tid] = kept ? pr : -pr;
            x[i] = kept ? pr * inv_keep : 0.f;
          }
        }
      }
      pair_arrive(1 + s);
    }

    // dV += bf16(Pd^T) dO or dK += bf16(dS^T) Q over the tile's 64
    // queries.
    unsigned a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc_as_a(x, kk, a[kk]);
    wgmma_fence();
    product_rs<DH, DV>(acc, a, DK ? q_addr : do_addr, chunk0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  if constexpr (DK)
    store_acc<DV>(acc, p.dk + b * p.sdk[0] + h * p.sdk[1] + col0, p.sdk[2],
                  key0, p.Tk, t);
  else
    store_acc<DV>(acc, p.dv + b * p.sdv[0] + h * p.sdv[1] + col0, p.sdv[2],
                  key0, p.Tk, t);
}

template <int DH, int DV>
__global__ void __launch_bounds__(384, 1)
flash_bwd_dkv_kernel_wgmma(const __grid_constant__ CUtensorMap mq,
                           const __grid_constant__ CUtensorMap mk,
                           const __grid_constant__ CUtensorMap mv,
                           const __grid_constant__ CUtensorMap mdo,
                           const Params p) {
  using L = Layout<DH, 1, true>;
  extern __shared__ char smem_raw[];
  char* smem = aligned_smem(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBarOffset);
  const TileOf at = unfold((p.Tk + kPanelRows - 1) / kPanelRows);
  const int bh = at.pair;
  const int b = bh / p.H, h = bh % p.H;
  const int k0 = at.tile * kPanelRows;
  const int n_tiles = (p.Tq + kTile - 1) / kTile;
  init_barriers(bars, L::kStages, 2, 33);

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    if (threadIdx.x < 32)
      produce<DH, 1, true>(smem, bars, &mk, &mv, &mq, &mdo, k0, n_tiles, h,
                           b, p, bh);
  } else if (wg == 1) {
    dkv_consume<DH, DV, false>(smem, bars, p, b, h, bh, k0, n_tiles);
  } else {
    dkv_consume<DH, DV, true>(smem, bars, p, b, h, bh, k0, n_tiles);
  }
}

// ---------------------------------------------------------------------------
// dQ: warpgroup c owns query rows [q0 + 64 c, + 64) and all DH columns.
// Fixed panels: Q (NC), dO (NC); ring: K, V.
// ---------------------------------------------------------------------------
template <int DH, int NC>
__global__ void __launch_bounds__(128 * (NC + 1), 1)
flash_bwd_dq_kernel_wgmma(const __grid_constant__ CUtensorMap mq,
                          const __grid_constant__ CUtensorMap mk,
                          const __grid_constant__ CUtensorMap mv,
                          const __grid_constant__ CUtensorMap mdo,
                          const Params p) {
  using L = Layout<DH, NC>;
  using P = Panel<DH>;
  extern __shared__ char smem_raw[];
  char* smem = aligned_smem(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBarOffset);
  const TileOf at =
      unfold((p.Tq + kPanelRows * NC - 1) / (kPanelRows * NC));
  const int bh = at.pair;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = at.tile * kPanelRows * NC;
  const int n_tiles = (p.Tk + kTile - 1) / kTile;
  init_barriers(bars, L::kStages, NC, 1);

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    if (threadIdx.x < 32)
      produce<DH, NC, false>(smem, bars, &mq, &mdo, &mk, &mv, q0, n_tiles,
                             h, b, p, bh);
  } else {
    const int c = wg - 1;
    const int lane = threadIdx.x & 31;
    const int w = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, t = lane & 3;
    const int row0 = q0 + c * kPanelRows + 16 * w + g;  // and row0 + 8
    const uint32_t q_addr = smem_u32(smem + c * P::kBytes);
    const uint32_t do_addr = smem_u32(smem + (NC + c) * P::kBytes);
    const long long base = (long long)bh * p.Tq;
    const float lse0 = row0 < p.Tq ? p.lse[base + row0] * kLog2e : 0.f;
    const float lse1 = row0 + 8 < p.Tq ? p.lse[base + row0 + 8] * kLog2e : 0.f;
    const float dl0 = row0 < p.Tq ? p.delta[base + row0] : 0.f;
    const float dl1 = row0 + 8 < p.Tq ? p.delta[base + row0 + 8] : 0.f;
    const float inv_keep = 1.f / p.keep;
    HashRow hr0 = {0u, 0u}, hr1 = {0u, 0u};
    if (p.drop.on) {
      hr0 = hash_row(p.drop, bh, row0);
      hr1 = hash_row(p.drop, bh, row0 + 8);
    }

    float dq[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) dq[i] = 0.f;

    mbar_wait(bars, 0);
    uint64_t* full = bars + 1;
    uint64_t* empty = bars + 1 + L::kStages;
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % L::kStages;
      mbar_wait(&full[s], (j / L::kStages) & 1);
      const uint32_t k_addr = smem_u32(smem + L::kFixed + s * L::kStage);
      const uint32_t v_addr = k_addr + P::kBytes;

      float sc[32], dp[32];
      wgmma_fence();
      product_ss<DH>(sc, q_addr, k_addr);
      product_ss<DH>(dp, do_addr, v_addr);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);

      // Register 4n + 2hh + e: row row0 + 8 hh, key k0 + 8n + 2t + e; a
      // 64-key tile lies in one Pallas key tile (hk a multiple of 128).
      const int k0 = j * kTile;
      const unsigned ktile =
          static_cast<unsigned>(k0 / p.drop.hk) * 0x27D4EB2Fu;
      const int kbase = k0 % p.drop.hk;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int off = 8 * n + 2 * t + e;
          const bool valid = k0 + off < p.Tk;
          const HashCol hc = {static_cast<unsigned>(kbase + off) * 0x61C88647u,
                              ktile};
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int i = 4 * n + 2 * hh + e;
            const float pr =
                valid ? exp2f(sc[i] * p.scale_log2 - (hh ? lse1 : lse0)) : 0.f;
            float d = dp[i];
            if (p.drop.on)
              d = hash_keep(p.drop, hh ? hr1 : hr0, hc) ? d * inv_keep : 0.f;
            sc[i] = pr * (d - (hh ? dl1 : dl0)) * p.scale;
          }
        }
      }

      // dQ += bf16(dS) K over the tile's 64 keys.
      unsigned a[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) acc_as_a(sc, kk, a[kk]);
      wgmma_fence();
      product_rs<DH, DH>(dq, a, k_addr, 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    store_acc<DH>(dq, p.dq + b * p.sdq[0] + h * p.sdq[1], p.sdq[2], row0,
                  p.Tq, t);
  }
}

struct Maps {
  CUtensorMap q, k, v, dout;
};

template <int DH, int DV>
cudaError_t launch_dkv(const Maps& m, const Params& p, long long bh,
                       int device, cudaStream_t stream) {
  using L = Layout<DH, 1, true>;
  static unsigned done = 0;
  cudaError_t err = set_smem_once(flash_bwd_dkv_kernel_wgmma<DH, DV>,
                                  L::kBytes, device, &done);
  if (err != cudaSuccess) return err;
  const dim3 grid =
      folded_grid((p.Tk + kPanelRows - 1) / kPanelRows, bh, 1, DH / DV);
  flash_bwd_dkv_kernel_wgmma<DH, DV>
      <<<grid, 384, L::kBytes, stream>>>(m.q, m.k, m.v, m.dout, p);
  return cudaGetLastError();
}

template <int DH, int NC>
cudaError_t launch_dq(const Maps& m, const Params& p, long long bh,
                      int device, cudaStream_t stream) {
  using L = Layout<DH, NC>;
  static unsigned done = 0;
  cudaError_t err = set_smem_once(flash_bwd_dq_kernel_wgmma<DH, NC>,
                                  L::kBytes, device, &done);
  if (err != cudaSuccess) return err;
  const dim3 grid =
      folded_grid((p.Tq + kPanelRows * NC - 1) / (kPanelRows * NC), bh);
  flash_bwd_dq_kernel_wgmma<DH, NC>
      <<<grid, L::kThreads, L::kBytes, stream>>>(m.q, m.k, m.v, m.dout, p);
  return cudaGetLastError();
}

// dK/dV: blocks of 64 keys, one consumer warpgroup for dV and one for dK
// (at dh 256 for one of two groups of 128 output columns).  dQ: two
// consumer warpgroups of 64 rows (168 registers a thread), or one where
// 64-row blocks give each block an SM of its own (T 1024 at B2 H4) and at
// dh 256 (its 128 dQ accumulators take ~230 registers).
template <int DH>
cudaError_t launch(const Maps& m, const Params& p, int B, int device,
                   cudaStream_t stream) {
  const long long bh = (long long)B * p.H;
  const dim3 grid = folded_grid(
      (p.Tq + kDeltaThreads / 32 - 1) / (kDeltaThreads / 32), bh);
  flash_bwd_delta_kernel<DH><<<grid, kDeltaThreads, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch_dkv<DH, DH == 256 ? 128 : DH>(m, p, bh, device, stream);
  if (err != cudaSuccess) return err;
  if constexpr (DH == 256) {
    return launch_dq<DH, 1>(m, p, bh, device, stream);
  } else {
    const long long blocks1 =
        (long long)((p.Tq + kPanelRows - 1) / kPanelRows) * bh;
    return blocks1 <= sm_count(device)
               ? launch_dq<DH, 1>(m, p, bh, device, stream)
               : launch_dq<DH, 2>(m, p, bh, device, stream);
  }
}

}  // namespace

// q, k, v, o, dO and dQ, dK, dV bf16 with (batch, head, time) strides in
// elements (3 each, in that order); lse and delta float32 (B, H, Tq).
extern "C" int avsep_flash_bwd_wgmma(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int H, int Tq, int Tk, int dh,
    const long long* strides, float scale, float keep, unsigned threshold,
    unsigned seed, int hq, int hk, int dropout, int device, void* stream) {
  const DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long* sq = strides;
  const long long* sk = strides + 3;
  const long long* sv = strides + 6;
  Maps m;
  if (!encode_map(&m.q, q, dh, H, Tq, B, sq[1], sq[2], sq[0]) ||
      !encode_map(&m.k, k, dh, H, Tk, B, sk[1], sk[2], sk[0]) ||
      !encode_map(&m.v, v, dh, H, Tk, B, sv[1], sv[2], sv[0]) ||
      !encode_map(&m.dout, dout, dh, H, Tq, B, strides[13], strides[14],
                  strides[12]))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.o = static_cast<const bf16*>(o);
  p.dout = static_cast<const bf16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.dq = static_cast<bf16*>(dq);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.H = H; p.Tq = Tq; p.Tk = Tk;
  long long* dst[5] = {p.so, p.sdo, p.sdq, p.sdk, p.sdv};
  for (int i = 0; i < 5; ++i)
    for (int j = 0; j < 3; ++j) dst[i][j] = strides[9 + 3 * i + j];
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  p.keep = keep;
  p.drop.seed = seed;
  p.drop.threshold = threshold;
  p.drop.hq = hq;
  p.drop.hk = hk;
  p.drop.on = dropout;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32: return static_cast<int>(launch<32>(m, p, B, device, s));
    case 64: return static_cast<int>(launch<64>(m, p, B, device, s));
    case 128: return static_cast<int>(launch<128>(m, p, B, device, s));
    case 256: return static_cast<int>(launch<256>(m, p, B, device, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* avsep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
