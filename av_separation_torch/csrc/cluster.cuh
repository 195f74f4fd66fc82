// Thread-block clusters on Hopper (sm_90a), for the flash kernels above head
// dim 256 (flash_attn_fwd.cu, flash_fwd_wgmma.cu, flash_attn_bwd.cu): the
// block's rank in its cluster, the cluster-wide barrier, loads from another
// block's shared memory (distributed shared memory), the two forms of the
// partials' exchange, and the launch.  Also the exchange between two warps
// of one block that the float32 kernels at head dim 256 use instead.
//
// The wide flash kernels split the head dim into nc = dh / 128 column
// chunks and launch a cluster of C = cluster_blocks(nc) blocks along grid
// z (cluster dims (1, 1, C)); block r (its rank, blockIdx.z) owns chunks
// r, r + C, r + 2 C, ... below nc: one each up to nc = kClusterMax, and
// ceil(nc / kClusterMax) above (`chunks_per_block`), whose accumulators
// after the first (in dK/dV all) live in a scratch buffer (`acc_place`)
// and whose operands it reads from global memory (chunk_frags.cuh).  Each block
// sums its partial q k^T (and dO v^T) over its own chunks, in chunk order,
// into its shared memory; after a cluster barrier the partials are summed
// in rank order, so every block of a cluster holds the same sum, bit for
// bit, and runs the same softmax:
// - `cluster_sum` (the float32 forward, the backward): every block sums
//   all C partials (its own from its shared memory, the others' from the
//   cluster's).
// - `reduce_slots` / `gather_slots` (the bf16 forward): of a thread's 8
//   float4 of partials, slot i is summed by block i % C alone, and every
//   block gathers the 8 sums after the next barrier; the loads from other
//   blocks fall from 8 (C - 1) to about 16 (C - 1) / C a thread.  (In
//   the backward, with a second barrier a tile, it measured slower: the
//   float32 dK/dV kernel spilled.)
// Loads from another block's shared memory cost a round trip of ~0.5 us
// under load on the H100 (tools/torch_flash_rows.py --probe), so
// `reduce_slots` issues the loads of four blocks before it sums them.
#pragma once

#include <cuda_runtime.h>

namespace {

// A cluster of more than 8 blocks needs the non-portable attribute
// (`launch_cluster` sets it); the H100 takes up to 16.
constexpr int kClusterMax = 16;

// The chunks a block owns at most, and the blocks of a cluster, for nc
// column chunks: block r owns chunks r + i C (i < chunks_per_block, below
// nc), so no two blocks' counts differ by more than one.
__host__ __device__ constexpr int chunks_per_block(int nc) {
  return (nc + kClusterMax - 1) / kClusterMax;
}
__host__ __device__ constexpr int cluster_blocks(int nc) {
  return (nc + chunks_per_block(nc) - 1) / chunks_per_block(nc);
}

// Float4 q (of N) of a thread's accumulators in place `place` (of
// `places`) of its block in the scratch buffer: the block's (linear over
// grid x and z) places follow each other, N float4 each, and float4 q of
// a place is one float4 a thread, so a warp's loads and stores are
// coalesced.  Index it [q * blockDim.x].
__device__ __forceinline__ float4* acc_place(float* scratch, int place,
                                             int places, int n) {
  const long long block = (long long)blockIdx.x * gridDim.z + blockIdx.z;
  return reinterpret_cast<float4*>(scratch) +
         ((block * places + place) * n) * blockDim.x + threadIdx.x;
}

// The place of the chunk a block owns in place i >= 1 where its first
// chunk's accumulators stay in registers (the forwards, dQ).
__device__ __forceinline__ float4* extra_acc(float* scratch, int i,
                                             int chunks, int n) {
  return acc_place(scratch, i - 1, chunks - 1, n);
}

// Bytes of that scratch buffer for `blocks` blocks of a cluster grid's
// rows (grid x), `places` a block, `threads` a block, N float4 a place; 0
// up to kClusterMax chunks.
inline long long acc_places_bytes(long long blocks, int nc, int places,
                                  int threads, int n) {
  if (nc <= kClusterMax) return 0;
  return blocks * cluster_blocks(nc) * places * n * threads * 16LL;
}

inline long long extra_acc_bytes(long long blocks, int nc, int threads,
                                 int n) {
  return acc_places_bytes(blocks, nc, chunks_per_block(nc) - 1, threads, n);
}

__device__ __forceinline__ void load4(float (&d)[4], const float4* p) {
  const float4 v = *p;
  d[0] = v.x;
  d[1] = v.y;
  d[2] = v.z;
  d[3] = v.w;
}

__device__ __forceinline__ void store4(float4* p, const float (&d)[4]) {
  *p = make_float4(d[0], d[1], d[2], d[3]);
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every block of the cluster arrives, then waits for all:
// shared-memory writes before it (of any block) are seen by reads after it
// (release / acquire at cluster scope).  A block-wide barrier too.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;\n" ::
          : "memory");
}

// The shared::cluster address of `p` (this block's shared memory) in the
// block of rank `rank`.
__device__ __forceinline__ unsigned dsmem_addr(const void* p, unsigned rank) {
  unsigned a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a)
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))),
                 "r"(rank));
  return a;
}

__device__ __forceinline__ float4 ld_dsmem4(unsigned addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// A thread's N float4 partials into this block's exchange buffer `x`:
// partial i (d[4i .. 4i + 3]) at float4 index i * stride + off.
template <int N>
__device__ __forceinline__ void put_partials(float* x, const float* d,
                                             int stride, int off) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    reinterpret_cast<float4*>(x)[i * stride + off] =
        make_float4(d[4 * i], d[4 * i + 1], d[4 * i + 2], d[4 * i + 3]);
}

// Head dim 256 (flash_attn_fwd.cu, flash_attn_bwd.cu `*_pair`): no
// cluster, but warps w and w + 4 of one 8-warp block, each owning one
// 128-column half of the same 16 rows, exchange their partials through
// the block's shared memory.  Each stores its own (`put_partials`), the
// two meet at named barrier 1 + w of 64 threads (barrier 0 is
// __syncthreads), and each adds the other's (`pair_sum`).
__device__ __forceinline__ void pair_sync(int w) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + w) : "memory");
}

// d[0 .. 4N) += the partner's N float4 partials, put at float4
// i * stride + off of its buffer x: S_0 + S_1 in both warps, the same
// float (a sum of two floats does not depend on their order).
template <int N>
__device__ __forceinline__ void pair_sum(float* d, const float* x,
                                         int stride, int off) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float4 v = reinterpret_cast<const float4*>(x)[i * stride + off];
    d[4 * i] += v.x;
    d[4 * i + 1] += v.y;
    d[4 * i + 2] += v.z;
    d[4 * i + 3] += v.w;
  }
}

// Float4 `i * stride + off` of buffer `x` in the block of rank `from`:
// from this block's shared memory if `from` is this block (`rank`), else
// from the cluster's.
__device__ __forceinline__ float4 load_from(const float* x, int idx,
                                           unsigned from, unsigned rank) {
  return from == rank ? reinterpret_cast<const float4*>(x)[idx]
                      : ld_dsmem4(dsmem_addr(x, from) + 16u * idx);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// The sum over the cluster's `blocks` blocks, in rank order, of the partials
// that `put_partials` wrote at the same place of each block's `x`, into
// d[0 .. 4N).  Rank 0's partial is the first term, so the sum is the same
// float in every block.
template <int N>
__device__ __forceinline__ void cluster_sum(float* d, const float* x,
                                            int stride, int off, int blocks,
                                            unsigned rank) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float4 v = load_from(x, i * stride + off, 0, rank);
    d[4 * i] = v.x;
    d[4 * i + 1] = v.y;
    d[4 * i + 2] = v.z;
    d[4 * i + 3] = v.w;
  }
  for (int c = 1; c < blocks; ++c) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float4 v = load_from(x, i * stride + off, c, rank);
      d[4 * i] += v.x;
      d[4 * i + 1] += v.y;
      d[4 * i + 2] += v.z;
      d[4 * i + 3] += v.w;
    }
  }
}

// Reduce-scatter by slot: of a thread's N float4 partials, slot i is
// summed (in rank order, over the `blocks` >= 3 blocks' `part`) by block
// i % blocks alone, which writes the sum at the same place of its `total`
// (which may be `part`: no other block reads a block's own slots).  A
// block takes at most (N + 2) / 3 slots; the partials of four blocks are
// loaded at once.
template <int N>
__device__ __forceinline__ void reduce_slots(float* total, const float* part,
                                             int stride, int off, int blocks,
                                             unsigned rank) {
  constexpr int kMine = (N + 2) / 3;
  float4 acc[kMine];
  for (int c0 = 0; c0 < blocks; c0 += 4) {
    float4 v[4][kMine];
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int m = 0; m < kMine; ++m) {
        const int i = rank + m * blocks;
        if (c0 + k < blocks && i < N)
          v[k][m] = load_from(part, i * stride + off, c0 + k, rank);
      }
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int m = 0; m < kMine; ++m) {
        const int i = rank + m * blocks;
        if (c0 + k < blocks && i < N)
          acc[m] = c0 + k == 0 ? v[k][m] : add4(acc[m], v[k][m]);
      }
  }
#pragma unroll
  for (int m = 0; m < kMine; ++m) {
    const int i = rank + m * blocks;
    if (i < N) reinterpret_cast<float4*>(total)[i * stride + off] = acc[m];
  }
}

// The other half: slots [first, first + N) of the sums, each from the
// block that took it, into d[0 .. 4N).
template <int N>
__device__ __forceinline__ void gather_slots(float* d, const float* total,
                                             int stride, int off, int first,
                                             int blocks, unsigned rank) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float4 v =
        load_from(total, i * stride + off, (first + i) % blocks, rank);
    d[4 * i] = v.x;
    d[4 * i + 1] = v.y;
    d[4 * i + 2] = v.z;
    d[4 * i + 3] = v.w;
  }
}

// Launches `kernel` on `grid` (z = the cluster size) as clusters of
// (1, 1, grid.z) blocks; sets the kernel's shared-memory size and the
// non-portable cluster attribute once per device (`done`: one bit a
// device).  A grid whose cluster size exceeds kClusterMax is refused.
template <typename... Exp, typename... Act>
cudaError_t launch_cluster(void (*kernel)(Exp...), dim3 grid, int threads,
                           size_t smem, cudaStream_t stream, unsigned* done,
                           Act&&... args) {
  if (grid.z < 1 || grid.z > static_cast<unsigned>(kClusterMax))
    return cudaErrorInvalidValue;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const unsigned bit = 1u << (device & 31);
  if (!(*done & bit)) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    *done |= bit;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = grid.z;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<Act&&>(args)...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace
