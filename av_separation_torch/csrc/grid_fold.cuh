// Launch grids that fold a batch index into grid x.  Grid y and z take at
// most 65,535 blocks; x takes 2^31 - 1.  A kernel whose blocks tile rows
// of many (batch, head) pairs -- the flash kernels over B*H -- launches
// `tiles * n` blocks in x, block
// `tile + tiles * i` owning row tile `tile` of pair i.  The tiles of one
// pair stay next to each other in launch order, as they did when the pair
// was grid y, so the L2 reuse of a pair's keys and values is unchanged.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr long long kMaxGridX = 0x7fffffffLL;  // 2^31 - 1

struct TileOf {
  int tile;  // the row tile, in [0, tiles)
  int pair;  // the folded index: b*H + h
};

__device__ __forceinline__ TileOf unfold(int tiles) {
  const unsigned x = blockIdx.x;
  return {static_cast<int>(x % static_cast<unsigned>(tiles)),
          static_cast<int>(x / static_cast<unsigned>(tiles))};
}

// unfold() from a fresh read of the block index.  A kernel at its register
// cap calls it where it needs the tile or the pair late (inside its main
// loop, in its epilogue), so that neither is held in a register meanwhile:
// the compiler keeps a division's result live rather than redo it, where
// it would read blockIdx.y again for free.
__device__ __forceinline__ TileOf unfold_again(int tiles) {
  unsigned x;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(x));
  return {static_cast<int>(x % static_cast<unsigned>(tiles)),
          static_cast<int>(x / static_cast<unsigned>(tiles))};
}

// The grid of `tiles` row tiles of `n` pairs (and `z` column groups); x is
// 0, which the launch refuses (cudaErrorInvalidConfiguration), where
// tiles * n exceeds 2^31 - 1.  The wrappers refuse such shapes first.
inline dim3 folded_grid(int tiles, long long n, int y = 1, int z = 1) {
  const long long x = static_cast<long long>(tiles) * n;
  return dim3(x <= kMaxGridX ? static_cast<unsigned>(x) : 0u, y, z);
}

}  // namespace
