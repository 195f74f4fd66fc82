// bfloat16 products on the tensor cores (mma.sync.m16n8k16, bf16 operands,
// float32 accumulators) and the tile copies of the flash-attention kernels
// (flash_attn_fwd.cu, flash_attn_bwd.cu) on Hopper (sm_90a).
//
// The m16n8k16 bf16 fragments (lane = 4g + t), each register two bf16, the
// lower column (A) or k (B) in the low half: A (16 x 16, row-major) holds
// (g, 2t..2t+1), (g+8, 2t..2t+1), (g, 2t+8..2t+9), (g+8, 2t+8..2t+9);
// B (16 x 8, k x n) holds (k=2t..2t+1, n=g), (k=2t+8..2t+9, n=g); C is the
// m16n8k8 C: (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1).  So two C
// fragments of 8 columns each are the A fragment of a k16 product over
// their 16 columns, in order, with no shuffle (`c_pair_as_a`).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "chunk_frags.cuh"  // mma_bf16
#include "mma_3xtf32.cuh"  // cp_async16

namespace {

using bf16 = __nv_bfloat16;

// Two floats rounded to nearest-even bf16 (the JAX `astype`), lo in the
// low half.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// The A fragment of rows [0, 16) and columns [c, c + 16) of a row-major
// bf16 tile at a row stride of S elements.
template <int S>
__device__ __forceinline__ void load_a_bf16(const bf16* tile, int c, int g,
                                            int t, unsigned (&a)[4]) {
  const bf16* p = tile + g * S + c + 2 * t;
  a[0] = *reinterpret_cast<const unsigned*>(p);
  a[1] = *reinterpret_cast<const unsigned*>(p + 8 * S);
  a[2] = *reinterpret_cast<const unsigned*>(p + 8);
  a[3] = *reinterpret_cast<const unsigned*>(p + 8 * S + 8);
}

// The B fragment B[k][n] = tile[n0 + n][c + k]: the tile's rows are B's
// columns (K of Q K^T, Q of K Q^T).
template <int S>
__device__ __forceinline__ void load_b_rows(const bf16* tile, int n0, int c,
                                            int g, int t, unsigned (&b)[2]) {
  const bf16* p = tile + (n0 + g) * S + c + 2 * t;
  b[0] = *reinterpret_cast<const unsigned*>(p);
  b[1] = *reinterpret_cast<const unsigned*>(p + 8);
}

// The B fragment B[k][n] = tile[k0 + k][c + n]: the tile's rows are B's
// rows (V of P V, dO of Pd^T dO, K of dS K): two 16-bit loads a register.
template <int S>
__device__ __forceinline__ void load_b_cols(const bf16* tile, int k0, int c,
                                            int g, int t, unsigned (&b)[2]) {
  const unsigned short* p = reinterpret_cast<const unsigned short*>(tile) +
                            (k0 + 2 * t) * S + c + g;
  b[0] = p[0] | (static_cast<unsigned>(p[S]) << 16);
  b[1] = p[8 * S] | (static_cast<unsigned>(p[9 * S]) << 16);
}

// Two C fragments (columns 0-7 and 8-15), rounded to bf16, as the A
// fragment of a k16 product over those 16 columns.
__device__ __forceinline__ void c_pair_as_a(const float (&c0)[4],
                                            const float (&c1)[4],
                                            unsigned (&a)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

// Two accumulators into a tile of T at `dst` (8-byte or 4-byte aligned).
__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

// Copy W columns of rows [r0, r0 + ROWS) of a (time, columns) slice of T
// into a tile at row stride S with THREADS threads, as 16-byte cp.async
// copies; rows at or past `n_valid` are zero-filled.
template <typename T, int W, int S, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(T* tile, const T* base,
                                          long long stride, int r0,
                                          int n_valid, int tid) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = W / kVec;
#pragma unroll
  for (int i = tid; i < ROWS * kChunks; i += THREADS) {
    const int r = i / kChunks, c = (i % kChunks) * kVec;
    const bool ok = r0 + r < n_valid;
    const T* src = ok ? base + (long long)(r0 + r) * stride + c : base;
    cp_async16(tile + r * S + c, src, ok ? 16 : 0);
  }
}

}  // namespace
