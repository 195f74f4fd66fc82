// Operand fragments of the column chunks a block of a wide-flash cluster
// owns after its first (head dims above 128 kClusterMax; cluster.cuh),
// read straight from global memory: the block's shared memory holds its
// first chunk's tiles only, and it reads each element of another chunk's
// operands a few times a tile, through L1.  Also the bf16 mma.sync
// product, which the wgmma forward takes from here (mma_bf16.cuh, which
// holds the other bf16 helpers, clashes with wgmma_tma.cuh).
//
// Fragment maps (lane = 4g + t): m16n8k8 TF32 (mma_3xtf32.cuh) A (g, t),
// (g + 8, t), (g, t + 4), (g + 8, t + 4), B (k = t, n = g), (k = t + 4,
// n = g); m16n8k16 bf16 (mma_bf16.cuh) A (g, 2t..2t+1), (g + 8, 2t..2t+1),
// (g, 2t+8..2t+9), (g + 8, 2t+8..2t+9), B (k = 2t..2t+1, n = g),
// (k = 2t+8..2t+9, n = g).  The float32 loaders return the values, which
// the caller splits into TF32 parts; the bf16 ones packed pairs.  Rows at
// or past a slice's `n` read as zero, as the tile copies zero-fill them.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Rows [0, n) of a (time, dh) slice at a row stride of `stride` elements.
template <typename T>
struct GlobalRows {
  const T* base;
  long long stride;
  int n;
};

__device__ __forceinline__ float gload(const GlobalRows<float>& m, int r,
                                       int c) {
  return r < m.n ? __ldg(m.base + r * m.stride + c) : 0.f;
}

// Elements c and c + 1 (c even) of row r, c in the low half.
__device__ __forceinline__ unsigned gpair(const GlobalRows<__nv_bfloat16>& m,
                                          int r, int c) {
  return r < m.n ? __ldg(reinterpret_cast<const unsigned*>(m.base +
                                                           r * m.stride + c))
                 : 0u;
}

__device__ __forceinline__ unsigned ghalf(const GlobalRows<__nv_bfloat16>& m,
                                          int r, int c) {
  return r < m.n ? __ldg(reinterpret_cast<const unsigned short*>(
                       m.base + r * m.stride + c))
                 : 0u;
}

// Float32: the A fragment of rows [r0, r0 + 16), columns [c, c + 8).
__device__ __forceinline__ void gfrag_a(const GlobalRows<float>& m, int r0,
                                        int c, int g, int t, float (&a)[4]) {
  a[0] = gload(m, r0 + g, c + t);
  a[1] = gload(m, r0 + g + 8, c + t);
  a[2] = gload(m, r0 + g, c + t + 4);
  a[3] = gload(m, r0 + g + 8, c + t + 4);
}

// Float32: B[k][n] = row n0 + n, column c + k (the rows are B's columns:
// K of Q K^T, Q of K Q^T).
__device__ __forceinline__ void gfrag_b_rows(const GlobalRows<float>& m,
                                             int n0, int c, int g, int t,
                                             float (&b)[2]) {
  b[0] = gload(m, n0 + g, c + t);
  b[1] = gload(m, n0 + g, c + t + 4);
}

// Float32: the B fragment of a product over keys (queries) whose A is a C
// fragment as `c_as_a` takes it: k = t, t + 4 stand for rows k0 + 2t,
// k0 + 2t + 1; n = g is column c + g (V of P V, dO of Pd^T dO, ...).
__device__ __forceinline__ void gfrag_b_cols(const GlobalRows<float>& m,
                                             int k0, int c, int g, int t,
                                             float (&b)[2]) {
  b[0] = gload(m, k0 + 2 * t, c + g);
  b[1] = gload(m, k0 + 2 * t + 1, c + g);
}

// bf16: the A fragment of rows [r0, r0 + 16), columns [c, c + 16).
__device__ __forceinline__ void gfrag_a(const GlobalRows<__nv_bfloat16>& m,
                                        int r0, int c, int g, int t,
                                        unsigned (&a)[4]) {
  a[0] = gpair(m, r0 + g, c + 2 * t);
  a[1] = gpair(m, r0 + g + 8, c + 2 * t);
  a[2] = gpair(m, r0 + g, c + 2 * t + 8);
  a[3] = gpair(m, r0 + g + 8, c + 2 * t + 8);
}

// bf16: B[k][n] = row n0 + n, column c + k.
__device__ __forceinline__ void gfrag_b_rows(
    const GlobalRows<__nv_bfloat16>& m, int n0, int c, int g, int t,
    unsigned (&b)[2]) {
  b[0] = gpair(m, n0 + g, c + 2 * t);
  b[1] = gpair(m, n0 + g, c + 2 * t + 8);
}

// bf16: B[k][n] = row k0 + k, column c + n: two 16-bit loads a register.
__device__ __forceinline__ void gfrag_b_cols(
    const GlobalRows<__nv_bfloat16>& m, int k0, int c, int g, int t,
    unsigned (&b)[2]) {
  b[0] = ghalf(m, k0 + 2 * t, c + g) | (ghalf(m, k0 + 2 * t + 1, c + g) << 16);
  b[1] = ghalf(m, k0 + 2 * t + 8, c + g) |
         (ghalf(m, k0 + 2 * t + 9, c + g) << 16);
}

}  // namespace
