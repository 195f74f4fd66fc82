// Float32 products on the tensor cores in 3xTF32, and the cp.async copies
// that feed them: shared by the flash-attention forward and backward
// kernels (flash_attn_fwd.cu, flash_attn_bwd.cu), the audio projection
// (audio_proj.cu) and the mask decoder (mask_decoder.cu) on Hopper
// (sm_90a); the STFT's FFT (stft_fft.cu) takes the copies.
//
// The m16n8k8 TF32 fragments (lane = 4g + t): A (16 x 8, row-major) holds
// (g, t), (g+8, t), (g, t+4), (g+8, t+4); B (8 x 8, k x n) holds (k=t, n=g),
// (k=t+4, n=g); C (16 x 8) holds (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1).
#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x = big + small for 3xTF32: big keeps the top 10 mantissa bits (the mask
// truncates; the low 13 bits of a TF32 operand register are zero), small
// = x - big is exact in float32, and the tensor core reads its top 10
// mantissa bits.  What is lost, x's bits below 2^-20 |x| and the
// small * small term, is ~2^-20 relative, against 2^-11 for 1xTF32.  Two
// ALU instructions: the splits outnumber the products, and two
// cvt.rna.tf32.f32 conversions a split made the whole kernel slower.
__device__ __forceinline__ void split(float x, unsigned& big,
                                      unsigned& small) {
  big = __float_as_uint(x) & 0xFFFFE000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a * b in 3xTF32: the small terms first, then big * big.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const unsigned (&ab)[4],
                                           const unsigned (&as)[4],
                                           const unsigned (&bb)[2],
                                           const unsigned (&bs)[2]) {
  mma_tf32(d, as, bb);
  mma_tf32(d, ab, bs);
  mma_tf32(d, ab, bb);
}

// The 3xTF32 A fragment of rows [0, 16) and columns [0, 8) of a row-major
// tile at `a` with a row stride of `stride` floats.
__device__ __forceinline__ void load_a_frag(const float* a, int stride, int g,
                                            int t, unsigned (&ab)[4],
                                            unsigned (&as)[4]) {
  const float* p = a + g * stride + t;
  split(p[0], ab[0], as[0]);
  split(p[8 * stride], ab[1], as[1]);
  split(p[4], ab[2], as[2]);
  split(p[8 * stride + 4], ab[3], as[3]);
}

// Copy rows [r0, r0 + ROWS) of a (time, dh) slice into a tile at row stride
// DH + 4 with THREADS threads; rows at or past `n_valid` are zero-filled.
template <int DH, int ROWS, int THREADS>
__device__ __forceinline__ void load_rows(float* tile, const float* base,
                                          long long stride, int r0,
                                          int n_valid, int tid) {
  constexpr int kChunks = DH / 4;
#pragma unroll
  for (int i = tid; i < ROWS * kChunks; i += THREADS) {
    const int r = i / kChunks, c = (i % kChunks) * 4;
    const bool ok = r0 + r < n_valid;
    const float* src = ok ? base + (long long)(r0 + r) * stride + c : base;
    cp_async16(tile + r * (DH + 4) + c, src, ok ? 16 : 0);
  }
}

}  // namespace
