// Hopper building blocks of the bfloat16 flash-attention kernels
// (flash_fwd_wgmma.cu, flash_bwd_wgmma.cu) and the audio projection
// (audio_proj.cu), sm_90a only: TMA tile loads
// into a 128- or 64-byte swizzled shared-memory layout, mbarriers, and
// warpgroup products (`wgmma.mma_async`) on bf16 operands with float32
// accumulators.
//
// Tiles.  Every operand tile is a "panel" of 64 rows (query rows or keys)
// by DH columns, stored as DH / CW column chunks of CW = min(DH, 64)
// columns: chunk c holds columns [c CW, (c + 1) CW) of all 64 rows, one row
// every RB = 2 CW bytes (128 or 64), as one TMA box lands it with the
// matching swizzle (CU_TENSOR_MAP_SWIZZLE_128B or _64B).  The swizzle XORs
// the 16-byte unit of an address (bits 4-6) with bits 7-9: element (r, c)
// of a chunk lies at byte r RB + ((2 c / 16) ^ ((r RB / 128) % 8)) 16 +
// 2 c % 16 (the 64-byte swizzle XORs two bits).  Chunks are 1024-byte
// aligned, so the pattern is the same from every chunk's start.
//
// Descriptors (the PTX ISA's matrix descriptor: start address, leading
// and stride byte offsets in 16-byte units, layout type 1 = 128-byte
// swizzle, 2 = 64-byte):
// - K-major (the product's k runs along the row: Q and K of Q K^T, K and
//   Q of K Q^T, ...): SBO = 8 RB (the next eight rows), LBO unused (1);
//   k step kk (16 columns, 32 bytes) starts at chunk kk*16 / CW, byte
//   (kk*16 % CW) * 2 of its first row.
// - MN-major (k runs down the rows: V of P V, dO of Pd^T dO, Q of dS^T Q,
//   K of dS K; the transpose bit set): SBO = 8 RB (the next eight k rows),
//   LBO = 64 RB (the next chunk of CW columns); k step kk starts at row
//   16 kk of the chunk that holds the product's first column.
//
// Fragments (lane = 4g + t, warp w of the warpgroup): the m64nNk16
// accumulator's register 4n + 2h + e holds row 16w + g + 8h, column
// 8n + 2t + e; the A operand from registers holds (row 16w + g + 8h,
// column 2t + 8j + e) in register 2j + h, half e.  So accumulator chunks
// 2j and 2j + 1 (16 columns) are the A fragment of a k16 product over
// those columns as they stand (`acc_as_a`): P into P V, Pd^T into dV, dS
// into dQ and dK, with no shuffle.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kPanelRows = 64;  // rows of a panel: one warpgroup's m64

template <int DH>
struct Panel {
  static constexpr int kCW = DH < 64 ? DH : 64;        // columns a chunk
  static constexpr int kRB = 2 * kCW;                  // bytes a row
  static constexpr int kChunks = DH / kCW;
  static constexpr int kChunkBytes = kPanelRows * kRB;
  static constexpr int kBytes = kChunks * kChunkBytes;  // 128 DH
  static constexpr int kLayout = kRB == 128 ? 1 : 2;    // descriptor type
  static_assert(DH % 32 == 0 && (kRB == 128 || kRB == 64), "head dim");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -------------------------------------------------------------------------
// mbarriers
// -------------------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Spin until the barrier's phase of parity `parity` has completed.  A
// phase that never completes (a byte count that does not match the copies)
// traps after ~2^26 polls instead of hanging the card.
__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar,
                                              unsigned parity) {
  unsigned ok;
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.b32 %0, 1, 0, P1;\n"
      "}\n"
      : "=r"(ok)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return ok != 0;
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  for (unsigned i = 0; !mbar_try_wait(bar, parity); ++i)
    if (i == (1u << 26)) __trap();
}

// -------------------------------------------------------------------------
// TMA: one box of a 4-D (dh, H, T, B) map into shared memory, completing
// on `bar`; rows at or past T arrive as zeros (and count as bytes).
// -------------------------------------------------------------------------
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

// One box of a 3-D map, as tma_load_4d.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_prefetch_desc(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// A 64-row panel of DH columns, rows [row0, row0 + 64) of (b, h): one box
// a chunk.
template <int DH>
__device__ __forceinline__ void tma_panel(char* dst, const CUtensorMap* map,
                                          uint64_t* bar, int col0, int h,
                                          int row0, int b) {
  using P = Panel<DH>;
  for (int c = 0; c < P::kChunks; ++c)
    tma_load_4d(dst + c * P::kChunkBytes, map, bar, col0 + c * P::kCW, h,
                row0, b);
}

// -------------------------------------------------------------------------
// Descriptors
// -------------------------------------------------------------------------
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint32_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

// K-major operand: k step kk of a panel at shared address `panel`.
template <int DH>
__device__ __forceinline__ uint64_t desc_k(uint32_t panel, int kk) {
  using P = Panel<DH>;
  const int col = kk * 16;
  const uint32_t addr =
      panel + (col / P::kCW) * P::kChunkBytes + (col % P::kCW) * 2;
  return make_desc(addr, 16, 8 * P::kRB, P::kLayout);
}

// MN-major operand: k rows [16 kk, 16 kk + 16), columns from chunk `chunk`.
template <int DH>
__device__ __forceinline__ uint64_t desc_mn(uint32_t panel, int kk,
                                            int chunk) {
  using P = Panel<DH>;
  const uint32_t addr = panel + chunk * P::kChunkBytes + kk * 16 * P::kRB;
  return make_desc(addr, P::kChunkBytes, 8 * P::kRB, P::kLayout);
}

// -------------------------------------------------------------------------
// Warpgroup products
// -------------------------------------------------------------------------
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads or writes across an
// asynchronous product.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define AVSEP_R8(i)                                                      \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// D (64 x 64) (+)= A B, A and B K-major from shared memory.
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t a,
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : AVSEP_R8(0), AVSEP_R8(8), AVSEP_R8(16), AVSEP_R8(24)
      : "l"(a), "l"(b), "r"(accumulate));
}

// D (64 x 64) += A B, A from registers, B MN-major from shared memory.
__device__ __forceinline__ void wgmma_rs64(float (&d)[32],
                                           const unsigned (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : AVSEP_R8(0), AVSEP_R8(8), AVSEP_R8(16), AVSEP_R8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D (64 x 32) += A B, A from registers, B MN-major (head dim 32).
__device__ __forceinline__ void wgmma_rs32(float (&d)[16],
                                           const unsigned (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
      "}\n"
      : AVSEP_R8(0), AVSEP_R8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef AVSEP_R8

// S (+)= A B^T over DH: A and B K-major panels (64 rows each).
template <int DH>
__device__ __forceinline__ void product_ss(float (&s)[32], uint32_t a,
                                           uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    wgmma_ss64(s, desc_k<DH>(a, kk), desc_k<DH>(b, kk), kk > 0);
}

// Two float32 values rounded to nearest-even bf16, lo in the low half.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Accumulator chunks 2j, 2j + 1 (of a 64-column accumulator), rounded to
// bf16, as the A fragment of a k16 product over their 16 columns.
__device__ __forceinline__ void acc_as_a(const float (&s)[32], int j,
                                         unsigned (&a)[4]) {
  a[0] = pack_bf16(s[8 * j + 0], s[8 * j + 1]);
  a[1] = pack_bf16(s[8 * j + 2], s[8 * j + 3]);
  a[2] = pack_bf16(s[8 * j + 4], s[8 * j + 5]);
  a[3] = pack_bf16(s[8 * j + 6], s[8 * j + 7]);
}

// ACC (+)= A B over the k16 steps of a 64-row k: A's k16 fragments in
// registers (a[kk]), B an MN-major panel whose columns [col0, col0 + NOUT)
// are ACC's; one n64 (or n32 at head dim 32) product per CW columns.
template <int DH, int NOUT>
__device__ __forceinline__ void product_rs(float (&acc)[NOUT / 2],
                                           const unsigned (&a)[4][4],
                                           uint32_t b, int chunk0) {
  using P = Panel<DH>;
  constexpr int kN = NOUT / P::kCW;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      if constexpr (P::kCW == 64) {
        float(&d)[32] = *reinterpret_cast<float(*)[32]>(acc + 32 * n);
        wgmma_rs64(d, a[kk], desc_mn<DH>(b, kk, chunk0 + n));
      } else {
        float(&d)[16] = *reinterpret_cast<float(*)[16]>(acc + 16 * n);
        wgmma_rs32(d, a[kk], desc_mn<DH>(b, kk, chunk0 + n));
      }
    }
  }
}

}  // namespace

// -------------------------------------------------------------------------
// Host: 4-D tensor maps, encoded by `cuTensorMapEncodeTiled`, looked up
// in libcuda at run time (no -lcuda at link time).
// -------------------------------------------------------------------------
#include <dlfcn.h>

namespace {

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_fn() {
  static EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_LAZY | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_LAZY);
    if (lib == nullptr) return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(
        dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// A (dh, H, T, B) bf16 map with (head, time, batch) strides in elements
// and boxes of CW x 1 x 64 x 1.  Returns false where TMA refuses the
// tensor (base or a stride not a multiple of 16 bytes; the wrapper checks
// these first).
inline bool encode_map(CUtensorMap* map, const void* base, int dh, int H,
                       int T, int B, long long sh, long long st,
                       long long sb) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const int cw = dh < 64 ? dh : 64;
  // A dim of extent 1 is never stepped: give it a legal stride.
  if (H == 1) sh = st;
  if (B == 1) sb = st;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(dh),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(st) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cw), 1, kPanelRows, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
      cw == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS;
}

// A 3-D map of `type` (elements of `esize` bytes): dims (d0, d1, d2), the
// strides of dims 1 and 2 in bytes, boxes of box0 x box1 x 1 (box0 esize
// = 128 bytes) landing in the 128-byte swizzle; out-of-range elements
// (negative coordinates too) arrive as zeros.  False where TMA refuses
// the tensor (base or a stride not a multiple of 16 bytes).
inline bool encode_map_3d(CUtensorMap* map, CUtensorMapDataType type,
                          const void* base, long long d0, long long d1,
                          long long d2, long long s1, long long s2,
                          int box0, int box1) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  if (d2 == 1) s2 = s1 * d1;  // never stepped: a legal stride
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d0),
                              static_cast<cuuint64_t>(d1),
                              static_cast<cuuint64_t>(d2)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(s1),
                                 static_cast<cuuint64_t>(s2)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box0),
                             static_cast<cuuint32_t>(box1), 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r = fn(map, type, 3, const_cast<void*>(base), dims, strides,
                        box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS;
}

// cudaFuncSetAttribute (the dynamic shared memory a block takes) once per
// kernel instance (`done`: one bit a device) and device.
template <typename Kernel>
cudaError_t set_smem_once(Kernel kernel, size_t bytes, int device,
                          unsigned* done) {
  const unsigned bit = 1u << (device & 31);
  if (*done & bit) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess) *done |= bit;
  return err;
}

// The SM count of each device, read once.
inline int sm_count(int device) {
  static int counts[64] = {0};
  if (device < 0 || device >= 64) return 0;
  if (counts[device] == 0)
    cudaDeviceGetAttribute(&counts[device], cudaDevAttrMultiProcessorCount,
                           device);
  return counts[device];
}

}  // namespace
