// Audio input projection forward for Hopper (sm_90a), at a float32 or a
// bfloat16 input: warpgroup products (`wgmma`) on tiles that TMA brings
// into shared-memory rings guarded by mbarriers.
//
// Replaces: av_separation_tpu/ops/pallas/audio_proj.py `_proj_kernel`
// (audio_proj.py:32-58, :75): x cast up to float32, float32 weights and
// biases,
//     h[t] = relu(b1 + sum_tap x[t + tap - 1] @ W1[tap])  for t in [0, T),
//            and h = 0 outside [0, T)                  (audio_proj.py:51-56)
//     y[t] = relu(b2 + sum_tap h[t + tap - 1] @ W2[tap])
// with y and h stored in x's dtype and conv2 reading the float32 h.  x is
// (B, T, F) with any row stride that is a multiple of 16 bytes, W1
// (3, F, D), W2 (3, D, D) (flax layout, tap-major).
//
// Products keep float32 accuracy on bf16 tensor cores.  A float32 value v
// is the exact sum of three bf16 parts, p1 = bf16(v), p2 = bf16(v - p1),
// p3 = bf16(v - p1 - p2) (each rounding keeps 8 of the 24 bits).
// - A bf16 x is exact in bf16, so x W1 = x W1_1 + x W1_2 + x W1_3, three
//   bf16 products summed in float32: exact but for the float32 sums.
// - A float32 operand (a float32 x; the float32 h that conv2 reads) and
//   the weight both in three parts: the six products a_i W_j with
//   i + j <= 4 (1-based) leave out terms below 2^-24 of a W, as 3xTF32
//   leaves out its small x small term.
// So a bf16 conv1 runs 3 bf16 products and every other conv 6: at 989
// TFLOP/s that is 330 and 165 TFLOP/s of float32 work.
//
// Bound on the H100 at the scaled serving shape (B 8, T 501, F 257,
// D 512), by the float32 math at those rates: bf16, conv1 3.16 GFLOP at
// 330 TFLOP/s and conv2 6.31 GFLOP at 165: 48 us, against 15 MB (x, y, h
// in bf16, the float32 weights): 4.5 us; float32, both convs at 165:
// 57 us against 25 MB: 7.5 us.  Bound by operations.
//
// Design:
// - Weights split once a call.  `audio_proj_split_kernel` writes each
//   weight's three bf16 parts, (part, tap, c_in, D), before the convs;
//   the products read them as they stand (no split in an inner loop).
// - Two launches, conv1 then conv2, one kernel.  A bf16 conv1 writes h
//   twice: bf16 (the output, the backward's residual) and float32
//   (conv2's A); both stay in L2 at the scaled shape (8.2 + 4.1 MB).  A
//   float32 conv1 writes the float32 h once.
// - Tiles.  A block owns 128 frames of one utterance (two consumer
//   warpgroups of 64) x BN output channels (128, or 64 where 128-channel
//   blocks would leave half the SMs idle, and at D 64).  The grid is one
//   dimension over (utterance, frame tile, channel slab), slab fastest, so
//   neither B nor D has a 65,535 cap.  A warpgroup with no frame below T
//   exits at once (T 63: one warpgroup does the work).
// - Operands by TMA.  Warpgroup 0 is the producer: one thread starts every
//   copy.  The A operand (x, or the float32 h) comes as 3-D boxes (c_in,
//   T, B) of 130 frames, t0 - 1 .. t0 + 128: TMA zero-fills frames before
//   0 and from T on, so each tap's halo (and conv2's zero padding of h)
//   comes free, and never reads the next utterance's frames; columns
//   from c_in on arrive as zeros too, so x may have padded rows (F 257
//   in rows of 264 bf16 or 260 float32: TMA needs 16-byte strides) and no
//   pad is read.  One A stage holds a 64-channel chunk (one 128-byte box
//   of bf16, two of float32), the weights' stage one (chunk, tap): the
//   three parts' 64 rows x BN columns.  Rings of 2 A and 3-4 weight
//   stages; a stage's `full` barrier completes on the copies' bytes, its
//   `empty` barrier on one arrival of each consumer warp.
// - Products.  m64n64k16 `wgmma` with A from registers and the weight
//   parts as MN-major B operands (the transpose bit; W's (c_in, D) tile is
//   n-contiguous), 128-byte swizzle, the descriptors of wgmma_tma.cuh.
//   Each tap reads A at a row offset: warpgroup c's frame m, tap k is
//   staged row 64 c + m + k, loaded into the k16 A fragments by
//   `ldmatrix` (bf16 x) or by 8-byte loads split into three bf16 parts in
//   registers (float32), the 128-byte swizzle undone in the address.
//   A warpgroup loads a tap's four k16 fragments, issues its products
//   (4 x 3 or 4 x 6, times BN / 64), and waits for them before the next
//   tap; the other warpgroup's products run meanwhile.  (Loading the next
//   half tap's fragments while this half's products run, two fragment
//   buffers and a wait for the products two steps back, measured slower
//   on the H100: bf16 scaled 0.1065 against 0.0832 ms.)
// - Registers.  384 threads a block: ptxas caps a thread at 168.  BN 128
//   holds 64 accumulators and a float32 A's 48 fragment registers a
//   thread.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "wgmma_tma.cuh"
#include "device_guard.cuh"

namespace {

constexpr int kConsumers = 2;                    // warpgroups of 64 frames
constexpr int kBM = kPanelRows * kConsumers;     // frames a block
constexpr int kStaged = kBM + 2;                 // with the two halo frames
constexpr int kBK = 64;                          // input channels a chunk
constexpr int kBox = (kStaged * 128 + 1023) / 1024 * 1024;  // one A box
constexpr int kWChunk = 64 * 128;  // 64 k rows x 64 bf16 channels
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kSmem = 232448;      // a block's shared memory on the H100

// A32: A is float32 (two 32-column boxes a chunk), else bf16.
template <bool A32, int BN>
struct Layout {
  static constexpr int kAStage = (A32 ? 2 : 1) * kBox;
  static constexpr int kABytes = (A32 ? 2 : 1) * kStaged * 128;  // copied
  static constexpr int kPart = BN / 64 * kWChunk;  // one weight part
  static constexpr int kWStage = 3 * kPart;
  static constexpr int kAStages = 2;
  static constexpr int kFit =
      (kSmem - 1024 - 128 - kAStages * kAStage) / kWStage;
  static constexpr int kWStages = kFit < 4 ? kFit : 4;
  static constexpr int kBarOffset = kAStages * kAStage + kWStages * kWStage;
  static constexpr size_t kBytes =
      1024 + kBarOffset + 8 * 2 * (kAStages + kWStages);
  static_assert(kWStages >= 2 && kBytes <= kSmem, "shared memory");
};

struct Params {
  const float* bias;
  float* h32;  // a bf16 conv1: the float32 h it writes (conv2's A)
  void* out;   // conv1: h; conv2: y (float32 or bf16, as x)
  int T, cin, D;
  int tiles, slabs;  // frame tiles an utterance, channel slabs
};

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4],
                                            uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ float2 lds_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ unsigned bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const unsigned*>(&v);
}

// Two float32 values as three bf16 pairs whose sums are exactly them.
__device__ __forceinline__ void split3(float2 v, unsigned& p1, unsigned& p2,
                                       unsigned& p3) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  const float r0 = v.x - __low2float(a), r1 = v.y - __high2float(a);
  const __nv_bfloat162 b = __floats2bfloat162_rn(r0, r1);
  const __nv_bfloat162 c =
      __floats2bfloat162_rn(r0 - __low2float(b), r1 - __high2float(b));
  p1 = bits(a);
  p2 = bits(b);
  p3 = bits(c);
}

// relu that keeps a NaN, as torch.relu and XLA's max do (fmaxf(NaN, 0) is
// 0, which would hide a NaN input from the NaN checks of utils/debug.py).
__device__ __forceinline__ float relu_keep_nan(float v) {
  return v < 0.f ? 0.f : v;
}

// Byte offset of 16-byte unit u of staged row r in a 128-byte-swizzled box.
__device__ __forceinline__ uint32_t swz(int r, int u) {
  return r * 128 + ((u ^ (r & 7)) << 4);
}

// ACC += A B_part over the BN columns: one m64n64k16 product per 64.
template <int BN>
__device__ __forceinline__ void product(float (&acc)[BN / 2],
                                        const unsigned (&a)[4],
                                        uint32_t part, int kk) {
#pragma unroll
  for (int n = 0; n < BN / 64; ++n) {
    float(&d)[32] = *reinterpret_cast<float(*)[32]>(acc + 32 * n);
    wgmma_rs64(d, a, desc_mn<BN>(part, kk, n));
  }
}

// relu(conv3(src, W) + bias) for a block, F32 the dtype of x: conv1
// (src = x) writes h, a bf16 one in bf16 and float32; conv2 (src = the
// float32 h) writes y.
template <bool CONV2, bool F32, int BN>
__global__ void __launch_bounds__(kThreads, 1)
audio_proj_wgmma_kernel(const __grid_constant__ CUtensorMap ma,
                        const __grid_constant__ CUtensorMap mw,
                        const Params p) {
  constexpr bool A32 = CONV2 || F32;
  using L = Layout<A32, BN>;
  extern __shared__ char smem_raw[];
  char* smem = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  char* sA = smem;
  char* sW = smem + L::kAStages * L::kAStage;
  uint64_t* a_full = reinterpret_cast<uint64_t*>(smem + L::kBarOffset);
  uint64_t* a_empty = a_full + L::kAStages;
  uint64_t* w_full = a_empty + L::kAStages;
  uint64_t* w_empty = w_full + L::kWStages;

  const unsigned blk = blockIdx.x;
  const int slab = static_cast<int>(blk % p.slabs);
  const unsigned rest = blk / p.slabs;
  const int b = static_cast<int>(rest / p.tiles);
  const int t0 = static_cast<int>(rest % p.tiles) * kBM;
  const int n0 = slab * BN;
  const int chunks = (p.cin + kBK - 1) / kBK;
  // Consumer warpgroups with a frame below T; the others exit.
  const int rows = p.T - t0;
  const int active = rows >= kBM ? kConsumers : (rows + 63) / 64;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kAStages; ++s) {
      mbar_init(&a_full[s], 1);
      mbar_init(&a_empty[s], 4 * active);
    }
    for (int s = 0; s < L::kWStages; ++s) {
      mbar_init(&w_full[s], 1);
      mbar_init(&w_empty[s], 4 * active);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    if (threadIdx.x != 0) return;
    // Producer: per chunk, the A box(es), then the three taps' weights.
    tma_prefetch_desc(&ma);
    tma_prefetch_desc(&mw);
    for (int c = 0; c < chunks; ++c) {
      const int sa = c % L::kAStages;
      mbar_wait(&a_empty[sa], ((c / L::kAStages) & 1) ^ 1);
      mbar_expect_tx(&a_full[sa], L::kABytes);
      char* dst = sA + sa * L::kAStage;
      if (A32) {
        tma_load_3d(dst, &ma, &a_full[sa], c * kBK, t0 - 1, b);
        tma_load_3d(dst + kBox, &ma, &a_full[sa], c * kBK + 32, t0 - 1, b);
      } else {
        tma_load_3d(dst, &ma, &a_full[sa], c * kBK, t0 - 1, b);
      }
      for (int tap = 0; tap < 3; ++tap) {
        const int j = 3 * c + tap, sw = j % L::kWStages;
        mbar_wait(&w_empty[sw], ((j / L::kWStages) & 1) ^ 1);
        mbar_expect_tx(&w_full[sw], L::kWStage);
        char* wdst = sW + sw * L::kWStage;
        for (int part = 0; part < 3; ++part)
          for (int n = 0; n < BN / 64; ++n)
            tma_load_3d(wdst + part * L::kPart + n * kWChunk, &mw,
                        &w_full[sw], n0 + 64 * n, c * kBK, 3 * part + tap);
      }
    }
    return;
  }
  const int cw = wg - 1;  // frames [t0 + 64 cw, + 64)
  if (cw >= active) return;

  const int lane = threadIdx.x & 31;
  const int w = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  for (int c = 0; c < chunks; ++c) {
    const int sa = c % L::kAStages;
    mbar_wait(&a_full[sa], (c / L::kAStages) & 1);
    const uint32_t a_addr = smem_u32(sA + sa * L::kAStage);
#pragma unroll 1
    for (int tap = 0; tap < 3; ++tap) {
      const int j = 3 * c + tap, sw = j % L::kWStages;
      // This thread's staged rows: frame 64 cw + 16 w + g (+ 8), tap.
      const int r0 = 64 * cw + 16 * w + tap;
      const uint32_t w_addr = smem_u32(sW + sw * L::kWStage);
      if constexpr (A32) {
        // k16 step kk: columns 16 kk .. + 15 of the chunk, in box kk / 2
        // at 16-byte units 4 (kk % 2) + 2 j + t / 2; register 2 j + h
        // holds row g + 8 h, columns 8 j + 2 t, + 1.
        unsigned a1[4][4], a2[4][4], a3[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int j2 = 0; j2 < 2; ++j2)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = r0 + g + 8 * h;
              const uint32_t at = a_addr + (kk >> 1) * kBox +
                                  swz(r, 4 * (kk & 1) + 2 * j2 + (t >> 1)) +
                                  8 * (t & 1);
              split3(lds_f2(at), a1[kk][2 * j2 + h], a2[kk][2 * j2 + h],
                     a3[kk][2 * j2 + h]);
            }
        mbar_wait(&w_full[sw], (j / L::kWStages) & 1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          // A_i W_j for i + j <= 4: the three parts' sums to 2^-24.
          product<BN>(acc, a3[kk], w_addr, kk);
          product<BN>(acc, a2[kk], w_addr + L::kPart, kk);
          product<BN>(acc, a1[kk], w_addr + 2 * L::kPart, kk);
          product<BN>(acc, a2[kk], w_addr, kk);
          product<BN>(acc, a1[kk], w_addr + L::kPart, kk);
          product<BN>(acc, a1[kk], w_addr, kk);
        }
      } else {
        // ldmatrix.x4: lanes 8m .. 8m + 7 address rows (m % 2) 8 + l % 8
        // of 16-byte unit 2 kk + m / 2: registers 0-3 are the k16 A
        // fragment's (rows g, g + 8) x (columns 2t, 8 + 2t).
        unsigned a[4][4];
        const int r = r0 + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          ldmatrix_x4(a[kk], a_addr + swz(r, 2 * kk + (lane >> 4)));
        mbar_wait(&w_full[sw], (j / L::kWStages) & 1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          product<BN>(acc, a[kk], w_addr + 2 * L::kPart, kk);
          product<BN>(acc, a[kk], w_addr + L::kPart, kk);
          product<BN>(acc, a[kk], w_addr, kk);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(&w_empty[sw]);
    }
    if (lane == 0) mbar_arrive(&a_empty[sa]);
  }

  // Register 4 n + 2 h + e: frame row0 + 8 h, channel n0 + 8 n + 2 t + e.
  const int row0 = t0 + 64 * cw + 16 * w + g;
  const size_t base = static_cast<size_t>(b) * p.T;
#pragma unroll
  for (int n = 0; n < BN / 8; ++n) {
    const int col = n0 + 8 * n + 2 * t;
    if (col >= p.D) continue;  // D is a multiple of 8: col + 1 < D too
    const float c0 = p.bias[col], c1 = p.bias[col + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= p.T) continue;
      const float v0 = relu_keep_nan(acc[4 * n + 2 * h] + c0);
      const float v1 = relu_keep_nan(acc[4 * n + 2 * h + 1] + c1);
      const size_t at = (base + row) * p.D + col;
      if constexpr (F32) {
        *reinterpret_cast<float2*>(static_cast<float*>(p.out) + at) =
            make_float2(v0, v1);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(p.out) + at) =
            __floats2bfloat162_rn(v0, v1);
        if (!CONV2)
          *reinterpret_cast<float2*>(p.h32 + at) = make_float2(v0, v1);
      }
    }
  }
}

// Each weight's three bf16 parts: w (3, c_in, D) float32 -> parts
// (3, 3, c_in, D), part q of element i at q n + i.
__global__ void __launch_bounds__(256)
audio_proj_split_kernel(const float* __restrict__ w1,
                        const float* __restrict__ w2, bf16* __restrict__ p1,
                        bf16* __restrict__ p2, long long n1, long long n2) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n1 + n2; i += step) {
    const bool first = i < n1;
    const long long k = first ? i : i - n1, n = first ? n1 : n2;
    const float v = first ? w1[k] : w2[k];
    bf16* dst = (first ? p1 : p2) + k;
    const bf16 a = __float2bfloat16_rn(v);
    const float r = v - __bfloat162float(a);
    const bf16 m = __float2bfloat16_rn(r);
    dst[0] = a;
    dst[n] = m;
    dst[2 * n] = __float2bfloat16_rn(r - __bfloat162float(m));
  }
}

template <bool CONV2, bool F32, int BN>
cudaError_t launch(const CUtensorMap& ma, const CUtensorMap& mw,
                   const Params& p, long long blocks, int device,
                   cudaStream_t stream) {
  using L = Layout<CONV2 || F32, BN>;
  static unsigned done = 0;
  cudaError_t err = set_smem_once(audio_proj_wgmma_kernel<CONV2, F32, BN>,
                                  L::kBytes, device, &done);
  if (err != cudaSuccess) return err;
  audio_proj_wgmma_kernel<CONV2, F32, BN>
      <<<static_cast<unsigned>(blocks), kThreads, L::kBytes, stream>>>(ma,
                                                                      mw, p);
  return cudaGetLastError();
}

template <bool F32, int BN>
cudaError_t convs(const CUtensorMap& mx, const CUtensorMap& mw1,
                  const CUtensorMap& mh, const CUtensorMap& mw2, Params p1,
                  Params p2, long long blocks, int device, cudaStream_t s) {
  cudaError_t err = launch<false, F32, BN>(mx, mw1, p1, blocks, device, s);
  if (err != cudaSuccess) return err;
  return launch<true, F32, BN>(mh, mw2, p2, blocks, device, s);
}

}  // namespace

// w1 (3, F, D) and w2 (3, D, D) float32 -> p1 (3, 3, F, D), p2 (3, 3, D, D)
// bf16: each weight's three parts, part-major.
extern "C" int avsep_audio_proj_split(const void* w1, const void* w2,
                                      void* p1, void* p2, long long n1,
                                      long long n2, int device,
                                      void* stream) {
  const DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long want = (n1 + n2 + 255) / 256;
  const long long cap = 4LL * sm_count(device);
  const int blocks = static_cast<int>(want < cap ? want : cap);
  audio_proj_split_kernel<<<blocks, 256, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w1), static_cast<const float*>(w2),
      static_cast<bf16*>(p1), static_cast<bf16*>(p2), n1, n2);
  return static_cast<int>(cudaGetLastError());
}

// x (B, T, F) float32 (dtype 0) or bf16 (1) with row stride sxt and batch
// stride sxb (elements, multiples of 16 bytes); p1, p2 the weight parts;
// b1, b2 float32 (D); y, h (B, T, D) in x's dtype, contiguous; h32 a
// float32 (B, T, D) scratch at bf16 (conv2's A), unused at float32 (conv2
// reads h).  bn: the channels a block, 64 or 128 (`proj_plan` in
// ops/kernels/audio_proj.py).
extern "C" int avsep_audio_proj_fwd(
    const void* x, long long sxt, long long sxb, int dtype, const void* p1,
    const void* b1, const void* p2, const void* b2, void* y, void* h,
    void* h32, int B, int T, int F, int D, int bn, int device,
    void* stream) {
  const bool f32 = dtype == 0;
  const int esize = f32 ? 4 : 2;
  if (D % 8 != 0 || D < 64 || (bn != 64 && bn != 128) ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (f32) h32 = h;
  const int tiles = (T + kBM - 1) / kBM, slabs = (D + bn - 1) / bn;
  const long long blocks = static_cast<long long>(B) * tiles * slabs;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap mx, mw1, mh, mw2;
  if (!encode_map_3d(&mx,
                     f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                         : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                     x, F, T, B, esize * sxt, esize * sxb, 128 / esize,
                     kStaged) ||
      !encode_map_3d(&mw1, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p1, D, F, 9,
                     2LL * D, 2LL * F * D, 64, 64) ||
      !encode_map_3d(&mh, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, h32, D, T, B,
                     4LL * D, 4LL * T * D, 32, kStaged) ||
      !encode_map_3d(&mw2, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p2, D, D, 9,
                     2LL * D, 2LL * D * D, 64, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  Params c1, c2;
  c1.bias = static_cast<const float*>(b1);
  c1.h32 = f32 ? nullptr : static_cast<float*>(h32);
  c1.out = h;
  c1.T = T; c1.cin = F; c1.D = D;
  c1.tiles = tiles; c1.slabs = slabs;
  c2 = c1;
  c2.bias = static_cast<const float*>(b2);
  c2.h32 = nullptr;
  c2.out = y;
  c2.cin = D;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f32)
    err = bn == 128
              ? convs<true, 128>(mx, mw1, mh, mw2, c1, c2, blocks, device, s)
              : convs<true, 64>(mx, mw1, mh, mw2, c1, c2, blocks, device, s);
  else
    err = bn == 128
              ? convs<false, 128>(mx, mw1, mh, mw2, c1, c2, blocks, device, s)
              : convs<false, 64>(mx, mw1, mh, mw2, c1, c2, blocks, device, s);
  return static_cast<int>(err);
}

extern "C" const char* avsep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
