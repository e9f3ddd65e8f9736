// Hopper (sm_90a) building blocks shared by csrc/masked_attention.cu and
// csrc/train_flash_attention.cu, and the one forward mainloop both use.
// Everything that depends on the head width is a template on DH, one of
// 8, 16, 32, 64, 128 and 256 (Width<DH>); each is its own instantiation,
// and a head width Dh between two of them (any multiple of 8 up to 256)
// runs at the next one up (instantiated_width): 24 at 32, 40-56 at 64,
// 72-120 at 128, 136-248 at 256.
//
// * Tensor maps: a 4-D TMA map over a (B, T, H, Dh) bf16 tensor, read as
//   (Dh, H, T, B) innermost first with the caller's batch and time strides,
//   so a strided view (the NAR's split of a fused qkv) is read in place.  A
//   tile is 64 rows of one head in panels of at most 64 columns: DH 128 and
//   256 are two and four 64-column panels, each its own box at column 0,
//   64, 128 or 192, the others one panel of DH columns.  A box is PW x 1 x 64 x 1 (PW the panel's
//   columns), one PW·2-byte row each, stored with the swizzle whose span is
//   the row: 128-byte at PW 64, 64-byte at 32, 32-byte at 16, none at 8
//   (16-byte rows, the smallest inner box TMA takes).  The map's inner
//   dimension is the true Dh, so the hardware zero-fills the columns past
//   Dh of a box, as it zero-fills rows past T: every byte of a tile is
//   written by TMA.  Zero columns add nothing to a product over the head
//   width, and the DH-wide outputs store their first Dh columns only.
//   cuTensorMapEncodeTiled is reached through cudaGetDriverEntryPoint, so
//   the build needs no -lcuda.
// * A full/empty mbarrier ring fed by one producer warp with TMA loads
//   (cp.async.bulk.tensor ... mbarrier::complete_tx::bytes).
// * wgmma (bf16 in, fp32 accumulate): m64n64k16 SS (both operands from
//   shared memory) for the products that reduce over the head width, and
//   m64nDHk16 RS (A from registers) for those whose output is DH wide;
//   shared-memory descriptors per swizzle mode for K-major and MN-major
//   (transposed) 64-row tiles; fence / commit / wait.
// * fwd_kernel: the forward mainloop (online softmax over 64-key tiles),
//   instantiated by kernel 1 without the row log-sum-exp and causality and
//   by kernel 2 with both.
//
// Fragment layout (PTX ISA, wgmma m64nN accumulator): in a warpgroup, warp w
// owns rows 16w..16w+15; with g = lane / 4 and t = lane % 4, register
// 4c + e holds row 16w + g + 8·(e / 2), column 8c + 2t + (e % 2), so an
// m64nN accumulator is N / 2 floats a thread.  An RS A operand (m64k16)
// holds, for k-chunk kk, {A[r][16kk+2t..+1]}, {A[r+8][16kk+2t..]},
// {A[r][16kk+8+2t..]}, {A[r+8][16kk+8+2t..]}: exactly accumulator
// registers 8kk..8kk+7 of a 64-wide tile packed in pairs, so a score tile
// turns into the next product's A operand in registers.
//
// Shared-memory layouts (CUTLASS's canonical GMMA layouts, cute/atom/
// mma_traits_sm90_gmma.hpp, in 16-byte units; a panel's row pitch is PW·2
// bytes, equal to its swizzle span, so 8 rows are one PW-unit group):
// * K-major (the head width is the reduced dimension: Q, K, V, dO in S, dP,
//   Sᵀ, dPᵀ): stride between 8-row groups SBO = PW; a k16 step starts 32
//   bytes further into each row, and after PW / 16 steps the next panel
//   begins (DH 128: steps 4-7 read the second panel; DH 256: steps 4p to
//   4p+3 read panel p).  Swizzled, the second
//   8-column half of a k16 step lies inside the swizzle span and LBO is
//   unused.  At DH 8 (no swizzle) the k16 step's upper half is the core
//   matrix LBO further on: the descriptor points it at a zeroed 1 KB block
//   laid out as a tile, so the reduction runs over 8 real columns and 8
//   zeros on both operands (0 · 0 adds nothing; no uninitialised byte is
//   read, which could hold an Inf and give 0 · Inf = NaN).
// * MN-major (the 64 rows are the reduced dimension: V, dO, Q, K as the B
//   operand of P·V, Pᵀ·dO, dSᵀ·Q, dS·K): a k16 step covers rows
//   16kk..16kk+15, 16·PW·2 bytes on; its two 8-row groups are PW units
//   apart: SBO when swizzled, and LBO is the distance between the 64-column
//   swizzle atoms along N (DH 128 and 256: the next panel, 8 KB on; unused
//   when N fits one atom); LBO without swizzle (DH 8: N is one core matrix,
//   SBO unused).  A product over columns c0.. of a wider tile (the DH-256
//   dK/dV halves) starts its descriptor at panel c0 / 64.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: nothing of libcuda is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>
#include <stdio.h>

namespace hopper {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;                  // rows of a tile (queries or keys)
constexpr float kNegInf = -0.7f * FLT_MAX;  // the masked score (finite)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

constexpr int kDhMax = 256;  // the widest head either kernel takes

// What a head width fixes on this path.
template <int DH>
struct Width {
  static_assert(DH == 8 || DH == 16 || DH == 32 || DH == 64 || DH == 128 || DH == 256,
                "head width 8, 16, 32, 64, 128 or 256");
  static constexpr int kTileBytes = kRows * DH * 2;  // one 64-row bf16 tile
  static constexpr int kPanelCols = DH < 64 ? DH : 64;  // columns of a panel (PW)
  static constexpr int kPanels = DH / kPanelCols;       // 2 at DH 128, 4 at 256, else 1
  static constexpr int kPanelBytes = kRows * kPanelCols * 2;
  // k16 steps over the head width (DH 8: one, its upper half zeros), and
  // those within one panel
  static constexpr int kSteps = DH < 16 ? 1 : DH / 16;
  static constexpr int kPanelSteps = kPanelCols < 16 ? 1 : kPanelCols / 16;
  // bytes of the zeroed block a DH-8 k16 step reads as its upper half
  static constexpr int kZeroBytes = DH == 8 ? kRows * 16 : 0;
  // wgmma descriptor layout type (bits 62-63): 1 = 128B, 2 = 64B, 3 = 32B
  // swizzle, 0 = none; the TMA map's swizzle is the same
  static constexpr uint64_t kLayout =
      kPanelCols == 64 ? 1 : kPanelCols == 32 ? 2 : kPanelCols == 16 ? 3 : 0;
  static constexpr CUtensorMapSwizzle kSwizzle =
      kPanelCols == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
      : kPanelCols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
      : kPanelCols == 16 ? CU_TENSOR_MAP_SWIZZLE_32B
                         : CU_TENSOR_MAP_SWIZZLE_NONE;
  // Blocks per SM the kernels are compiled for.  At DH 128 a block's ring
  // takes 114-131 KB of shared memory and at 256 198-231 KB, so one block
  // fits an SM whatever the registers; one block lets a thread hold the
  // dK/dV kernel's two 64-float accumulators, or a 128-float DH-256 one,
  // with the score tiles (up to 255 registers) without spills.
  static constexpr int kFwdBlocks = DH >= 128 ? 1 : 3;
  static constexpr int kDkdvBlocks = DH >= 128 ? 1 : 2;
  static constexpr int kDqBlocks = DH >= 128 ? 1 : 3;
  // Depth of the TMA rings.  The forward keeps three stages at every width
  // (fwd_smem_bytes: 231,248 bytes at DH 256, under the 232,448 a block may
  // use).  The backward's three stages were faster than two at every width
  // where the dK/dV and dQ kernels were timed (scripts/kernel_variants.py,
  // PERF.md); at DH 256 three stages need 263-266 KB, so its rings take two
  // (198-199 KB).
  static constexpr int kFwdStages = 3;
  static constexpr int kBwdStages = DH == 256 ? 2 : 3;
  // dK/dV blocks per 64-key tile, each accumulating DH / kDkdvSplit columns
  // of dK and dV: one DH-256 warpgroup cannot hold two m64n256 accumulators
  // (256 floats a thread), so two blocks share a key tile, each forming the
  // whole Sᵀ and dPᵀ (bwd_dkdv_wgmma_kernel).
  static constexpr int kDkdvSplit = DH == 256 ? 2 : 1;
};

// The instantiation a head width Dh on the tensor cores (bf16, a multiple
// of 8) runs at.
inline int instantiated_width(int Dh) {
  return Dh <= 8 ? 8 : Dh <= 16 ? 16 : Dh <= 32 ? 32 : Dh <= 64 ? 64 : Dh <= 128 ? 128 : 256;
}

// The head widths the kernels take: any from 1 to kDhMax in fp32, the
// multiples of 8 (TMA's 16-byte stride rule) in bf16.  A bf16 call at
// another width is the wrappers' to make, and only theirs: they launch it
// on copies zero-padded to the next multiple of 8 with the true width's
// scale and slice the results back (ops/route.py); the launchers refuse it
// unpadded.  Wider heads are refused by the launchers and by the wrappers
// (ops/masked_attention.kernel_width).
inline bool kernel_width(int Dh, int dtype) {
  return Dh >= 1 && Dh <= kDhMax && (dtype == 0 || Dh % 8 == 0);
}

// The route of a call, the one rule both launchers follow (and that
// ops/route.tensor_core_route states for the wrappers' calls): bf16 with
// every tensor TMA-aligned (tma_ok) runs on the tensor cores; fp32 and
// unaligned bf16 views run on the SIMT kernels.
inline bool tensor_core_route(int dtype, bool aligned) { return dtype == 1 && aligned; }

// The SIMT kernels hold a row at DW, the head width Dh rounded up to 8, 16,
// 32, 64, 128 or 256 (columns past Dh are 0; any Dh, its loads scalar).
inline int simt_width(int Dh) { return instantiated_width(Dh); }

// At DW 128 and 256 two and four neighbouring threads share a row, 64
// columns each, and add their partial dot products with shuffles (row_sum),
// so no thread holds more than 64 columns and a block's shared-memory tiles
// shrink with the width.
template <int DW>
struct Simt {
  static_assert(DW == 8 || DW == 16 || DW == 32 || DW == 64 || DW == 128 || DW == 256,
                "SIMT width 8, 16, 32, 64, 128 or 256");
  static constexpr int kSplit = DW > 64 ? DW / 64 : 1;  // threads per row
  static constexpr int kCols = DW / kSplit;             // columns a thread holds
};

// A partial dot product summed over the kSplit threads of a row (lanes
// SPLIT·i .. SPLIT·i + SPLIT - 1), in a fixed order.  The shuffles name only
// those lanes, so a branch that all threads of a row take together may
// hold it.
template <int SPLIT>
__device__ __forceinline__ float row_sum(float x) {
  if constexpr (SPLIT == 1) {
    return x;
  } else {
    const unsigned lane = threadIdx.x & 31u;
    const unsigned mask = ((1u << SPLIT) - 1u) << (lane & ~(unsigned)(SPLIT - 1));
#pragma unroll
    for (int o = 1; o < SPLIT; o *= 2) x += __shfl_xor_sync(mask, x, o);
    return x;
  }
}

// ---------------------------------------------------------------- host side

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                   void*, const cuuint64_t*, const cuuint64_t*,
                                   const cuuint32_t*, const cuuint32_t*,
                                   CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t rc = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                             cudaEnableDefault, &found);
#endif
    if (rc != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// Error codes of the launchers besides cudaError_t: the tensor map could
// not be encoded (the wrappers raise on any nonzero code).
constexpr int kErrNoEncoder = 1001;
constexpr int kErrEncode = 1002;

// 16-byte aligned base, batch and time strides a multiple of 8 elements
// (16 bytes): what a TMA map over the tensor needs.  Strides of a size-1
// dimension are never used and are not checked.
inline bool tma_ok(const void* p, int n_b, long long sb, int n_t, long long st) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (n_b == 1 || sb % 8 == 0) &&
         (n_t == 1 || st % 8 == 0);
}

// Map over a (B, T, H, Dh) bf16 tensor with element strides sb, st (heads
// and head width dense), read in boxes of DH's panels; Dh <= DH, and the
// box columns past Dh read as zeros.  Returns 0 or an error code.
template <int DH>
inline int make_map(CUtensorMap* map, const void* base, int B, int T, int H, int Dh,
                    long long sb, long long st) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return kErrNoEncoder;
  // The encoder (a libcuda entry) needs a current context, which a thread
  // that has made no runtime call yet (autograd's backward thread) lacks.
  // cudaSetDevice makes the current device's primary context current, once
  // per thread; unlike cudaFree it is legal inside a stream capture.
  static thread_local const cudaError_t ctx = [] {
    int dev = 0;
    const cudaError_t e = cudaGetDevice(&dev);
    return e != cudaSuccess ? e : cudaSetDevice(dev);
  }();
  if (ctx != cudaSuccess) return (int)ctx;
  if (T == 1) st = (long long)H * Dh;  // unused; any legal stride
  if (B == 1) sb = st * T;
  const cuuint64_t dims[4] = {(cuuint64_t)Dh, (cuuint64_t)H, (cuuint64_t)T,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)Dh * 2, (cuuint64_t)st * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)Width<DH>::kPanelCols, 1, kRows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  CUresult rc = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                   dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                   Width<DH>::kSwizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (rc == CUDA_SUCCESS) return 0;
  fprintf(stderr,
          "cuTensorMapEncodeTiled failed (CUresult %d): base %p, dims (%d, %d, %d, %d), "
          "byte strides (%llu, %llu, %llu), box columns %d\n",
          (int)rc, base, Dh, H, T, B, (unsigned long long)strides[0],
          (unsigned long long)strides[1], (unsigned long long)strides[2],
          Width<DH>::kPanelCols);
  return kErrEncode;
}

// Every kernel here has one consumer warpgroup of 64 rows per block.  Two
// warpgroups sharing each streamed tile were measured slower on the H100 at
// every main-path shape, from DiT serving at B = 4 (192 blocks of 64 rows)
// to the AR's 770² at B = 16: a one-warpgroup block needs at most ~136
// registers a thread in the forward, so an SM holds three or four
// independent blocks whose softmax and products interleave, where a
// two-warpgroup block holds the SM alone (PERF.md, PR 6).
// Narrower heads keep the same shape: the accumulators shrink with DH and
// the grids of the Gaussian sites (a few hundred blocks) fit in one wave.
// At DH 128 a block's ring fills half an SM's shared memory and the
// accumulators double, so each kernel runs one block per SM (Width::k*Blocks);
// at DH 256 the rings fill the SM.

// ---------------------------------------------------------------- device side

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  const uint32_t a = smem_addr(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// One box: columns c0.. of head h, rows t0.., batch b into `dst`
// (1024-byte aligned); completion counts bytes on `bar`.
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map, uint64_t* bar,
                                        int c0, int h, int t0, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(h),
      "r"(t0), "r"(b)
      : "memory");
}

// One 64-row tile of head h, rows t0.., batch b: a box per panel, panel p
// (columns 64p..) at dst + p · kPanelBytes; Width<DH>::kTileBytes in all.
template <int DH>
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int h, int t0, int b) {
#pragma unroll
  for (int p = 0; p < Width<DH>::kPanels; ++p)
    tma_box(static_cast<uint8_t*>(dst) + p * Width<DH>::kPanelBytes, map, bar,
            p * Width<DH>::kPanelCols, h, t0, b);
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map))
               : "memory");
}

// Zero the DH-8 k16 steps' upper-half block (no-op at other widths) with
// the block's threads, then make the writes visible to wgmma's reads (the
// async proxy).  Call before the block's first __syncthreads.
template <int DH>
__device__ __forceinline__ void zero_block(uint8_t* zero) {
  if constexpr (Width<DH>::kZeroBytes > 0) {
    for (int i = threadIdx.x; i < Width<DH>::kZeroBytes / 16; i += blockDim.x)
      reinterpret_cast<uint4*>(zero)[i] = make_uint4(0u, 0u, 0u, 0u);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
}

__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint64_t lbo, uint64_t sbo,
                                              uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (lbo << 16) | (sbo << 32) | (layout << 62);
}

// K-major descriptor of k16 step kk of a 64-row tile (the reduced dimension
// is the tile's head width, contiguous within a panel); `zero` is the DH-8
// upper half.
template <int DH>
__device__ __forceinline__ uint64_t desc_kmajor(const void* tile, int kk, const void* zero) {
  using W = Width<DH>;
  const uint32_t a = smem_addr(tile) + (uint32_t)(kk / W::kPanelSteps) * W::kPanelBytes +
                     32u * (kk % W::kPanelSteps);
  const uint64_t lbo = DH == 8 ? (uint64_t)((smem_addr(zero) - smem_addr(tile)) >> 4) : 1;
  return make_desc(a, lbo, W::kPanelCols, W::kLayout);
}

// MN-major descriptor of k16 step kk (rows 16kk..16kk+15 of the tile read
// transposed, wgmma's transpose flag); N spans the tile's panels, LBO apart.
template <int DH>
__device__ __forceinline__ uint64_t desc_mnmajor(const void* tile, int kk) {
  using W = Width<DH>;
  const uint32_t a = smem_addr(tile) + 32u * W::kPanelCols * kk;
  const uint64_t lbo = DH == 8 ? 8 : W::kPanels > 1 ? W::kPanelBytes / 16 : 1;
  return make_desc(a, lbo, W::kPanelCols, W::kLayout);
}

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

// Tell the compiler the registers change here (after a wait), so no read
// of an asynchronously written accumulator is hoisted above it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define HA_ACC4(d) "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
#define HA_ACC8(d) HA_ACC4(d), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
#define HA_ACC16(d)                                                          \
  HA_ACC8(d), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define HA_ACC32(d)                                                           \
  HA_ACC16(d), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),            \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),        \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),        \
      "+f"(d[30]), "+f"(d[31])

#define HA_ACC64(d)                                                           \
  HA_ACC32(d), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),            \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),        \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),        \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),        \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),        \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),        \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

#define HA_ACC128(d) \
  HA_ACC64(d), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), \
      "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), \
      "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), \
      "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), \
      "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), \
      "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), \
      "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), \
      "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), \
      "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), \
      "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), \
      "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), \
      "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), \
      "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])

#define HA_REGS4 "{%0, %1, %2, %3}"
#define HA_REGS8 "{%0, %1, %2, %3, %4, %5, %6, %7}"
#define HA_REGS16 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define HA_REGS32                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define HA_REGS64                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"

#define HA_REGS128 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, " \
  "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, " \
  "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, " \
  "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, " \
  "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, " \
  "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, " \
  "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, " \
  "%126, %127}"

// D (64 x 64, fp32) (+)= A (64 x 16) · B (16 x 64), both from shared memory.
// TA / TB: 0 = K-major, 1 = MN-major.  accumulate = 0 overwrites D.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HA_REGS32
      ", %32, %33, p, 1, 1, %35, %36;\n}\n"
      : HA_ACC32(d)
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// D (64 x N) (+)= A · B with A from registers (four packed bf16 pairs per
// thread), B (16 x N) from shared memory; N/2 accumulators a thread.
#define HA_WGMMA_RS(N, REGS, ACC, A0, A1, A2, A3, DB, P, T)                     \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #P ", 0;\n"              \
               "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 " REGS \
               ", {%" #A0 ", %" #A1 ", %" #A2 ", %" #A3 "}, %" #DB               \
               ", p, 1, 1, %" #T ";\n}\n"                                      \
               : ACC(d)                                                        \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),          \
                 "r"(accumulate), "n"(TB))

template <int TB, int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t db, int accumulate) {
  if constexpr (N == 8)
    HA_WGMMA_RS(8, HA_REGS4, HA_ACC4, 4, 5, 6, 7, 8, 9, 10);
  else if constexpr (N == 16)
    HA_WGMMA_RS(16, HA_REGS8, HA_ACC8, 8, 9, 10, 11, 12, 13, 14);
  else if constexpr (N == 32)
    HA_WGMMA_RS(32, HA_REGS16, HA_ACC16, 16, 17, 18, 19, 20, 21, 22);
  else if constexpr (N == 64)
    HA_WGMMA_RS(64, HA_REGS32, HA_ACC32, 32, 33, 34, 35, 36, 37, 38);
  else if constexpr (N == 128)
    HA_WGMMA_RS(128, HA_REGS64, HA_ACC64, 64, 65, 66, 67, 68, 69, 70);
  else
    HA_WGMMA_RS(256, HA_REGS128, HA_ACC128, 128, 129, 130, 131, 132, 133, 134);
}

// D (64 x 64) = A · Bᵀ over the head width (DH / 16 k16 steps; at DH 8 one
// step whose upper half is the zero block), both tiles K-major.
template <int DH>
__device__ __forceinline__ void gemm_abt(float (&d)[32], const void* a, const void* b,
                                         const void* zero) {
#pragma unroll
  for (int kk = 0; kk < Width<DH>::kSteps; ++kk)
    wgmma_ss<0, 0>(d, desc_kmajor<DH>(a, kk, zero), desc_kmajor<DH>(b, kk, zero), kk > 0);
}

// D (64 x N) += P · B over 64 rows of B (four k16 steps), P from
// registers, B read transposed (MN-major) from its tile: the tile's first N
// columns (N = DH), or N columns from panel b (a panel-aligned pointer into
// a DH-wide tile, N < DH).
template <int DH, int N = DH>
__device__ __forceinline__ void gemm_pb(float (&d)[N / 2], const uint32_t (&p)[4][4],
                                        const void* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs<1, N>(d, p[kk], desc_mnmajor<DH>(b, kk), 1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// An accumulator tile (rounded to bf16) as four RS A operands.
__device__ __forceinline__ void to_operand(const float (&d)[32], uint32_t (&p)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) p[kk][i] = pack_bf16(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1]);
}

// Index of the first key with mask > 0 (Tk when none), the same in every
// lane of the calling warp.  Query rows below it have no visible valid key
// under causality: their softmax row is the uniform 1/Tk over all keys.
__device__ __forceinline__ int first_valid_key(const float* mask_b, int Tk, int lane) {
  for (int j0 = 0; j0 < Tk; j0 += 32) {
    const int j = j0 + lane;
    const unsigned hit = __ballot_sync(0xffffffffu, j < Tk && mask_b[j] > 0.f);
    if (hit) return j0 + __ffs(hit) - 1;
  }
  return Tk;
}

// ------------------------------------------------------- the forward mainloop

struct FwdParams {
  const float* mask;  // (B, Tk), > 0 = valid key
  bf16* o;            // (B, Tq, H, Dh), strides o_sb, o_st
  float* lse;         // (B, H, Tq) natural-log row log-sum-exp, or null
  long long o_sb, o_st;
  int Tq, Tk, H, Dh, causal;  // Dh: the true head width, at most DH
  float scale_log2;   // Dh^-0.5 · log2(e)
};

// The forward keeps three K/V stages (Width::kFwdStages): the tile whose
// P·V is in flight, the tile being scored, and the one being loaded.  At
// DH <= 32 the smaller tiles leave room for a deeper ring or more blocks
// per SM; timed at the Gaussian and D3PM sites (scripts/kernel_variants.py,
// PERF.md), a fourth stage gains nothing (a block walks at most 7 key
// tiles, and its chain of S, softmax and P·V, not the loads, sets its
// time), two stages are slower, and a bound of four blocks per SM is slower
// at DH 32 and 64.  At DH 128 the three stages take 114 KB, at DH 256 226
// KB: one block per SM.
template <int DH>
constexpr int fwd_smem_bytes() {
  constexpr int S = Width<DH>::kFwdStages;
  return 1024 + (1 + 2 * S) * Width<DH>::kTileBytes + Width<DH>::kZeroBytes +
         S * (kRows + 2) * 4 + (2 * S + 1) * 8;
}
static_assert(fwd_smem_bytes<256>() <= 232448, "the DH-256 forward's ring exceeds a block's "
              "shared memory");

// One block per (query tile of 64 rows, head, batch): one consumer
// warpgroup (warps 0..3) and one producer warp (warp 4).  The producer
// loads the block's Q tile once and streams K/V tiles with
// their key flags through the ring; each consumer computes S = Q·Kᵀ (SS),
// the online softmax in registers (exp2 of scores pre-scaled by
// Dh^-0.5·log2 e), and O += P·V (RS, P in bf16 from registers, V read
// transposed; m64nDHk16, DH / 2 accumulators a thread).  S of tile kt and
// P·V of tile kt-1 are issued together, and the softmax of tile kt runs
// while P·V is in flight (FlashAttention-3's intra-warpgroup overlap); O is
// rescaled before the next P·V is issued.  At least three blocks per SM
// (at most 136 registers a thread at DH 64, fewer below); one at DH 128
// and 256 (at 256 the m64n256 O accumulator is 128 floats a thread).
// Columns past p.Dh (when DH > p.Dh) are zeros in every tile, and O's are
// not stored.
template <bool kLse, int DH>
__global__ void __launch_bounds__(160, Width<DH>::kFwdBlocks)
fwd_kernel(const __grid_constant__ CUtensorMap map_q,
           const __grid_constant__ CUtensorMap map_k,
           const __grid_constant__ CUtensorMap map_v, const FwdParams p) {
  constexpr int S = Width<DH>::kFwdStages;
  constexpr int kTile = Width<DH>::kTileBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align1024(smem_raw);
  uint8_t* qs = base;
  uint8_t* ks = qs + kTile;
  uint8_t* vs = ks + S * kTile;
  uint8_t* zero = vs + S * kTile;  // DH 8 only
  float* flag = reinterpret_cast<float*>(zero + Width<DH>::kZeroBytes);
  float* plain = flag + S * kRows;  // per stage: 1 when every key is valid
  uint64_t* full = reinterpret_cast<uint64_t*>(plain + S + (S & 1));
  uint64_t* empty = full + S;
  uint64_t* qbar = empty + S;

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* mask_b = p.mask + (long long)b * p.Tk;

  // Key tiles: every tile, or under causality up to the last one a row of
  // the block can see -- unless a row of the block has no visible valid
  // key, whose uniform row spans all Tk keys.
  int n_kt = (p.Tk + kRows - 1) / kRows;
  if (p.causal) {
    const int q_last = min(p.Tq, q0 + kRows) - 1;
    if (q0 >= first_valid_key(mask_b, p.Tk, lane)) n_kt = min(n_kt, q_last / kRows + 1);
  }

  zero_block<DH>(zero);
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], 4);
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4) {  // ---- producer warp
    if (lane == 0) {
      prefetch_map(&map_q);
      prefetch_map(&map_k);
      prefetch_map(&map_v);
      mbar_arrive_tx(qbar, kTile);
      tma_load<DH>(qs, &map_q, qbar, h, q0, b);
    }
    for (int kt = 0; kt < n_kt; ++kt) {
      const int s = kt % S;
      mbar_wait(&empty[s], ((kt / S) & 1) ^ 1);
      // key flag: 0 = valid (keep the score), NEG_INF = masked (finite,
      // replaces the score), -inf = past Tk (weighs exactly 0)
      bool valid = true;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = kt * kRows + lane + 32 * e;
        const float f = j < p.Tk ? (mask_b[j] > 0.f ? 0.f : kNegInf) : -INFINITY;
        flag[s * kRows + lane + 32 * e] = f;
        valid = valid && f == 0.f;
      }
      valid = __all_sync(0xffffffffu, valid);
      if (lane == 0) {
        plain[s] = valid ? 1.f : 0.f;
        mbar_arrive_tx(&full[s], 2 * kTile);
        tma_load<DH>(ks + s * kTile, &map_k, &full[s], h, kt * kRows, b);
        tma_load<DH>(vs + s * kTile, &map_v, &full[s], h, kt * kRows, b);
      } else {
        mbar_arrive(&full[s]);
      }
    }
    return;
  }
  // ---- consumer warpgroup
  const int w = warp, g = lane >> 2, t = lane & 3;
  const int r0 = q0 + 16 * w + g, r1 = r0 + 8;
  const uint8_t* q_tile = qs;
  const float sl2 = p.scale_log2;

  constexpr int NO = DH / 2;  // output accumulators a thread
  float o[NO], sc[32];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, c0 = 0.f, c1 = 0.f;
  uint32_t pa[4][4];  // P of the last scored tile, bf16 (p.astype(v.dtype))

  // Scores of tile kt (in sc) → p = exp2(x − m) in sc, with x the score in
  // log2 units; the running maxima and sums move on, and (c0, c1) is the
  // factor that rescales O to the new maxima.
  auto softmax = [&](int kt) {
    const int s = kt % S;
    const int j0 = kt * kRows;
    const bool diag = p.causal && j0 + kRows - 1 > q0;
    float mx0 = -INFINITY, mx1 = -INFINITY, mn0, mn1;
    if (!diag && plain[s] != 0.f) {  // every key valid and visible
#pragma unroll
      for (int i = 0; i < 32; i += 4) {
        mx0 = fmaxf(mx0, fmaxf(sc[i], sc[i + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[i + 2], sc[i + 3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      mn0 = fmaxf(m0, mx0 * sl2);
      mn1 = fmaxf(m1, mx1 * sl2);
#pragma unroll
      for (int i = 0; i < 32; i += 4) {
        sc[i] = exp2f(fmaf(sc[i], sl2, -mn0));
        sc[i + 1] = exp2f(fmaf(sc[i + 1], sl2, -mn0));
        sc[i + 2] = exp2f(fmaf(sc[i + 2], sl2, -mn1));
        sc[i + 3] = exp2f(fmaf(sc[i + 3], sl2, -mn1));
      }
    } else {
      const float* fl = flag + s * kRows;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float2 f = *reinterpret_cast<const float2*>(fl + 8 * c + 2 * t);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float fe = e ? f.y : f.x;
          const int j = j0 + 8 * c + 2 * t + e;
          float x0 = fe != 0.f ? fe : sc[4 * c + e] * sl2;
          float x1 = fe != 0.f ? fe : sc[4 * c + 2 + e] * sl2;
          if (diag) {  // hidden keys (j > i) take NEG_INF unless past Tk
            if (j > r0) x0 = fminf(x0, kNegInf);
            if (j > r1) x1 = fminf(x1, kNegInf);
          }
          sc[4 * c + e] = x0;
          sc[4 * c + 2 + e] = x1;
          mx0 = fmaxf(mx0, x0);
          mx1 = fmaxf(mx1, x1);
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      // tile 0 holds key 0 < Tk, so the running maxima are finite from there
      mn0 = fmaxf(m0, mx0);
      mn1 = fmaxf(m1, mx1);
#pragma unroll
      for (int i = 0; i < 32; i += 4) {
        sc[i] = exp2f(sc[i] - mn0);
        sc[i + 1] = exp2f(sc[i + 1] - mn0);
        sc[i + 2] = exp2f(sc[i + 2] - mn1);
        sc[i + 3] = exp2f(sc[i + 3] - mn1);
      }
    }
    c0 = exp2f(m0 - mn0);
    c1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= c0;
    l1 *= c1;
#pragma unroll
    for (int i = 0; i < 32; i += 4) {
      l0 += sc[i] + sc[i + 1];
      l1 += sc[i + 2] + sc[i + 3];
    }
  };
  auto rescale_o = [&]() {
#pragma unroll
    for (int i = 0; i < NO; i += 4) {
      o[i] *= c0;
      o[i + 1] *= c0;
      o[i + 2] *= c1;
      o[i + 3] *= c1;
    }
  };

  mbar_wait(qbar, 0);
  mbar_wait(&full[0], 0);
  wgmma_fence();
  gemm_abt<DH>(sc, q_tile, ks, zero);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc);
  softmax(0);
  to_operand(sc, pa);

  // Iteration kt: S of tile kt and P·V of tile kt−1 go to the tensor cores
  // together; the softmax of tile kt runs while P·V is still in flight.
  for (int kt = 1; kt < n_kt; ++kt) {
    const int s = kt % S, sp = (kt - 1) % S;
    mbar_wait(&full[s], (kt / S) & 1);
    rescale_o();
    wgmma_fence();
    gemm_abt<DH>(sc, q_tile, ks + s * kTile, zero);
    wgmma_commit();
    gemm_pb<DH>(o, pa, vs + sp * kTile);
    wgmma_commit();
    wgmma_wait<1>();  // S of tile kt
    fence_regs(sc);
    softmax(kt);
    wgmma_wait<0>();  // P·V of tile kt−1: its stage is free, pa may change
    fence_regs(o);
    if (lane == 0) mbar_arrive(&empty[sp]);
    to_operand(sc, pa);
  }
  rescale_o();
  wgmma_fence();
  gemm_pb<DH>(o, pa, vs + ((n_kt - 1) % S) * kTile);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float i0 = 1.f / l0, i1 = 1.f / l1;
  bf16* ob = p.o + (long long)b * p.o_sb + h * p.Dh;
#pragma unroll
  for (int c = 0; c < DH / 8; ++c) {
    const int col = 8 * c + 2 * t;
    if (8 * c >= p.Dh) break;  // zero columns past the head width
    if (r0 < p.Tq)
      *reinterpret_cast<uint32_t*>(ob + (long long)r0 * p.o_st + col) =
          pack_bf16(o[4 * c] * i0, o[4 * c + 1] * i0);
    if (r1 < p.Tq)
      *reinterpret_cast<uint32_t*>(ob + (long long)r1 * p.o_st + col) =
          pack_bf16(o[4 * c + 2] * i1, o[4 * c + 3] * i1);
  }
  if (kLse && t == 0) {
    // natural log; an all-masked row (m = NEG_INF) gives NEG_INF exactly,
    // which the backward reads as "uniform row, no dS"
    float* lb = p.lse + ((long long)b * p.H + h) * p.Tq;
    if (r0 < p.Tq) lb[r0] = m0 == kNegInf ? kNegInf : (m0 + log2f(l0)) * kLn2;
    if (r1 < p.Tq) lb[r1] = m1 == kNegInf ? kNegInf : (m1 + log2f(l1)) * kLn2;
  }
}

template <typename Kernel>
inline int set_smem(Kernel kernel, int bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   bytes);
}

// The forward on the Hopper path: q (B, Tq, H, Dh), k, v (B, Tk, H, Dh)
// bf16 with element strides, Dh <= DH; o written with its strides; lse
// (B, H, Tq) when kLse; scores scaled by `scale` (the true head width's
// Dh^-0.5, which a padded copy keeps).  Returns 0 when launched, else an
// error code.
template <bool kLse, int DH>
inline int launch_fwd(const void* q, const void* k, const void* v, const float* mask,
                      void* o, float* lse, long long q_sb, long long q_st,
                      long long k_sb, long long k_st, long long v_sb, long long v_st,
                      long long o_sb, long long o_st, int B, int Tq, int Tk, int H, int Dh,
                      int causal, float scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  int rc = make_map<DH>(&mq, q, B, Tq, H, Dh, q_sb, q_st);
  if (rc == 0) rc = make_map<DH>(&mk, k, B, Tk, H, Dh, k_sb, k_st);
  if (rc == 0) rc = make_map<DH>(&mv, v, B, Tk, H, Dh, v_sb, v_st);
  if (rc != 0) return rc;
  FwdParams p{mask, static_cast<bf16*>(o), lse, o_sb, o_st, Tq, Tk, H, Dh, causal,
              scale * kLog2e};
  constexpr int smem = fwd_smem_bytes<DH>();
  static const int attr = set_smem(fwd_kernel<kLse, DH>, smem);
  if (attr != 0) return attr;
  const dim3 grid((Tq + kRows - 1) / kRows, H, B);
  fwd_kernel<kLse, DH><<<grid, 160, smem, stream>>>(mq, mk, mv, p);
  return (int)cudaGetLastError();
}

// launch_fwd at the instantiation of head width Dh (a multiple of 8; the
// caller checked).
template <bool kLse>
inline int launch_fwd_at(int Dh, const void* q, const void* k, const void* v,
                         const float* mask, void* o, float* lse, long long q_sb,
                         long long q_st, long long k_sb, long long k_st, long long v_sb,
                         long long v_st, long long o_sb, long long o_st, int B, int Tq,
                         int Tk, int H, int causal, float scale, cudaStream_t stream) {
#define HA_FWD(DH)                                                                     \
  launch_fwd<kLse, DH>(q, k, v, mask, o, lse, q_sb, q_st, k_sb, k_st, v_sb, v_st, o_sb, \
                       o_st, B, Tq, Tk, H, Dh, causal, scale, stream)
  switch (instantiated_width(Dh)) {
    case 8: return HA_FWD(8);
    case 16: return HA_FWD(16);
    case 32: return HA_FWD(32);
    case 64: return HA_FWD(64);
    case 128: return HA_FWD(128);
    default: return HA_FWD(256);
  }
#undef HA_FWD
}

}  // namespace hopper
