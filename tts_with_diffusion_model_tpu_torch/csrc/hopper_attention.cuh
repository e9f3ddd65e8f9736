// Hopper (sm_90a) building blocks shared by csrc/masked_attention.cu and
// csrc/train_flash_attention.cu, and the one forward mainloop both use.
//
// * Tensor maps: a 4-D TMA map over a (B, T, H, Dh=64) bf16 tensor, read as
//   (Dh, H, T, B) innermost first with the caller's batch and time strides,
//   so a strided view (the NAR's split of a fused qkv) is read in place.  A
//   box is 64 x 1 x 64 x 1: 64 rows of one head, one 128-byte row each,
//   stored with the 128-byte swizzle that wgmma reads.  Rows past T are
//   zero-filled by the hardware.  cuTensorMapEncodeTiled is reached through
//   cudaGetDriverEntryPoint, so the build needs no -lcuda.
// * A full/empty mbarrier ring fed by one producer warp with TMA loads
//   (cp.async.bulk.tensor ... mbarrier::complete_tx::bytes).
// * wgmma m64n64k16 (bf16 in, fp32 accumulate): SS (both operands from
//   shared memory) and RS (A from registers), shared-memory descriptors for
//   K-major and MN-major (transposed) 64 x 64 tiles, fence / commit / wait.
// * fwd_kernel: the forward mainloop (online softmax over 64-key tiles),
//   instantiated by kernel 1 without the row log-sum-exp and causality and
//   by kernel 2 with both.
//
// Fragment layout (PTX ISA, wgmma m64nN accumulator): in a warpgroup, warp w
// owns rows 16w..16w+15; with g = lane / 4 and t = lane % 4, register
// 4c + e holds row 16w + g + 8·(e / 2), column 8c + 2t + (e % 2).  An RS A
// operand (m64k16) holds, for k-chunk kk, {A[r][16kk+2t..+1]},
// {A[r+8][16kk+2t..]}, {A[r][16kk+8+2t..]}, {A[r+8][16kk+8+2t..]}: exactly
// accumulator registers 8kk..8kk+7 packed in pairs, so a score tile turns
// into the next product's A operand in registers.

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
constexpr int kDh = 64;                    // head width of this path
constexpr int kTileBytes = kRows * kDh * 2;  // one 64 x 64 bf16 tile, 8 KB
constexpr int kStages = 2;                 // depth of the backward's TMA rings
constexpr float kNegInf = -0.7f * FLT_MAX;  // the masked score (finite)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

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

// Map over a (B, T, H, 64) bf16 tensor with element strides sb, st (heads
// and head width dense).  Returns 0 or an error code.
inline int make_map(CUtensorMap* map, const void* base, int B, int T, int H,
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
  if (T == 1) st = (long long)H * kDh;  // unused; any legal stride
  if (B == 1) sb = st * T;
  const cuuint64_t dims[4] = {(cuuint64_t)kDh, (cuuint64_t)H, (cuuint64_t)T,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)kDh * 2, (cuuint64_t)st * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {kDh, 1, kRows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  CUresult rc = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                   dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                   CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (rc == CUDA_SUCCESS) return 0;
  fprintf(stderr,
          "cuTensorMapEncodeTiled failed (CUresult %d): base %p, dims (64, %d, %d, %d), "
          "byte strides (%llu, %llu, %llu)\n",
          (int)rc, base, H, T, B, (unsigned long long)strides[0],
          (unsigned long long)strides[1], (unsigned long long)strides[2]);
  return kErrEncode;
}

// Every kernel here has one consumer warpgroup of 64 rows per block.  Two
// warpgroups sharing each streamed tile were measured slower on the H100 at
// every main-path shape, from DiT serving at B = 4 (192 blocks of 64 rows)
// to the AR's 770² at B = 16: a one-warpgroup block needs at most ~136
// registers a thread in the forward, so an SM holds three or four
// independent blocks whose softmax and products interleave, where a
// two-warpgroup block holds the SM alone (PERF.md, PR 6).

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

// One 64-row x 64-wide box of head h, rows t0.., batch b into `dst`
// (1024-byte aligned); completion counts bytes on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int h, int t0, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(0), "r"(h),
      "r"(t0), "r"(b)
      : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map))
               : "memory");
}

// wgmma shared-memory descriptors of a 64 x 64 bf16 tile written by TMA
// with the 128-byte swizzle (8-row groups of 1024 bytes; layout type 1).
// K-major (the reduced dimension is the tile's contiguous width): the
// k16 step kk starts 32·kk bytes into each row.  MN-major (the reduced
// dimension runs over the tile's rows, wgmma's transpose flag): step kk
// covers rows 16kk..16kk+15, two 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_kmajor(const void* tile, int kk) {
  const uint32_t a = smem_addr(tile) + 32u * kk;
  return (uint64_t)((a & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ uint64_t desc_mnmajor(const void* tile, int kk) {
  const uint32_t a = smem_addr(tile) + 2048u * kk;
  return (uint64_t)((a & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
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
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define HA_ACC32(d)                                                         \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])

#define HA_REGS32                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

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

// D (+)= A · B with A from registers (four packed bf16 pairs per thread).
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HA_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : HA_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate),
        "n"(TB));
}

// D = A · Bᵀ over the full width 64 (four k16 steps), both tiles K-major.
__device__ __forceinline__ void gemm_abt(float (&d)[32], const void* a, const void* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss<0, 0>(d, desc_kmajor(a, kk), desc_kmajor(b, kk), kk > 0);
}

// D += P · B over 64 rows of B (four k16 steps), P from registers, B read
// transposed (MN-major) from its tile.
__device__ __forceinline__ void gemm_pb(float (&d)[32], const uint32_t (&p)[4][4],
                                        const void* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs<1>(d, p[kk], desc_mnmajor(b, kk), 1);
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
  bf16* o;            // (B, Tq, H, 64), strides o_sb, o_st
  float* lse;         // (B, H, Tq) natural-log row log-sum-exp, or null
  long long o_sb, o_st;
  int Tq, Tk, H, causal;
  float scale_log2;   // Dh^-0.5 · log2(e)
};

// The forward keeps three K/V stages: the tile whose P·V is in flight, the
// tile being scored, and the one being loaded.
constexpr int kFwdStages = 3;

constexpr int kFwdSmemBytes =
    1024 + (1 + 2 * kFwdStages) * kTileBytes + kFwdStages * (kRows + 2) * 4 + (2 * kFwdStages + 1) * 8;

// One block per (query tile of 64 rows, head, batch): one consumer
// warpgroup (warps 0..3) and one producer warp (warp 4).  The producer
// loads the block's Q tile once and streams K/V tiles with
// their key flags through the ring; each consumer computes S = Q·Kᵀ (SS),
// the online softmax in registers (exp2 of scores pre-scaled by
// Dh^-0.5·log2 e), and O += P·V (RS, P in bf16 from registers, V read
// transposed).  S of tile kt and P·V of tile kt-1 are issued together, and
// the softmax of tile kt runs while P·V is in flight (FlashAttention-3's
// intra-warpgroup overlap); O is rescaled before the next P·V is issued.
// At least three blocks per SM (at most 136 registers a thread).
template <bool kLse>
__global__ void __launch_bounds__(160, 3)
fwd_kernel(const __grid_constant__ CUtensorMap map_q,
           const __grid_constant__ CUtensorMap map_k,
           const __grid_constant__ CUtensorMap map_v, const FwdParams p) {
  constexpr int S = kFwdStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align1024(smem_raw);
  uint8_t* qs = base;
  uint8_t* ks = qs + kTileBytes;
  uint8_t* vs = ks + S * kTileBytes;
  float* flag = reinterpret_cast<float*>(vs + S * kTileBytes);
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
      mbar_arrive_tx(qbar, kTileBytes);
      tma_load(qs, &map_q, qbar, h, q0, b);
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
        mbar_arrive_tx(&full[s], 2 * kTileBytes);
        tma_load(ks + s * kTileBytes, &map_k, &full[s], h, kt * kRows, b);
        tma_load(vs + s * kTileBytes, &map_v, &full[s], h, kt * kRows, b);
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

  float o[32], sc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
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
    for (int i = 0; i < 32; i += 4) {
      o[i] *= c0;
      o[i + 1] *= c0;
      o[i + 2] *= c1;
      o[i + 3] *= c1;
    }
  };

  mbar_wait(qbar, 0);
  mbar_wait(&full[0], 0);
  wgmma_fence();
  gemm_abt(sc, q_tile, ks);
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
    gemm_abt(sc, q_tile, ks + s * kTileBytes);
    wgmma_commit();
    gemm_pb(o, pa, vs + sp * kTileBytes);
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
  gemm_pb(o, pa, vs + ((n_kt - 1) % S) * kTileBytes);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float i0 = 1.f / l0, i1 = 1.f / l1;
  bf16* ob = p.o + (long long)b * p.o_sb + h * kDh;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int col = 8 * c + 2 * t;
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

// The forward on the Hopper path: q (B, Tq, H, 64), k, v (B, Tk, H, 64)
// bf16 with element strides; o written with its strides; lse (B, H, Tq)
// when kLse.  Returns 0 when launched, else an error code.
template <bool kLse>
inline int launch_fwd(const void* q, const void* k, const void* v, const float* mask,
                      void* o, float* lse, long long q_sb, long long q_st,
                      long long k_sb, long long k_st, long long v_sb, long long v_st,
                      long long o_sb, long long o_st, int B, int Tq, int Tk, int H,
                      int causal, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  int rc = make_map(&mq, q, B, Tq, H, q_sb, q_st);
  if (rc == 0) rc = make_map(&mk, k, B, Tk, H, k_sb, k_st);
  if (rc == 0) rc = make_map(&mv, v, B, Tk, H, v_sb, v_st);
  if (rc != 0) return rc;
  FwdParams p{mask, static_cast<bf16*>(o), lse, o_sb, o_st, Tq, Tk, H, causal,
              kLog2e / sqrtf((float)kDh)};
  static const int attr = set_smem(fwd_kernel<kLse>, kFwdSmemBytes);
  if (attr != 0) return attr;
  const dim3 grid((Tq + kRows - 1) / kRows, H, B);
  fwd_kernel<kLse><<<grid, 160, kFwdSmemBytes, stream>>>(mq, mk, mv, p);
  return (int)cudaGetLastError();
}

}  // namespace hopper
