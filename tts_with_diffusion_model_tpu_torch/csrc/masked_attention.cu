// Key-masked multi-head attention, forward only, for Hopper (sm_90a).
//
// Replaces tts_with_diffusion_model_tpu/ops/flash_attention.py::_attn_kernel
// (launched by _flash_impl through pl.pallas_call).  Same function:
//   per (batch b, head h):  s = q·kᵀ·Dh^-0.5 in fp32
//                           s stays where kv_mask[b, j] > 0, else NEG_INF
//                           p = softmax(s) over keys;  o = p·v
// with NEG_INF = -0.7·FLT_MAX (finite, so a row whose keys are all masked
// gets a uniform softmax over its Tk keys, never NaN; replacing the score
// and adding NEG_INF to it round to the same fp32 value), inputs and output
// in the (B, T, H, Dh) layout with no transposes, fp32 accumulation for
// fp32 and bf16 inputs, and p rounded to v's dtype before p·v as the TPU
// kernel does.  Query rows are never masked here: every caller multiplies
// padding query rows away.
//
// What bounds it on the card.  At the serving shapes (Tq, Tk <= 800,
// H·Dh = 512 or 1024, B <= 8) one call is small: a B=1 DiT self-attention
// (384 x 384, 8 x 64) moves about 1.5 MB in bf16 and does about 0.3 GFLOP,
// under a microsecond of either bytes or tensor-core time, so the bound is
// the bytes plus the launch itself.  The design reads every input byte once
// per query block and writes the output once, keeps the (Tq, Tk) scores out
// of device memory (online softmax in registers over 64-key tiles), and
// needs no second pass or workspace: each attention is one launch.
//
// The bf16 path at every multiple of 8 up to 256 (hopper::kernel_width) with
// 16-byte aligned views (every call of the serving paths, the Gaussian
// family's and the Dh-128 and Dh-256 models' included; the wrapper pads
// another width to the next multiple of 8, keeping the true width's scale)
// is the forward mainloop of csrc/hopper_attention.cuh, instantiated at 8,
// 16, 32, 64, 128 and 256 (a width between them runs at the next one up,
// the tiles' columns past Dh zero-filled by TMA), shared with the training
// kernel's forward (here without the log-sum-exp and causality).  Against
// what held the mma.sync version back:
//  1. loads: a producer warp keeps a 3-stage ring of K/V tiles filled by
//     TMA (full/empty mbarriers), so loads run under the products; Q is
//     loaded once per block;
//  2. transposed V: V lands in shared memory with the swizzle of its row
//     width and wgmma reads it transposed through an MN-major descriptor --
//     no scalar 16-bit loads or packing by hand;
//  3. products: S = Q·Kᵀ (both from shared memory, m64n64k16 over DH / 16
//     k-steps; Dh 8 pads its one step with a zeroed block) and O += P·V (P
//     in bf16 straight from the score accumulators, m64nDHk16) are
//     warpgroup wgmma; S of tile k goes out with P·V of tile k-1, and the
//     softmax of tile k runs under that P·V;
//  4. exponents: one multiply by Dh^-0.5·log2 e and exp2f per score;
//  5. causality: none here (kernel 1 is never causal);
//  6. no D pass (forward only).
// One consumer warpgroup of 64 query rows per block (hopper_attention.cuh):
// DiT serving at B = 4 gives only 192 blocks, and two warpgroups per block
// measured slower at every serving shape, the NAR's included.
// fp32 and unaligned bf16 views: one thread per query row (two at DW 128,
// four at DW 256, each holding 64 columns) on the CUDA cores in fp32, q and the output
// accumulators in registers, K/V tiles read from shared memory as
// broadcasts, each held at the head width rounded up to 8, 16, 32, 64, 128
// or 256 (DW, hopper::simt_width), loaded element by element so that any
// width is read in place.  fp32 inputs take this path so that they are
// summed in fp32 throughout.  Wider heads are refused.
// hopper::tensor_core_route is the rule between the two; the launcher
// reports the route it took.
// Still left: warp-specialised ping-pong between two consumer warpgroups
// and a persistent schedule over the (tile, head, batch) grid.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC (ops/_build.py).  Plain C entry point below, bound
// with ctypes (ops/masked_attention.py).

#include "hopper_attention.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kQTile = 64;   // query rows per block, one per thread
constexpr int kKTile = 64;   // keys staged in shared memory per step
constexpr int kSub = 16;     // keys scored per online-softmax update
constexpr float kNegInf = -0.7f * FLT_MAX;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
// p is rounded to the value dtype before p·v (the TPU kernel's
// ``p.astype(v.dtype)``); a no-op for fp32.
__device__ __forceinline__ float round_like(float x, const float*) { return x; }
__device__ __forceinline__ float round_like(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

using hopper::row_sum;
using hopper::Simt;

// DW: the head width Dh rounded up to 8, 16, 32, 64, 128 or 256
// (hopper::Simt; at DW 128 and 256 two and four threads per query row and a
// key tile of 32 and 16 rows).
template <typename T, int DW>
__global__ void __launch_bounds__(kQTile * Simt<DW>::kSplit)
masked_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const float* __restrict__ kv_mask, T* __restrict__ o,
                        int q_sb, int q_st, int k_sb, int k_st, int v_sb,
                        int v_st, int o_sb, int o_st, int Tq, int Tk, int Dh,
                        float scale) {
  constexpr int S = Simt<DW>::kSplit, C = Simt<DW>::kCols, KT = kKTile / S;
  __shared__ __align__(16) float ks[KT][DW];
  __shared__ __align__(16) float vs[KT][DW];
  __shared__ float bias[KT];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int tid = threadIdx.x, c0 = (tid % S) * C;
  const int row = blockIdx.x * kQTile + tid / S;
  const bool live = row < Tq;

  // this thread's columns of the q row in registers, zero-padded past Dh
  // and pre-scaled.
  float qr[C];
  const T* qp = q + (long long)b * q_sb + (long long)row * q_st + h * Dh + c0;
#pragma unroll
  for (int d = 0; d < C; ++d)
    qr[d] = (live && c0 + d < Dh) ? to_float(qp[d]) * scale : 0.f;

  float acc[C];
#pragma unroll
  for (int d = 0; d < C; ++d) acc[d] = 0.f;
  float m = -INFINITY;  // running max (true -inf only before the first key)
  float l = 0.f;        // running sum of exp

  const T* kb = k + (long long)b * k_sb + h * Dh;
  const T* vb = v + (long long)b * v_sb + h * Dh;
  const float* mb = kv_mask + (long long)b * Tk;

  for (int j0 = 0; j0 < Tk; j0 += KT) {
    __syncthreads();  // previous tile fully consumed
    for (int idx = tid; idx < KT * DW; idx += kQTile * S) {
      const int j = idx / DW, d = idx % DW;
      const bool in = (j0 + j < Tk) && d < Dh;
      ks[j][d] = in ? to_float(kb[(long long)(j0 + j) * k_st + d]) : 0.f;
      vs[j][d] = in ? to_float(vb[(long long)(j0 + j) * v_st + d]) : 0.f;
    }
    if (tid < KT) {
      const int j = j0 + tid;
      // keys past Tk take no part at all (true -inf -> p = 0); masked keys
      // inside Tk get the finite NEG_INF bias, as in the TPU kernel.
      bias[tid] = j < Tk ? (mb[j] > 0.f ? 0.f : kNegInf) : -INFINITY;
    }
    __syncthreads();

#pragma unroll
    for (int s0 = 0; s0 < KT; s0 += kSub) {
      float s[kSub];
      float smax = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < kSub; ++jj) {
        const float4* kr = reinterpret_cast<const float4*>(ks[s0 + jj] + c0);
        float dot = 0.f;
#pragma unroll
        for (int d4 = 0; d4 < C / 4; ++d4) {
          const float4 kv4 = kr[d4];
          dot += qr[4 * d4] * kv4.x + qr[4 * d4 + 1] * kv4.y +
                 qr[4 * d4 + 2] * kv4.z + qr[4 * d4 + 3] * kv4.w;
        }
        s[jj] = row_sum<S>(dot) + bias[s0 + jj];
        smax = fmaxf(smax, s[jj]);
      }
      if (smax == -INFINITY) continue;  // sub-tile wholly past Tk
      const float m_new = fmaxf(m, smax);
      const float corr = expf(m - m_new);  // 0 on the first sub-tile
      l *= corr;
#pragma unroll
      for (int d = 0; d < C; ++d) acc[d] *= corr;
#pragma unroll
      for (int jj = 0; jj < kSub; ++jj) {
        const float p = expf(s[jj] - m_new);
        l += p;
        const float pr = round_like(p, q);
        const float4* vr = reinterpret_cast<const float4*>(vs[s0 + jj] + c0);
#pragma unroll
        for (int d4 = 0; d4 < C / 4; ++d4) {
          const float4 vv = vr[d4];
          acc[4 * d4] += pr * vv.x;
          acc[4 * d4 + 1] += pr * vv.y;
          acc[4 * d4 + 2] += pr * vv.z;
          acc[4 * d4 + 3] += pr * vv.w;
        }
      }
      m = m_new;
    }
  }

  if (!live) return;
  const float inv = 1.f / l;
  T* op = o + (long long)b * o_sb + (long long)row * o_st + h * Dh + c0;
#pragma unroll
  for (int d = 0; d < C; ++d)
    if (c0 + d < Dh) store(op + d, acc[d] * inv);
}

template <typename T, int DW>
int launch_at(const void* q, const void* k, const void* v, const float* mask, void* o,
              int q_sb, int q_st, int k_sb, int k_st, int v_sb, int v_st, int o_sb, int o_st,
              int B, int Tq, int Tk, int H, int Dh, float scale, cudaStream_t stream) {
  const dim3 grid((Tq + kQTile - 1) / kQTile, H, B);
  masked_attention_kernel<T, DW><<<grid, kQTile * Simt<DW>::kSplit, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<T*>(o), q_sb, q_st, k_sb,
      k_st, v_sb, v_st, o_sb, o_st, Tq, Tk, Dh, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* mask,
           void* o, int q_sb, int q_st, int k_sb, int k_st, int v_sb, int v_st,
           int o_sb, int o_st, int B, int Tq, int Tk, int H, int Dh, float scale,
           cudaStream_t stream) {
#define MA_SIMT(DW) \
  launch_at<T, DW>(q, k, v, mask, o, q_sb, q_st, k_sb, k_st, v_sb, v_st, o_sb, o_st, B, Tq, \
                   Tk, H, Dh, scale, stream)
  switch (hopper::simt_width(Dh)) {
    case 8: return MA_SIMT(8);
    case 16: return MA_SIMT(16);
    case 32: return MA_SIMT(32);
    case 64: return MA_SIMT(64);
    case 128: return MA_SIMT(128);
    default: return MA_SIMT(256);
  }
#undef MA_SIMT
}

bool args_ok(int B, int Tq, int Tk, int H, int Dh, int dtype, float scale) {
  return B >= 1 && Tq >= 1 && Tk >= 1 && H >= 1 && H <= 65535 && B <= 65535 &&
         (dtype == 0 || dtype == 1) && hopper::kernel_width(Dh, dtype) && scale > 0.f &&
         scale < INFINITY;
}

// The launcher's route: 1 = tensor cores (hopper::launch_fwd), 0 = SIMT.
bool route(const void* q, const void* k, const void* v, const void* o, int q_sb, int q_st,
           int k_sb, int k_st, int v_sb, int v_st, int o_sb, int o_st, int B, int Tq, int Tk,
           int dtype) {
  using hopper::tma_ok;
  return hopper::tensor_core_route(
      dtype,
      tma_ok(q, B, q_sb, Tq, q_st) && tma_ok(k, B, k_sb, Tk, k_st) &&
          tma_ok(v, B, v_sb, Tk, v_st) && tma_ok(o, B, o_sb, Tq, o_st));
}

}  // namespace

// Strides are in elements; the head and Dh dimensions are dense (head
// stride Dh, element stride 1).  dtype: 0 = float32, 1 = bfloat16.  scale:
// the scores' factor, Dh^-0.5 of the true head width (a zero-padded copy's
// Dh is wider).
// Returns cudaGetLastError() after the launch (0 = launched), -1 when the
// arguments are outside what the kernel takes, or another nonzero code
// when a TMA tensor map cannot be encoded.  *route_out (when not null) is
// set to the route taken: 1 = tensor cores, 0 = SIMT.
extern "C" int masked_attention_fwd(const void* q, const void* k,
                                    const void* v, const void* kv_mask,
                                    void* o, int q_sb, int q_st, int k_sb,
                                    int k_st, int v_sb, int v_st, int o_sb,
                                    int o_st, int B, int Tq, int Tk, int H,
                                    int Dh, int dtype, float scale, void* stream,
                                    int* route_out) {
  if (!args_ok(B, Tq, Tk, H, Dh, dtype, scale)) return -1;
  const float* mask = static_cast<const float*>(kv_mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool tc =
      route(q, k, v, o, q_sb, q_st, k_sb, k_st, v_sb, v_st, o_sb, o_st, B, Tq, Tk, dtype);
  if (route_out != nullptr) *route_out = tc ? 1 : 0;
  if (tc)
    return hopper::launch_fwd_at<false>(Dh, q, k, v, mask, o, nullptr, q_sb, q_st, k_sb, k_st,
                                        v_sb, v_st, o_sb, o_st, B, Tq, Tk, H, 0, scale, s);
  if (dtype == 0)
    return launch<float>(q, k, v, mask, o, q_sb, q_st, k_sb, k_st, v_sb, v_st,
                         o_sb, o_st, B, Tq, Tk, H, Dh, scale, s);
  return launch<__nv_bfloat16>(q, k, v, mask, o, q_sb, q_st, k_sb, k_st,
                               v_sb, v_st, o_sb, o_st, B, Tq, Tk, H, Dh, scale, s);
}
