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
// The bf16, Dh = 64, 16-byte aligned path (every call of the serving path)
// is the forward mainloop of csrc/hopper_attention.cuh, shared with the
// training kernel's forward (here without the log-sum-exp and causality).
// Against what held the mma.sync version back:
//  1. loads: a producer warp keeps a 3-stage ring of K/V tiles filled by
//     TMA (full/empty mbarriers), so loads run under the products; Q is
//     loaded once per block;
//  2. transposed V: V lands in shared memory with the 128-byte swizzle and
//     wgmma reads it transposed through an MN-major descriptor -- no scalar
//     16-bit loads or packing by hand;
//  3. products: S = Q·Kᵀ (both from shared memory) and O += P·V (P in bf16
//     straight from the score accumulators) are warpgroup wgmma m64n64k16;
//     S of tile k goes out with P·V of tile k-1, and the softmax of tile k
//     runs under that P·V;
//  4. exponents: one multiply by Dh^-0.5·log2 e and exp2f per score;
//  5. causality: none here (kernel 1 is never causal);
//  6. no D pass (forward only).
// One consumer warpgroup of 64 query rows per block (hopper_attention.cuh):
// DiT serving at B = 4 gives only 192 blocks, and two warpgroups per block
// measured slower at every serving shape, the NAR's included.
// Everything else (fp32, other head widths, unaligned views): one thread
// per query row on the CUDA cores in fp32, q and the output accumulators in
// registers, K/V tiles read from shared memory as broadcasts.  fp32 inputs
// take this path so that they are summed in fp32 throughout.
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
constexpr int kDhMax = 64;   // head width held in registers (Dh <= 64)
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

template <typename T>
__global__ void __launch_bounds__(kQTile)
masked_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const float* __restrict__ kv_mask, T* __restrict__ o,
                        int q_sb, int q_st, int k_sb, int k_st, int v_sb,
                        int v_st, int o_sb, int o_st, int Tq, int Tk, int Dh,
                        float scale) {
  __shared__ __align__(16) float ks[kKTile][kDhMax];
  __shared__ __align__(16) float vs[kKTile][kDhMax];
  __shared__ float bias[kKTile];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int row = blockIdx.x * kQTile + threadIdx.x;
  const bool live = row < Tq;

  // q row in registers, zero-padded past Dh and pre-scaled.
  float qr[kDhMax];
  const T* qp = q + (long long)b * q_sb + (long long)row * q_st + h * Dh;
#pragma unroll
  for (int d = 0; d < kDhMax; ++d)
    qr[d] = (live && d < Dh) ? to_float(qp[d]) * scale : 0.f;

  float acc[kDhMax];
#pragma unroll
  for (int d = 0; d < kDhMax; ++d) acc[d] = 0.f;
  float m = -INFINITY;  // running max (true -inf only before the first key)
  float l = 0.f;        // running sum of exp

  const T* kb = k + (long long)b * k_sb + h * Dh;
  const T* vb = v + (long long)b * v_sb + h * Dh;
  const float* mb = kv_mask + (long long)b * Tk;

  for (int j0 = 0; j0 < Tk; j0 += kKTile) {
    __syncthreads();  // previous tile fully consumed
    for (int idx = threadIdx.x; idx < kKTile * kDhMax; idx += kQTile) {
      const int j = idx / kDhMax, d = idx % kDhMax;
      const bool in = (j0 + j < Tk) && d < Dh;
      ks[j][d] = in ? to_float(kb[(long long)(j0 + j) * k_st + d]) : 0.f;
      vs[j][d] = in ? to_float(vb[(long long)(j0 + j) * v_st + d]) : 0.f;
    }
    if (threadIdx.x < kKTile) {
      const int j = j0 + threadIdx.x;
      // keys past Tk take no part at all (true -inf -> p = 0); masked keys
      // inside Tk get the finite NEG_INF bias, as in the TPU kernel.
      bias[threadIdx.x] =
          j < Tk ? (mb[j] > 0.f ? 0.f : kNegInf) : -INFINITY;
    }
    __syncthreads();

#pragma unroll
    for (int s0 = 0; s0 < kKTile; s0 += kSub) {
      float s[kSub];
      float smax = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < kSub; ++jj) {
        const float4* kr = reinterpret_cast<const float4*>(ks[s0 + jj]);
        float dot = 0.f;
#pragma unroll
        for (int d4 = 0; d4 < kDhMax / 4; ++d4) {
          const float4 kv4 = kr[d4];
          dot += qr[4 * d4] * kv4.x + qr[4 * d4 + 1] * kv4.y +
                 qr[4 * d4 + 2] * kv4.z + qr[4 * d4 + 3] * kv4.w;
        }
        s[jj] = dot + bias[s0 + jj];
        smax = fmaxf(smax, s[jj]);
      }
      if (smax == -INFINITY) continue;  // sub-tile wholly past Tk
      const float m_new = fmaxf(m, smax);
      const float corr = expf(m - m_new);  // 0 on the first sub-tile
      l *= corr;
#pragma unroll
      for (int d = 0; d < kDhMax; ++d) acc[d] *= corr;
#pragma unroll
      for (int jj = 0; jj < kSub; ++jj) {
        const float p = expf(s[jj] - m_new);
        l += p;
        const float pr = round_like(p, q);
        const float4* vr = reinterpret_cast<const float4*>(vs[s0 + jj]);
#pragma unroll
        for (int d4 = 0; d4 < kDhMax / 4; ++d4) {
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
  T* op = o + (long long)b * o_sb + (long long)row * o_st + h * Dh;
#pragma unroll
  for (int d = 0; d < kDhMax; ++d)
    if (d < Dh) store(op + d, acc[d] * inv);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* mask,
           void* o, int q_sb, int q_st, int k_sb, int k_st, int v_sb, int v_st,
           int o_sb, int o_st, int B, int Tq, int Tk, int H, int Dh,
           cudaStream_t stream) {
  const dim3 grid((Tq + kQTile - 1) / kQTile, H, B);
  masked_attention_kernel<T><<<grid, kQTile, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<T*>(o), q_sb, q_st, k_sb,
      k_st, v_sb, v_st, o_sb, o_st, Tq, Tk, Dh, rsqrtf((float)Dh));
  return (int)cudaGetLastError();
}

}  // namespace

// Strides are in elements; the head and Dh dimensions are dense (head
// stride Dh, element stride 1).  dtype: 0 = float32, 1 = bfloat16.
// Returns cudaGetLastError() after the launch (0 = launched), -1 when the
// arguments are outside what the kernel takes, or another nonzero code
// when a TMA tensor map cannot be encoded.
extern "C" int masked_attention_fwd(const void* q, const void* k,
                                    const void* v, const void* kv_mask,
                                    void* o, int q_sb, int q_st, int k_sb,
                                    int k_st, int v_sb, int v_st, int o_sb,
                                    int o_st, int B, int Tq, int Tk, int H,
                                    int Dh, int dtype, void* stream) {
  if (B < 1 || Tq < 1 || Tk < 1 || H < 1 || H > 65535 || B > 65535 ||
      Dh < 1 || Dh > kDhMax || Dh % 8 != 0)
    return -1;
  const float* mask = static_cast<const float*>(kv_mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, mask, o, q_sb, q_st, k_sb, k_st, v_sb, v_st,
                         o_sb, o_st, B, Tq, Tk, H, Dh, s);
  if (dtype == 1 && Dh == hopper::kDh && hopper::tma_ok(q, B, q_sb, Tq, q_st) &&
      hopper::tma_ok(k, B, k_sb, Tk, k_st) && hopper::tma_ok(v, B, v_sb, Tk, v_st) &&
      hopper::tma_ok(o, B, o_sb, Tq, o_st))
    return hopper::launch_fwd<false>(q, k, v, mask, o, nullptr, q_sb, q_st, k_sb, k_st,
                                     v_sb, v_st, o_sb, o_st, B, Tq, Tk, H, 0, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, mask, o, q_sb, q_st, k_sb, k_st,
                                 v_sb, v_st, o_sb, o_st, B, Tq, Tk, H, Dh, s);
  return -1;
}
