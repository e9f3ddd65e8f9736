// Key-masked (optionally slot-causal) flash attention for training, forward
// and backward, for Hopper (sm_90a).
//
// Replaces tts_with_diffusion_model_tpu/ops/attention.py::_train_flash_attention,
// which calls the library Pallas TPU kernel
// jax.experimental.pallas.ops.tpu.flash_attention (forward, dq, dk, dv).
// Same function, per (batch b, head h):
//   s_ij = q_i·k_j·Dh^-0.5 in fp32
//   s_ij stays where key j is valid (kv_mask[b, j] > 0) and, with `causal`,
//        j <= i; every other score is *replaced* by NEG_INF = -0.7·FLT_MAX
//   p = softmax(s) over the Tk keys;  o = p·v
// A row whose keys are all masked gets the finite uniform row 1/Tk (never
// NaN).  The gradient stops at replaced scores, as JAX's where(mask, s,
// NEG_INF) does: dS is 0 there, while P (uniform on an all-masked row)
// still feeds dV.  Inputs and outputs keep the (B, T, H, Dh) layout with
// batch and time strides as arguments and no transposes; Tq and Tk are
// ragged (no padding to multiples of 128).  fp32 and bf16 inputs, fp32
// sums; p is rounded to v's dtype before p·v, as the TPU kernel does.
//
// The work is split as FlashAttention-2 splits it:
//  * forward: online softmax per query tile; writes O and the row
//    log-sum-exp L = m + log(l) (fp32, (B, H, Tq)).  On an all-masked row
//    L == NEG_INF exactly, which is how the backward recognises it.
//  * backward: D_i = dO_i·O_i (one pass); dK/dV per key tile, looping over
//    the query tiles and recomputing P from L; dQ per query tile, looping
//    over the key tiles.  No atomics: dQ, dK and dV each have one writer
//    and a fixed order of sums, so the result is deterministic (the JAX
//    reference is, and the tests compare against it).  dS is formed in fp32.
//
// What bounds it on the card.  At the D3PM training sites (B=32, H=8,
// Dh=64, Tq, Tk <= 398) one forward moves at most ~52 MB in bf16 (q, k, v,
// o) and does up to ~10 GFLOP, so the bytes (16 µs at 3.35 TB/s) and the
// tensor cores (10 µs at 989 TF/s) are close; the backward moves twice the
// bytes and does 2.5x the operations.  The (Tq, Tk) scores and
// probabilities never reach device memory (the only scratch is L and D, 8
// bytes per query row).
//
// The bf16 path at every multiple of 8 up to 256 (hopper::kernel_width) with
// 16-byte aligned views (every call of the training paths, the Gaussian
// family's and the Dh-128 and Dh-256 models' included; the wrapper pads
// another width to the next multiple of 8) is built from
// csrc/hopper_attention.cuh, instantiated at 8, 16, 32, 64, 128 and 256 (a
// width between them runs at the next one up, the columns past Dh
// zero-filled by TMA and never stored); against what held the mma.sync
// version back:
//  1. loads: each block has a producer warp that keeps a ring of 64-row
//     tiles filled by TMA (3 stages in the forward and the backward; 2 in
//     the backward at DH 256, whose 3 would exceed a block's shared memory),
//     full/empty mbarriers in between, so the next tile's load runs under
//     the current tile's products;
//  2. transposed operands: the tiles land in shared memory with the
//     swizzle of their row width and wgmma reads V, dO, Q and K transposed
//     through MN-major descriptors -- no scalar 16-bit loads, no packing by
//     hand;
//  3. products: every product is a warpgroup wgmma (S, dP, Sᵀ, dPᵀ
//     m64n64k16 from shared memory over DH / 16 k-steps, Dh 8 padded with a
//     zeroed block; P·V, Pᵀ·dO, dSᵀ·Q, dS·K m64nDHk16 with P or dS in
//     registers, straight from the score accumulators); the forward issues
//     S of tile k with P·V of tile k-1 and runs the softmax of tile k under
//     that P·V (one consumer warpgroup per block, three or four blocks per
//     SM, so the products of one block also run under another's softmax;
//     one at DH 128, whose ring fills half the SM's shared memory, and at
//     256); at DH 256 two dK/dV blocks share a key tile, each holding half
//     of dK's and dV's columns (bwd_dkdv_wgmma_kernel);
//  4. exponents: scores are pre-scaled by Dh^-0.5·log2 e in one multiply and
//     exponentiated with exp2f; the backward's per-element work is one
//     exp2f and a select, with no branch: the producer turns L into
//     log2 units (+inf past Tq and on all-masked rows, so exp2 gives 0
//     there) plus a per-row uniform weight (1/Tk on all-masked rows), and
//     the key flags are loaded once per block (dK/dV) or per tile (dQ);
//  5. causality: the forward and dQ stop at the last key tile any row of
//     the block can see, dK/dV starts at the first query tile that can see
//     the block's keys, and only tiles crossing the diagonal mask element
//     by element.  Rows with no visible valid key (below the first valid
//     key) average all Tk values, so their tiles are kept;
//  6. D pass: DH / 8 threads per row with 16-byte loads.
// fp32 and unaligned bf16 views take SIMT kernels: one thread per query row
// (forward, dQ) or per key (dK/dV) on the CUDA cores in fp32 (two at DW
// 128, four at DW 256, each holding 64 columns), rows held at Dh rounded up
// to 8, 16, 32, 64, 128 or 256 (hopper::simt_width) and loaded element by
// element.  Wider heads are refused.
// hopper::tensor_core_route is the rule between the two; each launcher
// reports the route it took.
// Still left: warp-specialised ping-pong between two consumer warpgroups
// (one's softmax under the other's products) and a persistent schedule
// over the (tile, head, batch) grid.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC (ops/_build.py).  Plain C entry points at the end,
// bound with ctypes (ops/train_flash_attention.py).

#include "hopper_attention.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;     // query rows (forward, dQ) or keys (dK/dV) per block
constexpr int kKTile = 64;    // keys staged in shared memory per step
constexpr int kSub = 16;      // keys scored per online-softmax update
constexpr int kQTileB = 16;   // query rows staged per step of the dK/dV loop
constexpr float kNegInf = -0.7f * FLT_MAX;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
// p rounded to the value dtype before a product with v or dO; no-op for fp32
__device__ __forceinline__ float round_like(float x, const float*) { return x; }
__device__ __forceinline__ float round_like(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

struct Strides {
  int q_sb, q_st, k_sb, k_st, v_sb, v_st, o_sb, o_st;
};

// key flag: 1 valid, 0 masked (NEG_INF), -1 past Tk (takes no part)
__device__ __forceinline__ float key_flag(const float* mb, int j, int Tk) {
  return j < Tk ? (mb[j] > 0.f ? 1.f : 0.f) : -1.f;
}

// ---------------------------------------------------------------------------
// The SIMT kernels (hopper::Simt: a row at DW, two threads at DW 128, four
// at 256).
using hopper::row_sum;
using hopper::Simt;

// Forward, CUDA cores: one thread (hopper::Simt's kSplit) per query row.

template <typename T, int DW>
__global__ void __launch_bounds__(kRows * Simt<DW>::kSplit)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const float* __restrict__ kv_mask,
           T* __restrict__ o, float* __restrict__ lse, Strides st, int Tq,
           int Tk, int H, int Dh, int causal, float scale) {
  constexpr int S = Simt<DW>::kSplit, C = Simt<DW>::kCols, KT = kKTile / S;
  __shared__ __align__(16) float ks[KT][DW];
  __shared__ __align__(16) float vs[KT][DW];
  __shared__ float flag[KT];

  const int b = blockIdx.z, h = blockIdx.y;
  const int tid = threadIdx.x, c0 = (tid % S) * C;
  const int row = blockIdx.x * kRows + tid / S;
  const bool live = row < Tq;

  float qr[C];
  const T* qp = q + (long long)b * st.q_sb + (long long)row * st.q_st + h * Dh + c0;
#pragma unroll
  for (int d = 0; d < C; ++d)
    qr[d] = (live && c0 + d < Dh) ? to_float(qp[d]) * scale : 0.f;
  float acc[C];
#pragma unroll
  for (int d = 0; d < C; ++d) acc[d] = 0.f;
  float m = -INFINITY, l = 0.f;

  const T* kb = k + (long long)b * st.k_sb + h * Dh;
  const T* vb = v + (long long)b * st.v_sb + h * Dh;
  const float* mb = kv_mask + (long long)b * Tk;

  for (int j0 = 0; j0 < Tk; j0 += KT) {
    __syncthreads();
    for (int idx = tid; idx < KT * DW; idx += kRows * S) {
      const int j = idx / DW, d = idx % DW;
      const bool in = (j0 + j < Tk) && d < Dh;
      ks[j][d] = in ? to_float(kb[(long long)(j0 + j) * st.k_st + d]) : 0.f;
      vs[j][d] = in ? to_float(vb[(long long)(j0 + j) * st.v_st + d]) : 0.f;
    }
    if (tid < KT) flag[tid] = key_flag(mb, j0 + tid, Tk);
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
          const float4 k4 = kr[d4];
          dot += qr[4 * d4] * k4.x + qr[4 * d4 + 1] * k4.y +
                 qr[4 * d4 + 2] * k4.z + qr[4 * d4 + 3] * k4.w;
        }
        dot = row_sum<S>(dot);
        const float f = flag[s0 + jj];
        const bool vis = f > 0.f && (!causal || j0 + s0 + jj <= row);
        s[jj] = vis ? dot : (f < 0.f ? -INFINITY : kNegInf);
        smax = fmaxf(smax, s[jj]);
      }
      if (smax == -INFINITY) continue;  // sub-tile wholly past Tk
      const float m_new = fmaxf(m, smax);
      const float corr = expf(m - m_new);
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
          const float4 v4 = vr[d4];
          acc[4 * d4] += pr * v4.x;
          acc[4 * d4 + 1] += pr * v4.y;
          acc[4 * d4 + 2] += pr * v4.z;
          acc[4 * d4 + 3] += pr * v4.w;
        }
      }
      m = m_new;
    }
  }

  if (!live) return;
  const float inv = 1.f / l;
  T* op = o + (long long)b * st.o_sb + (long long)row * st.o_st + h * Dh + c0;
#pragma unroll
  for (int d = 0; d < C; ++d)
    if (c0 + d < Dh) store(op + d, acc[d] * inv);
  if (c0 == 0) lse[((long long)b * H + h) * Tq + row] = m + logf(l);
}

// ---------------------------------------------------------------------------
// Backward.  P_ij = exp(s_ij - L_i) at visible entries, 0 at other entries,
// and 1/Tk on a row whose L is NEG_INF (all keys masked).
// dV_j = Σ_i round(P_ij)·dO_i;  dS_ij = P_ij·(dO_i·v_j − D_i) at visible
// entries, 0 elsewhere;  dQ_i = scale·Σ_j dS_ij·k_j;  dK_j = scale·Σ_i dS_ij·q_i.

// D_i = Σ_d dO_id·O_id, one thread per (b, i, h) row, fp32.
template <typename T>
__global__ void bwd_delta_kernel(const T* __restrict__ o,
                                 const T* __restrict__ dout,
                                 float* __restrict__ delta, int o_sb, int o_st,
                                 int do_sb, int do_st, int B, int Tq, int H,
                                 int Dh) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= (long long)B * Tq * H) return;
  const int h = (int)(r % H);
  const int i = (int)((r / H) % Tq);
  const int b = (int)(r / ((long long)H * Tq));
  const T* op = o + (long long)b * o_sb + (long long)i * o_st + h * Dh;
  const T* dp = dout + (long long)b * do_sb + (long long)i * do_st + h * Dh;
  float acc = 0.f;
  for (int d = 0; d < Dh; ++d) acc += to_float(op[d]) * to_float(dp[d]);
  delta[((long long)b * H + h) * Tq + i] = acc;
}

// dK, dV: one thread (kSplit) per key; q / dO rows staged kQTileB /
// kSplit at a time.
template <typename T, int DW>
__global__ void __launch_bounds__(kRows)
bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ kv_mask,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dk,
                T* __restrict__ dv, Strides st, int do_sb, int do_st, int Tq,
                int Tk, int H, int Dh, int causal, float scale) {
  constexpr int S = Simt<DW>::kSplit, C = Simt<DW>::kCols;
  constexpr int NK = kRows / S, QB = kQTileB / S;  // keys per block, rows per stage
  __shared__ float ksm[NK][DW + 1];
  __shared__ float vsm[NK][DW + 1];
  __shared__ __align__(16) float qs[QB][DW];
  __shared__ __align__(16) float dos[QB][DW];
  __shared__ float ls[QB], ds_[QB];

  const int b = blockIdx.z, h = blockIdx.y;
  const int tid = threadIdx.x, kr = tid / S, c0 = (tid % S) * C;
  const int j = blockIdx.x * NK + kr;
  const bool live = j < Tk;
  const float* mb = kv_mask + (long long)b * Tk;
  const bool valid = live && mb[j] > 0.f;
  const float inv_tk = 1.f / (float)Tk;

  // this block's K and V rows, fp32, zero-padded past Dh
  for (int idx = tid; idx < NK * DW; idx += kRows) {
    const int r = idx / DW, d = idx % DW;
    const int jr = blockIdx.x * NK + r;
    const bool in = jr < Tk && d < Dh;
    ksm[r][d] = in ? to_float(k[(long long)b * st.k_sb + (long long)jr * st.k_st + h * Dh + d]) : 0.f;
    vsm[r][d] = in ? to_float(v[(long long)b * st.v_sb + (long long)jr * st.v_st + h * Dh + d]) : 0.f;
  }

  float dka[C], dva[C];
#pragma unroll
  for (int d = 0; d < C; ++d) dka[d] = dva[d] = 0.f;

  const float* lb = lse + ((long long)b * H + h) * Tq;
  const float* db = delta + ((long long)b * H + h) * Tq;
  const float* kk = ksm[kr] + c0;
  const float* vk = vsm[kr] + c0;
  for (int i0 = 0; i0 < Tq; i0 += QB) {
    __syncthreads();
    for (int idx = tid; idx < QB * DW; idx += kRows) {
      const int r = idx / DW, d = idx % DW;
      const int ir = i0 + r;
      const bool in = ir < Tq && d < Dh;
      qs[r][d] = in ? to_float(q[(long long)b * st.q_sb + (long long)ir * st.q_st + h * Dh + d]) : 0.f;
      dos[r][d] = in ? to_float(dout[(long long)b * do_sb + (long long)ir * do_st + h * Dh + d]) : 0.f;
    }
    if (tid < QB) {
      const int ir = i0 + tid;
      ls[tid] = ir < Tq ? lb[ir] : 0.f;
      ds_[tid] = ir < Tq ? db[ir] : 0.f;
    }
    __syncthreads();
    if (!live) continue;
    const int n_rows = min(QB, Tq - i0);
    for (int r = 0; r < n_rows; ++r) {
      const int i = i0 + r;
      const float Li = ls[r];
      const float4* q4 = reinterpret_cast<const float4*>(qs[r] + c0);
      const float4* do4 = reinterpret_cast<const float4*>(dos[r] + c0);
      if (Li == kNegInf) {  // all keys masked: uniform P, no dS
        const float pr = round_like(inv_tk, q);
#pragma unroll
        for (int d4 = 0; d4 < C / 4; ++d4) {
          const float4 g4 = do4[d4];
          dva[4 * d4] += pr * g4.x;
          dva[4 * d4 + 1] += pr * g4.y;
          dva[4 * d4 + 2] += pr * g4.z;
          dva[4 * d4 + 3] += pr * g4.w;
        }
        continue;
      }
      if (!valid || (causal && j > i)) continue;  // P = 0, dS = 0
      float dot = 0.f, dpv = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < C / 4; ++d4) {
        const float4 a = q4[d4], g4 = do4[d4];
        dot += a.x * kk[4 * d4] + a.y * kk[4 * d4 + 1] +
               a.z * kk[4 * d4 + 2] + a.w * kk[4 * d4 + 3];
        dpv += g4.x * vk[4 * d4] + g4.y * vk[4 * d4 + 1] +
               g4.z * vk[4 * d4 + 2] + g4.w * vk[4 * d4 + 3];
      }
      dot = row_sum<S>(dot);
      dpv = row_sum<S>(dpv);
      const float p = expf(dot * scale - Li);
      const float pr = round_like(p, q);
      const float dsv = p * (dpv - ds_[r]);
#pragma unroll
      for (int d4 = 0; d4 < C / 4; ++d4) {
        const float4 a = q4[d4], g4 = do4[d4];
        dva[4 * d4] += pr * g4.x;
        dva[4 * d4 + 1] += pr * g4.y;
        dva[4 * d4 + 2] += pr * g4.z;
        dva[4 * d4 + 3] += pr * g4.w;
        dka[4 * d4] += dsv * a.x;
        dka[4 * d4 + 1] += dsv * a.y;
        dka[4 * d4 + 2] += dsv * a.z;
        dka[4 * d4 + 3] += dsv * a.w;
      }
    }
  }
  if (!live) return;
  // dK, dV are dense (B, Tk, H, Dh)
  const long long base = ((long long)b * Tk + j) * H * Dh + (long long)h * Dh + c0;
#pragma unroll
  for (int d = 0; d < C; ++d) {
    if (c0 + d < Dh) {
      store(dk + base + d, dka[d] * scale);
      store(dv + base + d, dva[d]);
    }
  }
}

// dQ: one thread (kSplit) per query row; K / V tiles staged in
// shared memory.
template <typename T, int DW>
__global__ void __launch_bounds__(kRows * Simt<DW>::kSplit)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const float* __restrict__ kv_mask,
              const T* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta, T* __restrict__ dq, Strides st,
              int do_sb, int do_st, int Tq, int Tk, int H, int Dh, int causal,
              float scale) {
  constexpr int S = Simt<DW>::kSplit, C = Simt<DW>::kCols, KT = kKTile / S;
  __shared__ __align__(16) float ks[KT][DW];
  __shared__ __align__(16) float vs[KT][DW];
  __shared__ float flag[KT];

  const int b = blockIdx.z, h = blockIdx.y;
  const int tid = threadIdx.x, c0 = (tid % S) * C;
  const int i = blockIdx.x * kRows + tid / S;
  const bool live = i < Tq;
  const float Li = live ? lse[((long long)b * H + h) * Tq + i] : 0.f;
  const float Di = live ? delta[((long long)b * H + h) * Tq + i] : 0.f;
  // an all-masked row has dS = 0 everywhere: dQ stays 0
  const bool work = live && Li != kNegInf;

  float qr[C], gr[C], acc[C];
  const T* qp = q + (long long)b * st.q_sb + (long long)i * st.q_st + h * Dh + c0;
  const T* gp = dout + (long long)b * do_sb + (long long)i * do_st + h * Dh + c0;
#pragma unroll
  for (int d = 0; d < C; ++d) {
    qr[d] = (work && c0 + d < Dh) ? to_float(qp[d]) : 0.f;
    gr[d] = (work && c0 + d < Dh) ? to_float(gp[d]) : 0.f;
    acc[d] = 0.f;
  }

  const T* kb = k + (long long)b * st.k_sb + h * Dh;
  const T* vb = v + (long long)b * st.v_sb + h * Dh;
  const float* mb = kv_mask + (long long)b * Tk;
  for (int j0 = 0; j0 < Tk; j0 += KT) {
    __syncthreads();
    for (int idx = tid; idx < KT * DW; idx += kRows * S) {
      const int j = idx / DW, d = idx % DW;
      const bool in = (j0 + j < Tk) && d < Dh;
      ks[j][d] = in ? to_float(kb[(long long)(j0 + j) * st.k_st + d]) : 0.f;
      vs[j][d] = in ? to_float(vb[(long long)(j0 + j) * st.v_st + d]) : 0.f;
    }
    if (tid < KT) flag[tid] = key_flag(mb, j0 + tid, Tk);
    __syncthreads();
    if (!work) continue;
    const int n_keys = min(KT, Tk - j0);
    for (int jj = 0; jj < n_keys; ++jj) {
      if (!(flag[jj] > 0.f) || (causal && j0 + jj > i)) continue;
      const float4* k4 = reinterpret_cast<const float4*>(ks[jj] + c0);
      const float4* v4 = reinterpret_cast<const float4*>(vs[jj] + c0);
      float dot = 0.f, dpv = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < C / 4; ++d4) {
        const float4 a = k4[d4], c = v4[d4];
        dot += qr[4 * d4] * a.x + qr[4 * d4 + 1] * a.y +
               qr[4 * d4 + 2] * a.z + qr[4 * d4 + 3] * a.w;
        dpv += gr[4 * d4] * c.x + gr[4 * d4 + 1] * c.y +
               gr[4 * d4 + 2] * c.z + gr[4 * d4 + 3] * c.w;
      }
      dot = row_sum<S>(dot);
      dpv = row_sum<S>(dpv);
      const float p = expf(dot * scale - Li);
      const float dsv = p * (dpv - Di);
#pragma unroll
      for (int d4 = 0; d4 < C / 4; ++d4) {
        const float4 a = k4[d4];
        acc[4 * d4] += dsv * a.x;
        acc[4 * d4 + 1] += dsv * a.y;
        acc[4 * d4 + 2] += dsv * a.z;
        acc[4 * d4 + 3] += dsv * a.w;
      }
    }
  }
  if (!live) return;
  T* out = dq + ((long long)b * Tq + i) * H * Dh + (long long)h * Dh + c0;
#pragma unroll
  for (int d = 0; d < C; ++d)
    if (c0 + d < Dh) store(out + d, acc[d] * scale);
}


// ---------------------------------------------------------------------------
// Backward on the Hopper path: bf16, DH = 8, 16, 32, 64, 128 or 256, the
// head width Dh <= DH (csrc/hopper_attention.cuh; columns past Dh are zeros).
// P_ij = exp2(s_ij·Dh^-0.5·log2 e − L_i·log2 e) at visible entries, 0
// elsewhere, plus 1/Tk on a row whose L is NEG_INF (all keys masked, no dS);
// dV_j = Σ_i round(P_ij)·dO_i;  dS_ij = P_ij·(dO_i·v_j − D_i) at visible
// entries;  dQ_i = scale·Σ_j dS_ij·k_j;  dK_j = scale·Σ_i dS_ij·q_i.

using hopper::Width;

// D_i = Σ_d dO_id·O_id: DH / 8 threads per (b, i, h) row, one 16-byte load
// of o and of dO each (threads past the head width Dh add 0), the partial
// sums reduced by shuffles in a fixed order.
template <int DH>
__global__ void __launch_bounds__(256)
bwd_delta_rows_kernel(const hopper::bf16* __restrict__ o,
                      const hopper::bf16* __restrict__ dout,
                      float* __restrict__ delta, long long o_sb, long long o_st,
                      long long do_sb, long long do_st, int B, int Tq, int H, int Dh) {
  constexpr int P = DH / 8;  // threads per row
  const long long r = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / P;
  const int part = threadIdx.x % P;
  const bool live = r < (long long)B * Tq * H;
  const int h = live ? (int)(r % H) : 0;
  const int i = live ? (int)((r / H) % Tq) : 0;
  const int b = live ? (int)(r / ((long long)H * Tq)) : 0;
  float acc = 0.f;
  if (live && part * 8 < Dh) {
    const uint4 a = *reinterpret_cast<const uint4*>(o + b * o_sb + i * o_st + h * Dh + part * 8);
    const uint4 c =
        *reinterpret_cast<const uint4*>(dout + b * do_sb + i * do_st + h * Dh + part * 8);
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* c2 = reinterpret_cast<const __nv_bfloat162*>(&c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 x = __bfloat1622float2(a2[e]), y = __bfloat1622float2(c2[e]);
      acc += x.x * y.x + x.y * y.y;
    }
  }
#pragma unroll
  for (int off = P / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (live && part == 0) delta[((long long)b * H + h) * Tq + i] = acc;
}

struct BwdParams {
  const float* mask;   // (B, Tk)
  const float* lse;    // (B, H, Tq), natural log
  const float* delta;  // (B, H, Tq)
  hopper::bf16 *dq, *dk, *dv;  // dense (B, T, H, Dh)
  int Tq, Tk, H, Dh, causal;    // Dh: the true head width, at most DH
  float scale, scale_log2, inv_tk;
};

// Per query row, what the dK/dV producer stages beside Q and dO: L in log2
// units (+inf past Tq and on an all-masked row, so exp2 gives 0), D, and
// the uniform weight (1/Tk on an all-masked row, else 0).
__device__ __forceinline__ void row_terms(const BwdParams& p, long long row0, int i,
                                          float* l2, float* dd, float* pu) {
  float L2 = INFINITY, D = 0.f, U = 0.f;
  if (i < p.Tq) {
    const float L = p.lse[row0 + i];
    D = p.delta[row0 + i];
    if (L == hopper::kNegInf)
      U = p.inv_tk;
    else
      L2 = L * hopper::kLog2e;
  }
  *l2 = L2;
  *dd = D;
  *pu = U;
}

template <int DH>
constexpr int dkdv_smem_bytes() {
  constexpr int S = Width<DH>::kBwdStages;
  return 1024 + (2 + 2 * S) * Width<DH>::kTileBytes + Width<DH>::kZeroBytes +
         3 * S * hopper::kRows * 4 + (2 * S + 1) * 8;
}
static_assert(dkdv_smem_bytes<256>() <= 232448, "the DH-256 dK/dV ring exceeds a block's "
              "shared memory");

// dK, dV: one block per (64 keys, column part, head, batch), one consumer
// warpgroup (warps 0..3) and one producer warp (warp 4); K and V tiles
// resident, Q, dO and the row terms stream through the ring.  Sᵀ = K·Qᵀ and
// dPᵀ = V·dOᵀ (SS, m64n64 over DH / 16 k-steps); Pᵀ and dSᵀ are formed in
// the accumulators, which are already in A-operand layout; dV += Pᵀ·dO and
// dK += dSᵀ·Q (RS m64nNC, dO and Q read transposed).  At least two blocks
// per SM (at DH 64, four accumulators of 32 floats a thread); one at DH 128
// (dK and dV 64 floats each).
// DH 256: one warpgroup cannot hold both m64n256 accumulators (128 floats
// each, 256 a thread against the 255-register limit), so the key tile's
// dK and dV are split by columns over kDkdvSplit = 2 blocks, blockIdx.x =
// 2·tile + part: each forms the whole Sᵀ and dPᵀ over the 256 columns and
// accumulates columns 128·part.. of dK and dV (m64n128k16 RS from panel
// 2·part of the Q and dO tiles; 64 + 64 floats a thread, as at DH 128).  Sᵀ
// and dPᵀ are formed twice per key tile: 6 products of 64 x 64 x 256 per
// query tile against the unsplit 4 (1.5x the operations), for twice the
// blocks (the D3PM's cross-attention to 50 text slots gives 64 unsplit
// blocks for 132 SMs) and a block's chain of 3 products, not 4; every
// column of dK and dV keeps one writer and a fixed order of sums, so the
// backward stays deterministic.  At DH 256 (ptxas, sm_90a, CUDA 12.8): 246
// registers, no spill, 199,208 bytes of dynamic shared memory (2 stages);
// the dQ kernel 229 registers, no spill, 198,184 bytes.
template <int DH>
__global__ void __launch_bounds__(160, Width<DH>::kDkdvBlocks)
bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v,
                      const __grid_constant__ CUtensorMap map_do, const BwdParams p) {
  using namespace hopper;
  constexpr int kRows = hopper::kRows;  // the tile, not the SIMT kernels' block
  constexpr float kNegInf = hopper::kNegInf;
  constexpr int kTile = Width<DH>::kTileBytes;
  constexpr int kStages = Width<DH>::kBwdStages;
  constexpr int SPLIT = Width<DH>::kDkdvSplit;
  constexpr int NC = DH / SPLIT;  // columns of dK and dV this block accumulates
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align1024(smem_raw);
  uint8_t* ks = base;
  uint8_t* vs = ks + kTile;
  uint8_t* qs = vs + kTile;
  uint8_t* gs = qs + kStages * kTile;
  uint8_t* zero = gs + kStages * kTile;  // DH 8 only
  float* l2s = reinterpret_cast<float*>(zero + Width<DH>::kZeroBytes);
  float* dds = l2s + kStages * kRows;
  float* pus = dds + kStages * kRows;
  uint64_t* full = reinterpret_cast<uint64_t*>(pus + kStages * kRows);
  uint64_t* empty = full + kStages;
  uint64_t* kvbar = empty + kStages;

  const int b = blockIdx.z, h = blockIdx.y;
  const int j0 = (blockIdx.x / SPLIT) * kRows;
  const int c_base = (blockIdx.x % SPLIT) * NC;  // first column of this block's part
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* mask_b = p.mask + (long long)b * p.Tk;
  const long long row0 = ((long long)b * p.H + h) * p.Tq;

  // Query tiles: all, or under causality those from the first one that
  // can see this block's keys, after the tiles holding rows with no
  // visible valid key (their uniform rows weigh every key).
  const int n_qt = (p.Tq + kRows - 1) / kRows;
  int lead = 0, first = 0;
  if (p.causal) {
    first = min(j0 / kRows, n_qt);
    lead = min((first_valid_key(mask_b, p.Tk, lane) + kRows - 1) / kRows, first);
  }
  const int count = lead + n_qt - first;

  zero_block<DH>(zero);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], 4);
    }
    mbar_init(kvbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4) {  // ---- producer warp
    if (lane == 0) {
      mbar_arrive_tx(kvbar, 2 * kTile);
      tma_load<DH>(ks, &map_k, kvbar, h, j0, b);
      tma_load<DH>(vs, &map_v, kvbar, h, j0, b);
    }
    for (int idx = 0; idx < count; ++idx) {
      const int s = idx % kStages;
      const int i0 = (idx < lead ? idx : first + idx - lead) * kRows;
      mbar_wait(&empty[s], ((idx / kStages) & 1) ^ 1);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = lane + 32 * e;
        row_terms(p, row0, i0 + c, &l2s[s * kRows + c], &dds[s * kRows + c],
                  &pus[s * kRows + c]);
      }
      if (lane == 0) {
        mbar_arrive_tx(&full[s], 2 * kTile);
        tma_load<DH>(qs + s * kTile, &map_q, &full[s], h, i0, b);
        tma_load<DH>(gs + s * kTile, &map_do, &full[s], h, i0, b);
      } else {
        mbar_arrive(&full[s]);
      }
    }
    return;
  }
  // ---- consumer warpgroup: its keys are the accumulator rows
  const int w = warp, g = lane >> 2, t = lane & 3;
  const int kr0 = j0 + 16 * w + g, kr1 = kr0 + 8;
  // key flag: 0 valid, NEG_INF masked, -inf past Tk; in: the key exists
  const float f0 = kr0 < p.Tk ? (mask_b[kr0] > 0.f ? 0.f : kNegInf) : -INFINITY;
  const float f1 = kr1 < p.Tk ? (mask_b[kr1] > 0.f ? 0.f : kNegInf) : -INFINITY;
  const float in0 = kr0 < p.Tk ? 1.f : 0.f, in1 = kr1 < p.Tk ? 1.f : 0.f;
  const uint8_t* k_tile = ks;
  const uint8_t* v_tile = vs;
  const float sl2 = p.scale_log2;

  constexpr int NO = NC / 2;  // dK / dV accumulators a thread
  float dk[NO], dv[NO], st[32], dp[32];
  // the part's first panel of the Q and dO tiles (columns c_base..; 64-row
  // panels of 64 columns lie kRows·64·2 bytes apart)
  const int part_off = c_base * kRows * 2;
#pragma unroll
  for (int i = 0; i < NO; ++i) dk[i] = dv[i] = 0.f;
  mbar_wait(kvbar, 0);

  for (int idx = 0; idx < count; ++idx) {
    const int s = idx % kStages;
    const int i0 = (idx < lead ? idx : first + idx - lead) * kRows;
    mbar_wait(&full[s], (idx / kStages) & 1);
    const uint8_t* q_tile = qs + s * kTile;
    const uint8_t* g_tile = gs + s * kTile;
    wgmma_fence();
    gemm_abt<DH>(st, k_tile, q_tile, zero);  // Sᵀ
    gemm_abt<DH>(dp, v_tile, g_tile, zero);  // dPᵀ
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dp);

    const bool diag = p.causal && j0 + kRows - 1 > i0;
    const float* l2r = l2s + s * kRows;
    const float* ddr = dds + s * kRows;
    const float* pur = pus + s * kRows;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = 8 * c + 2 * t;
      const float2 l2 = *reinterpret_cast<const float2*>(l2r + col);
      const float2 dd = *reinterpret_cast<const float2*>(ddr + col);
      const float2 pu = *reinterpret_cast<const float2*>(pur + col);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = i0 + col + e;
        const float L2 = e ? l2.y : l2.x, D = e ? dd.y : dd.x, U = e ? pu.y : pu.x;
        float x0 = f0 != 0.f ? f0 : st[4 * c + e] * sl2;
        float x1 = f1 != 0.f ? f1 : st[4 * c + 2 + e] * sl2;
        if (diag) {
          if (kr0 > i) x0 = fminf(x0, kNegInf);
          if (kr1 > i) x1 = fminf(x1, kNegInf);
        }
        const float p0 = exp2f(x0 - L2), p1 = exp2f(x1 - L2);
        st[4 * c + e] = p0 + in0 * U;
        st[4 * c + 2 + e] = p1 + in1 * U;
        dp[4 * c + e] = p0 * (dp[4 * c + e] - D);
        dp[4 * c + 2 + e] = p1 * (dp[4 * c + 2 + e] - D);
      }
    }
    uint32_t pa[4][4], sa[4][4];
    to_operand(st, pa);
    to_operand(dp, sa);
    wgmma_fence();
    gemm_pb<DH, NC>(dv, pa, g_tile + part_off);  // dV += Pᵀ·dO
    gemm_pb<DH, NC>(dk, sa, q_tile + part_off);  // dK += dSᵀ·Q
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // dK, dV are dense (B, Tk, H, Dh)
#pragma unroll
  for (int c = 0; c < NC / 8; ++c) {
    const int col = c_base + 8 * c + 2 * t;
    if (c_base + 8 * c >= p.Dh) break;  // zero columns past the head width
    if (kr0 < p.Tk) {
      const long long off = ((long long)b * p.Tk + kr0) * p.H * p.Dh + (long long)h * p.Dh + col;
      *reinterpret_cast<uint32_t*>(p.dk + off) =
          pack_bf16(dk[4 * c] * p.scale, dk[4 * c + 1] * p.scale);
      *reinterpret_cast<uint32_t*>(p.dv + off) = pack_bf16(dv[4 * c], dv[4 * c + 1]);
    }
    if (kr1 < p.Tk) {
      const long long off = ((long long)b * p.Tk + kr1) * p.H * p.Dh + (long long)h * p.Dh + col;
      *reinterpret_cast<uint32_t*>(p.dk + off) =
          pack_bf16(dk[4 * c + 2] * p.scale, dk[4 * c + 3] * p.scale);
      *reinterpret_cast<uint32_t*>(p.dv + off) = pack_bf16(dv[4 * c + 2], dv[4 * c + 3]);
    }
  }
}

template <int DH>
constexpr int dq_smem_bytes() {
  constexpr int S = Width<DH>::kBwdStages;
  return 1024 + (2 + 2 * S) * Width<DH>::kTileBytes + Width<DH>::kZeroBytes +
         S * hopper::kRows * 4 + (2 * S + 1) * 8;
}
static_assert(dq_smem_bytes<256>() <= 232448, "the DH-256 dQ ring exceeds a block's shared "
              "memory");

// dQ: one block per (64 queries, head, batch), one consumer warpgroup
// (warps 0..3) and one producer warp (warp 4); Q and dO tiles resident, K/V tiles and key flags stream through the
// ring.  S = Q·Kᵀ and dP = dO·Vᵀ (SS), dS in the accumulators, dQ += dS·K
// (RS m64nDH, K read transposed).
// At least three blocks per SM; one at DH 128 and 256 (at 256 the m64n256
// dQ accumulator is 128 floats a thread, S and dP 32 each).
template <int DH>
__global__ void __launch_bounds__(160, Width<DH>::kDqBlocks)
bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    const __grid_constant__ CUtensorMap map_do, const BwdParams p) {
  using namespace hopper;
  constexpr int kRows = hopper::kRows;  // the tile, not the SIMT kernels' block
  constexpr float kNegInf = hopper::kNegInf;
  constexpr int kTile = Width<DH>::kTileBytes;
  constexpr int kStages = Width<DH>::kBwdStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align1024(smem_raw);
  uint8_t* qs = base;
  uint8_t* gs = qs + kTile;
  uint8_t* ks = gs + kTile;
  uint8_t* vs = ks + kStages * kTile;
  uint8_t* zero = vs + kStages * kTile;  // DH 8 only
  float* flag = reinterpret_cast<float*>(zero + Width<DH>::kZeroBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(flag + kStages * kRows);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* mask_b = p.mask + (long long)b * p.Tk;
  const long long row0 = ((long long)b * p.H + h) * p.Tq;

  // Key tiles: all, or under causality up to the last one a row of the
  // block can see (rows with no visible valid key have dS = 0 everywhere).
  int n_kt = (p.Tk + kRows - 1) / kRows;
  if (p.causal) n_kt = min(n_kt, (min(p.Tq, q0 + kRows) - 1) / kRows + 1);

  zero_block<DH>(zero);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], 4);
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4) {  // ---- producer warp
    if (lane == 0) {
      mbar_arrive_tx(qbar, 2 * kTile);
      tma_load<DH>(qs, &map_q, qbar, h, q0, b);
      tma_load<DH>(gs, &map_do, qbar, h, q0, b);
    }
    for (int kt = 0; kt < n_kt; ++kt) {
      const int s = kt % kStages;
      mbar_wait(&empty[s], ((kt / kStages) & 1) ^ 1);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = kt * kRows + lane + 32 * e;
        flag[s * kRows + lane + 32 * e] =
            j < p.Tk ? (mask_b[j] > 0.f ? 0.f : kNegInf) : -INFINITY;
      }
      if (lane == 0) {
        mbar_arrive_tx(&full[s], 2 * kTile);
        tma_load<DH>(ks + s * kTile, &map_k, &full[s], h, kt * kRows, b);
        tma_load<DH>(vs + s * kTile, &map_v, &full[s], h, kt * kRows, b);
      } else {
        mbar_arrive(&full[s]);
      }
    }
    return;
  }
  // ---- consumer warpgroup: its queries are the accumulator rows
  const int w = warp, g = lane >> 2, t = lane & 3;
  const int r0 = q0 + 16 * w + g, r1 = r0 + 8;
  float L20, D0, U0, L21, D1, U1;  // U: unused here (all-masked rows have dS = 0)
  row_terms(p, row0, r0, &L20, &D0, &U0);
  row_terms(p, row0, r1, &L21, &D1, &U1);
  const uint8_t* q_tile = qs;
  const uint8_t* g_tile = gs;
  const float sl2 = p.scale_log2;

  constexpr int NO = DH / 2;  // dQ accumulators a thread
  float dq[NO], sc[32], dp[32];
#pragma unroll
  for (int i = 0; i < NO; ++i) dq[i] = 0.f;
  mbar_wait(qbar, 0);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int s = kt % kStages;
    const int j0 = kt * kRows;
    mbar_wait(&full[s], (kt / kStages) & 1);
    const uint8_t* k_tile = ks + s * kTile;
    wgmma_fence();
    gemm_abt<DH>(sc, q_tile, k_tile, zero);             // S
    gemm_abt<DH>(dp, g_tile, vs + s * kTile, zero);     // dP
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);

    const bool diag = p.causal && j0 + kRows - 1 > q0;
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
        if (diag) {
          if (j > r0) x0 = fminf(x0, kNegInf);
          if (j > r1) x1 = fminf(x1, kNegInf);
        }
        dp[4 * c + e] = exp2f(x0 - L20) * (dp[4 * c + e] - D0);
        dp[4 * c + 2 + e] = exp2f(x1 - L21) * (dp[4 * c + 2 + e] - D1);
      }
    }
    uint32_t sa[4][4];
    to_operand(dp, sa);
    wgmma_fence();
    gemm_pb<DH>(dq, sa, k_tile);  // dQ += dS·K
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // dQ is dense (B, Tq, H, Dh)
#pragma unroll
  for (int c = 0; c < DH / 8; ++c) {
    const int col = 8 * c + 2 * t;
    if (8 * c >= p.Dh) break;  // zero columns past the head width
    if (r0 < p.Tq)
      *reinterpret_cast<uint32_t*>(p.dq + ((long long)b * p.Tq + r0) * p.H * p.Dh +
                                   (long long)h * p.Dh + col) =
          pack_bf16(dq[4 * c] * p.scale, dq[4 * c + 1] * p.scale);
    if (r1 < p.Tq)
      *reinterpret_cast<uint32_t*>(p.dq + ((long long)b * p.Tq + r1) * p.H * p.Dh +
                                   (long long)h * p.Dh + col) =
          pack_bf16(dq[4 * c + 2] * p.scale, dq[4 * c + 3] * p.scale);
  }
}

bool args_ok(int B, int Tq, int Tk, int H, int Dh, int dtype, float scale) {
  return B >= 1 && Tq >= 1 && Tk >= 1 && H >= 1 && H <= 65535 && B <= 65535 &&
         (dtype == 0 || dtype == 1) && hopper::kernel_width(Dh, dtype) && scale > 0.f &&
         scale < INFINITY;
}

template <typename T, int DW>
int launch_fwd_simt(const void* q, const void* k, const void* v, const float* mask, void* o,
                    float* lse, Strides st, int B, int Tq, int Tk, int H, int Dh, int causal,
                    float scale, cudaStream_t s) {
  const dim3 grid((Tq + kRows - 1) / kRows, H, B);
  fwd_kernel<T, DW><<<grid, kRows * Simt<DW>::kSplit, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<T*>(o), lse, st, Tq, Tk, H,
      Dh, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, const float* mask,
               void* o, float* lse, Strides st, int B, int Tq, int Tk, int H,
               int Dh, int causal, float scale, cudaStream_t s) {
#define TFA_FWD(DW) \
  launch_fwd_simt<T, DW>(q, k, v, mask, o, lse, st, B, Tq, Tk, H, Dh, causal, scale, s)
  switch (hopper::simt_width(Dh)) {
    case 8: return TFA_FWD(8);
    case 16: return TFA_FWD(16);
    case 32: return TFA_FWD(32);
    case 64: return TFA_FWD(64);
    case 128: return TFA_FWD(128);
    default: return TFA_FWD(256);
  }
#undef TFA_FWD
}

template <typename T, int DW>
int launch_bwd_simt(const void* q, const void* k, const void* v, const float* mask,
                    const float* lse, const void* dout, void* dq, void* dk, void* dv,
                    const float* delta, Strides st, int do_sb, int do_st, int Tq, int Tk,
                    int B, int H, int Dh, int causal, float scale, cudaStream_t s) {
  constexpr int NK = kRows / Simt<DW>::kSplit;  // keys per dK/dV block
  const dim3 gk((Tk + NK - 1) / NK, H, B);
  bwd_dkdv_kernel<T, DW><<<gk, kRows, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), st, do_sb, do_st, Tq, Tk, H,
      Dh, causal, scale);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const dim3 gq((Tq + kRows - 1) / kRows, H, B);
  bwd_dq_kernel<T, DW><<<gq, kRows * Simt<DW>::kSplit, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), st, do_sb, do_st, Tq, Tk, H, Dh, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* q, const void* k, const void* v, const float* mask,
               const void* o, const float* lse, const void* dout, void* dq,
               void* dk, void* dv, float* delta, Strides st, int do_sb,
               int do_st, int B, int Tq, int Tk, int H, int Dh, int causal,
               float scale, cudaStream_t s) {
  const long long rows = (long long)B * Tq * H;
  bwd_delta_kernel<T><<<(unsigned)((rows + 255) / 256), 256, 0, s>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, st.o_sb,
      st.o_st, do_sb, do_st, B, Tq, H, Dh);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
#define TFA_BWD(DW)                                                                       \
  launch_bwd_simt<T, DW>(q, k, v, mask, lse, dout, dq, dk, dv, delta, st, do_sb, do_st, Tq, \
                         Tk, B, H, Dh, causal, scale, s)
  switch (hopper::simt_width(Dh)) {
    case 8: return TFA_BWD(8);
    case 16: return TFA_BWD(16);
    case 32: return TFA_BWD(32);
    case 64: return TFA_BWD(64);
    case 128: return TFA_BWD(128);
    default: return TFA_BWD(256);
  }
#undef TFA_BWD
}

using BwdKernel = void (*)(CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap, BwdParams);

template <BwdKernel kernel>
int launch_bwd_kernel(int smem, int blocks, int H, int B, const CUtensorMap& mq,
                      const CUtensorMap& mk, const CUtensorMap& mv,
                      const CUtensorMap& mdo, const BwdParams& p, cudaStream_t s) {
  static const int attr = hopper::set_smem(kernel, smem);
  if (attr != 0) return attr;
  kernel<<<dim3(blocks, H, B), 160, smem, s>>>(mq, mk, mv, mdo, p);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_bwd_hopper(const void* q, const void* k, const void* v, const float* mask,
                      const void* o, const float* lse, const void* dout, void* dq,
                      void* dk, void* dv, float* delta, const Strides& st, int do_sb,
                      int do_st, int B, int Tq, int Tk, int H, int Dh, int causal,
                      float scale, cudaStream_t s) {
  using hopper::make_map;
  CUtensorMap mq, mk, mv, mdo;
  int rc = make_map<DH>(&mq, q, B, Tq, H, Dh, st.q_sb, st.q_st);
  if (rc == 0) rc = make_map<DH>(&mk, k, B, Tk, H, Dh, st.k_sb, st.k_st);
  if (rc == 0) rc = make_map<DH>(&mv, v, B, Tk, H, Dh, st.v_sb, st.v_st);
  if (rc == 0) rc = make_map<DH>(&mdo, dout, B, Tq, H, Dh, do_sb, do_st);
  if (rc != 0) return rc;
  constexpr int P = DH / 8;  // delta threads per row
  const long long rows = (long long)B * Tq * H;
  bwd_delta_rows_kernel<DH><<<(unsigned)((rows * P + 255) / 256), 256, 0, s>>>(
      static_cast<const hopper::bf16*>(o), static_cast<const hopper::bf16*>(dout), delta,
      st.o_sb, st.o_st, do_sb, do_st, B, Tq, H, Dh);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const BwdParams p{mask, lse, delta, static_cast<hopper::bf16*>(dq),
                    static_cast<hopper::bf16*>(dk), static_cast<hopper::bf16*>(dv),
                    Tq, Tk, H, Dh, causal, scale, scale * hopper::kLog2e, 1.f / (float)Tk};
  constexpr int R = hopper::kRows;
  rc = launch_bwd_kernel<bwd_dkdv_wgmma_kernel<DH>>(
      dkdv_smem_bytes<DH>(), (Tk + R - 1) / R * Width<DH>::kDkdvSplit, H, B, mq, mk, mv, mdo,
      p, s);
  if (rc != 0) return rc;
  return launch_bwd_kernel<bwd_dq_wgmma_kernel<DH>>(dq_smem_bytes<DH>(), (Tq + R - 1) / R, H,
                                                    B, mq, mk, mv, mdo, p, s);
}

using hopper::tma_ok;

// The forward launcher's route: 1 = tensor cores, 0 = SIMT.
bool fwd_route(const void* q, const void* k, const void* v, const void* o, const Strides& st,
               int B, int Tq, int Tk, int dtype) {
  return hopper::tensor_core_route(
      dtype,
      tma_ok(q, B, st.q_sb, Tq, st.q_st) && tma_ok(k, B, st.k_sb, Tk, st.k_st) &&
          tma_ok(v, B, st.v_sb, Tk, st.v_st) && tma_ok(o, B, st.o_sb, Tq, st.o_st));
}

// The backward launcher's route: the forward's, with dO aligned too.
bool bwd_route(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const Strides& st, int do_sb, int do_st, int B, int Tq, int Tk, int dtype) {
  return fwd_route(q, k, v, o, st, B, Tq, Tk, dtype) && tma_ok(dout, B, do_sb, Tq, do_st);
}

}  // namespace

// Strides are in elements; the head and Dh dimensions are dense (head
// stride Dh, element stride 1).  dtype: 0 = float32, 1 = bfloat16.
// causal: 0 or 1.  scale: the scores' factor, Dh^-0.5 of the true head
// width (a zero-padded copy's Dh is wider).  Each entry returns cudaGetLastError() after its launches
// (0 = launched), -1 when the arguments are outside what it takes, or
// another nonzero code when a TMA tensor map cannot be encoded; *route_out
// (when not null) is set to the route taken: 1 = tensor cores, 0 = SIMT.

// o: (B, Tq, H, Dh) with strides o_sb / o_st; lse: (B, H, Tq) fp32, dense.
extern "C" int train_flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* kv_mask, void* o,
    void* lse, int q_sb, int q_st, int k_sb, int k_st, int v_sb, int v_st,
    int o_sb, int o_st, int B, int Tq, int Tk, int H, int Dh, int causal,
    int dtype, float scale, void* stream, int* route_out) {
  if (!args_ok(B, Tq, Tk, H, Dh, dtype, scale)) return -1;
  const Strides st{q_sb, q_st, k_sb, k_st, v_sb, v_st, o_sb, o_st};
  const float* mask = static_cast<const float*>(kv_mask);
  float* L = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool tc = fwd_route(q, k, v, o, st, B, Tq, Tk, dtype);
  if (route_out != nullptr) *route_out = tc ? 1 : 0;
  if (tc)
    return hopper::launch_fwd_at<true>(Dh, q, k, v, mask, o, L, q_sb, q_st, k_sb, k_st, v_sb,
                                       v_st, o_sb, o_st, B, Tq, Tk, H, causal, scale, s);
  if (dtype == 0)
    return launch_fwd<float>(q, k, v, mask, o, L, st, B, Tq, Tk, H, Dh, causal, scale, s);
  return launch_fwd<__nv_bfloat16>(q, k, v, mask, o, L, st, B, Tq, Tk, H, Dh, causal, scale,
                                   s);
}

// dq: (B, Tq, H, Dh), dk, dv: (B, Tk, H, Dh), all dense; delta: (B, H, Tq)
// fp32 scratch.  o and dout are read with their strides.
extern "C" int train_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* kv_mask,
    const void* o, const void* lse, const void* dout, void* dq, void* dk,
    void* dv, void* delta, int q_sb, int q_st, int k_sb, int k_st, int v_sb,
    int v_st, int o_sb, int o_st, int do_sb, int do_st, int B, int Tq, int Tk,
    int H, int Dh, int causal, int dtype, float scale, void* stream, int* route_out) {
  if (!args_ok(B, Tq, Tk, H, Dh, dtype, scale)) return -1;
  const Strides st{q_sb, q_st, k_sb, k_st, v_sb, v_st, o_sb, o_st};
  const float* mask = static_cast<const float*>(kv_mask);
  const float* L = static_cast<const float*>(lse);
  float* D = static_cast<float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool tc = bwd_route(q, k, v, o, dout, st, do_sb, do_st, B, Tq, Tk, dtype);
  if (route_out != nullptr) *route_out = tc ? 1 : 0;
  if (tc) {
#define TFA_HOPPER(DH)                                                                     \
  launch_bwd_hopper<DH>(q, k, v, mask, o, L, dout, dq, dk, dv, D, st, do_sb, do_st, B, Tq, \
                        Tk, H, Dh, causal, scale, s)
    switch (hopper::instantiated_width(Dh)) {
      case 8: return TFA_HOPPER(8);
      case 16: return TFA_HOPPER(16);
      case 32: return TFA_HOPPER(32);
      case 64: return TFA_HOPPER(64);
      case 128: return TFA_HOPPER(128);
      default: return TFA_HOPPER(256);
    }
#undef TFA_HOPPER
  }
  if (dtype == 0)
    return launch_bwd<float>(q, k, v, mask, o, L, dout, dq, dk, dv, D, st,
                             do_sb, do_st, B, Tq, Tk, H, Dh, causal, scale, s);
  return launch_bwd<__nv_bfloat16>(q, k, v, mask, o, L, dout, dq, dk, dv, D, st,
                                   do_sb, do_st, B, Tq, Tk, H, Dh, causal, scale, s);
}
