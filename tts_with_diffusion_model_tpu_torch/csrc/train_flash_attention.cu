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
//  * forward: one block per (b, h, query tile), online softmax; writes O and
//    the row log-sum-exp L = m + log(l) (fp32, (B, H, Tq)).  On an
//    all-masked row m = NEG_INF and L == NEG_INF exactly (log l is below
//    half an ulp of NEG_INF), which is how the backward recognises it.
//  * backward: D_i = dO_i·O_i (one pass); dK/dV per key tile, looping over
//    every query tile and recomputing P from L; dQ per query tile, looping
//    over every key tile.  No atomics: dQ, dK and dV are each written by
//    one thread, so the result is deterministic.  dS is formed in fp32.
//
// What bounds it on the card.  At the D3PM training sites (B=32, H=8,
// Dh=64, Tq, Tk <= 398) one forward moves at most ~52 MB in bf16 (q, k, v,
// o) and does up to ~10 GFLOP, so the bytes (16 µs at 3.35 TB/s) and the
// tensor cores (10 µs at 989 TF/s) are close; the backward moves twice the
// bytes and does 2.5x the operations.  The design keeps the (Tq, Tk) scores
// and probabilities out of device memory in both passes (the only scratch
// is L and D, 8 bytes per query row).
//
// Kernels:
//  * bf16 with Dh = 64 and 16-byte aligned rows (every call of the D3PM
//    training path): forward, dK/dV and dQ on the tensor cores, mma.sync
//    m16n8k16 with the fragment layout of csrc/masked_attention.cu: four
//    warps of 16 rows, the block's own rows as A fragments in registers,
//    the other side's 64-row tiles in padded shared memory, score fragments
//    turned into the next product's A operand in registers (P for p·v and
//    dV, dS for dK and dQ) with no shared round trip.
//  * everything else (fp32, other head widths, unaligned views): one thread
//    per query row (forward, dQ) or per key (dK/dV) on the CUDA cores in
//    fp32, the other side's tiles staged in shared memory.
// wgmma/TMA tiles and a pipelined K/V ring are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC (ops/_build.py).  Plain C entry points at the end,
// bound with ctypes (ops/train_flash_attention.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kDhMax = 64;    // head width held in registers (Dh <= 64)
constexpr int kRows = 64;     // query rows (forward, dQ) or keys (dK/dV) per block
constexpr int kKTile = 64;    // keys staged in shared memory per step
constexpr int kSub = 16;      // keys scored per online-softmax update
constexpr int kQTileB = 16;   // query rows staged per step of the dK/dV loop
constexpr int kPad = kDhMax + 1;  // padded shared row: own-row reads hit 32 banks
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
// Forward, CUDA cores: one thread per query row.

template <typename T>
__global__ void __launch_bounds__(kRows)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const float* __restrict__ kv_mask,
           T* __restrict__ o, float* __restrict__ lse, Strides st, int Tq,
           int Tk, int H, int Dh, int causal, float scale) {
  __shared__ __align__(16) float ks[kKTile][kDhMax];
  __shared__ __align__(16) float vs[kKTile][kDhMax];
  __shared__ float flag[kKTile];

  const int b = blockIdx.z, h = blockIdx.y;
  const int row = blockIdx.x * kRows + threadIdx.x;
  const bool live = row < Tq;

  float qr[kDhMax];
  const T* qp = q + (long long)b * st.q_sb + (long long)row * st.q_st + h * Dh;
#pragma unroll
  for (int d = 0; d < kDhMax; ++d)
    qr[d] = (live && d < Dh) ? to_float(qp[d]) * scale : 0.f;
  float acc[kDhMax];
#pragma unroll
  for (int d = 0; d < kDhMax; ++d) acc[d] = 0.f;
  float m = -INFINITY, l = 0.f;

  const T* kb = k + (long long)b * st.k_sb + h * Dh;
  const T* vb = v + (long long)b * st.v_sb + h * Dh;
  const float* mb = kv_mask + (long long)b * Tk;

  for (int j0 = 0; j0 < Tk; j0 += kKTile) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < kKTile * kDhMax; idx += kRows) {
      const int j = idx / kDhMax, d = idx % kDhMax;
      const bool in = (j0 + j < Tk) && d < Dh;
      ks[j][d] = in ? to_float(kb[(long long)(j0 + j) * st.k_st + d]) : 0.f;
      vs[j][d] = in ? to_float(vb[(long long)(j0 + j) * st.v_st + d]) : 0.f;
    }
    flag[threadIdx.x] = key_flag(mb, j0 + threadIdx.x, Tk);
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
          const float4 k4 = kr[d4];
          dot += qr[4 * d4] * k4.x + qr[4 * d4 + 1] * k4.y +
                 qr[4 * d4 + 2] * k4.z + qr[4 * d4 + 3] * k4.w;
        }
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
      for (int d = 0; d < kDhMax; ++d) acc[d] *= corr;
#pragma unroll
      for (int jj = 0; jj < kSub; ++jj) {
        const float p = expf(s[jj] - m_new);
        l += p;
        const float pr = round_like(p, q);
        const float4* vr = reinterpret_cast<const float4*>(vs[s0 + jj]);
#pragma unroll
        for (int d4 = 0; d4 < kDhMax / 4; ++d4) {
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
  T* op = o + (long long)b * st.o_sb + (long long)row * st.o_st + h * Dh;
#pragma unroll
  for (int d = 0; d < kDhMax; ++d)
    if (d < Dh) store(op + d, acc[d] * inv);
  lse[((long long)b * H + h) * Tq + row] = m + logf(l);
}

// ---------------------------------------------------------------------------
// Forward, tensor cores: bf16, Dh = 64.  Fragment layout as in
// csrc/masked_attention.cu (mma.sync m16n8k16, g = lane / 4, t = lane % 4).

constexpr int kTcDh = 64;
constexpr int kTcWarps = 4;
constexpr int kTcRows = 16 * kTcWarps;
constexpr int kTcKeys = 64;
constexpr int kTcStride = kTcDh + 8;

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__global__ void __launch_bounds__(32 * kTcWarps)
fwd_tc_kernel(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              const float* __restrict__ kv_mask, __nv_bfloat16* __restrict__ o,
              float* __restrict__ lse, Strides st, int Tq, int Tk, int H,
              int causal, float scale) {
  __shared__ __align__(16) __nv_bfloat16 ks[kTcKeys][kTcStride];
  __shared__ __align__(16) __nv_bfloat16 vs[kTcKeys][kTcStride];
  __shared__ float flag[kTcKeys];

  const int b = blockIdx.z, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r_lo = blockIdx.x * kTcRows + warp * 16 + g;
  const int r_hi = r_lo + 8;

  uint32_t qa[4][4];
  const __nv_bfloat16* qb = q + (long long)b * st.q_sb + h * kTcDh;
  const __nv_bfloat16* q_lo = qb + (long long)r_lo * st.q_st;
  const __nv_bfloat16* q_hi = qb + (long long)r_hi * st.q_st;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int c = kk * 16 + 2 * t;
    qa[kk][0] = r_lo < Tq ? ld32(q_lo + c) : 0u;
    qa[kk][1] = r_hi < Tq ? ld32(q_hi + c) : 0u;
    qa[kk][2] = r_lo < Tq ? ld32(q_lo + c + 8) : 0u;
    qa[kk][3] = r_hi < Tq ? ld32(q_hi + c + 8) : 0u;
  }

  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY;
  float l_lo = 0.f, l_hi = 0.f;

  const __nv_bfloat16* kb = k + (long long)b * st.k_sb + h * kTcDh;
  const __nv_bfloat16* vb = v + (long long)b * st.v_sb + h * kTcDh;
  const float* mb = kv_mask + (long long)b * Tk;

  for (int j0 = 0; j0 < Tk; j0 += kTcKeys) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < kTcKeys * kTcDh / 8;
         idx += 32 * kTcWarps) {
      const int j = idx / (kTcDh / 8), c = (idx % (kTcDh / 8)) * 8;
      uint4 k4 = make_uint4(0, 0, 0, 0), v4 = make_uint4(0, 0, 0, 0);
      if (j0 + j < Tk) {
        k4 = *reinterpret_cast<const uint4*>(kb + (long long)(j0 + j) * st.k_st + c);
        v4 = *reinterpret_cast<const uint4*>(vb + (long long)(j0 + j) * st.v_st + c);
      }
      *reinterpret_cast<uint4*>(&ks[j][c]) = k4;
      *reinterpret_cast<uint4*>(&vs[j][c]) = v4;
    }
    if (threadIdx.x < kTcKeys) flag[threadIdx.x] = key_flag(mb, j0 + threadIdx.x, Tk);
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const __nv_bfloat16* kr = &ks[n * 8 + g][kk * 16 + 2 * t];
        mma_bf16(s[n], qa[kk], ld32(kr), ld32(kr + 8));
      }
    }

    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = j0 + n * 8 + 2 * t + e;
        const float f = flag[n * 8 + 2 * t + e];
        const float off = f < 0.f ? -INFINITY : kNegInf;
        const bool ok = f > 0.f;
        s[n][e] = (ok && (!causal || key <= r_lo)) ? s[n][e] * scale : off;
        s[n][2 + e] = (ok && (!causal || key <= r_hi)) ? s[n][2 + e] * scale : off;
        mx_lo = fmaxf(mx_lo, s[n][e]);
        mx_hi = fmaxf(mx_hi, s[n][2 + e]);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    // every tile holds a key < Tk, so the new maxima are finite
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    const float c_lo = expf(m_lo - mn_lo), c_hi = expf(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    l_lo *= c_lo;
    l_hi *= c_hi;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      acc[n][0] *= c_lo;
      acc[n][1] *= c_lo;
      acc[n][2] *= c_hi;
      acc[n][3] *= c_hi;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[n][e] = expf(s[n][e] - mn_lo);
        s[n][2 + e] = expf(s[n][2 + e] - mn_hi);
        l_lo += s[n][e];
        l_hi += s[n][2 + e];
      }
    }

#pragma unroll
    for (int c = 0; c < 4; ++c) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * c][0], s[2 * c][1]);
      pa[1] = pack_bf16(s[2 * c][2], s[2 * c][3]);
      pa[2] = pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]);
      pa[3] = pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3]);
      const int key = c * 16 + 2 * t;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int d = n * 8 + g;
        mma_bf16(acc[n], pa, pack_bf16(vs[key][d], vs[key + 1][d]),
                 pack_bf16(vs[key + 8][d], vs[key + 9][d]));
      }
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  const float i_lo = 1.f / l_lo, i_hi = 1.f / l_hi;
  __nv_bfloat16* ob = o + (long long)b * st.o_sb + h * kTcDh;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (r_lo < Tq)
      *reinterpret_cast<uint32_t*>(ob + (long long)r_lo * st.o_st + col) =
          pack_bf16(acc[n][0] * i_lo, acc[n][1] * i_lo);
    if (r_hi < Tq)
      *reinterpret_cast<uint32_t*>(ob + (long long)r_hi * st.o_st + col) =
          pack_bf16(acc[n][2] * i_hi, acc[n][3] * i_hi);
  }
  if (t == 0) {
    float* lb = lse + ((long long)b * H + h) * Tq;
    if (r_lo < Tq) lb[r_lo] = m_lo + logf(l_lo);
    if (r_hi < Tq) lb[r_hi] = m_hi + logf(l_hi);
  }
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

// dK, dV: one thread per key; q / dO rows staged kQTileB at a time.
template <typename T>
__global__ void __launch_bounds__(kRows)
bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ kv_mask,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dk,
                T* __restrict__ dv, Strides st, int do_sb, int do_st, int Tq,
                int Tk, int H, int Dh, int causal, float scale) {
  __shared__ float ksm[kRows][kPad];
  __shared__ float vsm[kRows][kPad];
  __shared__ __align__(16) float qs[kQTileB][kDhMax];
  __shared__ __align__(16) float dos[kQTileB][kDhMax];
  __shared__ float ls[kQTileB], ds_[kQTileB];

  const int b = blockIdx.z, h = blockIdx.y;
  const int tid = threadIdx.x;
  const int j = blockIdx.x * kRows + tid;
  const bool live = j < Tk;
  const float* mb = kv_mask + (long long)b * Tk;
  const bool valid = live && mb[j] > 0.f;
  const float inv_tk = 1.f / (float)Tk;

  // this block's K and V rows, fp32, zero-padded past Dh
  for (int idx = tid; idx < kRows * kDhMax; idx += kRows) {
    const int r = idx / kDhMax, d = idx % kDhMax;
    const int jr = blockIdx.x * kRows + r;
    const bool in = jr < Tk && d < Dh;
    ksm[r][d] = in ? to_float(k[(long long)b * st.k_sb + (long long)jr * st.k_st + h * Dh + d]) : 0.f;
    vsm[r][d] = in ? to_float(v[(long long)b * st.v_sb + (long long)jr * st.v_st + h * Dh + d]) : 0.f;
  }

  float dka[kDhMax], dva[kDhMax];
#pragma unroll
  for (int d = 0; d < kDhMax; ++d) dka[d] = dva[d] = 0.f;

  const float* lb = lse + ((long long)b * H + h) * Tq;
  const float* db = delta + ((long long)b * H + h) * Tq;
  for (int i0 = 0; i0 < Tq; i0 += kQTileB) {
    __syncthreads();
    for (int idx = tid; idx < kQTileB * kDhMax; idx += kRows) {
      const int r = idx / kDhMax, d = idx % kDhMax;
      const int ir = i0 + r;
      const bool in = ir < Tq && d < Dh;
      qs[r][d] = in ? to_float(q[(long long)b * st.q_sb + (long long)ir * st.q_st + h * Dh + d]) : 0.f;
      dos[r][d] = in ? to_float(dout[(long long)b * do_sb + (long long)ir * do_st + h * Dh + d]) : 0.f;
    }
    if (tid < kQTileB) {
      const int ir = i0 + tid;
      ls[tid] = ir < Tq ? lb[ir] : 0.f;
      ds_[tid] = ir < Tq ? db[ir] : 0.f;
    }
    __syncthreads();
    if (!live) continue;
    const int n_rows = min(kQTileB, Tq - i0);
    for (int r = 0; r < n_rows; ++r) {
      const int i = i0 + r;
      const float Li = ls[r];
      const float4* q4 = reinterpret_cast<const float4*>(qs[r]);
      const float4* do4 = reinterpret_cast<const float4*>(dos[r]);
      if (Li == kNegInf) {  // all keys masked: uniform P, no dS
        const float pr = round_like(inv_tk, q);
#pragma unroll
        for (int d4 = 0; d4 < kDhMax / 4; ++d4) {
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
      for (int d4 = 0; d4 < kDhMax / 4; ++d4) {
        const float4 a = q4[d4], g4 = do4[d4];
        dot += a.x * ksm[tid][4 * d4] + a.y * ksm[tid][4 * d4 + 1] +
               a.z * ksm[tid][4 * d4 + 2] + a.w * ksm[tid][4 * d4 + 3];
        dpv += g4.x * vsm[tid][4 * d4] + g4.y * vsm[tid][4 * d4 + 1] +
               g4.z * vsm[tid][4 * d4 + 2] + g4.w * vsm[tid][4 * d4 + 3];
      }
      const float p = expf(dot * scale - Li);
      const float pr = round_like(p, q);
      const float dsv = p * (dpv - ds_[r]);
#pragma unroll
      for (int d4 = 0; d4 < kDhMax / 4; ++d4) {
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
  const long long base = ((long long)b * Tk + j) * H * Dh + (long long)h * Dh;
#pragma unroll
  for (int d = 0; d < kDhMax; ++d) {
    if (d < Dh) {
      store(dk + base + d, dka[d] * scale);
      store(dv + base + d, dva[d]);
    }
  }
}

// dQ: one thread per query row; K / V tiles staged in shared memory.
template <typename T>
__global__ void __launch_bounds__(kRows)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const float* __restrict__ kv_mask,
              const T* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta, T* __restrict__ dq, Strides st,
              int do_sb, int do_st, int Tq, int Tk, int H, int Dh, int causal,
              float scale) {
  __shared__ __align__(16) float ks[kKTile][kDhMax];
  __shared__ __align__(16) float vs[kKTile][kDhMax];
  __shared__ float flag[kKTile];

  const int b = blockIdx.z, h = blockIdx.y;
  const int i = blockIdx.x * kRows + threadIdx.x;
  const bool live = i < Tq;
  const float Li = live ? lse[((long long)b * H + h) * Tq + i] : 0.f;
  const float Di = live ? delta[((long long)b * H + h) * Tq + i] : 0.f;
  // an all-masked row has dS = 0 everywhere: dQ stays 0
  const bool work = live && Li != kNegInf;

  float qr[kDhMax], gr[kDhMax], acc[kDhMax];
  const T* qp = q + (long long)b * st.q_sb + (long long)i * st.q_st + h * Dh;
  const T* gp = dout + (long long)b * do_sb + (long long)i * do_st + h * Dh;
#pragma unroll
  for (int d = 0; d < kDhMax; ++d) {
    qr[d] = (work && d < Dh) ? to_float(qp[d]) : 0.f;
    gr[d] = (work && d < Dh) ? to_float(gp[d]) : 0.f;
    acc[d] = 0.f;
  }

  const T* kb = k + (long long)b * st.k_sb + h * Dh;
  const T* vb = v + (long long)b * st.v_sb + h * Dh;
  const float* mb = kv_mask + (long long)b * Tk;
  for (int j0 = 0; j0 < Tk; j0 += kKTile) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < kKTile * kDhMax; idx += kRows) {
      const int j = idx / kDhMax, d = idx % kDhMax;
      const bool in = (j0 + j < Tk) && d < Dh;
      ks[j][d] = in ? to_float(kb[(long long)(j0 + j) * st.k_st + d]) : 0.f;
      vs[j][d] = in ? to_float(vb[(long long)(j0 + j) * st.v_st + d]) : 0.f;
    }
    flag[threadIdx.x] = key_flag(mb, j0 + threadIdx.x, Tk);
    __syncthreads();
    if (!work) continue;
    const int n_keys = min(kKTile, Tk - j0);
    for (int jj = 0; jj < n_keys; ++jj) {
      if (!(flag[jj] > 0.f) || (causal && j0 + jj > i)) continue;
      const float4* k4 = reinterpret_cast<const float4*>(ks[jj]);
      const float4* v4 = reinterpret_cast<const float4*>(vs[jj]);
      float dot = 0.f, dpv = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < kDhMax / 4; ++d4) {
        const float4 a = k4[d4], c = v4[d4];
        dot += qr[4 * d4] * a.x + qr[4 * d4 + 1] * a.y +
               qr[4 * d4 + 2] * a.z + qr[4 * d4 + 3] * a.w;
        dpv += gr[4 * d4] * c.x + gr[4 * d4 + 1] * c.y +
               gr[4 * d4 + 2] * c.z + gr[4 * d4 + 3] * c.w;
      }
      const float p = expf(dot * scale - Li);
      const float dsv = p * (dpv - Di);
#pragma unroll
      for (int d4 = 0; d4 < kDhMax / 4; ++d4) {
        const float4 a = k4[d4];
        acc[4 * d4] += dsv * a.x;
        acc[4 * d4 + 1] += dsv * a.y;
        acc[4 * d4 + 2] += dsv * a.z;
        acc[4 * d4 + 3] += dsv * a.w;
      }
    }
  }
  if (!live) return;
  T* out = dq + ((long long)b * Tq + i) * H * Dh + (long long)h * Dh;
#pragma unroll
  for (int d = 0; d < kDhMax; ++d)
    if (d < Dh) store(out + d, acc[d] * scale);
}

// ---------------------------------------------------------------------------
// Backward, tensor cores: bf16, Dh = 64.  Four warps of 16 rows each; P and
// dS are formed in fp32 from the score fragments and rounded to bf16 only as
// the A operand of the next product (P for dV, dS for dK / dQ).

// dK, dV: a block owns 64 keys (16 per warp, K and V as A fragments in
// registers) and walks the query tiles, staged 64 rows at a time.
__global__ void __launch_bounds__(32 * kTcWarps)
bwd_dkdv_tc_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   const float* __restrict__ kv_mask,
                   const __nv_bfloat16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                   Strides st, int do_sb, int do_st, int Tq, int Tk, int H,
                   int causal, float scale) {
  __shared__ __align__(16) __nv_bfloat16 qs[kTcRows][kTcStride];
  __shared__ __align__(16) __nv_bfloat16 gs[kTcRows][kTcStride];
  __shared__ float ls[kTcRows], ds_[kTcRows];

  const int b = blockIdx.z, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int key_lo = blockIdx.x * kTcRows + warp * 16 + g;
  const int key_hi = key_lo + 8;
  const float* mb = kv_mask + (long long)b * Tk;
  const bool ok_lo = key_lo < Tk && mb[key_lo] > 0.f;
  const bool ok_hi = key_hi < Tk && mb[key_hi] > 0.f;
  const float inv_tk = 1.f / (float)Tk;

  uint32_t ka[4][4], va[4][4];
  {
    const __nv_bfloat16* kb = k + (long long)b * st.k_sb + h * kTcDh;
    const __nv_bfloat16* vb = v + (long long)b * st.v_sb + h * kTcDh;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int c = kk * 16 + 2 * t;
      ka[kk][0] = key_lo < Tk ? ld32(kb + (long long)key_lo * st.k_st + c) : 0u;
      ka[kk][1] = key_hi < Tk ? ld32(kb + (long long)key_hi * st.k_st + c) : 0u;
      ka[kk][2] = key_lo < Tk ? ld32(kb + (long long)key_lo * st.k_st + c + 8) : 0u;
      ka[kk][3] = key_hi < Tk ? ld32(kb + (long long)key_hi * st.k_st + c + 8) : 0u;
      va[kk][0] = key_lo < Tk ? ld32(vb + (long long)key_lo * st.v_st + c) : 0u;
      va[kk][1] = key_hi < Tk ? ld32(vb + (long long)key_hi * st.v_st + c) : 0u;
      va[kk][2] = key_lo < Tk ? ld32(vb + (long long)key_lo * st.v_st + c + 8) : 0u;
      va[kk][3] = key_hi < Tk ? ld32(vb + (long long)key_hi * st.v_st + c + 8) : 0u;
    }
  }
  float dka[8][4], dva[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  const __nv_bfloat16* qb = q + (long long)b * st.q_sb + h * kTcDh;
  const __nv_bfloat16* gb = dout + (long long)b * do_sb + h * kTcDh;
  const float* lb = lse + ((long long)b * H + h) * Tq;
  const float* db = delta + ((long long)b * H + h) * Tq;
  for (int i0 = 0; i0 < Tq; i0 += kTcRows) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < kTcRows * kTcDh / 8; idx += 32 * kTcWarps) {
      const int r = idx / (kTcDh / 8), c = (idx % (kTcDh / 8)) * 8;
      uint4 q4 = make_uint4(0, 0, 0, 0), g4 = make_uint4(0, 0, 0, 0);
      if (i0 + r < Tq) {
        q4 = *reinterpret_cast<const uint4*>(qb + (long long)(i0 + r) * st.q_st + c);
        g4 = *reinterpret_cast<const uint4*>(gb + (long long)(i0 + r) * do_st + c);
      }
      *reinterpret_cast<uint4*>(&qs[r][c]) = q4;
      *reinterpret_cast<uint4*>(&gs[r][c]) = g4;
    }
    if (threadIdx.x < kTcRows) {
      const int i = i0 + threadIdx.x;
      ls[threadIdx.x] = i < Tq ? lb[i] : 0.f;
      ds_[threadIdx.x] = i < Tq ? db[i] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int c = 0; c < 4; ++c) {  // 16 queries at a time
      float sp[2][4], dp[2][4];  // Sᵀ then Pᵀ; dPᵀ then dSᵀ
#pragma unroll
      for (int nn = 0; nn < 2; ++nn) {
        const int n = 2 * c + nn;
#pragma unroll
        for (int e = 0; e < 4; ++e) sp[nn][e] = dp[nn][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const __nv_bfloat16* qr = &qs[n * 8 + g][kk * 16 + 2 * t];
          const __nv_bfloat16* gr = &gs[n * 8 + g][kk * 16 + 2 * t];
          mma_bf16(sp[nn], ka[kk], ld32(qr), ld32(qr + 8));
          mma_bf16(dp[nn], va[kk], ld32(gr), ld32(gr + 8));
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = n * 8 + 2 * t + (e & 1);  // query in the tile
          const int i = i0 + r;
          const bool hi = e >= 2;
          const int key = hi ? key_hi : key_lo;
          const bool kok = hi ? ok_hi : ok_lo;
          const float Li = ls[r];
          float p = 0.f, dsv = 0.f;
          if (i < Tq && key < Tk) {
            if (Li == kNegInf) {
              p = inv_tk;  // all keys masked: uniform P, no dS
            } else if (kok && (!causal || key <= i)) {
              p = expf(sp[nn][e] * scale - Li);
              dsv = p * (dp[nn][e] - ds_[r]);
            }
          }
          sp[nn][e] = p;
          dp[nn][e] = dsv;
        }
      }
      uint32_t pa[4], sa[4];
      pa[0] = pack_bf16(sp[0][0], sp[0][1]);
      pa[1] = pack_bf16(sp[0][2], sp[0][3]);
      pa[2] = pack_bf16(sp[1][0], sp[1][1]);
      pa[3] = pack_bf16(sp[1][2], sp[1][3]);
      sa[0] = pack_bf16(dp[0][0], dp[0][1]);
      sa[1] = pack_bf16(dp[0][2], dp[0][3]);
      sa[2] = pack_bf16(dp[1][0], dp[1][1]);
      sa[3] = pack_bf16(dp[1][2], dp[1][3]);
      const int r = c * 16 + 2 * t;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int d = n * 8 + g;
        mma_bf16(dva[n], pa, pack_bf16(gs[r][d], gs[r + 1][d]),
                 pack_bf16(gs[r + 8][d], gs[r + 9][d]));
        mma_bf16(dka[n], sa, pack_bf16(qs[r][d], qs[r + 1][d]),
                 pack_bf16(qs[r + 8][d], qs[r + 9][d]));
      }
    }
  }

  // dK, dV are dense (B, Tk, H, Dh)
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (key_lo < Tk) {
      const long long o = ((long long)b * Tk + key_lo) * H * kTcDh + (long long)h * kTcDh + col;
      *reinterpret_cast<uint32_t*>(dk + o) = pack_bf16(dka[n][0] * scale, dka[n][1] * scale);
      *reinterpret_cast<uint32_t*>(dv + o) = pack_bf16(dva[n][0], dva[n][1]);
    }
    if (key_hi < Tk) {
      const long long o = ((long long)b * Tk + key_hi) * H * kTcDh + (long long)h * kTcDh + col;
      *reinterpret_cast<uint32_t*>(dk + o) = pack_bf16(dka[n][2] * scale, dka[n][3] * scale);
      *reinterpret_cast<uint32_t*>(dv + o) = pack_bf16(dva[n][2], dva[n][3]);
    }
  }
}

// dQ: a block owns 64 queries (16 per warp, Q and dO as A fragments in
// registers) and walks the key tiles, staged 64 keys at a time.
__global__ void __launch_bounds__(32 * kTcWarps)
bwd_dq_tc_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const float* __restrict__ kv_mask,
                 const __nv_bfloat16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 __nv_bfloat16* __restrict__ dq, Strides st, int do_sb, int do_st,
                 int Tq, int Tk, int H, int causal, float scale) {
  __shared__ __align__(16) __nv_bfloat16 ks[kTcKeys][kTcStride];
  __shared__ __align__(16) __nv_bfloat16 vs[kTcKeys][kTcStride];
  __shared__ float flag[kTcKeys];

  const int b = blockIdx.z, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r_lo = blockIdx.x * kTcRows + warp * 16 + g;
  const int r_hi = r_lo + 8;

  uint32_t qa[4][4], ga[4][4];
  {
    const __nv_bfloat16* qb = q + (long long)b * st.q_sb + h * kTcDh;
    const __nv_bfloat16* gb = dout + (long long)b * do_sb + h * kTcDh;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int c = kk * 16 + 2 * t;
      qa[kk][0] = r_lo < Tq ? ld32(qb + (long long)r_lo * st.q_st + c) : 0u;
      qa[kk][1] = r_hi < Tq ? ld32(qb + (long long)r_hi * st.q_st + c) : 0u;
      qa[kk][2] = r_lo < Tq ? ld32(qb + (long long)r_lo * st.q_st + c + 8) : 0u;
      qa[kk][3] = r_hi < Tq ? ld32(qb + (long long)r_hi * st.q_st + c + 8) : 0u;
      ga[kk][0] = r_lo < Tq ? ld32(gb + (long long)r_lo * do_st + c) : 0u;
      ga[kk][1] = r_hi < Tq ? ld32(gb + (long long)r_hi * do_st + c) : 0u;
      ga[kk][2] = r_lo < Tq ? ld32(gb + (long long)r_lo * do_st + c + 8) : 0u;
      ga[kk][3] = r_hi < Tq ? ld32(gb + (long long)r_hi * do_st + c + 8) : 0u;
    }
  }
  const float* lb = lse + ((long long)b * H + h) * Tq;
  const float* db = delta + ((long long)b * H + h) * Tq;
  const float L_lo = r_lo < Tq ? lb[r_lo] : 0.f, L_hi = r_hi < Tq ? lb[r_hi] : 0.f;
  const float D_lo = r_lo < Tq ? db[r_lo] : 0.f, D_hi = r_hi < Tq ? db[r_hi] : 0.f;
  // rows past Tq and all-masked rows have dS = 0 everywhere
  const bool w_lo = r_lo < Tq && L_lo != kNegInf;
  const bool w_hi = r_hi < Tq && L_hi != kNegInf;

  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const __nv_bfloat16* kb = k + (long long)b * st.k_sb + h * kTcDh;
  const __nv_bfloat16* vb = v + (long long)b * st.v_sb + h * kTcDh;
  const float* mb = kv_mask + (long long)b * Tk;
  for (int j0 = 0; j0 < Tk; j0 += kTcKeys) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < kTcKeys * kTcDh / 8; idx += 32 * kTcWarps) {
      const int j = idx / (kTcDh / 8), c = (idx % (kTcDh / 8)) * 8;
      uint4 k4 = make_uint4(0, 0, 0, 0), v4 = make_uint4(0, 0, 0, 0);
      if (j0 + j < Tk) {
        k4 = *reinterpret_cast<const uint4*>(kb + (long long)(j0 + j) * st.k_st + c);
        v4 = *reinterpret_cast<const uint4*>(vb + (long long)(j0 + j) * st.v_st + c);
      }
      *reinterpret_cast<uint4*>(&ks[j][c]) = k4;
      *reinterpret_cast<uint4*>(&vs[j][c]) = v4;
    }
    if (threadIdx.x < kTcKeys) flag[threadIdx.x] = key_flag(mb, j0 + threadIdx.x, Tk);
    __syncthreads();

    float s[8][4], dp[8][4];  // S then dS; dP
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const __nv_bfloat16* kr = &ks[n * 8 + g][kk * 16 + 2 * t];
        const __nv_bfloat16* vr = &vs[n * 8 + g][kk * 16 + 2 * t];
        mma_bf16(s[n], qa[kk], ld32(kr), ld32(kr + 8));
        mma_bf16(dp[n], ga[kk], ld32(vr), ld32(vr + 8));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jj = n * 8 + 2 * t + (e & 1);
        const bool hi = e >= 2;
        const int row = hi ? r_hi : r_lo;
        const bool vis = (hi ? w_hi : w_lo) && flag[jj] > 0.f &&
                         (!causal || j0 + jj <= row);
        const float p = vis ? expf(s[n][e] * scale - (hi ? L_hi : L_lo)) : 0.f;
        s[n][e] = vis ? p * (dp[n][e] - (hi ? D_hi : D_lo)) : 0.f;
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      uint32_t sa[4];
      sa[0] = pack_bf16(s[2 * c][0], s[2 * c][1]);
      sa[1] = pack_bf16(s[2 * c][2], s[2 * c][3]);
      sa[2] = pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]);
      sa[3] = pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3]);
      const int key = c * 16 + 2 * t;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int d = n * 8 + g;
        mma_bf16(acc[n], sa, pack_bf16(ks[key][d], ks[key + 1][d]),
                 pack_bf16(ks[key + 8][d], ks[key + 9][d]));
      }
    }
  }

#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (r_lo < Tq)
      *reinterpret_cast<uint32_t*>(dq + ((long long)b * Tq + r_lo) * H * kTcDh +
                                   (long long)h * kTcDh + col) =
          pack_bf16(acc[n][0] * scale, acc[n][1] * scale);
    if (r_hi < Tq)
      *reinterpret_cast<uint32_t*>(dq + ((long long)b * Tq + r_hi) * H * kTcDh +
                                   (long long)h * kTcDh + col) =
          pack_bf16(acc[n][2] * scale, acc[n][3] * scale);
  }
}

bool tc_ok(const void* p, int sb, int st) {
  return (reinterpret_cast<uintptr_t>(p) % 16 == 0) && sb % 8 == 0 &&
         st % 8 == 0;
}

bool args_ok(int B, int Tq, int Tk, int H, int Dh) {
  return B >= 1 && Tq >= 1 && Tk >= 1 && H >= 1 && H <= 65535 && B <= 65535 &&
         Dh >= 8 && Dh <= kDhMax && Dh % 8 == 0;
}

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, const float* mask,
               void* o, float* lse, Strides st, int B, int Tq, int Tk, int H,
               int Dh, int causal, cudaStream_t s) {
  const dim3 grid((Tq + kRows - 1) / kRows, H, B);
  fwd_kernel<T><<<grid, kRows, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<T*>(o), lse, st, Tq, Tk, H,
      Dh, causal, rsqrtf((float)Dh));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* q, const void* k, const void* v, const float* mask,
               const void* o, const float* lse, const void* dout, void* dq,
               void* dk, void* dv, float* delta, Strides st, int do_sb,
               int do_st, int B, int Tq, int Tk, int H, int Dh, int causal,
               cudaStream_t s) {
  const float scale = rsqrtf((float)Dh);
  const long long rows = (long long)B * Tq * H;
  bwd_delta_kernel<T><<<(unsigned)((rows + 255) / 256), 256, 0, s>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, st.o_sb,
      st.o_st, do_sb, do_st, B, Tq, H, Dh);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const dim3 gk((Tk + kRows - 1) / kRows, H, B);
  bwd_dkdv_kernel<T><<<gk, kRows, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), st, do_sb, do_st, Tq, Tk, H,
      Dh, causal, scale);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const dim3 gq((Tq + kRows - 1) / kRows, H, B);
  bwd_dq_kernel<T><<<gq, kRows, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), st, do_sb, do_st, Tq, Tk, H, Dh, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Strides are in elements; the head and Dh dimensions are dense (head
// stride Dh, element stride 1).  dtype: 0 = float32, 1 = bfloat16.
// causal: 0 or 1.  Each entry returns cudaGetLastError() after its launches
// (0 = launched), or -1 when the arguments are outside what it takes.

// o: (B, Tq, H, Dh) with strides o_sb / o_st; lse: (B, H, Tq) fp32, dense.
extern "C" int train_flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* kv_mask, void* o,
    void* lse, int q_sb, int q_st, int k_sb, int k_st, int v_sb, int v_st,
    int o_sb, int o_st, int B, int Tq, int Tk, int H, int Dh, int causal,
    int dtype, void* stream) {
  if (!args_ok(B, Tq, Tk, H, Dh)) return -1;
  const Strides st{q_sb, q_st, k_sb, k_st, v_sb, v_st, o_sb, o_st};
  const float* mask = static_cast<const float*>(kv_mask);
  float* L = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_fwd<float>(q, k, v, mask, o, L, st, B, Tq, Tk, H, Dh, causal, s);
  if (dtype != 1) return -1;
  if (Dh == kTcDh && tc_ok(q, q_sb, q_st) && tc_ok(k, k_sb, k_st) &&
      tc_ok(v, v_sb, v_st) && tc_ok(o, o_sb, o_st)) {
    const dim3 grid((Tq + kTcRows - 1) / kTcRows, H, B);
    fwd_tc_kernel<<<grid, 32 * kTcWarps, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), mask,
        static_cast<__nv_bfloat16*>(o), L, st, Tq, Tk, H, causal,
        rsqrtf((float)Dh));
    return (int)cudaGetLastError();
  }
  return launch_fwd<__nv_bfloat16>(q, k, v, mask, o, L, st, B, Tq, Tk, H, Dh,
                                   causal, s);
}

// dq: (B, Tq, H, Dh), dk, dv: (B, Tk, H, Dh), all dense; delta: (B, H, Tq)
// fp32 scratch.  o and dout are read with their strides.
extern "C" int train_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* kv_mask,
    const void* o, const void* lse, const void* dout, void* dq, void* dk,
    void* dv, void* delta, int q_sb, int q_st, int k_sb, int k_st, int v_sb,
    int v_st, int o_sb, int o_st, int do_sb, int do_st, int B, int Tq, int Tk,
    int H, int Dh, int causal, int dtype, void* stream) {
  if (!args_ok(B, Tq, Tk, H, Dh)) return -1;
  const Strides st{q_sb, q_st, k_sb, k_st, v_sb, v_st, o_sb, o_st};
  const float* mask = static_cast<const float*>(kv_mask);
  const float* L = static_cast<const float*>(lse);
  float* D = static_cast<float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(q, k, v, mask, o, L, dout, dq, dk, dv, D, st,
                             do_sb, do_st, B, Tq, Tk, H, Dh, causal, s);
  if (dtype != 1) return -1;
  if (Dh == kTcDh && tc_ok(q, q_sb, q_st) && tc_ok(k, k_sb, k_st) &&
      tc_ok(v, v_sb, v_st) && tc_ok(dout, do_sb, do_st)) {
    const float scale = rsqrtf((float)Dh);
    const long long rows = (long long)B * Tq * H;
    bwd_delta_kernel<__nv_bfloat16><<<(unsigned)((rows + 255) / 256), 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(o),
        static_cast<const __nv_bfloat16*>(dout), D, o_sb, o_st, do_sb, do_st, B,
        Tq, H, Dh);
    int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    const auto* qh = static_cast<const __nv_bfloat16*>(q);
    const auto* kh = static_cast<const __nv_bfloat16*>(k);
    const auto* vh = static_cast<const __nv_bfloat16*>(v);
    const auto* gh = static_cast<const __nv_bfloat16*>(dout);
    const dim3 gk((Tk + kTcRows - 1) / kTcRows, H, B);
    bwd_dkdv_tc_kernel<<<gk, 32 * kTcWarps, 0, s>>>(
        qh, kh, vh, mask, gh, L, D, static_cast<__nv_bfloat16*>(dk),
        static_cast<__nv_bfloat16*>(dv), st, do_sb, do_st, Tq, Tk, H, causal,
        scale);
    rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    const dim3 gq((Tq + kTcRows - 1) / kTcRows, H, B);
    bwd_dq_tc_kernel<<<gq, 32 * kTcWarps, 0, s>>>(
        qh, kh, vh, mask, gh, L, D, static_cast<__nv_bfloat16*>(dq), st, do_sb,
        do_st, Tq, Tk, H, causal, scale);
    return (int)cudaGetLastError();
  }
  return launch_bwd<__nv_bfloat16>(q, k, v, mask, o, L, dout, dq, dk, dv, D, st,
                                   do_sb, do_st, B, Tq, Tk, H, Dh, causal, s);
}
