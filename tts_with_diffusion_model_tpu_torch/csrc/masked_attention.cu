// Key-masked multi-head attention, forward only, for Hopper (sm_90a).
//
// Replaces tts_with_diffusion_model_tpu/ops/flash_attention.py::_attn_kernel
// (launched by _flash_impl through pl.pallas_call).  Same function:
//   per (batch b, head h):  s = q·kᵀ·Dh^-0.5 in fp32
//                           s += 0 where kv_mask[b, j] > 0, else NEG_INF
//                           p = softmax(s) over keys;  o = p·v
// with NEG_INF = -0.7·FLT_MAX (finite, so a row whose keys are all masked
// gets a uniform softmax over its Tk keys, never NaN), inputs and output in
// the (B, T, H, Dh) layout with no transposes, fp32 accumulation for fp32
// and bf16 inputs, and p rounded to v's dtype before p·v as the TPU kernel
// does.  Query rows are never masked here: every caller multiplies padding
// query rows away.
//
// What bounds it on the card.  At the serving shapes (Tq, Tk <= 800,
// H·Dh = 512 or 1024, B <= 8) one call is small: a B=1 DiT self-attention
// (384 x 384, 8 x 64) moves about 1.5 MB in bf16 and does about 0.3 GFLOP,
// under a microsecond of either bytes or tensor-core time, so the bound is
// the bytes plus the launch itself.  The design therefore reads every input
// byte once and writes the output once, keeps the (Tq, Tk) scores out of
// device memory entirely (online softmax in registers over 64-key tiles
// staged in shared memory), and needs no second pass or workspace, so each
// attention is exactly one launch.
//
// Two kernels, chosen by the launcher from the inputs:
//  * bf16 with Dh = 64 and 16-byte aligned rows (every call of the serving
//    path): four warps per block, 16 query rows each; q·kᵀ and p·v run on
//    the tensor cores as mma.sync m16n8k16 (bf16 in, fp32 accumulate), the
//    score fragments are turned into p·v operands in registers (no shared
//    round trip), and K/V tiles sit in padded shared rows so the fragment
//    loads hit 32 distinct banks.
//  * everything else (fp32, other head widths, unaligned views): one thread
//    per query row on the CUDA cores in fp32, q and the output accumulators
//    in registers, K/V tiles read from shared memory as broadcasts.  fp32
//    inputs take this path so that they are summed in fp32 throughout.
// wgmma/TMA tiles and a pipelined K/V ring are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC (ops/_build.py).  Plain C entry point below, bound
// with ctypes (ops/masked_attention.py).

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

// ---------------------------------------------------------------------------
// Tensor-core path: bf16, Dh = 64.
//
// mma.sync.m16n8k16 fragments (PTX ISA), g = lane / 4, t = lane % 4:
//   A (16x16, row): {A[g][2t..2t+1]}, {A[g+8][2t..]}, {A[g][2t+8..]},
//                   {A[g+8][2t+8..]}
//   B (16x8, col):  {B[2t..2t+1][g]}, {B[2t+8..2t+9][g]}
//   C (16x8, f32):  C[g][2t], C[g][2t+1], C[g+8][2t], C[g+8][2t+1]
// S = Q·Kᵀ takes B[k][n] = K[n][k]: two consecutive bf16 of a K row.
// O += P·V takes A = P straight from S's C fragments (n-tiles 2c, 2c+1 form
// k-chunk c) and B[k][n] = V[k][n]: two V rows, packed by hand.

constexpr int kTcDh = 64;
constexpr int kTcWarps = 4;
constexpr int kTcRows = 16 * kTcWarps;  // query rows per block
constexpr int kTcKeys = 64;             // keys per shared tile
constexpr int kTcStride = kTcDh + 8;    // padded shared row (bf16)

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
masked_attention_tc_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const float* __restrict__ kv_mask,
                           __nv_bfloat16* __restrict__ o, int q_sb, int q_st,
                           int k_sb, int k_st, int v_sb, int v_st, int o_sb,
                           int o_st, int Tq, int Tk, float scale) {
  __shared__ __align__(16) __nv_bfloat16 ks[kTcKeys][kTcStride];
  __shared__ __align__(16) __nv_bfloat16 vs[kTcKeys][kTcStride];
  __shared__ float bias[kTcKeys];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r_lo = blockIdx.x * kTcRows + warp * 16 + g;
  const int r_hi = r_lo + 8;

  // Q fragments for the four 16-wide slices of Dh; rows past Tq are zero.
  uint32_t qa[4][4];
  const __nv_bfloat16* qb = q + (long long)b * q_sb + h * kTcDh;
  const __nv_bfloat16* q_lo = qb + (long long)r_lo * q_st;
  const __nv_bfloat16* q_hi = qb + (long long)r_hi * q_st;
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
  float m_lo = -INFINITY, m_hi = -INFINITY;  // running row maxima
  float l_lo = 0.f, l_hi = 0.f;              // this thread's share of the sums

  const __nv_bfloat16* kb = k + (long long)b * k_sb + h * kTcDh;
  const __nv_bfloat16* vb = v + (long long)b * v_sb + h * kTcDh;
  const float* mb = kv_mask + (long long)b * Tk;

  for (int j0 = 0; j0 < Tk; j0 += kTcKeys) {
    __syncthreads();  // previous tile fully consumed
    for (int idx = threadIdx.x; idx < kTcKeys * kTcDh / 8;
         idx += 32 * kTcWarps) {
      const int j = idx / (kTcDh / 8), c = (idx % (kTcDh / 8)) * 8;
      uint4 kv4 = make_uint4(0, 0, 0, 0), vv4 = make_uint4(0, 0, 0, 0);
      if (j0 + j < Tk) {
        kv4 = *reinterpret_cast<const uint4*>(kb + (long long)(j0 + j) * k_st + c);
        vv4 = *reinterpret_cast<const uint4*>(vb + (long long)(j0 + j) * v_st + c);
      }
      *reinterpret_cast<uint4*>(&ks[j][c]) = kv4;
      *reinterpret_cast<uint4*>(&vs[j][c]) = vv4;
    }
    if (threadIdx.x < kTcKeys) {
      const int j = j0 + threadIdx.x;
      bias[threadIdx.x] = j < Tk ? (mb[j] > 0.f ? 0.f : kNegInf) : -INFINITY;
    }
    __syncthreads();

    // S = Q·Kᵀ for this warp's 16 rows and the tile's 64 keys.
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
        const float bb = bias[n * 8 + 2 * t + e];
        s[n][e] = s[n][e] * scale + bb;
        s[n][2 + e] = s[n][2 + e] * scale + bb;
        mx_lo = fmaxf(mx_lo, s[n][e]);
        mx_hi = fmaxf(mx_hi, s[n][2 + e]);
      }
    }
    // the four threads of a quad hold one row between them
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

    // O += P·V, P rounded to bf16 (the TPU kernel's p.astype(v.dtype)).
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
  __nv_bfloat16* ob = o + (long long)b * o_sb + h * kTcDh;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (r_lo < Tq)
      *reinterpret_cast<uint32_t*>(ob + (long long)r_lo * o_st + col) =
          pack_bf16(acc[n][0] * i_lo, acc[n][1] * i_lo);
    if (r_hi < Tq)
      *reinterpret_cast<uint32_t*>(ob + (long long)r_hi * o_st + col) =
          pack_bf16(acc[n][2] * i_hi, acc[n][3] * i_hi);
  }
}

bool tc_ok(const void* p, int sb, int st) {
  return (reinterpret_cast<uintptr_t>(p) % 16 == 0) && sb % 8 == 0 &&
         st % 8 == 0;
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
// Returns cudaGetLastError() after the launch (0 = launched), or -1 when
// the arguments are outside what the kernel takes.
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
  if (dtype == 1 && Dh == kTcDh && tc_ok(q, q_sb, q_st) &&
      tc_ok(k, k_sb, k_st) && tc_ok(v, v_sb, v_st) && tc_ok(o, o_sb, o_st)) {
    const dim3 grid((Tq + kTcRows - 1) / kTcRows, H, B);
    masked_attention_tc_kernel<<<grid, 32 * kTcWarps, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), mask,
        static_cast<__nv_bfloat16*>(o), q_sb, q_st, k_sb, k_st, v_sb, v_st,
        o_sb, o_st, Tq, Tk, rsqrtf((float)Dh));
    return (int)cudaGetLastError();
  }
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, mask, o, q_sb, q_st, k_sb, k_st,
                                 v_sb, v_st, o_sb, o_st, B, Tq, Tk, H, Dh, s);
  return -1;
}
