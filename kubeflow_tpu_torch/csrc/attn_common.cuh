// Body of the serving decode kernel (flash_decode.cu): grouped-query
// attention of a block of query rows that all belong to one (slot, kv
// head) against that kv head's slab [B, T, kv, hd], with an online softmax
// over KV tiles held in shared memory. A RowMap says how a query row maps
// to its head and absolute position. (The prefill kernel runs on the
// tensor-core mainloop of attn_fwd_sm90.cuh.)
//
// Numerics follow the TPU kernels (kubeflow_tpu/ops/flash_decode.py
// _decode_kernel and flash_prefill.py _prefill_kernel) step for step:
//   s   = dot(q, k) in f32 (k converted to bf16 exactly, int8 included),
//   s  *= k_scale[t] (int8 only), then s *= 1/sqrt(hd),
//   masked keys get -1e30, m/l/acc carry in f32,
//   p   = exp(s - m) (0 where masked), l += sum(p),
//   acc += bf16(p * v_scale[t]) . v   (v_scale only for int8),
//   out = acc / max(l, 1e-30), rounded to bf16.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace kft {

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

// 16 bytes of K/V converted to f32: 16 int8 or 8 bf16 values.
__device__ __forceinline__ void load16(const int8_t* p, float* out) {
  int4 raw = *reinterpret_cast<const int4*>(p);
  const char4* c = reinterpret_cast<const char4*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[4 * i] = c[i].x; out[4 * i + 1] = c[i].y;
    out[4 * i + 2] = c[i].z; out[4 * i + 3] = c[i].w;
  }
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  int4 raw = *reinterpret_cast<const int4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x; out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Everything one launch needs; all element strides, not bytes.
struct AttnParams {
  const __nv_bfloat16* q;   // [B, Sq, H, HD] contiguous
  const void* k;            // [B, T, kv, HD], slot stride kv_sb
  const void* v;
  const float* k_scale;     // [B, T, kv], slot stride s_sb (int8 only)
  const float* v_scale;
  __nv_bfloat16* out;       // [B, Sq, H, HD] contiguous
  long long kv_sb;
  long long s_sb;
  int Sq, H, kv, T;
  float scale;
};

// Row stride of the q and k tiles in shared memory: 16-byte aligned for
// float4 reads, and 4 banks apart from row to row, so the 8 lanes of a
// float4 phase that read 8 consecutive keys hit 32 distinct banks.
template <int HD>
__host__ __device__ constexpr int row_stride() { return HD + 4; }

// Shared-memory footprint of one block, in bytes.
template <int HD, int RMAX, int TK>
constexpr int smem_bytes() {
  return (RMAX * row_stride<HD>() + TK * row_stride<HD>() + TK * HD +
          RMAX * TK + 2 * TK + 3 * RMAX) * 4;
}

// Where a block's rows sit. Rows stack as [group member, rpg]: row r is
// query head h * g + r / rpg at query index qbase + r % rpg (live iff that
// is < Sq), and sees keys t <= pos_base + r % rpg.
struct RowMap {
  int g, rpg, qbase, pos_base;
  __device__ int head(int h, int r) const { return h * g + r / rpg; }
  __device__ int qrow(int r) const { return qbase + r % rpg; }
  __device__ int pos(int r) const { return pos_base + r % rpg; }
};

// Online-softmax attention of R query rows (R <= RMAX) over the keys
// [t_begin, t_end) of kv head h of slot b. On return, acc[j] holds row
// (tid / HD + (kThreads / HD) * j), column tid % HD, and the returned
// pointer is m_s (l_s follows it at m_s + RMAX): each row's running max
// and sum.
template <typename KV_T, int HD, int RMAX, int TK>
__device__ float* attend(const AttnParams& p, int b, int h, int R,
                         const RowMap& rows, int t_begin, int t_end,
                         float* smem, float (&acc)[RMAX * HD / kThreads]) {
  constexpr int NRG = kThreads / TK;       // row groups in the score pass
  constexpr int SR = RMAX / NRG;           // score rows per thread
  constexpr int NRG2 = kThreads / HD;      // row groups in the PV pass
  constexpr int AR = RMAX / NRG2;          // acc rows per thread
  const bool quantized = sizeof(KV_T) == 1;
  const int tid = threadIdx.x;

  constexpr int QS = row_stride<HD>();
  constexpr int VEC = 16 / sizeof(KV_T);    // K/V elements per 16 bytes
  float* q_s = smem;                        // [RMAX][QS]
  float* k_s = q_s + RMAX * QS;             // [TK][QS]
  float* v_s = k_s + TK * QS;               // [TK][HD]
  float* p_s = v_s + TK * HD;               // [RMAX][TK]
  float* ks_s = p_s + RMAX * TK;            // [TK]
  float* vs_s = ks_s + TK;                  // [TK]
  float* m_s = vs_s + TK;                   // [RMAX]
  float* l_s = m_s + RMAX;                  // [RMAX]
  float* corr_s = l_s + RMAX;               // [RMAX]

  // q rows of this block, converted once; rows past R are zero
  for (int i = tid; i < RMAX * HD; i += kThreads) {
    int r = i / HD, d = i % HD;
    float val = 0.f;
    if (r < R && rows.qrow(r) < p.Sq) {
      long long off =
          ((long long)(b * p.Sq + rows.qrow(r)) * p.H + rows.head(h, r)) * HD + d;
      val = __bfloat162float(p.q[off]);
    }
    q_s[r * QS + d] = val;
  }
  for (int r = tid; r < RMAX; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < AR; ++j) acc[j] = 0.f;

  const KV_T* kb = reinterpret_cast<const KV_T*>(p.k) + (long long)b * p.kv_sb;
  const KV_T* vb = reinterpret_cast<const KV_T*>(p.v) + (long long)b * p.kv_sb;

  for (int t0 = t_begin; t0 < t_end; t0 += TK) {
    __syncthreads();   // previous tile's readers are done
    for (int i = tid; i < TK * HD / VEC; i += kThreads) {
      int t = (i * VEC) / HD, d = (i * VEC) % HD;
      float kv[VEC], vv[VEC];
      if (t0 + t < p.T) {
        long long off = ((long long)(t0 + t) * p.kv + h) * HD + d;
        load16(kb + off, kv);
        load16(vb + off, vv);
      } else {
#pragma unroll
        for (int c = 0; c < VEC; ++c) kv[c] = vv[c] = 0.f;
      }
#pragma unroll
      for (int c = 0; c < VEC; c += 4) {
        *reinterpret_cast<float4*>(&k_s[t * QS + d + c]) =
            make_float4(kv[c], kv[c + 1], kv[c + 2], kv[c + 3]);
        *reinterpret_cast<float4*>(&v_s[t * HD + d + c]) =
            make_float4(vv[c], vv[c + 1], vv[c + 2], vv[c + 3]);
      }
    }
    if (quantized) {
      for (int t = tid; t < TK; t += kThreads) {
        bool in = t0 + t < p.T;
        long long off = (long long)b * p.s_sb + (long long)(t0 + t) * p.kv + h;
        ks_s[t] = in ? p.k_scale[off] : 0.f;
        vs_s[t] = in ? p.v_scale[off] : 0.f;
      }
    }
    __syncthreads();

    // scores: thread owns key column t and rows rg, rg + NRG, ...
    {
      const int t = tid % TK, rg = tid / TK;
      float sc[SR];
#pragma unroll
      for (int j = 0; j < SR; ++j) sc[j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HD; d += 4) {
        const float4 kd = *reinterpret_cast<const float4*>(&k_s[t * QS + d]);
#pragma unroll
        for (int j = 0; j < SR; ++j)
          sc[j] = dot4(*reinterpret_cast<const float4*>(
                           &q_s[(rg + NRG * j) * QS + d]), kd, sc[j]);
      }
      const int ta = t0 + t;
#pragma unroll
      for (int j = 0; j < SR; ++j) {
        int r = rg + NRG * j;
        float s = sc[j];
        if (quantized) s *= ks_s[t];
        s *= p.scale;
        // rows past R carry no probability mass into the PV pass
        bool valid = ta < p.T && ta <= rows.pos(r);
        p_s[r * TK + t] = r >= R ? 0.f : (valid ? s : kNegInf);
      }
    }
    __syncthreads();

    // online softmax: one warp per row
    {
      const int lane = tid % 32, warp = tid / 32;
      for (int r = warp; r < R; r += kThreads / 32) {
        float mx = kNegInf;
        for (int t = lane; t < TK; t += 32) mx = fmaxf(mx, p_s[r * TK + t]);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        float m_prev = m_s[r];
        float m_new = fmaxf(m_prev, mx);
        float sum = 0.f;
        for (int t = lane; t < TK; t += 32) {
          float s = p_s[r * TK + t];
          float e = s > kNegInf / 2 ? __expf(s - m_new) : 0.f;
          sum += e;
          p_s[r * TK + t] = round_bf16(quantized ? e * vs_s[t] : e);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
        if (lane == 0) {
          float corr = __expf(m_prev - m_new);
          corr_s[r] = corr;
          m_s[r] = m_new;
          l_s[r] = l_s[r] * corr + sum;
        }
      }
    }
    __syncthreads();

    // acc = acc * corr + p . v: thread owns column d of rows rg2 + NRG2*j
    {
      const int d = tid % HD, rg2 = tid / HD;
#pragma unroll
      for (int j = 0; j < AR; ++j) {
        int r = rg2 + NRG2 * j;
        if (r < R) acc[j] *= corr_s[r];
      }
#pragma unroll 2
      for (int t = 0; t < TK; t += 4) {
        const float4 vd = make_float4(v_s[t * HD + d], v_s[(t + 1) * HD + d],
                                      v_s[(t + 2) * HD + d],
                                      v_s[(t + 3) * HD + d]);
#pragma unroll
        for (int j = 0; j < AR; ++j)
          acc[j] = dot4(*reinterpret_cast<const float4*>(
                            &p_s[(rg2 + NRG2 * j) * TK + t]), vd, acc[j]);
      }
    }
  }
  __syncthreads();
  return m_s;
}

}  // namespace kft
