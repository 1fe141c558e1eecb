// Shared pieces of the two training-attention backward kernels
// (flash_attn_dq.cu B2, flash_attn_dkv.cu B3; the forward B1 runs on
// attn_fwd_sm90.cuh): bf16 tensor-core products (mma.sync m16n8k16, f32
// accumulation) on tiles staged in shared memory and read with ldmatrix,
// the tile loads, and the mask.
//
// Semantics follow kubeflow_tpu/ops/flash_pallas.py: NEG_INF = -1e30 for
// masked scores, a key is visible to query row i iff k < Sk, k <= i when
// causal (q_offset is 0 in the backward), and its segment id equals the
// row's. q/k/v/o/dO are [B, S, H, D] bf16, contiguous; lse/delta are
// [B*H, Sq] f32; segment ids stay [B, Sk] int32, read by b = bh / H.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace kfa {

constexpr int kThreads = 128;   // 4 warps, 16 rows of a 64-row tile each
constexpr float kNegInf = -1e30f;
// exponentials run as exp2 on scores scaled by log2(e) (one ex2 per score)
constexpr float kLog2e = 1.4426950408889634f;

// Everything one launch reads and writes; element strides, not bytes.
struct Params {
  const __nv_bfloat16* q;    // [B, Sq, H, D]
  const __nv_bfloat16* k;    // [B, Sk, H, D]
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout; // [B, Sq, H, D] (backward)
  const float* lse;          // [B*H, Sq]
  const float* delta;        // [B*H, Sq] rowsum(dO * O) (backward)
  const int* seg_q;          // query row i of batch b: seg_q[b*seg_stride+i]
  const int* seg_k;          // key t of batch b: seg_k[b*seg_stride+t]
  __nv_bfloat16* out;        // dq (B2)
  __nv_bfloat16* dk;         // B3
  __nv_bfloat16* dv;         // B3
  long long seg_stride;
  int B, H, Sq, Sk, causal;
  float scale;
};

// Row stride of a [rows][D] bf16 tile in shared memory: D + 8 elements, so
// the 8 rows one ldmatrix phase reads start 4 banks apart (no conflicts).
template <int D>
__host__ __device__ constexpr int tile_stride() { return D + 8; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a . b for one 16x8 tile, k = 16: a row-major (4 regs), b k-major
// (2 regs), c f32 (4 regs).
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// A operand (16 rows x 16 k) from a row-major tile: rows r0.., cols c0..
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* tile, int r0,
                                       int c0) {
  const int lane = threadIdx.x % 32;
  ldsm_x4(a, tile + (r0 + lane % 16) * tile_stride<D>() + c0 +
                 (lane / 16) * 8);
}

// B operands of two n-blocks (n0.., n0+8..) for k = c0..c0+15, where the
// tile stores n along rows and k along columns (K for Q.K^T): r[0], r[1]
// feed n-block n0 and r[2], r[3] n-block n0 + 8.
template <int D>
__device__ __forceinline__ void load_b_nk(uint32_t (&r)[4],
                                          const __nv_bfloat16* tile, int n0,
                                          int c0) {
  const int lane = threadIdx.x % 32, i = lane / 8;
  ldsm_x4(r, tile + (n0 + (i / 2) * 8 + lane % 8) * tile_stride<D>() + c0 +
                 (i % 2) * 8);
}

// B operands of two n-blocks (n0.., n0+8..) for k = k0..k0+15, where the
// tile stores k along rows and n along columns (V for P.V).
template <int D>
__device__ __forceinline__ void load_b_kn(uint32_t (&r)[4],
                                          const __nv_bfloat16* tile, int k0,
                                          int n0) {
  const int lane = threadIdx.x % 32, i = lane / 8;
  ldsm_x4_t(r, tile + (k0 + (i % 2) * 8 + lane % 8) * tile_stride<D>() +
                   n0 + (i / 2) * 8);
}

// rows [row0, row0 + R) of a [B, S, H, D] tensor for (b, h) into a tile;
// rows at or past S are zero (so masked products stay finite).
template <int D, int R>
__device__ __forceinline__ void load_tile(__nv_bfloat16* tile,
                                          const __nv_bfloat16* x, int b,
                                          int h, int row0, int S, int H) {
  constexpr int CH = D / 8;   // 16-byte chunks per row
  for (int i = threadIdx.x; i < R * CH; i += kThreads) {
    const int r = i / CH, c = (i % CH) * 8;
    int4 val = make_int4(0, 0, 0, 0);
    if (row0 + r < S)
      val = *reinterpret_cast<const int4*>(
          x + ((long long)(b * S + row0 + r) * H + h) * D + c);
    *reinterpret_cast<int4*>(tile + r * tile_stride<D>() + c) = val;
  }
}

// 16 bytes global -> shared without passing through registers; when `in`
// is false nothing is read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// load_tile as asynchronous copies (one commit group is the
// caller's business); rows at or past S are zero-filled.
template <int D, int R>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* tile,
                                                const __nv_bfloat16* x, int b,
                                                int h, int row0, int S,
                                                int H) {
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < R * CH; i += kThreads) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool in = row0 + r < S;
    const __nv_bfloat16* src =
        in ? x + ((long long)(b * S + row0 + r) * H + h) * D + c : x;
    cp_async16(tile + r * tile_stride<D>() + c, src, in);
  }
}

// `n` values of a per-row f32 vector (lse, delta) or int32 segment ids
// into shared memory, `fill` past `limit`.
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int row0,
                                          int n, int limit, T fill) {
  for (int i = threadIdx.x; i < n; i += kThreads)
    dst[i] = row0 + i < limit ? src[row0 + i] : fill;
}

// Whether key `kpos` is visible to the query row at `qpos`: key padding,
// causal, segments.
__device__ __forceinline__ bool visible(int qpos, int kpos, int Sk,
                                        int causal, int seg_q, int seg_k,
                                        bool segmented) {
  return kpos < Sk && (!causal || kpos <= qpos) &&
         (!segmented || seg_q == seg_k);
}

}  // namespace kfa
