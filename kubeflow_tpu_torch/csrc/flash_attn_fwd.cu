// B1: flash-attention forward for training, with the row logsumexp the
// backward needs.
//
// Replaces: kubeflow_tpu/ops/flash_pallas.py `_fwd_kernel` (the TPU Pallas
// kernel behind `flash_fwd_stats` and the forward of `_flash`).
//
// What it computes: for q [B, Sq, H, D] and k/v [B, Sk, H, D] (GQA already
// expanded), query row i sits at q_offset + i; o = softmax(q.k^T * scale,
// masked) . v in bf16 and lse = m + log(l) f32 [B*H, Sq], with the TPU
// kernel's online softmax step for step: masked scores -1e30, p = 0 where
// masked (a fully masked row keeps m = -1e30), l clamped to 1e-30, p
// rounded to bf16 before p.v. Rows past Sq are not written.
//
// Bound on the H100: operations. A causal layer at B=2, S=4096, H=32,
// D=128 does 4 * B*H * D * (S^2 / 2) = 275 GFLOP against 134 MB of q/k/v/o,
// about 2,000 operations per byte, so 0.278 ms at the card's 989 TFLOP/s.
//
// Design: one block of 4 warps per (batch*head, 64 query rows); each warp
// owns 16 rows and keeps them as tensor-core A fragments in registers. The
// block walks the key tiles (64 keys) in order, staging K and V in shared
// memory; q.k^T and p.v run as bf16 mma.sync m16n8k16 with f32
// accumulation, the softmax state (m, l, acc) stays in registers (the TPU
// kernel's VMEM scratch), and p goes from the score accumulators straight
// into the A fragments of p.v without touching shared memory. K/V tiles
// are double-buffered: the next tile's cp.async copies are in flight while
// the current one is multiplied. The softmax runs in log2 units (one exp2
// per score) and tiles that every row sees whole skip the mask. Causal
// blocks stop at the tile's deepest row; heavy (late) query tiles are
// scheduled first. wgmma and TMA are not used: that is later work.
#include "flash_attn_common.cuh"

namespace {

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per shared-memory tile

template <int D>
constexpr int smem_bytes() {   // q, two K/V stages, segment ids
  return (BQ + 4 * BK) * kfa::tile_stride<D>() * 2 + (BQ + 2 * BK) * 4;
}

template <int D>
__global__ void __launch_bounds__(kfa::kThreads) fwd_kernel(kfa::Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int TS = kfa::tile_stride<D>();
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* kv_s = q_s + BQ * TS;   // stage i: K at 2i, V at 2i + 1
  int* segq_s = reinterpret_cast<int*>(kv_s + 4 * BK * TS);
  int* segk_s = segq_s + BQ;             // stage i at i * BK

  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const bool segmented = p.seg_q != nullptr;

  kfa::load_tile<D, BQ>(q_s, p.q, b, h, q0, p.Sq, p.H);
  if (segmented)
    kfa::load_rows(segq_s, p.seg_q + b * p.seg_stride, q0, BQ, p.Sq, -1);
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc)
    kfa::load_a<D>(qf[kc], q_s, warp * 16, kc * 16);

  // this thread's two rows: r (fragment elements 0, 1) and r + 8 (2, 3)
  const int r = warp * 16 + g;
  const int qpos[2] = {p.q_offset + q0 + r, p.q_offset + q0 + r + 8};
  const int segq[2] = {segmented ? segq_s[r] : 0,
                       segmented ? segq_s[r + 8] : 0};

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {kfa::kNegInf, kfa::kNegInf}, l[2] = {0.f, 0.f};

  // scores, the running max m and p = exp2(s - m) are in log2 units
  const float scale2 = p.scale * kfa::kLog2e;
  // causal: keys past the tile's deepest row are visible to no row of it
  const int k_end = p.causal ? min(p.Sk, p.q_offset + q0 + BQ) : p.Sk;
  const int n_tiles = (k_end + BK - 1) / BK;
  auto prefetch = [&](int tile) {   // copies of K/V tile `tile` into its stage
    const int st = tile & 1, k0 = tile * BK;
    kfa::load_tile_async<D, BK>(kv_s + 2 * st * BK * TS, p.k, b, h, k0,
                                p.Sk, p.H);
    kfa::load_tile_async<D, BK>(kv_s + (2 * st + 1) * BK * TS, p.v, b, h,
                                k0, p.Sk, p.H);
    kfa::cp_async_commit();
    if (segmented)
      kfa::load_rows(segk_s + st * BK, p.seg_k + b * p.seg_stride, k0, BK,
                     p.Sk, -1);
  };
  if (n_tiles > 0) prefetch(0);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * BK, st = tile & 1;
    if (tile + 1 < n_tiles) {   // the stage it fills was freed by the
      prefetch(tile + 1);          // barrier that ended the previous tile
      kfa::cp_async_wait<1>();
    } else {
      kfa::cp_async_wait<0>();
    }
    __syncthreads();   // this tile's copies are visible to every warp
    const __nv_bfloat16* k_s = kv_s + 2 * st * BK * TS;
    const __nv_bfloat16* v_s = kv_s + (2 * st + 1) * BK * TS;
    const int* segk_t = segk_s + st * BK;

    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t bb[4];
        kfa::load_b_nk<D>(bb, k_s, np * 16, kc * 16);
        kfa::mma(s[2 * np], qf[kc], bb[0], bb[1]);
        kfa::mma(s[2 * np + 1], qf[kc], bb[2], bb[3]);
      }
    }

    // a tile every row sees whole needs no per-score mask
    const bool whole = !segmented && k0 + BK <= p.Sk &&
                       (!p.causal || k0 + BK - 1 <= p.q_offset + q0);
    float mx[2] = {kfa::kNegInf, kfa::kNegInf};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hi = e >> 1, col = n * 8 + t * 2 + (e & 1);
        const bool ok =
            whole || kfa::visible(qpos[hi], k0 + col, p.Sk, p.causal,
                                  segq[hi], segmented ? segk_t[col] : 0,
                                  segmented);
        const float x = ok ? s[n][e] * scale2 : kfa::kNegInf;
        s[n][e] = x;
        mx[hi] = fmaxf(mx[hi], x);
      }
    }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      corr[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hi = e >> 1;
        const float x = s[n][e];
        const float pe = x > kfa::kNegInf / 2 ? exp2f(x - m[hi]) : 0.f;
        s[n][e] = pe;
        sum[hi] += pe;
      }
    }
    // l is kept as this thread's partial sum; the quad adds up at the end
    l[0] = l[0] * corr[0] + sum[0];
    l[1] = l[1] * corr[1] + sum[1];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] *= corr[0]; acc[j][1] *= corr[0];
      acc[j][2] *= corr[1]; acc[j][3] *= corr[1];
    }
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      const uint32_t a[4] = {
          kfa::pack_bf16(s[2 * kc][0], s[2 * kc][1]),
          kfa::pack_bf16(s[2 * kc][2], s[2 * kc][3]),
          kfa::pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
          kfa::pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bb[4];
        kfa::load_b_kn<D>(bb, v_s, kc * 16, dp * 16);
        kfa::mma(acc[2 * dp], a, bb[0], bb[1]);
        kfa::mma(acc[2 * dp + 1], a, bb[2], bb[3]);
      }
    }
    __syncthreads();   // every warp is done with this stage
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = fmaxf(l[i], 1e-30f);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r + 8 * i;
    if (row >= p.Sq) continue;
    __nv_bfloat16* orow = p.out + ((long long)(b * p.Sq + row) * p.H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + t * 2) =
          __floats2bfloat162_rn(acc[j][2 * i] / l[i],
                                acc[j][2 * i + 1] / l[i]);
    // lse = m + log(l) in natural units (a fully masked row keeps -1e30)
    const float mn = m[i] > kfa::kNegInf / 2 ? m[i] * kfa::kLn2 : m[i];
    if (t == 0) p.lse_out[(long long)bh * p.Sq + row] = mn + logf(l[i]);
  }
}

template <int D>
cudaError_t launch(const kfa::Params& p, cudaStream_t stream) {
  constexpr int smem = smem_bytes<D>();
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  dim3 grid(p.B * p.H, (p.Sq + BQ - 1) / BQ);
  fwd_kernel<D><<<grid, kfa::kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// o [B, Sq, H, D] bf16 and lse [B*H, Sq] f32 for q [B, Sq, H, D] and k/v
// [B, Sk, H, D] bf16, all contiguous. seg_q/seg_k are null or int32 with
// rows seg_stride apart (query row i reads seg_q[b * seg_stride + i]).
extern "C" int kft_flash_attn_fwd(const void* q, const void* k, const void* v,
                                  const void* seg_q, const void* seg_k,
                                  void* o, void* lse, int B, int H, int Sq,
                                  int Sk, int D, long long seg_stride,
                                  int q_offset, int causal, float scale,
                                  void* stream) {
  if (B <= 0 || H <= 0 || Sq < 0 || Sk < 0 || q_offset < 0)
    return (int)cudaErrorInvalidValue;
  if (Sq == 0) return (int)cudaSuccess;
  kfa::Params p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.seg_q = static_cast<const int*>(seg_q);
  p.seg_k = static_cast<const int*>(seg_k);
  p.out = static_cast<__nv_bfloat16*>(o);
  p.lse_out = static_cast<float*>(lse);
  p.seg_stride = seg_stride;
  p.B = B; p.H = H; p.Sq = Sq; p.Sk = Sk;
  p.q_offset = q_offset; p.causal = causal; p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128) return (int)launch<128>(p, st);
  if (D == 64) return (int)launch<64>(p, st);
  return (int)cudaErrorInvalidValue;
}
