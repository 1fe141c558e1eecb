// B2: flash-attention backward, the query gradient.
//
// Replaces: kubeflow_tpu/ops/flash_pallas.py `_bwd_dq_kernel` (the first
// of the two TPU Pallas kernels of `_bwd`, behind `flash_bwd_grads` and the
// backward of `_flash`).
//
// What it computes: dq = sum over keys of [p * (dp - delta)] . k * scale,
// with p = exp(q.k^T * scale - lse) (0 where masked), dp = dO . v^T and
// delta = rowsum(dO * O) computed outside the kernel, as the TPU version
// does. ds is rounded to bf16 before ds . k. q_offset is 0 (the training
// path); rows past Sq are not written.
//
// Bound on the H100: operations. Three products per visible (row, key)
// pair (q.k^T, dO.v^T, ds.k): 6 * B*H * D * (S^2 / 2) = 412 GFLOP for a
// causal layer at B=2, S=4096, H=32, D=128, so 0.417 ms at 989 TFLOP/s.
//
// Design: one block of 4 warps per (batch*head, 64 query rows), each warp
// 16 rows; q and dO stay in shared memory for the whole block, K and V
// tiles of 32 keys stream through it in two stages (the next tile's
// cp.async copies fly while the current one is used). p is taken as one
// exp2 of log2-scaled scores, and tiles every row sees whole skip the
// mask. All
// three products are bf16 mma.sync m16n8k16 with f32 accumulation; ds
// goes from the accumulators straight into the A fragments of ds . k. dq
// accumulates in registers over the keys in order, with no atomics, so a
// launch is deterministic. Causal blocks stop at the tile's deepest row.
#include "flash_attn_common.cuh"

namespace {

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 32;   // keys per shared-memory stage: with q and dO
                         // resident, 70 KB a block keeps 3 blocks per SM

template <int D>
constexpr int smem_bytes() {   // q, dO, two K/V stages, segment ids
  return (2 * BQ + 4 * BK) * kfa::tile_stride<D>() * 2 + (BQ + 2 * BK) * 4;
}

template <int D>
__global__ void __launch_bounds__(kfa::kThreads) dq_kernel(kfa::Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int TS = kfa::tile_stride<D>();
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* do_s = q_s + BQ * TS;
  __nv_bfloat16* kv_s = do_s + BQ * TS;   // stage i: K at 2i, V at 2i + 1
  int* segq_s = reinterpret_cast<int*>(kv_s + 4 * BK * TS);
  int* segk_s = segq_s + BQ;              // stage i at i * BK

  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const bool segmented = p.seg_q != nullptr;

  kfa::load_tile<D, BQ>(q_s, p.q, b, h, q0, p.Sq, p.H);
  kfa::load_tile<D, BQ>(do_s, p.dout, b, h, q0, p.Sq, p.H);
  if (segmented)
    kfa::load_rows(segq_s, p.seg_q + b * p.seg_stride, q0, BQ, p.Sq, -1);
  __syncthreads();

  const int r = warp * 16 + g;
  int row[2], segq[2];
  float lse[2], delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = q0 + r + 8 * i;
    const bool live = row[i] < p.Sq;
    // in log2 units: p = exp2(s * scale * log2(e) - lse * log2(e))
    lse[i] = live ? p.lse[(long long)bh * p.Sq + row[i]] * kfa::kLog2e : 0.f;
    delta[i] = live ? p.delta[(long long)bh * p.Sq + row[i]] : 0.f;
    segq[i] = segmented ? segq_s[r + 8 * i] : 0;
  }

  float dq[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
    dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;

  const float scale2 = p.scale * kfa::kLog2e;
  const int k_end = p.causal ? min(p.Sk, q0 + BQ) : p.Sk;
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
    if (tile + 1 < n_tiles) {   // its stage was freed by the last barrier
      prefetch(tile + 1);
      kfa::cp_async_wait<1>();
    } else {
      kfa::cp_async_wait<0>();
    }
    __syncthreads();   // this tile's copies are visible to every warp
    const __nv_bfloat16* k_s = kv_s + 2 * st * BK * TS;
    const __nv_bfloat16* v_s = kv_s + (2 * st + 1) * BK * TS;
    const int* segk_t = segk_s + st * BK;

#pragma unroll
    for (int kb = 0; kb < BK; kb += 32) {
      float s[4][4], dp[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        uint32_t aq[4], ado[4];
        kfa::load_a<D>(aq, q_s, warp * 16, kc * 16);
        kfa::load_a<D>(ado, do_s, warp * 16, kc * 16);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t bb[4];
          kfa::load_b_nk<D>(bb, k_s, kb + np * 16, kc * 16);
          kfa::mma(s[2 * np], aq, bb[0], bb[1]);
          kfa::mma(s[2 * np + 1], aq, bb[2], bb[3]);
          kfa::load_b_nk<D>(bb, v_s, kb + np * 16, kc * 16);
          kfa::mma(dp[2 * np], ado, bb[0], bb[1]);
          kfa::mma(dp[2 * np + 1], ado, bb[2], bb[3]);
        }
      }
      // s becomes ds = p * (dp - delta) * scale; a tile every live row
      // sees whole needs no per-score mask
      const bool whole = !segmented && k0 + BK <= p.Sk && q0 + BQ <= p.Sq &&
                         (!p.causal || k0 + BK - 1 <= q0);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hi = e >> 1, col = kb + n * 8 + t * 2 + (e & 1);
          const bool ok =
              whole ||
              (row[hi] < p.Sq &&
               kfa::visible(row[hi], k0 + col, p.Sk, p.causal, segq[hi],
                            segmented ? segk_t[col] : 0, segmented));
          const float pe = ok ? exp2f(s[n][e] * scale2 - lse[hi]) : 0.f;
          s[n][e] = pe * (dp[n][e] - delta[hi]) * p.scale;
        }
      }
#pragma unroll
      for (int kc = 0; kc < 2; ++kc) {
        const uint32_t a[4] = {
            kfa::pack_bf16(s[2 * kc][0], s[2 * kc][1]),
            kfa::pack_bf16(s[2 * kc][2], s[2 * kc][3]),
            kfa::pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
            kfa::pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
        for (int dn = 0; dn < D / 16; ++dn) {
          uint32_t bb[4];
          kfa::load_b_kn<D>(bb, k_s, kb + kc * 16, dn * 16);
          kfa::mma(dq[2 * dn], a, bb[0], bb[1]);
          kfa::mma(dq[2 * dn + 1], a, bb[2], bb[3]);
        }
      }
    }
    __syncthreads();   // every warp is done with this stage
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= p.Sq) continue;
    __nv_bfloat16* out = p.out + ((long long)(b * p.Sq + row[i]) * p.H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + j * 8 + t * 2) =
          __floats2bfloat162_rn(dq[j][2 * i], dq[j][2 * i + 1]);
  }
}

template <int D>
cudaError_t launch(const kfa::Params& p, cudaStream_t stream) {
  constexpr int smem = smem_bytes<D>();
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  dim3 grid(p.B * p.H, (p.Sq + BQ - 1) / BQ);
  dq_kernel<D><<<grid, kfa::kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dq [B, Sq, H, D] bf16 from q, dout [B, Sq, H, D], k/v [B, Sk, H, D] bf16
// and lse, delta [B*H, Sq] f32, all contiguous; segment ids as in
// kft_flash_attn_fwd.
extern "C" int kft_flash_attn_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, const void* seg_q,
                                 const void* seg_k, void* dq, int B, int H,
                                 int Sq, int Sk, int D, long long seg_stride,
                                 int causal, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Sq < 0 || Sk < 0) return (int)cudaErrorInvalidValue;
  if (Sq == 0) return (int)cudaSuccess;
  kfa::Params p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.seg_q = static_cast<const int*>(seg_q);
  p.seg_k = static_cast<const int*>(seg_k);
  p.out = static_cast<__nv_bfloat16*>(dq);
  p.seg_stride = seg_stride;
  p.B = B; p.H = H; p.Sq = Sq; p.Sk = Sk;
  p.causal = causal; p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128) return (int)launch<128>(p, st);
  if (D == 64) return (int)launch<64>(p, st);
  return (int)cudaErrorInvalidValue;
}
