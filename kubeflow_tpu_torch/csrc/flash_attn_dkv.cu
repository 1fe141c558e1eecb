// B3: flash-attention backward, the key and value gradients.
//
// Replaces: kubeflow_tpu/ops/flash_pallas.py `_bwd_dkv_kernel` (the second
// of the two TPU Pallas kernels of `_bwd`).
//
// What it computes, per key: dv = sum over query rows of p^T . dO and dk =
// sum of ds^T . q, with p = exp(q.k^T * scale - lse) (0 where masked) and
// ds = p * (dO.v^T - delta) * scale, delta = rowsum(dO * O) computed
// outside the kernel. p is rounded to bf16 before p^T . dO and ds before
// ds^T . q, as on the TPU. Keys past Sk are not written.
//
// Bound on the H100: operations. Four products per visible (row, key)
// pair (k.q^T, v.dO^T, p^T.dO, ds^T.q): 8 * B*H * D * (S^2 / 2) = 550 GFLOP
// for a causal layer at B=2, S=4096, H=32, D=128, so 0.556 ms at 989
// TFLOP/s.
//
// Design: the transpose of B2. One block of 4 warps per (batch*head, 64
// keys), each warp 16 keys; K and V stay in shared memory, q and dO tiles
// of 32 rows stream through it in two stages (cp.async, the next tile's
// copies in flight during the current one) with their lse, delta and
// segment ids. The warp computes the transposed scores k.q^T and dp^T =
// v.dO^T (keys as rows), so p^T and ds^T come out of the accumulators
// already in the A layout of p^T . dO and ds^T . q (p as one exp2 of
// log2-scaled scores; tiles every row sees whole skip the mask). dk and dv
// accumulate in registers over the query rows in order, with no atomics,
// so a launch is deterministic. Causal blocks start at the first query
// tile that reaches their first key.
#include "flash_attn_common.cuh"

namespace {

constexpr int BK = 64;   // keys per block
constexpr int BQ = 32;   // query rows per shared-memory tile

template <int D>
constexpr int smem_bytes() {   // K, V, two q/dO stages, two row stages
  return (2 * BK + 4 * BQ) * kfa::tile_stride<D>() * 2 + 6 * BQ * 4;
}

template <int D>
__global__ void __launch_bounds__(kfa::kThreads) dkv_kernel(kfa::Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int TS = kfa::tile_stride<D>();
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* v_s = k_s + BK * TS;
  __nv_bfloat16* qdo_s = v_s + BK * TS;   // stage i: q at 2i, dO at 2i + 1
  float* rows_s = reinterpret_cast<float*>(qdo_s + 4 * BQ * TS);
  // stage i: lse at rows_s + 3 * BQ * i, delta after it, then segment ids

  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int k0 = blockIdx.y * BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const bool segmented = p.seg_q != nullptr;

  kfa::load_tile<D, BK>(k_s, p.k, b, h, k0, p.Sk, p.H);
  kfa::load_tile<D, BK>(v_s, p.v, b, h, k0, p.Sk, p.H);

  // this thread's two keys: fragment elements 0, 1 and 2, 3
  const int r = warp * 16 + g;
  int key[2], segk[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    key[i] = k0 + r + 8 * i;
    segk[i] = segmented && key[i] < p.Sk
                  ? p.seg_k[b * p.seg_stride + key[i]] : -1;
  }

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  const float* lse_bh = p.lse + (long long)bh * p.Sq;
  const float* delta_bh = p.delta + (long long)bh * p.Sq;
  const float scale2 = p.scale * kfa::kLog2e;   // p = exp2 in log2 units
  // causal: query tiles wholly before this block's first key see none of it
  const int q_begin = p.causal ? (k0 / BQ) * BQ : 0;
  const int n_tiles = p.Sq > q_begin ? (p.Sq - q_begin + BQ - 1) / BQ : 0;
  auto prefetch = [&](int tile) {   // copies of q/dO tile `tile` into its stage
    const int st = tile & 1, q0 = q_begin + tile * BQ;
    kfa::load_tile_async<D, BQ>(qdo_s + 2 * st * BQ * TS, p.q, b, h, q0,
                                p.Sq, p.H);
    kfa::load_tile_async<D, BQ>(qdo_s + (2 * st + 1) * BQ * TS, p.dout, b,
                                h, q0, p.Sq, p.H);
    kfa::cp_async_commit();
    float* rs = rows_s + 3 * BQ * st;
    kfa::load_rows(rs, lse_bh, q0, BQ, p.Sq, 0.f);
    kfa::load_rows(rs + BQ, delta_bh, q0, BQ, p.Sq, 0.f);
    if (segmented)
      kfa::load_rows(reinterpret_cast<int*>(rs + 2 * BQ),
                     p.seg_q + b * p.seg_stride, q0, BQ, p.Sq, -1);
  };
  __syncthreads();   // K and V are in place
  if (n_tiles > 0) prefetch(0);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int q0 = q_begin + tile * BQ, st = tile & 1;
    if (tile + 1 < n_tiles) {   // its stage was freed by the last barrier
      prefetch(tile + 1);
      kfa::cp_async_wait<1>();
    } else {
      kfa::cp_async_wait<0>();
    }
    __syncthreads();   // this tile's copies are visible to every warp
    const __nv_bfloat16* q_s = qdo_s + 2 * st * BQ * TS;
    const __nv_bfloat16* do_s = qdo_s + (2 * st + 1) * BQ * TS;
    const float* lse_s = rows_s + 3 * BQ * st;
    const float* delta_s = lse_s + BQ;
    const int* segq_s = reinterpret_cast<const int*>(lse_s + 2 * BQ);

    // transposed scores s^T = k.q^T and dp^T = v.dO^T: 16 keys x 32 rows
    float s[BQ / 8][4], dp[BQ / 8][4];
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t ak[4], av[4];
      kfa::load_a<D>(ak, k_s, warp * 16, kc * 16);
      kfa::load_a<D>(av, v_s, warp * 16, kc * 16);
#pragma unroll
      for (int np = 0; np < BQ / 16; ++np) {
        uint32_t bb[4];
        kfa::load_b_nk<D>(bb, q_s, np * 16, kc * 16);
        kfa::mma(s[2 * np], ak, bb[0], bb[1]);
        kfa::mma(s[2 * np + 1], ak, bb[2], bb[3]);
        kfa::load_b_nk<D>(bb, do_s, np * 16, kc * 16);
        kfa::mma(dp[2 * np], av, bb[0], bb[1]);
        kfa::mma(dp[2 * np + 1], av, bb[2], bb[3]);
      }
    }
    // s becomes p^T, dp becomes ds^T; a tile whose every row sees every
    // key of the block needs no per-score mask
    const bool whole = !segmented && k0 + BK <= p.Sk && q0 + BQ <= p.Sq &&
                       (!p.causal || q0 >= k0 + BK - 1);
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hi = e >> 1, col = n * 8 + t * 2 + (e & 1);
        const int qpos = q0 + col;
        const bool ok =
            whole || (qpos < p.Sq &&
                      kfa::visible(qpos, key[hi], p.Sk, p.causal,
                                   segmented ? segq_s[col] : 0, segk[hi],
                                   segmented));
        const float pe =
            ok ? exp2f(s[n][e] * scale2 - lse_s[col] * kfa::kLog2e) : 0.f;
        s[n][e] = pe;
        dp[n][e] = pe * (dp[n][e] - delta_s[col]) * p.scale;
      }
    }
#pragma unroll
    for (int kc = 0; kc < BQ / 16; ++kc) {
      const uint32_t ap[4] = {
          kfa::pack_bf16(s[2 * kc][0], s[2 * kc][1]),
          kfa::pack_bf16(s[2 * kc][2], s[2 * kc][3]),
          kfa::pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
          kfa::pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
      const uint32_t ads[4] = {
          kfa::pack_bf16(dp[2 * kc][0], dp[2 * kc][1]),
          kfa::pack_bf16(dp[2 * kc][2], dp[2 * kc][3]),
          kfa::pack_bf16(dp[2 * kc + 1][0], dp[2 * kc + 1][1]),
          kfa::pack_bf16(dp[2 * kc + 1][2], dp[2 * kc + 1][3])};
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t bb[4];
        kfa::load_b_kn<D>(bb, do_s, kc * 16, dn * 16);
        kfa::mma(dv[2 * dn], ap, bb[0], bb[1]);
        kfa::mma(dv[2 * dn + 1], ap, bb[2], bb[3]);
        kfa::load_b_kn<D>(bb, q_s, kc * 16, dn * 16);
        kfa::mma(dk[2 * dn], ads, bb[0], bb[1]);
        kfa::mma(dk[2 * dn + 1], ads, bb[2], bb[3]);
      }
    }
    __syncthreads();   // every warp is done with this stage
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key[i] >= p.Sk) continue;
    const long long off = ((long long)(b * p.Sk + key[i]) * p.H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(p.dk + off + j * 8 + t * 2) =
          __floats2bfloat162_rn(dk[j][2 * i], dk[j][2 * i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(p.dv + off + j * 8 + t * 2) =
          __floats2bfloat162_rn(dv[j][2 * i], dv[j][2 * i + 1]);
    }
  }
}

template <int D>
cudaError_t launch(const kfa::Params& p, cudaStream_t stream) {
  constexpr int smem = smem_bytes<D>();
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  dim3 grid(p.B * p.H, (p.Sk + BK - 1) / BK);
  dkv_kernel<D><<<grid, kfa::kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dk, dv [B, Sk, H, D] bf16 from q, dout [B, Sq, H, D], k/v [B, Sk, H, D]
// bf16 and lse, delta [B*H, Sq] f32, all contiguous; segment ids as in
// kft_flash_attn_fwd.
extern "C" int kft_flash_attn_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, const void* seg_q,
                                  const void* seg_k, void* dk, void* dv,
                                  int B, int H, int Sq, int Sk, int D,
                                  long long seg_stride, int causal,
                                  float scale, void* stream) {
  if (B <= 0 || H <= 0 || Sq < 0 || Sk < 0) return (int)cudaErrorInvalidValue;
  if (Sk == 0) return (int)cudaSuccess;
  kfa::Params p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.seg_q = static_cast<const int*>(seg_q);
  p.seg_k = static_cast<const int*>(seg_k);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.seg_stride = seg_stride;
  p.B = B; p.H = H; p.Sq = Sq; p.Sk = Sk;
  p.causal = causal; p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128) return (int)launch<128>(p, st);
  if (D == 64) return (int)launch<64>(p, st);
  return (int)cudaErrorInvalidValue;
}
