// B3: flash-attention backward, the key and value gradients.
//
// Replaces: kubeflow_tpu/ops/flash_pallas.py `_bwd_dkv_kernel` (the second
// of the two TPU Pallas kernels of `_bwd`).
//
// What it computes, per key: dv = sum over query rows of p^T . dO and dk =
// sum of ds^T . q, with p = exp(q.k^T * scale - lse) (0 where masked) and
// ds = p * (dO.v^T - delta) * scale, delta = rowsum(dO * O) computed
// outside the kernel. ds takes p in f32; p is rounded to bf16 before
// p^T . dO and ds before ds^T . q, as on the TPU. A key is visible to
// query row i iff k < Sk, k <= i when causal (q_offset is 0 in the
// backward) and its segment id equals the row's. Keys past Sk are not
// written.
//
// Bound on the H100: operations. Four products per visible (row, key)
// pair (k.q^T, v.dO^T, p^T.dO, ds^T.q): 8 * B*H * D * (S^2 / 2) = 550 GFLOP
// for a causal layer at B=2, S=4096, H=32, D=128, so 0.556 ms at 989
// TFLOP/s.
//
// Design: the Hopper block of sm90_primitives.cuh, one block per (128
// keys, batch * head), 384 threads.
//   Producer warpgroup: thread 0 loads the block's K and V once by TMA,
//   then streams q and dO tiles of 64 rows through a ring of kStages
//   stages; warp 1 puts each tile's lse (in log2 units), delta and query
//   segment ids into the same stage with plain loads (a TMA map needs
//   16-byte row strides, and S = 200 or 4000 must work). A stage's full
//   barrier waits for the TMA bytes and warp 1's 32 lanes, its empty
//   barrier for one arrival per consumer warp.
//   Consumer warpgroup w owns keys k0 + 64w .. k0 + 64w + 63, the wgmma M.
//   Per tile it computes the transposed scores, keys as rows:
//     S^T  = K.Q^T   wgmma m64n64k16, K and q both K-major (as the
//     dP^T = V.dO^T  forward's Q.K^T);
//   p^T and ds^T then sit in the accumulator layout, which is the register
//   A fragment layout, and are packed to bf16 pairs in place:
//     dV += P^T.dO   wgmma m64nDk16, dO read MN-major (as the forward's
//     dK += dS^T.Q   P.V), Q likewise.
//   dk and dv accumulate in registers over the query tiles in order, with
//   no atomics, so a launch is deterministic. Causal blocks start at the
//   first q tile that reaches their first key, and a warpgroup skips the
//   tiles wholly before its own first key; tiles that every pair sees
//   whole skip the mask. Key blocks vary fastest in the grid, in
//   ascending order: each head's heaviest blocks launch first, and the
//   blocks in flight share a few heads' q and dO in L2.
// Where it can go wrong:
//   - The MN-major descriptor of a 64-row tile has its 64-column regions
//     kBQ * 128 bytes apart (the forward's V: kBK * 128). A mismatch
//     gives wrong numbers, not a fault; chip_smoke's comparison with the
//     plain version is the check.
//   - Registers: at D = 128 a consumer thread holds dk and dv (64 f32
//     each) and s^T and dp^T (32 each); p and ds are packed to bf16 as s
//     and dp die, inside setmaxnreg's 240 (ptxas -v reports spills).
//   - Rows past Sq read zeros from TMA and lse = delta = 0; the mask
//     drops them, and the whole-tile path is taken only below Sq.
#include "sm90_primitives.cuh"

namespace {

constexpr int kBKeys = 128;   // keys per block, 64 per consumer warpgroup
constexpr int kBQ = 64;       // query rows per streamed tile
constexpr int kStages = 2;    // q/dO ring depth
constexpr int kLoaderLanes = 32;   // warp 1 of the producer warpgroup

struct Args {
  __nv_bfloat16* dk;    // [B, Sk, H, D]
  __nv_bfloat16* dv;
  const float* lse;     // [B*H, Sq]
  const float* delta;   // [B*H, Sq]
  const int* seg_q;     // null, or query row i of batch b at b*seg_stride+i
  const int* seg_k;     // key t of batch b at b*seg_stride + t
  long long seg_stride;
  int H, Sq, Sk, causal;
  float scale;
};

// Byte offsets of a block's shared memory (from a 1024-aligned base).
template <int D>
struct Smem {
  static constexpr int kKV = kBKeys * D * 2;   // K or V: [D/64][kBKeys][64]
  static constexpr int kTile = kBQ * D * 2;    // q or dO: [D/64][kBQ][64]
  static constexpr int kK = 0;
  static constexpr int kV = kKV;
  static constexpr int kRing = 2 * kKV;        // stage s: q, then dO
  // stage s: lse * log2(e) and delta [kBQ] f32, segment ids [kBQ] int32
  static constexpr int kRows = kRing + 2 * kStages * kTile;
  static constexpr int kRowBytes = 3 * kBQ * 4;
  static constexpr int kBars = kRows + kStages * kRowBytes;
  // full[kStages], empty[kStages], kv; plus room to align the base
  static constexpr int kBytes = kBars + (2 * kStages + 1) * 8 + 1024;
};

// Which (key, query row) pairs of a tile a consumer thread keeps.
struct Mask {
  int key[2];    // its two keys (accumulator rows)
  int seg[2];    // their segment ids
  int Sq, Sk;
  bool causal, segmented;
};

// p^T and ds^T of one tile, in place of s^T and dp^T. s[4j + 2i + e] is
// key i of the thread, query row q0 + 8j + 2t + e; rows holds the tile's
// lse * log2(e), delta and segment ids.
template <bool MASKED>
__device__ __forceinline__ void tile_grads(float (&s)[32], float (&dp)[32],
                                           const float* rows, int q0,
                                           const Mask& mk, float scale2,
                                           float scale) {
  const int t = threadIdx.x % 4;
  const float* lse2 = rows;
  const float* dlt = rows + kBQ;
  const int* segq = reinterpret_cast<const int*>(rows + 2 * kBQ);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c0 = 8 * j + 2 * t;
    const float2 l2 = *reinterpret_cast<const float2*>(lse2 + c0);
    const float2 dl = *reinterpret_cast<const float2*>(dlt + c0);
    int2 sq = make_int2(0, 0);
    if (MASKED && mk.segmented)
      sq = *reinterpret_cast<const int2*>(segq + c0);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int q = q0 + c0 + e;
      const float le = e ? l2.y : l2.x, de = e ? dl.y : dl.x;
      const int se = e ? sq.y : sq.x;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int idx = 4 * j + 2 * i + e;
        float p = sm90::exp2_fast(fmaf(s[idx], scale2, -le));
        if (MASKED) {
          const bool ok = (q < mk.Sq) & (mk.key[i] < mk.Sk) &
                          (!mk.causal | (mk.key[i] <= q)) &
                          (!mk.segmented | (se == mk.seg[i]));
          p = ok ? p : 0.f;
        }
        dp[idx] = p * (dp[idx] - de) * scale;
        s[idx] = p;
      }
    }
  }
}

// The register A fragments of a [64 x 64] accumulator rounded to bf16:
// a[kc] covers columns 16 kc .. 16 kc + 15.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4],
                                       const float (&x)[32]) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kc][r] = sm90::pack_bf16(x[8 * kc + 2 * r], x[8 * kc + 2 * r + 1]);
}

template <int D>
__global__ void __launch_bounds__(sm90::kThreads, 1)
dkv_kernel(const __grid_constant__ CUtensorMap qm,
           const __grid_constant__ CUtensorMap km,
           const __grid_constant__ CUtensorMap vm,
           const __grid_constant__ CUtensorMap dom, Args a) {
  using L = Smem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + kStages;
  uint64_t* kvbar = full + 2 * kStages;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.x * kBKeys;
  // causal: query tiles wholly before the block's first key see none of it
  // (k0 is a multiple of kBQ)
  const int q_begin = a.causal ? k0 : 0;
  const int n_tiles = a.Sq > q_begin ? (a.Sq - q_begin + kBQ - 1) / kBQ : 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(full + s, 1 + kLoaderLanes);
      sm90::mbar_init(empty + s, sm90::kConsumerWarps);
    }
    sm90::mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    sm90::producer_regs();
    if (threadIdx.x == 0) {   // every TMA load
      sm90::mbar_expect_tx(kvbar, 2 * L::kKV);
      for (int c = 0; c < D / 64; ++c) {
        sm90::tma_load(smem + L::kK + c * kBKeys * 128, &km, c * 64, h, k0,
                       b, kvbar);
        sm90::tma_load(smem + L::kV + c * kBKeys * 128, &vm, c * 64, h, k0,
                       b, kvbar);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages, q0 = q_begin + i * kBQ;
        sm90::mbar_wait(empty + st, ((i / kStages) & 1) ^ 1);
        sm90::mbar_expect_tx(full + st, 2 * L::kTile);
        uint8_t* qt = smem + L::kRing + 2 * st * L::kTile;
        for (int c = 0; c < D / 64; ++c) {
          sm90::tma_load(qt + c * kBQ * 128, &qm, c * 64, h, q0, b,
                         full + st);
          sm90::tma_load(qt + L::kTile + c * kBQ * 128, &dom, c * 64, h, q0,
                         b, full + st);
        }
      }
    } else if (threadIdx.x / 32 == 1) {   // each tile's per-row values
      const int lane = threadIdx.x % 32;
      const float* lse = a.lse + (long long)bh * a.Sq;
      const float* delta = a.delta + (long long)bh * a.Sq;
      const int* seg_q =
          a.seg_q == nullptr ? nullptr : a.seg_q + b * a.seg_stride;
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages, q0 = q_begin + i * kBQ;
        sm90::mbar_wait(empty + st, ((i / kStages) & 1) ^ 1);
        float* rows =
            reinterpret_cast<float*>(smem + L::kRows + st * L::kRowBytes);
        for (int r = lane; r < kBQ; r += 32) {
          const int q = q0 + r;
          const bool in = q < a.Sq;
          rows[r] = in ? lse[q] * sm90::kLog2e : 0.f;
          rows[kBQ + r] = in ? delta[q] : 0.f;
          reinterpret_cast<int*>(rows)[2 * kBQ + r] =
              seg_q != nullptr && in ? seg_q[q] : -1;
        }
        sm90::mbar_arrive(full + st);
      }
    }
    return;
  }
  sm90::consumer_regs();

  const int wg = threadIdx.x / 128 - 1, lane = threadIdx.x % 32;
  const int t = lane % 4;
  const int kw0 = k0 + 64 * wg;   // this warpgroup's first key
  Mask mk;
  mk.Sq = a.Sq;
  mk.Sk = a.Sk;
  mk.causal = a.causal != 0;
  mk.segmented = a.seg_q != nullptr;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mk.key[i] = k0 + sm90::row(i);
    mk.seg[i] = mk.segmented && mk.key[i] < a.Sk
                    ? a.seg_k[b * a.seg_stride + mk.key[i]] : -1;
  }
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) dk[j] = dv[j] = 0.f;
  const float scale2 = a.scale * sm90::kLog2e;
  // this warpgroup's 64 rows of each K and V region
  const uint32_t k_addr = sm90::smem_u32(smem + L::kK) + wg * 64 * 128;
  const uint32_t v_addr = sm90::smem_u32(smem + L::kV) + wg * 64 * 128;
  sm90::mbar_wait(kvbar, 0);

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kStages, q0 = q_begin + i * kBQ;
    sm90::mbar_wait(full + st, (i / kStages) & 1);
    // no pair of this warpgroup's keys and the tile's rows is visible when
    // its keys are all padding or, causal, all after the tile's last row
    const bool live = kw0 < a.Sk && (!mk.causal || q0 + kBQ - 1 >= kw0);
    if (live) {
      const uint32_t q_addr =
          sm90::smem_u32(smem + L::kRing + 2 * st * L::kTile);
      const uint32_t do_addr = q_addr + L::kTile;
      // S^T = K.Q^T and dP^T = V.dO^T: D/16 steps of 16 along the head
      // dim, 32 bytes apart in a 128-byte swizzle row, then the next
      // 64-column region
      float s[32], dp[32];
      sm90::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc)
        sm90::Wgmma<64>::ss(
            s,
            sm90::desc(k_addr + kc / 4 * kBKeys * 128 + kc % 4 * 32, 16,
                       1024),
            sm90::desc(q_addr + kc / 4 * kBQ * 128 + kc % 4 * 32, 16, 1024),
            kc);
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc)
        sm90::Wgmma<64>::ss(
            dp,
            sm90::desc(v_addr + kc / 4 * kBKeys * 128 + kc % 4 * 32, 16,
                       1024),
            sm90::desc(do_addr + kc / 4 * kBQ * 128 + kc % 4 * 32, 16,
                       1024),
            kc);
      sm90::wgmma_commit();
      sm90::wgmma_wait();
      sm90::fence_regs(s);
      sm90::fence_regs(dp);

      const float* rows = reinterpret_cast<const float*>(
          smem + L::kRows + st * L::kRowBytes);
      const bool whole = !mk.segmented && kw0 + 64 <= a.Sk &&
                         q0 + kBQ <= a.Sq &&
                         (!mk.causal || q0 >= kw0 + 63);
      if (whole)
        tile_grads<false>(s, dp, rows, q0, mk, scale2, a.scale);
      else
        tile_grads<true>(s, dp, rows, q0, mk, scale2, a.scale);

      // dV += P^T.dO and dK += dS^T.Q: 4 steps of 16 query rows (two
      // 8-row swizzle atoms, 2048 bytes); dO and q are MN-major, their
      // 64-column regions kBQ * 128 bytes apart. Every A fragment is
      // packed before the fence, so no wgmma waits on a register write.
      uint32_t pa[4][4], da[4][4];
      pack_a(pa, s);
      pack_a(da, dp);
      sm90::fence_regs(dv);
      sm90::fence_regs(dk);
      sm90::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
        sm90::Wgmma<D>::rs(dv, pa[kc],
                           sm90::desc(do_addr + kc * 2048, kBQ * 128, 1024));
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
        sm90::Wgmma<D>::rs(dk, da[kc],
                           sm90::desc(q_addr + kc * 2048, kBQ * 128, 1024));
      sm90::wgmma_commit();
      sm90::wgmma_wait();
      sm90::fence_regs(dv);
      sm90::fence_regs(dk);
    }
    if (lane == 0) sm90::mbar_arrive(empty + st);   // q, dO and rows free
  }

  // dk[4j + 2i + e] is key i of the thread, column 8j + 2t + e
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (mk.key[i] >= a.Sk) continue;
    const long long off = ((long long)(b * a.Sk + mk.key[i]) * a.H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(a.dk + off + 8 * j + 2 * t) =
          __floats2bfloat162_rn(dk[4 * j + 2 * i], dk[4 * j + 2 * i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(a.dv + off + 8 * j + 2 * t) =
          __floats2bfloat162_rn(dv[4 * j + 2 * i], dv[4 * j + 2 * i + 1]);
    }
  }
}

template <int D>
cudaError_t launch(const CUtensorMap& qm, const CUtensorMap& km,
                   const CUtensorMap& vm, const CUtensorMap& dom,
                   const Args& a, int B, cudaStream_t stream) {
  constexpr int smem = Smem<D>::kBytes;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  dim3 grid((a.Sk + kBKeys - 1) / kBKeys, B * a.H);
  dkv_kernel<D><<<grid, sm90::kThreads, smem, stream>>>(qm, km, vm, dom, a);
  return cudaGetLastError();
}

}  // namespace

// dk, dv [B, Sk, H, D] bf16 from q, dout [B, Sq, H, D], k/v [B, Sk, H, D]
// bf16 and lse, delta [B*H, Sq] f32, all contiguous (16-byte aligned for
// the TMA maps); segment ids as in kft_flash_attn_fwd.
extern "C" int kft_flash_attn_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, const void* seg_q,
                                  const void* seg_k, void* dk, void* dv,
                                  int B, int H, int Sq, int Sk, int D,
                                  long long seg_stride, int causal,
                                  float scale, void* stream) {
  if (B <= 0 || H <= 0 || Sq < 0 || Sk < 0 || (D != 64 && D != 128))
    return (int)cudaErrorInvalidValue;
  if (Sk == 0) return (int)cudaSuccess;
  CUtensorMap qm, km, vm, dom;
  const long long row = (long long)H * D, rows_q = Sq > 0 ? Sq : 1;
  const bool ok =
      sm90::tensor_map(&qm, q, false, D, H, Sq, B, D, row, rows_q * row, 64,
                       1, kBQ) &&
      sm90::tensor_map(&dom, dout, false, D, H, Sq, B, D, row, rows_q * row,
                       64, 1, kBQ) &&
      sm90::tensor_map(&km, k, false, D, H, Sk, B, D, row, Sk * row, 64, 1,
                       kBKeys) &&
      sm90::tensor_map(&vm, v, false, D, H, Sk, B, D, row, Sk * row, 64, 1,
                       kBKeys);
  if (!ok) return (int)cudaErrorInvalidValue;
  Args a{static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
         static_cast<const float*>(lse), static_cast<const float*>(delta),
         static_cast<const int*>(seg_q), static_cast<const int*>(seg_k),
         seg_stride, H, Sq, Sk, causal, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128) return (int)launch<128>(qm, km, vm, dom, a, B, st);
  return (int)launch<64>(qm, km, vm, dom, a, B, st);
}
