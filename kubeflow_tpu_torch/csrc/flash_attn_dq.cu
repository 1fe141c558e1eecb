// B2: flash-attention backward, the query gradient.
//
// Replaces: kubeflow_tpu/ops/flash_pallas.py `_bwd_dq_kernel` (the first
// of the two TPU Pallas kernels of `_bwd`, behind `flash_bwd_grads` and the
// backward of `_flash`).
//
// What it computes: dq = sum over keys of [p * (dp - delta)] . k * scale,
// with p = exp(q.k^T * scale - lse) (0 where masked), dp = dO . v^T and
// delta = rowsum(dO * O) computed outside the kernel, as the TPU version
// does. ds takes p in f32 and is rounded to bf16 before ds . k. A key is
// visible to query row i iff k < Sk, k <= i when causal (q_offset is 0 in
// the backward) and its segment id equals the row's. Rows past Sq are not
// written.
//
// Bound on the H100: operations. Three products per visible (row, key)
// pair (q.k^T, dO.v^T, ds.k): 6 * B*H * D * (S^2 / 2) = 412 GFLOP for a
// causal layer at B=2, S=4096, H=32, D=128, so 0.417 ms at 989 TFLOP/s.
//
// Design: the Hopper block of sm90_primitives.cuh, one block per (128
// query rows, batch * head), 384 threads.
//   Producer: one thread loads the block's q and dO once by TMA, then
//   streams K and V tiles of 128 keys through a ring of kStages stages
//   (full barrier: the TMA bytes; empty: one arrival per consumer warp).
//   Consumer warpgroup w owns rows q0 + 64w .. q0 + 64w + 63, the wgmma
//   M, with their lse, delta and segment ids in registers. Per tile:
//     S  = Q.K^T    wgmma m64n128k16, q and K both K-major (as the
//     dP = dO.V^T   forward's Q.K^T), committed as two groups so that p
//                   is computed while dP runs;
//   ds = p (dp - delta) scale from the f32 p, packed to bf16 pairs as the
//   register A operand (the accumulator layout is the A fragment layout):
//     dQ += dS.K    wgmma m64nDk16, K read MN-major (as the forward's P.V).
//   Key segment ids are read with __ldg on the tiles that need a mask,
//   once per key for both of a thread's rows; tiles that every pair sees
//   whole skip the mask. dq accumulates in registers over the keys in
//   order, with no atomics, so a launch is deterministic. Causal blocks
//   stop at their deepest row, and the heavy (late) query blocks of each
//   head launch first; query blocks vary fastest, so the blocks in flight
//   share a few heads' K and V in L2.
// Where it can go wrong:
//   - The MN-major descriptor of a K tile has its 64-column regions
//     kBK * 128 bytes apart; a mismatch gives wrong numbers, not a fault,
//     and chip_smoke's comparison with the plain version is the check.
//   - Registers: at D = 128 a consumer thread holds dq, s and dp (64 f32
//     each), inside setmaxnreg's 240 (ptxas -v reports spills); 64-key
//     tiles, which need half of s and dp, were slower (PERF.md).
#include "sm90_primitives.cuh"

namespace {

constexpr int kBQ = 128;     // query rows per block, 64 per consumer
constexpr int kBK = 128;     // keys per streamed tile
constexpr int kStages = 2;   // K/V ring depth

struct Args {
  __nv_bfloat16* dq;    // [B, Sq, H, D]
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
  static constexpr int kQD = kBQ * D * 2;    // q or dO: [D/64][kBQ][64]
  static constexpr int kTile = kBK * D * 2;  // K or V: [D/64][kBK][64]
  static constexpr int kQ = 0;
  static constexpr int kDO = kQD;
  static constexpr int kRing = 2 * kQD;      // stage s: K, then V
  static constexpr int kBars = kRing + 2 * kStages * kTile;
  // full[kStages], empty[kStages], q; plus room to align the base
  static constexpr int kBytes = kBars + (2 * kStages + 1) * 8 + 1024;
};

template <int D>
__global__ void __launch_bounds__(sm90::kThreads, 1)
dq_kernel(const __grid_constant__ CUtensorMap qm,
          const __grid_constant__ CUtensorMap km,
          const __grid_constant__ CUtensorMap vm,
          const __grid_constant__ CUtensorMap dom, Args a) {
  using L = Smem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = full + 2 * kStages;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;   // heavy first
  // causal: keys past the block's deepest row are visible to no row of it
  const int k_end = a.causal ? min(a.Sk, q0 + kBQ) : a.Sk;
  const int n_tiles = (k_end + kBK - 1) / kBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(full + s, 1);
      sm90::mbar_init(empty + s, sm90::kConsumerWarps);
    }
    sm90::mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    sm90::producer_regs();
    if (threadIdx.x == 0) {
      sm90::mbar_expect_tx(qbar, 2 * L::kQD);
      for (int c = 0; c < D / 64; ++c) {
        sm90::tma_load(smem + L::kQ + c * kBQ * 128, &qm, c * 64, h, q0, b,
                       qbar);
        sm90::tma_load(smem + L::kDO + c * kBQ * 128, &dom, c * 64, h, q0,
                       b, qbar);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages;
        sm90::mbar_wait(empty + st, ((i / kStages) & 1) ^ 1);
        sm90::mbar_expect_tx(full + st, 2 * L::kTile);
        uint8_t* kt = smem + L::kRing + 2 * st * L::kTile;
        for (int c = 0; c < D / 64; ++c) {
          sm90::tma_load(kt + c * kBK * 128, &km, c * 64, h, i * kBK, b,
                         full + st);
          sm90::tma_load(kt + L::kTile + c * kBK * 128, &vm, c * 64, h,
                         i * kBK, b, full + st);
        }
      }
    }
    return;
  }
  sm90::consumer_regs();

  const int wg = threadIdx.x / 128 - 1, lane = threadIdx.x % 32;
  const int t = lane % 4;
  const int qw0 = q0 + 64 * wg;   // this warpgroup's first row
  const bool causal = a.causal != 0, segmented = a.seg_q != nullptr;
  const int* seg_k = segmented ? a.seg_k + b * a.seg_stride : nullptr;
  int pos[2], seg[2];
  float lse2[2], dlt[2];   // lse in log2 units, delta
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    pos[i] = q0 + sm90::row(i);
    const bool in = pos[i] < a.Sq;
    const long long r = (long long)bh * a.Sq + pos[i];
    lse2[i] = in ? a.lse[r] * sm90::kLog2e : 0.f;
    dlt[i] = in ? a.delta[r] : 0.f;
    seg[i] = segmented && in ? a.seg_q[b * a.seg_stride + pos[i]] : -1;
  }
  float dq[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) dq[j] = 0.f;
  const float scale2 = a.scale * sm90::kLog2e, scale = a.scale;
  // this warpgroup's 64 rows of each q and dO region
  const uint32_t q_addr = sm90::smem_u32(smem + L::kQ) + wg * 64 * 128;
  const uint32_t do_addr = sm90::smem_u32(smem + L::kDO) + wg * 64 * 128;
  sm90::mbar_wait(qbar, 0);

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kStages, k0 = i * kBK;
    sm90::mbar_wait(full + st, (i / kStages) & 1);
    const uint32_t k_addr = sm90::smem_u32(smem + L::kRing + 2 * st * L::kTile);
    const uint32_t v_addr = k_addr + L::kTile;
    // S = Q.K^T, then dP = dO.V^T, as two groups: p is computed while dP
    // runs. D/16 steps of 16 along the head dim, 32 bytes apart in a
    // 128-byte swizzle row, then the next 64-column region.
    float s[kBK / 2], dp[kBK / 2];
    sm90::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc)
      sm90::Wgmma<kBK>::ss(
          s,
          sm90::desc(q_addr + kc / 4 * kBQ * 128 + kc % 4 * 32, 16, 1024),
          sm90::desc(k_addr + kc / 4 * kBK * 128 + kc % 4 * 32, 16, 1024),
          kc);
    sm90::wgmma_commit();
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc)
      sm90::Wgmma<kBK>::ss(
          dp,
          sm90::desc(do_addr + kc / 4 * kBQ * 128 + kc % 4 * 32, 16, 1024),
          sm90::desc(v_addr + kc / 4 * kBK * 128 + kc % 4 * 32, 16, 1024),
          kc);
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();   // S is done, dP may still run
    sm90::fence_regs(s);

    // s becomes p; s[4j + 2i + e] is row(i), key k0 + 8j + 2t + e
    const bool whole = !segmented && k0 + kBK <= a.Sk &&
                       (!causal || k0 + kBK - 1 <= qw0);
    if (whole) {   // one FFMA and one exp2 a score
#pragma unroll
      for (int j = 0; j < kBK / 2; ++j)
        s[j] = sm90::exp2_fast(fmaf(s[j], scale2, -lse2[(j >> 1) & 1]));
    } else {   // one segment id load per key, shared by the two rows
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int key = k0 + 8 * j + 2 * t + c;
          const bool in = key < a.Sk;
          const int sk = segmented ? __ldg(seg_k + (in ? key : 0)) : 0;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const bool ok = in & (!causal | (key <= pos[r])) &
                            (!segmented | (sk == seg[r]));
            const int x = 4 * j + 2 * r + c;
            const float p = sm90::exp2_fast(fmaf(s[x], scale2, -lse2[r]));
            s[x] = ok ? p : 0.f;
          }
        }
      }
    }
    // ds = p (dp - delta) scale from the f32 p, rounded to bf16 pairs as
    // the A fragments of dS.K
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dp);
    uint32_t da[kBK / 16][4];
#pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int x = 8 * kc + 2 * r;
        const float d = dlt[r & 1];
        da[kc][r] = sm90::pack_bf16(s[x] * (dp[x] - d) * scale,
                                    s[x + 1] * (dp[x + 1] - d) * scale);
      }

    // dQ += dS.K: kBK/16 steps of 16 keys (two 8-key swizzle atoms, 2048
    // bytes); K is MN-major, its 64-column regions kBK * 128 bytes apart.
    // Every A fragment is packed before the fence.
    sm90::fence_regs(dq);
    sm90::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc)
      sm90::Wgmma<D>::rs(dq, da[kc],
                         sm90::desc(k_addr + kc * 2048, kBK * 128, 1024));
    sm90::wgmma_commit();
    sm90::wgmma_wait();
    sm90::fence_regs(dq);
    if (lane == 0) sm90::mbar_arrive(empty + st);   // K and V are free
  }

  // dq[4j + 2i + e] is row(i), column 8j + 2t + e
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (pos[i] >= a.Sq) continue;
    __nv_bfloat16* out =
        a.dq + ((long long)(b * a.Sq + pos[i]) * a.H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j + 2 * t) =
          __floats2bfloat162_rn(dq[4 * j + 2 * i], dq[4 * j + 2 * i + 1]);
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
        dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  dim3 grid((a.Sq + kBQ - 1) / kBQ, B * a.H);
  dq_kernel<D><<<grid, sm90::kThreads, smem, stream>>>(qm, km, vm, dom, a);
  return cudaGetLastError();
}

}  // namespace

// dq [B, Sq, H, D] bf16 from q, dout [B, Sq, H, D], k/v [B, Sk, H, D] bf16
// and lse, delta [B*H, Sq] f32, all contiguous (16-byte aligned for the
// TMA maps); segment ids as in kft_flash_attn_fwd.
extern "C" int kft_flash_attn_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, const void* seg_q,
                                 const void* seg_k, void* dq, int B, int H,
                                 int Sq, int Sk, int D, long long seg_stride,
                                 int causal, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Sq < 0 || Sk < 0 || (D != 64 && D != 128))
    return (int)cudaErrorInvalidValue;
  if (Sq == 0) return (int)cudaSuccess;
  CUtensorMap qm, km, vm, dom;
  const long long row = (long long)H * D, keys = Sk > 0 ? Sk : 1;
  const bool ok =
      sm90::tensor_map(&qm, q, false, D, H, Sq, B, D, row, Sq * row, 64, 1,
                       kBQ) &&
      sm90::tensor_map(&dom, dout, false, D, H, Sq, B, D, row, Sq * row, 64,
                       1, kBQ) &&
      sm90::tensor_map(&km, k, false, D, H, Sk, B, D, row, keys * row, 64, 1,
                       kBK) &&
      sm90::tensor_map(&vm, v, false, D, H, Sk, B, D, row, keys * row, 64, 1,
                       kBK);
  if (!ok) return (int)cudaErrorInvalidValue;
  Args a{static_cast<__nv_bfloat16*>(dq), static_cast<const float*>(lse),
         static_cast<const float*>(delta), static_cast<const int*>(seg_q),
         static_cast<const int*>(seg_k), seg_stride, H, Sq, Sk, causal,
         scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128) return (int)launch<128>(qm, km, vm, dom, a, B, st);
  return (int)launch<64>(qm, km, vm, dom, a, B, st);
}
