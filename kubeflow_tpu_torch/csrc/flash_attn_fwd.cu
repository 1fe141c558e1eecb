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
// rounded to bf16 before p.v. A key is visible iff k < Sk, k <= q_offset +
// i when causal, and its segment id equals the row's. Rows past Sq are not
// written.
//
// Bound on the H100: operations. A causal layer at B=2, S=4096, H=32,
// D=128 does 4 * B*H * D * (S^2 / 2) = 275 GFLOP against 134 MB of q/k/v/o,
// about 2,000 operations per byte, so 0.278 ms at the card's 989 TFLOP/s.
//
// Design: the wgmma/TMA mainloop of attn_fwd_sm90.cuh, one block per
// (batch * head, 128 query rows). Q, K and V come through 4-D TMA maps
// over [B, S, H, D] (box (64, 1, rows, 1) per 64 columns). Segment ids are
// read per batch row from global memory on the tiles that need a mask;
// tiles that every row sees whole skip it. Causal blocks stop at the
// tile's deepest row, and heavy (late) query tiles are scheduled first.
#include "attn_fwd_sm90.cuh"

namespace {

struct Args {
  __nv_bfloat16* out;   // [B, Sq, H, D]
  float* lse;           // [B*H, Sq]
  const int* seg_q;     // query row i of batch b: seg_q[b*seg_stride + i]
  const int* seg_k;     // key t of batch b: seg_k[b*seg_stride + t]
  long long seg_stride;
  int H, Sq, Sk, q_offset, causal;
  float scale;
};

template <int D>
__global__ void __launch_bounds__(sm90::kThreads, 1)
fwd_kernel(const __grid_constant__ CUtensorMap qm,
           const __grid_constant__ CUtensorMap km,
           const __grid_constant__ CUtensorMap vm, Args a) {
  extern __shared__ uint8_t smem_raw[];
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * sm90::kBM;   // heavy first
  // causal: keys past the tile's deepest row are visible to no row of it
  const int k_end =
      a.causal ? min(a.Sk, a.q_offset + q0 + sm90::kBM) : a.Sk;
  const int n_tiles = (k_end + sm90::kBK - 1) / sm90::kBK;
  uint8_t* smem = sm90::begin<D, false>(smem_raw, sm90::kBM);
  if (threadIdx.x < 128) {
    sm90::producer_regs();
    if (threadIdx.x == 0)
      sm90::produce<D, false>(smem, &qm, &km, &vm, sm90::kBM, h, q0, h, b,
                              n_tiles);
    return;
  }
  sm90::consumer_regs();
  const bool segmented = a.seg_q != nullptr;
  sm90::Rows rows;
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + sm90::row(i);
    rows.pos[i] = a.q_offset + r;
    rows.seg[i] = segmented && r < a.Sq ? a.seg_q[b * a.seg_stride + r] : -1;
  }
  rows.seg_k = segmented ? a.seg_k + b * a.seg_stride : nullptr;
  rows.n_keys = a.Sk;
  rows.first_pos = a.q_offset + q0;
  rows.causal = a.causal != 0;
  float o[D / 2], m[2], l[2];
  sm90::consume<D, false>(smem, rows, sm90::KvScales{}, n_tiles, a.scale, o,
                          m, l);

  const int t = threadIdx.x % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + sm90::row(i);
    if (r >= a.Sq) continue;
    __nv_bfloat16* orow = a.out + ((long long)(b * a.Sq + r) * a.H + h) * D;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * t) =
          __floats2bfloat162_rn(o[4 * j + 2 * i] * inv,
                                o[4 * j + 2 * i + 1] * inv);
    // lse = m + log(l) in natural units (a fully masked row keeps -1e30)
    const float mn = m[i] > sm90::kNegInf / 2 ? m[i] * sm90::kLn2 : m[i];
    if (t == 0) a.lse[(long long)bh * a.Sq + r] = mn + logf(l[i]);
  }
}

template <int D>
cudaError_t launch(const CUtensorMap& qm, const CUtensorMap& km,
                   const CUtensorMap& vm, const Args& a, int B,
                   cudaStream_t stream) {
  constexpr int smem = sm90::Smem<D, false>::kBytes;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  // query tiles vary fastest, so the blocks in flight share a few heads'
  // K/V in L2 (by heads, their K/V would not fit in it)
  dim3 grid((a.Sq + sm90::kBM - 1) / sm90::kBM, B * a.H);
  fwd_kernel<D><<<grid, sm90::kThreads, smem, stream>>>(qm, km, vm, a);
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
  if (B <= 0 || H <= 0 || Sq < 0 || Sk < 0 || q_offset < 0 ||
      (D != 64 && D != 128))
    return (int)cudaErrorInvalidValue;
  if (Sq == 0) return (int)cudaSuccess;
  CUtensorMap qm, km, vm;
  const long long row = (long long)H * D, keys = Sk > 0 ? Sk : 1;
  const bool ok =
      sm90::tensor_map(&qm, q, false, D, H, Sq, B, D, row, Sq * row, 64, 1,
                       sm90::kBM) &&
      sm90::tensor_map(&km, k, false, D, H, Sk, B, D, row, keys * row, 64,
                       1, sm90::kBK) &&
      sm90::tensor_map(&vm, v, false, D, H, Sk, B, D, row, keys * row, 64,
                       1, sm90::kBK);
  if (!ok) return (int)cudaErrorInvalidValue;
  Args a{static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse),
         static_cast<const int*>(seg_q), static_cast<const int*>(seg_k),
         seg_stride, H, Sq, Sk, q_offset, causal, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128) return (int)launch<128>(qm, km, vm, a, B, st);
  return (int)launch<64>(qm, km, vm, a, B, st);
}
