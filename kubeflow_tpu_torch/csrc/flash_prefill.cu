// K3: causal grouped-query attention for a prefill chunk over the slab.
//
// Replaces: kubeflow_tpu/ops/flash_prefill.py `_prefill_kernel` (the TPU
// Pallas kernel behind `flash_prefill_attention`, slab mode).
//
// What it computes: q [B, S, H, hd] whose row i sits at absolute position
// q_offset + i, against K/V [B, T, kv, hd] covering positions 0..T-1 (bf16,
// or int8 with per-token f32 scales [B, T, kv]); key t is visible to row i
// iff t <= q_offset + i and t < T. The TPU kernel's numerics: the int8 k
// scale multiplies the score before 1/sqrt(hd), the v scale is folded into
// p before p is rounded to bf16, masked scores are -1e30 and their p is 0,
// l is clamped to 1e-30.
//
// Bound on the H100: operations. A causal chunk does about 2 * 2 * S * T/2
// * hd operations per head against 2 * T * hd bytes per kv head, hundreds
// of operations per byte; the engine's 1024-token wave (B=3) is 25.8 GFLOP,
// 26 us at the card's 989 TFLOP/s bf16 tensor-core peak.
//
// Design: the wgmma/TMA mainloop of attn_fwd_sm90.cuh. A block is one
// (slot, kv head, tile of BQ = 128 / g query positions); its 128 rows are
// the g query heads of the kv head at each position (the TPU kernel's
// g * block_q packing), so each K/V tile is read once for all of them. One
// TMA box (64, g, BQ, 1) over q [B, S, H, hd] at head h * g lands the rows
// position-major: row r is head h * g + r % g at position q0 + r / g. K/V
// come through a 4-D map [B, T, kv, hd] with the slab's slot stride, so no
// copy is made; int8 tiles are widened to bf16 in shared memory. The key
// loop stops at the tile's deepest position (the causal block skip), and
// heavy (late) tiles are scheduled first.
#include "attn_fwd_sm90.cuh"

namespace {

struct Args {
  __nv_bfloat16* out;     // [B, S, H, hd]
  const float* k_scale;   // [B, T, kv], slot stride s_sb (int8 only)
  const float* v_scale;
  long long s_sb;
  int S, H, kv, T, g, bq, q_offset;
  float scale;
};

template <int HD, bool INT8>
__global__ void __launch_bounds__(sm90::kThreads, 1)
prefill_kernel(const __grid_constant__ CUtensorMap qm,
               const __grid_constant__ CUtensorMap km,
               const __grid_constant__ CUtensorMap vm, Args a) {
  extern __shared__ uint8_t smem_raw[];
  const int b = blockIdx.y / a.kv, h = blockIdx.y % a.kv;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * a.bq;   // heavy tiles first
  const int q_rows = a.g * a.bq;
  const int q_last = min(a.S, q0 + a.bq) - 1;            // deepest position
  const int t_end = min(a.T, a.q_offset + q_last + 1);
  const int n_tiles = (t_end + sm90::kBK - 1) / sm90::kBK;
  uint8_t* smem = sm90::begin<HD, INT8>(smem_raw, q_rows);
  if (threadIdx.x < 128) {
    sm90::producer_regs();
    if (threadIdx.x == 0)
      sm90::produce<HD, INT8>(smem, &qm, &km, &vm, q_rows, h * a.g, q0, h,
                              b, n_tiles);
    return;
  }
  sm90::consumer_regs();
  sm90::Rows rows;
  for (int i = 0; i < 2; ++i) {
    rows.pos[i] = a.q_offset + q0 + sm90::row(i) / a.g;
    rows.seg[i] = 0;
  }
  rows.seg_k = nullptr;
  rows.n_keys = a.T;
  rows.first_pos = a.q_offset + q0;
  rows.causal = true;
  const long long sc0 = (long long)b * a.s_sb + h;
  const sm90::KvScales sc{INT8 ? a.k_scale + sc0 : nullptr,
                          INT8 ? a.v_scale + sc0 : nullptr, a.kv};
  float o[HD / 2], m[2], l[2];
  sm90::consume<HD, INT8>(smem, rows, sc, n_tiles, a.scale, o, m, l);

  const int t = threadIdx.x % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = sm90::row(i), qi = q0 + r / a.g;
    if (r >= q_rows || qi >= a.S) continue;   // pad rows, rows past S
    __nv_bfloat16* orow =
        a.out + ((long long)(b * a.S + qi) * a.H + h * a.g + r % a.g) * HD;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * t) =
          __floats2bfloat162_rn(o[4 * j + 2 * i] * inv,
                                o[4 * j + 2 * i + 1] * inv);
  }
}

template <int HD, bool INT8>
cudaError_t launch(const CUtensorMap& qm, const CUtensorMap& km,
                   const CUtensorMap& vm, const Args& a, int B,
                   cudaStream_t stream) {
  constexpr int smem = sm90::Smem<HD, INT8>::kBytes;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        prefill_kernel<HD, INT8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  // query tiles vary fastest: the blocks in flight share their K/V in L2
  dim3 grid((a.S + a.bq - 1) / a.bq, B * a.kv);
  prefill_kernel<HD, INT8><<<grid, sm90::kThreads, smem, stream>>>(qm, km,
                                                                    vm, a);
  return cudaGetLastError();
}

}  // namespace

// Query heads per kv head that one block holds, at most.
extern "C" int kft_flash_prefill_max_group(void) { return sm90::kBM; }

// q, out [B, S, H, hd] bf16 contiguous; k/v [B, T, kv, hd] with contiguous
// [T, kv, hd] rows and slots kv_sb elements apart; int8 scales [B, T, kv]
// with slots s_sb apart.
extern "C" int kft_flash_prefill(const void* q, const void* k, const void* v,
                                 const void* k_scale, const void* v_scale,
                                 void* out, int B, int S, int H, int kv,
                                 int hd, int T, long long kv_sb,
                                 long long s_sb, int int8_kv, int q_offset,
                                 float scale, void* stream) {
  if (B <= 0 || S < 0 || T < 0 || kv <= 0 || H % kv != 0 ||
      H / kv > sm90::kBM || q_offset < 0 || (hd != 64 && hd != 128))
    return (int)cudaErrorInvalidValue;
  if (S == 0) return (int)cudaSuccess;
  const int g = H / kv, bq = sm90::kBM / g;
  const bool i8 = int8_kv != 0;
  CUtensorMap qm, km, vm;
  const bool ok =
      sm90::tensor_map(&qm, q, false, hd, H, S, B, hd, (long long)H * hd,
                       (long long)S * H * hd, 64, g, bq) &&
      sm90::tensor_map(&km, k, i8, hd, kv, T, B, hd, (long long)kv * hd,
                       kv_sb, i8 ? hd : 64, 1, sm90::kBK) &&
      sm90::tensor_map(&vm, v, i8, hd, kv, T, B, hd, (long long)kv * hd,
                       kv_sb, i8 ? hd : 64, 1, sm90::kBK);
  if (!ok) return (int)cudaErrorInvalidValue;
  Args a{static_cast<__nv_bfloat16*>(out), static_cast<const float*>(k_scale),
         static_cast<const float*>(v_scale), s_sb, S, H, kv, T, g, bq,
         q_offset, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (i8) {
    if (hd == 128) return (int)launch<128, true>(qm, km, vm, a, B, st);
    return (int)launch<64, true>(qm, km, vm, a, B, st);
  }
  if (hd == 128) return (int)launch<128, false>(qm, km, vm, a, B, st);
  return (int)launch<64, false>(qm, km, vm, a, B, st);
}
