// K3: causal grouped-query attention for a prefill chunk over the slab.
//
// Replaces: kubeflow_tpu/ops/flash_prefill.py `_prefill_kernel` (the TPU
// Pallas kernel behind `flash_prefill_attention`, slab mode).
//
// What it computes: q [B, S, H, hd] whose row i sits at absolute position
// q_offset + i, against K/V [B, T, kv, hd] covering positions 0..T-1 (bf16,
// or int8 with per-token f32 scales); key t is visible to row i iff
// t <= q_offset + i and t < T. See attn_common.cuh for the arithmetic.
//
// Bound on the H100: operations at the engine's bucket sizes. A causal
// chunk of S rows over T keys does about 2 * 2 * S * T/2 * hd operations
// per head against 2 * T * hd bytes per kv head, hundreds of operations
// per byte; at 8 slots * 1024 tokens that is 68.7 GFLOP per layer, 69 us at
// the card's 989 TFLOP/s bf16 tensor-core peak.
//
// Design: one block per (slot, kv head, tile of BQ query positions); the g
// query heads of the kv head share the tile's mask, so the block holds
// g * BQ rows (the TPU kernel's g * block_q packing) and reads each K/V
// tile once for all of them. The loop over KV tiles stops at the tile's
// deepest position (the causal block skip). This first version multiplies
// with plain FMAs in f32 from shared memory, not with the tensor cores, so
// it stays well short of the operations bound; the fast path (wgmma on
// bf16 tiles) is later work.
#include "attn_common.cuh"

namespace {

constexpr int RMAX = 64;   // g * BQ rows per block
constexpr int TK = 32;     // keys per shared-memory tile

template <typename KV_T, int HD>
__global__ void __launch_bounds__(kft::kThreads)
prefill_kernel(kft::AttnParams p, int q_offset, int bq) {
  extern __shared__ __align__(16) float smem[];
  constexpr int AR = RMAX * HD / kft::kThreads;
  const int bh = blockIdx.x, b = bh / p.kv, h = bh % p.kv;
  const int qt = blockIdx.y;
  const int g = p.H / p.kv, R = g * bq;
  const int q_last = min(p.Sq, (qt + 1) * bq) - 1;   // deepest live row
  const int t_end = min(p.T, q_offset + q_last + 1);
  kft::RowMap rows{g, bq, qt * bq, q_offset + qt * bq};
  float acc[AR];
  float* m_s = kft::attend<KV_T, HD, RMAX, TK>(p, b, h, R, rows, 0, t_end,
                                               smem, acc);
  const float* l_s = m_s + RMAX;
  const int d = threadIdx.x % HD, rg = threadIdx.x / HD;
  constexpr int NRG2 = kft::kThreads / HD;
#pragma unroll
  for (int j = 0; j < AR; ++j) {
    int r = rg + NRG2 * j;
    if (r >= R || rows.qrow(r) >= p.Sq) continue;
    float o = acc[j] / fmaxf(l_s[r], 1e-30f);
    long long off =
        ((long long)(b * p.Sq + rows.qrow(r)) * p.H + rows.head(h, r)) * HD + d;
    p.out[off] = __float2bfloat16(o);
  }
}

template <typename KV_T, int HD>
cudaError_t launch(const kft::AttnParams& p, int B, int q_offset,
                   cudaStream_t stream) {
  constexpr int smem = kft::smem_bytes<HD, RMAX, TK>();
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        prefill_kernel<KV_T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  int bq = RMAX / (p.H / p.kv);     // query positions per block
  int pow2 = 1;
  while (pow2 * 2 <= bq) pow2 *= 2;
  bq = pow2;
  dim3 grid(B * p.kv, (p.Sq + bq - 1) / bq);
  prefill_kernel<KV_T, HD><<<grid, kft::kThreads, smem, stream>>>(
      p, q_offset, bq);
  return cudaGetLastError();
}

}  // namespace

// Query heads per kv head that one block holds, at most.
extern "C" int kft_flash_prefill_max_group(void) { return RMAX; }

extern "C" int kft_flash_prefill(const void* q, const void* k, const void* v,
                                 const void* k_scale, const void* v_scale,
                                 void* out, int B, int S, int H, int kv,
                                 int hd, int T, long long kv_sb,
                                 long long s_sb, int int8_kv, int q_offset,
                                 float scale, void* stream) {
  if (kv <= 0 || H % kv != 0 || H / kv > RMAX || q_offset < 0)
    return (int)cudaErrorInvalidValue;
  kft::AttnParams p{static_cast<const __nv_bfloat16*>(q), k, v,
                    static_cast<const float*>(k_scale),
                    static_cast<const float*>(v_scale),
                    static_cast<__nv_bfloat16*>(out), kv_sb, s_sb, S, H, kv,
                    T, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (int8_kv) {
    if (hd == 128) return (int)launch<int8_t, 128>(p, B, q_offset, st);
    if (hd == 64) return (int)launch<int8_t, 64>(p, B, q_offset, st);
  } else {
    if (hd == 128) return (int)launch<__nv_bfloat16, 128>(p, B, q_offset, st);
    if (hd == 64) return (int)launch<__nv_bfloat16, 64>(p, B, q_offset, st);
  }
  return (int)cudaErrorInvalidValue;
}
