// K2: grouped-query flash-decoding over the serving KV slab.
//
// Replaces: kubeflow_tpu/ops/flash_decode.py `_decode_kernel` (the TPU
// Pallas kernel behind `flash_decode_attention`, slab mode).
//
// What it computes: for every slot b, kv head h and query row r of the
// g * S_v rows regrouped onto h (row r is head h*g + r / S_v at position
// lengths[b] + r % S_v), softmax(q . k * scale) . v over the keys
// t <= lengths[b] + r % S_v, t < T, with the int8 cache's per-token scales
// folded into the score (k) and the probability (v) exactly as the TPU
// kernel folds them. See attn_common.cuh for the arithmetic.
//
// Bound on the H100: bytes. A decode step reads each live KV row once
// (int8: 2 * hd bytes + 8 bytes of scales per token and kv head) and does
// 4 * g * S_v * hd operations per row read, far below the card's ~295
// operations per byte. At 8B width and span 2048 one layer's K and V are
// 8 slots * 2048 * 8 heads * 128 * 2 bytes = 33.6 MB, about 10 us at
// 3.35 TB/s.
//
// Design: B * kv = 64 (slot, head) pairs would leave half of the 132 SMs
// idle, so the span is split across blocks (flash-decoding): grid
// (B * kv, n_split), each block runs the online softmax over its share of
// the KV tiles and writes (m, l, acc) partials; a second small kernel
// merges the partials in a fixed order, so the result is deterministic.
// Tiles past lengths[b] + S_v - 1 are never read (the TPU kernel's block
// skip), so the bytes moved follow the live lengths, not the span. The
// split count is chosen here (`kft_flash_decode_workspace` reports the
// workspace it needs), so the tile sizes are known only in this file.
#include "attn_common.cuh"

namespace {

constexpr int RMAX_LIMIT = 32;   // g * S_v rows per block, at most
constexpr int TK = 64;           // keys per shared-memory tile
constexpr int TARGET_BLOCKS = 396;  // about three blocks on each of 132 SMs

// Blocks that share one (slot, kv head): enough for TARGET_BLOCKS, at most
// one per KV tile.
int choose_split(int B, int kv, int T) {
  const int n_tiles = (T + TK - 1) / TK;
  return max(1, min(n_tiles, TARGET_BLOCKS / (B * kv)));
}

bool supported(int H, int kv, int s_v) {
  return kv > 0 && s_v > 0 && H % kv == 0 && (H / kv) * s_v <= RMAX_LIMIT;
}

// RMAX: the block's row capacity, the smallest of 8/16/32 that holds
// g * S_v, so decode (4 rows at 8B) does not pay for 32
template <typename KV_T, int HD, int RMAX>
__global__ void __launch_bounds__(kft::kThreads)
decode_kernel(kft::AttnParams p, const int* __restrict__ lengths, int s_v,
              int tiles_per_split, float* part_acc, float* part_ml) {
  extern __shared__ __align__(16) float smem[];
  constexpr int AR = RMAX * HD / kft::kThreads;
  const int bh = blockIdx.x, b = bh / p.kv, h = bh % p.kv;
  const int split = blockIdx.y, n_split = gridDim.y;
  const int g = p.H / p.kv, R = g * s_v;
  const int len = lengths[b];
  const int limit = min(p.T, len + s_v);          // keys any row can see
  const int t_begin = split * tiles_per_split * TK;
  const int t_end = min(limit, t_begin + tiles_per_split * TK);
  kft::RowMap rows{g, s_v, 0, len};
  float acc[AR];
  float* m_s = kft::attend<KV_T, HD, RMAX, TK>(p, b, h, R, rows, t_begin,
                                               t_end, smem, acc);
  const float* l_s = m_s + RMAX;
  const int d = threadIdx.x % HD, rg = threadIdx.x / HD;
  constexpr int NRG2 = kft::kThreads / HD;
  if (n_split == 1) {
#pragma unroll
    for (int j = 0; j < AR; ++j) {
      int r = rg + NRG2 * j;
      if (r >= R) continue;
      float o = acc[j] / fmaxf(l_s[r], 1e-30f);
      long long off =
          ((long long)(b * p.Sq + rows.qrow(r)) * p.H + rows.head(h, r)) * HD + d;
      p.out[off] = __float2bfloat16(o);
    }
    return;
  }
  const long long base = (long long)bh * n_split + split;
#pragma unroll
  for (int j = 0; j < AR; ++j) {
    int r = rg + NRG2 * j;
    if (r < R) part_acc[(base * R + r) * HD + d] = acc[j];
  }
  for (int r = threadIdx.x; r < R; r += kft::kThreads) {
    part_ml[(base * R + r) * 2] = m_s[r];
    part_ml[(base * R + r) * 2 + 1] = l_s[r];
  }
}

// Merge the n_split partials of one (slot, kv head) in split order.
template <int HD>
__global__ void __launch_bounds__(kft::kThreads)
combine_kernel(kft::AttnParams p, int s_v, int n_split,
               const float* __restrict__ part_acc,
               const float* __restrict__ part_ml) {
  const int bh = blockIdx.x, b = bh / p.kv, h = bh % p.kv;
  const int g = p.H / p.kv, R = g * s_v;
  kft::RowMap rows{g, s_v, 0, 0};
  for (int i = threadIdx.x; i < R * HD; i += kft::kThreads) {
    int r = i / HD, d = i % HD;
    float mx = kft::kNegInf;
    for (int z = 0; z < n_split; ++z)
      mx = fmaxf(mx, part_ml[(((long long)bh * n_split + z) * R + r) * 2]);
    float l = 0.f, o = 0.f;
    for (int z = 0; z < n_split; ++z) {
      long long base = ((long long)bh * n_split + z) * R + r;
      float w = __expf(part_ml[base * 2] - mx);
      l += part_ml[base * 2 + 1] * w;
      o += part_acc[base * HD + d] * w;
    }
    long long off =
        ((long long)(b * p.Sq + rows.qrow(r)) * p.H + rows.head(h, r)) * HD + d;
    p.out[off] = __float2bfloat16(o / fmaxf(l, 1e-30f));
  }
}

template <typename KV_T, int HD, int RMAX>
cudaError_t launch_rows(const kft::AttnParams& p, int B, const int* lengths,
                        int s_v, int n_split, float* part_acc,
                        float* part_ml, cudaStream_t stream) {
  constexpr int smem = kft::smem_bytes<HD, RMAX, TK>();
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_kernel<KV_T, HD, RMAX>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const int n_tiles = (p.T + TK - 1) / TK;
  const int tiles_per_split = (n_tiles + n_split - 1) / n_split;
  dim3 grid(B * p.kv, n_split);
  decode_kernel<KV_T, HD, RMAX><<<grid, kft::kThreads, smem, stream>>>(
      p, lengths, s_v, tiles_per_split, part_acc, part_ml);
  if (n_split > 1) {
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    combine_kernel<HD><<<B * p.kv, kft::kThreads, 0, stream>>>(
        p, s_v, n_split, part_acc, part_ml);
  }
  return cudaGetLastError();
}

template <typename KV_T, int HD>
cudaError_t launch(const kft::AttnParams& p, int B, const int* lengths,
                   int s_v, int n_split, float* part_acc, float* part_ml,
                   cudaStream_t stream) {
  const int rows = (p.H / p.kv) * s_v;
  if (rows <= 8)
    return launch_rows<KV_T, HD, 8>(p, B, lengths, s_v, n_split, part_acc,
                                    part_ml, stream);
  if (rows <= 16)
    return launch_rows<KV_T, HD, 16>(p, B, lengths, s_v, n_split, part_acc,
                                     part_ml, stream);
  return launch_rows<KV_T, HD, 32>(p, B, lengths, s_v, n_split, part_acc,
                                   part_ml, stream);
}

}  // namespace

// f32 words of workspace that kft_flash_decode needs for this shape: 0 when
// the span is not split, -1 when the kernel does not support the shape
// (more than RMAX_LIMIT query rows per kv head).
extern "C" long long kft_flash_decode_workspace(int B, int s_v, int H, int kv,
                                                int hd, int T) {
  if (!supported(H, kv, s_v)) return -1;
  const int n_split = choose_split(B, kv, T);
  if (n_split == 1) return 0;
  return (long long)B * kv * n_split * (H / kv) * s_v * (hd + 2);
}

extern "C" int kft_flash_decode(const void* q, const void* k, const void* v,
                                const void* k_scale, const void* v_scale,
                                const void* lengths, void* out,
                                void* workspace, int B, int s_v, int H, int kv,
                                int hd, int T, long long kv_sb, long long s_sb,
                                int int8_kv, float scale, void* stream) {
  if (!supported(H, kv, s_v) || B < 1 || T < 1)
    return (int)cudaErrorInvalidValue;
  const int n_split = choose_split(B, kv, T);
  if (n_split > 1 && workspace == nullptr) return (int)cudaErrorInvalidValue;
  kft::AttnParams p{static_cast<const __nv_bfloat16*>(q), k, v,
                    static_cast<const float*>(k_scale),
                    static_cast<const float*>(v_scale),
                    static_cast<__nv_bfloat16*>(out), kv_sb, s_sb, s_v, H, kv,
                    T, scale};
  const int* len = static_cast<const int*>(lengths);
  // partial accumulators [B*kv, n_split, rows, hd], then (m, l) pairs
  float* pa = static_cast<float*>(workspace);
  float* pm = pa == nullptr
                  ? nullptr
                  : pa + (long long)B * kv * n_split * (H / kv) * s_v * hd;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (int8_kv) {
    if (hd == 128) return (int)launch<int8_t, 128>(p, B, len, s_v, n_split, pa, pm, st);
    if (hd == 64) return (int)launch<int8_t, 64>(p, B, len, s_v, n_split, pa, pm, st);
  } else {
    if (hd == 128) return (int)launch<__nv_bfloat16, 128>(p, B, len, s_v, n_split, pa, pm, st);
    if (hd == 64) return (int)launch<__nv_bfloat16, 64>(p, B, len, s_v, n_split, pa, pm, st);
  }
  return (int)cudaErrorInvalidValue;
}
