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
//
// Paged mode (K3-paged; replaces the same `_prefill_kernel` under its
// paged index maps, kubeflow_tpu/ops/flash_prefill.py:313-319, where the
// kv-block grid axis reads a scalar-prefetched table): k/v are one pool
// layer [N, bt, kv, hd] (int8 scales [N, bt, kv]) and slot b's T = nb * bt
// keys are the blocks of its table row tbl[b, 0 .. nb) concatenated; the
// mask is the slab's with T keys. Only the addressing changes (the PAGED
// flag of attn_fwd_sm90.cuh): the K/V maps describe the pool, B -> N and
// T -> bt, and the producer thread reads the table. For bt >= 128 it
// loads tile i as one box of 128 rows at row (i * 128) % bt of block
// tbl[b, i * 128 / bt]; for bt < 128 as 128 / bt boxes of bt rows, box j
// from block tbl[b, i * 128 / bt + j] landing at row j * bt of the stage.
// The stage's byte count is the slab's, so the consumers wait as before;
// they read an int8 key's scales at its pool row tbl[b, t / bt] * bt +
// t % bt. Tiles start at the same key positions as the slab's, and the
// products, the widening and the softmax are the same code, so a paged
// launch gives the slab launch's bits on the same keys. Table entries
// are read through the read-only path (__ldg), once a box by the
// producer and once a key by the consumers' scale loads (int8).
// Bound: bytes at the serving profiler's shape (B=8, S=32, H=32, kv=8,
// hd=128, T=2048 int8, q_offset 2016): the K/V rows and scales of every
// slot, about 34.6 MB, and q and out, 4.2 MB, 0.0116 ms at 3.35 TB/s;
// the grid there is one query tile by 64 (slot, kv head) blocks on 132
// SMs, so it runs far from that bound.
#include "attn_fwd_sm90.cuh"

namespace {

struct Args {
  __nv_bfloat16* out;     // [B, S, H, hd]
  const float* k_scale;   // [B, T, kv], slot stride s_sb (int8 only)
  const float* v_scale;   // (paged: [N, bt, kv], s_sb 0)
  long long s_sb;
  int S, H, kv, T, g, bq, q_offset;
  float scale;
  // paged mode: tables [B, >= nb] int32, rows tbl_stride apart; pool of
  // n_blocks blocks of bt keys
  const int* tbl;
  int bt, nb, n_blocks, tbl_stride;
};

template <int HD, bool INT8, bool PAGED>
__global__ void __launch_bounds__(sm90::kThreads, 1)
prefill_kernel(const __grid_constant__ CUtensorMap qm,
               const __grid_constant__ CUtensorMap km,
               const __grid_constant__ CUtensorMap vm, Args a) {
  extern __shared__ uint8_t smem_raw[];
  const int b = blockIdx.y / a.kv, h = blockIdx.y % a.kv;
  sm90::Pages pg{};
  if constexpr (PAGED)
    pg = sm90::Pages{a.tbl + (long long)b * a.tbl_stride, a.bt, a.nb,
                     a.n_blocks};
  const int q0 = (gridDim.x - 1 - blockIdx.x) * a.bq;   // heavy tiles first
  const int q_rows = a.g * a.bq;
  const int q_last = min(a.S, q0 + a.bq) - 1;            // deepest position
  const int t_end = min(a.T, a.q_offset + q_last + 1);
  const int n_tiles = (t_end + sm90::kBK - 1) / sm90::kBK;
  uint8_t* smem = sm90::begin<HD, INT8>(smem_raw, q_rows);
  if (threadIdx.x < 128) {
    sm90::producer_regs();
    if (threadIdx.x == 0)
      sm90::produce<HD, INT8, PAGED>(smem, &qm, &km, &vm, q_rows, h * a.g,
                                     q0, h, b, n_tiles, pg);
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
  sm90::consume<HD, INT8, PAGED>(smem, rows, sc, n_tiles, a.scale, o, m, l,
                                 pg);

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

template <int HD, bool INT8, bool PAGED>
cudaError_t launch(const CUtensorMap& qm, const CUtensorMap& km,
                   const CUtensorMap& vm, const Args& a, int B,
                   cudaStream_t stream) {
  constexpr int smem = sm90::Smem<HD, INT8>::kBytes;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        prefill_kernel<HD, INT8, PAGED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  // query tiles vary fastest: the blocks in flight share their K/V in L2
  dim3 grid((a.S + a.bq - 1) / a.bq, B * a.kv);
  prefill_kernel<HD, INT8, PAGED>
      <<<grid, sm90::kThreads, smem, stream>>>(qm, km, vm, a);
  return cudaGetLastError();
}

template <bool PAGED>
cudaError_t launch_kv(const CUtensorMap& qm, const CUtensorMap& km,
                      const CUtensorMap& vm, const Args& a, int B, int hd,
                      bool i8, cudaStream_t st) {
  if (i8) {
    if (hd == 128) return launch<128, true, PAGED>(qm, km, vm, a, B, st);
    return launch<64, true, PAGED>(qm, km, vm, a, B, st);
  }
  if (hd == 128) return launch<128, false, PAGED>(qm, km, vm, a, B, st);
  return launch<64, false, PAGED>(qm, km, vm, a, B, st);
}

// Whether the paged producer can load blocks of bt keys: a multiple of 8
// that divides the 128-key tile, or a multiple of the tile (the rule
// ops/flash_prefill.py checks first).
bool bt_ok(int bt) {
  return bt > 0 &&
         (bt % sm90::kBK == 0 || (bt % 8 == 0 && sm90::kBK % bt == 0));
}

bool q_map(CUtensorMap* qm, const void* q, int B, int S, int H, int hd,
           int g, int bq) {
  return sm90::tensor_map(qm, q, false, hd, H, S, B, hd, (long long)H * hd,
                          (long long)S * H * hd, 64, g, bq);
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
      q_map(&qm, q, B, S, H, hd, g, bq) &&
      sm90::tensor_map(&km, k, i8, hd, kv, T, B, hd, (long long)kv * hd,
                       kv_sb, i8 ? hd : 64, 1, sm90::kBK) &&
      sm90::tensor_map(&vm, v, i8, hd, kv, T, B, hd, (long long)kv * hd,
                       kv_sb, i8 ? hd : 64, 1, sm90::kBK);
  if (!ok) return (int)cudaErrorInvalidValue;
  Args a{static_cast<__nv_bfloat16*>(out), static_cast<const float*>(k_scale),
         static_cast<const float*>(v_scale), s_sb, S, H, kv, T, g, bq,
         q_offset, scale, nullptr, 0, 0, 0, 0};
  return (int)launch_kv<false>(qm, km, vm, a, B, hd, i8,
                               static_cast<cudaStream_t>(stream));
}

// Paged mode: q, out [B, S, H, hd] bf16 contiguous; k/v the contiguous
// pool layer [n_blocks, bt, kv, hd] (int8 with contiguous scales
// [n_blocks, bt, kv] f32, or bf16); tables [B, >= nb] int32 with rows
// tbl_stride elements apart. Slot b's T = nb * bt keys are its table's
// blocks in order.
extern "C" int kft_flash_prefill_paged(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* tables, void* out, int B, int S, int H,
    int kv, int hd, int bt, int nb, int n_blocks, int tbl_stride,
    int int8_kv, int q_offset, float scale, void* stream) {
  if (B <= 0 || S < 0 || kv <= 0 || H % kv != 0 || H / kv > sm90::kBM ||
      q_offset < 0 || (hd != 64 && hd != 128) ||
      !bt_ok(bt) || nb < 1 || n_blocks < 1 ||
      tbl_stride < nb)
    return (int)cudaErrorInvalidValue;
  if (S == 0) return (int)cudaSuccess;
  const int g = H / kv, bq = sm90::kBM / g;
  const bool i8 = int8_kv != 0;
  const int rows = bt < sm90::kBK ? bt : sm90::kBK;
  CUtensorMap qm, km, vm;
  const long long blk = (long long)bt * kv * hd;
  const bool ok =
      q_map(&qm, q, B, S, H, hd, g, bq) &&
      sm90::tensor_map(&km, k, i8, hd, kv, bt, n_blocks, hd,
                       (long long)kv * hd, blk, i8 ? hd : 64, 1, rows) &&
      sm90::tensor_map(&vm, v, i8, hd, kv, bt, n_blocks, hd,
                       (long long)kv * hd, blk, i8 ? hd : 64, 1, rows);
  if (!ok) return (int)cudaErrorInvalidValue;
  Args a{static_cast<__nv_bfloat16*>(out), static_cast<const float*>(k_scale),
         static_cast<const float*>(v_scale), 0, S, H, kv, nb * bt, g, bq,
         q_offset, scale, static_cast<const int*>(tables), bt, nb, n_blocks,
         tbl_stride};
  return (int)launch_kv<true>(qm, km, vm, a, B, hd, i8,
                              static_cast<cudaStream_t>(stream));
}
