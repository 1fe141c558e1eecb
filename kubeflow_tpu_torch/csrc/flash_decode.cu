// K2: grouped-query flash-decoding over the serving KV slab, or over the
// block pool of paged serving through per-slot block tables.
//
// Replaces: kubeflow_tpu/ops/flash_decode.py `_decode_kernel` (the TPU
// Pallas kernel behind `flash_decode_attention`), in slab mode and in
// paged mode (`tables=`, where the TPU kernel's k/v/scale index maps read
// a scalar-prefetched table).
//
// What it computes: for every slot b, kv head h and query row r of the
// g * S_v rows regrouped onto h (row r is head h*g + r / S_v at position
// lengths[b] + r % S_v), softmax(q . k * scale) . v over the keys
// t <= lengths[b] + r % S_v, t < T. Numerics of the TPU kernel, step for
// step:
//   s   = dot(q, k) in f32 (k exact in f32, int8 included),
//   s  *= k_scale[t] (int8 only), then s *= 1/sqrt(hd),
//   masked keys get -1e30, m/l/acc carry in f32,
//   p   = exp(s - m) (0 where masked), l += sum(p),
//   acc += bf16(p * v_scale[t]) . v   (v_scale only for int8),
//   out = acc / max(l, 1e-30), rounded to bf16.
//
// Bound on the H100: bytes. A decode step reads each live KV row once
// (int8: 2 * hd bytes + 8 bytes of scales per token and kv head) and does
// 4 * g * S_v * hd operations per row, far below the card's ~295
// operations per byte. At 8B width, 8 slots at position 1000 read 16.5 MB
// a layer, about 5 us at 3.35 TB/s.
//
// Design: one launch, grid (n_split, B * kv * n_grp), each column of
// n_split blocks one thread block cluster for one (slot, kv head, row
// group).
//   - Row groups: a block holds at most 32 of the g * S_v query rows of its
//     kv head (RMAX_LIMIT; the PV accumulators live in registers). A
//     verify step with more rows (g = 4 at S_v = 9..17: 36..68 rows) runs
//     n_grp = ceil(g * S_v / 32) groups of 32 rows side by side, each a
//     cluster of its own over the same keys. Each group reads the slot's
//     live K/V again: n_grp times the bytes of one read (2x at S_v 9..16,
//     3x at S_v 17 for g = 4), served from L2 where the groups of a kv
//     head run at once. Rows of different groups never meet, so a group's
//     rows give the bits they give in any other grouping.
//   - Split by live keys: each block derives its share of the key tiles
//     on the device from lengths[b] (the min(T, lengths[b] + S_v) live
//     keys, split evenly over the cluster), so no block walks dead tiles.
//     The host picks the cluster size from (B, kv, T) alone, no sync. A
//     row's bits depend on the cluster size (it orders the merge), so a
//     launch over a window of a slab's slots (a stage's microbatch) passes
//     the slab's slot count as split_b and sums each row's keys as the
//     launch over every slot does.
//   - Bytes in flight: every thread issues cp.async copies of the int8
//     (or bf16) K/V tiles and their scales into a ring of kStages stages,
//     kStages - 1 tiles ahead of the one computed, so a block's whole
//     share (two or three tiles in the 8B decode step) is in flight at
//     once; about 100 KB a SM at three blocks a SM. Tiles stay in their
//     storage type, with 16-byte chunks XOR-swizzled by row so the score
//     pass reads them without bank conflicts. (TMA would need a tensor
//     map encoded on the host per call; cp.async needs none.)
//   - The products on tensor cores, mma.sync m16n8k16 in bf16 with f32
//     accumulation (int8 is exact in bf16), the fragments widened in
//     registers as they are read (PRMT + FADD, not I2F). Each of the 4
//     warps owns 16 keys of every tile with its own online softmax, so a
//     tile needs one block barrier (the ring's); S^T = K.Q^T puts the keys
//     on the M side, since g * S_v is 4 rows at decode. On CUDA cores the
//     products were measured to take about as long as the bytes. The verify
//     form (up to 32 rows a block) runs the same code with more n- and
//     m-tiles.
//     The warps' partials merge in warp order at the end.
//   - The merge: each block leaves its (m, l, acc) partial in its own
//     shared memory; after a cluster barrier every rank reads the others'
//     (m, l) through distributed shared memory, and writes its share of
//     the output, each value summed over the ranks in rank order. No
//     second kernel, no workspace, no atomics, and the summation order is
//     fixed, so a second launch gives the same bits.
//
// Paged mode (kPaged): k/v are one layer of the pool, [N, bt, kv, HD]
// (scales [N, bt, kv]), and slot b's T = nb * bt logical keys are the
// blocks of its table row tbl[b, 0 .. nb) concatenated: key t lies in
// pool row tbl[b, t / bt] * bt + t % bt. Only the address of a key row
// changes; the split, the ring, the products, the mask and the merge are
// the slab kernel's, so a paged launch gives the slab launch's bits for
// the same keys. Each thread that copies a 16-byte chunk of a key row
// reads that row's table entry through the read-only path (__ldg): the
// chunks of one row hit the same L1 line, so the table costs one load a
// row and nothing in shared memory, and bt need not divide the 64-key
// tile. The bound is the slab's plus the table: bytes, the live key rows
// of every slot and kv head and their scales, plus 4 bytes a block of
// table. Entries past a slot's live keys may name any block (the engine
// leaves them at block 0, the trash block): their keys are masked, and
// junk there must only be finite.
#include "sm90_primitives.cuh"

namespace {

constexpr int kThreads = 128;      // 4 warps, 16 keys of each tile apiece
constexpr int kWarps = kThreads / 32;
constexpr int TK = 64;             // keys per tile
constexpr int kStages = 4;         // K/V ring depth
constexpr int kMaxCluster = 8;     // portable cluster size
constexpr int RMAX_LIMIT = 32;     // g * S_v rows per block, at most
constexpr int kMaxGridY = 65535;   // B * kv * n_grp blocks along y
// blocks wanted in flight: two a SM on 132 SMs (three fit; two, with
// larger clusters' shares, measured faster at the 8B decode shapes)
constexpr int kTargetBlocks = 2 * 132;
constexpr float kNegInf = -1e30f;

struct Params {
  const __nv_bfloat16* q;   // [B, S_v, H, HD] contiguous
  const void* k;            // [B, T, kv, HD], slot stride kv_sb elements;
  const void* v;            //   paged: the pool layer [N, bt, kv, HD]
  const float* k_scale;     // [B, T, kv], slot stride s_sb (int8 only);
  const float* v_scale;     //   paged: [N, bt, kv]
  const int* lengths;       // [B]
  __nv_bfloat16* out;       // [B, S_v, H, HD] contiguous
  long long kv_sb, s_sb;    // 0 when paged
  int s_v, H, kv, T;        // paged: T = nb * bt
  int n_grp;                // row groups of RMAX_LIMIT rows per kv head
  float scale;
  const int* tbl;           // paged: [B, >= nb] int32, rows tbl_stride apart
  int bt, tbl_stride;
};

// Cluster size: enough blocks for kTargetBlocks, at most one per tile;
// `columns` is the number of clusters (B * kv * n_grp).
int choose_split(int columns, int T) {
  const int n_tiles = (T + TK - 1) / TK;
  return max(1, min(min(kMaxCluster, n_tiles), kTargetBlocks / columns));
}

// Row groups of one kv head's g * S_v query rows.
int row_groups(int H, int kv, int s_v) {
  return ((H / kv) * s_v + RMAX_LIMIT - 1) / RMAX_LIMIT;
}

bool supported(int B, int H, int kv, int s_v) {
  return B > 0 && kv > 0 && s_v > 0 && H % kv == 0 &&
         (long long)B * kv * row_groups(H, kv, s_v) <= kMaxGridY;
}

// Byte offsets of a block's shared memory, for RMAX query rows (a
// multiple of 8: the n of the score products).
template <typename KV_T, int HD, int RMAX>
struct Smem {
  static constexpr int kRow = HD * sizeof(KV_T);       // one key's bytes
  static constexpr int kChunks = kRow / 16;            // 16-byte chunks
  static constexpr int kSwz = kChunks < 8 ? kChunks : 8;
  static constexpr int kTile = TK * kRow;
  static constexpr int kRM = (RMAX + 15) / 16;         // PV m-tiles
  // stage s: K tile, V tile, k scales [TK], v scales [TK]
  static constexpr int kStage = 2 * kTile + 2 * TK * 4;
  // q [RMAX][HD] bf16, rows kQRow bytes apart: 32 bytes of padding put
  // the score pass's 8 rows in two shared-memory wavefronts, not eight
  static constexpr int kQRow = HD * 2 + 32;
  static constexpr int kQ = kStages * kStage;
  static constexpr int kP = kQ + RMAX * kQRow;         // per warp [16 kRM][16]
  static constexpr int kCorr = kP + kWarps * kRM * 16 * 16 * 2;
  static constexpr int kWm = kCorr + kWarps * RMAX * 4;  // per warp m, l
  static constexpr int kM = kWm + 2 * kWarps * RMAX * 4;  // block m, l
  static constexpr int kW = kM + 2 * RMAX * 4;          // merge weights
  static constexpr int kBytes = kW + RMAX * (kMaxCluster + 1) * 4;
  // after the loop the ring holds each warp's acc [kWarps][RMAX][HD] f32,
  // warp 0's becoming the block's
  static_assert(kWarps * RMAX * HD * 4 <= kQ, "partials do not fit");
};

// where chunk c of key row r lies in a tile
template <typename L>
__device__ __forceinline__ int chunk_at(int r, int c) {
  return r * L::kRow + ((c ^ (r % L::kSwz)) * 16);
}

// d (+)= a . b, m16n8k16, bf16 inputs, f32 accumulators
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 b16 matrices, transposed: register j of lane l holds rows
// 2 (l % 4), 2 (l % 4) + 1 of column l / 4 of matrix j, whose rows lanes
// 8j .. 8j + 7 address
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(sm90::smem_u32(row)));
}

// bf16 pairs (bytes 0, 2) and (1, 3) of four int8
__device__ __forceinline__ void widen4_odd_even(uint32_t w, uint32_t& even,
                                                uint32_t& odd) {
  float f[4];
  sm90::int8x4_to_f32(w, f);
  even = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[2]), 0x7632);
  odd = __byte_perm(__float_as_uint(f[1]), __float_as_uint(f[3]), 0x7632);
}

// Where one slot's K/V rows and scales start (paged: the pool's start),
// and its table row (paged only).
struct Slot {
  const char* k;
  const char* v;
  const float* ks;
  const float* vs;
  const int* tbl;
};

// The row of key t < T from the slot's start: t in the slab, its pool row
// through the table when paged.
template <bool kPaged>
__device__ __forceinline__ long long key_row(const Params& p,
                                             const Slot& slot, int t) {
  if constexpr (kPaged)
    return (long long)__ldg(slot.tbl + t / p.bt) * p.bt + t % p.bt;
  else
    return t;
}

// Local tile i (keys (first + i) * TK ..) of kv head h into stage
// i % kStages by cp.async, zero-filled past T; one commit group per call,
// empty past the block's n_local tiles.
template <typename L, bool kInt8, bool kPaged>
__device__ __forceinline__ void load_tile(uint8_t* smem, const Params& p,
                                          const Slot& slot, int h,
                                          int first, int i, int n_local) {
  if (i < n_local) {
    uint8_t* st = smem + (i % kStages) * L::kStage;
    const int t0 = (first + i) * TK;
    for (int c = threadIdx.x; c < TK * L::kChunks; c += kThreads) {
      const int r = c / L::kChunks, cc = c % L::kChunks;
      const bool in = t0 + r < p.T;
      const long long off =
          in ? (key_row<kPaged>(p, slot, t0 + r) * p.kv + h) * L::kRow +
                   cc * 16
             : 0;
      sm90::cp_async16(st + chunk_at<L>(r, cc),
                       (in ? slot.k : static_cast<const char*>(p.k)) + off,
                       in ? 16 : 0);
      sm90::cp_async16(st + L::kTile + chunk_at<L>(r, cc),
                       (in ? slot.v : static_cast<const char*>(p.v)) + off,
                       in ? 16 : 0);
    }
    if (kInt8) {   // k scales in threads 0..TK-1, v scales in the rest
      const int j = threadIdx.x % TK;
      const bool in = t0 + j < p.T, is_k = threadIdx.x < TK;
      const long long off =
          in ? key_row<kPaged>(p, slot, t0 + j) * p.kv + h : 0;
      const float* src = in ? (is_k ? slot.ks : slot.vs)
                            : (is_k ? p.k_scale : p.v_scale);
      sm90::cp_async4(reinterpret_cast<float*>(st + 2 * L::kTile) +
                          threadIdx.x / TK * TK + j,
                      src + off, in ? 4 : 0);
    }
  }
  sm90::cp_async_commit();
}

// RMAX: the block's row capacity, the smallest of 8/16/32 that holds
// g * S_v (32 when there are several row groups); the block computes rows
// r0 .. r0 + R - 1 of its kv head, r0 = RMAX_LIMIT * its group. Warp w
// owns keys 16w .. 16w + 15 of every tile and keeps its own online softmax
// over them (a split inside the block); lane (g, t) is (lane / 4, lane % 4)
// in the mma fragments.
//   S^T = K . Q^T: keys as M, query rows as N, the head dim as K. The
//     head dim is permuted inside each 16-wide step (k-indices 2t, 2t+1,
//     2t+8, 2t+9 are head dims 4t .. 4t+3), the same for K and Q, so a
//     lane's A fragment is 4 consecutive bytes of a key row.
//   O += P . V: query rows as M (zero past RMAX), head dims as N, the
//     warp's 16 keys as K. P goes through shared memory from the S^T
//     accumulator layout to the A layout; V's B fragments come from
//     ldmatrix.trans on the int8 tile: a lane's register holds keys 2t,
//     2t+1 at two adjacent head dims, which split into the fragments of an
//     even and an odd n-tile.
template <typename KV_T, int HD, int RMAX, bool kPaged>
__global__ void __launch_bounds__(kThreads, 1)
decode_kernel(const Params p) {
  using L = Smem<KV_T, HD, RMAX>;
  constexpr bool kInt8 = sizeof(KV_T) == 1;
  constexpr int RT = RMAX / 8;       // score n-tiles
  constexpr int RM = L::kRM;         // PV m-tiles
  constexpr int NT = HD / 8;         // PV n-tiles
  extern __shared__ __align__(16) uint8_t smem[];
  float* m_s = reinterpret_cast<float*>(smem + L::kM);
  float* l_s = m_s + RMAX;
  float* w_s = reinterpret_cast<float*>(smem + L::kW);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int split = blockIdx.x, n_split = gridDim.x;
  const int bh = blockIdx.y / p.n_grp;
  const int r0 = blockIdx.y % p.n_grp * RMAX_LIMIT;
  const int b = bh / p.kv, h = bh % p.kv;
  const int grp = p.H / p.kv, R = min(RMAX, grp * p.s_v - r0);
  __nv_bfloat16* p_w =
      reinterpret_cast<__nv_bfloat16*>(smem + L::kP) + warp * RM * 16 * 16;
  float* corr_w = reinterpret_cast<float*>(smem + L::kCorr) + warp * RMAX;
  float* wm = reinterpret_cast<float*>(smem + L::kWm);   // [kWarps][RMAX]
  float* wl = wm + kWarps * RMAX;

  // q rows (bf16, rows past R zero) in the first cp.async group
  for (int c = tid; c < RMAX * HD / 8; c += kThreads) {
    const int r = c / (HD / 8), d = c % (HD / 8) * 8, rq = r0 + r;
    const bool in = r < R;
    const long long off =
        in ? ((long long)(b * p.s_v + rq % p.s_v) * p.H + h * grp +
              rq / p.s_v) * HD + d : 0;
    sm90::cp_async16(smem + L::kQ + r * L::kQRow + d * 2, p.q + off,
                     in ? 16 : 0);
  }
  sm90::cp_async_commit();
  // the P rows no query row fills stay zero
  for (int i = tid; i < kWarps * RM * 16 * 16; i += kThreads)
    reinterpret_cast<__nv_bfloat16*>(smem + L::kP)[i] =
        __float2bfloat16(0.f);

  const int len = p.lengths[b];
  // this block's share of the live key tiles
  const int live = min(p.T, len + p.s_v);
  const int n_live = (live + TK - 1) / TK;
  const int per = (n_live + n_split - 1) / n_split;
  const int first = split * per;
  const int n_local = max(0, min(per, n_live - first));
  const Slot slot{static_cast<const char*>(p.k) +
                      (long long)b * p.kv_sb * sizeof(KV_T),
                  static_cast<const char*>(p.v) +
                      (long long)b * p.kv_sb * sizeof(KV_T),
                  kInt8 ? p.k_scale + (long long)b * p.s_sb : nullptr,
                  kInt8 ? p.v_scale + (long long)b * p.s_sb : nullptr,
                  kPaged ? p.tbl + (long long)b * p.tbl_stride : nullptr};
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i)
    load_tile<L, kInt8, kPaged>(smem, p, slot, h, first, i, n_local);

  // this lane's softmax state: rows rt * 8 + 2t + j
  float m[RT][2], l[RT][2];
  float o[RM][NT][4];
#pragma unroll
  for (int rt = 0; rt < RT; ++rt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      m[rt][j] = kNegInf;
      l[rt][j] = 0.f;
    }
#pragma unroll
  for (int mt = 0; mt < RM; ++mt)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][n][e] = 0.f;
  const int kw = 16 * warp;   // this warp's first key in a tile

  for (int i = 0; i < n_local; ++i) {
    sm90::cp_async_wait<kStages - 2>();   // tile i (and q) have landed
    __syncthreads();                      // ... for every thread
    // the stage tile i - 1 used
    load_tile<L, kInt8, kPaged>(smem, p, slot, h, first, i + kStages - 1,
                                n_local);
    const uint8_t* kt = smem + (i % kStages) * L::kStage;
    const uint8_t* vt = kt + L::kTile;
    const float* ks_s = reinterpret_cast<const float*>(kt + 2 * L::kTile);
    const float* vs_s = ks_s + TK;
    const int t0 = (first + i) * TK;

    // S^T: sc[rt][e] is key kw + g + 8 (e / 2), row rt * 8 + 2t + e % 2
    float sc[RT][4];
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[rt][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < HD / 16; ++kc) {
      uint32_t a[4];
      if constexpr (kInt8) {
        sm90::widen4(*reinterpret_cast<const uint32_t*>(
                   kt + chunk_at<L>(kw + g, kc) + 4 * t), a[0], a[2]);
        sm90::widen4(*reinterpret_cast<const uint32_t*>(
                   kt + chunk_at<L>(kw + g + 8, kc) + 4 * t), a[1], a[3]);
      } else {   // bf16: 4 head dims at 16 kc + 4t, 8 bytes
        const int c = 2 * kc + t / 2, off = t % 2 * 8;
        const uint2 r0 = *reinterpret_cast<const uint2*>(
            kt + chunk_at<L>(kw + g, c) + off);
        const uint2 r1 = *reinterpret_cast<const uint2*>(
            kt + chunk_at<L>(kw + g + 8, c) + off);
        a[0] = r0.x; a[2] = r0.y; a[1] = r1.x; a[3] = r1.y;
      }
#pragma unroll
      for (int rt = 0; rt < RT; ++rt) {
        const uint2 qb = *reinterpret_cast<const uint2*>(
            smem + L::kQ + (rt * 8 + g) * L::kQRow + 32 * kc + 8 * t);
        mma16816(sc[rt], a, qb.x, qb.y);
      }
    }

    // online softmax over the warp's 16 keys
#pragma unroll
    for (int rt = 0; rt < RT; ++rt) {
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kl = kw + g + 8 * (e / 2), key = t0 + kl;
        const int row = rt * 8 + 2 * t + e % 2;
        float s = sc[rt][e];
        if (kInt8) s *= ks_s[kl];
        s *= p.scale;
        const bool valid =
            row < R && key < p.T && key <= len + (r0 + row) % p.s_v;
        sc[rt][e] = valid ? s : kNegInf;
        mx[e % 2] = fmaxf(mx[e % 2], sc[rt][e]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int x = 4; x < 32; x <<= 1)
          mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], x));
        const float m_new = fmaxf(m[rt][j], mx[j]);
        const float corr = __expf(m[rt][j] - m_new);
        m[rt][j] = m_new;
        l[rt][j] *= corr;
        if (g == 0) corr_w[rt * 8 + 2 * t + j] = corr;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kl = g + 8 * (e / 2), row = rt * 8 + 2 * t + e % 2;
        const float s = sc[rt][e];
        const float pe = s > kNegInf / 2 ? __expf(s - m[rt][e % 2]) : 0.f;
        l[rt][e % 2] += pe;   // this lane's part; the warp adds up at the end
        p_w[row * 16 + kl] =
            __float2bfloat16(kInt8 ? pe * vs_s[kw + kl] : pe);
      }
    }
    __syncwarp();

    // O = O * corr + P . V
#pragma unroll
    for (int mt = 0; mt < RM; ++mt) {
      const int r0 = mt * 16 + g, r1 = r0 + 8;
      const float c0 = r0 < RMAX ? corr_w[r0] : 1.f;
      const float c1 = r1 < RMAX ? corr_w[r1] : 1.f;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        o[mt][n][0] *= c0;
        o[mt][n][1] *= c0;
        o[mt][n][2] *= c1;
        o[mt][n][3] *= c1;
      }
    }
    uint32_t pa[RM][4];
#pragma unroll
    for (int mt = 0; mt < RM; ++mt) {
      const __nv_bfloat16* pr = p_w + (mt * 16 + g) * 16 + 2 * t;
      pa[mt][0] = *reinterpret_cast<const uint32_t*>(pr);
      pa[mt][1] = *reinterpret_cast<const uint32_t*>(pr + 8 * 16);
      pa[mt][2] = *reinterpret_cast<const uint32_t*>(pr + 8);
      pa[mt][3] = *reinterpret_cast<const uint32_t*>(pr + 8 * 16 + 8);
    }
    // lanes 8j .. 8j + 7 address matrix j: keys kw + (j % 2) 8 + lane % 8
    // of chunk 2 c2 + j / 2
    const int lkey = kw + (lane / 8 % 2) * 8 + lane % 8;
#pragma unroll
    for (int c2 = 0; c2 < L::kChunks / 2; ++c2) {
      uint32_t r[4];
      ldmatrix_x4_trans(r, vt + chunk_at<L>(lkey, 2 * c2 + lane / 16));
#pragma unroll
      for (int ch = 0; ch < 2; ++ch) {
        const int cc = 2 * c2 + ch;
        if constexpr (kInt8) {   // chunk cc: head dims 16 cc ..
          uint32_t e0, o0, e1, o1;
          widen4_odd_even(r[2 * ch], e0, o0);
          widen4_odd_even(r[2 * ch + 1], e1, o1);
#pragma unroll
          for (int mt = 0; mt < RM; ++mt) {
            mma16816(o[mt][2 * cc], pa[mt], e0, e1);
            mma16816(o[mt][2 * cc + 1], pa[mt], o0, o1);
          }
        } else {                 // chunk cc: head dims 8 cc ..
#pragma unroll
          for (int mt = 0; mt < RM; ++mt)
            mma16816(o[mt][cc], pa[mt], r[2 * ch], r[2 * ch + 1]);
        }
      }
    }
    __syncwarp();   // p_w and corr_w are rewritten by the next tile
  }

  // each warp's partial: (m, l) per row, acc rows where the ring was
  sm90::cp_async_wait<0>();
  __syncthreads();
  float* acc_w = reinterpret_cast<float*>(smem) + warp * RMAX * HD;
#pragma unroll
  for (int rt = 0; rt < RT; ++rt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float lt = l[rt][j];
#pragma unroll
      for (int x = 4; x < 32; x <<= 1)
        lt += __shfl_xor_sync(0xffffffffu, lt, x);
      if (g == 0) {
        wm[warp * RMAX + rt * 8 + 2 * t + j] = m[rt][j];
        wl[warp * RMAX + rt * 8 + 2 * t + j] = lt;
      }
    }
#pragma unroll
  for (int mt = 0; mt < RM; ++mt)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = mt * 16 + g + 8 * (e / 2);
        // int8: n-tile 2cc + parity, head dim 16cc + 4t + 2 (e % 2) +
        // parity; bf16: n-tile cc, head dim 8cc + 2t + e % 2
        const int d = kInt8 ? 16 * (n / 2) + 4 * t + 2 * (e % 2) + n % 2
                            : 8 * n + 2 * t + e % 2;
        if (row < RMAX) acc_w[row * HD + d] = o[mt][n][e];
      }
  __syncthreads();
  // the block's partial from its warps', in warp order, into warp 0's rows
  float* part = reinterpret_cast<float*>(smem);
  for (int i = tid; i < R * HD; i += kThreads) {
    const int r = i / HD;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm[w * RMAX + r]);
    float lb = 0.f, ob = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float e = __expf(wm[w * RMAX + r] - mx);
      lb += wl[w * RMAX + r] * e;
      ob += part[w * RMAX * HD + i] * e;
    }
    part[i] = ob;
    if (i % HD == 0) {
      m_s[r] = mx;
      l_s[r] = lb;
    }
  }

  if (n_split > 1)
    sm90::cluster_sync();
  else
    __syncthreads();
  // every rank: each row's weight per split (the same bits in each rank)
  for (int r = tid; r < R; r += kThreads) {
    float mz[kMaxCluster], lz[kMaxCluster];
#pragma unroll
    for (int z = 0; z < kMaxCluster; ++z) {   // all loads first
      mz[z] = z < n_split ? sm90::ld_dsmem(sm90::dsmem(m_s + r, z))
                          : kNegInf;
      lz[z] = z < n_split ? sm90::ld_dsmem(sm90::dsmem(l_s + r, z)) : 0.f;
    }
    float mx = kNegInf;
#pragma unroll
    for (int z = 0; z < kMaxCluster; ++z) mx = fmaxf(mx, mz[z]);
    float l = 0.f;
#pragma unroll
    for (int z = 0; z < kMaxCluster; ++z) {
      if (z >= n_split) break;
      const float w = __expf(mz[z] - mx);
      w_s[r * (kMaxCluster + 1) + z] = w;
      l += lz[z] * w;
    }
    w_s[r * (kMaxCluster + 1) + kMaxCluster] = fmaxf(l, 1e-30f);
  }
  __syncthreads();
  // rank `split` writes its share of the R * HD outputs, each summed over
  // the splits in order
  const int n_out = R * HD, share = (n_out + n_split - 1) / n_split;
  for (int i = split * share + tid; i < min(n_out, (split + 1) * share);
       i += kThreads) {
    const int r = i / HD, d = i % HD;
    const float* w = w_s + r * (kMaxCluster + 1);
    float pz[kMaxCluster];
#pragma unroll
    for (int z = 0; z < kMaxCluster; ++z)
      pz[z] = z < n_split ? sm90::ld_dsmem(sm90::dsmem(part + i, z)) : 0.f;
    float o = 0.f;
#pragma unroll
    for (int z = 0; z < kMaxCluster; ++z)
      if (z < n_split) o += pz[z] * w[z];
    const int head = h * grp + (r0 + r) / p.s_v, qi = (r0 + r) % p.s_v;
    p.out[((long long)(b * p.s_v + qi) * p.H + head) * HD + d] =
        __float2bfloat16(o / w[kMaxCluster]);
  }
  if (n_split > 1) sm90::cluster_sync_exit();
}

template <typename KV_T, int HD, int RMAX, bool kPaged>
cudaError_t launch_rows(const Params& p, int B, int n_split,
                        cudaStream_t stream) {
  constexpr int smem = Smem<KV_T, HD, RMAX>::kBytes;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_kernel<KV_T, HD, RMAX, kPaged>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  return sm90::launch_cluster(decode_kernel<KV_T, HD, RMAX, kPaged>,
                              dim3(n_split, B * p.kv * p.n_grp), kThreads,
                              smem, stream, n_split, p);
}

template <typename KV_T, int HD, bool kPaged>
cudaError_t launch(const Params& p, int B, int n_split, cudaStream_t st) {
  const int rows = (p.H / p.kv) * p.s_v;
  if (rows <= 8) return launch_rows<KV_T, HD, 8, kPaged>(p, B, n_split, st);
  if (rows <= 16)
    return launch_rows<KV_T, HD, 16, kPaged>(p, B, n_split, st);
  return launch_rows<KV_T, HD, 32, kPaged>(p, B, n_split, st);
}

template <bool kPaged>
cudaError_t launch_kv(Params p, int B, int split_b, int hd, int int8_kv,
                      cudaStream_t st) {
  p.n_grp = row_groups(p.H, p.kv, p.s_v);
  const int n_split = choose_split(split_b * p.kv * p.n_grp, p.T);
  if (int8_kv) {
    if (hd == 128) return launch<int8_t, 128, kPaged>(p, B, n_split, st);
    if (hd == 64) return launch<int8_t, 64, kPaged>(p, B, n_split, st);
  } else {
    if (hd == 128)
      return launch<__nv_bfloat16, 128, kPaged>(p, B, n_split, st);
    if (hd == 64) return launch<__nv_bfloat16, 64, kPaged>(p, B, n_split, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Workspace f32 words that kft_flash_decode needs for this shape: 0 (the
// split is merged inside the launch), or -1 when the kernel does not
// support the shape (heads not a multiple of kv heads, or more than
// kMaxGridY (slot, kv head, row group) columns).
extern "C" long long kft_flash_decode_workspace(int B, int s_v, int H, int kv,
                                                int hd, int T) {
  return supported(B, H, kv, s_v) ? 0 : -1;
}

// split_b: the slot count whose (slot, kv head, row group) columns size
// the cluster, B for a launch over a whole slab, the slab's slot count for
// a window of its slots.
extern "C" int kft_flash_decode(const void* q, const void* k, const void* v,
                                const void* k_scale, const void* v_scale,
                                const void* lengths, void* out, int B,
                                int s_v, int H, int kv, int hd, int T,
                                int split_b, long long kv_sb, long long s_sb,
                                int int8_kv, float scale, void* stream) {
  if (!supported(B, H, kv, s_v) || T < 1 || split_b < 1)
    return (int)cudaErrorInvalidValue;
  Params p{static_cast<const __nv_bfloat16*>(q), k, v,
           static_cast<const float*>(k_scale),
           static_cast<const float*>(v_scale),
           static_cast<const int*>(lengths),
           static_cast<__nv_bfloat16*>(out), kv_sb, s_sb, s_v, H, kv, T,
           1, scale, nullptr, 0, 0};
  return (int)launch_kv<false>(p, B, split_b, hd, int8_kv,
                               static_cast<cudaStream_t>(stream));
}

// Paged mode: k/v the pool layer [N, bt, kv, hd] (int8 with scales
// [N, bt, kv] f32, or bf16), tables [B, nb] int32 with rows tbl_stride
// elements apart; slot b's nb * bt keys are its table's blocks in order.
extern "C" int kft_flash_decode_paged(const void* q, const void* k,
                                      const void* v, const void* k_scale,
                                      const void* v_scale,
                                      const void* lengths,
                                      const void* tables, void* out, int B,
                                      int s_v, int H, int kv, int hd, int bt,
                                      int nb, int tbl_stride, int int8_kv,
                                      float scale, void* stream) {
  if (!supported(B, H, kv, s_v) || bt < 1 || nb < 1 ||
      tbl_stride < nb)
    return (int)cudaErrorInvalidValue;
  Params p{static_cast<const __nv_bfloat16*>(q), k, v,
           static_cast<const float*>(k_scale),
           static_cast<const float*>(v_scale),
           static_cast<const int*>(lengths),
           static_cast<__nv_bfloat16*>(out), 0, 0, s_v, H, kv, nb * bt,
           1, scale, static_cast<const int*>(tables), bt, tbl_stride};
  return (int)launch_kv<true>(p, B, B, hd, int8_kv,
                              static_cast<cudaStream_t>(stream));
}
