// The Hopper forward mainloop of the two attention kernels that run a
// causal online softmax over streamed K/V tiles: K3 (flash_prefill.cu,
// serving prefill) and B1 (flash_attn_fwd.cu, training forward).
//
// Block: 128 query rows, 384 threads in three warpgroups.
//   Warpgroup 0, the producer, gives its registers away (setmaxnreg) and
//   one of its threads issues every load by TMA: the Q tile once, then
//   K and V tiles of BK keys into a ring of kStages stages. Each stage has
//   a full mbarrier (the TMA's transaction bytes) and an empty one (one
//   arrival per consumer warp).
//   Warpgroups 1 and 2, the consumers, own 64 rows each, the wgmma M:
//     S  = Q.K^T   wgmma m64nBKk16, Q and K both from shared memory;
//     the online softmax in registers, in log2 units (one exp2 a score);
//     O += P.V     wgmma m64nDk16 with p rounded to bf16 as the register
//                  A operand (the S accumulator layout is the A fragment
//                  layout) and V read transposed from shared memory.
// Tiles live in shared memory as regions of [rows][64] bf16, 128-byte
// rows in the 128-byte swizzle that TMA writes and the wgmma descriptors
// read (both XOR address bits 4-6 with bits 7-9, so every region starts
// 1024-byte aligned). int8 K/V arrive unswizzled by TMA and the consumers
// widen them to bf16 regions in the same swizzle (exact for int8).
//
// The TMA, barrier and wgmma primitives are in sm90_primitives.cuh, which
// the backward kernels share.
//
// The kernels differ only in where a row sits and which keys it sees
// (`Rows`), in the int8 scales (`KvScales`, K3 only) and in their
// epilogues, which each kernel writes from the returned o, m and l.
//
// K3's paged mode (PAGED, `Pages`) changes only where a K/V tile comes
// from: the producer loads a tile of slot b as boxes from the pool blocks
// that b's table names, and the consumers read an int8 key's scales at
// its pool row. The products, the widening and the softmax are the slab
// path's, and with PAGED false the code is the slab path's as it was.
#pragma once

#include "sm90_primitives.cuh"

namespace sm90 {

constexpr int kBM = 128;        // query rows per block
constexpr int kStages = 2;      // K/V ring depth
constexpr int kBK = 128;        // keys per K/V tile

// Byte offsets of a block's shared memory (from a 1024-aligned base).
template <int D, bool INT8>
struct Smem {
  static constexpr int kTile = kBK * D * (INT8 ? 1 : 2);   // K or V as landed
  static constexpr int kWideTile = INT8 ? kBK * D * 2 : 0;  // widened to bf16
  static constexpr int kQ = 0;                          // [D/64][kBM][64]
  static constexpr int kRing = kQ + kBM * D * 2;        // stage s: K, then V
  static constexpr int kWide = kRing + 2 * kStages * kTile;  // K, then V
  static constexpr int kScales = kWide + 2 * kWideTile;  // k, v [kBK] f32
  static constexpr int kBars = kScales + (INT8 ? 2 * kBK * 4 : 0);
  // full[kStages], empty[kStages], q; plus room to align the base
  static constexpr int kBytes = kBars + (2 * kStages + 1) * 8 + 1024;
};

// -- the mainloop ------------------------------------------------------------

// Which keys this thread's two rows see.
struct Rows {
  int pos[2];          // each row's position: causal rows see keys <= it
  int seg[2];          // each row's segment id (when seg_k is set)
  const int* seg_k;    // null, or this batch row's key segment ids
  int n_keys;          // keys at or past it are padding
  int first_pos;       // the smallest position of any row of the block
  bool causal;

  // whether every row of the block sees all of [k0, k0 + kBK)
  __device__ bool whole(int k0) const {
    return seg_k == nullptr && k0 + kBK <= n_keys &&
           (!causal || k0 + kBK - 1 <= first_pos);
  }
};

// int8 K/V: key t's scales are k[t * stride] and v[t * stride].
struct KvScales {
  const float* k;
  const float* v;
  int stride;
};

// Paged K/V: one slot's table row. Key t lies in pool row
// tbl[t / bt] * bt + t % bt of a pool [n_blocks, bt, kv, D]; a tile's
// boxes past the row's nb blocks load from block n_blocks, out of the
// map's bounds, which TMA fills with zeros (and counts in full).
struct Pages {
  const int* tbl;
  int bt, nb, n_blocks;
};

// Aligns the block's shared memory, sets up the barriers and zeroes the
// Q rows [q_rows, kBM) that no TMA box covers; ends in __syncthreads.
template <int D, bool INT8>
__device__ uint8_t* begin(uint8_t* raw, int q_rows) {
  using L = Smem<D, INT8>;
  uint8_t* smem = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + s, 1);
      mbar_init(bars + kStages + s, kConsumerWarps);
    }
    mbar_init(bars + 2 * kStages, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (q_rows < kBM) {
    const int pad = kBM - q_rows;   // 8 chunks of 16 bytes per row
    for (int i = threadIdx.x; i < (D / 64) * pad * 8; i += kThreads) {
      const int c = i / (pad * 8), r = q_rows + i / 8 % pad;
      *reinterpret_cast<int4*>(smem + L::kQ + c * kBM * 128 + r * 128 +
                               i % 8 * 16) = make_int4(0, 0, 0, 0);
    }
    fence_async_smem();
  }
  __syncthreads();
  return smem;
}


// The producer thread: Q rows [q0, q0 + q_rows) of head coordinate qh
// (q_rows * 128 bytes per 64-column box), then n_tiles K/V tiles of head
// coordinate kh, batch b. PAGED: K/V maps over the pool [n_blocks, bt,
// kv, D] with boxes of min(bt, kBK) rows; tile i's keys i * kBK + r come
// from block tbl[(i * kBK + r) / bt] (b is unused), one box per block
// share of the tile, each landing at its row of the stage. A landing row
// that is a multiple of 8 starts a 1024-byte swizzle atom in bf16 (and a
// 16-byte multiple in int8), so the wrapper takes bt a multiple of 8
// that divides kBK, or a multiple of kBK.
template <int D, bool INT8, bool PAGED = false>
__device__ void produce(uint8_t* smem, const CUtensorMap* qm,
                        const CUtensorMap* km, const CUtensorMap* vm,
                        int q_rows, int qh, int q0, int kh, int b,
                        int n_tiles, const Pages& pg = Pages{}) {
  using L = Smem<D, INT8>;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = full + 2 * kStages;
  mbar_expect_tx(qbar, (D / 64) * q_rows * 128);
  for (int c = 0; c < D / 64; ++c)
    tma_load(smem + L::kQ + c * kBM * 128, qm, c * 64, qh, q0, b, qbar);
  constexpr int kBoxes = INT8 ? 1 : D / 64;   // int8: one [kBK][D] box
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kStages;
    mbar_wait(empty + st, ((i / kStages) & 1) ^ 1);   // first pass: free
    mbar_expect_tx(full + st, 2 * L::kTile);
    uint8_t* kt = smem + L::kRing + 2 * st * L::kTile;
    if constexpr (PAGED) {
      constexpr int kRow = INT8 ? D : 128;   // bytes of a row in a region
      const int rows = min(pg.bt, kBK);
      for (int r0 = 0; r0 < kBK; r0 += rows) {
        const int t = i * kBK + r0, j = t / pg.bt;
        const int blk = j < pg.nb ? __ldg(pg.tbl + j) : pg.n_blocks;
        for (int c = 0; c < kBoxes; ++c) {
          uint8_t* dst = kt + c * kBK * 128 + r0 * kRow;
          tma_load(dst, km, c * 64, kh, t % pg.bt, blk, full + st);
          tma_load(dst + L::kTile, vm, c * 64, kh, t % pg.bt, blk,
                   full + st);
        }
      }
    } else {
      for (int c = 0; c < kBoxes; ++c) {
        tma_load(kt + c * kBK * 128, km, c * 64, kh, i * kBK, b, full + st);
        tma_load(kt + L::kTile + c * kBK * 128, vm, c * 64, kh, i * kBK, b,
                 full + st);
      }
    }
  }
}

// A [kBK][D] int8 tile to bf16 regions in the 128-byte swizzle; the 256
// consumer threads share the work (ct is this one's index).
template <int D>
__device__ __forceinline__ void widen(uint8_t* dst, const uint8_t* src,
                                      int ct) {
  constexpr int CH = D / 16;   // 16-byte int8 chunks per row
#pragma unroll 2
  for (int i = ct; i < kBK * CH; i += 256) {
    const int r = i / CH, c = i % CH * 16;
    uint32_t w[8];
    widen16(*reinterpret_cast<const int4*>(src + r * D + c), w);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int col = c + 8 * half, grp = col % 64 / 8;
      *reinterpret_cast<int4*>(dst + col / 64 * kBK * 128 + r * 128 +
                               (grp ^ (r % 8)) * 16) =
          make_int4(w[4 * half], w[4 * half + 1], w[4 * half + 2],
                    w[4 * half + 3]);
    }
  }
}

// A consumer thread: attention of its warpgroup's 64 rows over n_tiles
// K/V tiles. Returns o (the wgmma accumulator layout: o[4j + 2i + e] is
// row(i), column 8j + 2 (lane % 4) + e), each row's max m in log2 units
// (kNegInf if it saw no key) and its sum l, clamped to 1e-30. Numerics of
// the TPU kernels: scores s = q.k in f32 (times the int8 k scale, then the
// softmax scale), -1e30 where masked; p = 0 where masked; l sums the
// unrounded p; p times the int8 v scale is rounded to bf16 before p.v.
// PAGED: key t's scales are read at its pool row (see Pages).
template <int D, bool INT8, bool PAGED = false>
__device__ void consume(uint8_t* smem, const Rows& rows, const KvScales& sc,
                        int n_tiles, float scale, float (&o)[D / 2],
                        float (&m)[2], float (&l)[2],
                        const Pages& pg = Pages{}) {
  using L = Smem<D, INT8>;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = full + 2 * kStages;
  float* ks_s = reinterpret_cast<float*>(smem + L::kScales);
  float* vs_s = ks_s + kBK;
  const int ct = threadIdx.x - 128, lane = threadIdx.x % 32, t = lane % 4;
  const float scale2 = scale * kLog2e;
#pragma unroll
  for (int j = 0; j < D / 2; ++j) o[j] = 0.f;
  m[0] = m[1] = kNegInf;
  l[0] = l[1] = 0.f;
  // this warpgroup's 64 rows of each Q region
  const uint32_t q_addr = smem_u32(smem + L::kQ) + ct / 128 * 64 * 128;
  mbar_wait(qbar, 0);

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kStages, k0 = i * kBK;
    mbar_wait(full + st, (i / kStages) & 1);
    uint8_t* kt = smem + L::kRing + 2 * st * L::kTile;
    uint8_t* vt = kt + L::kTile;
    if constexpr (INT8) {
      consumer_sync();   // both warpgroups are done with the last tile
      widen<D>(smem + L::kWide, kt, ct);
      widen<D>(smem + L::kWide + L::kWideTile, vt, ct);
      if constexpr (PAGED) {
        for (int j = ct; j < kBK; j += 256) {
          const int t = k0 + j;
          const bool in = t < rows.n_keys;
          const long long r =
              in ? (long long)__ldg(pg.tbl + t / pg.bt) * pg.bt + t % pg.bt
                 : 0;
          ks_s[j] = in ? sc.k[r * sc.stride] : 0.f;
          vs_s[j] = in ? sc.v[r * sc.stride] : 0.f;
        }
      } else {
        for (int j = ct; j < kBK; j += 256) {
          const bool in = k0 + j < rows.n_keys;
          ks_s[j] = in ? sc.k[(long long)(k0 + j) * sc.stride] : 0.f;
          vs_s[j] = in ? sc.v[(long long)(k0 + j) * sc.stride] : 0.f;
        }
      }
      fence_async_smem();
      consumer_sync();
      if (lane == 0) mbar_arrive(empty + st);   // the int8 stage is free
      kt = smem + L::kWide;
      vt = kt + L::kWideTile;
    }

    // S = Q.K^T: D/16 steps of 16 along the head dim, 32 bytes apart
    // inside a 128-byte swizzle row, then on to the next 64-column region
    float s[kBK / 2];
    const uint32_t k_addr = smem_u32(kt);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc)
      Wgmma<kBK>::ss(s,
                     desc(q_addr + kc / 4 * kBM * 128 + kc % 4 * 32, 16,
                          1024),
                     desc(k_addr + kc / 4 * kBK * 128 + kc % 4 * 32, 16,
                          1024),
                     kc);
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);

    // online softmax; s[4j + e] is row(e / 2), key k0 + 8j + 2t + e % 2
    if constexpr (INT8) {
#pragma unroll
      for (int j = 0; j < kBK / 2; ++j)
        s[j] *= ks_s[8 * (j / 4) + 2 * t + (j & 1)];
    }
    float mx[2] = {kNegInf, kNegInf}, corr[2], sum[2] = {0.f, 0.f};
    const bool whole = rows.whole(k0);
    if (whole) {   // no mask: the max of the raw scores (scale2 > 0)
#pragma unroll
      for (int j = 0; j < kBK / 2; ++j)
        mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], s[j]);
      mx[0] *= scale2;
      mx[1] *= scale2;
    } else {   // one segment id load per key, shared by the two rows
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int key = k0 + 8 * j + 2 * t + c;
          const bool in = key < rows.n_keys;
          const int seg =
              rows.seg_k == nullptr ? 0 : __ldg(rows.seg_k + (in ? key : 0));
#pragma unroll
          for (int hi = 0; hi < 2; ++hi) {
            const bool ok = in & (!rows.causal | (key <= rows.pos[hi])) &
                            (rows.seg_k == nullptr | (seg == rows.seg[hi]));
            float& x = s[4 * j + 2 * hi + c];
            x = ok ? x * scale2 : kNegInf;
            mx[hi] = fmaxf(mx[hi], x);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = exp2_fast(m[r] - m_new);
      m[r] = m_new;
    }
    if (whole) {   // one FFMA and one exp2 a score
#pragma unroll
      for (int j = 0; j < kBK / 2; ++j) {
        s[j] = exp2_fast(fmaf(s[j], scale2, -m[(j >> 1) & 1]));
        sum[(j >> 1) & 1] += s[j];
      }
    } else {
#pragma unroll
      for (int j = 0; j < kBK / 2; ++j) {
        s[j] = s[j] > kNegInf / 2 ? exp2_fast(s[j] - m[(j >> 1) & 1]) : 0.f;
        sum[(j >> 1) & 1] += s[j];
      }
    }
    if constexpr (INT8) {
#pragma unroll
      for (int j = 0; j < kBK / 2; ++j)
        s[j] *= vs_s[8 * (j / 4) + 2 * t + (j & 1)];
    }
    // l is this thread's partial sum; the quad adds up at the end
    l[0] = l[0] * corr[0] + sum[0];
    l[1] = l[1] * corr[1] + sum[1];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] *= corr[0];
      o[4 * j + 1] *= corr[0];
      o[4 * j + 2] *= corr[1];
      o[4 * j + 3] *= corr[1];
    }

    // O += P.V: kBK/16 steps of 16 keys (two 8-key swizzle atoms, 2048
    // bytes); V is MN-major, its 64-column regions kBK * 128 bytes apart.
    // Every A fragment is packed before the fence, so no wgmma of the
    // chain waits for a register write.
    uint32_t pa[kBK / 16][4];
#pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc) {
      pa[kc][0] = pack_bf16(s[8 * kc], s[8 * kc + 1]);
      pa[kc][1] = pack_bf16(s[8 * kc + 2], s[8 * kc + 3]);
      pa[kc][2] = pack_bf16(s[8 * kc + 4], s[8 * kc + 5]);
      pa[kc][3] = pack_bf16(s[8 * kc + 6], s[8 * kc + 7]);
    }
    const uint32_t v_addr = smem_u32(vt);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc)
      Wgmma<D>::rs(o, pa[kc], desc(v_addr + kc * 2048, kBK * 128, 1024));
    wgmma_commit();
    wgmma_wait();
    fence_regs(o);
    if (!INT8 && lane == 0) mbar_arrive(empty + st);   // K and V are free
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
}

}  // namespace sm90
