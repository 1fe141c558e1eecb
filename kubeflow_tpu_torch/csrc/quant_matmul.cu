// K1: weight-only int8 skinny GEMM, out = (x @ q) * s.
//
// Replaces: kubeflow_tpu/ops/quant_matmul.py `_dequant_kernel` (the TPU
// Pallas kernel behind `dequant_matmul`).
//
// What it computes: x [m, d] bf16 (m <= 128) times the int8 weight
// q [d, o] (row-major, the JAX layout), accumulated in f32, times the
// per-output-channel f32 scale s [o], cast to bf16 or f32. The scale is
// applied once to the f32 sum, as the TPU kernel does.
//
// Bound on the H100: bytes. Every decode step reads every weight once for
// a handful of rows (2 * m operations per weight byte), so the time floor
// is d * o bytes over 3.35 TB/s: 7.50 GB of int8 weights per 8B decode step
// is 2.24 ms. Converting each weight by I2F and multiplying it on CUDA
// cores costs about that much again in instruction issue.
//
// Design: tensor cores, with the operands swapped so that nothing is
// wasted at m = 8: out^T = W^T . x^T on bf16 wgmma with f32 accumulation.
// An int8 value is exact in bf16, so this is the TPU kernel's arithmetic.
//   - A block owns BO = 64 output channels (wgmma's M) and a range of d;
//     the activation rows are wgmma's N, m rounded up to 8, 16, 32, 64 or
//     128 (zero rows above m).
//   - One producer warp: lane 0 streams int8 weight boxes [DK rows of d]
//     [64 channels] by TMA into a ring of kStages stages (the tensor map
//     is encoded once per weight and cached, since weights do not move);
//     all 32 lanes copy the matching x tile [N][DK] bf16 into the same
//     stage by cp.async, in the 128-byte swizzle, and the stage's full
//     barrier counts the TMA bytes and the 32 lanes' copies.
//   - Two consumer warpgroups take alternate stages. Each widens its int8
//     box to bf16 in shared memory (PRMT + FADD, no I2F; about 3
//     instructions and 5 bytes of shared-memory traffic per weight) in the
//     swizzle wgmma reads, then runs 8 wgmma m64nNk16 (in two
//     accumulator chains, even and odd k-steps) with W^T read MN-major (the
//     transpose bit; channels contiguous, as q lies in memory) and x^T
//     K-major. Widening in registers into an A fragment
//     would need a transposing int8 shared-memory load that sm_90 lacks.
//   - Split-K inside the launch: the blocks that share a channel tile
//     along d form one cluster of n_split <= 8; each leaves its two f32
//     partials in its own shared memory, and after a cluster barrier rank
//     r sums the 64 / n_split channels it owns over ranks 0.. n_split - 1
//     and consumer warpgroups 0, 1 in that order through distributed
//     shared memory, applies the scale and writes the output. No second
//     kernel, no workspace, and the bits repeat from launch to launch.
//     The split is chosen so the grid fills the SMs once (wq, wo and
//     w_down: 2-way, 128 blocks; wk and wv, 16 channel tiles: 8-way, 128
//     blocks); w_gate and w_up (224 tiles) and the lm_head are not split
//     and run two blocks a SM. The smallest matmuls stay far above their
//     byte bound, where the launch, one DRAM round trip and the cluster
//     barrier set the floor.
#include <mutex>

#include "sm90_primitives.cuh"

namespace {

constexpr int BO = 64;         // output channels per block: wgmma M
constexpr int DK = 128;        // rows of d per stage
constexpr int kConsumers = 2;  // consumer warpgroups, alternating stages
constexpr int kProducerWarp = 4 * kConsumers;
constexpr int kThreads = 128 * kConsumers + 32;
constexpr int kMaxCluster = 8;
constexpr int kSms = 132;
constexpr int kSmemPerSm = 228 * 1024;   // shared memory of one SM

// Byte offsets of a block's shared memory (from a 1024-aligned base) for
// N activation columns.
template <int N>
struct Cfg {
  static constexpr int kStages = N <= 16 ? 6 : 4;
  static constexpr int kW = DK * BO;             // int8 box [DK][BO]
  static constexpr int kX = DK / 64 * N * 128;   // x: [N][64] bf16 each
  static constexpr int kStage = kW + kX;         // a multiple of 1024
  static constexpr int kWide = kStages * kStage;  // per consumer: [DK][64]
  static constexpr int kWideBytes = DK * BO * 2;
  static constexpr int kBars = kWide + kConsumers * kWideBytes;
  // full[kStages], empty[kStages]; plus room to align the base
  static constexpr int kBytes = kBars + 2 * kStages * 8 + 1024;
  static constexpr int kPerSm = kSmemPerSm / (kBytes + 1024);
  // the epilogue's partials [kConsumers][BO][N] f32 reuse the ring
  static_assert(kConsumers * BO * N * 4 <= kWide, "partials do not fit");
};

// Blocks that share one channel tile along d (a cluster): doubled while
// the grid stays within one block per SM and each gets whole stages.
// (Filling the two a SM that fit measured slower on an H100.)
int choose_split(int d, int o) {
  const int tiles = o / BO;
  int split = 1;
  while (split * 2 <= kMaxCluster && tiles * split * 2 <= kSms &&
         d % (split * 2 * DK) == 0)
    split *= 2;
  return split;
}

template <int N>
struct WgmmaTA;

// d[64 x N] += A[64 x 16] . B[16 x N]: A MN-major in shared memory (the
// transpose bit), B K-major
template <>
struct WgmmaTA<8> {
  __device__ static void ss(float (&d)[4], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3}, "
        "%4, %5, p, 1, 1, 1, 0;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaTA<16> {
  __device__ static void ss(float (&d)[8], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, "
        "%8, %9, p, 1, 1, 1, 0;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaTA<32> {
  __device__ static void ss(float (&d)[16], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
        "%13, %14, %15}, "
        "%16, %17, p, 1, 1, 1, 0;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaTA<64> {
  __device__ static void ss(float (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
        "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 1, 0;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaTA<128> {
  __device__ static void ss(float (&d)[64], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
        "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
        "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
        "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
        "%57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 1, 0;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(1));
  }
};

__device__ __forceinline__ void wg_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(id) : "memory");
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <int N, typename OutT>
__global__ void __launch_bounds__(kThreads, Cfg<N>::kPerSm)
dequant_kernel(const __grid_constant__ CUtensorMap wm,
               const __nv_bfloat16* __restrict__ x,
               const float* __restrict__ s, OutT* __restrict__ out, int m,
               int d, int o) {
  using C = Cfg<N>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kBars);
  uint64_t* empty = full + C::kStages;
  const int split = blockIdx.x, n_split = gridDim.x;
  const int o0 = blockIdx.y * BO;
  const int k_begin = split * (d / n_split);
  const int n_stages = d / n_split / DK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // the epilogue's channels (see there); their scale, loaded early
  const int rows = BO / n_split, r0 = split * rows;
  const float scale = s[o0 + r0 + threadIdx.x % rows];
  if (threadIdx.x == 0) {
    for (int st = 0; st < C::kStages; ++st) {
      sm90::mbar_init(full + st, 1 + 32);   // TMA bytes + 32 lanes' x
      sm90::mbar_init(empty + st, 4);       // the consuming warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kProducerWarp) {
    for (int i = 0; i < n_stages; ++i) {
      const int st = i % C::kStages, k0 = k_begin + i * DK;
      sm90::mbar_wait(empty + st, ((i / C::kStages) & 1) ^ 1);
      uint8_t* stage = smem + st * C::kStage;
      if (lane == 0) {
        sm90::mbar_expect_tx(full + st, C::kW);
        sm90::tma_load(stage, &wm, o0, k0, 0, 0, full + st);
      }
      // x rows 0..N-1 (zero past m), columns k0..k0+DK: DK / 64 [N][64]
      // regions, 16-byte chunks XOR-swizzled by row (the 128-byte swizzle)
      for (int c = lane; c < N * DK / 8; c += 32) {
        const int r = c / (DK / 8), cc = c % (DK / 8);
        const bool in = r < m;
        sm90::cp_async16(stage + C::kW + (cc / 8) * N * 128 + r * 128 +
                             ((cc % 8) ^ (r % 8)) * 16,
                         x + (in ? (long long)r * d + k0 + cc * 8 : 0),
                         in ? 16 : 0);
      }
      sm90::cp_async_arrive(full + st);
    }
  } else if (warp < kProducerWarp) {
    const int wg = warp / 4, ct = threadIdx.x % 128;
    uint8_t* wide = smem + C::kWide + wg * C::kWideBytes;
    const uint32_t a_addr = sm90::smem_u32(wide);
    // two accumulator chains (even and odd k-steps) halve the dependent
    // wgmma chain of a stage; at every N, so that an output's sum runs in
    // one order whatever the row count: a row's bits at m = 112 (a verify
    // round of 16 slots x 7) are its bits at m = 16 (a decode step), and
    // speculation's greedy rows are the plain engine's on the card
    constexpr int kChains = 2;
    float acc[kChains][N / 2];
#pragma unroll
    for (int c = 0; c < kChains; ++c)
#pragma unroll
      for (int j = 0; j < N / 2; ++j) acc[c][j] = 0.f;
    for (int i = wg; i < n_stages; i += kConsumers) {
      const int st = i % C::kStages;
      uint8_t* stage = smem + st * C::kStage;
      sm90::mbar_wait(full + st, (i / C::kStages) & 1);
      wg_sync(1 + wg);   // the last wgmma is done with `wide`
      // int8 [DK][64] -> bf16 [DK][64], 16-byte chunks swizzled by row
#pragma unroll
      for (int c = ct; c < DK * BO / 16; c += 128) {
        const int r = c / (BO / 16), c8 = c % (BO / 16);
        uint32_t w[8];
        sm90::widen16(*reinterpret_cast<const int4*>(stage + c * 16), w);
#pragma unroll
        for (int half = 0; half < 2; ++half)
          *reinterpret_cast<int4*>(wide + r * 128 +
                                   ((2 * c8 + half) ^ (r % 8)) * 16) =
              make_int4(w[4 * half], w[4 * half + 1], w[4 * half + 2],
                        w[4 * half + 3]);
      }
      sm90::fence_async_smem();   // widened W and the landed x, to wgmma
      wg_sync(1 + wg);
      const uint32_t b_addr = sm90::smem_u32(stage + C::kW);
#pragma unroll
      for (int c = 0; c < kChains; ++c) sm90::fence_regs(acc[c]);
      sm90::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < DK / 16; ++kc)
        WgmmaTA<N>::ss(acc[kc % kChains],
                       sm90::desc(a_addr + kc * 2048, DK * 128, 1024),
                       sm90::desc(b_addr + kc / 4 * N * 128 + kc % 4 * 32,
                                  16, 1024));
      sm90::wgmma_commit();
      sm90::wgmma_wait();
#pragma unroll
      for (int c = 0; c < kChains; ++c) sm90::fence_regs(acc[c]);
      if (lane == 0) sm90::mbar_arrive(empty + st);   // W and x are free
    }
    // both warpgroups' partials where the ring was, once every stage is
    // consumed: acc[4j + 2i + e] is channel row(i), activation 8j + 2t + e
    asm volatile("bar.sync %0, %1;\n" :: "n"(1 + kConsumers),
                 "n"(128 * kConsumers) : "memory");
    float* part = reinterpret_cast<float*>(smem) + wg * BO * N;
    const int t = lane % 4;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = warp % 4 * 16 + lane / 4 + 8 * (e / 2);
        part[row * N + 8 * j + 2 * t + e % 2] =
            acc[0][4 * j + e] + acc[1][4 * j + e];
      }
  }
  __syncwarp();
  if (n_split > 1)
    sm90::cluster_sync();
  else
    __syncthreads();
  // rank `split` owns channels r0 .. r0 + rows - 1 of the tile; the
  // consumer threads take (channel tid % rows, activations tid / rows +
  // 256 / rows * k), each summed over the ranks, then the warpgroups, in
  // order
  if (threadIdx.x < 128 * kConsumers) {
    const int row = r0 + threadIdx.x % rows;
    const float* part = reinterpret_cast<const float*>(smem);
    for (int col = threadIdx.x / rows; col < m;
         col += 128 * kConsumers / rows) {
      float pz[kMaxCluster][kConsumers];
#pragma unroll
      for (int z = 0; z < kMaxCluster; ++z)   // all loads first
#pragma unroll
        for (int w = 0; w < kConsumers; ++w)
          pz[z][w] = z < n_split ? sm90::ld_dsmem(sm90::dsmem(
                                       part + (w * BO + row) * N + col, z))
                                 : 0.f;
      float v = 0.f;
#pragma unroll
      for (int z = 0; z < kMaxCluster; ++z)
#pragma unroll
        for (int w = 0; w < kConsumers; ++w)
          if (z < n_split) v += pz[z][w];
      store(out + (long long)col * o + o0 + row, v * scale);
    }
  }
  if (n_split > 1) sm90::cluster_sync_exit();
}

// One tensor map per weight, encoded at its first use: the weights of a
// model never move, and a map depends only on (pointer, d, o).
struct MapEntry {
  const void* q;
  int d, o;
  CUtensorMap map;
};
MapEntry g_maps[1024];
std::mutex g_maps_mu;

bool weight_map(const void* q, int d, int o, CUtensorMap* map) {
  const uint64_t key = reinterpret_cast<uintptr_t>(q) >> 4;
  std::lock_guard<std::mutex> lock(g_maps_mu);
  MapEntry& e = g_maps[(key * 0x9E3779B97F4A7C15ull) >> 54];
  if (e.q != q || e.d != d || e.o != o) {
    // [d][o] int8 as a 4-D map with two unit dimensions; box [DK][BO].
    // 128-byte L2 promotion: the box rows are 64 bytes (256 measured
    // slower on the 8B decode shapes).
    if (!sm90::tensor_map(&e.map, q, true, o, d, 1, 1, o, (long long)d * o,
                          (long long)d * o, BO, DK, 1,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_128B)) {
      e.q = nullptr;
      return false;
    }
    e.q = q;
    e.d = d;
    e.o = o;
  }
  *map = e.map;
  return true;
}

template <int N, typename OutT>
cudaError_t launch_n(const CUtensorMap& wm, const void* x, const void* s,
                     void* out, int m, int d, int o, cudaStream_t stream) {
  using C = Cfg<N>;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        dequant_kernel<N, OutT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, C::kBytes);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const int split = choose_split(d, o);
  return sm90::launch_cluster(
      dequant_kernel<N, OutT>, dim3(split, o / BO), kThreads, C::kBytes,
      stream, split, wm, static_cast<const __nv_bfloat16*>(x),
      static_cast<const float*>(s), static_cast<OutT*>(out), m, d, o);
}

template <typename OutT>
cudaError_t launch(const CUtensorMap& wm, const void* x, const void* s,
                   void* out, int m, int d, int o, cudaStream_t st) {
  if (m <= 8) return launch_n<8, OutT>(wm, x, s, out, m, d, o, st);
  if (m <= 16) return launch_n<16, OutT>(wm, x, s, out, m, d, o, st);
  if (m <= 32) return launch_n<32, OutT>(wm, x, s, out, m, d, o, st);
  if (m <= 64) return launch_n<64, OutT>(wm, x, s, out, m, d, o, st);
  return launch_n<128, OutT>(wm, x, s, out, m, d, o, st);
}

}  // namespace

// x [m, d] bf16, q [d, o] int8 and s [o] f32 contiguous, q 16-byte
// aligned; 1 <= m <= 128, d a multiple of 128, o of 64.
extern "C" int kft_dequant_matmul(const void* x, const void* q, const void* s,
                                  void* out, int m, int d, int o,
                                  int out_f32, void* stream) {
  if (m < 1 || m > 128 || d < DK || d % DK != 0 || o < BO || o % BO != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap wm;
  if (!weight_map(q, d, o, &wm)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_f32) return (int)launch<float>(wm, x, s, out, m, d, o, st);
  return (int)launch<__nv_bfloat16>(wm, x, s, out, m, d, o, st);
}
