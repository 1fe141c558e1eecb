// K1: weight-only int8 skinny GEMM, out = (x @ q) * s.
//
// Replaces: kubeflow_tpu/ops/quant_matmul.py `_dequant_kernel` (the TPU
// Pallas kernel behind `dequant_matmul`).
//
// What it computes: x [m, d] bf16 (m <= 128) times the int8 weight
// q [d, o] (row-major, x @ W layout), accumulated in f32, times the
// per-output-channel f32 scale s [o], cast to bf16 or f32. The scale is
// applied once to the f32 sum, as the TPU kernel does.
//
// Bound on the H100: bytes. Every decode step reads every weight once for
// a handful of rows (2 * m operations per weight byte), so the time floor
// is d * o bytes over 3.35 TB/s: 7.50 GB of int8 weights per 8B decode step
// is 2.24 ms.
//
// Design: each warp owns a strip of 256 output columns, each lane 8
// adjacent columns read as one 8-byte word, so a warp reads 256 contiguous
// bytes of a weight row per load. The 8 warps of a block share one strip
// and split the block's rows of d between them (row k goes to warp k % 8);
// their f32 partial sums meet in shared memory at the end. The x rows of
// the block (8 at a time) are staged in shared memory as f32 and read as
// broadcasts. A grid over column strips alone gives o / 256 blocks, 4 for
// the 1024-wide wk/wv, so d is also split across blocks (split-K) until
// the card holds about three blocks per SM; those partial sums go to an
// f32 workspace that a second kernel reduces in a fixed order
// (deterministic, no atomics) while applying the scale. When the strips
// alone fill the card (the 128256-wide lm_head) there is no split and the
// first kernel writes the output. The split count is chosen here
// (`kft_dequant_matmul_workspace` reports the workspace it needs), so the
// tile sizes are known only in this file.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MT = 8;              // activation rows per block
constexpr int CPT = 8;             // output columns per lane
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int COLS = 32 * CPT;     // output columns per block
constexpr int KCH = 256;           // x columns staged in shared memory per pass
constexpr int SMEM = (MT * KCH + WARPS * MT * COLS) * 4;
constexpr int TARGET_BLOCKS = 396;   // about three blocks on each of 132 SMs
constexpr int MIN_SPLIT_DEPTH = 128; // rows of d per split, at least

// Blocks that share one output column strip along d: doubled until the
// grid holds TARGET_BLOCKS or a split would get too few rows of d.
int choose_splits(int m, int d, int o) {
  const int blocks = ((o + COLS - 1) / COLS) * ((m + MT - 1) / MT);
  int splits = 1;
  while (blocks * splits < TARGET_BLOCKS && d % (splits * 2) == 0 &&
         d / (splits * 2) >= MIN_SPLIT_DEPTH)
    splits *= 2;
  return splits;
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename OutT>
__global__ void __launch_bounds__(THREADS, 2)
dequant_kernel(const __nv_bfloat16* __restrict__ x,
               const int8_t* __restrict__ q, const float* __restrict__ s,
               OutT* __restrict__ out, float* __restrict__ ws, int m, int d,
               int o, int kc) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                  // [MT][KCH]
  float* red = smem + MT * KCH;      // [WARPS][MT][COLS]
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int col = blockIdx.x * COLS + lane * CPT;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * MT;
  const int k_begin = split * kc;
  float acc[MT][CPT];
#pragma unroll
  for (int r = 0; r < MT; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[r][c] = 0.f;

  for (int k0 = k_begin; k0 < k_begin + kc; k0 += KCH) {
    const int len = min(KCH, k_begin + kc - k0);
    __syncthreads();
    for (int i = threadIdx.x; i < MT * KCH; i += THREADS) {
      int r = i / KCH, kk = i % KCH;
      float val = 0.f;
      if (m0 + r < m && kk < len)
        val = __bfloat162float(x[(long long)(m0 + r) * d + k0 + kk]);
      xs[i] = val;
    }
    __syncthreads();
    if (col < o) {
      const int8_t* qp = q + (long long)k0 * o + col;
#pragma unroll 4
      for (int kk = warp; kk < len; kk += WARPS) {
        const int2 w = __ldg(reinterpret_cast<const int2*>(
            qp + (long long)kk * o));
        const char4 lo = *reinterpret_cast<const char4*>(&w.x);
        const char4 hi = *reinterpret_cast<const char4*>(&w.y);
        const float wf[CPT] = {(float)lo.x, (float)lo.y, (float)lo.z,
                               (float)lo.w, (float)hi.x, (float)hi.y,
                               (float)hi.z, (float)hi.w};
#pragma unroll
        for (int r = 0; r < MT; ++r) {
          const float xv = xs[r * KCH + kk];
#pragma unroll
          for (int c = 0; c < CPT; ++c) acc[r][c] = fmaf(xv, wf[c], acc[r][c]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < MT; ++r) {
    float* dst = red + (warp * MT + r) * COLS + lane * CPT;
    *reinterpret_cast<float4*>(dst) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    *reinterpret_cast<float4*>(dst + 4) =
        make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
  }
  __syncthreads();
  // one thread per column sums the warps in order
  const int cg = blockIdx.x * COLS + threadIdx.x;
  if (cg >= o) return;
  for (int r = 0; r < MT && m0 + r < m; ++r) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) v += red[(w * MT + r) * COLS + threadIdx.x];
    if (ws != nullptr)
      ws[((long long)split * m + m0 + r) * o + cg] = v;
    else
      store(out + (long long)(m0 + r) * o + cg, v * s[cg]);
  }
}

// out[i] = (sum over splits of ws[split][i]) * s[col], splits in order.
template <typename OutT>
__global__ void splitk_reduce(const float* __restrict__ ws,
                              const float* __restrict__ s,
                              OutT* __restrict__ out, int m, int o,
                              int splits) {
  const long long n = (long long)m * o;
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = 0.f;
  for (int sp = 0; sp < splits; ++sp) v += ws[sp * n + i];
  store(out + i, v * s[i % o]);
}

template <typename OutT>
cudaError_t launch(const void* x, const void* q, const void* s, void* out,
                   void* ws, int m, int d, int o, int splits,
                   cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        dequant_kernel<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  dim3 grid((o + COLS - 1) / COLS, splits, (m + MT - 1) / MT);
  float* wsf = splits > 1 ? static_cast<float*>(ws) : nullptr;
  dequant_kernel<OutT><<<grid, THREADS, SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(s), static_cast<OutT*>(out), wsf, m, d, o,
      d / splits);
  if (splits == 1) return cudaGetLastError();
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long n = (long long)m * o;
  splitk_reduce<OutT><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      wsf, static_cast<const float*>(s), static_cast<OutT*>(out), m, o,
      splits);
  return cudaGetLastError();
}

}  // namespace

// f32 words of workspace that kft_dequant_matmul needs for this shape
// (0 when d is not split).
extern "C" long long kft_dequant_matmul_workspace(int m, int d, int o) {
  const int splits = choose_splits(m, d, o);
  return splits > 1 ? (long long)splits * m * o : 0;
}

extern "C" int kft_dequant_matmul(const void* x, const void* q, const void* s,
                                  void* out, void* ws, int m, int d, int o,
                                  int out_f32, void* stream) {
  if (m < 1 || d < 1 || o % CPT != 0) return (int)cudaErrorInvalidValue;
  const int splits = choose_splits(m, d, o);
  if (d % splits != 0 || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_f32) return (int)launch<float>(x, q, s, out, ws, m, d, o, splits, st);
  return (int)launch<__nv_bfloat16>(x, q, s, out, ws, m, d, o, splits, st);
}
