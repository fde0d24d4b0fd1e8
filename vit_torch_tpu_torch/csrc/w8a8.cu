// The dynamic W8A8 serving path's two device operations for Hopper
// (sm_90a):
//   Q1  row quantisation:  (R, K) bf16 or fp32 -> int8 codes (R, K) and
//       fp32 scales (R), symmetric per row;
//   Q2  int8 product:      s8 (T, K) x s8 (N, K)^T -> s32, rescaled per row
//       and per column in fp32 (+ bias), cast to fp32 or bf16.
//
// They replace no Pallas kernel: vit_torch_tpu/ops/quant.py computes both
// with XLA ops (quantize_rowwise / quantize_weight, :68-90, and the
// dot_general + rescale of w8a8_dot, :93-117), which the TPU's compiler
// lowers to its int8 matrix unit.  On the H100 the same work needs hand
// kernels: PyTorch has no int8 GEMM on the port's path (torch._int_mm is
// timed beside Q2 by chip_smoke.py as a yardstick only).
//
// Arithmetic, bit for bit that of quant.py (and of the plain versions in
// ops/quant.py):
// - Q1: the input widened to fp32; absmax = max |x| over the row;
//   scale = absmax / 127 + 1e-8 (IEEE division, round to nearest, then the
//   add); q = clamp(rint(x / scale), -127, 127), an IEEE division and
//   round half to even (__fdiv_rn, rintf; no reciprocal, no fast math).
//   A zero row has scale 1e-8 and codes 0.
// - Q2: the s32 sum is exact (|sum| <= 127^2 K < 2^31 for K < 133,000);
//   y = (float(acc) * x_scale[row]) * w_scale[col] (+ bias[col]), each step
//   rounded (__fmul_rn / __fadd_rn, so nvcc contracts nothing into an FMA),
//   in quant.py's order, then rounded once to the output dtype.
//
// Bounds on an H100 (1,979 TOP/s dense int8, 3.35 TB/s): Q1 moves its
// input once, its codes and scales once, and is bound by bytes (dino_vitb8
// @224 bs32 fc2's input, 25,120 x 3,072 bf16: 0.23 GB, 0.07 ms).  Q2 does
// 2 T K N operations and moves A, W and Y once; at that model's fc1 (T =
// 25,120, K = 768, N = 3,072) it is bound by operations (0.060 ms).
//
// Design.
// - Q1: one warp a row, eight rows a block; 16-byte loads (8 bf16 or 4
//   fp32 a lane), a first pass for the absmax (butterfly over the warp),
//   a second pass that reads the row again (from L1/L2) and writes 8 or 4
//   codes a lane.  K a multiple of 16.
// - Q2: the shape of window_gemm.cu's plain product, over int8: persistent,
//   warp-specialised blocks of 384 threads walking 128 x BN output tiles
//   (BN = 128 or 192, ops/quant.py:int8_plan picks it as ops/gemm.py's
//   gemm_plan does), tile index column-fastest.  A stage of the mbarrier
//   ring is a k-step of 128: the 128 x 128 int8 A tile and the BN x 128
//   W tile, each a TMA box in the 128-byte swizzle, which for int8 is the
//   bf16 tile's layout byte for byte (sm90.cuh).  Warpgroup 2's first
//   thread is the producer; warpgroups 0 and 1 own 64 rows each and run
//   wgmma m64nBNk32 s32.s8.s8 (four a stage), releasing a stage once the
//   wgmma that read it has retired.  Both operands are K-major, the only
//   form the 8-bit wgmma takes: the port's (N, K) weight is read as it is
//   stored.  The K tail (K a multiple of 16, not of 128) is TMA's zero fill
//   in both operands; rows past T and columns past N read zero and are not
//   written.  The epilogue rescales each thread's accumulator pairs and
//   writes them straight to device memory (two fp32 or bf16 a store, a
//   warp covering 8 rows of 8 columns): simple, not yet fast.
//
// C entry points (ctypes): w8a8_quantize_rows(...) and w8a8_gemm(...)
// return the cudaError_t of the launch; they launch on the given stream and
// do not synchronise or allocate.  A width, plan or option the kernels do
// not take is refused with cudaErrorInvalidValue before any launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

// ---- Q1 ------------------------------------------------------------------

constexpr int kQRows = 8;   // rows a block, one warp each

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ int8_t code(float x, float scale) {
  const float q = rintf(__fdiv_rn(x, scale));
  return static_cast<int8_t>(fminf(fmaxf(q, -127.f), 127.f));
}

template <typename T>
__global__ void __launch_bounds__(32 * kQRows)
    quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                         float* __restrict__ scale, int R, int K) {
  constexpr int kE = 16 / sizeof(T);   // elements a 16-byte load
  const int lane = threadIdx.x & 31;
  const long long r =
      static_cast<long long>(blockIdx.x) * kQRows + (threadIdx.x >> 5);
  if (r >= R) return;
  const T* src = x + r * K;
  float amax = 0.f;
  for (int c = lane * kE; c < K; c += 32 * kE) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(src + c));
    const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
    for (int i = 0; i < kE; ++i) amax = fmaxf(amax, fabsf(widen(e[i])));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  }
  const float s = __fadd_rn(__fdiv_rn(amax, 127.f), 1e-8f);
  int8_t* dst = q + r * K;
  for (int c = lane * kE; c < K; c += 32 * kE) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(src + c));
    const T* e = reinterpret_cast<const T*>(&v);
    uint32_t out[kE / 4] = {};   // the codes, four a word
#pragma unroll
    for (int i = 0; i < kE; ++i) {
      out[i / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(
                        code(widen(e[i]), s)))
                    << (8 * (i % 4));
    }
    if constexpr (kE == 8) {
      *reinterpret_cast<uint2*>(dst + c) = make_uint2(out[0], out[1]);
    } else {
      *reinterpret_cast<uint32_t*>(dst + c) = out[0];
    }
  }
  if (lane == 0) scale[r] = s;
}

// ---- Q2 ------------------------------------------------------------------

constexpr int kThreads = 384;      // 2 consumer warpgroups + producer
constexpr int kBM = 128;           // rows a tile: 64 a consumer warpgroup
constexpr int kBK = 128;           // int8 of K a stage (128-byte rows)
constexpr int kSmemMax = 232448;   // 227 KB a block may use
constexpr int kMaxStages = 8;
constexpr int kFixed = 1024 + 2 * kMaxStages * 8;   // alignment, barriers

struct Params {
  const float* x_scale;   // (T)
  const float* w_scale;   // (N)
  const float* bias;      // (N) or null
  void* y;                // (T, N) fp32 or bf16
  int T, K, N;
  int out_bf16;
  int tiles_n, tiles, ksteps, stages;
};

__device__ __forceinline__ float rescale(uint32_t acc, float xs, float ws,
                                         float b, bool has_bias) {
  const float y = __fmul_rn(__fmul_rn(__int2float_rn(static_cast<int>(acc)),
                                      xs), ws);
  return has_bias ? __fadd_rn(y, b) : y;
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
    w8a8_gemm_kernel(const __grid_constant__ CUtensorMap tm_x,
                     const __grid_constant__ CUtensorMap tm_w,
                     const Params p) {
  constexpr int kStage = (kBM + BN) * kBK;   // A + W tiles of a k-step
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = sm90::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + p.stages * kStage);
  uint64_t* empty = full + kMaxStages;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      sm90::mbar_init(full + s, 1);
      sm90::mbar_init(empty + s, 8);   // one arrival per consumer warp
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == 2) {
    // ---- producer
    sm90::setmaxnreg_dec<56>();
    if (threadIdx.x == 256) {
      sm90::tma_prefetch_desc(&tm_x);
      sm90::tma_prefetch_desc(&tm_w);
      sm90::RingPos rp;
#pragma unroll 1
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        const int m0 = (tile / p.tiles_n) * kBM;
        const int n0 = (tile % p.tiles_n) * BN;
#pragma unroll 1
        for (int kk = 0; kk < p.ksteps; ++kk) {
          sm90::mbar_wait(empty + rp.stage, rp.phase ^ 1);
          uint8_t* st = ring + rp.stage * kStage;
          sm90::mbar_arrive_expect_tx(full + rp.stage, kStage);
          sm90::tma_load_2d(st, &tm_x, full + rp.stage, kk * kBK, m0);
          sm90::tma_load_2d(st + kBM * kBK, &tm_w, full + rp.stage,
                            kk * kBK, n0);
          rp.advance(p.stages);
        }
      }
    }
  } else {
    // ---- consumers
    sm90::setmaxnreg_inc<224>();
    const int t = threadIdx.x & 127;
    const int lane = t & 31;
    const int r0 = 16 * (t >> 5) + (lane >> 2);
    const int c0 = 2 * (lane & 3);
    const bool has_bias = p.bias != nullptr;
    uint32_t acc[BN / 2];
    sm90::RingPos rp;
#pragma unroll 1
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const int m0 = (tile / p.tiles_n) * kBM;
      const int n0 = (tile % p.tiles_n) * BN;
      const int mw = m0 + 64 * wg;   // this warpgroup's first row
      int prev = -1;
#pragma unroll 1
      for (int kk = 0; kk < p.ksteps; ++kk) {
        sm90::mbar_wait(full + rp.stage, rp.phase);
        const uint8_t* st = ring + rp.stage * kStage;
        const uint64_t da = sm90::make_desc(st + wg * 64 * kBK);
        const uint64_t db = sm90::make_desc(st + kBM * kBK);
        sm90::wgmma_fence();
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          sm90::WgmmaS8<BN>::mma(acc, da + 2 * k, db + 2 * k,
                                 (kk | k) != 0);
        }
        sm90::wgmma_commit();
        if (prev >= 0) {
          sm90::wgmma_wait<1>();
          if (lane == 0) sm90::mbar_arrive(empty + prev);
        }
        prev = rp.stage;
        rp.advance(p.stages);
      }
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      if (lane == 0) sm90::mbar_arrive(empty + prev);

      // epilogue: rows mw + r0 and + 8, columns n0 + 8 i + c0 and + 1
      const int row0 = mw + r0, row1 = row0 + 8;
      const float xs0 = row0 < p.T ? __ldg(p.x_scale + row0) : 0.f;
      const float xs1 = row1 < p.T ? __ldg(p.x_scale + row1) : 0.f;
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        const int col = n0 + 8 * i + c0;
        if (col >= p.N) break;   // N is a multiple of 8: col + 1 < N too
        const float2 ws = __ldg(reinterpret_cast<const float2*>(
            p.w_scale + col));
        const float2 b = has_bias ? __ldg(reinterpret_cast<const float2*>(
                                        p.bias + col))
                                  : make_float2(0.f, 0.f);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = half ? row1 : row0;
          if (row >= p.T) continue;
          const float xs = half ? xs1 : xs0;
          const float v0 = rescale(acc[4 * i + 2 * half], xs, ws.x, b.x,
                                   has_bias);
          const float v1 = rescale(acc[4 * i + 2 * half + 1], xs, ws.y, b.y,
                                   has_bias);
          const long long off = static_cast<long long>(row) * p.N + col;
          if (p.out_bf16) {
            *reinterpret_cast<__nv_bfloat162*>(
                static_cast<__nv_bfloat16*>(p.y) + off) =
                __floats2bfloat162_rn(v0, v1);
          } else {
            *reinterpret_cast<float2*>(static_cast<float*>(p.y) + off) =
                make_float2(v0, v1);
          }
        }
      }
    }
  }
}

template <int BN>
cudaError_t launch(const Params& p, const void* xq, const void* wq, int grid,
                   cudaStream_t s) {
  auto kernel = w8a8_gemm_kernel<BN>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  CUtensorMap mx, mw;
  if (!sm90::encode_s8_2d(&mx, xq, p.T, p.K, kBM) ||
      !sm90::encode_s8_2d(&mw, wq, p.N, p.K, BN)) {
    return cudaErrorInvalidValue;
  }
  const int smem = kFixed + p.stages * (kBM + BN) * kBK;
  kernel<<<grid, kThreads, smem, s>>>(mx, mw, p);
  return cudaGetLastError();
}

}  // namespace

// x (R, K) fp32 (x_bf16 = 0) or bf16 (1), q (R, K) int8, scale (R) fp32;
// K a multiple of 16, x 16-byte aligned
extern "C" int w8a8_quantize_rows(const void* x, int x_bf16, void* q,
                                  void* scale, int R, int K, void* stream) {
  if (R < 1 || K < 16 || K % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (R + kQRows - 1) / kQRows;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    quantize_rows_kernel<__nv_bfloat16><<<blocks, 32 * kQRows, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(q),
        static_cast<float*>(scale), R, K);
  } else {
    quantize_rows_kernel<float><<<blocks, 32 * kQRows, 0, s>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(q),
        static_cast<float*>(scale), R, K);
  }
  return static_cast<int>(cudaGetLastError());
}

// x_q (T, K) int8, w_q (N, K) int8, x_scale (T), w_scale (N), bias (N) or
// null, all fp32; y (T, N) fp32 (y_bf16 = 0) or bf16 (1).  The plan
// (block_n, stages, grid) is ops/quant.py:int8_plan's
extern "C" int w8a8_gemm(const void* x_q, const void* w_q,
                         const void* x_scale, const void* w_scale,
                         const void* bias, void* y, int y_bf16, int T, int K,
                         int N, int block_n, int stages, int grid,
                         void* stream) {
  if (T < 1 || K < 16 || K % 16 || N < 8 || N % 8 || stages < 2 ||
      stages > kMaxStages ||
      kFixed + stages * (kBM + block_n) * kBK > kSmemMax || grid < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.x_scale = static_cast<const float*>(x_scale);
  p.w_scale = static_cast<const float*>(w_scale);
  p.bias = static_cast<const float*>(bias);
  p.y = y;
  p.T = T;
  p.K = K;
  p.N = N;
  p.out_bf16 = y_bf16 != 0;
  p.tiles_n = (N + block_n - 1) / block_n;
  const long long tiles =
      static_cast<long long>((T + kBM - 1) / kBM) * p.tiles_n;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  p.tiles = static_cast<int>(tiles);
  p.ksteps = (K + kBK - 1) / kBK;
  p.stages = stages;
  if (grid > p.tiles) grid = p.tiles;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (block_n) {
    case 128: return static_cast<int>(launch<128>(p, x_q, w_q, grid, s));
    case 192: return static_cast<int>(launch<192>(p, x_q, w_q, grid, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
