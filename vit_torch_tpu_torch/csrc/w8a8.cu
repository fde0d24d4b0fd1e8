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
// - Q1: a team of threads (a power of two, 1 to 512) a row; each thread
//   holds J of the row's 16-value units in registers (two 16-byte loads
//   a bf16 unit, four an fp32 one; J <= 4, at most 128 bytes a thread),
//   unit m + team j for member m, so a team's threads read neighbouring
//   units.  Every load is issued before the first is used, then the
//   absmax over the registers, a butterfly over the team's lanes and,
//   for a team of several warps, their maxima through shared memory; the
//   codes are made from the same registers and leave 16 bytes a thread.
//   The row is read from device memory once.  ops/quant.py:quant_plan
//   picks the team (the fewest threads that hold the row so), blocks of
//   256 threads (several rows a warp where a row is narrow) or of one
//   team, and spreads each row over more threads, up to 512, where the
//   blocks would not give every SM one (few rows, as in the box head).  A
//   row wider than 512 threads hold (K > 32,768 bf16, 16,384 fp32) takes
//   several passes and reads the earlier ones again for their codes.
//   Each code leaves as the low byte of a float (code_bits), four packed
//   into a word by byte permutes, in place of a float-to-int conversion.
//   K a multiple of 16.
//   What holds it back (tools/w8a8_takeout.py --kernel q1 on an H100 80GB
//   HBM3 at 700 W, device ms): its per-value arithmetic, not its loads.
//   At dino_vitb8 @224 bs32's fc2 input (25,120 x 3,072 bf16, bound
//   0.069) it takes 0.081 (85%), and 0.073 without the code stores,
//   0.077 with a multiply for the division, 0.078 without rintf; at K =
//   768 0.023 of 0.017, 0.020 with the multiply.  The division (a
//   reciprocal on the quarter-rate unit, its range check and three FMAs a
//   value) stays: a reciprocal a row with the exact division only near a
//   rounding tie measured no faster (0.080, 0.024).  The first design (a
//   warp a row, eight rows a block, the row read again for its codes)
//   took 0.129 and 0.026; its second read alone was 39% of the former,
//   56% at the box head's (2048, 12,544) input (0.068, now 0.032).
// - Q2: persistent, warp-specialised blocks walking BM x BN output tiles
//   (BM = 128 or 192 rows, 64 a consumer warpgroup; BN = 128 or 192;
//   ops/quant.py:int8_plan picks the tile whose busiest SM reads the
//   fewest operand bytes), tile index column-fastest.  A stage of the
//   mbarrier ring is a k-step of 128: the BM x 128 int8 A tile and the
//   BN x 128 W tile, each a TMA box in the 128-byte swizzle, which for
//   int8 is the bf16 tile's layout byte for byte (sm90.cuh).  The last
//   warpgroup's first thread is the producer; each consumer warpgroup
//   owns 64 rows of the tile and runs wgmma m64nBNk32 s32.s8.s8 (four a
//   stage), releasing a stage once the wgmma that read it has retired.
//   Both operands are K-major, the only form the 8-bit wgmma takes: the
//   port's (N, K) weight is read as it is stored.  The K tail (K a
//   multiple of 16, not of 128) is TMA's zero fill in both operands.
//   Epilogue: each thread loads its two row scales and its share of the
//   tile's column scales and bias at the tile's start, while the first
//   stages land, and puts the latter in shared memory after the products.
//   Each consumer warpgroup rescales its 64 rows 64 bf16 (or 32 fp32)
//   columns at a time into two 8 KB slice buffers in the 128-byte
//   swizzle, used in turn (a buffer is written again once the store two
//   slices back has read it); bf16 slices are written by stmatrix, and one
//   thread sends each slice out with a TMA store, which clips rows past T
//   and columns past N.  The warpgroup goes back to the next tile's
//   products as soon as its last slice is in shared memory; the stores
//   drain while they run.
//   What holds it back (tools/w8a8_takeout.py on an H100 80GB HBM3 at
//   700 W, dino_vitb8 @224 bs32's qkv): the epilogue still runs with no
//   wgmma on the SM, a third of the time (0.079 ms whole, 0.053 without
//   it); the stores themselves cost 0.005 ms, the rescale arithmetic
//   0.006, the staging into the slices the rest.  Overlapping it needs a
//   second set of accumulators: two warpgroups each owning 128 x 128
//   tiles in turn (CUTLASS's ping-pong) ran slower at the dino shapes
//   (more operand bytes a product, an epilogue of four warps), and at
//   128 x 192 spilled; 192-row tiles of three warpgroups, each at 152
//   registers, have no room for one.  A fourth ring stage (one slice
//   buffer a warpgroup) or k-steps of 64 gained nothing; two stages
//   take 30% longer.
//   The first design (128 x BN tiles, each thread storing its accumulator
//   pairs straight to device memory after the products, the column scales
//   read there) spent three quarters of its time in that epilogue.
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

constexpr int kQThreads = 512;   // the most threads a block (and a team)
constexpr int kQUnits = 4;       // the most 16-element units a thread holds

// The code of x as the low byte of a float's bits: n = clamp(rint(x /
// scale), -127, 127) is an integer (a NaN quotient clamps to -127), so
// n + 1.5 * 2^23 is exact, an integer in [2^23, 2^24) whose bits are
// 0x4B400000 + n, and its low byte is n as an int8.  This takes the
// place of a float-to-int conversion on the quarter-rate unit.
__device__ __forceinline__ uint32_t code_bits(float x, float scale) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(x, scale)), -127.f), 127.f);
  return __float_as_uint(__fadd_rn(q, 12582912.f));
}

// element e (< 16) of a unit held as 32-bit words: bf16 pairs, widened
// exactly (a bf16 is the high half of its fp32), or fp32 words
template <typename T>
__device__ __forceinline__ float element(const uint32_t (&w)[4 * sizeof(T)],
                                         int e) {
  if constexpr (sizeof(T) == 2) {
    const uint32_t v = w[e >> 1];
    return __uint_as_float((e & 1) ? (v & 0xffff0000u) : (v << 16));
  } else {
    return __uint_as_float(w[e]);
  }
}

// pass p's J units of a row into registers: unit member + team (j + J p),
// so a team's threads read neighbouring units; units past the row (and
// rows past R) read as zeros.  Every load is issued before any is used.
template <typename T, int J>
__device__ __forceinline__ void load_units(uint32_t (&w)[J][4 * sizeof(T)],
                                           const uint4* src, int first,
                                           int team, int units, bool live) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int u = first + team * j;
    const bool in = live && u < units;
#pragma unroll
    for (int i = 0; i < static_cast<int>(sizeof(T)); ++i) {
      const uint4 v =
          in ? __ldg(src + sizeof(T) * u + i) : make_uint4(0, 0, 0, 0);
      w[j][4 * i] = v.x;
      w[j][4 * i + 1] = v.y;
      w[j][4 * i + 2] = v.z;
      w[j][4 * i + 3] = v.w;
    }
  }
}

// the codes of the J units held, 16 bytes a unit
template <typename T, int J>
__device__ __forceinline__ void store_codes(uint32_t (&w)[J][4 * sizeof(T)],
                                            uint4* dst, float s, int first,
                                            int team, int units, bool live) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int u = first + team * j;
    if (!live || u >= units) continue;
    uint32_t out[4];   // four codes a word, one word at a time
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t lo =
          __byte_perm(code_bits(element<T>(w[j], 4 * k), s),
                      code_bits(element<T>(w[j], 4 * k + 1), s), 0x0040);
      const uint32_t hi =
          __byte_perm(code_bits(element<T>(w[j], 4 * k + 2), s),
                      code_bits(element<T>(w[j], 4 * k + 3), s), 0x0040);
      out[k] = __byte_perm(lo, hi, 0x5410);
    }
    dst[u] = make_uint4(out[0], out[1], out[2], out[3]);
  }
}

// A team of `team` threads (a power of two) a row, blockDim.x / team rows
// a block; each thread holds J units of its row a pass (`passes` > 1 only
// where the row is wider than a team holds, and then the earlier passes
// are read again for their codes).
template <typename T, int J>
__global__ void __launch_bounds__(kQThreads)
    quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                         float* __restrict__ scale, int R, int K, int team,
                         int passes) {
  __shared__ float warp_max[kQThreads / 32];
  const int member = threadIdx.x & (team - 1);
  const long long r = static_cast<long long>(blockIdx.x) * (blockDim.x / team) +
                      threadIdx.x / team;
  const bool live = r < R;
  const int units = K >> 4;
  const long long row = (live ? r : 0) * static_cast<long long>(K);
  const uint4* src = reinterpret_cast<const uint4*>(x + row);
  uint4* dst = reinterpret_cast<uint4*>(q + row);
  uint32_t w[J][4 * sizeof(T)];
  float amax = 0.f;
  for (int p = 0; p < passes; ++p) {
    load_units<T, J>(w, src, member + team * J * p, team, units, live);
#pragma unroll
    for (int j = 0; j < J; ++j) {
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        amax = fmaxf(amax, fabsf(element<T>(w[j], e)));
      }
    }
  }
  // the team's absmax: a butterfly inside the warp, then across its warps
  for (int off = (team < 32 ? team : 32) >> 1; off > 0; off >>= 1) {
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  }
  if (team > 32) {
    if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = amax;
    __syncthreads();
    const int w0 = (threadIdx.x & ~(team - 1)) >> 5;
    for (int i = 0; i < team >> 5; ++i) amax = fmaxf(amax, warp_max[w0 + i]);
  }
  const float s = __fadd_rn(__fdiv_rn(amax, 127.f), 1e-8f);
  if (live && member == 0) scale[r] = s;
  store_codes<T, J>(w, dst, s, member + team * J * (passes - 1), team, units,
                    live);
  for (int p = 0; p + 1 < passes; ++p) {
    load_units<T, J>(w, src, member + team * J * p, team, units, live);
    store_codes<T, J>(w, dst, s, member + team * J * p, team, units, live);
  }
}

template <typename T>
cudaError_t launch_rows(const void* x, void* q, void* scale, int R, int K,
                        int team, int units, int passes, int threads,
                        int grid, cudaStream_t s) {
  auto run = [&](auto kernel) {
    kernel<<<grid, threads, 0, s>>>(static_cast<const T*>(x),
                                    static_cast<int8_t*>(q),
                                    static_cast<float*>(scale), R, K, team,
                                    passes);
  };
  switch (units) {
    case 1: run(quantize_rows_kernel<T, 1>); break;
    case 2: run(quantize_rows_kernel<T, 2>); break;
    case 3: run(quantize_rows_kernel<T, 3>); break;
    default: run(quantize_rows_kernel<T, 4>); break;
  }
  return cudaGetLastError();
}

// ---- Q2 ------------------------------------------------------------------

constexpr int kBK = 128;           // int8 of K a stage (128-byte rows)
constexpr int kSmemMax = 232448;   // 227 KB a block may use
constexpr int kMaxStages = 8;
constexpr int kSlice = 64 * 128;   // a 64 x 64 bf16 or 64 x 32 fp32 slice
constexpr int kFixed = 1024 + 2 * kMaxStages * 8;   // alignment, barriers

// a block: a consumer warpgroup for every 64 rows of a tile, and the
// producer's
constexpr int threads(int bm) { return 128 * (bm / 64 + 1); }

// dynamic shared bytes of a block: the ring, then per consumer warpgroup
// two output slices and the tile's column scales and bias (fp32)
constexpr int smem_bytes(int bm, int bn, int stages) {
  return kFixed + (bm / 64) * (2 * kSlice + 8 * bn) + stages * (bm + bn) * kBK;
}

struct Params {
  const float* x_scale;   // (T)
  const float* w_scale;   // (N)
  const float* bias;      // (N) or null
  int T, K, N;
  int tiles_n, tiles, ksteps, stages;
};

__device__ __forceinline__ float rescale(uint32_t acc, float xs, float ws,
                                         float b, bool has_bias) {
  const float y = __fmul_rn(__fmul_rn(__int2float_rn(static_cast<int>(acc)),
                                      xs), ws);
  return has_bias ? __fadd_rn(y, b) : y;
}

// Slice c of a consumer warpgroup's 64 x BN accumulator, rescaled into a
// 128-byte-swizzled slice buffer: 64 bf16 or 32 fp32 columns.  The thread
// holds rows r0 and r0 + 8 (row scales xs0, xs1) and, in each group i of 8
// columns, columns 8 i + c0 and + 1 (wgmma's accumulator layout: per
// group, an 8 x 8 matrix in each row half, the mma fragment of each).
// wsb holds the tile's column scales and bias as float4s {w_scale[j],
// w_scale[j + 1], bias[j], bias[j + 1]} per even column j.  bf16 leaves by
// stmatrix, four 8 x 8 matrices (two groups, both row halves) a warp
// instruction, each row at its swizzled 16 bytes; fp32 by 8-byte stores.
template <int BN, typename OutT>
__device__ __forceinline__ void stage_slice(int c, uint8_t* slice,
                                            const uint32_t (&acc)[BN / 2],
                                            const float* wsb, float xs0,
                                            float xs1, bool has_bias, int t) {
  constexpr bool kBf16 = sizeof(OutT) == 2;
  constexpr int kGroups = (kBf16 ? 64 : 32) / 8;   // column groups a slice
  const int lane = t & 31;
  const int r0 = 16 * (t >> 5) + (lane >> 2);
  const int c0 = 2 * (lane & 3);
  if constexpr (kBf16) {
    // lane l addresses row l % 8 of matrix l / 8: row half (l / 8) % 2,
    // group g + l / 16
    const int m = lane >> 3, rr = lane & 7;
    uint8_t* row = slice + (16 * (t >> 5) + 8 * (m & 1) + rr) * 128;
#pragma unroll
    for (int g = 0; g < kGroups; g += 2) {
      uint32_t r[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {   // matrix q: group g + q / 2, half q % 2
        const int i = c * kGroups + g + q / 2, half = q % 2;
        const float4 sb =
            *reinterpret_cast<const float4*>(wsb + 16 * i + 2 * c0);
        const float xs = half ? xs1 : xs0;
        const __nv_bfloat162 h = __floats2bfloat162_rn(
            rescale(acc[4 * i + 2 * half], xs, sb.x, sb.z, has_bias),
            rescale(acc[4 * i + 2 * half + 1], xs, sb.y, sb.w, has_bias));
        r[q] = *reinterpret_cast<const uint32_t*>(&h);
      }
      sm90::stmatrix_x4(row + (((g + (m >> 1)) ^ rr) << 4), r);
    }
  } else {
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int i = c * kGroups + g;
      const float4 sb =
          *reinterpret_cast<const float4*>(wsb + 16 * i + 2 * c0);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float xs = half ? xs1 : xs0;
        *reinterpret_cast<float2*>(
            slice + sm90::swizzle128(r0 + 8 * half, 2 * (8 * g + c0))) =
            make_float2(
                rescale(acc[4 * i + 2 * half], xs, sb.x, sb.z, has_bias),
                rescale(acc[4 * i + 2 * half + 1], xs, sb.y, sb.w,
                        has_bias));
      }
    }
  }
}

template <int BM, int BN, typename OutT>
__global__ void __launch_bounds__(128 * (BM / 64 + 1), 1)
    w8a8_gemm_kernel(const __grid_constant__ CUtensorMap tm_x,
                     const __grid_constant__ CUtensorMap tm_w,
                     const __grid_constant__ CUtensorMap tm_y,
                     const Params p) {
  constexpr int kWGs = BM / 64;              // consumer warpgroups
  constexpr int kStage = (BM + BN) * kBK;    // A + W tiles of a k-step
  constexpr int kCols = sizeof(OutT) == 2 ? 64 : 32;   // columns a slice
  constexpr int kLoads = 2 * BN / 128;       // column values a thread loads
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = sm90::align1024(smem_raw);
  uint8_t* slices = ring + p.stages * kStage;
  float* scales = reinterpret_cast<float*>(slices + kWGs * 2 * kSlice);
  uint64_t* full = reinterpret_cast<uint64_t*>(scales + kWGs * 2 * BN);
  uint64_t* empty = full + kMaxStages;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      sm90::mbar_init(full + s, 1);
      sm90::mbar_init(empty + s, 4 * kWGs);   // one arrival a consumer warp
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == kWGs) {
    // ---- producer
    sm90::setmaxnreg_dec<kWGs == 2 ? 56 : 40>();
    if (threadIdx.x == 128 * kWGs) {
      sm90::tma_prefetch_desc(&tm_x);
      sm90::tma_prefetch_desc(&tm_w);
      sm90::RingPos rp;
#pragma unroll 1
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        const int m0 = (tile / p.tiles_n) * BM;
        const int n0 = (tile % p.tiles_n) * BN;
#pragma unroll 1
        for (int kk = 0; kk < p.ksteps; ++kk) {
          sm90::mbar_wait(empty + rp.stage, rp.phase ^ 1);
          uint8_t* st = ring + rp.stage * kStage;
          sm90::mbar_arrive_expect_tx(full + rp.stage, kStage);
          sm90::tma_load_2d(st, &tm_x, full + rp.stage, kk * kBK, m0);
          sm90::tma_load_2d(st + BM * kBK, &tm_w, full + rp.stage,
                            kk * kBK, n0);
          rp.advance(p.stages);
        }
      }
    }
  } else {
    // ---- consumers
    sm90::setmaxnreg_inc<kWGs == 2 ? 224 : 152>();
    const int t = threadIdx.x & 127;
    const int lane = t & 31;
    const int r0 = 16 * (t >> 5) + (lane >> 2);   // the thread's first row
    const bool has_bias = p.bias != nullptr;
    uint8_t* own = slices + wg * 2 * kSlice;   // two slices, used in turn
    float* wsb = scales + wg * 2 * BN;         // see stage_slice
    int sc = 0;                                // slices written
    uint32_t acc[BN / 2];
    sm90::RingPos rp;
#pragma unroll 1
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const int m0 = (tile / p.tiles_n) * BM;
      const int n0 = (tile % p.tiles_n) * BN;
      const int mw = m0 + 64 * wg;   // this warpgroup's first row
      // the tile's scales and bias, loaded while the products run: the
      // thread's two row scales, and values t + 128 u of (w_scale, bias)
      // over the tile's columns, which reach shared memory after the
      // products
      const int row0 = mw + r0, row1 = row0 + 8;
      const float xs0 = row0 < p.T ? __ldg(p.x_scale + row0) : 0.f;
      const float xs1 = row1 < p.T ? __ldg(p.x_scale + row1) : 0.f;
      float cv[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int j = t + 128 * u;
        const int col = n0 + (j < BN ? j : j - BN);
        cv[u] = col >= p.N                ? 0.f
                : j < BN                  ? __ldg(p.w_scale + col)
                : has_bias                ? __ldg(p.bias + col)
                                          : 0.f;
      }
      int prev = -1;
#pragma unroll 1
      for (int kk = 0; kk < p.ksteps; ++kk) {
        sm90::mbar_wait(full + rp.stage, rp.phase);
        const uint8_t* st = ring + rp.stage * kStage;
        const uint64_t da = sm90::make_desc(st + wg * 64 * kBK);
        const uint64_t db = sm90::make_desc(st + BM * kBK);
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

      // epilogue: every thread of the warpgroup finished reading the last
      // tile's scales before the last named barrier, so they are replaced
      // now and read after the next one
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int j = t + 128 * u;
        const int col = j < BN ? j : j - BN;
        wsb[4 * (col >> 1) + 2 * (j >= BN) + (col & 1)] = cv[u];
      }
#pragma unroll
      for (int c = 0; c < BN / kCols; ++c) {
        const int nc = n0 + kCols * c;
        if (nc >= p.N) break;
        uint8_t* slice = own + (sc++ & 1) * kSlice;
        // the store two slices back has read this buffer
        if (t == 0) sm90::bulk_wait_read<1>();
        sm90::named_barrier(1 + wg, 128);
        stage_slice<BN, OutT>(c, slice, acc, wsb, xs0, xs1, has_bias, t);
        sm90::fence_proxy_async();   // st.shared -> the store's reads
        sm90::named_barrier(1 + wg, 128);
        // TMA clips rows past T and columns past N
        if (t == 0 && mw < p.T) {
          sm90::tma_store_2d(&tm_y, slice, nc, mw);
          sm90::bulk_commit();
        }
      }
    }
    if (t == 0) sm90::bulk_wait<0>();
  }
}

template <int BM, int BN, typename OutT>
cudaError_t launch(const Params& p, const void* xq, const void* wq, void* y,
                   int grid, cudaStream_t s) {
  auto kernel = w8a8_gemm_kernel<BM, BN, OutT>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  CUtensorMap mx, mw, my;
  const bool y_ok = sizeof(OutT) == 2
                        ? sm90::encode_bf16_2d(&my, y, p.T, p.N, 64)
                        : sm90::encode_f32_2d(&my, y, p.T, p.N, 64);
  if (!sm90::encode_s8_2d(&mx, xq, p.T, p.K, BM) ||
      !sm90::encode_s8_2d(&mw, wq, p.N, p.K, BN) || !y_ok) {
    return cudaErrorInvalidValue;
  }
  kernel<<<grid, threads(BM), smem_bytes(BM, BN, p.stages), s>>>(mx, mw, my,
                                                                 p);
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t launch_tile(const Params& p, const void* xq, const void* wq,
                        void* y, int block_m, int block_n, int grid,
                        cudaStream_t s) {
  if (block_m == 128 && block_n == 128) {
    return launch<128, 128, OutT>(p, xq, wq, y, grid, s);
  }
  if (block_m == 128 && block_n == 192) {
    return launch<128, 192, OutT>(p, xq, wq, y, grid, s);
  }
  if (block_m == 192 && block_n == 128) {
    return launch<192, 128, OutT>(p, xq, wq, y, grid, s);
  }
  return launch<192, 192, OutT>(p, xq, wq, y, grid, s);
}

}  // namespace

// x (R, K) fp32 (x_bf16 = 0) or bf16 (1), q (R, K) int8, scale (R) fp32;
// K a multiple of 16, x and q 16-byte aligned.  The plan (team, units,
// passes, threads, grid) is ops/quant.py:quant_plan's: `team` threads a
// row holding `units` 16-element units each a pass, `threads` a block
// (threads / team rows)
extern "C" int w8a8_quantize_rows(const void* x, int x_bf16, void* q,
                                  void* scale, int R, int K, void* stream,
                                  int team, int units, int passes,
                                  int threads, int grid) {
  const auto pow2 = [](int v) { return v > 0 && (v & (v - 1)) == 0; };
  if (R < 1 || K < 16 || K % 16 || !pow2(team) || team > kQThreads ||
      !pow2(threads) || threads < 32 || threads > kQThreads ||
      threads < team || units < 1 || units > kQUnits || passes < 1 ||
      static_cast<long long>(team) * units * passes < K / 16 || grid < 1 ||
      static_cast<long long>(grid) * (threads / team) < R) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      x_bf16 ? launch_rows<__nv_bfloat16>(x, q, scale, R, K, team, units,
                                          passes, threads, grid, s)
             : launch_rows<float>(x, q, scale, R, K, team, units, passes,
                                  threads, grid, s));
}

// x_q (T, K) int8, w_q (N, K) int8, x_scale (T), w_scale (N), bias (N) or
// null, all fp32; y (T, N) fp32 (y_bf16 = 0) or bf16 (1), 16-byte
// aligned.  The plan (block_m, block_n, stages, grid) is
// ops/quant.py:int8_plan's
extern "C" int w8a8_gemm(const void* x_q, const void* w_q,
                         const void* x_scale, const void* w_scale,
                         const void* bias, void* y, int y_bf16, int T, int K,
                         int N, int block_m, int block_n, int stages,
                         int grid, void* stream) {
  if (T < 1 || K < 16 || K % 16 || N < 8 || N % 8 || stages < 2 ||
      stages > kMaxStages || (block_m != 128 && block_m != 192) ||
      (block_n != 128 && block_n != 192) ||
      smem_bytes(block_m, block_n, stages) > kSmemMax || grid < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.x_scale = static_cast<const float*>(x_scale);
  p.w_scale = static_cast<const float*>(w_scale);
  p.bias = static_cast<const float*>(bias);
  p.T = T;
  p.K = K;
  p.N = N;
  p.tiles_n = (N + block_n - 1) / block_n;
  const long long tiles =
      static_cast<long long>((T + block_m - 1) / block_m) * p.tiles_n;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  p.tiles = static_cast<int>(tiles);
  p.ksteps = (K + kBK - 1) / kBK;
  p.stages = stages;
  if (grid > p.tiles) grid = p.tiles;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      y_bf16 ? launch_tile<__nv_bfloat16>(p, x_q, w_q, y, block_m, block_n,
                                          grid, s)
             : launch_tile<float>(p, x_q, w_q, y, block_m, block_n, grid,
                                  s));
}
