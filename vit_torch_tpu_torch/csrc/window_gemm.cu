// The matrix products and LayerNorms of the Swin block kernels for Hopper
// (sm_90a):
//   Y = epilogue(X W^T + b),  bf16 in / bf16 out, fp32 accumulation, and
//   Y = bf16(LayerNorm(X)) over rows, fp32 statistics.
//
// Together with window_attention_fwd.cu (the attention core) this replaces
// the products that the Pallas TPU kernels of
// vit_torch_tpu/ops/window_block.py computed in their bodies:
// _fwd_kernel (def :200, pallas_call :247; window_block, "B7"),
// _fwd_kernel_spatial (:404 / :496; window_block_spatial, "B8") and
// _fwd_kernel_spatial_full (:710 / :806; window_block_full_spatial, "B9"):
//   B7 = qkv product -> core -> proj product, over windows already cut,
//   B8 = the same over a map, the window partition in the products' rows,
//   B9 = LN1 -> qkv product -> core -> proj product + residual
//        -> LN2 -> fc1 product + GELU -> fc2 product + residual.
// The TPU kernels held the weights in VMEM; B9's 12 C^2 weights do not fit
// in an SM's shared memory, so on Hopper each block is this short chain of
// launches, each keeping the TPU kernel's rounding points.
//
// Product options, chosen per launch:
// - window addressing.  Row r of the window-major order lives at map row
//   (r / hw) hw + rows[r mod hw], rows the per-image table that the host
//   builds per geometry (ops/gemm.py:window_rows: window (wy, wx), token
//   j -> map position (wy w + j / w + s) mod H, (wx w + j mod w + s) mod W,
//   the cyclic shift s of a shifted block folded in: roll by -s before the
//   block and by +s after computes the same function).  A gathered A reads
//   its rows there and a scattered Y (with its residual) writes them there:
//   the window partition and reverse of the TPU band kernels.
// - epilogues (fp32 accumulator acc, bf16 bias b, bf16 residual res):
//   0: bf16(acc + b)                                   (qkv; B7/B8's proj)
//   1: bf16(bf16(acc + b) + res)                        (B9's proj)
//   2: bf16(gelu(bf16(bf16(acc) + b))), erf GELU        (fc1)
//   3: bf16(res + bf16(bf16(acc) + b))                  (fc2)
//
// Bound on an H100 (989 TFLOP/s dense bf16, 3.35 TB/s): 2 T K N operations
// against A, W and Y (and res) once.  At swin_base_384 bs32 stage 1
// (T = 294,912, C = 128) every product is bound by bytes (the four move
// 1.36 GB, 0.41 ms); from stage 2 on, by operations (116 GFLOP a block at
// every stage, 0.117 ms).  The products of stages 3-4 want the tensor
// cores busy; stage 1 wants the gathered rows read once and every byte
// moved by wide, coalesced copies.
//
// Design: persistent, warp-specialised blocks of 384 threads (the shape of
// attn_block.cu's qkv product).  Each block walks 128 x BN output tiles
// (BN = 128 or 192: ops/gemm.py:gemm_plan picks the width that leaves the
// busiest SM the fewest columns for N, so that 96-, 288- and 1024-wide
// outputs all take a tile set with little padding; a tile's columns past
// N read zero weights and are not written), tile index column-fastest so
// that the blocks sharing a row tile run together and read its A from L2.
// A stage of the mbarrier ring is a k-step of 64: the 128 x 64 A tile and
// the BN x 64 W tile in the 128-byte swizzle.
// - Warpgroup 2 is the producer (setmaxnreg 56).  W always comes by TMA
//   (cached tensor map); so does a plain A (fc1, fc2, B7's rows).  The K
//   tail (K = 96: the second k-step is half past the edge) is TMA's zero
//   fill in both A and W, which adds nothing to the product.
// - A gathered A (B8/B9's qkv) is not one TMA box: a window's 144 rows are
//   12 runs of 12 map rows, any run may be cut by the shift's wrap, and a
//   run of 12 rows does not start on the swizzle's 8-row phase (a box must
//   land 1024-byte aligned).  So the producer's 128 threads gather it with
//   16-byte cp.async copies, each thread 8 rows of one 16-byte chunk (a
//   warp moves 4 whole 128-byte rows an instruction), into the 128-byte
//   swizzle's offsets, zero-filled past T and past K, and each signals the
//   stage's mbarrier with cp.async.mbarrier.arrive.noinc (128 arrivals and
//   W's expect_tx arrival complete a stage).  cp.async writes in the
//   generic proxy, so the consumers fence.proxy.async before their wgmma.
// - Warpgroups 0 and 1 (setmaxnreg 224) own 64 rows each: wgmma
//   m64nBNk16 from shared memory into BN / 2 fp32 registers a thread, a
//   stage released once the wgmma that read it has retired.
// - The epilogue runs 64 columns at a time through two 64 x 64 bf16 slice
//   buffers a warpgroup, used in turn, in the 128-byte swizzle, one branch
//   on the epilogue a slice (stage_slice); each thread's bias pairs and
//   copy-out rows are read at the tile's start, while the products run.
//   Plain rows without a residual (qkv of B7, fc1, B7's proj) leave by TMA
//   stores (a buffer is written again once the store two slices back has
//   read it); scattered rows (proj of B8/B9) and residual rows (B9's proj,
//   fc2) are copied out 16 bytes a thread at their map rows, the residual
//   read there 16 bytes at a time (its lines prefetched into L2 at the
//   tile's start, its four chunks loaded at once) and added in fp32 (a
//   warp writes 4 whole 128-byte rows an instruction).  Meanwhile the
//   producer fills the next tile's stages.  GELU evaluates the Pallas
//   kernel's own erf polynomial (window_block.py:_gelu_f32 takes
//   fused_mlp._erf; sm90::gelu_erf), whose rcp and exp2 run on the SFU,
//   where erff's longer evaluation made fc1's epilogue outlast its
//   products.
// - Shared memory: 1 KB of alignment, stages of (128 + BN) x 128 bytes
//   (4 at BN = 192, 6 at 128), four 8 KB output slices, the barriers.
// What holds it back, from development builds on an H100 80GB HBM3 at
// 700 W with parts of the work taken out: not the tensor cores (without
// its wgmmas a product took as long), but the epilogue (without it, a
// quarter to three quarters less time; fc1's GELU most) and the loads.
// Tiles of 256 columns, and each consumer warpgroup taking whole tiles of
// its own so that one's epilogue overlaps the other's products (CUTLASS's
// ping-pong), ran no faster and were taken out.
//
// This replaces the port's first design: 128 x 128 tiles of 8 warps on
// mma.sync.m16n8k16 with ldmatrix fragments and a 3-stage cp.async ring,
// about 190 TFLOP/s at stages 3-4 on an H100 80GB HBM3 at 700 W, against
// cuBLAS's ~532 for the same product (chip_smoke).
//
// LayerNorm (the TPU kernels' _ln_rows_f32, flax's fast variance): one
// warp per row, fp32 sum and sum of squares over 16-byte loads, mean and
// var = max(E[x^2] - mean^2, 0), then
// bf16((x - mean) * (rsqrt(var + eps) * w[k]) + b[k]) with fp32 w, b.  It
// writes the normalised map once (the products then read it like any
// input) rather than normalising inside every column tile of the product;
// it is bound by bytes and keeps its first design.
//
// C entry points (ctypes): window_gemm_bf16(...) and
// window_layer_norm_bf16(...) return the cudaError_t of the launch; they
// launch on the given stream and do not synchronise or allocate.  A width,
// plan or option that the kernel does not take is refused with
// cudaErrorInvalidValue before any launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kThreads = 384;        // 2 consumer warpgroups + producer
constexpr int kBM = 128;             // rows a tile: 64 a consumer warpgroup
constexpr int kSmemMax = 232448;     // 227 KB a block may use
constexpr int kMaxStages = 8;
constexpr int kSlice = 64 * 128;     // a 64 x 64 bf16 output slice
// 1 KB of alignment, two slices a consumer warpgroup, the barriers
constexpr int kFixed = 1024 + 4 * kSlice + 2 * kMaxStages * 8;

enum Epilogue { kBias = 0, kBiasRes = 1, kGelu = 2, kBias16Res = 3 };

struct Params {
  const __nv_bfloat16* x;     // A rows, K columns (gathered: the map)
  const __nv_bfloat16* bias;  // (Nout) or null
  const __nv_bfloat16* res;   // residual, addressed as Y, or null
  __nv_bfloat16* y;           // rows of Nout
  const int* rows;            // per-image window-major -> map row, or null
  int T, K, Nout, hw;
  int gather, scatter, epi;
  int tiles_n, tiles, ksteps, stages;
};

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// row r of the window-major order -> its row of the (B, H, W) map
__device__ __forceinline__ int map_row(int r, const Params& p) {
  const int b = r / p.hw;
  return b * p.hw + p.rows[r - b * p.hw];
}

// the value an epilogue stages in bf16 before the residual (if any) is
// added: 0 and 1 bf16(acc + b); 2 bf16(gelu(bf16(bf16(acc) + b)));
// 3 bf16(bf16(acc) + b)
template <int EPI>
__device__ __forceinline__ float staged(float acc, float b) {
  if (EPI == kGelu) return sm90::gelu_erf(bf16r(bf16r(acc) + b));
  if (EPI == kBias16Res) return bf16r(acc) + b;
  return acc + b;
}

// The staged bf16 values of 64-column slice c of a warpgroup's 64 x BN
// accumulator (thread t's rows r0 and r0 + 8, columns 8 i + c0 and + 1)
// into a 64 x 64 slice in the 128-byte swizzle; bias2 holds the thread's
// bias pairs of the tile, one 32-bit bf16 pair per 8 columns.  Called
// with c a constant of an unrolled loop, so that acc stays in registers.
template <int EPI, int NA>
__device__ __forceinline__ void stage_slice(int c, uint8_t* slice,
                                            const float (&acc)[NA],
                                            const uint32_t (&bias2)[NA / 4],
                                            int r0, int c0) {
#pragma unroll
  for (int i = 8 * c; i < 8 * c + 8; ++i) {
    const __nv_bfloat162 bb = *reinterpret_cast<const __nv_bfloat162*>(
        &bias2[i]);
    const float b0 = __low2float(bb), b1 = __high2float(bb);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      *reinterpret_cast<__nv_bfloat162*>(
          slice + sm90::swizzle128(r0 + 8 * half, 8 * (i & 7) + c0)) =
          __floats2bfloat162_rn(staged<EPI>(acc[4 * i + 2 * half], b0),
                                staged<EPI>(acc[4 * i + 2 * half + 1], b1));
    }
  }
}

template <int NA>
__device__ __forceinline__ void stage_slice(int epi, int c, uint8_t* slice,
                                            const float (&acc)[NA],
                                            const uint32_t (&bias2)[NA / 4],
                                            int r0, int c0) {
  switch (epi) {   // one branch a slice, not one an element
    case kGelu: stage_slice<kGelu>(c, slice, acc, bias2, r0, c0); break;
    case kBias16Res:
      stage_slice<kBias16Res>(c, slice, acc, bias2, r0, c0);
      break;
    default: stage_slice<kBias>(c, slice, acc, bias2, r0, c0); break;
  }
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
    window_gemm_kernel(const __grid_constant__ CUtensorMap tm_x,
                       const __grid_constant__ CUtensorMap tm_w,
                       const __grid_constant__ CUtensorMap tm_y,
                       const Params p) {
  constexpr int kStage = (kBM + BN) * 128;   // A + W tiles of a k-step
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = sm90::align1024(smem_raw);
  uint8_t* otile = ring + p.stages * kStage;
  uint64_t* full = reinterpret_cast<uint64_t*>(otile + 4 * kSlice);
  uint64_t* empty = full + kMaxStages;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      // a gathered stage completes on its 128 gathering threads' cp.async
      // arrivals and the W tile's expect_tx arrival
      sm90::mbar_init(full + s, p.gather ? 129 : 1);
      sm90::mbar_init(empty + s, 8);   // one arrival per consumer warp
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == 2) {
    // ---- producer
    sm90::setmaxnreg_dec<56>();
    const int pt = threadIdx.x - 256;
    if (p.gather) {
      const int chunk = pt & 7;   // this thread's 16-byte chunk of a row
      const int sub = pt >> 3;    // and its rows: sub + 16 u of the tile
      if (pt == 0) sm90::tma_prefetch_desc(&tm_w);
      sm90::RingPos rp;
#pragma unroll 1
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        const int m0 = (tile / p.tiles_n) * kBM;
        const int n0 = (tile % p.tiles_n) * BN;
        int src[8];   // map rows, -1 past T
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int r = m0 + sub + 16 * u;
          src[u] = r < p.T ? map_row(r, p) : -1;
        }
#pragma unroll 1
        for (int kk = 0; kk < p.ksteps; ++kk) {
          sm90::mbar_wait(empty + rp.stage, rp.phase ^ 1);
          uint8_t* st = ring + rp.stage * kStage;
          if (pt == 0) {
            sm90::mbar_arrive_expect_tx(full + rp.stage, BN * 128);
            sm90::tma_load_2d(st + kBM * 128, &tm_w, full + rp.stage,
                              kk * 64, n0);
          }
          const int col = kk * 64 + chunk * 8;
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const bool ok = src[u] >= 0 && col < p.K;
            sm90::cp_async16(
                st + sm90::swizzle128(sub + 16 * u, chunk * 8),
                p.x + (ok ? static_cast<long long>(src[u]) * p.K + col : 0),
                ok);
          }
          sm90::cp_async_mbar_arrive(full + rp.stage);
          rp.advance(p.stages);
        }
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");
    } else if (pt == 0) {
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
          sm90::tma_load_2d(st, &tm_x, full + rp.stage, kk * 64, m0);
          sm90::tma_load_2d(st + kBM * 128, &tm_w, full + rp.stage, kk * 64,
                            n0);
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
    // plain rows without a residual leave by TMA stores; the others are
    // copied out by the threads, 16 bytes each: rows (t / 8) + 16 u of the
    // warpgroup's 64, chunk t % 8.  Two slice buffers a warpgroup, used in
    // turn (sc counts the slices written)
    const bool via_tma = !p.scatter && p.res == nullptr;
    const int oc = 8 * (t & 7);
    uint8_t* slices = otile + wg * 2 * kSlice;
    int sc = 0;
    float acc[BN / 2];
    sm90::RingPos rp;
#pragma unroll 1
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const int m0 = (tile / p.tiles_n) * kBM;
      const int n0 = (tile % p.tiles_n) * BN;
      const int mw = m0 + 64 * wg;   // this warpgroup's first row
      // the thread's bias pairs of the tile, loaded while the products run
      uint32_t bias2[BN / 8];
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        const int col = n0 + 8 * i + c0;
        bias2[i] = p.bias != nullptr && col < p.Nout
                       ? __ldg(reinterpret_cast<const unsigned int*>(
                             p.bias + col))
                       : 0u;
      }
      long long dst[4];   // element offsets of the copy-out rows
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int r = mw + (t >> 3) + 16 * u;
        dst[u] = r < p.T ? static_cast<long long>(
                               p.scatter ? map_row(r, p) : r) * p.Nout
                         : -1;
        // the residual's lines (both ends of a 128-byte slice row) into L2
        // while the products run, so that the copy-out does not wait on
        // device memory
        if (p.res != nullptr && dst[u] >= 0 && (oc == 0 || oc == 56)) {
#pragma unroll
          for (int c = 0; c < BN / 64; ++c) {
            if (n0 + 64 * c + oc < p.Nout) {
              asm volatile("prefetch.global.L2 [%0];\n" ::"l"(
                  p.res + dst[u] + n0 + 64 * c + oc));
            }
          }
        }
      }
      int prev = -1;
#pragma unroll 1
      for (int kk = 0; kk < p.ksteps; ++kk) {
        sm90::mbar_wait(full + rp.stage, rp.phase);
        if (p.gather) sm90::fence_proxy_async();   // cp.async -> wgmma
        const uint8_t* st = ring + rp.stage * kStage;
        const uint64_t da = sm90::make_desc(st + wg * 64 * 128);
        const uint64_t db = sm90::make_desc(st + kBM * 128);
        sm90::wgmma_fence();
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          sm90::Wgmma<BN>::mma(acc, da + 2 * k, db + 2 * k, (kk | k) != 0);
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

#pragma unroll
      for (int c = 0; c < BN / 64; ++c) {
        const int nc = n0 + 64 * c;
        if (nc >= p.Nout) break;
        uint8_t* slice = slices + (sc++ & 1) * kSlice;
        // the residual's chunks first: all four loads in flight at once
        // (y may alias res as far as the compiler knows, so loads left
        // in the copy-out loop would each wait for the store before)
        uint4 rv[4];
        if (p.res != nullptr && nc + oc < p.Nout) {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (dst[u] >= 0) {
              rv[u] = __ldg(reinterpret_cast<const uint4*>(
                  p.res + dst[u] + nc + oc));
            }
          }
        }
        if (via_tma) {   // the store two slices back has read the buffer
          if (t == 0) sm90::bulk_wait_read<1>();
          sm90::named_barrier(1 + wg, 128);
        }   // (copied out: every thread read it before the last barrier)
        stage_slice(p.epi, c, slice, acc, bias2, r0, c0);
        if (via_tma) {
          sm90::fence_proxy_async();   // st.shared -> the store's reads
          sm90::named_barrier(1 + wg, 128);
          if (t == 0 && mw < p.T) {
            sm90::tma_store_2d(&tm_y, slice, nc, mw);
            sm90::bulk_commit();
          }
          continue;
        }
        sm90::named_barrier(1 + wg, 128);
        if (nc + oc >= p.Nout) continue;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (dst[u] < 0) continue;
          uint4 v = *reinterpret_cast<const uint4*>(
              slice + sm90::swizzle128((t >> 3) + 16 * u, oc));
          if (p.res != nullptr) {   // bf16(staged + res), in fp32
            __nv_bfloat162* a = reinterpret_cast<__nv_bfloat162*>(&v);
            const __nv_bfloat162* r =
                reinterpret_cast<const __nv_bfloat162*>(&rv[u]);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              a[e] = __floats2bfloat162_rn(
                  __low2float(a[e]) + __low2float(r[e]),
                  __high2float(a[e]) + __high2float(r[e]));
            }
          }
          *reinterpret_cast<uint4*>(p.y + dst[u] + nc + oc) = v;
        }
      }
    }
    if (t == 0) sm90::bulk_wait<0>();
  }
}

template <int BN>
cudaError_t launch(const Params& p, const void* w, int grid, cudaStream_t s) {
  auto kernel = window_gemm_kernel<BN>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  // A and Y change from call to call and are encoded each time (a gathered
  // A's map goes unused); W's map is cached by pointer and shape
  CUtensorMap mx, mw, my;
  if (!sm90::encode_bf16_2d(&mx, p.x, p.T, p.K, kBM) ||
      !sm90::cached_bf16_2d(&mw, w, p.Nout, p.K, BN) ||
      !sm90::encode_bf16_2d(&my, p.y, p.T, p.Nout, 64)) {
    return cudaErrorInvalidValue;
  }
  const int smem = kFixed + p.stages * (kBM + BN) * 128;
  kernel<<<grid, kThreads, smem, s>>>(mx, mw, my, p);
  return cudaGetLastError();
}

constexpr int kLnRows = 8;   // rows per block, one warp each

__global__ void __launch_bounds__(32 * kLnRows)
    window_layer_norm_kernel(const __nv_bfloat16* x, const float* w,
                             const float* b, __nv_bfloat16* y, int T, int C,
                             float eps) {
  const int lane = threadIdx.x & 31;
  const long long r =
      static_cast<long long>(blockIdx.x) * kLnRows + (threadIdx.x >> 5);
  if (r >= T) return;
  const __nv_bfloat16* src = x + r * C;
  float sum = 0.f, sq = 0.f;
  for (int c = lane * 8; c < C; c += 32 * 8) {
    const int4 v = *reinterpret_cast<const int4*>(src + c);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float f = __bfloat162float(e[q]);
      sum += f;
      sq += f * f;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
    sq += __shfl_xor_sync(0xffffffffu, sq, off);
  }
  const float mean = sum / C;
  const float rstd = rsqrtf(fmaxf(sq / C - mean * mean, 0.f) + eps);
  __nv_bfloat16* dst = y + r * C;
  for (int c = lane * 8; c < C; c += 32 * 8) {
    int4 v = *reinterpret_cast<const int4*>(src + c);
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float f = __bfloat162float(e[q]);
      e[q] = __float2bfloat16((f - mean) * (rstd * w[c + q]) + b[c + q]);
    }
    *reinterpret_cast<int4*>(dst + c) = v;
  }
}

}  // namespace

// x (T or map rows, K), w (Nout, K), bias (Nout) or null, res (as y) or
// null, y (T or map rows, Nout), rows (hw) int32 or null; the plan
// (block_n, stages, grid) is ops/gemm.py:gemm_plan's
extern "C" int window_gemm_bf16(const void* x, const void* w,
                                const void* bias, const void* res, void* y,
                                const void* rows, int T, int K, int Nout,
                                int hw, int gather, int scatter, int epilogue,
                                int block_n, int stages, int grid,
                                void* stream) {
  const bool windowed = gather || scatter;
  const bool with_res = epilogue == kBiasRes || epilogue == kBias16Res;
  if (T < 1 || K < 32 || K % 32 || Nout < 8 || Nout % 8 || epilogue < 0 ||
      epilogue > kBias16Res || (with_res && res == nullptr) ||
      (windowed && (rows == nullptr || hw < 1 || T % hw)) || stages < 2 ||
      stages > kMaxStages ||
      kFixed + stages * (kBM + block_n) * 128 > kSmemMax || grid < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.bias = static_cast<const __nv_bfloat16*>(bias);
  p.res = with_res ? static_cast<const __nv_bfloat16*>(res) : nullptr;
  p.y = static_cast<__nv_bfloat16*>(y);
  p.rows = static_cast<const int*>(rows);
  p.T = T;
  p.K = K;
  p.Nout = Nout;
  p.hw = windowed ? hw : 1;
  p.gather = gather != 0;
  p.scatter = scatter != 0;
  p.epi = epilogue;
  p.tiles_n = (Nout + block_n - 1) / block_n;
  const long long tiles =
      static_cast<long long>((T + kBM - 1) / kBM) * p.tiles_n;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  p.tiles = static_cast<int>(tiles);
  p.ksteps = (K + 63) / 64;
  p.stages = stages;
  if (grid > p.tiles) grid = p.tiles;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (block_n) {
    case 128: return static_cast<int>(launch<128>(p, w, grid, s));
    case 192: return static_cast<int>(launch<192>(p, w, grid, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int window_layer_norm_bf16(const void* x, const void* w,
                                      const void* b, void* y, int T, int C,
                                      float eps, void* stream) {
  if (T < 1 || C < 8 || C % 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  window_layer_norm_kernel<<<(T + kLnRows - 1) / kLnRows, 32 * kLnRows, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<__nv_bfloat16*>(y), T, C,
      eps);
  return static_cast<int>(cudaGetLastError());
}
