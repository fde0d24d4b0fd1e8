// The fused transformer MLP for Hopper (sm_90a):
//   out = bf16(gelu(x W1^T + b1) W2^T + b2),  one launch, bf16 in and out,
//   fp32 accumulation; the (T, Hd) hidden activation never leaves the SM.
//
// Replaces the Pallas TPU kernel vit_torch_tpu/ops/fused_mlp.py:_kernel
// ("B12").  Rounding points are _kernel's: x W1 accumulates in fp32, b1 is
// added in fp32, GELU runs in fp32 (the exact erf form), h is rounded once
// to bf16; h W2 accumulates in fp32, b2 is added in fp32, one rounding.
// GELU evaluates the TPU kernel's own erf polynomial (Abramowitz-Stegun
// 7.1.26, |err| <= 1.5e-7, far below bf16 resolution 2^-8).
//
// Bound: 2 T Hd (C + Co) operations against x and out once, W1 and W2
// once.  At DeiT-base bs32 (T = 6336, C = Co = 768, Hd = 3072) that is
// 59.8 GFLOP against 28.9 MB: bound by operations, 60 us at 989 TFLOP/s.
// Swin stage 1 (C = 128) is the nearest to its byte bound.
//
// Design.  The TPU kernel kept W1 and W2 resident in VMEM beside a whole
// (tb, Hd) hidden tile; an SM holds neither.  Here a block owns a tile of
// token rows and a whole output row (one "slab" of columns, up to 768) and
// walks the hidden dimension in chunks of HC = 128 (64 at 384 columns a
// warpgroup, below):
//   1. fc1: h = x[rows] W1[chunk]^T over k-steps of 64, wgmma m64nN1k16
//      (bf16 in, fp32 in registers), both operands from shared memory;
//   2. h = bf16(gelu(h + b1)) into a double-buffered shared tile, written
//      in the 128-byte swizzle that wgmma reads;
//   3. fc2: acc += h W2[slab, chunk]^T, wgmma m64nPRk16 with h as A;
// then out = bf16(acc + b2), each output element written once.
// Warp specialisation: warpgroups 0 and 1 compute (setmaxnreg 240), the
// first thread of warpgroup 2 issues every copy (setmaxnreg 24).  All
// tiles arrive by TMA (cp.async.bulk.tensor, 128-byte swizzle, out-of-
// bounds rows zero-filled) into one ring of stages, each completing on a
// "full" mbarrier; the 8 consumer warps release a stage on its "empty"
// mbarrier once the wgmma that read it has retired (wgmma.wait_group 1
// keeps one group in flight).  A stage holds either the x tile and the W1
// tile of one fc1 k-step or one W2 piece (PR rows x 64 of the chunk); the
// chunk's b1 slice rides on its first fc1 stage (cp.async.bulk), so GELU
// reads b1 from shared memory.  x is streamed with W1, so any C that is a
// multiple of 64 fits.
//
// Two row layouts, chosen by the host plan (ops/fused_mlp.py:launch_plan):
//   rows 128 (slab <= 256 columns, at least one wave of blocks): each
//     consumer warpgroup owns 64 rows and the whole slab, computes its own
//     rows' fc1 for the whole chunk (N1 = 128) and reads its own rows of
//     h; W1 and W2 tiles serve 128 rows, half the operand bytes a row of
//     the 64-row layout, which is what the narrow, many-row Swin stages
//     need.  Registers: 64 (fc1) + NW / 2 <= 128 (fc2) accumulators.
//   rows 64 (every other shape): both warpgroups share 64 rows; each
//     computes half of the chunk's fc1 (N1 = HC / 2), the two halves of h
//     meet in shared memory (named barrier), and each accumulates half of
//     the slab (NW = 64 to 384 columns); twice the blocks of rows 128,
//     for a T too small to fill the card with 128-row tiles.  At C = Co =
//     768 the fc2 accumulator of a 64 x 768 row tile is 49,152 fp32
//     registers, three quarters of the SM's 65,536: 192 a consumer thread,
//     which holds 240 (256 x 240 + 128 x 24 = 64,512).  With N1 = 64 on top
//     (224) ptxas spills and serialises wgmma, so that instance takes
//     HC = 64 and N1 = 32: 192 + 16 accumulators, no spills.
// Co above 768 (Swin stage 4 at 1024) takes ceil(Co / 768) slabs, each of
// which recomputes fc1 for its rows; at Co <= 768 there is one slab and
// the kernel does exactly the function's operations.
// Shared memory: ring stages of max((BM + HC) x 128, PR x 128) bytes
// (32 KB x 5 at rows 128, 24 KB x 8 at rows 64) plus two h buffers
// (BM x HC bf16 each: 16-64 KB together) and 4 b1 slices, <= 227 KB; one
// block of 384 threads per SM.  Waves: DeiT-base bs32 launches 99 blocks
// of 64 rows on 132 SMs (three quarters of the card); dino_vitb8 bs32
// 393, Swin stage 1 2304 blocks of 128 rows.
// What bounds it, timed with clock64 around each phase: at C = 768 most
// of a block's cycles go to issuing wgmma, fc1 at n32 being limited by
// shared-memory operand reads, then to waiting for fc1's x and W1 tiles
// and to GELU, during which the tensor cores idle because both warpgroups
// reach it together; at C = 128, GELU takes half of them.
//
// This replaces the port's first design: 8 warps of mma.sync.m16n8k16 on
// ldmatrix fragments, a 3-stage cp.async ring filled by every warp, one
// output slab of at most 384 columns per block and fc1 recomputed per slab
// (1.5x the operations at C = 768).  Its times on an H100 80GB HBM3 at
// 700 W (chip_smoke): DeiT-base bs32 0.899-0.907 ms, dino_vitb8 bs32
// 2.628-2.683, cait_s24_224 bs32 0.157, Swin stage 1 0.534-0.560.
//
// C entry point (ctypes): fused_mlp_bf16(...) returns the cudaError_t of
// the launch; it launches on the given stream, does not synchronise and
// allocates nothing.  x (T, C), W1 (Hd, C), W2 (Co, Hd) are row-major
// (nn.Linear layout), b1 (Hd) and b2 (Co) may be null, out (T, Co); every
// pointer 16-byte aligned.  C and Hd are multiples of 64, Co of 8.
// (block_rows, wg_cols, slabs) is the host's plan; a plan with no kernel
// instance below is refused.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kThreads = 384;         // 2 consumer warpgroups + producer
constexpr int kSmemMax = 232448;      // 227 KB a block may use
constexpr int kB1Slots = 4;           // b1 slices in flight (chunk % 4)

template <bool kRows128, int kNW, int kPR, int kHC>
struct Cfg {
  static constexpr int BM = kRows128 ? 128 : 64;     // token rows a block
  static constexpr int N1 = kRows128 ? kHC : kHC / 2;  // fc1 width a WG
  static constexpr int NQ = kNW / kPR;               // W2 pieces a WG
  static constexpr int PIECES = kRows128 ? NQ : 2 * NQ;  // per 64 of K
  static constexpr int SW = kRows128 ? kNW : 2 * kNW;    // slab width
  static constexpr int FC1_BYTES = (BM + kHC) * 128;     // x + W1 tiles
  static constexpr int PIECE_BYTES = kPR * 128;
  static constexpr int STAGE =
      FC1_BYTES > PIECE_BYTES ? FC1_BYTES : PIECE_BYTES;
  static constexpr int H_TILE = BM * 128;    // one 64-column tile of h
  static constexpr int H_BYTES = BM * kHC * 2;   // one h buffer
  static constexpr int B1_BYTES = kB1Slots * kHC * 2;  // b1 slices
  static constexpr int FIT =
      (kSmemMax - 1024 - 2 * H_BYTES - B1_BYTES - 256) / STAGE;
  static constexpr int STAGES = FIT < 8 ? FIT : 8;
  static constexpr int SMEM = 1024 + STAGES * STAGE + 2 * H_BYTES +
                              B1_BYTES + 2 * STAGES * 8;
  static_assert(kNW % kPR == 0 && kPR <= 256, "pieces tile the slab");
  static_assert(STAGES >= 3 && SMEM <= kSmemMax, "shared memory");
};

struct Params {
  const __nv_bfloat16* b1;    // (Hd) or null
  const __nv_bfloat16* b2;    // (Co) or null
  __nv_bfloat16* out;         // (T, Co)
  int T, C, Hd, Co, slabs;
};

template <bool kRows128, int kNW, int kPR, int kHC>
__global__ void __launch_bounds__(kThreads, 1)
    fused_mlp_kernel(const __grid_constant__ CUtensorMap tm_x,
                     const __grid_constant__ CUtensorMap tm_w1,
                     const __grid_constant__ CUtensorMap tm_w2,
                     const Params p) {
  using K = Cfg<kRows128, kNW, kPR, kHC>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* hbuf = ring + K::STAGES * K::STAGE;
  __nv_bfloat16* b1s =
      reinterpret_cast<__nv_bfloat16*>(hbuf + 2 * K::H_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(hbuf + 2 * K::H_BYTES +
                                               K::B1_BYTES);
  uint64_t* empty = full + K::STAGES;

  const int rb = blockIdx.x / p.slabs;
  const int m0 = rb * K::BM;
  const int n0 = (blockIdx.x - rb * p.slabs) * K::SW;
  const int ksteps = p.C / 64;
  const int nchunks = (p.Hd + kHC - 1) / kHC;

  if (threadIdx.x == 0) {
    for (int s = 0; s < K::STAGES; ++s) {
      sm90::mbar_init(full + s, 1);
      sm90::mbar_init(empty + s, 8);   // one arrival per consumer warp
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == 2) {
    // ---- producer: one thread issues every tile copy, in the order the
    // consumers read the ring
    sm90::setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      sm90::tma_prefetch_desc(&tm_x);
      sm90::tma_prefetch_desc(&tm_w1);
      sm90::tma_prefetch_desc(&tm_w2);
      sm90::RingPos rp;
#pragma unroll 1
      for (int j = 0; j < nchunks; ++j) {
#pragma unroll 1
        for (int kk = 0; kk < ksteps; ++kk) {
          sm90::mbar_wait(empty + rp.stage, rp.phase ^ 1);
          uint8_t* st = ring + rp.stage * K::STAGE;
          // the chunk's b1 slice rides on its first fc1 stage; slot
          // j % 4 was last read four chunks ago
          const int b1_bytes =
              kk == 0 && p.b1 != nullptr ? 2 * min(kHC, p.Hd - j * kHC) : 0;
          sm90::mbar_arrive_expect_tx(full + rp.stage,
                                      K::FC1_BYTES + b1_bytes);
          if (b1_bytes) {
            sm90::bulk_load(b1s + (j % kB1Slots) * kHC, p.b1 + j * kHC,
                            b1_bytes, full + rp.stage);
          }
          sm90::tma_load_2d(st, &tm_x, full + rp.stage, kk * 64, m0);
          sm90::tma_load_2d(st + K::BM * 128, &tm_w1, full + rp.stage,
                            kk * 64, j * kHC);
          rp.advance(K::STAGES);
        }
#pragma unroll 1
        for (int kc = 0; kc < kHC / 64; ++kc) {
#pragma unroll 1
          for (int pc = 0; pc < K::PIECES; ++pc) {
            sm90::mbar_wait(empty + rp.stage, rp.phase ^ 1);
            sm90::mbar_arrive_expect_tx(full + rp.stage, K::PIECE_BYTES);
            sm90::tma_load_2d(ring + rp.stage * K::STAGE, &tm_w2,
                              full + rp.stage, j * kHC + kc * 64,
                              n0 + pc * kPR);
            rp.advance(K::STAGES);
          }
        }
      }
    }
  } else {
    // ---- consumers
    sm90::setmaxnreg_inc<240>();
    const int t = threadIdx.x & 127;
    const int lane = t & 31;
    const int r0 = 16 * (t >> 5) + (lane >> 2);   // row in the WG's 64
    const int c0 = 2 * (lane & 3);
    const int own_rows = kRows128 ? wg * 64 : 0;  // WG's rows in the block
    const int own_h = kRows128 ? 0 : wg * K::N1;  // WG's fc1 columns

    float acc[K::NQ][kPR / 2];
#pragma unroll
    for (int q = 0; q < K::NQ; ++q) {
#pragma unroll
      for (int i = 0; i < kPR / 2; ++i) acc[q][i] = 0.f;
    }
    float h[K::N1 / 2];

    sm90::RingPos rp;
#pragma unroll 1
    for (int j = 0; j < nchunks; ++j) {
      // 1. fc1 over the k-steps; the stage read by the previous group is
      // released once that group has retired
      int prev = -1;
#pragma unroll 1
      for (int kk = 0; kk < ksteps; ++kk) {
        sm90::mbar_wait(full + rp.stage, rp.phase);
        const uint8_t* st = ring + rp.stage * K::STAGE;
        const uint64_t da = sm90::make_desc(st + own_rows * 128);
        const uint64_t db = sm90::make_desc(st + K::BM * 128 + own_h * 128);
        sm90::wgmma_fence();
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          sm90::Wgmma<K::N1>::mma(h, da + 2 * k, db + 2 * k,
                                  (kk | k) != 0);
        }
        sm90::wgmma_commit();
        if (prev >= 0) {
          sm90::wgmma_wait<1>();
          if (lane == 0) sm90::mbar_arrive(empty + prev);
        }
        prev = rp.stage;
        rp.advance(K::STAGES);
      }
      sm90::wgmma_wait<0>();
      sm90::fence_regs(h);
      if (lane == 0) sm90::mbar_arrive(empty + prev);

      // 2. h = bf16(gelu(h + b1)) into buffer j % 2, 128-byte swizzled:
      // 16-byte chunk c of row r of a 64-column tile sits at c ^ (r % 8)
      uint8_t* hb = hbuf + (j & 1) * K::H_BYTES;
#pragma unroll
      for (int i = 0; i < K::N1 / 8; ++i) {
        const int cc = own_h + 8 * i + c0;        // column in the chunk
        const float2 b = sm90::bf16_pair(
            p.b1 ? b1s + (j % kB1Slots) * kHC : nullptr, cc,
            j * kHC + cc < p.Hd);
        const int tile = cc >> 6;
        const int col = cc & 63;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int rr = own_rows + r0 + 8 * half;
          const int off = tile * K::H_TILE + sm90::swizzle128(rr, col);
          *reinterpret_cast<__nv_bfloat162*>(hb + off) =
              __floats2bfloat162_rn(
                  sm90::gelu_erf(h[4 * i + 2 * half] + b.x),
                  sm90::gelu_erf(h[4 * i + 2 * half + 1] + b.y));
        }
      }
      sm90::fence_proxy_async();   // st.shared -> wgmma operand reads
      if (kRows128) {
        sm90::named_barrier(1 + wg, 128);
      } else {
        sm90::named_barrier(1, 256);   // both halves of h are written
      }

      // 3. fc2: the chunk's 64-column tiles of h against the W2 pieces;
      // a piece of the other warpgroup's columns is released unread
      prev = -1;
#pragma unroll 1
      for (int kc = 0; kc < kHC / 64; ++kc) {
        const uint64_t da =
            sm90::make_desc(hb + kc * K::H_TILE + own_rows * 128);
#pragma unroll
        for (int pc = 0; pc < K::PIECES; ++pc) {
          sm90::mbar_wait(full + rp.stage, rp.phase);
          if (kRows128 || pc / K::NQ == wg) {
            const uint64_t db = sm90::make_desc(ring + rp.stage * K::STAGE);
            sm90::wgmma_fence();
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              sm90::Wgmma<kPR>::mma(acc[pc % K::NQ], da + 2 * k, db + 2 * k,
                                    1);
            }
            sm90::wgmma_commit();
            if (prev >= 0) {
              sm90::wgmma_wait<1>();
              if (lane == 0) sm90::mbar_arrive(empty + prev);
            }
            prev = rp.stage;
          } else if (lane == 0) {
            sm90::mbar_arrive(empty + rp.stage);
          }
          rp.advance(K::STAGES);
        }
      }
      sm90::wgmma_wait<0>();
      if (lane == 0 && prev >= 0) sm90::mbar_arrive(empty + prev);
    }

    // out = bf16(acc + b2)
#pragma unroll
    for (int q = 0; q < K::NQ; ++q) {
      sm90::fence_regs(acc[q]);
#pragma unroll
      for (int i = 0; i < kPR / 8; ++i) {
        const int col = n0 + (kRows128 ? 0 : wg * kNW) + q * kPR + 8 * i + c0;
        if (col >= p.Co) continue;
        const float2 b = sm90::bf16_pair(p.b2, col, true);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = m0 + own_rows + r0 + 8 * half;
          if (row >= p.T) continue;
          *reinterpret_cast<__nv_bfloat162*>(
              p.out + static_cast<long long>(row) * p.Co + col) =
              __floats2bfloat162_rn(acc[q][4 * i + 2 * half] + b.x,
                                    acc[q][4 * i + 2 * half + 1] + b.y);
        }
      }
    }
  }
}

template <bool kRows128, int kNW, int kPR, int kHC>
cudaError_t launch(const Params& p, const void* x, const void* w1,
                   const void* w2, cudaStream_t s) {
  using K = Cfg<kRows128, kNW, kPR, kHC>;
  auto kernel = fused_mlp_kernel<kRows128, kNW, kPR, kHC>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, K::SMEM);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  // x changes from call to call and is encoded each time; the weights'
  // maps are cached by pointer and shape
  CUtensorMap mx, m1, m2;
  if (!sm90::encode_bf16_2d(&mx, x, p.T, p.C, K::BM) ||
      !sm90::cached_bf16_2d(&m1, w1, p.Hd, p.C, kHC) ||
      !sm90::cached_bf16_2d(&m2, w2, p.Co, p.Hd, kPR)) {
    return cudaErrorInvalidValue;
  }
  const long long blocks =
      static_cast<long long>((p.T + K::BM - 1) / K::BM) * p.slabs;
  if (blocks > 0x7fffffffLL ||
      static_cast<long long>(p.slabs) * K::SW < p.Co) {
    return cudaErrorInvalidValue;
  }
  kernel<<<static_cast<unsigned>(blocks), kThreads, K::SMEM, s>>>(mx, m1, m2,
                                                                   p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fused_mlp_bf16(const void* x, const void* w1, const void* b1,
                              const void* w2, const void* b2, void* out,
                              int T, int C, int Hd, int Co, int block_rows,
                              int wg_cols, int slabs, void* stream) {
  if (T < 1 || C < 64 || C % 64 || Hd < 64 || Hd % 64 || Co < 8 || Co % 8 ||
      slabs < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.b1 = static_cast<const __nv_bfloat16*>(b1);
  p.b2 = static_cast<const __nv_bfloat16*>(b2);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.T = T;
  p.C = C;
  p.Hd = Hd;
  p.Co = Co;
  p.slabs = slabs;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // (rows a block, columns a consumer warpgroup) -> (W2 piece rows,
  // hidden chunk): the instances launch_plan() chooses from.  At 384
  // columns a warpgroup the chunk is 64 (fc1 n32) to stay in registers.
  using Launch = cudaError_t (*)(const Params&, const void*, const void*,
                                 const void*, cudaStream_t);
  Launch fn = nullptr;
  if (block_rows == 128) {
    fn = wg_cols == 128   ? launch<true, 128, 128, 128>
         : wg_cols == 192 ? launch<true, 192, 192, 128>
         : wg_cols == 256 ? launch<true, 256, 256, 128>
                          : nullptr;
  } else if (block_rows == 64) {
    fn = wg_cols == 64    ? launch<false, 64, 64, 128>
         : wg_cols == 128 ? launch<false, 128, 128, 128>
         : wg_cols == 192 ? launch<false, 192, 192, 128>
         : wg_cols == 256 ? launch<false, 256, 128, 128>
         : wg_cols == 384 ? launch<false, 384, 192, 64>
                          : nullptr;
  }
  if (fn != nullptr) return static_cast<int>(fn(p, x, w1, w2, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
