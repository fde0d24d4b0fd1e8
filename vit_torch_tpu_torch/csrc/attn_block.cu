// The attention block of a ViT for Hopper (sm_90a), bf16 in / bf16 out,
// fp32 accumulation, in two launches:
//   qkv = bf16(x W_qkv^T + b_qkv)                     (attn_block_qkv_kernel)
//   out = bf16(concat_h bf16(softmax(scale q_h k_h^T) v_h) W_proj^T + b)
//                                                        (attn_block_kernel)
// over T = B N token rows of B images; qkv has 3C columns in (3, H, D)
// order.
//
// Replaces the Pallas TPU kernels vit_torch_tpu/ops/attn_block.py: _kernel
// (:77, called at :132; attention_block, "B3") and _kernel_packed (:234,
// called at :282; attention_block_packed, "B4", whose qkv output is the
// first launch's).  The TPU kernels ran the whole block in one program per
// image (B3) or per pack of images (B4) with the 4 C^2 weights resident in
// VMEM; 4 C^2 bf16 is 1.2 MB at C = 384 and 4.7 MB at C = 768, which no SM
// holds, so here the qkv product is its own launch.  Rounding points are
// _kernel's: q, k and v take their bias in fp32 and round once; scores and
// softmax statistics are fp32; the unnormalised exp(s - m) is rounded to
// bf16 for P V (m the running row max: the softmax is online over 64-key
// tiles) while the row sum l adds the unrounded values; O / l is rounded
// per head; the projection adds its bias in fp32 and rounds once.
//
// Bound: 8 B N C^2 + 4 B N^2 C operations against x, the weights and the
// output once.  dino_vits16 @224 bs64 (64, 197, 384): 18.7 GFLOP, 18.9 us
// at 989 TFLOP/s, against ~22 MB (6.5 us at 3.35 TB/s); dino_vitb8 @224
// bs32 (32, 785, 768): 179 GFLOP, 181 us.  Bound by operations.
//
// Both kernels are warp-specialised: 384 threads, the first thread of
// warpgroup 2 issues every copy (TMA, cp.async.bulk.tensor, onto mbarriers;
// setmaxnreg 24), warpgroups 0 and 1 run wgmma (setmaxnreg 240).  Tiles
// arrive in the 128-byte swizzle (64-byte for the key/value tiles of head
// dim 32), out-of-bounds rows zero-filled; a ring stage is released on its
// "empty" mbarrier by the 8 consumer warps once the wgmma that read it has
// retired.  The ring and the descriptors are csrc/sm90.cuh's.
//
// 1. The qkv product.  Persistent blocks (one per SM) walk 128 x 192 output
//    tiles; a stage is the 128 x 64 x tile and the 192 x 64 W_qkv tile of
//    one k-step (40 KB, 5 stages); each consumer warpgroup owns 64 rows:
//    wgmma m64n192k16, 96 fp32 accumulators a thread.  The epilogue adds
//    the bias (staged in shared memory once a block) in fp32 and stores
//    the bf16 rows by TMA, 64 columns at a time through a slice of
//    shared memory in the 128-byte swizzle (bf16 pairs stored straight
//    from the accumulators' layout touch 8 rows a warp instruction:
//    slower at C = 384 on the H100; a slice instead of the whole tile
//    leaves room for the fifth stage), while the producer already fills
//    the next tile's stages.  3C is always a multiple of 192.
//
// 2. Attention and projection.  A block owns 64 query rows (B3: 64
//    consecutive rows of one image; B4: one pack of 64 / N whole images).
//    Their q columns (64 x C) are loaded once, by TMA, into a head-output
//    tile HO (C / 64 tiles of 64 columns in the 128-byte swizzle, one
//    mbarrier each) that is the projection's A operand.  The two consumer
//    warpgroups share the rows and take alternate heads (a ring stage
//    carries two heads' K and V tiles).  For each head:
//    - S = Q_h K_h^T per 64-key tile: wgmma m64n64k16, A = HO's q columns
//      of the head, B = the key tile (K-major), both in shared memory;
//    - the masks and the online softmax in base 2 on S's fp32 registers:
//      each query row takes the keys of its own image only (B4's
//      block-diagonal mask as a key range per row; in B3 the range also
//      masks the padding of the last key tile);
//    - O += P V_h: P packed to bf16 in registers is wgmma's A operand as
//      it stands (the accumulator's layout is the register-A layout), V_h
//      is D-contiguous, an MN-major B (sm90::WgmmaRS, transposed B);
//    - at the last key tile O / l is rounded and written over the head's
//      q columns in HO, in the swizzle the projection reads
//      (fence.proxy.async, then a named barrier).
//    What bounds this loop is the softmax: timed with clock64 on an H100
//    (a development build), it took the largest share of a warpgroup's
//    cycles, with both warpgroups in it at once, so that the SFU's exp2
//    and the tensor cores took turns idling.  So the warpgroups take turns
//    (ping-pong, FA3's schedule): each issues its products only in its
//    turn (named barriers 3 and 4) and hands the turn over, and each runs
//    a software pipeline, issuing S of tile j + 1 with P V of tile j and
//    running the softmax of tile j + 1 while P V of tile j is in flight;
//    one warpgroup's softmax then overlaps the other's products.  ptxas
//    serialises a wgmma pipeline whose registers another instruction
//    defines before its wait (C7513) or whose wgmma sits under a branch
//    it cannot prove uniform (C7520): S is read, not rewritten, while P V
//    runs, P is handed over in fp32 and packed after the wait, and the
//    first and last tiles are peeled off the loop.  The loop is
//    csrc/attention_sm90.cuh's head_pingpong, which the flash-attention
//    forward runs too.
//    Then out = HO W_proj^T + b: W_proj (nn.Linear layout, already
//    K-major) streamed in pieces of PR rows x 64 through the same ring;
//    the warpgroups split the output columns, each accumulating at most
//    384 a pass (wgmma m64nPRk16, <= 192 fp32 registers): 192 each at
//    C = 384 and 384 at C = 768 in one pass, 2 x 256 at C = 1024; each
//    output element is written once.  The host's plan (ops/attn_block.py:
//    launch_plan) gives the pass width and the passes.  Shared memory for
//    D = 64: at C = 384 HO 48 KB + 5 stages of 32 KB (a stage holds two
//    heads' K and V tiles or a W piece of 192 rows); at C = 768 HO 96 KB +
//    4 x 32 KB; at C = 1024 128 KB + 3 x 32 KB.
// L2 -> SM bytes (K/V of every head over the block's key tiles, W_proj,
// the q rows; the function itself needs ~22 / 82 MB from device memory):
//   (64, 197, 384)  256 blocks x 0.74 MB = 189 MB
//   (128, 197, 384) 512 x 0.74 MB = 377 MB
//   (32, 785, 768)  416 x 3.83 MB = 1.60 GB: W_proj (1.18 MB) and K/V
//                   (2.56 MB) a block
//   B4 (128, 17, 768) 43 blocks x 1.47 MB = 63 MB.
// Blocks of 128 rows, both warpgroups on one head so that one K/V tile and
// one W_proj piece feed 128 rows, halve these bytes at C <= 384, but on an
// H100 80GB HBM3 at 700 W (chip_smoke) they ran within 2% of 64-row blocks
// at (64, 197, 384) and (128, 197, 384), faster at the one and slower at
// the other: the softmax (above), not L2, bounds the loop.  So there is one
// layout, and no 2-block cluster multicasting K/V and W_proj.
//
// This replaces the port's first design: one 4-warp block of 64 rows,
// mma.sync.m16n8k16 on 32-bit shared loads for all three products, a
// cp.async ring, 154,624 bytes of shared memory at C = 768, and
// window_gemm.cu's mma.sync product for qkv.  Its times on an H100 80GB
// HBM3 at 700 W (chip_smoke): 0.1428-0.1469 ms at (64, 197, 384),
// 0.2768-0.2827 at (128, 197, 384), 1.5570-1.5925 at (32, 785, 768),
// 0.1658-0.1670 at B4's (128, 17, 768).
//
// C entry points (ctypes), each returning the cudaError_t of its launch;
// they launch on the given stream, do not synchronise and allocate
// nothing; every pointer 16-byte aligned:
//   attn_block_qkv_bf16(x (T, C), w_qkv (3C, C), b_qkv (3C) or null,
//                       qkv (T, 3C), T, C, sms, stream)
//   attn_block_bf16(qkv (T, 3C), w_proj (C, C), b_proj (C) or null,
//                   out (T, C), B, N, C, H, group, pass_cols, passes,
//                   scale, stream)
// group is the images a 64-row pack holds (B4) or 0 (B3); (pass_cols,
// passes) is the host's plan; a plan with no kernel instance, or whose
// ring does not fit beside the head-output tile, is refused.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_sm90.cuh"
#include "sm90.cuh"

namespace {

constexpr int kThreads = 384;        // 2 consumer warpgroups + producer
constexpr int kSmemMax = 232448;     // 227 KB a block may use
constexpr int kMaxC = 1024;

// Every thread of the block copies a bias vector (n bf16, n a multiple of
// 8; zeros for a null bias) into shared memory before the roles split, so
// that the qkv product's epilogue reads it there (bias pairs loaded from
// global memory there measured slower on the H100: the tensor cores wait
// through the epilogue).
__device__ __forceinline__ void stage_bias(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src, int n) {
  for (int i = 8 * threadIdx.x; i < n; i += 8 * blockDim.x) {
    *reinterpret_cast<uint4*>(dst + i) =
        src == nullptr ? make_uint4(0, 0, 0, 0)
                       : *reinterpret_cast<const uint4*>(src + i);
  }
}

// ---- 1. the qkv product ------------------------------------------------

constexpr int kQkvBM = 128;   // rows a tile: 64 a consumer warpgroup
constexpr int kQkvBN = 192;   // columns a tile
constexpr int kQkvStage = (kQkvBM + kQkvBN) * 128;   // x + W_qkv tiles
constexpr int kQkvStages = 5;
constexpr int kQkvOut = 2 * 64 * 128;   // a 64 x 64 output slice a WG
constexpr int kQkvBias = 3 * kMaxC * 2;                // the bias, staged
constexpr int kQkvSmem = 1024 + kQkvStages * kQkvStage + kQkvOut +
                         kQkvBias + 2 * kQkvStages * 8;
static_assert(kQkvSmem <= kSmemMax, "shared memory");

struct QkvParams {
  const __nv_bfloat16* bias;  // (3C) or null
  __nv_bfloat16* out;         // (T, 3C)
  int T, C, N3, tiles_n, tiles;
};

__global__ void __launch_bounds__(kThreads, 1)
    attn_block_qkv_kernel(const __grid_constant__ CUtensorMap tm_x,
                          const __grid_constant__ CUtensorMap tm_w,
                          const __grid_constant__ CUtensorMap tm_out,
                          const QkvParams p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = sm90::align1024(smem_raw);
  // the output slices, one of 64 rows x 64 columns a consumer warpgroup
  uint8_t* otile = ring + kQkvStages * kQkvStage;
  __nv_bfloat16* bias = reinterpret_cast<__nv_bfloat16*>(otile + kQkvOut);
  uint64_t* full = reinterpret_cast<uint64_t*>(otile + kQkvOut + kQkvBias);
  uint64_t* empty = full + kQkvStages;
  const int ksteps = p.C / 64;
  stage_bias(bias, p.bias, p.N3);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kQkvStages; ++s) {
      sm90::mbar_init(full + s, 1);
      sm90::mbar_init(empty + s, 8);   // one arrival per consumer warp
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == 2) {
    sm90::setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      sm90::tma_prefetch_desc(&tm_x);
      sm90::tma_prefetch_desc(&tm_w);
      sm90::tma_prefetch_desc(&tm_out);
      sm90::RingPos rp;
#pragma unroll 1
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        const int m0 = (tile / p.tiles_n) * kQkvBM;
        const int n0 = (tile % p.tiles_n) * kQkvBN;
#pragma unroll 1
        for (int kk = 0; kk < ksteps; ++kk) {
          sm90::mbar_wait(empty + rp.stage, rp.phase ^ 1);
          uint8_t* st = ring + rp.stage * kQkvStage;
          sm90::mbar_arrive_expect_tx(full + rp.stage, kQkvStage);
          sm90::tma_load_2d(st, &tm_x, full + rp.stage, kk * 64, m0);
          sm90::tma_load_2d(st + kQkvBM * 128, &tm_w, full + rp.stage,
                            kk * 64, n0);
          rp.advance(kQkvStages);
        }
      }
    }
  } else {
    sm90::setmaxnreg_inc<240>();
    const int t = threadIdx.x & 127;
    const int lane = t & 31;
    const int r0 = 16 * (t >> 5) + (lane >> 2);
    const int c0 = 2 * (lane & 3);
    float acc[kQkvBN / 2];
    sm90::RingPos rp;
#pragma unroll 1
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const int m0 = (tile / p.tiles_n) * kQkvBM;
      const int n0 = (tile % p.tiles_n) * kQkvBN;
      int prev = -1;
#pragma unroll 1
      for (int kk = 0; kk < ksteps; ++kk) {
        sm90::mbar_wait(full + rp.stage, rp.phase);
        const uint8_t* st = ring + rp.stage * kQkvStage;
        const uint64_t da = sm90::make_desc(st + wg * 64 * 128);
        const uint64_t db = sm90::make_desc(st + kQkvBM * 128);
        sm90::wgmma_fence();
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          sm90::Wgmma<kQkvBN>::mma(acc, da + 2 * k, db + 2 * k,
                                   (kk | k) != 0);
        }
        sm90::wgmma_commit();
        if (prev >= 0) {
          sm90::wgmma_wait<1>();
          if (lane == 0) sm90::mbar_arrive(empty + prev);
        }
        prev = rp.stage;
        rp.advance(kQkvStages);
      }
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      if (lane == 0) sm90::mbar_arrive(empty + prev);
      // qkv = bf16(acc + b), 64 columns at a time through the WG's
      // slice: its previous store has read it, then every thread writes
      // its pairs (the swizzle keeps a warp's 8 rows on distinct banks),
      // then one thread stores it
      uint8_t* slice = otile + wg * 64 * 128;
#pragma unroll
      for (int j = 0; j < kQkvBN / 64; ++j) {
        if (t == 0) sm90::bulk_wait_read<0>();
        sm90::named_barrier(1 + wg, 128);
#pragma unroll
        for (int i = 8 * j; i < 8 * j + 8; ++i) {
          const int col = 8 * i + c0;
          const float2 b = sm90::bf16_pair(bias, n0 + col, true);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            *reinterpret_cast<__nv_bfloat162*>(
                slice + sm90::swizzle128(r0 + 8 * half, col & 63)) =
                __floats2bfloat162_rn(acc[4 * i + 2 * half] + b.x,
                                      acc[4 * i + 2 * half + 1] + b.y);
          }
        }
        sm90::fence_proxy_async();   // st.shared -> the TMA store's reads
        sm90::named_barrier(1 + wg, 128);
        if (t == 0 && m0 + wg * 64 < p.T) {
          sm90::tma_store_2d(&tm_out, slice, n0 + 64 * j, m0 + wg * 64);
          sm90::bulk_commit();
        }
      }
    }
    if (t == 0) sm90::bulk_wait<0>();
  }
}

// ---- 2. attention and projection ----------------------------------------

using attn::kKeys;                // keys a tile
constexpr int kTurn = 3;          // named barriers 3 and 4: the turns
constexpr int kMaxStages = 8;
constexpr int kQTiles = kMaxC / 64;
// barriers after the ring: full and empty per stage, one per q tile
constexpr int kBarBytes = (2 * kMaxStages + kQTiles) * 8;

struct Params {
  const __nv_bfloat16* bias;  // (C) or null
  __nv_bfloat16* out;         // (T, C)
  int T, N, C, H;
  int group;         // images a 64-row pack holds (B4), or 0 (B3)
  int passes;        // projection passes a consumer warpgroup
  int stage_bytes, stages;
  float scale_log2;  // scale * log2(e): the softmax runs in base 2
};

// W_proj rows (output columns) of piece q of pass `pass` of consumer
// warpgroup w, which projects columns [w * passes * PW, ...).  A piece at
// or past C is not loaded.
template <int kPW, int kPR>
__device__ __forceinline__ int piece_col(const Params& p, int w, int pass,
                                         int q) {
  return w * p.passes * kPW + pass * kPW + q * kPR;
}

template <int D, int kPW>
__global__ void __launch_bounds__(kThreads, 1)
    attn_block_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_kv,
                      const __grid_constant__ CUtensorMap tm_w,
                      const Params p) {
  static_assert(D == 32 || D == 64, "head dim 32 or 64");
  constexpr int kPR = kPW <= 256 ? kPW : kPW / 2;   // W piece rows
  constexpr int kNQ = kPW / kPR;                     // pieces a pass
  constexpr int kKV = kKeys * D * 2;                 // one K or V tile
  extern __shared__ uint8_t smem_raw[];
  const int C = p.C;
  const int N = p.N;
  constexpr int q_tile = 64 * 128;                   // one HO tile
  uint8_t* ho = sm90::align1024(smem_raw);
  uint8_t* ring = ho + (C / 64) * q_tile;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(ring + p.stages * p.stage_bytes);
  uint64_t* empty = full + kMaxStages;
  uint64_t* qbar = empty + kMaxStages;

  // the block's query rows [q_lo, q_hi) and key rows [k_lo, k_hi), flat
  // over (image, token); the key rows cover whole images
  int q_lo, q_hi;
  if (p.group > 0) {
    q_lo = blockIdx.x * p.group * N;
    q_hi = min(q_lo + p.group * N, p.T);
  } else {
    const int img0 = blockIdx.y * N;
    q_lo = img0 + blockIdx.x * 64;
    q_hi = min(q_lo + 64, img0 + N);
  }
  const int k_lo = (q_lo / N) * N;
  const int k_hi = ((q_hi - 1) / N + 1) * N;
  const int n_kt = (k_hi - k_lo + kKeys - 1) / kKeys;
  const int n_hsteps = (p.H + 1) / 2;        // two heads a stage

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      sm90::mbar_init(full + s, 1);
      sm90::mbar_init(empty + s, 8);   // one arrival per consumer warp
    }
    for (int u = 0; u < C / 64; ++u) sm90::mbar_init(qbar + u, 1);
    sm90::mbar_init_fence();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == 2) {
    // ---- producer: the q tiles, then the (head, key tile) stages, then
    // the W_proj pieces, in the order the consumers read them
    sm90::setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      sm90::tma_prefetch_desc(&tm_q);
      sm90::tma_prefetch_desc(&tm_kv);
      sm90::tma_prefetch_desc(&tm_w);
#pragma unroll 1
      for (int u = 0; u < C / 64; ++u) {
        sm90::mbar_arrive_expect_tx(qbar + u, q_tile);
        sm90::tma_load_2d(ho + u * q_tile, &tm_q, qbar + u, u * 64, q_lo);
      }
      sm90::RingPos rp;
#pragma unroll 1
      for (int j = 0; j < n_hsteps; ++j) {
        const int nh = min(2, p.H - j * 2);
#pragma unroll 1
        for (int kt = 0; kt < n_kt; ++kt) {
          sm90::mbar_wait(empty + rp.stage, rp.phase ^ 1);
          uint8_t* st = ring + rp.stage * p.stage_bytes;
          sm90::mbar_arrive_expect_tx(full + rp.stage, nh * 2 * kKV);
          for (int e = 0; e < nh; ++e) {
            const int h = j * 2 + e;
            const int row = k_lo + kt * kKeys;
            sm90::tma_load_2d(st + 2 * e * kKV, &tm_kv, full + rp.stage,
                              C + h * D, row);
            sm90::tma_load_2d(st + (2 * e + 1) * kKV, &tm_kv,
                              full + rp.stage, 2 * C + h * D, row);
          }
          rp.advance(p.stages);
        }
      }
#pragma unroll 1
      for (int pass = 0; pass < p.passes; ++pass) {
#pragma unroll 1
        for (int kt = 0; kt < C / 64; ++kt) {
#pragma unroll 1
          for (int w = 0; w < 2; ++w) {
#pragma unroll 1
            for (int q = 0; q < kNQ; ++q) {
              const int n = piece_col<kPW, kPR>(p, w, pass, q);
              if (n >= C) continue;
              sm90::mbar_wait(empty + rp.stage, rp.phase ^ 1);
              sm90::mbar_arrive_expect_tx(full + rp.stage, kPR * 128);
              sm90::tma_load_2d(ring + rp.stage * p.stage_bytes, &tm_w,
                                full + rp.stage, kt * 64, n);
              rp.advance(p.stages);
            }
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

    // the key range of the image of each of this thread's two rows (a
    // row past the block's last takes that row's, so that it stays finite)
    int key_lo[2], key_hi[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = min(q_lo + r0 + 8 * i, q_hi - 1);
      key_lo[i] = (row / N) * N;
      key_hi[i] = key_lo[i] + N;
    }

    // warpgroup 0 takes the first turn
    if (wg == 1) sm90::named_barrier_arrive(kTurn, 256);
    sm90::RingPos rp;
#pragma unroll 1
    for (int j = 0; j < n_hsteps; ++j) {
      const int h = j * 2 + wg;
      const bool mine = h < p.H;   // with H odd: WG 1 idles last
      const int qcol = h * D;      // the head's columns in HO
      const uint64_t dq = sm90::make_desc(ho + (qcol >> 6) * q_tile) +
                          (((qcol & 63) * 2) >> 4);
      const attn::KvRing kv{ring, p.stage_bytes, p.stages, full, empty};
      if (!mine) {   // with H odd: release the last pair's stages and keep
        attn::head_idle(kv, rp, n_kt, lane, kTurn, wg);   // the turns
        continue;
      }
      sm90::mbar_wait(qbar + (qcol >> 6), 0);
      float o[D / 2], m_run[2], l_run[2];
      attn::head_pingpong<D>(dq, kv, 2 * wg * kKV, rp, n_kt, k_lo, key_lo,
                             key_hi, c0, lane, p.scale_log2, kTurn, wg, o,
                             m_run, l_run);
      // the head's output, normalised and rounded, over its q columns
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float l = l_run[r];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        inv[r] = l > 0.f ? 1.f / l : 0.f;
      }
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        const int col = qcol + 8 * i + c0;
        uint8_t* tile = ho + (col >> 6) * q_tile;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          *reinterpret_cast<__nv_bfloat162*>(
              tile + sm90::swizzle128(r0 + 8 * r, col & 63)) =
              __floats2bfloat162_rn(o[4 * i + 2 * r] * inv[r],
                                    o[4 * i + 2 * r + 1] * inv[r]);
        }
      }
    }
    // warpgroup 1's last turn handed to warpgroup 0, which takes none now
    if (wg == 0) sm90::named_barrier(kTurn, 256);
    sm90::fence_proxy_async();   // st.shared -> wgmma operand reads
    sm90::named_barrier(1, 256);   // both WGs' heads are written

    // ---- out = HO W_proj^T + b, kPW columns a pass
#pragma unroll 1
    for (int pass = 0; pass < p.passes; ++pass) {
      float acc[kNQ][kPR / 2];
      int prev = -1;
#pragma unroll 1
      for (int kt = 0; kt < C / 64; ++kt) {
        const uint64_t da = sm90::make_desc(ho + kt * q_tile);
#pragma unroll
        for (int w = 0; w < 2; ++w) {
#pragma unroll
          for (int q = 0; q < kNQ; ++q) {
            if (piece_col<kPW, kPR>(p, w, pass, q) >= C) continue;
            sm90::mbar_wait(full + rp.stage, rp.phase);
            if (w == wg) {
              const uint64_t db =
                  sm90::make_desc(ring + rp.stage * p.stage_bytes);
              sm90::wgmma_fence();
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                sm90::Wgmma<kPR>::mma(acc[q], da + 2 * k, db + 2 * k,
                                      (kt | k) != 0);
              }
              sm90::wgmma_commit();
              if (prev >= 0) {
                sm90::wgmma_wait<1>();
                if (lane == 0) sm90::mbar_arrive(empty + prev);
              }
              prev = rp.stage;
            } else if (lane == 0) {
              sm90::mbar_arrive(empty + rp.stage);   // the other WG's
            }
            rp.advance(p.stages);
          }
        }
      }
      sm90::wgmma_wait<0>();
      if (lane == 0 && prev >= 0) sm90::mbar_arrive(empty + prev);
#pragma unroll
      for (int q = 0; q < kNQ; ++q) {
        sm90::fence_regs(acc[q]);
        const int n = piece_col<kPW, kPR>(p, wg, pass, q);
#pragma unroll
        for (int i = 0; i < kPR / 8; ++i) {
          const int col = n + 8 * i + c0;
          if (col >= C) continue;
          const float2 b = sm90::bf16_pair(p.bias, col, true);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = q_lo + r0 + 8 * r;
            if (row >= q_hi) continue;
            *reinterpret_cast<__nv_bfloat162*>(
                p.out + static_cast<long long>(row) * C + col) =
                __floats2bfloat162_rn(acc[q][4 * i + 2 * r] + b.x,
                                      acc[q][4 * i + 2 * r + 1] + b.y);
          }
        }
      }
    }
  }
}

template <int D, int kPW>
cudaError_t launch(const Params& p, const void* qkv, const void* w,
                   dim3 grid, int smem, cudaStream_t s) {
  constexpr int kPR = kPW <= 256 ? kPW : kPW / 2;
  auto kernel = attn_block_kernel<D, kPW>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  // qkv changes from call to call and is encoded each time; W_proj's map
  // is cached by pointer and shape
  CUtensorMap mq, mkv, mw;
  if (!sm90::encode_bf16_box(&mq, qkv, p.T, 3 * p.C, 64, 64) ||
      !sm90::encode_bf16_box(&mkv, qkv, p.T, 3 * p.C, D, kKeys) ||
      !sm90::cached_bf16_2d(&mw, w, p.C, p.C, kPR)) {
    return cudaErrorInvalidValue;
  }
  kernel<<<grid, kThreads, smem, s>>>(mq, mkv, mw, p);
  return cudaGetLastError();
}

cudaError_t launch_qkv(const QkvParams& p, const void* x, const void* w,
                       int sms, cudaStream_t s) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        attn_block_qkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kQkvSmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  CUtensorMap mx, mw, mo;
  if (!sm90::encode_bf16_2d(&mx, x, p.T, p.C, kQkvBM) ||
      !sm90::cached_bf16_2d(&mw, w, p.N3, p.C, kQkvBN) ||
      !sm90::encode_bf16_2d(&mo, p.out, p.T, p.N3, 64)) {
    return cudaErrorInvalidValue;
  }
  const int grid = p.tiles < sms ? p.tiles : sms;
  attn_block_qkv_kernel<<<grid, kThreads, kQkvSmem, s>>>(mx, mw, mo, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int attn_block_qkv_bf16(const void* x, const void* w,
                                   const void* bias, void* out, int T, int C,
                                   int sms, void* stream) {
  if (T < 1 || C < 64 || C % 64 || C > kMaxC || sms < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  QkvParams p;
  p.bias = static_cast<const __nv_bfloat16*>(bias);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.T = T;
  p.C = C;
  p.N3 = 3 * C;
  p.tiles_n = p.N3 / kQkvBN;
  const long long tiles =
      static_cast<long long>((T + kQkvBM - 1) / kQkvBM) * p.tiles_n;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  p.tiles = static_cast<int>(tiles);
  return static_cast<int>(
      launch_qkv(p, x, w, sms, static_cast<cudaStream_t>(stream)));
}

extern "C" int attn_block_bf16(const void* qkv, const void* w,
                               const void* bias, void* out, int B, int N,
                               int C, int H, int group, int pass_cols,
                               int passes, float scale, void* stream) {
  if (B < 1 || N < 1 || H < 1 || C < 64 || C % 64 || C > kMaxC || C % H ||
      group < 0 || group * N > 64 || passes < 1 ||
      static_cast<long long>(B) * N * 3 * C > 0x7fffffffLL ||
      (group == 0 && B > 65535)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int D = C / H;
  // the plan: the two warpgroups' 2 x passes x pass_cols columns cover C
  // (a pass is at most 384 columns: the instances below)
  if (2 * passes * pass_cols < C) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int pr = pass_cols <= 256 ? pass_cols : pass_cols / 2;
  const int kv_stage = 4 * kKeys * D * 2;   // two heads' K and V tiles
  const int stage = kv_stage > pr * 128 ? kv_stage : pr * 128;
  const int fixed = 1024 + (C / 64) * 64 * 128 + kBarBytes;
  int stages = (kSmemMax - fixed) / stage;
  if (stages > kMaxStages) stages = kMaxStages;
  // A warpgroup keeps its last W piece's stage until its next piece has
  // been issued, and the other warpgroup's pieces of the k-tile lie
  // between them in the ring; with fewer than pieces + 2 stages its next
  // piece would wait on the stage it keeps.  Every C up to kMaxC has them.
  if (stages < pass_cols / pr + 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.bias = static_cast<const __nv_bfloat16*>(bias);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.T = B * N;
  p.N = N;
  p.C = C;
  p.H = H;
  p.group = group;
  p.passes = passes;
  p.stage_bytes = stage;
  p.stages = stages;
  p.scale_log2 = scale * attn::kLog2e;
  const dim3 grid = group > 0 ? dim3((B + group - 1) / group, 1)
                              : dim3((N + 63) / 64, B);
  const int smem = fixed + stages * stage;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // (head dim, columns a pass): the instances launch_plan() chooses from
  using Launch = cudaError_t (*)(const Params&, const void*, const void*,
                                 dim3, int, cudaStream_t);
  Launch fn = nullptr;
  if (D == 64) {
    fn = pass_cols == 128   ? launch<64, 128>
         : pass_cols == 192 ? launch<64, 192>
         : pass_cols == 256 ? launch<64, 256>
         : pass_cols == 384 ? launch<64, 384>
                            : nullptr;
  } else if (D == 32) {
    fn = pass_cols == 128   ? launch<32, 128>
         : pass_cols == 192 ? launch<32, 192>
         : pass_cols == 256 ? launch<32, 256>
         : pass_cols == 384 ? launch<32, 384>
                            : nullptr;
  }
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(fn(p, qkv, w, grid, smem, s));
}
