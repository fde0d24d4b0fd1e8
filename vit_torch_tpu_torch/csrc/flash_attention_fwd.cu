// Flash-attention forward for Hopper (sm_90a), bf16 in / bf16 out.
//
// Replaces the Pallas TPU kernels vit_torch_tpu/ops/flash_attention.py:
// _fwd_kernel (:91) and _fwd_kernel_hb (:111), both reached through
// _fwd_impl (pallas_calls at :251 and :265).  Same function:
// O = softmax(scale * Q K^T) V with Q and O over (B, H, Nq, D) and K and V
// over (B, H, Nk, D), keys at index >= Nk masked (the Pallas kernel's
// kv_len), fp32 scores and softmax statistics, P rounded to bf16 for P V
// while the row sum adds the unrounded fp32 P, O / l rounded once.
// Self-attention is Nq = Nk = N; DETR's decoder cross-attention puts 100
// queries against the Hf * Wf memory tokens (Nq < Nk), and 300 queries
// over a 16 x 16 map give Nq > Nk.  The notes below write N where the two
// are one.
//
// Design.  The TPU kernel keeps a whole K/V row in VMEM and runs an exact
// one-pass softmax; an SM's 227 KB do not hold that at N = 785, so the
// keys stream in 64-key tiles under an online softmax (running row max m
// and sum l, O rescaled when the max grows), divided by l once.
//
// - Persistent blocks of 384 threads, at most one per SM, walk the
//   (128 query rows, b * h) items of the call, warp-specialised as
//   csrc/attn_block.cu: the first thread of warpgroup 2 (setmaxnreg 24)
//   loads each item's two 64-row Q tiles into one of two Q slots and
//   streams its (K, V) tile pairs through a ring of mbarrier stages by
//   TMA, running ahead into the next item while the consumers finish one;
//   consumer warpgroups 0 and 1 (setmaxnreg 240) each own 64 query rows of
//   the same head, so that each K/V tile feeds 128 rows.  A block per item
//   instead spends a fixed few microseconds an item (launch, barriers, the
//   first Q and K tiles, the epilogue) that 4 key tiles at N = 197 do not
//   hide: such a version took 0.0377 ms of device time at
//   (32, 12, 197, 64), SDPA 0.0253, on an H100 80GB HBM3 at 700 W
//   (chip_smoke).
// - Each consumer runs csrc/attention_sm90.cuh's head_pingpong, the loop
//   of B3 (attn_block.cu): S = Q K^T by wgmma m64n64k16 from shared memory,
//   the online softmax in base 2 (ex2.approx) on S's registers, O += P V by
//   the register-A wgmma (P packed to bf16 as it stands, V an MN-major
//   tile).  The two warpgroups take turns to issue their products (named
//   barriers 1 and 2: ping-pong, FA3's schedule) and each pipelines S of
//   tile j + 1 against P V of tile j, so that one warpgroup's exp2 on the
//   SFU overlaps the other's products.  At D = 64 the exp is nearly a bound
//   of its own: 16 results a clock an SM give 0.057 ms for the
//   B * H * N^2 = 236.6 M scores of (32, 12, 785, 64), level with the
//   tensor-core bound below.
// - Addressing by TMA: one 4-D tensor map per operand over (D, N, H, B)
//   with the tensor's own strides (sm90::encode_bf16_bhnd), so views into
//   the fused (B, N, 3, H, D) qkv and contiguous (B, H, N, D) tensors take
//   the same kernel; rows at or past N read as zero.  D = 64 tiles are in
//   the 128-byte swizzle, D = 32 tiles in the 64-byte one.  O / l is
//   written through o's strides (bf16 pairs), so O may land straight in a
//   (B, N, H, D) buffer.
// - The ragged edge: keys >= Nk are masked to -inf in the last key tile
//   (softmax_tile's key range); a warpgroup whose 64 rows all lie at or
//   past Nq takes its turns without products (head_idle).  So the products
//   cover ceil(N / 64) * 64 rows and keys: at N = 785, (832 / 785)^2 =
//   1.12x the useful work (a 128-key tiling would be (896 / 785)^2 =
//   1.30x); N = 197: (256 / 197)^2 = 1.69x; N = 17: (64 / 17)^2 = 14x, a
//   shape bound by launch and latency, not by products.
// - Shared memory (ops/flash_attention.py:launch_plan gives the stages,
//   min(8, key tiles), and the blocks, min(items, SMs)): 1 KB of
//   alignment, two slots of two Q tiles (32 KB at D = 64), the stages of K
//   and V (16 KB each), the barriers; at D = 64: N = 785 (13 key tiles,
//   8 stages) 165,024 bytes, N = 197 (4 stages) 99,488, N = 17 (1 stage)
//   50,336.
//
// Bound at B=32, H=12, N=785, D=64: 4*B*H*N^2*D = 60.6 GFLOP (61 us at
// 989 TFLOP/s dense bf16) against 4*B*H*N*D*2 = 154 MB of q/k/v/o (46 us
// at 3.35 TB/s): bound by operations.
//
// For training the kernel also writes each row's log-sum-exp,
// LSE = log sum_j exp(scale * S_ij) in natural log, fp32, into a
// (B*H, Nq) buffer (row (b*H + h) * Nq + i); the backward recomputes
// P = exp(scale * S - LSE) from it.  A null pointer skips the write
// (inference).  The kernel runs in base 2, so it stores
// (m + log2 l) / log2(e) and the backward multiplies by log2(e) again.
//
// This replaces the port's first design: one 4-warp block per
// 64-row tile on mma.sync.m16n8k16, B fragments from 32-bit shared loads,
// synchronous tile loads between __syncthreads; 0.381-0.391 ms at
// (32, 12, 785, 64) on an H100 80GB HBM3 at 700 W (chip_smoke).
//
// C entry point (ctypes): flash_attention_fwd_bf16(...) returns the
// cudaError_t of the launch; it launches on the given stream and does not
// synchronise or allocate.  A plan other than the one launch_plan gives
// for the shape is refused.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_sm90.cuh"
#include "sm90.cuh"

namespace {

constexpr int kThreads = 384;      // 2 consumer warpgroups + producer
constexpr int kSmemMax = 232448;   // 227 KB a block may use
constexpr int kRows = 64;          // query rows a consumer warpgroup
constexpr int kBlockQ = 2 * kRows;
constexpr int kTurn = 1;           // named barriers 1 and 2: the turns
constexpr int kMaxStages = 8;
// full and empty per ring stage; full and empty per Q slot
constexpr int kBarBytes = (2 * kMaxStages + 4) * 8;

struct Params {
  __nv_bfloat16* o;
  float* lse;              // (B*H, Nq) natural-log LSE, or null (inference)
  long long o_stride[3];   // elements: image, head, row
  int H, Nq, Nk, n_kt, stages;   // n_kt: 64-key tiles over Nk
  int q_blocks, items;     // 128-row blocks a head; q_blocks * B * H
  float scale_log2;        // scale * log2(e): the softmax runs in base 2
};

// item n of the call: 128 query rows (block qb) of head h of image b
struct Item {
  int b, h, bh, q0, live;  // live: warpgroups with rows before Nq (1 or 2)
  __device__ __forceinline__ Item(const Params& p, int n) {
    const int qb = n % p.q_blocks;
    bh = n / p.q_blocks;
    b = bh / p.H;
    h = bh % p.H;
    q0 = qb * kBlockQ;
    live = min(2, (p.Nq - q0 + kRows - 1) / kRows);
  }
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const Params p) {
  static_assert(D == 32 || D == 64, "head dim 32 or 64");
  constexpr int kTile = kRows * D * 2;   // 64 rows of Q, K or V
  constexpr int kStage = 2 * kTile;      // a K tile and a V tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_tiles = sm90::align1024(smem_raw);   // 2 slots x 2 tiles
  uint8_t* ring = q_tiles + 4 * kTile;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + p.stages * kStage);
  uint64_t* empty = full + kMaxStages;
  uint64_t* qfull = empty + kMaxStages;      // per Q slot
  uint64_t* qempty = qfull + 2;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      sm90::mbar_init(full + s, 1);
      sm90::mbar_init(empty + s, 8);   // one arrival per consumer warp
    }
    for (int s = 0; s < 2; ++s) {
      sm90::mbar_init(qfull + s, 1);
      sm90::mbar_init(qempty + s, 2);  // one arrival per consumer WG
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == 2) {
    sm90::setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      sm90::tma_prefetch_desc(&tm_q);
      sm90::tma_prefetch_desc(&tm_k);
      sm90::tma_prefetch_desc(&tm_v);
      sm90::RingPos rp;
      int use = 0;   // the items this block has taken
#pragma unroll 1
      for (int n = blockIdx.x; n < p.items; n += gridDim.x, ++use) {
        const Item it(p, n);
        // both Q tiles of the slot (a tile past Nq reads as zero), once the
        // item two back has released it
        const int slot = use & 1;
        sm90::mbar_wait(qempty + slot, ((use >> 1) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(qfull + slot, 2 * kTile);
        for (int w = 0; w < 2; ++w) {
          sm90::tma_load_4d(q_tiles + (2 * slot + w) * kTile, &tm_q,
                            qfull + slot, 0, it.q0 + w * kRows, it.h, it.b);
        }
#pragma unroll 1
        for (int kt = 0; kt < p.n_kt; ++kt) {
          sm90::mbar_wait(empty + rp.stage, rp.phase ^ 1);
          uint8_t* st = ring + rp.stage * kStage;
          sm90::mbar_arrive_expect_tx(full + rp.stage, kStage);
          sm90::tma_load_4d(st, &tm_k, full + rp.stage, 0, kt * attn::kKeys,
                            it.h, it.b);
          sm90::tma_load_4d(st + kTile, &tm_v, full + rp.stage, 0,
                            kt * attn::kKeys, it.h, it.b);
          rp.advance(p.stages);
        }
      }
    }
  } else {
    sm90::setmaxnreg_inc<240>();
    const int t = threadIdx.x & 127;
    const int lane = t & 31;
    const int r0 = 16 * (t >> 5) + (lane >> 2);   // row in the WG's 64
    const int c0 = 2 * (lane & 3);
    const int key_lo[2] = {0, 0};
    const int key_hi[2] = {p.Nk, p.Nk};
    const attn::KvRing kv{ring, kStage, p.stages, full, empty};
    sm90::RingPos rp;
    // warpgroup 0 takes the first turn
    if (wg == 1) sm90::named_barrier_arrive(kTurn, 256);
    int use = 0;
#pragma unroll 1
    for (int n = blockIdx.x; n < p.items; n += gridDim.x, ++use) {
      const Item it(p, n);
      const int slot = use & 1;
      sm90::mbar_wait(qfull + slot, (use >> 1) & 1);
      if (wg >= it.live) {
        attn::head_idle(kv, rp, p.n_kt, lane, kTurn, wg);
        if (t == 0) sm90::mbar_arrive(qempty + slot);
        continue;
      }
      const uint8_t* qt = q_tiles + (2 * slot + wg) * kTile;
      const uint64_t dq =
          D == 64 ? sm90::make_desc(qt) : sm90::make_desc_sw64(qt);
      float o[D / 2], m_run[2], l_run[2];
      attn::head_pingpong<D>(dq, kv, 0, rp, p.n_kt, 0, key_lo, key_hi, c0,
                             lane, p.scale_log2, kTurn, wg, o, m_run, l_run);
      // every wgmma that read the slot has retired (head_pingpong's last
      // wait): the producer may load the item after next into it
      if (t == 0) sm90::mbar_arrive(qempty + slot);
      // O / l, rounded once, through o's strides; the natural-log LSE
      float inv[2], lse[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float l = l_run[r];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        inv[r] = 1.f / l;
        lse[r] = (m_run[r] + log2f(l)) * (1.f / attn::kLog2e);
      }
      __nv_bfloat16* og = p.o + it.b * p.o_stride[0] + it.h * p.o_stride[1];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = it.q0 + wg * kRows + r0 + 8 * r;
        if (row >= p.Nq) continue;
        __nv_bfloat16* orow = og + row * p.o_stride[2];
#pragma unroll
        for (int i = 0; i < D / 8; ++i) {
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * i + c0) =
              __floats2bfloat162_rn(o[4 * i + 2 * r] * inv[r],
                                    o[4 * i + 2 * r + 1] * inv[r]);
        }
        if (p.lse != nullptr && c0 == 0) {
          p.lse[static_cast<long long>(it.bh) * p.Nq + row] = lse[r];
        }
      }
    }
    // warpgroup 1's last turn handed to warpgroup 0, which takes none now
    if (wg == 0) sm90::named_barrier(kTurn, 256);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const long long* st, int B, const Params& p, dim3 grid,
                   int smem, cudaStream_t s) {
  auto kernel = flash_fwd_kernel<D>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  CUtensorMap mq, mk, mv;
  if (!sm90::encode_bf16_bhnd(&mq, q, B, p.H, p.Nq, D, st[0], st[1], st[2],
                              kRows) ||
      !sm90::encode_bf16_bhnd(&mk, k, B, p.H, p.Nk, D, st[3], st[4], st[5],
                              attn::kKeys) ||
      !sm90::encode_bf16_bhnd(&mv, v, B, p.H, p.Nk, D, st[6], st[7], st[8],
                              attn::kKeys)) {
    return cudaErrorInvalidValue;
  }
  kernel<<<grid, kThreads, smem, s>>>(mq, mk, mv, p);
  return cudaGetLastError();
}

}  // namespace

// q and o are (B, H, Nq, D), k and v (B, H, Nk, D).  strides: 12 element
// strides, (image, head, row) of q, k, v and o.  plan: block_q, block_k,
// stages, grid x (the persistent blocks, at most one an item), grid y (1),
// shared bytes, dQ rows (launch_plan's fields; dQ rows 0 here).
extern "C" int flash_attention_fwd_bf16(const void* q, const void* k,
                                        const void* v, void* o, void* lse,
                                        int B, int H, int Nq, int Nk, int D,
                                        const long long* strides,
                                        const int* plan, float scale,
                                        void* stream) {
  const int stage = 2 * kRows * D * 2;
  const int n_kt = (Nk + attn::kKeys - 1) / attn::kKeys;
  const int stages = plan[2];
  const int q_blocks = (Nq + kBlockQ - 1) / kBlockQ;
  const long long items = static_cast<long long>(q_blocks) * B * H;
  if (B < 1 || H < 1 || Nq < 1 || Nk < 1 || (D != 64 && D != 32) ||
      items > 0x7fffffffLL || plan[0] != kBlockQ ||
      plan[1] != attn::kKeys || stages < 1 || stages > kMaxStages ||
      stages > n_kt || plan[3] < 1 || plan[3] > items || plan[4] != 1 ||
      plan[5] != 1024 + 4 * kRows * D * 2 + stages * stage + kBarBytes ||
      plan[5] > kSmemMax) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  for (int j = 0; j < 3; ++j) p.o_stride[j] = strides[9 + j];
  p.H = H;
  p.Nq = Nq;
  p.Nk = Nk;
  p.n_kt = n_kt;
  p.stages = stages;
  p.q_blocks = q_blocks;
  p.items = static_cast<int>(items);
  p.scale_log2 = scale * attn::kLog2e;
  const dim3 grid(plan[3], plan[4]);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      D == 64 ? launch<64>(q, k, v, strides, B, p, grid, plan[5], s)
              : launch<32>(q, k, v, strides, B, p, grid, plan[5], s));
}
