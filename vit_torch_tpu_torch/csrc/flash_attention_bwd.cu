// Flash-attention backward for Hopper (sm_90a), bf16 in / bf16 out.
//
// Replaces the four Pallas TPU backward kernels of
// vit_torch_tpu/ops/flash_attention.py, all reached through _bwd_impl:
// _bwd_fused_kernel_hb (:176, pallas_call at :292), _bwd_fused_kernel
// (:155, at :307), _bwd_dq_kernel (:143, at :324) and _bwd_dkv_kernel
// (:204, at :335).  Same function with Q, O, dO and dQ over (B, H, Nq, D)
// and K, V, dK and dV over (B, H, Nk, D), keys >= Nk masked (Nq = Nk = N
// in self-attention; the notes below write N where the two are one):
//
//   P  = softmax(scale * Q K^T)                    (fp32)
//   dV = P^T dO                                    (P rounded to bf16)
//   dP = dO V^T                                    (fp32)
//   dS = P o (dP - rowsum(P o dP)) * scale         (rounded to bf16)
//   dQ = dS K,  dK = dS^T Q                        (fp32 accumulation)
//
// The TPU kernels keep whole K/V rows and the full N x N fp32 P in VMEM
// and recompute exact softmax rows.  At N = 785 that does not fit an SM's
// 227 KB, so this kernel tiles both sequence axes and takes two residuals
// from the forward: the output O and the per-row log-sum-exp (natural log,
// fp32, (B*H, Nq); see flash_attention_fwd.cu).  P is recomputed tile by
// tile as exp2(scale*log2(e) * S - log2(e) * LSE), already normalised.
//
// Three launches on one stream:
// 1. flash_bwd_preprocess_kernel: Di = rowsum(dO o O) (equal to
//    rowsum(P o dP)) in fp32 from the bf16 tiles, and log2(e) * LSE, into a
//    (B*H, 2, R) fp32 scratch (R = ceil(Nq / 64) * 64, launch_plan's dQ
//    rows; rows past Nq get LSE = +inf, hence P = 0, and Di = 0); it also
//    zeroes the (B*H, R, D) fp32 dQ accumulator.
// 2. flash_bwd_kernel: one block per (128 keys, b * h), one pass over the
//    query tiles, so that each (query tile, key tile) pair is visited once:
//    5 products and one exp2 per score.  Warp-specialised: the first
//    thread of warpgroup 2 (setmaxnreg 24) loads the block's K and V once
//    and streams (Q_i, dO_i, log2(e) LSE_i, Di_i) for each 64-query tile i
//    through a ring of mbarrier stages by TMA (4-D maps over (D, N, H, B)
//    with the tensors' own strides, rows past Nq or Nk zero; the
//    statistics by a bulk copy); consumer warpgroups 0 and 1 (setmaxnreg
//    240) each own 64 of the keys and, per tile:
//    - S^T = K Q^T and dP^T = V dO^T: wgmma m64n64k16, both operands
//      K-major tiles in shared memory;
//    - P^T = exp2(S^T scale log2(e) - log2(e) LSE) (keys past Nk masked to
//      0), dS^T = P^T o (dP^T - Di) scale, in fp32 on the accumulators;
//    - dV += bf16(P^T) dO and dK += bf16(dS^T) Q: register-A wgmma with
//      dO and Q as MN-major B (sm90::WgmmaRS::mma_tb), the accumulator's
//      layout being the register-A layout; dK and dV stay in registers for
//      the whole pass;
//    - dS^T in bf16 into one of two shared buffers (128 keys x 64 queries,
//      the 128-byte swizzle); then one warpgroup (warpgroup i % 2, so the
//      two share the work) computes dQ_i = dS K over all 128 keys with
//      the transposed-A wgmma (sm90::WgmmaTT: dS^T read as an MN-major A,
//      K as an MN-major B) and adds it into the fp32 accumulator with
//      red.global.add (float2 atomicAdd, the result unused).  Named
//      barriers 1-2 (buffer b written by both warpgroups) and 3-4 (buffer
//      b read by the last dQ) order the buffers.
//    dK and dV are written once, at the end, through their strides.
// 3. flash_bwd_convert_kernel: dq = bf16(dQ accumulator) through dq's
//    strides, so that dq can land in one (B, N, 3, H, D) gradient.
// dQ's fp32 sums arrive by atomics in an order that changes from run to
// run, so dq may differ in its last bf16 bit between runs; dk and dv do
// not.  The card's gates hold all three within 2e-2 of max |plain|.
//
// The ragged edge.  Query tiles are 64 rows (R = ceil(Nq / 64) * 64), key
// blocks 128 (64 a warpgroup) over Nk; a warpgroup whose 64 keys all lie
// at or past Nk skips its products (its dS^T halves are zeroed once, for dQ).
// So the products cover about ceil(N / 64) * 64 keys and queries: at
// N = 785 (832 / 785)^2 = 1.12x the useful work, N = 197 1.69x, N = 17
// 14x (a launch- and latency-bound shape).
//
// Shared memory (D = 64; launch_plan gives the stages, min(4, query
// tiles)): 1 KB of alignment, K and V of 128 keys (32 KB), two dS^T
// buffers (32 KB), stages of Q_i, dO_i and 512 bytes of statistics
// (17 KB each), barriers: 136,264 bytes with 4 stages (N >= 193), 84,040
// with 1 (N <= 64).  Registers: a
// consumer thread holds S^T, dP^T, dK, dV (32 fp32 each at D = 64), P and
// dS packed (16 each) and, in its dQ turn, dQ (32).
//
// Bound at the training shape B=32, H=12, N=785, D=64: the function needs
// 5 products of 2*N^2*D flops each, 10*B*H*N^2*D = 151.4 GFLOP (0.153 ms
// at 989 TFLOP/s dense bf16), against q, k, v, O, dO read and dq, dk, dv
// written, 8 * 38.6 MB = 309 MB (0.092 ms at 3.35 TB/s): bound by
// operations.  The exp2 of 236.6 M scores takes 0.057 ms at 16 a clock an
// SM; the dQ atomics move B*H*ceil(N/128)*N*D fp32 = 540 MB into L2.
//
// This replaces the port's first design: a dQ pass and a dK/dV
// pass on mma.sync.m16n8k16 with synchronous tile loads, 7 products (S
// and dP twice) and every exp computed twice; 1.269-1.285 ms at
// (32, 12, 785, 64) on an H100 80GB HBM3 at 700 W (chip_smoke).
//
// C entry point (ctypes): flash_attention_bwd_bf16(...) launches the three
// kernels on the given stream and returns the first non-zero cudaError_t;
// it does not synchronise or allocate.  A plan other than the one
// launch_plan gives for the shape is refused.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_sm90.cuh"
#include "sm90.cuh"

namespace {

constexpr int kThreads = 384;      // 2 consumer warpgroups + producer
constexpr int kSmemMax = 232448;   // 227 KB a block may use
constexpr int kBlockQ = 64;        // query rows a step
constexpr int kBlockK = 128;       // keys a block: 64 a consumer warpgroup
constexpr int kMaxStages = 4;
constexpr int kReady = 1;          // named barriers 1, 2: buffer b written
constexpr int kFree = 3;           // named barriers 3, 4: buffer b read
constexpr int kDsT = kBlockK * kBlockQ * 2;   // a dS^T buffer, 16 KB
constexpr int kStats = 2 * kBlockQ * 4;       // log2(e) LSE_i and Di_i
constexpr int kBarBytes = (2 * kMaxStages + 1) * 8;
constexpr int kPreThreads = 256;

__host__ __device__ constexpr int stage_bytes(int D) {
  return (2 * kBlockQ * D * 2 + kStats + 1023) / 1024 * 1024;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// fp32 pair added into global memory, the result unused (red.global.add)
__device__ __forceinline__ void red_add2(float* dst, float a, float b) {
#if CUDART_VERSION >= 12010
  atomicAdd(reinterpret_cast<float2*>(dst), make_float2(a, b));
#else
  atomicAdd(dst, a);
  atomicAdd(dst + 1, b);
#endif
}

// ---- 1. preprocess and 3. convert: D / 8 threads a row, 8 columns each

struct RowParams {
  const __nv_bfloat16* o;
  const __nv_bfloat16* dout;
  const float* lse;   // (B*H, Nq)
  float* stats;       // (B*H, 2, R): log2(e) LSE, Di
  float* dq_acc;      // (B*H, R, D)
  __nv_bfloat16* dq;
  long long o_stride[3], do_stride[3], dq_stride[3];
  int H, Nq, R;   // query rows: these kernels never see a key
};

template <int D>
__global__ void __launch_bounds__(kPreThreads)
    flash_bwd_preprocess_kernel(const RowParams p) {
  constexpr int kPer = D / 8;
  const int part = threadIdx.x % kPer;
  const int row = blockIdx.x * (kPreThreads / kPer) + threadIdx.x / kPer;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  float acc = 0.f;
  if (row < p.Nq) {
    const uint4 ov = *reinterpret_cast<const uint4*>(
        p.o + b * p.o_stride[0] + h * p.o_stride[1] + row * p.o_stride[2] +
        8 * part);
    const uint4 dv = *reinterpret_cast<const uint4*>(
        p.dout + b * p.do_stride[0] + h * p.do_stride[1] +
        row * p.do_stride[2] + 8 * part);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 of = __bfloat1622float2(o2[j]);
      const float2 df = __bfloat1622float2(d2[j]);
      acc = fmaf(of.x, df.x, acc);
      acc = fmaf(of.y, df.y, acc);
    }
  }
#pragma unroll
  for (int m = 1; m < kPer; m <<= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, m);
  }
  if (row >= p.R) return;
  const long long base = static_cast<long long>(bh) * p.R;
  if (part == 0) {
    const bool valid = row < p.Nq;
    p.stats[2 * base + row] =
        valid ? p.lse[static_cast<long long>(bh) * p.Nq + row] * attn::kLog2e
              : INFINITY;
    p.stats[2 * base + p.R + row] = valid ? acc : 0.f;
  }
  float4* z = reinterpret_cast<float4*>(p.dq_acc + (base + row) * D +
                                        8 * part);
  z[0] = make_float4(0.f, 0.f, 0.f, 0.f);
  z[1] = make_float4(0.f, 0.f, 0.f, 0.f);
}

template <int D>
__global__ void __launch_bounds__(kPreThreads)
    flash_bwd_convert_kernel(const RowParams p) {
  constexpr int kPer = D / 8;
  const int part = threadIdx.x % kPer;
  const int row = blockIdx.x * (kPreThreads / kPer) + threadIdx.x / kPer;
  if (row >= p.Nq) return;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const float4* src = reinterpret_cast<const float4*>(
      p.dq_acc + (static_cast<long long>(bh) * p.R + row) * D + 8 * part);
  const float4 x = src[0];
  const float4 y = src[1];
  uint4 out;
  out.x = pack_bf16(x.x, x.y);
  out.y = pack_bf16(x.z, x.w);
  out.z = pack_bf16(y.x, y.y);
  out.w = pack_bf16(y.z, y.w);
  *reinterpret_cast<uint4*>(p.dq + b * p.dq_stride[0] + h * p.dq_stride[1] +
                            row * p.dq_stride[2] + 8 * part) = out;
}

// ---- 2. the one pass over the query tiles

struct Params {
  const float* stats;   // (B*H, 2, R)
  float* dq_acc;        // (B*H, R, D)
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  long long dk_stride[3], dv_stride[3];
  int H, Nq, Nk, R, n_qt, stages;   // n_qt: 64-row query tiles over Nq
  float scale;          // the softmax scale, applied to dS
  float scale_log2;     // scale * log2(e)
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do,
                     const Params p) {
  static_assert(D == 32 || D == 64, "head dim 32 or 64");
  constexpr int kTile = 64 * D * 2;           // 64 rows of Q, dO, K or V
  constexpr int kStage = stage_bytes(D);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* k_tile = sm90::align1024(smem_raw);   // 128 keys: 2 x kTile
  uint8_t* v_tile = k_tile + 2 * kTile;
  uint8_t* ds_t = v_tile + 2 * kTile;         // 2 x kDsT
  uint8_t* ring = ds_t + 2 * kDsT;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + p.stages * kStage);
  uint64_t* empty = full + kMaxStages;
  uint64_t* kvbar = empty + kMaxStages;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int key0 = blockIdx.x * kBlockK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      sm90::mbar_init(full + s, 1);
      sm90::mbar_init(empty + s, 8);   // one arrival per consumer warp
    }
    sm90::mbar_init(kvbar, 1);
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
      sm90::tma_prefetch_desc(&tm_do);
      // K and V of the block's 128 keys (a half past Nk reads as zero)
      sm90::mbar_arrive_expect_tx(kvbar, 4 * kTile);
      for (int w = 0; w < 2; ++w) {
        sm90::tma_load_4d(k_tile + w * kTile, &tm_k, kvbar, 0, key0 + 64 * w,
                          h, b);
        sm90::tma_load_4d(v_tile + w * kTile, &tm_v, kvbar, 0, key0 + 64 * w,
                          h, b);
      }
      const float* lse2 = p.stats + 2LL * bh * p.R;
      sm90::RingPos rp;
#pragma unroll 1
      for (int i = 0; i < p.n_qt; ++i) {
        sm90::mbar_wait(empty + rp.stage, rp.phase ^ 1);
        uint8_t* st = ring + rp.stage * kStage;
        sm90::mbar_arrive_expect_tx(full + rp.stage, 2 * kTile + kStats);
        sm90::tma_load_4d(st, &tm_q, full + rp.stage, 0, i * kBlockQ, h, b);
        sm90::tma_load_4d(st + kTile, &tm_do, full + rp.stage, 0,
                          i * kBlockQ, h, b);
        sm90::bulk_load(st + 2 * kTile, lse2 + i * kBlockQ, kStats / 2,
                        full + rp.stage);
        sm90::bulk_load(st + 2 * kTile + kStats / 2,
                        lse2 + p.R + i * kBlockQ, kStats / 2,
                        full + rp.stage);
        rp.advance(p.stages);
      }
    }
  } else {
    sm90::setmaxnreg_inc<240>();
    const int t = threadIdx.x & 127;
    const int lane = t & 31;
    const int r0 = 16 * (t >> 5) + (lane >> 2);   // key row in the WG's 64
    const int c0 = 2 * (lane & 3);
    const int wkey0 = key0 + 64 * wg;
    const bool live = wkey0 < p.Nk;   // the warpgroup has keys before Nk
    const bool key_ok[2] = {wkey0 + r0 < p.Nk, wkey0 + r0 + 8 < p.Nk};
    if (!live) {   // its halves of the dS^T buffers stay zero for dQ
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        uint4* z = reinterpret_cast<uint4*>(ds_t + u * kDsT + wg * 64 * 128);
#pragma unroll
        for (int j = 0; j < 4; ++j) z[t + 128 * j] = make_uint4(0, 0, 0, 0);
      }
      sm90::fence_proxy_async();
    }
    const uint8_t* kw = k_tile + wg * kTile;
    const uint8_t* vw = v_tile + wg * kTile;
    const uint64_t a_k = D == 64 ? sm90::make_desc(kw)
                                 : sm90::make_desc_sw64(kw);
    const uint64_t a_v = D == 64 ? sm90::make_desc(vw)
                                 : sm90::make_desc_sw64(vw);
    const uint64_t b_k = sm90::make_desc_mn<2 * D>(k_tile);   // dQ's B
    float dk[D / 2], dv[D / 2], dq[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) dk[j] = dv[j] = 0.f;
    uint32_t pa[4][4] = {}, dsa[4][4] = {};
    sm90::mbar_wait(kvbar, 0);
    sm90::RingPos rp;
#pragma unroll 1
    for (int i = 0; i < p.n_qt; ++i) {
      const int buf = i & 1;
      sm90::mbar_wait(full + rp.stage, rp.phase);
      const uint8_t* st = ring + rp.stage * kStage;
      if (live) {
        const uint64_t b_q = D == 64 ? sm90::make_desc(st)
                                     : sm90::make_desc_sw64(st);
        const uint64_t b_do = D == 64 ? sm90::make_desc(st + kTile)
                                      : sm90::make_desc_sw64(st + kTile);
        float s[32], dp[32];
        sm90::wgmma_fence();
#pragma unroll
        for (int k = 0; k < D / 16; ++k) {
          sm90::Wgmma<64>::mma(s, a_k + 2 * k, b_q + 2 * k, k != 0);
        }
#pragma unroll
        for (int k = 0; k < D / 16; ++k) {
          sm90::Wgmma<64>::mma(dp, a_v + 2 * k, b_do + 2 * k, k != 0);
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(s);
        sm90::fence_regs(dp);
        // P^T and dS^T of the thread's two keys (rows r0, r0 + 8) and its
        // 16 queries (columns 8 j + c0 + {0, 1}), packed as pack_p packs
        const float* lse2 = reinterpret_cast<const float*>(st + 2 * kTile);
        const float* di = lse2 + kBlockQ;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 l = *reinterpret_cast<const float2*>(lse2 + 8 * j + c0);
          const float2 d = *reinterpret_cast<const float2*>(di + 8 * j + c0);
          float pv[4], ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float le = (e & 1) ? l.y : l.x;
            const float de = (e & 1) ? d.y : d.x;
            pv[e] = key_ok[e >> 1] ? attn::exp2_approx(fmaf(
                                         s[4 * j + e], p.scale_log2, -le))
                                   : 0.f;
            ds[e] = pv[e] * (dp[4 * j + e] - de) * p.scale;
          }
          pa[j >> 1][2 * (j & 1)] = pack_bf16(pv[0], pv[1]);
          pa[j >> 1][2 * (j & 1) + 1] = pack_bf16(pv[2], pv[3]);
          dsa[j >> 1][2 * (j & 1)] = pack_bf16(ds[0], ds[1]);
          dsa[j >> 1][2 * (j & 1) + 1] = pack_bf16(ds[2], ds[3]);
        }
        // dV += P^T dO, dK += dS^T Q: 16 queries a k-step
        const uint64_t m_do = sm90::make_desc_mn<2 * D>(st + kTile);
        const uint64_t m_q = sm90::make_desc_mn<2 * D>(st);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          sm90::WgmmaRS<D>::mma_tb(dv, pa[kk], m_do + kk * (2 * D), 1);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          sm90::WgmmaRS<D>::mma_tb(dk, dsa[kk], m_q + kk * (2 * D), 1);
        }
        sm90::wgmma_commit();
      }
      // buffer buf was last read by the other warpgroup's dQ of tile i - 2
      if (i >= 2 && wg != buf) sm90::named_barrier(kFree + buf, 256);
      if (live) {
        uint8_t* dst = ds_t + buf * kDsT;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            *reinterpret_cast<uint32_t*>(
                dst + sm90::swizzle128(64 * wg + r0 + 8 * r, 8 * j + c0)) =
                dsa[j >> 1][2 * (j & 1) + r];
          }
        }
        sm90::fence_proxy_async();   // st.shared -> the dQ wgmma's reads
      }
      if (wg == buf) {
        sm90::named_barrier(kReady + buf, 256);
        // dQ_i = dS K over the block's 128 keys: 16 keys a k-step
        const uint64_t a_ds = sm90::make_desc_mn<128>(ds_t + buf * kDsT);
        sm90::wgmma_fence();
#pragma unroll
        for (int k = 0; k < kBlockK / 16; ++k) {
          sm90::WgmmaTT<D>::mma(dq, a_ds + k * 128, b_k + k * (2 * D),
                                k != 0);
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(dq);
        if (i + 2 < p.n_qt) sm90::named_barrier_arrive(kFree + buf, 256);
        float* acc = p.dq_acc + (static_cast<long long>(bh) * p.R +
                                 i * kBlockQ) * D;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = r0 + 8 * r;
          if (i * kBlockQ + row >= p.Nq) continue;
#pragma unroll
          for (int j = 0; j < D / 8; ++j) {
            red_add2(acc + row * D + 8 * j + c0, dq[4 * j + 2 * r],
                     dq[4 * j + 2 * r + 1]);
          }
        }
      } else {
        sm90::named_barrier_arrive(kReady + buf, 256);
      }
      sm90::wgmma_wait<0>();   // dV and dK of this tile
      sm90::fence_regs(dv);
      sm90::fence_regs(dk);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        sm90::fence_regs(pa[a]);
        sm90::fence_regs(dsa[a]);
      }
      if (lane == 0) sm90::mbar_arrive(empty + rp.stage);
      rp.advance(p.stages);
    }
    if (live) {   // dK and dV of the warpgroup's keys, through strides
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = wkey0 + r0 + 8 * r;
        if (key >= p.Nk) continue;
        __nv_bfloat16* dkr = p.dk + b * p.dk_stride[0] +
                             h * p.dk_stride[1] + key * p.dk_stride[2];
        __nv_bfloat16* dvr = p.dv + b * p.dv_stride[0] +
                             h * p.dv_stride[1] + key * p.dv_stride[2];
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          *reinterpret_cast<uint32_t*>(dkr + 8 * j + c0) =
              pack_bf16(dk[4 * j + 2 * r], dk[4 * j + 2 * r + 1]);
          *reinterpret_cast<uint32_t*>(dvr + 8 * j + c0) =
              pack_bf16(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
        }
      }
    }
  }
}

template <int D>
cudaError_t launch(const void* const* ptr, const long long* st, int B,
                   const RowParams& rp, const Params& p, dim3 grid, int smem,
                   cudaStream_t s) {
  auto kernel = flash_bwd_kernel<D>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  // q, k, v, dout: tensors 0, 1, 2, 4 of the stride table
  CUtensorMap mq, mk, mv, mdo;
  if (!sm90::encode_bf16_bhnd(&mq, ptr[0], B, p.H, p.Nq, D, st[0], st[1],
                              st[2], kBlockQ) ||
      !sm90::encode_bf16_bhnd(&mk, ptr[1], B, p.H, p.Nk, D, st[3], st[4],
                              st[5], 64) ||
      !sm90::encode_bf16_bhnd(&mv, ptr[2], B, p.H, p.Nk, D, st[6], st[7],
                              st[8], 64) ||
      !sm90::encode_bf16_bhnd(&mdo, ptr[4], B, p.H, p.Nq, D, st[12], st[13],
                              st[14], kBlockQ)) {
    return cudaErrorInvalidValue;
  }
  const dim3 rows_grid((p.R + kPreThreads / (D / 8) - 1) /
                           (kPreThreads / (D / 8)),
                       grid.y);
  flash_bwd_preprocess_kernel<D><<<rows_grid, kPreThreads, 0, s>>>(rp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, s>>>(mq, mk, mv, mdo, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_convert_kernel<D><<<rows_grid, kPreThreads, 0, s>>>(rp);
  return cudaGetLastError();
}

}  // namespace

// q, o, dout and dq are (B, H, Nq, D), k, v, dk and dv (B, H, Nk, D).
// strides: 24 element strides, (image, head, row) of q, k, v, o, dout, dq,
// dk, dv in that order.  lse is contiguous (B*H, Nq) fp32; stats (B*H, 2, R)
// and dq_acc (B*H, R, D) are fp32 scratch, R = plan[6].  plan: block_q,
// block_k, stages, grid x, grid y, shared bytes, dQ rows (launch_plan's
// fields).
extern "C" int flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* stats, void* dq_acc, void* dq,
    void* dk, void* dv, int B, int H, int Nq, int Nk, int D,
    const long long* strides, const int* plan, float scale, void* stream) {
  const int n_qt = (Nq + kBlockQ - 1) / kBlockQ;
  const int stages = plan[2];
  if (B < 1 || H < 1 || Nq < 1 || Nk < 1 || (D != 64 && D != 32) ||
      static_cast<long long>(B) * H > 65535 || plan[0] != kBlockQ ||
      plan[1] != kBlockK || stages < 1 || stages > kMaxStages ||
      stages > n_qt || plan[3] != (Nk + kBlockK - 1) / kBlockK ||
      plan[4] != B * H ||
      plan[5] != 1024 + 4 * 64 * D * 2 + 2 * kDsT +
                     stages * stage_bytes(D) + kBarBytes ||
      plan[5] > kSmemMax || plan[6] != n_qt * kBlockQ) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RowParams rp;
  rp.o = static_cast<const __nv_bfloat16*>(o);
  rp.dout = static_cast<const __nv_bfloat16*>(dout);
  rp.lse = static_cast<const float*>(lse);
  rp.stats = static_cast<float*>(stats);
  rp.dq_acc = static_cast<float*>(dq_acc);
  rp.dq = static_cast<__nv_bfloat16*>(dq);
  for (int j = 0; j < 3; ++j) {
    rp.o_stride[j] = strides[9 + j];
    rp.do_stride[j] = strides[12 + j];
    rp.dq_stride[j] = strides[15 + j];
  }
  rp.H = H;
  rp.Nq = Nq;
  rp.R = plan[6];
  Params p;
  p.stats = rp.stats;
  p.dq_acc = rp.dq_acc;
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  for (int j = 0; j < 3; ++j) {
    p.dk_stride[j] = strides[18 + j];
    p.dv_stride[j] = strides[21 + j];
  }
  p.H = H;
  p.Nq = Nq;
  p.Nk = Nk;
  p.R = plan[6];
  p.n_qt = n_qt;
  p.stages = stages;
  p.scale = scale;
  p.scale_log2 = scale * attn::kLog2e;
  const void* ptr[5] = {q, k, v, o, dout};
  const dim3 grid(plan[3], plan[4]);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      D == 64 ? launch<64>(ptr, strides, B, rp, p, grid, plan[5], s)
              : launch<32>(ptr, strides, B, rp, p, grid, plan[5], s));
}
