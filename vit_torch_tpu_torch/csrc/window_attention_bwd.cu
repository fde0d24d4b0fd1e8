// Swin window-attention backward for Hopper (sm_90a), bf16 in / bf16 out.
//
// Replaces the Pallas TPU kernel vit_torch_tpu/ops/window_attention.py:
// _bwd_kernel (def :111, pallas_call :196, reached through _bwd_impl).  Same
// function, per window i and head h of (Bn, N, H, D) tensors, keys and
// queries >= N excluded:
//   S  = scale * Q K^T + bias[h] + mask[i mod nW]    (fp32)
//   P  = softmax(S)                                  (fp32, exact rows)
//   dV = bf16(P)^T dO
//   dP = dO V^T                                      (fp32)
//   Di = rowsum(P o dP)                              (from the fp32 P)
//   dS = P o (dP - Di)                               (fp32)
//   dQ = bf16(dS) K * scale,  dK = bf16(dS)^T Q * scale
//   dbias[h] = sum over windows of the fp32 dS       (unrounded)
// The mask gets no gradient.  It is the backward of the window-attention
// core, and so of the Swin block kernels B8 and B9 (window_block.py).  As in
// the forward (window_attention_fwd.cu), the table bias[h] + mask[j] is
// summed once in fp32 before the scores are added to it: s + (b + m) where
// the plain version rounds (s + b) + m.  The two differ only where the mask
// is -100, where P is ~e^-100 of the row's largest either way.
//
// Bound on an H100 at swin_base_384 bs32 stage 1, (Bn, N, H, D) = (2048,
// 144, 4, 32): q, k, v, dO read and dq, dk, dv written, 7 Bn N H D * 2 bytes
// = 528 MB, 0.158 ms at 3.35 TB/s; the five products, 10 Bn H N^2 D = 54.4
// GFLOP, take 0.055 ms at 989 TFLOP/s.  So the kernel has to stream the
// window tiles at the memory's rate and keep the per-window work (the
// table, the softmax's exp, the dbias sums) on chip.
//
// Design.  N <= 144 and D = 32: a whole score row of a 64-row query slice
// fits in one warpgroup's registers (wgmma m64nNK, NK = the keys padded to
// 16, 32, 64 or 144), so P is recomputed exactly, with no log-sum-exp
// residual, and Di comes from P and dP as in the TPU kernel.
// - Persistent blocks of 384 threads, each owning a group (h, j): head h
//   and mask row j (the group is h alone unmasked), and a run of that
//   group's windows i = j + nW b (ops/window_attention.py:bwd_plan, the
//   forward's core_plan split).  The group's fp32 table bias[h] + mask[j]
//   is staged once a block (the forward's staging), so a window reads
//   nothing but its Q, K, V and dO.
// - Each window's tiles arrive by TMA, 4-D maps over the views' own
//   (window, row, head) strides (sm90::encode_bf16_bhnd: q, k, v are views
//   into the window-major (Bn, N, 3, H, D) qkv, dq, dk, dv into its
//   gradient), NK rows each, rows at or past N zero-filled.
// - Products on wgmma, for a 64-row query slice: S = Q K^T (m64nNKk16,
//   both operands K-major in the 64-byte swizzle) and dP = dO V^T in two
//   halves of NK / 2 keys, so that S and half of dP fit a thread's
//   registers beside the rest: both halves for Di, the second kept for its
//   dS, the first computed again for its own (half a product more, on the
//   tensor cores: cheaper than the spills the whole dP cost).  P and dS go
//   to bf16 tiles in shared memory, written from the accumulators in their
//   natural (query row, key) order, 64 keys a 128-byte-swizzled tile (the
//   keys past 128 in one 64-byte-swizzled tile).  dQ = bf16(dS) K reads the
//   warpgroup's own rows of the dS tile as a K-major A (sm90::WgmmaSB, K an
//   MN-major B); dV = P^T dO and dK = dS^T Q read the P and dS tiles as
//   MN-major A operands (sm90::WgmmaTT, dO and Q as MN-major B), 16 query
//   rows a k-step: the accumulators are the 64 keys of one tile.
// - dbias without atomics and in a fixed order.  The TPU kernel carries
//   dbias in VMEM scratch along its sequential window axis; here a thread
//   owns the same (row, column) elements of S in every window of its block
//   and adds its fp32 dS up over the block's windows, writing one (N, N)
//   partial at the end; a second launch sums the partials in a fixed
//   order.  A run is reproducible from its seed.
// - Two schedules, by the keys' width:
//   * NK <= 64 (one query slice): two consumer warpgroups take alternate
//     windows through a ring of stages (Q, K, V, dO a stage) that
//     warpgroup 2's first thread fills (setmaxnreg 24 / 240), each with its
//     own P and dS tiles and its own dbias sums in registers (one partial
//     a warpgroup); the table stays in shared memory.
//   * NK = 144 (Swin's window 12): the three query slices run in parallel,
//     warpgroup w taking query rows 64 w ... (the third has 16 live rows),
//     then, after a named barrier, dV and dK for keys 64 w ...  ptxas
//     allocates within the launch bound's share of the registers (168 for
//     384 threads, whatever setmaxnreg grants at run time), so nothing
//     beyond S and half of dP stays in registers: the dbias sums live in
//     shared memory (72 fp32 a thread of the 9 warps with live rows), and
//     the table in a global scratch, each thread's values over the scale
//     in its accumulator's order, loaded into S's registers while the
//     window before runs its keys; S's product then adds Q K^T to them.
//     So s = (Q K^T + t / scale) * scale where the plain version rounds
//     Q K^T * scale + t: the two differ in the last fp32 bits.  Thread 0
//     loads the next window's K and V once the rows are done with them;
//     Q and dO have two slots, so a window's arrive while the window
//     before runs (loaded once the window two before is done with the
//     slot).
// - Register budget: descriptors and offsets derived in a loop go through
//   sm90::opaque, and table reads from shared memory through
//   sm90::load_fence, so that the compiler neither hoists nor batches
//   them into registers.
// - Rows and keys at or past N take P = 0 and dS = 0, so they add nothing
//   to dbias, dK or dV, and are never stored.
// - Shared memory at N = 144: 1 KB of alignment, K, V and two Q/dO slots
//   (54 KB), the P and dS tiles (90 KB; the table is staged there before
//   the first window), the dbias sums (81 KB), the barriers: 231,552
//   bytes; the table scratch is 81 KB a block.
//
// This replaces the port's first design: one block per (head, mask row,
// chunk of images), ceil(N / 16) warps of warp-level m16n8k16 products,
// each window loaded by cp.async and waited on, dP computed twice, and P
// and dS through shared memory for ldmatrix.trans.  Its times on an H100
// 80GB HBM3 at 700 W (chip_smoke, swin_base_384 bs32): 0.709/0.701 ms at
// stage 1 shifted/unshifted, 0.379/0.374, 0.215/0.215 and 0.133 at stages
// 2-4; this design's are in PERF.md row 6.
//
// C entry point (ctypes): window_attention_bwd_bf16(...) launches both
// passes on the given stream and returns the first non-zero cudaError_t; it
// does not synchronise or allocate.  A plan other than bwd_plan's is
// refused.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_sm90.cuh"
#include "sm90.cuh"

namespace {

constexpr int kD = 32;               // head dim of every Swin config
constexpr int kMaxN = 144;           // N = w^2 up to window 12
constexpr int kThreads = 384;        // 3 warpgroups
constexpr int kSmemMax = 232448;     // 227 KB a block may use
constexpr int kMaxStages = 4;        // the ring of the alternate schedule
constexpr int kTable = 1;            // named barriers: the table staged;
constexpr int kOwn = 4;              // 4-6: one warpgroup's rows written;
constexpr int kRows = 2;             // split: a window's P and dS written,
constexpr int kDone = 3;             // its dV and dK done
constexpr int kSlots = 9;            // split: warps with live rows (N = 144)

struct Params {
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  const float* bias;     // (H, N, N)
  const float* mask;     // (nW, N, N) or null
  float* partial;        // (parts, H, N, N)
  float4* tab;           // split: (blocks, kSlots, NK / 8, 32) table / scale
  long long os[3][3];    // (window, row, head) strides of dq, dk, dv
  float scale;
  int N;
  int H;
  int nW;                // groups a head: mask rows, 1 unmasked
  int windows;           // windows a group: Bn / nW
  int per_block;         // windows a block walks
  int stages;            // ring stages (alternate schedule), 1 (split)
};

// the table's row stride in floats (window_attention_fwd.cu's): the keys'
// width rounded up to an odd multiple of 8
__host__ __device__ constexpr int table_stride(int nk) {
  return (nk % 32 == 8 || nk % 32 == 24) ? nk : nk + 8;
}

template <int NK>
struct Layout {
  static constexpr bool kSplit = NK > 64;
  static constexpr int kTile = NK * kD * 2;          // one of Q, K, V, dO
  // P (or dS) of one window: split, keys 0-63 and 64-127 in 128-byte rows
  // and keys 128-159 in 64-byte rows, NK query rows; alternate, one
  // 64-row tile of 128-byte rows (keys 0-63)
  static constexpr int kP = kSplit ? 2 * NK * 128 + NK * 64 : 64 * 128;
  static constexpr int kBufs = kSplit ? 2 * kP : 4 * kP;   // P, dS (x2 WGs)
  // split: the dbias sums, NK / 2 fp32 a thread of the live warps
  static constexpr int kDb = kSplit ? kSlots * 32 * (NK / 2) * 4 : 0;
  // a stage: alternate, Q, dO, K, V of one window; split, K and V, then
  // two (Q, dO) slots, so that a window's Q and dO arrive during the
  // window before
  static constexpr int kStage = (kSplit ? 6 : 4) * kTile;
  static constexpr int kTs = table_stride(NK);
  static constexpr int kBars = 4 * kMaxStages * 8;

  // byte offset of element (query row r, key c) in a P or dS buffer
  static __device__ __forceinline__ int at(int r, int c) {
    if (!kSplit) return sm90::swizzle128(r, c);
    return c < 128 ? (c >> 6) * (NK * 128) + sm90::swizzle128(r, c & 63)
                   : 2 * NK * 128 + sm90::swizzle64(r, c - 128);
  }
};

// dynamic shared bytes past the ring: split, the P and dS tiles and the
// dbias sums (the table lives in global scratch); alternate, the tiles
// and the table
template <int NK>
__host__ __device__ constexpr int fixed_bytes(int n) {
  using L = Layout<NK>;
  return 1024 + L::kBufs + (L::kSplit ? L::kDb : n * L::kTs * 4) + L::kBars;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// rows r0 and r0 + 8 (before N) of a 64 x 32 fp32 accumulator, times mul,
// rounded to bf16 into a (row, D) tensor through its row stride
__device__ __forceinline__ void store_rows(__nv_bfloat16* base,
                                           long long s_row,
                                           const float (&acc)[16], int row0,
                                           int c0, int N, float mul) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= N) continue;
    __nv_bfloat16* dst = base + row * s_row;
#pragma unroll
    for (int i = 0; i < kD / 8; ++i) {
      *reinterpret_cast<uint32_t*>(dst + 8 * i + c0) =
          pack_bf16(acc[4 * i + 2 * r] * mul, acc[4 * i + 2 * r + 1] * mul);
    }
  }
}

// the group's table, bias[h] + mask[j] in fp32, into shared memory (rows
// of ts floats, -inf past N) by nthreads threads: the forward's staging,
// 16-byte loads where the rows allow
__device__ __forceinline__ void stage_table(float* table, const float* bias,
                                            const float* mask, int N, int ts,
                                            int nthreads) {
  constexpr int kBatch = 8;
  const bool wide =
      N % 4 == 0 && ((reinterpret_cast<uintptr_t>(bias) |
                      reinterpret_cast<uintptr_t>(mask)) & 15) == 0;
  if (wide) {
    const int n4 = N * N / 4;
    const int rot = (blockIdx.x * 2053) % n4;
#pragma unroll 1
    for (int e0 = 0; e0 < n4; e0 += nthreads * kBatch) {
      float4 v[kBatch];
      int at[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        int e = e0 + nthreads * u + threadIdx.x;
        at[u] = -1;
        if (e < n4) {
          e = e + rot < n4 ? e + rot : e + rot - n4;
          at[u] = 4 * e;
          v[u] = __ldg(reinterpret_cast<const float4*>(bias) + e);
          if (mask != nullptr) {
            const float4 m = __ldg(reinterpret_cast<const float4*>(mask) + e);
            v[u].x += m.x;
            v[u].y += m.y;
            v[u].z += m.z;
            v[u].w += m.w;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = at[u];
        if (e >= 0) {
          *reinterpret_cast<float4*>(table + (e / N) * ts + e % N) =
              v[u];
        }
      }
    }
  } else {
#pragma unroll 1
    for (int e0 = 0; e0 < N * N; e0 += nthreads * kBatch) {
      float v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + nthreads * u + threadIdx.x;
        v[u] = 0.f;
        if (e < N * N) {
          v[u] = __ldg(bias + e);
          if (mask != nullptr) v[u] += __ldg(mask + e);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + nthreads * u + threadIdx.x;
        if (e < N * N) table[(e / N) * ts + e % N] = v[u];
      }
    }
  }
  for (int e = threadIdx.x; e < N * (ts - N); e += nthreads) {
    table[(e / (ts - N)) * ts + N + e % (ts - N)] = -INFINITY;
  }
}

// split: the thread's table values (bias + mask over the scale, in the
// accumulator's order) into S's registers, which S's product then adds to;
// a warp without live rows takes zeros
template <int NK>
__device__ __forceinline__ void load_table(float (&s)[NK / 2],
                                           const float4* tab, int lane) {
#pragma unroll
  for (int i = 0; i < NK / 8; ++i) {
    const float4 v = tab != nullptr ? tab[32 * i + lane]
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
    s[4 * i] = v.x;
    s[4 * i + 1] = v.y;
    s[4 * i + 2] = v.z;
    s[4 * i + 3] = v.w;
  }
}

// One 64-row query slice q of a window (rows 64 q + 16 warp + ...): S and
// dP on wgmma, the exact softmax, Di, dS, the dbias sums, P and dS into
// the bf16 tiles, dQ = bf16(dS) K * scale stored through dq's strides.
// The table and the dbias sums: split, s arrives holding the thread's
// table values over the scale (load_table) and the sums are 18 float4 a
// thread in shared memory (dbs, null for a warp without live rows);
// alternate, the staged table in shared memory and the sums in registers
// (db).
template <int NK>
__device__ __forceinline__ void row_slice(
    const Params& p, int q, const uint8_t* qd, const uint8_t* kv,
    const float* table,
    float4* dbs, uint8_t* pbuf, uint8_t* dsbuf, float (&s)[NK / 2],
    float (&db)[NK / 2], __nv_bfloat16* dq_win, int wg, int warp, int r0,
    int c0) {
  using L = Layout<NK>;
  const int N = p.N;
  const uint8_t* tq = qd;
  const uint8_t* tdo = qd + L::kTile;
  const uint8_t* tk = kv;
  const uint8_t* tv = kv + L::kTile;
  const int lane = threadIdx.x & 31;
  const bool live = 64 * q + 16 * warp < N;   // a row of this warp before N
  // dP is taken in two halves of HK keys (HK / 2 fp32 a thread), so that S
  // and one half of dP fit the registers beside the rest: both halves for
  // Di, the second kept for its dS, the first computed again for its own
  // (half a product more, on the tensor cores)
  constexpr int HK = NK / 2;
  float dp[HK / 2];
  const uint64_t dq_ = sm90::opaque(sm90::make_desc_sw64(tq + q * 64 * 64));
  const uint64_t ddo = sm90::opaque(sm90::make_desc_sw64(tdo + q * 64 * 64));
  const uint64_t dk_ = sm90::opaque(sm90::make_desc_sw64(tk));
  const uint64_t dv_ = sm90::opaque(sm90::make_desc_sw64(tv));
  // dP for keys [HK h, HK h + HK): V's rows of the half as B
  const auto dp_half = [&](int h) {
    const uint64_t b = dv_ + h * (HK * 64 / 16);
    sm90::wgmma_fence();
    sm90::Wgmma<HK>::mma(dp, ddo, b, 0);
    sm90::Wgmma<HK>::mma(dp, ddo + 2, b + 2, 1);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dp);
  };
  sm90::wgmma_fence();
  sm90::Wgmma<NK>::mma(s, dq_, dk_, L::kSplit ? 1 : 0);
  sm90::Wgmma<NK>::mma(s, dq_ + 2, dk_ + 2, 1);
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(s);

  const int row_a = sm90::opaque(64 * q + r0);   // the thread's two rows
  c0 = sm90::opaque(c0);
  const bool ok[2] = {row_a < N, row_a + 8 < N};
  if (live) {
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < NK / 8; ++i) {
      if constexpr (L::kSplit) {   // (QK^T + table / scale) * scale
#pragma unroll
        for (int e = 0; e < 4; ++e) s[4 * i + e] *= p.scale;
      } else {
        const float* ta = table + min(row_a, N - 1) * L::kTs;
        const float* tb = table + min(row_a + 8, N - 1) * L::kTs;
        const float2 a = *reinterpret_cast<const float2*>(ta + 8 * i + c0);
        const float2 b = *reinterpret_cast<const float2*>(tb + 8 * i + c0);
        s[4 * i] = fmaf(s[4 * i], p.scale, a.x);
        s[4 * i + 1] = fmaf(s[4 * i + 1], p.scale, a.y);
        s[4 * i + 2] = fmaf(s[4 * i + 2], p.scale, b.x);
        s[4 * i + 3] = fmaf(s[4 * i + 3], p.scale, b.y);
        if (i % 3 == 2) sm90::load_fence();   // 6 table loads in flight
      }
      mx[0] = fmaxf(mx[0], fmaxf(s[4 * i], s[4 * i + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[4 * i + 2], s[4 * i + 3]));
    }
    float l[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {   // the 4 threads of a quad share a row
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      mx[r] *= attn::kLog2e;
    }
#pragma unroll
    for (int i = 0; i < NK / 2; ++i) {
      const int r = (i >> 1) & 1;
      s[i] = attn::exp2_approx(fmaf(s[i], attn::kLog2e, -mx[r]));
      l[r] += s[i];
    }
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = ok[r] ? 1.f / l[r] : 0.f;   // rows >= N: P = 0
    }
#pragma unroll
    for (int i = 0; i < NK / 2; ++i) {
      const int r = (i >> 1) & 1;
      s[i] = ok[r] ? s[i] * inv[r] : 0.f;
    }
  } else {
#pragma unroll
    for (int i = 0; i < NK / 2; ++i) s[i] = 0.f;
  }

  // Di = rowsum(P o dP) over both halves; dS = P o (dP - Di) is 0 where P
  // is 0
  float di[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    dp_half(h);
#pragma unroll
    for (int j = 0; j < HK / 2; ++j) {
      di[(j >> 1) & 1] = fmaf(s[h * (HK / 2) + j], dp[j], di[(j >> 1) & 1]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    di[r] += __shfl_xor_sync(0xffffffffu, di[r], 1);
    di[r] += __shfl_xor_sync(0xffffffffu, di[r], 2);
  }

  // per half (the second, whose dP is in registers, then the first again):
  // dS, the dbias sums, and bf16 P and dS into the tiles, an n8 block at a
  // time so that each element dies as soon as it is stored
#pragma unroll
  for (int h = 1; h >= 0; --h) {
    if (h == 0) dp_half(0);
#pragma unroll
    for (int b = 0; b < HK / 8; ++b) {
      const int i = h * (HK / 8) + b;   // the n8 block of the whole row
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ds[e] = s[4 * i + e] * (dp[4 * b + e] - di[e >> 1]);
      }
      if constexpr (L::kSplit) {
        if (live) {
          float4 v = dbs[32 * i + lane];
          v.x += ds[0];
          v.y += ds[1];
          v.z += ds[2];
          v.w += ds[3];
          dbs[32 * i + lane] = v;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) db[4 * i + e] += ds[e];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row_a + 8 * r;
        if (L::kSplit && row >= NK) continue;   // rows past the tiles' NK
        const int off = L::at(row, 8 * i + c0);
        *reinterpret_cast<uint32_t*>(pbuf + off) =
            pack_bf16(s[4 * i + 2 * r], s[4 * i + 2 * r + 1]);
        *reinterpret_cast<uint32_t*>(dsbuf + off) =
            pack_bf16(ds[2 * r], ds[2 * r + 1]);
      }
    }
  }

  // dQ = bf16(dS) K * scale, 16 keys a k-step: the warpgroup's own dS rows
  // from the tile just written (K-major A), K as an MN-major B
  sm90::fence_proxy_async();   // st.shared dS -> wgmma's reads
  sm90::named_barrier(kOwn + wg, 128);
  float acc[16];
  const uint64_t bk = sm90::opaque(sm90::make_desc_mn<2 * kD>(tk));
  const uint64_t a128 = sm90::opaque(sm90::make_desc(dsbuf + 64 * q * 128));
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < NK / 16; ++kk) {
    // keys 16 kk ...: 4 k-steps a 128-byte tile; keys 128-143 open the
    // 64-byte tail tile (NK = 144)
    uint64_t a;
    if (kk < 8) {
      a = a128 + (kk >> 2) * (NK * 128 / 16) + 2 * (kk & 3);
    } else {
      a = sm90::make_desc_sw64(dsbuf + 2 * NK * 128 + 64 * q * 64);
    }
    sm90::WgmmaSB<kD>::mma(acc, a, bk + kk * (2 * kD), kk != 0);
  }
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(acc);
  if (live) store_rows(dq_win, p.os[0][1], acc, row_a, c0, N, p.scale);
}

// dV = bf16(P)^T dO and dK = bf16(dS)^T Q for the 64 keys of tile kt
// (keys 64 kt ...) over the query k-steps [K0, K1) (16 query rows each),
// accumulated into dv and dk (k-step 0 starts them): P and dS read as
// MN-major A, dO and Q as MN-major B
template <int NK, int K0, int K1>
__device__ __forceinline__ void key_steps(int kt, const uint8_t* qd,
                                          const uint8_t* pbuf,
                                          const uint8_t* dsbuf,
                                          float (&dv)[16], float (&dk)[16]) {
  using L = Layout<NK>;
  const uint8_t* tq = qd;
  const uint8_t* tdo = qd + L::kTile;
  const bool tail = L::kSplit && kt == 2;
  const int off = L::kSplit ? kt * NK * 128 : 0;
  const uint64_t ap = sm90::opaque(tail ? sm90::make_desc_mn<64>(pbuf + off)
                                        : sm90::make_desc_mn<128>(pbuf + off));
  const uint64_t ads =
      sm90::opaque(tail ? sm90::make_desc_mn<64>(dsbuf + off)
                        : sm90::make_desc_mn<128>(dsbuf + off));
  const int astep = tail ? 64 : 128;   // 16 rows of the tile, in 16 bytes
  const uint64_t bdo = sm90::opaque(sm90::make_desc_mn<2 * kD>(tdo));
  const uint64_t bq = sm90::opaque(sm90::make_desc_mn<2 * kD>(tq));
  sm90::wgmma_fence();
#pragma unroll
  for (int k = K0; k < K1; ++k) {
    sm90::WgmmaTT<kD>::mma(dv, ap + k * astep, bdo + k * (2 * kD), k != 0);
  }
#pragma unroll
  for (int k = K0; k < K1; ++k) {
    sm90::WgmmaTT<kD>::mma(dk, ads + k * astep, bq + k * (2 * kD), k != 0);
  }
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(dv);
  sm90::fence_regs(dk);
}

// tile kt's dV and dK * scale, keys before N, through their strides
__device__ __forceinline__ void key_store(const Params& p, int kt,
                                          const float (&dv)[16],
                                          const float (&dk)[16],
                                          __nv_bfloat16* dk_win,
                                          __nv_bfloat16* dv_win, int r0,
                                          int c0) {
  const int key = sm90::opaque(64 * kt + r0);
  store_rows(dv_win, p.os[2][1], dv, key, c0, p.N, 1.f);
  store_rows(dk_win, p.os[1][1], dk, key, c0, p.N, p.scale);
}

// this thread's dbias elements (rows row_a and row_a + 8 of S's layout,
// the order of the accumulator) into an (N, N) partial
template <int NK>
__device__ __forceinline__ void write_partial(float* part, const float* db,
                                              int row_a, int c0, int N) {
#pragma unroll
  for (int i = 0; i < NK / 8; ++i) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_a + 8 * r;
      const int col = 8 * i + c0;
      if (row >= N) continue;
      if (col < N) part[row * N + col] = db[4 * i + 2 * r];
      if (col + 1 < N) part[row * N + col + 1] = db[4 * i + 2 * r + 1];
    }
  }
}

template <int NK>
__global__ void __launch_bounds__(kThreads, 1)
    window_attn_bwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_do,
                           const Params p) {
  using L = Layout<NK>;
  constexpr int kTile = L::kTile;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = sm90::align1024(smem_raw);
  uint8_t* bufs = ring + p.stages * L::kStage;
  // split: the dbias sums; alternate: the table
  float4* dbs_all = reinterpret_cast<float4*>(bufs + L::kBufs);
  float* table = reinterpret_cast<float*>(bufs + L::kBufs);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      bufs + L::kBufs + (L::kSplit ? L::kDb : p.N * L::kTs * 4));
  uint64_t* empty = full + kMaxStages;
  // split schedule: one stage, K and V arriving on full[0], then (Q, dO)
  // slot 0 on full[1] and slot 1 on full[2]

  const int N = p.N;
  const int groups = p.H * p.nW;
  const int g = blockIdx.x % groups;
  const int j = g / p.H;
  const int h = g - j * p.H;
  const int chunk = blockIdx.x / groups;
  const int b0 = chunk * p.per_block;
  const int items = min(p.per_block, p.windows - b0);

  if (threadIdx.x == 0) {
    if constexpr (L::kSplit) {
      for (int b = 0; b < 3; ++b) sm90::mbar_init(full + b, 1);
    } else {
      for (int s = 0; s < p.stages; ++s) {
        sm90::mbar_init(full + s, 1);
        sm90::mbar_init(empty + s, 4);   // the consuming warpgroup's warps
      }
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (!L::kSplit && wg == 2) {
    // ---- producer (alternate schedule): window k of the run in stage
    // k mod stages
    sm90::setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      sm90::tma_prefetch_desc(&tm_q);
      sm90::tma_prefetch_desc(&tm_k);
      sm90::tma_prefetch_desc(&tm_v);
      sm90::tma_prefetch_desc(&tm_do);
      sm90::RingPos rp;
#pragma unroll 1
      for (int k = 0; k < items; ++k) {
        const int win = j + p.nW * (b0 + k);
        sm90::mbar_wait(empty + rp.stage, rp.phase ^ 1);
        uint8_t* st = ring + rp.stage * L::kStage;
        sm90::mbar_arrive_expect_tx(full + rp.stage, L::kStage);
        sm90::tma_load_4d(st, &tm_q, full + rp.stage, 0, 0, h, win);
        sm90::tma_load_4d(st + kTile, &tm_do, full + rp.stage, 0, 0, h, win);
        sm90::tma_load_4d(st + 2 * kTile, &tm_k, full + rp.stage, 0, 0, h,
                          win);
        sm90::tma_load_4d(st + 3 * kTile, &tm_v, full + rp.stage, 0, 0, h,
                          win);
        rp.advance(p.stages);
      }
    }
    return;
  }

  // ---- consumers
  if constexpr (!L::kSplit) sm90::setmaxnreg_inc<240>();
  const int t = threadIdx.x & 127;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int r0 = 16 * warp + (lane >> 2);
  const int c0 = 2 * (lane & 3);
  const int nthreads = L::kSplit ? kThreads : 256;
  const float* bias = p.bias + static_cast<long long>(h) * N * N;
  const float* mask =
      p.mask == nullptr ? nullptr : p.mask + static_cast<long long>(j) * N * N;

  // split: warp (wg, warp) owns query rows 64 wg + 16 warp ...; its slot in
  // the table scratch and the dbias sums (warps of rows past N have none)
  const int slot = wg * 4 + warp;
  const bool has_slot = L::kSplit && slot < kSlots && 64 * wg + 16 * warp < N;
  float4* tab = has_slot ? p.tab + (static_cast<long long>(blockIdx.x) *
                                        kSlots + slot) * (NK / 8) * 32
                         : nullptr;
  float4* dbs = has_slot ? dbs_all + slot * (NK / 8) * 32 : nullptr;

  if constexpr (L::kSplit) {
    // the group's table, staged in the P and dS tiles' room (87.5 KB of
    // 90); then the thread's own values, (bias[h] + mask[j]) / scale at its
    // elements of S (rows past N take row N - 1, keys past N are -inf),
    // into the block's scratch in the accumulator's order; its dbias sums
    // zeroed
    float* staged = reinterpret_cast<float*>(bufs);
    static_assert(NK * L::kTs * 4 <= L::kBufs, "the table fits the tiles");
    stage_table(staged, bias, mask, N, L::kTs, nthreads);
    sm90::named_barrier(kTable, nthreads);
    if (has_slot) {
      const float* ta = staged + min(64 * wg + r0, N - 1) * L::kTs;
      const float* tb = staged + min(64 * wg + r0 + 8, N - 1) * L::kTs;
      const float inv_scale = 1.f / p.scale;
#pragma unroll 1
      for (int i = 0; i < NK / 8; ++i) {
        const float2 a = *reinterpret_cast<const float2*>(ta + 8 * i + c0);
        const float2 b = *reinterpret_cast<const float2*>(tb + 8 * i + c0);
        tab[32 * i + lane] = make_float4(a.x * inv_scale, a.y * inv_scale,
                                         b.x * inv_scale, b.y * inv_scale);
        dbs[32 * i + lane] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    sm90::named_barrier(kTable, nthreads);   // the staged table is read
    // the P and dS tiles start at zero (rows that no slice writes stay so)
    uint4* z = reinterpret_cast<uint4*>(bufs);
    for (int e = threadIdx.x; e < L::kBufs / 16; e += nthreads) {
      z[e] = make_uint4(0, 0, 0, 0);
    }
  } else {
    stage_table(table, bias, mask, N, L::kTs, 256);
    uint4* z = reinterpret_cast<uint4*>(bufs);
    for (int e = threadIdx.x; e < L::kBufs / 16; e += 256) {
      z[e] = make_uint4(0, 0, 0, 0);
    }
  }
  sm90::fence_proxy_async();   // the zeroed tiles -> wgmma's reads
  sm90::named_barrier(kTable, nthreads);

  float db[NK / 2];
#pragma unroll
  for (int i = 0; i < NK / 2; ++i) db[i] = 0.f;
  float s[NK / 2];   // S's accumulator

  if constexpr (L::kSplit) {
    uint8_t* pbuf = bufs;
    uint8_t* dsbuf = bufs + L::kP;
    // thread 0 loads window k's K and V (full[0]) once window k - 1's rows
    // are done with them, and its Q and dO into slot k mod 2 (full[1 + k
    // mod 2]) once window k - 2's keys are done with that slot
    const auto load = [&](int k, bool kv) {
      const int win = j + p.nW * (b0 + k);
      uint64_t* bar = full + (kv ? 0 : 1 + (k & 1));
      uint8_t* dst = ring + (kv ? 0 : 2 + 2 * (k & 1)) * kTile;
      sm90::mbar_arrive_expect_tx(bar, 2 * kTile);
      sm90::tma_load_4d(dst, kv ? &tm_k : &tm_q, bar, 0, 0, h, win);
      sm90::tma_load_4d(dst + kTile, kv ? &tm_v : &tm_do, bar, 0, 0, h, win);
    };
    if (threadIdx.x == 0 && items > 0) {
      sm90::tma_prefetch_desc(&tm_q);
      sm90::tma_prefetch_desc(&tm_k);
      sm90::tma_prefetch_desc(&tm_v);
      sm90::tma_prefetch_desc(&tm_do);
      load(0, true);
      load(0, false);
      if (items > 1) load(1, false);
    }
    // warpgroup wg: query rows 64 wg ..., then keys 64 wg ...; the third
    // warpgroup only where N > 128.  S's accumulator holds the thread's
    // table values (over the scale) before each window's product: loaded
    // once here, then again while the keys of the window before run
    const bool active = 64 * wg < N;
    load_table<NK>(s, tab, lane);
#pragma unroll 1
    for (int k = 0; k < items; ++k) {
      const long long win = j + static_cast<long long>(p.nW) * (b0 + k);
      const uint8_t* qd = ring + (2 + 2 * (k & 1)) * kTile;
      sm90::mbar_wait(full, k & 1);
      sm90::mbar_wait(full + 1 + (k & 1), (k >> 1) & 1);
      if (active) {
        row_slice<NK>(p, wg, qd, ring, table, dbs, pbuf, dsbuf, s, db,
                      p.dq + win * p.os[0][0] + h * p.os[0][2], wg, warp, r0,
                      c0);
      }
      sm90::fence_proxy_async();   // st.shared P, dS -> wgmma's reads
      sm90::named_barrier(kRows, kThreads);
      // the rows are done with K and V: the next window's load
      if (threadIdx.x == 0 && k + 1 < items) load(k + 1, true);
      if (active) {
        if (k + 1 < items) load_table<NK>(s, tab, lane);
        float dv[16], dk[16];
        key_steps<NK, 0, NK / 16>(wg, qd, pbuf, dsbuf, dv, dk);
        key_store(p, wg, dv, dk, p.dk + win * p.os[1][0] + h * p.os[1][2],
                  p.dv + win * p.os[2][0] + h * p.os[2][2], r0, c0);
      }
      sm90::named_barrier(kDone, kThreads);   // the tiles are free again
      if (threadIdx.x == 0 && k + 2 < items) load(k + 2, false);
    }
  } else {
    uint8_t* pbuf = bufs + wg * 2 * L::kP;
    uint8_t* dsbuf = pbuf + L::kP;
#pragma unroll 1
    for (int k = wg; k < items; k += 2) {
      const int stage = k % p.stages;
      const uint32_t phase = (k / p.stages) & 1;
      const long long win = j + static_cast<long long>(p.nW) * (b0 + k);
      sm90::mbar_wait(full + stage, phase);
      const uint8_t* st = ring + stage * L::kStage;
      row_slice<NK>(p, 0, st, st + 2 * kTile, table, nullptr, pbuf, dsbuf,
                    s, db, p.dq + win * p.os[0][0] + h * p.os[0][2], wg,
                    warp, r0, c0);
      float dv[16], dk[16];
      key_steps<NK, 0, NK / 16>(0, st, pbuf, dsbuf, dv, dk);
      key_store(p, 0, dv, dk, p.dk + win * p.os[1][0] + h * p.os[1][2],
                p.dv + win * p.os[2][0] + h * p.os[2][2], r0, c0);
      if (lane == 0) sm90::mbar_arrive(empty + stage);
    }
  }

  // this block's (N, N) partial (a warpgroup's own, alternate schedule)
  const int wparts = L::kSplit ? 1 : 2;
  const long long part =
      (static_cast<long long>(chunk) * p.nW + j) * wparts +
      (L::kSplit ? 0 : wg);
  float* dst = p.partial + (part * p.H + h) * N * N;
  if constexpr (L::kSplit) {
    if (has_slot) {
#pragma unroll
      for (int i = 0; i < NK / 8; ++i) {
        const float4 v = dbs[32 * i + lane];
        db[4 * i] = v.x;
        db[4 * i + 1] = v.y;
        db[4 * i + 2] = v.z;
        db[4 * i + 3] = v.w;
      }
      write_partial<NK>(dst, db, 64 * wg + r0, c0, N);
    }
  } else {
    write_partial<NK>(dst, db, r0, c0, N);
  }
}

// dbias[i] = sum over parts c of partial[c][i], in part order
__global__ void dbias_reduce_kernel(const float* __restrict__ partial,
                                    float* __restrict__ dbias,
                                    long long count, int parts) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < count; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float sum = 0.f;
    for (int c = 0; c < parts; ++c) sum += partial[c * count + i];
    dbias[i] = sum;
  }
}

template <int NK>
cudaError_t launch(const Params& p, const CUtensorMap (&maps)[4], int blocks,
                   int parts, float* dbias, cudaStream_t s) {
  auto kernel = window_attn_bwd_kernel<NK>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int smem = fixed_bytes<NK>(p.N) + p.stages * Layout<NK>::kStage;
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  kernel<<<blocks, kThreads, smem, s>>>(maps[0], maps[1], maps[2], maps[3],
                                        p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long count = static_cast<long long>(p.H) * p.N * p.N;
  const int rblocks = static_cast<int>(
      (count + 255) / 256 < 2048 ? (count + 255) / 256 : 2048);
  dbias_reduce_kernel<<<rblocks, 256, 0, s>>>(p.partial, dbias, count,
                                              parts);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, dout: (Bn, N, H, D) views, dq, dk, dv likewise; strides: 21
// element strides, (window, row, head) for q, k, v, dout, dq, dk, dv in
// that order.  bias (H, N, N) fp32; mask (nW, N, N) fp32 or null (then
// nW = 1).  partial is (parts, H, N, N) fp32 scratch, tab the table
// scratch of the split schedule (blocks x 9 x 18 x 32 float4; null below
// N = 65), dbias the (H, N, N) fp32 result.  The plan (keys, per_block,
// stages, parts) is ops/window_attention.py:bwd_plan's.
extern "C" int window_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* dout, void* dq,
    void* dk, void* dv, const void* bias, const void* mask, void* partial,
    void* tab, void* dbias, int Bn, int H, int N, int D, int nW,
    const long long* strides, float scale, int keys, int per_block,
    int stages, int parts, void* stream) {
  const int nk = N <= 16 ? 16 : N <= 32 ? 32 : N <= 64 ? 64 : 144;
  const bool split = nk > 64;
  if (D != kD || N < 1 || N > kMaxN || H < 1 || Bn < 1 || nW < 1 ||
      Bn % nW || (mask == nullptr && nW != 1) || keys != nk ||
      per_block < 1 || (split ? stages != 1
                              : stages < 2 || stages > kMaxStages)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.bias = static_cast<const float*>(bias);
  p.mask = static_cast<const float*>(mask);
  p.partial = static_cast<float*>(partial);
  p.tab = static_cast<float4*>(tab);
  if (split && tab == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  for (int t = 0; t < 3; ++t) {
    for (int e = 0; e < 3; ++e) p.os[t][e] = strides[3 * (4 + t) + e];
  }
  p.scale = scale;
  p.N = N;
  p.H = H;
  p.nW = nW;
  p.windows = Bn / nW;
  p.per_block = per_block;
  p.stages = stages;
  const long long chunks = (p.windows + per_block - 1) / per_block;
  const long long blocks = static_cast<long long>(H) * nW * chunks;
  if (blocks > 0x7fffffffLL || parts != chunks * nW * (split ? 1 : 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* base[4] = {q, k, v, dout};
  CUtensorMap maps[4];
  for (int t = 0; t < 4; ++t) {
    const long long* st = strides + 3 * t;
    if (!sm90::encode_bf16_bhnd(&maps[t], base[t], Bn, H, N, kD, st[0], st[2],
                                st[1], nk)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  float* db = static_cast<float*>(dbias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = static_cast<int>(blocks);
  switch (nk) {
    case 16: return static_cast<int>(launch<16>(p, maps, nb, parts, db, s));
    case 32: return static_cast<int>(launch<32>(p, maps, nb, parts, db, s));
    case 64: return static_cast<int>(launch<64>(p, maps, nb, parts, db, s));
    default: return static_cast<int>(launch<144>(p, maps, nb, parts, db, s));
  }
}
