// CaiT talking-heads attention forward for Hopper (sm_90a), bf16 in / bf16
// out.
//
// Replaces the Pallas TPU kernels vit_torch_tpu/ops/talking_heads.py:
// _kernel (def :58, pallas_call :96, the (B, H, N, D) layout) and
// _kernel_v2 (def :218, pallas_call :272, the head-concatenated (B, N, C)
// layout).  Both compute one function, which these kernels read through
// strides from either layout.  For image b, head j and query row n, with
// the (H, H) fp32 mixing tables wl, ww and the (H,) fp32 biases bl, bw:
//   S_i  = scale * Q_i K_i^T                          (fp32, per head i)
//   S'_j = sum_i wl[i, j] S_i + bl[j]                  (pre-softmax mix)
//   P_j  = softmax of S'_j over the N keys             (exact, fp32)
//   A_j  = bf16(sum_i ww[i, j] P_i + bw[j])            (post-softmax mix)
//   O_j  = A_j V_j                                     (fp32 sum, bf16 out)
// which are the einsum reference's rounding points (_ref_forward: fp32
// scores, fp32 mixes and softmax, the mixed weights rounded to the
// activation dtype for PV).  The kernels stage wl and bl multiplied by
// log2(e) (wl by scale too) and take the softmax in base 2: the same
// function, its fp32 sums associated otherwise.
//
// Bound on an H100 at cait_s24_224 bs32, (B, H, N, D) = (32, 8, 196, 48):
// q, k, v read and o written, 4 B N H D * 2 bytes = 19.3 MB, 5.8 us at
// 3.35 TB/s; the products, 4 B H N^2 D = 1.89 GFLOP, and the two mixes,
// 4 B H^2 N^2 = 0.31 GFLOP, take 2.2 us at 989 TFLOP/s.  But the mixes and
// the softmax are fp32 work on the CUDA cores (H^2 FMAs a score element for
// each mix, one exp a head and pass), not tensor-core work.
//
// Design.  The mixes couple every head at every score element, and the
// post-mix needs every head's normalised P, so a row cannot be finished
// head by head with an online softmax.  wgmma gives every product of one
// shape the same accumulator layout, so a warpgroup that forms S_i for all
// heads over the same 64 query rows and 8 keys holds the same score
// element of every head in the same thread: both mixes are in-thread fp32
// FMAs on registers, with no score planes in shared memory.  What does not
// fit beside them is O: 64 rows of 16 heads of 48 columns are 192 KB of
// accumulators.  So the work is three launches, each done once:
// - talking_heads_mix_kernel<kStats = true> (launch 1) and <false>
//   (launch 2) over (64-row tile, key part, image) blocks of two
//   warpgroups.  Thread 0 loads the rows' Q of every head by one TMA load
//   (a 4-D map over the views' own strides whose box spans the heads:
//   sm90::encode_bf16_bhnd_box; D = 48 is read as a 64-column box whose
//   last 16 columns are zero, D <= 32 as 32 columns) and streams the
//   part's 16-key tiles of K of every head through a ring of mbarrier
//   slots, refilling a slot once both warpgroups have released it (no
//   producer warps, so that ptxas may give a thread 255 registers at 16
//   heads; up to 8 heads two blocks share an SM, within 128 registers and
//   half an SM's shared memory).
//   Warpgroup w takes keys 8 w .. 8 w + 7 of every tile: S_i of every
//   head by wgmma m64n8k16 (K-major tiles, D / 16 k-steps), then the
//   pre-mix of every mixed head.  Launch 1 keeps each thread's running
//   max and sum (base 2) and writes the part's (m, l) of every row and
//   mixed head; launch 2 merges the parts' statistics (in part order),
//   normalises P exactly, runs the post-mix for every output head and
//   writes A_g in bf16 as launch 3's wgmma register fragments.
// - talking_heads_pv_kernel (launch 3) over (64-row tile, head, image)
//   blocks of one warpgroup: A_g's fragments from global memory straight
//   into registers, V_g in 64-key tiles by TMA through a ring, O_g += A_g
//   V_g by sm90::WgmmaRS (V an MN-major B, 16 keys a k-step).
// - Heads past H (the tables padded to MH = 4, 8 or 16 heads with zeros)
//   read zero planes, so every loop is static and no wgmma sits in a
//   branch.  Keys at or past N are masked (S' = -inf, A = 0); rows at or
//   past N read zero and are never stored.
// - Each score product is formed twice (launches 1 and 2) and the pre-mix
//   twice: 3 H^2 N^2 FMAs an image for the mixes, the least that an exact
//   two-pass softmax allows.  The price is A's round trip through global
//   memory: 2 B H N^2 bytes, padded to whole tiles, written and read (27
//   MB each way at the headline, 83 MB at m48_448 (4, 16, 784, 48)).
//
// This replaces the port's first design: one block per 16 query rows and
// image, warp-level m16n8k16 products, K and V re-read from L2 for every
// 16 rows, the mixes from per-head score planes in shared memory.  Its
// device times on an H100 80GB HBM3 at 700 W (chip_smoke): 0.140 ms at
// (32, 8, 196, 48), 0.613 at (4, 16, 784, 48).
//
// Launch 3 reads A from global memory into registers with plain 8-byte
// loads, not TMA: the fragments are wgmma's register operand, stored in
// the order the threads hold them, so each warp's loads are whole 256-byte
// runs and no shared-memory round trip is needed.
//
// C entry point (ctypes): talking_heads_fwd_bf16(...) returns the
// cudaError_t of the launches; it launches on the given stream and does
// not synchronise or allocate.  A plan other than talking_heads_plan's is
// refused.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_sm90.cuh"
#include "sm90.cuh"

namespace {

constexpr int kRows = 64;            // query rows a block
constexpr int kKeys = 16;            // keys a K slot tile (a PV k-step)
// two warpgroups and no producer warps: ptxas allocates within the launch
// bound's share of the register file, counted in whole warpgroups (168 a
// thread for 288 or 384 threads, 255 for 256), and launch 2 needs ~235 at
// 16 heads (128 up to 8 heads, two blocks an SM)
constexpr int kThreads = 256;
constexpr int kSmemMax = 232448;
constexpr int kMaxSlots = 8;
constexpr int kMaxHeads = 16;

struct Params {
  __nv_bfloat16* o;
  const float* wl;  // (H, H), wl[i, j] mixes score head i into j
  const float* bl;  // (H,)
  const float* ww;  // (H, H)
  const float* bw;  // (H,)
  long long os[3];  // o's (batch, head, row) strides
  // element strides of the tables: wl (i, j), ww (i, j), bl, bw; the model
  // passes Linear(H, H) weights transposed, as views
  long long ts[6];
  int H;
  int N;
  int slots;
  int parts;        // key parts of a row tile (launches 1 and 2)
  float scale;
  // scratch: the parts' softmax statistics (m, l) by (image, part, mixed
  // head, row), and A as wgmma register fragments (talking_heads_mix_kernel)
  float2* stats;
  uint2* mix;
};

template <int D, int MH>
struct Layout {
  static constexpr int kCols = D > 32 ? 64 : 32;   // the TMA box's columns
  static constexpr int kRowB = 2 * kCols;           // bytes a tile row
  static constexpr int kQ = MH * kRows * kRowB;     // Q planes
  static constexpr int kSlot = MH * kKeys * kRowB;  // a K tile
  static constexpr int kTables = (2 * MH * MH + 2 * MH) * 4;
  static constexpr int kStats = MH * kRows * 8;  // (m, l) a row and head
  // blocks an SM holds: two up to 8 heads (then the plan keeps the shared
  // memory within half an SM's and a thread within 128 registers), else one
  static constexpr int kBlocksPerSm = MH <= 8 ? 2 : 1;
  static constexpr int kBars = (2 * kMaxSlots + 1) * 8;
  static constexpr int kFixed = 1024 + kQ + kTables + kStats + kBars;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// l * 2^(m - M): a running sum rescaled to a new max M >= m; an empty sum
// (m = -inf) stays 0
__device__ __forceinline__ float rescale(float l, float m, float M) {
  return m == -INFINITY ? 0.f : l * attn::exp2_approx(m - M);
}

template <int D, int MH>
__device__ __forceinline__ uint64_t tile_desc(const uint8_t* tile) {
  return D > 32 ? sm90::make_desc(tile) : sm90::make_desc_sw64(tile);
}

// s[i] = Q_i K_i^T over the block's 64 rows and keys [8 half, 8 half + 8)
// of the slot tile, every head; one commit, waited
template <int D, int MH>
__device__ __forceinline__ void scores(float (&s)[MH][4], const uint8_t* q,
                                       const uint8_t* kt, int half) {
  using L = Layout<D, MH>;
  // heads are kRows (Q) and kKeys (K) rows apart: in 16-byte units
  const uint64_t a0 = sm90::opaque(tile_desc<D, MH>(q));
  const uint64_t b0 =
      sm90::opaque(tile_desc<D, MH>(kt + half * 8 * L::kRowB));
  sm90::wgmma_fence();
#pragma unroll
  for (int i = 0; i < MH; ++i) {
    const uint64_t a = a0 + i * (kRows * L::kRowB / 16);
    const uint64_t b = b0 + i * (kKeys * L::kRowB / 16);
#pragma unroll
    for (int k = 0; k < D / 16; ++k) {
      sm90::Wgmma<8>::mma(s[i], a + 2 * k, b + 2 * k, k != 0);
    }
  }
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < MH; ++i) sm90::fence_regs(s[i]);
}

// x = bl'[j] + sum_i wl'[i, j] s[i], mixed head j over the thread's 4
// elements (the staged tables carry scale and log2(e); wl' is staged
// transposed, so head j's column is contiguous); keys at or past N masked
template <int MH>
__device__ __forceinline__ void premix(float (&x)[4], const float (&s)[MH][4],
                                       const float* wlt, const float* bl,
                                       int j, bool ok0, bool ok1) {
  x[0] = x[1] = x[2] = x[3] = bl[j];
#pragma unroll
  for (int i = 0; i < MH; i += 4) {
    const float4 w = *reinterpret_cast<const float4*>(wlt + j * MH + i);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      x[e] = fmaf(w.x, s[i][e], x[e]);
      x[e] = fmaf(w.y, s[i + 1][e], x[e]);
      x[e] = fmaf(w.z, s[i + 2][e], x[e]);
      x[e] = fmaf(w.w, s[i + 3][e], x[e]);
    }
  }
  if (!ok0) x[0] = x[2] = -INFINITY;
  if (!ok1) x[1] = x[3] = -INFINITY;
}

// Launches 1 and 2 (talking_heads_mix_kernel, kStats true, then false):
// a block takes 64 query rows of image b and the keys of part y of the row
// tile (16-key tiles [y t, y t + t), t = ceil(tiles / parts)); warpgroup w
// takes keys 8 w .. 8 w + 7 of every tile and forms S_i of every head, the
// pre-mix and P_j of every mixed head.  Launch 1 writes each part's running
// max and sum (base 2) of every mixed head's rows; launch 2 merges the
// parts' statistics, normalises P exactly, runs the post-mix for every
// output head and writes A_g rounded to bf16 as the register fragments of
// launch 3's wgmma: for (image, head, row tile, key tile, half w), 128
// threads' (row r0, keys c0, c0 + 1; row r0 + 8, the same keys) pairs, 8
// bytes a thread, so both sides move whole 1 KB runs.
template <int D, int MH, bool kStats>
__global__ void __launch_bounds__(kThreads, Layout<D, MH>::kBlocksPerSm)
    talking_heads_mix_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const Params p) {
  using L = Layout<D, MH>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qt = sm90::align1024(smem_raw);
  uint8_t* ring = qt + L::kQ;
  float* wl = reinterpret_cast<float*>(ring + p.slots * L::kSlot);
  float* ww = wl + MH * MH;   // transposed: ww[g MH + j] = ww[j, g]
  float* bl = ww + MH * MH;
  float* bw = bl + MH;
  float2* st = reinterpret_cast<float2*>(bw + MH);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(
      reinterpret_cast<uint8_t*>(st) + L::kStats);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + kMaxSlots;

  const int H = p.H;
  const int N = p.N;
  const int rt = blockIdx.x;
  const int row0 = rt * kRows;
  const int part = blockIdx.y;
  const int b = blockIdx.z;
  const int rows_pad = gridDim.x * kRows;
  const int tiles = (N + kKeys - 1) / kKeys;
  const int per = (tiles + p.parts - 1) / p.parts;
  const int kt0 = part * per;
  const int steps = min(tiles, kt0 + per) - kt0;

  if (threadIdx.x == 0) {
    sm90::mbar_init(qbar, 1);
    for (int s = 0; s < p.slots; ++s) {
      sm90::mbar_init(full + s, 1);
      sm90::mbar_init(empty + s, kThreads / 32);
    }
    sm90::mbar_init_fence();
  }
  // Q and slot planes of heads past H stay zero (TMA writes H planes)
  if (H < MH) {
    for (int e = threadIdx.x; e < (MH - H) * kRows * L::kRowB / 16;
         e += kThreads) {
      reinterpret_cast<uint4*>(qt + H * kRows * L::kRowB)[e] =
          make_uint4(0, 0, 0, 0);
    }
    for (int s = 0; s < p.slots; ++s) {
      for (int e = threadIdx.x; e < (MH - H) * kKeys * L::kRowB / 16;
           e += kThreads) {
        reinterpret_cast<uint4*>(ring + s * L::kSlot +
                                 H * kKeys * L::kRowB)[e] =
            make_uint4(0, 0, 0, 0);
      }
    }
  }
  // the tables, zero-padded to MH x MH and MH, both transposed (the mix
  // into head r contiguous); wl and bl carry log2(e), wl the scale too
  for (int i = threadIdx.x; i < MH * MH; i += kThreads) {
    const int r = i / MH;
    const int c = i - r * MH;
    const bool in = r < H && c < H;
    wl[i] = in ? p.wl[c * p.ts[0] + r * p.ts[1]] * (p.scale * attn::kLog2e)
               : 0.f;
    ww[i] = in ? p.ww[c * p.ts[2] + r * p.ts[3]] : 0.f;
  }
  for (int i = threadIdx.x; i < MH; i += kThreads) {
    bl[i] = i < H ? p.bl[i * p.ts[4]] * attn::kLog2e : 0.f;
    bw[i] = i < H ? p.bw[i * p.ts[5]] : 0.f;
  }
  if constexpr (!kStats) {
    // the row tile's statistics over all keys: the parts' (m, l) merged in
    // part order, kept as (m, 1 / l)
    for (int e = threadIdx.x; e < MH * kRows; e += kThreads) {
      const int j = e / kRows;
      const int r = e - j * kRows;
      float m = -INFINITY;
      float l = 0.f;
      for (int q = 0; q < p.parts; ++q) {
        const float2 s = p.stats[(static_cast<long long>(b * p.parts + q) *
                                      MH + j) * rows_pad + row0 + r];
        const float M = fmaxf(m, s.x);
        l = rescale(l, m, M) + rescale(s.y, s.x, M);
        m = M;
      }
      st[e] = make_float2(m, 1.f / l);
    }
  }
  sm90::fence_proxy_async();   // the zeroed planes -> wgmma's reads
  __syncthreads();

  const auto load = [&](int n) {
    const int slot = n % p.slots;
    sm90::mbar_arrive_expect_tx(full + slot, H * kKeys * L::kRowB);
    sm90::tma_load_4d(ring + slot * L::kSlot, &tm_k, full + slot, 0,
                      (kt0 + n) * kKeys, 0, b);
  };
  if (threadIdx.x == 0) {
    sm90::tma_prefetch_desc(&tm_q);
    sm90::tma_prefetch_desc(&tm_k);
    sm90::mbar_arrive_expect_tx(qbar, H * kRows * L::kRowB);
    sm90::tma_load_4d(qt, &tm_q, qbar, 0, row0, 0, b);
    for (int n = 0; n < p.slots && n < steps; ++n) load(n);
  }
  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x & 127;
  const int lane = t & 31;
  const int r0 = 16 * (t >> 5) + (lane >> 2);
  const int c0 = 2 * (lane & 3);
  sm90::mbar_wait(qbar, 0);

  sm90::RingPos rp;
  if constexpr (kStats) {
    float m[MH][2], l[MH][2];
#pragma unroll
    for (int j = 0; j < MH; ++j) {
      m[j][0] = m[j][1] = -INFINITY;
      l[j][0] = l[j][1] = 0.f;
    }
#pragma unroll 1
    for (int n = 0; n < steps; ++n) {
      sm90::mbar_wait(full + rp.stage, rp.phase);
      float s[MH][4];
      scores<D, MH>(s, qt, ring + rp.stage * L::kSlot, wg);
      if (lane == 0) sm90::mbar_arrive(empty + rp.stage);
      if (threadIdx.x == 0 && n + p.slots < steps) {
        sm90::mbar_wait(empty + rp.stage, rp.phase);
        load(n + p.slots);
      }
      rp.advance(p.slots);
      const int key = (kt0 + n) * kKeys + 8 * wg + c0;
#pragma unroll
      for (int j = 0; j < MH; ++j) {
        if (j >= H) continue;
        float x[4];
        premix<MH>(x, s, wl, bl, j, key < N, key + 1 < N);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float mx = fmaxf(x[2 * r], x[2 * r + 1]);
          if (mx == -INFINITY) continue;
          if (mx > m[j][r]) {
            l[j][r] = rescale(l[j][r], m[j][r], mx);
            m[j][r] = mx;
          }
          l[j][r] += attn::exp2_approx(x[2 * r] - m[j][r]) +
                     attn::exp2_approx(x[2 * r + 1] - m[j][r]);
        }
      }
    }
    // the quad's columns, then the two warpgroups' halves, into this
    // part's (m, l) of each row
#pragma unroll
    for (int j = 0; j < MH; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          const float m2 = __shfl_xor_sync(0xffffffffu, m[j][r], off);
          const float l2 = __shfl_xor_sync(0xffffffffu, l[j][r], off);
          const float M = fmaxf(m[j][r], m2);
          l[j][r] = rescale(l[j][r], m[j][r], M) + rescale(l2, m2, M);
          m[j][r] = M;
        }
        if (wg == 1 && c0 == 0) {
          st[j * kRows + r0 + 8 * r] = make_float2(m[j][r], l[j][r]);
        }
      }
    }
    sm90::named_barrier(1, kThreads);
    if (wg == 0 && c0 == 0) {
#pragma unroll
      for (int j = 0; j < MH; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 o = st[j * kRows + r0 + 8 * r];
          const float M = fmaxf(m[j][r], o.x);
          p.stats[(static_cast<long long>(b * p.parts + part) * MH + j) *
                      rows_pad + row0 + r0 + 8 * r] =
              make_float2(M, rescale(l[j][r], m[j][r], M) +
                                 rescale(o.y, o.x, M));
        }
      }
    }
  } else {
    // A_g fragments of this block: head g's run is g_stride apart
    const long long g_stride =
        static_cast<long long>(gridDim.x) * tiles * 2 * 128;
    uint2* dst = p.mix +
                 ((static_cast<long long>(b) * H * gridDim.x + rt) * tiles +
                  kt0) * 2 * 128 + wg * 128 + t;
#pragma unroll 1
    for (int n = 0; n < steps; ++n) {
      sm90::mbar_wait(full + rp.stage, rp.phase);
      float s[MH][4];
      scores<D, MH>(s, qt, ring + rp.stage * L::kSlot, wg);
      if (lane == 0) sm90::mbar_arrive(empty + rp.stage);
      if (threadIdx.x == 0 && n + p.slots < steps) {
        sm90::mbar_wait(empty + rp.stage, rp.phase);
        load(n + p.slots);
      }
      rp.advance(p.slots);
      const int key = (kt0 + n) * kKeys + 8 * wg + c0;
      const bool ok0 = key < N;
      const bool ok1 = key + 1 < N;
      // P_j = 2^(x_j - m_j) / l_j, exact, every mixed head (zero past H)
      float pj[MH][4];
#pragma unroll
      for (int j = 0; j < MH; ++j) {
        float x[4];
        premix<MH>(x, s, wl, bl, j, ok0, ok1);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 ml = st[j * kRows + r0 + 8 * r];
          pj[j][2 * r] = j < H ? attn::exp2_approx(x[2 * r] - ml.x) * ml.y
                               : 0.f;
          pj[j][2 * r + 1] =
              j < H ? attn::exp2_approx(x[2 * r + 1] - ml.x) * ml.y : 0.f;
        }
      }
      // A_g = bw[g] + sum_j ww[j, g] P_j for every output head, bf16
#pragma unroll
      for (int g = 0; g < MH; ++g) {
        if (g >= H) break;
        float a[4];
        a[0] = a[1] = a[2] = a[3] = bw[g];
#pragma unroll
        for (int j = 0; j < MH; j += 4) {
          const float4 w = *reinterpret_cast<const float4*>(ww + g * MH + j);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            a[e] = fmaf(w.x, pj[j][e], a[e]);
            a[e] = fmaf(w.y, pj[j + 1][e], a[e]);
            a[e] = fmaf(w.z, pj[j + 2][e], a[e]);
            a[e] = fmaf(w.w, pj[j + 3][e], a[e]);
          }
        }
        dst[g * g_stride + n * 2 * 128] =
            make_uint2(pack_bf16(ok0 ? a[0] : 0.f, ok1 ? a[1] : 0.f),
                       pack_bf16(ok0 ? a[2] : 0.f, ok1 ? a[3] : 0.f));
      }
    }
  }
}

// Launch 3: O_g = A_g V_g for one (64-row tile, head g, image b) a block of
// one warpgroup: A from launch 2's fragments straight into wgmma's
// registers, V in 64-key tiles by TMA through a ring that thread 0 refills.
constexpr int kPvKeys = 64;
constexpr int kPvSlots = 4;
constexpr int kPvThreads = 128;

template <int D>
struct PvLayout {
  static constexpr int kRowB = D > 32 ? 128 : 64;
  static constexpr int kSlot = kPvKeys * kRowB;
  static constexpr int kSmem = 1024 + kPvSlots * kSlot + 2 * kPvSlots * 8;
};

template <int D>
__global__ void __launch_bounds__(kPvThreads)
    talking_heads_pv_kernel(const __grid_constant__ CUtensorMap tm_v,
                            const Params p) {
  using L = PvLayout<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = sm90::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kPvSlots * L::kSlot);
  uint64_t* empty = full + kPvSlots;
  const int N = p.N;
  const int rt = blockIdx.x;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int tiles = (N + kKeys - 1) / kKeys;
  const int steps = (N + kPvKeys - 1) / kPvKeys;
  const int t = threadIdx.x;
  const int lane = t & 31;

  const auto load = [&](int n) {
    const int slot = n % kPvSlots;
    sm90::mbar_arrive_expect_tx(full + slot, L::kSlot);
    sm90::tma_load_4d(ring + slot * L::kSlot, &tm_v, full + slot, 0,
                      n * kPvKeys, g, b);
  };
  if (t == 0) {
    for (int s = 0; s < kPvSlots; ++s) {
      sm90::mbar_init(full + s, 1);
      sm90::mbar_init(empty + s, kPvThreads / 32);
    }
    sm90::mbar_init_fence();
    sm90::tma_prefetch_desc(&tm_v);
    for (int n = 0; n < kPvSlots && n < steps; ++n) load(n);
  }
  __syncthreads();

  const uint2* af = p.mix +
                    ((static_cast<long long>(b) * p.H + g) * gridDim.x + rt) *
                        tiles * 2 * 128 + t;
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  sm90::RingPos rp;
#pragma unroll 1
  for (int n = 0; n < steps; ++n) {
    // 16-key k-steps past the last tile take zero A (and V reads zeros)
    uint32_t pk[kPvKeys / kKeys][4];
#pragma unroll
    for (int kk = 0; kk < kPvKeys / kKeys; ++kk) {
      const int kt = n * (kPvKeys / kKeys) + kk;
      uint2 lo = make_uint2(0, 0);
      uint2 hi = make_uint2(0, 0);
      if (kt < tiles) {
        lo = af[kt * 2 * 128];
        hi = af[(kt * 2 + 1) * 128];
      }
      pk[kk][0] = lo.x;
      pk[kk][1] = lo.y;
      pk[kk][2] = hi.x;
      pk[kk][3] = hi.y;
    }
    sm90::mbar_wait(full + rp.stage, rp.phase);
    const uint64_t bv = sm90::opaque(
        sm90::make_desc_mn<L::kRowB>(ring + rp.stage * L::kSlot));
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kPvKeys / kKeys; ++kk) {
      // K by 16 keys adds 16 rows of kRowB bytes
      sm90::WgmmaRS<D>::mma_tb(o, pk[kk], bv + kk * L::kRowB, 1);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < kPvKeys / kKeys; ++kk) sm90::fence_regs(pk[kk]);
    if (lane == 0) sm90::mbar_arrive(empty + rp.stage);
    if (t == 0 && n + kPvSlots < steps) {
      sm90::mbar_wait(empty + rp.stage, rp.phase);
      load(n + kPvSlots);
    }
    rp.advance(kPvSlots);
  }

  // O_g rows, bf16, through o's strides
  const int r0 = 16 * (t >> 5) + (lane >> 2);
  const int c0 = 2 * (lane & 3);
  __nv_bfloat16* ob = p.o + b * p.os[0] + g * p.os[1];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = rt * kRows + r0 + 8 * r;
    if (row >= N) continue;
    __nv_bfloat16* out = ob + row * p.os[2];
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      *reinterpret_cast<uint32_t*>(out + 8 * i + c0) =
          pack_bf16(o[4 * i + 2 * r], o[4 * i + 2 * r + 1]);
    }
  }
}

template <int D, int MH>
cudaError_t launch(const Params& p, const CUtensorMap (&maps)[3], int B,
                   int smem, cudaStream_t s) {
  auto stats = talking_heads_mix_kernel<D, MH, true>;
  auto mix = talking_heads_mix_kernel<D, MH, false>;
  auto pv = talking_heads_pv_kernel<D>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        stats, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(
          mix, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    }
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(
          pv, cudaFuncAttributeMaxDynamicSharedMemorySize,
          PvLayout<D>::kSmem);
    }
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int tiles = (p.N + kKeys - 1) / kKeys;
  const int per = (tiles + p.parts - 1) / p.parts;
  using L = Layout<D, MH>;
  if (smem != L::kFixed + p.slots * L::kSlot ||
      smem > (L::kBlocksPerSm == 2 ? kSmemMax / 2 - 512 : kSmemMax) ||
      p.parts > tiles || (p.parts - 1) * per >= tiles ||
      p.stats == nullptr || p.mix == nullptr) {
    return cudaErrorInvalidValue;
  }
  const int row_tiles = (p.N + kRows - 1) / kRows;
  const dim3 grid(row_tiles, p.parts, B);
  stats<<<grid, kThreads, smem, s>>>(maps[0], maps[1], p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mix<<<grid, kThreads, smem, s>>>(maps[0], maps[1], p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  pv<<<dim3(row_tiles, p.H, B), kPvThreads, PvLayout<D>::kSmem, s>>>(maps[2],
                                                                     p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(const Params& p, const CUtensorMap (&maps)[3], int B,
                     int smem, cudaStream_t s) {
  if (p.H <= 4) return launch<D, 4>(p, maps, B, smem, s);
  if (p.H <= 8) return launch<D, 8>(p, maps, B, smem, s);
  return launch<D, 16>(p, maps, B, smem, s);
}

}  // namespace

// q, k, v, o: (B, H, N, D) views by element strides (strides[3 t + 0..2] =
// batch, head, row of tensor t in q, k, v, o); the tables through
// table_strides (wl (i, j), ww (i, j), bl, bw).  plan: ring slots, key
// parts, launches 1 and 2's shared bytes
// (ops/talking_heads.py:talking_heads_plan).  Scratch: stats, (B, parts,
// MH, row tiles x 64) float2; mix, the A fragments, (B, H, row tiles x 64,
// 16-key tiles x 16) bf16.
extern "C" int talking_heads_fwd_bf16(const void* q, const void* k,
                                      const void* v, void* o, const void* wl,
                                      const void* bl, const void* ww,
                                      const void* bw, int B, int H, int N,
                                      int D, const long long* strides,
                                      const long long* table_strides,
                                      float scale, const int* plan,
                                      void* stats, void* mix, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || H > kMaxHeads || N < 1 ||
      plan[0] < 2 || plan[0] > kMaxSlots || plan[1] < 1 ||
      plan[1] > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.wl = static_cast<const float*>(wl);
  p.bl = static_cast<const float*>(bl);
  p.ww = static_cast<const float*>(ww);
  p.bw = static_cast<const float*>(bw);
  for (int i = 0; i < 3; ++i) p.os[i] = strides[9 + i];
  for (int i = 0; i < 6; ++i) p.ts[i] = table_strides[i];
  p.H = H;
  p.N = N;
  p.slots = plan[0];
  p.parts = plan[1];
  p.scale = scale;
  p.stats = static_cast<float2*>(stats);
  p.mix = static_cast<uint2*>(mix);
  const int cols = D > 32 ? 64 : 32;
  const void* base[3] = {q, k, v};
  // Q: 64 rows of every head; K: 16 keys of every head; V: 64 keys of one
  // head
  const int rows[3] = {kRows, kKeys, kPvKeys};
  const int heads[3] = {H, H, 1};
  CUtensorMap maps[3];
  for (int t = 0; t < 3; ++t) {
    const long long* st = strides + 3 * t;
    if (!sm90::encode_bf16_bhnd_box(&maps[t], base[t], B, H, N, D, st[0],
                                    st[1], st[2], cols, rows[t], heads[t])) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int smem = plan[2];
  switch (D) {
    case 16:
      return static_cast<int>(launch_d<16>(p, maps, B, smem, s));
    case 32:
      return static_cast<int>(launch_d<32>(p, maps, B, smem, s));
    case 48:
      return static_cast<int>(launch_d<48>(p, maps, B, smem, s));
    case 64:
      return static_cast<int>(launch_d<64>(p, maps, B, smem, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
