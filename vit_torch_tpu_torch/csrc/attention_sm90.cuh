// The attention loop that the fused attention block (attn_block.cu, B3 and
// B4) and the flash-attention forward (flash_attention_fwd.cu) share: one
// consumer warpgroup's 64 query rows of one head against the key/value
// tiles that a producer streams through an mbarrier ring, with the online
// softmax in base 2 and the two consumer warpgroups taking turns to issue
// their products (ping-pong, FA3's schedule).  The flash backward takes
// exp2_approx and kLog2e from it.
//
// A key/value tile is 64 keys of one head, K-major (D contiguous) in the
// 128-byte swizzle at D = 64 and the 64-byte one at D = 32: the keys are
// S = Q K^T's B operand as they stand and P V's B operand as an MN-major
// tile (sm90.cuh's layout note).  Needs sm90.cuh.

#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace attn {

constexpr int kKeys = 64;   // keys a tile
constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the SFU (ex2.approx.ftz: 2 ulp, far below bf16's resolution);
// exp2f without fast math adds range handling around the same instruction
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The masks and one step of the online softmax in base 2 over a 64 x 64
// score tile in wgmma's accumulator layout (thread t holds rows r and
// r + 8, columns 8 i + c0 + {0, 1}): scores of keys outside the row's
// image [key_lo, key_hi) are dropped; the running max m and sum l of each
// row advance (l adds the unrounded exp), alpha rescales the previous O,
// and pe = exp2(scale s - m), unrounded, is what pack_p rounds for P V.
// s is read once, after the wait that retired its wgmma (read_regs: the
// P V wgmma may still run).  The scale is positive, so the row max is
// taken over the raw scores and scaled once; a tile whose 64 keys all lie
// in both rows' ranges (every tile of B3 but an image's last) skips the
// per-column tests.
__device__ __forceinline__ void softmax_tile(
    const float (&s)[32], int k0, const int (&key_lo)[2],
    const int (&key_hi)[2], int c0, float scale_log2, float (&m_run)[2],
    float (&l_run)[2], float (&alpha)[2], float (&pe)[32]) {
  float x[32];
  sm90::read_regs(x, s);
  const bool whole = k0 >= key_lo[0] && k0 + 64 <= key_hi[0] &&
                     k0 >= key_lo[1] && k0 + 64 <= key_hi[1];
  if (!whole) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = k0 + 8 * (i >> 2) + c0 + (i & 1);
      const int r = (i >> 1) & 1;
      if (col < key_lo[r] || col >= key_hi[r]) x[i] = -INFINITY;
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x[i]);
  }
  float m_use[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // the 4 threads of a quad share a row
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m_run[r], mx[r] * scale_log2);
    // a row with no key yet keeps P = 0 instead of exp(-inf + inf)
    m_use[r] = m_new == -INFINITY ? 0.f : m_new;
    alpha[r] = exp2_approx(m_run[r] - m_use[r]);
    m_run[r] = m_new;
    l_run[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1;
    pe[i] = exp2_approx(fmaf(x[i], scale_log2, -m_use[r]));
    l_run[r] += pe[i];
  }
}

// A 64 x 64 fp32 tile in the accumulator layout, rounded to bf16 and
// packed as the register A of a wgmma whose k-step kk is the tile's
// columns 16 kk to 16 kk + 15 (sm90::WgmmaRS); pa[kk][0] and pa[kk][2]
// hold row r, pa[kk][1] and pa[kk][3] row r + 8.  In the attention loop it
// is called only once the previous P V has retired: packing into registers
// that a wgmma may still read serialises the pipeline (ptxas C7513), which
// is why the softmax hands over fp32 pe.
__device__ __forceinline__ void pack_p(const float (&pe)[32],
                                       uint32_t (&pa)[4][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(pe[4 * i], pe[4 * i + 1]);
    const __nv_bfloat162 hi =
        __floats2bfloat162_rn(pe[4 * i + 2], pe[4 * i + 3]);
    pa[i >> 1][2 * (i & 1)] = *reinterpret_cast<const uint32_t*>(&lo);
    pa[i >> 1][2 * (i & 1) + 1] = *reinterpret_cast<const uint32_t*>(&hi);
  }
}

// The key/value ring: stage s at base + s * stage_bytes, its full and
// empty mbarriers (one arrival a consumer warp empties a stage).
struct KvRing {
  const uint8_t* base;
  int stage_bytes;
  int stages;
  uint64_t* full;
  uint64_t* empty;
};

// One head of one consumer warpgroup: o (unnormalised), m_run and l_run
// of its 64 query rows over n_kt key tiles from ring position rp (which
// advances past them; each stage is released).  dq describes the rows' Q
// (K-major, D columns); a stage holds the warpgroup's key tile at kv_off
// and its value tile right after it.  Keys are numbered from k_lo, the
// first tile's first key; each of the thread's two rows takes the keys in
// [key_lo, key_hi).
//
// Ping-pong: the consumer warpgroups take turns, on named barriers turn +
// wg, to issue their wgmmas, so that one's softmax on the SFU overlaps the
// other's products on the tensor cores; over a software pipeline (S of
// tile kt + 1 is issued with P V of tile kt, and the softmax of kt + 1
// runs while P V of kt is in flight).  Each head takes n_kt + 1 turns in
// either warpgroup (head_idle takes them for a warpgroup with no rows).
// Every wgmma is issued on a path all of the warpgroup takes (a wgmma
// under a branch ptxas cannot prove uniform is serialised: C7520), so the
// first and last tiles are peeled off the loop; S is read, not rewritten,
// while P V runs, and P is handed over in fp32 and packed after the wait
// (C7513).
template <int D>
__device__ __forceinline__ void head_pingpong(
    uint64_t dq, const KvRing& ring, int kv_off, sm90::RingPos& rp,
    int n_kt, int k_lo, const int (&key_lo)[2], const int (&key_hi)[2],
    int c0, int lane, float scale_log2, int turn, int wg, float (&o)[D / 2],
    float (&m_run)[2], float (&l_run)[2]) {
  static_assert(D == 32 || D == 64, "head dim 32 or 64");
  constexpr int kKV = kKeys * D * 2;   // one K or V tile
  // S = Q K^T of the key tile in stage `st`: 64 rows x 64 keys
  auto issue_s = [&](float (&s)[32], int st) {
    const uint8_t* k_tile = ring.base + st * ring.stage_bytes + kv_off;
    const uint64_t dk = D == 64 ? sm90::make_desc(k_tile)
                                : sm90::make_desc_sw64(k_tile);
#pragma unroll
    for (int k = 0; k < D / 16; ++k) {
      sm90::Wgmma<64>::mma(s, dq + 2 * k, dk + 2 * k, k != 0);
    }
  };
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  m_run[0] = m_run[1] = -INFINITY;
  l_run[0] = l_run[1] = 0.f;
  float s[32], alpha[2], pe[32];
  uint32_t pa[4][4];
  // O += P V of the key/value tile in stage `st`: 16 keys a k-step, 16
  // rows of 2 D bytes of V
  auto issue_pv = [&](int st) {
    const uint64_t dv = sm90::make_desc_mn<2 * D>(
        ring.base + st * ring.stage_bytes + kv_off + kKV);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      sm90::WgmmaRS<D>::mma_tb(o, pa[kk], dv + kk * (2 * D), 1);
    }
  };
  auto rescale_o = [&]() {
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      o[4 * i] *= alpha[0];
      o[4 * i + 1] *= alpha[0];
      o[4 * i + 2] *= alpha[1];
      o[4 * i + 3] *= alpha[1];
    }
  };
  sm90::mbar_wait(ring.full + rp.stage, rp.phase);
  sm90::named_barrier(turn + wg, 256);
  sm90::wgmma_fence();
  issue_s(s, rp.stage);
  sm90::wgmma_commit();
  sm90::named_barrier_arrive(turn + 1 - wg, 256);
  sm90::wgmma_wait<0>();
  softmax_tile(s, k_lo, key_lo, key_hi, c0, scale_log2, m_run, l_run, alpha,
               pe);
  pack_p(pe, pa);
#pragma unroll 1
  for (int kt = 0; kt + 1 < n_kt; ++kt) {
    sm90::RingPos nxt = rp;
    nxt.advance(ring.stages);
    rescale_o();
    sm90::mbar_wait(ring.full + nxt.stage, nxt.phase);
    sm90::named_barrier(turn + wg, 256);
    sm90::wgmma_fence();
    issue_s(s, nxt.stage);
    sm90::wgmma_commit();
    issue_pv(rp.stage);
    sm90::wgmma_commit();
    sm90::named_barrier_arrive(turn + 1 - wg, 256);
    sm90::wgmma_wait<1>();   // S of tile kt + 1 (P V may still run)
    softmax_tile(s, k_lo + (kt + 1) * kKeys, key_lo, key_hi, c0, scale_log2,
                 m_run, l_run, alpha, pe);
    sm90::wgmma_wait<0>();
    // o, S's accumulator and P's registers stay reserved up to here, so
    // that the softmax's registers do not take theirs
    sm90::fence_regs(o);
    sm90::fence_regs(s);
#pragma unroll
    for (int a = 0; a < 4; ++a) sm90::fence_regs(pa[a]);
    if (lane == 0) sm90::mbar_arrive(ring.empty + rp.stage);
    pack_p(pe, pa);
    rp = nxt;
  }
  rescale_o();
  sm90::named_barrier(turn + wg, 256);
  sm90::wgmma_fence();
  issue_pv(rp.stage);
  sm90::wgmma_commit();
  sm90::named_barrier_arrive(turn + 1 - wg, 256);
  sm90::wgmma_wait<0>();
  sm90::fence_regs(o);
  if (lane == 0) sm90::mbar_arrive(ring.empty + rp.stage);
  rp.advance(ring.stages);
}

// The n_kt + 1 turns of a head for a warpgroup that has no rows of it:
// each stage is waited for and released, and the turns are kept.
__device__ __forceinline__ void head_idle(const KvRing& ring,
                                          sm90::RingPos& rp, int n_kt,
                                          int lane, int turn, int wg) {
#pragma unroll 1
  for (int kt = 0; kt <= n_kt; ++kt) {
    if (kt < n_kt) sm90::mbar_wait(ring.full + rp.stage, rp.phase);
    sm90::named_barrier(turn + wg, 256);
    sm90::named_barrier_arrive(turn + 1 - wg, 256);
    if (kt < n_kt) {
      if (lane == 0) sm90::mbar_arrive(ring.empty + rp.stage);
      rp.advance(ring.stages);
    }
  }
}

}  // namespace attn
