// Helpers shared by the flash-attention forward and backward kernels:
// tile sizes, bf16 packing, the mma.sync / ldmatrix wrappers and the
// zero-filling tile copy.  Included by flash_attention_fwd.cu and
// flash_attention_bwd.cu; every definition lives in an anonymous namespace
// so each shared library keeps its own copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;   // query rows (or keys) per block
constexpr int kBlockN = 64;   // rows per streamed tile
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kPad = 8;       // bf16 elements (16 bytes) of row padding
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kBlockM == kBlockN, "load_tile copies 64-row tiles");

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a * b for one m16n8k16 tile, bf16 inputs, fp32 accumulation
__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* smem_ptr) {
  uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem_ptr));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Copies rows [row0, row0 + kBlockM) of one (b, h) slice into a padded shared
// tile, 16 bytes per thread per step; rows >= N are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16 (*dst)[D + kPad],
                                          const __nv_bfloat16* src,
                                          long long row_stride, int row0,
                                          int N) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < kBlockM * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 8;
    int4 val = make_int4(0, 0, 0, 0);
    if (row0 + r < N) {
      val = *reinterpret_cast<const int4*>(src + (row0 + r) * row_stride + col);
    }
    *reinterpret_cast<int4*>(&dst[r][col]) = val;
  }
}

// The A-fragments of a 16-row slice of a shared tile (rows r0 and r0 + 8 of
// this thread), k-steps of 16 along D.
template <int D>
__device__ __forceinline__ void load_a_frags(uint32_t f[D / 16][4],
                                             const __nv_bfloat16 (*s)[D + kPad],
                                             int r0, int t) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    f[kk][0] = lds32(&s[r0][kk * 16 + 2 * t]);
    f[kk][1] = lds32(&s[r0 + 8][kk * 16 + 2 * t]);
    f[kk][2] = lds32(&s[r0][kk * 16 + 8 + 2 * t]);
    f[kk][3] = lds32(&s[r0 + 8][kk * 16 + 8 + 2 * t]);
  }
}

// acc[nt] = A * B^T over D for 8 n-tiles of 8 rows of a shared tile: the
// 16 x 64 product of this warp's A rows with 64 rows of `s`.
template <int D>
__device__ __forceinline__ void mma_abt(float acc[kBlockN / 8][4],
                                        const uint32_t a[D / 16][4],
                                        const __nv_bfloat16 (*s)[D + kPad],
                                        int g, int t) {
#pragma unroll
  for (int nt = 0; nt < kBlockN / 8; ++nt) {
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t b0 = lds32(&s[nt * 8 + g][kk * 16 + 2 * t]);
      const uint32_t b1 = lds32(&s[nt * 8 + g][kk * 16 + 8 + 2 * t]);
      mma_bf16_16816(acc[nt], a[kk], b0, b1);
    }
  }
}

// acc += P * S for a 16 x 64 fp32 P in accumulator layout (rounded to bf16
// here) and a 64 x D shared tile S read through ldmatrix.trans.
template <int D>
__device__ __forceinline__ void mma_pv(float acc[D / 8][4],
                                       const float p[kBlockN / 8][4],
                                       const __nv_bfloat16 (*s)[D + kPad],
                                       int lane) {
#pragma unroll
  for (int kk = 0; kk < kBlockN / 16; ++kk) {
    uint32_t a[4];
    a[0] = pack_bf16x2(p[2 * kk][0], p[2 * kk][1]);
    a[1] = pack_bf16x2(p[2 * kk][2], p[2 * kk][3]);
    a[2] = pack_bf16x2(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    a[3] = pack_bf16x2(p[2 * kk + 1][2], p[2 * kk + 1][3]);
    const int row = kk * 16 + (lane & 15);
#pragma unroll
    for (int dt = 0; dt < D / 8; dt += 2) {
      uint32_t bv[4];
      ldmatrix_x4_trans(bv, &s[row][dt * 8 + (lane >> 4) * 8]);
      mma_bf16_16816(acc[dt], a, bv[0], bv[1]);
      mma_bf16_16816(acc[dt + 1], a, bv[2], bv[3]);
    }
  }
}

// Writes this thread's two rows of a 16 x D fp32 accumulator as bf16,
// scaled by `mul[0]` / `mul[1]`; rows >= N are skipped.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst,
                                           long long row_stride,
                                           const float acc[D / 8][4],
                                           int row_a, int N, int t,
                                           const float mul[2]) {
  const int row_b = row_a + 8;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (row_a < N) {
      *reinterpret_cast<uint32_t*>(dst + row_a * row_stride + col) =
          pack_bf16x2(acc[dt][0] * mul[0], acc[dt][1] * mul[0]);
    }
    if (row_b < N) {
      *reinterpret_cast<uint32_t*>(dst + row_b * row_stride + col) =
          pack_bf16x2(acc[dt][2] * mul[1], acc[dt][3] * mul[1]);
    }
  }
}

}  // namespace
