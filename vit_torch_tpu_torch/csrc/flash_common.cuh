// Helpers shared by the mma.sync kernels (talking_heads.cu and the window
// attention forward and backward): the row padding of their shared tiles,
// bf16 packing, the mma.sync / ldmatrix wrappers, and the A-fragment load
// and bf16 row store of a 16-row slice.  Written for the first flash
// kernels, which no longer use them.  Every definition lives in an
// anonymous namespace so each shared library keeps its own copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kPad = 8;       // bf16 elements (16 bytes) of row padding
constexpr float kLog2e = 1.4426950408889634f;

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
