// The fused transformer MLP for Hopper (sm_90a):
//   out = bf16(gelu(x W1^T + b1) W2^T + b2),  one launch, bf16 in and out,
//   fp32 accumulation; the (T, Hd) hidden activation never leaves the SM.
//
// Replaces the Pallas TPU kernel vit_torch_tpu/ops/fused_mlp.py:_kernel
// ("B12").  Rounding points are _kernel's: x W1 accumulates in fp32, b1 is
// added in fp32, GELU runs in fp32 (the exact erf form), h is rounded once
// to bf16; h W2 accumulates in fp32, b2 is added in fp32, one rounding.
// GELU uses erff, which differs from the TPU kernel's Abramowitz-Stegun
// polynomial (|err| <= 1.5e-7) far below bf16 resolution (2^-8).
//
// The TPU kernel held W1 and W2 resident in VMEM (9.4 MB at C = 768,
// Hd = 3072) and the whole (tb, Hd) hidden tile beside them.  An SM holds
// neither, so on Hopper a block owns BM = 64 token rows and one output
// slab of BN columns (BN = 128, 256 or 384, from Co) and walks the hidden
// dimension in chunks of 64:
//   1. h = x[rows] W1[chunk]^T over k-steps of 64, x and W1 tiles through
//      a 3-stage cp.async ring, mma.sync.m16n8k16 bf16 -> fp32;
//   2. h = bf16(gelu(h + b1)) into shared memory (64 x 64);
//   3. acc += h W2[slab, chunk]^T, the W2 tile (BN x 64) double-buffered
//      and fetched with the ring's cp.async groups one chunk ahead;
// then out[rows, slab] = bf16(acc + b2), each output element written once.
// Where Co needs more than one slab (Co > 384), every slab recomputes fc1
// for its rows: the recompute factor is ceil(Co / 384) on fc1 (2 at
// DeiT-base, C = Co = 768), so the kernel does (slabs + 1) / 2 times the
// function's operations (1.5x at DeiT-base).  The accumulator of a 384-wide
// slab is 96 fp32 registers a thread; a whole Co = 768 row would not fit.
//
// Bound: 2 T C Hd + 2 T Hd Co operations against x and out once, W1 and
// W2 once.  At DeiT-base bs32 (T = 6336, C = Co = 768, Hd = 3072) that is
// 59.8 GFLOP against 28.9 MB: bound by operations, 60 us at 989 TFLOP/s.
// At Swin stage 1 (C = 128) it is nearer the byte bound.  This version has
// no TMA, wgmma or warp specialisation: 8 warps a block, one block an SM
// at BN = 384 (171 KB of shared memory).
//
// C entry point (ctypes): fused_mlp_bf16(...) returns the cudaError_t of
// the launch; it launches on the given stream, does not synchronise and
// allocates nothing.  x (T, C), W1 (Hd, C), W2 (Co, Hd) are row-major
// (nn.Linear layout), b1 (Hd) and b2 (Co) may be null, out (T, Co).
// C must be a multiple of 64 and at least 128 (two k-steps: the W2 tile
// of chunk j + 1 is fetched while chunk j's fc1 runs), Hd a multiple of
// 64, Co a multiple of 8; every pointer 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;             // token rows per block
constexpr int kHC = 64;             // hidden columns per chunk
constexpr int kBK = 64;             // fc1 k-step
constexpr int kStages = 3;          // fc1 ring depth
constexpr int kLd = kBK + 8;        // ring row stride (16 bytes of padding)
constexpr int kLdH = kHC + 8;       // h and W2 tile row stride
constexpr int kThreads = 256;       // 8 warps: 2 along M x 4 along N
constexpr int kRingTile = kBM * kLd;          // x or W1 tile, one stage
constexpr int kRingElems = kStages * 2 * kRingTile;
constexpr int kHElems = kBM * kLdH;

constexpr int smem_bytes(int bn) {
  return (kRingElems + kHElems + 2 * bn * kLdH) * 2;
}

struct Params {
  const __nv_bfloat16* x;     // (T, C)
  const __nv_bfloat16* w1;    // (Hd, C)
  const __nv_bfloat16* b1;    // (Hd) or null
  const __nv_bfloat16* w2;    // (Co, Hd)
  const __nv_bfloat16* b2;    // (Co) or null
  __nv_bfloat16* out;         // (T, Co)
  int T, C, Hd, Co, slabs;
};

__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// 16-byte global -> shared copy; zero-fills the destination when !pred
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
}

// A fragments of one 16 x 16 tile of a row-major [m][k] operand
__device__ __forceinline__ void load_a(uint32_t af[4],
                                       const __nv_bfloat16* base, int ld,
                                       int row0, int k0, int lane) {
  ldmatrix_x4(af, base + (row0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
}

// B fragments of two 8-column tiles (16 n x 16 k) of an operand stored
// [n][k], row-major
__device__ __forceinline__ void load_b(uint32_t bf[2][2],
                                       const __nv_bfloat16* base, int ld,
                                       int n0, int k0, int lane) {
  uint32_t r[4];
  ldmatrix_x4(r, base + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 +
                     ((lane >> 3) & 1) * 8);
  bf[0][0] = r[0];
  bf[0][1] = r[1];
  bf[1][0] = r[2];
  bf[1][1] = r[3];
}

// NT: 8-column tiles of the output slab per warp (BN = 32 NT)
template <int NT>
__global__ void __launch_bounds__(kThreads, 1)
    fused_mlp_kernel(const Params p) {
  constexpr int BN = 32 * NT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* hs = ring + kRingElems;       // bf16 h, kBM x kLdH
  __nv_bfloat16* w2s = hs + kHElems;           // 2 x BN x kLdH

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int rb = blockIdx.x / p.slabs;
  const int slab = blockIdx.x - rb * p.slabs;
  const int m0 = rb * kBM;
  const int n0 = slab * BN;
  const int ksteps = p.C / kBK;
  const int nchunks = p.Hd / kHC;
  const int steps = ksteps * nchunks;

  // ring loads: thread copies rows tid / 8 and tid / 8 + 32, 16 bytes at
  // column (tid % 8) 8, of the x tile and of the W1 tile
  const int lrow = tid >> 3;
  const int lcol = (tid & 7) * 8;
  bool xok[2];
  const __nv_bfloat16* xrow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    xok[i] = m0 + lrow + 32 * i < p.T;
    xrow[i] = xok[i] ? p.x + static_cast<long long>(m0 + lrow + 32 * i) * p.C
                     : p.x;
  }

  // stage s: k-step s % ksteps of hidden chunk s / ksteps; the first
  // k-step of a chunk also fetches the chunk's W2 tile into buffer
  // chunk % 2 (the group is waited for before the chunk's fc1 starts)
  auto load_stage = [&](int s) {
    const int chunk = s / ksteps;
    const int ks = s - chunk * ksteps;
    __nv_bfloat16* sa = ring + (s % kStages) * 2 * kRingTile;
    __nv_bfloat16* sb = sa + kRingTile;
    const int k0 = ks * kBK + lcol;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = lrow + 32 * i;
      cp_async16(sa + r * kLd + lcol, xrow[i] + (xok[i] ? k0 : 0), xok[i]);
      cp_async16(sb + r * kLd + lcol,
                 p.w1 + static_cast<long long>(chunk * kHC + r) * p.C + k0,
                 true);
    }
    if (ks == 0) {
      __nv_bfloat16* dst = w2s + (chunk & 1) * BN * kLdH;
#pragma unroll
      for (int i = 0; i < BN * (kHC / 8) / kThreads; ++i) {
        const int idx = tid + kThreads * i;
        const int r = idx >> 3;
        const int c = (idx & 7) * 8;
        const bool ok = n0 + r < p.Co;
        cp_async16(dst + r * kLdH + c,
                   ok ? p.w2 + static_cast<long long>(n0 + r) * p.Hd +
                            chunk * kHC + c
                      : p.w2,
                   ok);
      }
    }
  };

  // fc1 warp tile: 32 rows x 16 hidden columns; fc2 warp tile: 32 rows x
  // BN / 4 output columns
  const int wm = (warp >> 2) * 32;
  const int wn1 = (warp & 3) * 16;
  const int wn2 = (warp & 3) * (BN / 4);
  const int g = lane >> 2;
  const int t = lane & 3;

  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;
    }
  }

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load_stage(s);
    cp_async_commit();
  }
  for (int chunk = 0; chunk < nchunks; ++chunk) {
    float h[2][2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        h[mt][nt][0] = h[mt][nt][1] = h[mt][nt][2] = h[mt][nt][3] = 0.f;
      }
    }
    for (int ks = 0; ks < ksteps; ++ks) {
      const int s = chunk * ksteps + ks;
      cp_async_wait<kStages - 2>();   // stage s has landed
      __syncthreads();                // and everyone is done with s - 1
      if (s + kStages - 1 < steps) load_stage(s + kStages - 1);
      cp_async_commit();
      const __nv_bfloat16* sa = ring + (s % kStages) * 2 * kRingTile;
      const __nv_bfloat16* sb = sa + kRingTile;
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        uint32_t af[2][4];
        load_a(af[0], sa, kLd, wm, kk * 16, lane);
        load_a(af[1], sa, kLd, wm + 16, kk * 16, lane);
        uint32_t bf[2][2];
        load_b(bf, sb, kLd, wn1, kk * 16, lane);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma16816(h[mt][0], af[mt], bf[0][0], bf[0][1]);
          mma16816(h[mt][1], af[mt], bf[1][0], bf[1][1]);
        }
      }
    }
    // h = bf16(gelu(h + b1)) into shared memory.  Every warp passed this
    // chunk's ring barriers after reading hs for the previous chunk's fc2.
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int c = wn1 + nt * 8 + 2 * t;
      float b[2] = {0.f, 0.f};
      if (p.b1 != nullptr) {
        const __nv_bfloat162 bv = *reinterpret_cast<const __nv_bfloat162*>(
            p.b1 + chunk * kHC + c);
        b[0] = __low2float(bv);
        b[1] = __high2float(bv);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = wm + mt * 16 + g + 8 * half;
          *reinterpret_cast<__nv_bfloat162*>(hs + r * kLdH + c) =
              __floats2bfloat162_rn(gelu_erf(h[mt][nt][2 * half] + b[0]),
                                    gelu_erf(h[mt][nt][2 * half + 1] + b[1]));
        }
      }
    }
    __syncthreads();   // h is in shared memory; W2 tile `chunk` has landed
    const __nv_bfloat16* w2t = w2s + (chunk & 1) * BN * kLdH;
#pragma unroll
    for (int kk = 0; kk < kHC / 16; ++kk) {
      uint32_t af[2][4];
      load_a(af[0], hs, kLdH, wm, kk * 16, lane);
      load_a(af[1], hs, kLdH, wm + 16, kk * 16, lane);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bf[2][2];
        load_b(bf, w2t, kLdH, wn2 + np * 16, kk * 16, lane);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma16816(acc[mt][2 * np], af[mt], bf[0][0], bf[0][1]);
          mma16816(acc[mt][2 * np + 1], af[mt], bf[1][0], bf[1][1]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // out = bf16(acc + b2): rows g and g + 8 of each 16-row tile, columns
  // 2t and 2t + 1 of each 8-column tile
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int c = n0 + wn2 + nt * 8 + 2 * t;
    if (c >= p.Co) continue;
    float b[2] = {0.f, 0.f};
    if (p.b2 != nullptr) {
      const __nv_bfloat162 bv =
          *reinterpret_cast<const __nv_bfloat162*>(p.b2 + c);
      b[0] = __low2float(bv);
      b[1] = __high2float(bv);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m0 + wm + mt * 16 + g + 8 * half;
        if (r >= p.T) continue;
        *reinterpret_cast<__nv_bfloat162*>(
            p.out + static_cast<long long>(r) * p.Co + c) =
            __floats2bfloat162_rn(acc[mt][nt][2 * half] + b[0],
                                  acc[mt][nt][2 * half + 1] + b[1]);
      }
    }
  }
}

template <int NT>
cudaError_t launch(const Params& p, cudaStream_t s) {
  constexpr int bytes = smem_bytes(32 * NT);
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_mlp_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const long long blocks =
      static_cast<long long>((p.T + kBM - 1) / kBM) * p.slabs;
  fused_mlp_kernel<NT><<<static_cast<unsigned>(blocks), kThreads, bytes, s>>>(
      p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fused_mlp_bf16(const void* x, const void* w1, const void* b1,
                              const void* w2, const void* b2, void* out,
                              int T, int C, int Hd, int Co, void* stream) {
  if (T < 1 || C < 2 * kBK || C % kBK || Hd < kHC || Hd % kHC || Co < 8 ||
      Co % 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the fewest slabs of at most 384 columns, each rounded up to 128
  const int slabs = (Co + 383) / 384;
  const int per = (Co + slabs - 1) / slabs;
  const int bn = (per + 127) / 128 * 128;
  if (static_cast<long long>((T + kBM - 1) / kBM) * slabs > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.w1 = static_cast<const __nv_bfloat16*>(w1);
  p.b1 = static_cast<const __nv_bfloat16*>(b1);
  p.w2 = static_cast<const __nv_bfloat16*>(w2);
  p.b2 = static_cast<const __nv_bfloat16*>(b2);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.T = T;
  p.C = C;
  p.Hd = Hd;
  p.Co = Co;
  p.slabs = slabs;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 128: return static_cast<int>(launch<4>(p, s));
    case 256: return static_cast<int>(launch<8>(p, s));
    default: return static_cast<int>(launch<12>(p, s));
  }
}
