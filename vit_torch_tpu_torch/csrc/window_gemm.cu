// The matrix products and LayerNorms of the Swin block kernels for Hopper
// (sm_90a):
//   Y = epilogue(X W^T + b),  bf16 in / bf16 out, fp32 accumulation, and
//   Y = bf16(LayerNorm(X)) over rows, fp32 statistics.
//
// Together with window_attention_fwd.cu (the attention core) this replaces
// the Pallas TPU kernels vit_torch_tpu/ops/window_block.py:
// _fwd_kernel_spatial (window_block_spatial, "B8") and
// _fwd_kernel_spatial_full (window_block_full_spatial, "B9"):
//   B8 = qkv product -> core -> proj product,
//   B9 = LN1 -> qkv product -> core -> proj product + residual
//        -> LN2 -> fc1 product + GELU -> fc2 product + residual.
// The TPU kernels computed these products in their own bodies with the
// weights resident in VMEM; B9's 12 C^2 weights do not fit in an SM's
// shared memory, so on Hopper each block is this short chain of launches.
// Each launch keeps the TPU kernel's rounding points.
//
// GEMM options, chosen per launch:
// - window addressing.  Row r of the window-major order (window
//   wi = r / N, token j = r mod N, window (wy, wx) of image b) lives at
//   map position (b, (wy w + j / w + s) mod H, (wx w + j mod w + s) mod W).
//   A gathered A-operand reads its rows there and a scattered Y (with its
//   residual) writes them there: the window partition and reverse of the
//   TPU band kernels, with the cyclic shift s of a shifted block folded in
//   (roll by -s before the block, by +s after, computes the same function).
// - epilogues (fp32 accumulator acc, bf16 bias b, bf16 residual res):
//   0: bf16(acc + b)                                   (qkv; B8's proj)
//   1: bf16(bf16(acc + b) + res)                        (B9's proj)
//   2: bf16(gelu(bf16(bf16(acc) + b))), exact erf GELU  (fc1)
//   3: bf16(res + bf16(bf16(acc) + b))                  (fc2)
//
// GEMM tiling: 128 x 128 output tiles, k-steps of 32, 8 warps of 64 x 32,
// mma.sync.m16n8k16 bf16 -> fp32 with ldmatrix fragment loads, and a
// 3-stage cp.async pipeline (16-byte copies, zero-filled past the last
// row) in 60 KB of dynamic shared memory.  (4 warps of 64 x 64 and 4
// stages measured slower on the H100: 222 registers a thread.)  Consecutive blocks share their
// rows of X, so gathered rows are read from device memory about once.  K
// must be a multiple of 32 and the row strides multiples of 8 elements.
//
// LayerNorm (the TPU kernels' _ln_rows_f32, flax's fast variance): one
// warp per row, fp32 sum and sum of squares over 16-byte loads, mean and
// var = max(E[x^2] - mean^2, 0), then
// bf16((x - mean) * (rsqrt(var + eps) * w[k]) + b[k]) with fp32 w, b.  It
// writes the normalised map once (the products then read it like any
// input) rather than normalising inside every column tile of the product.
//
// Bound (see window_block.py for the per-block formula): at swin_base_384
// stage 1, bs32 (T = 294,912 tokens, C = 128) the qkv product is 29 GFLOP
// against 302 MB (the map read, qkv written): bound by bytes, 90 us.  The
// products at C >= 256 are bound by operations.  This version has no TMA
// or wgmma.
//
// C entry points (ctypes): window_gemm_bf16(...) and
// window_layer_norm_bf16(...) return the cudaError_t of the launch; they
// launch on the given stream and do not synchronise or allocate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 32;
constexpr int kStages = 3;
constexpr int kLd = kBK + 8;        // 16 bytes of row padding
constexpr int kThreads = 256;       // 8 warps: 2 along M x 4 along N
constexpr int kWarpM = 64;
constexpr int kWarpN = 32;
constexpr int kRowsPerCopy = kThreads / 4;   // 4 chunks of 16 B per row
constexpr int kCopies = kBM / kRowsPerCopy;  // chunks per thread per tile
constexpr int kTileElems = kBM * kLd;                    // A or B, one stage
constexpr int kSmemBytes = kStages * 2 * kTileElems * 2;  // 61,440

enum Epilogue { kBias = 0, kBiasRes = 1, kGelu = 2, kBias16Res = 3 };

struct Params {
  const __nv_bfloat16* x;     // A source rows (row stride lda)
  const __nv_bfloat16* w;     // (Nout, K), row-major (nn.Linear layout)
  const __nv_bfloat16* bias;  // (Nout) or null
  const __nv_bfloat16* res;   // residual, addressed as Y
  __nv_bfloat16* y;           // rows of Nout (row stride ldy)
  int T, K, Nout;
  long long lda, ldy;
  int gather, scatter;        // window addressing of A rows / Y rows
  int Hm, Wm, win, shift;     // map geometry for window addressing
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

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// row r of the window-major order -> its row in the (B, Hm, Wm) map
__device__ __forceinline__ long long map_row(int r, const Params& p) {
  const int w = p.win;
  const int n = w * w;
  const int nwc = p.Wm / w;
  const int nw = (p.Hm / w) * nwc;
  const int wi = r / n;
  const int j = r - wi * n;
  const int b = wi / nw;
  const int wr = wi - b * nw;
  const int wy = wr / nwc;
  const int wx = wr - wy * nwc;
  const int i = j / w;
  int yy = wy * w + i + p.shift;
  int xx = wx * w + (j - i * w) + p.shift;
  if (yy >= p.Hm) yy -= p.Hm;
  if (xx >= p.Wm) xx -= p.Wm;
  return (static_cast<long long>(b) * p.Hm + yy) * p.Wm + xx;
}

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
}

template <int EPI>
__global__ void __launch_bounds__(kThreads)
    window_gemm_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // stage s: A tile at smem + 2 s kTileElems, B tile right after it
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;

  // each thread copies kCopies 16-byte chunks of A and of B per k-step:
  // rows tid / 4 + 32 i, columns (tid % 4) * 8 .. + 8
  const int lrow = tid >> 2;
  const int lcol = (tid & 3) * 8;
  const __nv_bfloat16* arow[kCopies];
  const __nv_bfloat16* brow[kCopies];
  bool aok[kCopies], bok[kCopies];
#pragma unroll
  for (int i = 0; i < kCopies; ++i) {
    const int r = m0 + lrow + kRowsPerCopy * i;
    aok[i] = r < p.T;
    arow[i] = p.x;
    if (aok[i]) arow[i] = p.x + (p.gather ? map_row(r, p) : r) * p.lda;
    const int n = n0 + lrow + kRowsPerCopy * i;
    bok[i] = n < p.Nout;
    brow[i] = bok[i] ? p.w + static_cast<long long>(n) * p.K : p.w;
  }
  const int ksteps = p.K / kBK;
  auto load_stage = [&](int ks) {
    __nv_bfloat16* sa = smem + (ks % kStages) * 2 * kTileElems;
    __nv_bfloat16* sb = sa + kTileElems;
    const int k0 = ks * kBK + lcol;
#pragma unroll
    for (int i = 0; i < kCopies; ++i) {
      const int row = (lrow + kRowsPerCopy * i) * kLd + lcol;
      cp_async16(sa + row, arow[i] + (aok[i] ? k0 : 0), aok[i]);
      cp_async16(sb + row, brow[i] + (bok[i] ? k0 : 0), bok[i]);
    }
  };

  float acc[kWarpM / 16][kWarpN / 8][4];
#pragma unroll
  for (int mt = 0; mt < kWarpM / 16; ++mt) {
#pragma unroll
    for (int nt = 0; nt < kWarpN / 8; ++nt) {
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;
    }
  }
  const int wm = (warp >> 2) * kWarpM;   // this warp's rows in the tile
  const int wn = (warp & 3) * kWarpN;    // and columns

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ksteps) load_stage(s);
    cp_async_commit();
  }
  for (int ks = 0; ks < ksteps; ++ks) {
    cp_async_wait<kStages - 2>();   // k-step ks has landed
    __syncthreads();                // and everyone is done with ks - 1
    if (ks + kStages - 1 < ksteps) load_stage(ks + kStages - 1);
    cp_async_commit();
    const __nv_bfloat16* sa = smem + (ks % kStages) * 2 * kTileElems;
    const __nv_bfloat16* sb = sa + kTileElems;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t af[kWarpM / 16][4];
#pragma unroll
      for (int mt = 0; mt < kWarpM / 16; ++mt) {
        ldmatrix_x4(af[mt], sa + (wm + mt * 16 + (lane & 15)) * kLd +
                                kk * 16 + (lane >> 4) * 8);
      }
      uint32_t bf[kWarpN / 8][2];
#pragma unroll
      for (int np = 0; np < kWarpN / 16; ++np) {
        uint32_t r[4];
        ldmatrix_x4(r, sb + (wn + np * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                kLd +
                            kk * 16 + ((lane >> 3) & 1) * 8);
        bf[2 * np][0] = r[0];
        bf[2 * np][1] = r[1];
        bf[2 * np + 1][0] = r[2];
        bf[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < kWarpM / 16; ++mt) {
#pragma unroll
        for (int nt = 0; nt < kWarpN / 8; ++nt) {
          mma16816(acc[mt][nt], af[mt], bf[nt][0], bf[nt][1]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // epilogue: each thread holds rows g and g + 8 of every 16-row tile,
  // columns 2t and 2t + 1 of every 8-column tile
  const int g = lane >> 2;
  const int t = lane & 3;
  float bias[kWarpN / 8][2];
#pragma unroll
  for (int nt = 0; nt < kWarpN / 8; ++nt) {
    const int c = n0 + wn + nt * 8 + 2 * t;
    bias[nt][0] = bias[nt][1] = 0.f;
    if (p.bias != nullptr && c < p.Nout) {
      const __nv_bfloat162 bv =
          *reinterpret_cast<const __nv_bfloat162*>(p.bias + c);
      bias[nt][0] = __low2float(bv);
      bias[nt][1] = __high2float(bv);
    }
  }
#pragma unroll
  for (int mt = 0; mt < kWarpM / 16; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = m0 + wm + mt * 16 + g + 8 * half;
      if (r >= p.T) continue;
      const long long yr = (p.scatter ? map_row(r, p) : r) * p.ldy;
#pragma unroll
      for (int nt = 0; nt < kWarpN / 8; ++nt) {
        const int c = n0 + wn + nt * 8 + 2 * t;
        if (c >= p.Nout) continue;
        float v[2] = {acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]};
        float rs[2] = {0.f, 0.f};
        if (EPI == kBiasRes || EPI == kBias16Res) {
          const __nv_bfloat162 rv =
              *reinterpret_cast<const __nv_bfloat162*>(p.res + yr + c);
          rs[0] = __low2float(rv);
          rs[1] = __high2float(rv);
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float b = bias[nt][e];
          if (EPI == kBias) {
            v[e] = v[e] + b;
          } else if (EPI == kBiasRes) {
            v[e] = bf16r(v[e] + b) + rs[e];
          } else if (EPI == kGelu) {
            v[e] = gelu_erf(bf16r(bf16r(v[e]) + b));
          } else {
            v[e] = rs[e] + bf16r(bf16r(v[e]) + b);
          }
        }
        *reinterpret_cast<__nv_bfloat162*>(p.y + yr + c) =
            __floats2bfloat162_rn(v[0], v[1]);
      }
    }
  }
}

template <int EPI>
cudaError_t launch(const Params& p, cudaStream_t s) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        window_gemm_kernel<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((p.Nout + kBN - 1) / kBN, (p.T + kBM - 1) / kBM);
  window_gemm_kernel<EPI><<<grid, kThreads, kSmemBytes, s>>>(p);
  return cudaGetLastError();
}

constexpr int kLnRows = 8;   // rows per block, one warp each

__global__ void __launch_bounds__(32 * kLnRows)
    window_layer_norm_kernel(const __nv_bfloat16* x, const float* w,
                             const float* b, __nv_bfloat16* y, int T, int C,
                             float eps) {
  const int lane = threadIdx.x & 31;
  const long long r =
      static_cast<long long>(blockIdx.x) * kLnRows + (threadIdx.x >> 5);
  if (r >= T) return;
  const __nv_bfloat16* src = x + r * C;
  float sum = 0.f, sq = 0.f;
  for (int c = lane * 8; c < C; c += 32 * 8) {
    const int4 v = *reinterpret_cast<const int4*>(src + c);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float f = __bfloat162float(e[q]);
      sum += f;
      sq += f * f;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
    sq += __shfl_xor_sync(0xffffffffu, sq, off);
  }
  const float mean = sum / C;
  const float rstd = rsqrtf(fmaxf(sq / C - mean * mean, 0.f) + eps);
  __nv_bfloat16* dst = y + r * C;
  for (int c = lane * 8; c < C; c += 32 * 8) {
    int4 v = *reinterpret_cast<const int4*>(src + c);
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float f = __bfloat162float(e[q]);
      e[q] = __float2bfloat16((f - mean) * (rstd * w[c + q]) + b[c + q]);
    }
    *reinterpret_cast<int4*>(dst + c) = v;
  }
}

}  // namespace

extern "C" int window_gemm_bf16(const void* x, const void* w,
                                const void* bias, const void* res, void* y,
                                int T, int K, int Nout, long long lda,
                                long long ldy, int gather, int scatter,
                                int Hm, int Wm, int win, int shift,
                                int epilogue, void* stream) {
  if (T < 1 || K < kBK || K % kBK || Nout < 2 || Nout % 2 || lda % 8 ||
      ldy % 2 || (T + kBM - 1) / kBM > 65535 ||
      ((gather || scatter) &&
       (win < 1 || Hm % win || Wm % win || shift < 0 || shift >= win))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.w = static_cast<const __nv_bfloat16*>(w);
  p.bias = static_cast<const __nv_bfloat16*>(bias);
  p.res = static_cast<const __nv_bfloat16*>(res);
  p.y = static_cast<__nv_bfloat16*>(y);
  p.T = T;
  p.K = K;
  p.Nout = Nout;
  p.lda = lda;
  p.ldy = ldy;
  p.gather = gather;
  p.scatter = scatter;
  p.Hm = Hm;
  p.Wm = Wm;
  p.win = win;
  p.shift = shift;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (epilogue) {
    case kBias: return static_cast<int>(launch<kBias>(p, s));
    case kBiasRes: return static_cast<int>(launch<kBiasRes>(p, s));
    case kGelu: return static_cast<int>(launch<kGelu>(p, s));
    case kBias16Res: return static_cast<int>(launch<kBias16Res>(p, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int window_layer_norm_bf16(const void* x, const void* w,
                                      const void* b, void* y, int T, int C,
                                      float eps, void* stream) {
  if (T < 1 || C < 8 || C % 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  window_layer_norm_kernel<<<(T + kLnRows - 1) / kLnRows, 32 * kLnRows, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<__nv_bfloat16*>(y), T, C,
      eps);
  return static_cast<int>(cudaGetLastError());
}
