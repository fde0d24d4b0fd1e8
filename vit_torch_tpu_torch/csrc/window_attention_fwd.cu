// Swin window-attention forward for Hopper (sm_90a), bf16 in / bf16 out.
//
// Replaces the Pallas TPU kernel vit_torch_tpu/ops/window_attention.py:
// _fwd_kernel (reached through _fwd_impl).  Same function, per window i and
// head h of (Bn, N, H, D) tensors:
//   S = scale * Q K^T + bias[h] + mask[i mod nW]     (fp32)
//   P = exp(S - rowmax(S))                            (fp32, unnormalised)
//   O = (bf16(P) V) / rowsum(P)                       (fp32 sum, bf16 out)
// It is also the attention core of the Swin block kernels (window_gemm.cu
// composes them), which launch it once per block.
//
// Design.  A window holds at most N = 144 tokens (window 12) and every Swin
// config has D = 32, so one window-head's Q, K and V are 27 KB of bf16 and
// its S is 144 x 144 fp32: the whole softmax row fits in registers across
// the warps of one block.  No online softmax is needed, so the rows are
// exact, as in the TPU kernel.
//
// - One block per (window, head); NT = ceil(N / 16) warps, each owning one
//   16-row slice of the queries.  Q, K and V are staged in shared memory
//   with cp.async (rows padded by 16 bytes, so fragment reads are free of
//   bank conflicts); rows >= N are zero-filled.  N = 49 (window 7) runs as
//   64 rows with keys >= N excluded.
// - S = Q K^T and O = P V run on the tensor cores with mma.sync.m16n8k16
//   bf16 -> fp32.  S's accumulator layout is the A-fragment layout of the
//   PV product, so P never leaves registers; it is rounded to bf16 for PV
//   only (the row sum uses the fp32 P).  V's B-fragments come through
//   ldmatrix.trans.
// - bias[h] and mask[i mod nW] are fp32 reads of (N, N) tables shared by
//   all windows and images, so they stay in L2 (the swin_base_384 stage-1
//   mask is 64 x 83 KB = 5.3 MB).  A thread reads them in the accumulator
//   layout, two neighbouring columns at once when N is even (8-byte
//   loads, whole 32-byte sectors per row of a warp).
// - q, k, v and o are addressed by (window, row, head) strides with unit
//   stride along D, so q/k/v are views into the window-major
//   (Bn, N, 3, H, D) qkv projection and O is written as (Bn, N, H * D).
//
// Bound at swin_base_384 stage 1, bs32: (Bn, N, H, D) = (2048, 144, 4, 32)
// is 4 * Bn * H * N^2 * D = 21.7 GFLOP (22 us at 989 TFLOP/s dense bf16)
// against q, k, v read and o written, 4 * Bn * N * H * D * 2 = 302 MB
// (90 us at 3.35 TB/s): it is bound by bytes.  Beside those bytes each
// window-head reads its (N, N) fp32 bias and mask rows from L2, 83 KB
// each at N = 144, which this version does not share between the blocks
// that use them.
//
// C entry point (ctypes): window_attention_fwd_bf16(...) returns the
// cudaError_t of the launch; it launches on the given stream and does not
// synchronise or allocate.

#include "flash_common.cuh"

namespace {

// 16-byte global -> shared copy; zero-fills the destination when !pred
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(pred ? 16 : 0));
  asm volatile("cp.async.commit_group;\n" ::);
}

constexpr int kD = 32;           // head dim of every Swin config
constexpr int kMaxTiles = 9;     // 16-row tiles: N <= 144

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  const float* bias;  // (H, N, N)
  const float* mask;  // (nW, N, N) or null
  // element strides: [tensor][window, row, head] for tensor in q, k, v, o
  long long stride[4][3];
  int N;
  int nW;
  float scale;
};

// NT 16-row tiles; EVEN: N is even, so column pairs (2t, 2t + 1) of the
// bias and mask are 8-byte aligned and both in or both out of range
template <int NT, bool EVEN>
__global__ void __launch_bounds__(32 * NT)
    window_attn_fwd_kernel(const Params p) {
  constexpr int NP = 16 * NT;        // padded rows and keys
  constexpr int kThreadsNT = 32 * NT;
  constexpr int kChunks = kD / 8;    // 16-byte chunks per row
  __shared__ __align__(16) __nv_bfloat16 sQ[NP][kD + kPad];
  __shared__ __align__(16) __nv_bfloat16 sK[NP][kD + kPad];
  __shared__ __align__(16) __nv_bfloat16 sV[NP][kD + kPad];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int N = p.N;
  const long long win = blockIdx.x;
  const int h = blockIdx.y;

  const __nv_bfloat16* src[3] = {p.q, p.k, p.v};
  __nv_bfloat16(*dst[3])[kD + kPad] = {sQ, sK, sV};
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    const __nv_bfloat16* base =
        src[m] + win * p.stride[m][0] + h * p.stride[m][2];
    for (int c = threadIdx.x; c < NP * kChunks; c += kThreadsNT) {
      const int r = c / kChunks;
      const int col = (c % kChunks) * 8;
      const bool ok = r < N;
      cp_async16(&dst[m][r][col], base + (ok ? r * p.stride[m][1] : 0) + col,
                 ok);
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  // this warp's queries as A-fragments: rows r0 and r0 + 8
  const int r0 = warp * 16 + g;
  uint32_t qf[kD / 16][4];
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    qf[kk][0] = lds32(&sQ[r0][kk * 16 + 2 * t]);
    qf[kk][1] = lds32(&sQ[r0 + 8][kk * 16 + 2 * t]);
    qf[kk][2] = lds32(&sQ[r0][kk * 16 + 8 + 2 * t]);
    qf[kk][3] = lds32(&sQ[r0 + 8][kk * 16 + 8 + 2 * t]);
  }

  // S = Q K^T over all NP keys: 2 * NT n-tiles of 8
  float s[2 * NT][4];
#pragma unroll
  for (int nt = 0; nt < 2 * NT; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const uint32_t b0 = lds32(&sK[nt * 8 + g][kk * 16 + 2 * t]);
      const uint32_t b1 = lds32(&sK[nt * 8 + g][kk * 16 + 8 + 2 * t]);
      mma_bf16_16816(s[nt], qf[kk], b0, b1);
    }
  }

  // scale, bias and mask in fp32; keys >= N excluded; row max
  const float* bias_h = p.bias + static_cast<long long>(h) * N * N;
  const float* mask_w =
      p.mask == nullptr ? nullptr
                        : p.mask + (win % p.nW) * static_cast<long long>(N) * N;
  const int rows[2] = {r0, r0 + 8};
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < 2 * NT; ++nt) {
    const int col = nt * 8 + 2 * t;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = rows[i];
      float x0 = s[nt][2 * i] * p.scale;
      float x1 = s[nt][2 * i + 1] * p.scale;
      if (row < N) {
        const long long at = static_cast<long long>(row) * N + col;
        if (EVEN) {
          if (col < N) {
            const float2 b = *reinterpret_cast<const float2*>(bias_h + at);
            x0 += b.x;
            x1 += b.y;
            if (mask_w != nullptr) {
              const float2 m = *reinterpret_cast<const float2*>(mask_w + at);
              x0 += m.x;
              x1 += m.y;
            }
          }
        } else {
          if (col < N) {
            x0 += bias_h[at];
            if (mask_w != nullptr) x0 += mask_w[at];
          }
          if (col + 1 < N) {
            x1 += bias_h[at + 1];
            if (mask_w != nullptr) x1 += mask_w[at + 1];
          }
        }
      }
      if (col >= N) x0 = -INFINITY;
      if (col + 1 >= N) x1 = -INFINITY;
      s[nt][2 * i] = x0;
      s[nt][2 * i + 1] = x1;
      mx[i] = fmaxf(mx[i], fmaxf(x0, x1));
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {  // the 4 threads of a quad share a row
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
  }
  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < 2 * NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pe = exp2f((s[nt][e] - mx[e >> 1]) * kLog2e);
      s[nt][e] = pe;
      l[e >> 1] += pe;
    }
  }

  // O = P V: k-steps of 16 keys; P's accumulator layout is the A layout
  float acc[kD / 8][4];
#pragma unroll
  for (int i = 0; i < kD / 8; ++i) {
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  }
#pragma unroll
  for (int kk = 0; kk < NT; ++kk) {
    uint32_t a[4];
    a[0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
    a[1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
    a[2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    a[3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    const int row = kk * 16 + (lane & 15);
#pragma unroll
    for (int dt = 0; dt < kD / 8; dt += 2) {
      uint32_t bv[4];
      ldmatrix_x4_trans(bv, &sV[row][dt * 8 + (lane >> 4) * 8]);
      mma_bf16_16816(acc[dt], a, bv[0], bv[1]);
      mma_bf16_16816(acc[dt + 1], a, bv[2], bv[3]);
    }
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = 1.f / l[i];
  }
  __nv_bfloat16* og = p.o + win * p.stride[3][0] + h * p.stride[3][2];
#pragma unroll
  for (int dt = 0; dt < kD / 8; ++dt) {
    const int col = dt * 8 + 2 * t;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (rows[i] < N) {
        *reinterpret_cast<uint32_t*>(og + rows[i] * p.stride[3][1] + col) =
            pack_bf16x2(acc[dt][2 * i] * inv[i], acc[dt][2 * i + 1] * inv[i]);
      }
    }
  }
}

template <int NT>
cudaError_t launch(const Params& p, int Bn, int H, cudaStream_t s) {
  if (p.N % 2 == 0) {
    window_attn_fwd_kernel<NT, true><<<dim3(Bn, H), 32 * NT, 0, s>>>(p);
  } else {
    window_attn_fwd_kernel<NT, false><<<dim3(Bn, H), 32 * NT, 0, s>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int window_attention_fwd_bf16(const void* q, const void* k,
                                         const void* v, void* o,
                                         const void* bias, const void* mask,
                                         int Bn, int H, int N, int D, int nW,
                                         const long long* strides, float scale,
                                         void* stream) {
  if (D != kD || N < 1 || N > 16 * kMaxTiles || nW < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.bias = static_cast<const float*>(bias);
  p.mask = static_cast<const float*>(mask);
  for (int i = 0; i < 4; ++i) {
    for (int j = 0; j < 3; ++j) p.stride[i][j] = strides[3 * i + j];
  }
  p.N = N;
  p.nW = nW;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((N + 15) / 16) {
    case 1: return static_cast<int>(launch<1>(p, Bn, H, s));
    case 2: return static_cast<int>(launch<2>(p, Bn, H, s));
    case 3: return static_cast<int>(launch<3>(p, Bn, H, s));
    case 4: return static_cast<int>(launch<4>(p, Bn, H, s));
    case 5: return static_cast<int>(launch<5>(p, Bn, H, s));
    case 6: return static_cast<int>(launch<6>(p, Bn, H, s));
    case 7: return static_cast<int>(launch<7>(p, Bn, H, s));
    case 8: return static_cast<int>(launch<8>(p, Bn, H, s));
    case 9: return static_cast<int>(launch<9>(p, Bn, H, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
