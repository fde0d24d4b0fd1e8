// Flash-attention forward for Hopper (sm_90a), bf16 in / bf16 out.
//
// Replaces the Pallas TPU kernels vit_torch_tpu/ops/flash_attention.py:
// _fwd_kernel and _fwd_kernel_hb (both reached through _fwd_impl).  Same
// function: O = softmax(scale * Q K^T) V over (B, H, N, D), keys at index
// >= N masked, fp32 scores and softmax statistics, bf16 output.
//
// Design.  The TPU kernel keeps a whole K/V row in VMEM and runs an exact
// one-pass softmax.  At N = 785, D = 64 that is ~200 KB per (b, h) with the
// fp32 score tile, which does not fit next to anything else in an SM's
// 227 KB of shared memory, so this kernel tiles K/V instead and carries an
// online softmax (running row max m, running row sum l, O rescaled by
// exp(m_old - m_new) whenever the max grows), then divides O by l once.
//
// - One block of 4 warps per (64-row query tile, b*h); each warp owns 16
//   query rows.  Q lives in registers as mma A-fragments for the whole run.
// - K/V are staged 64 keys at a time in shared memory (rows padded by 16
//   bytes so fragment reads are free of bank conflicts).  Out-of-range rows
//   are zero-filled: a zero V row keeps P*V finite where P is 0.
// - S = Q K^T and O += P V run on the tensor cores with
//   mma.sync.m16n8k16 bf16 -> fp32.  The S accumulator layout is exactly the
//   A-fragment layout of the next product, so P never leaves registers; it
//   is rounded to bf16 for the PV product only, as the TPU kernel rounds it
//   (the row sum l uses the unrounded fp32 P).  V's B-fragments come from
//   the row-major tile through ldmatrix.trans.
// - Keys >= N in the ragged last tile are masked to -inf before the max;
//   every tile the loop visits holds at least one valid key, so the running
//   max is finite from the first tile on.
// - Inputs are addressed by (batch, head, row) strides with unit stride
//   along D, so q/k/v may be views into the fused qkv projection and O may
//   be written straight into a (B, N, H, D) buffer: no transposes around
//   the call.
//
// Bound at the serving shape B=32, H=12, N=785, D=64: 4*B*H*N^2*D = 60.6
// GFLOP (61 us at 989 TFLOP/s dense bf16) against 4*B*H*N*D*2 = 154 MB of
// q/k/v/o (46 us at 3.35 TB/s), so it is bound by operations.  This first
// version uses mma.sync with synchronous tile loads and no software
// pipelining; wgmma, TMA and warp specialisation are later work.
//
// C entry point (ctypes): flash_attention_fwd_bf16(...) returns the
// cudaError_t of the launch; it launches on the given stream and does not
// synchronise or allocate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;   // query rows per block
constexpr int kBlockN = 64;   // keys per K/V tile
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kPad = 8;       // bf16 elements (16 bytes) of row padding
static_assert(kBlockM == kBlockN, "load_tile copies 64-row tiles");

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  // element strides: [tensor][batch, head, row] for tensor in q, k, v, o
  long long stride[4][3];
  int H;
  int N;
  float scale_log2;  // scale * log2(e): softmax runs in base 2
};

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

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

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const Params p) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  __shared__ __align__(16) __nv_bfloat16 sQ[kBlockM][D + kPad];
  __shared__ __align__(16) __nv_bfloat16 sK[kBlockN][D + kPad];
  __shared__ __align__(16) __nv_bfloat16 sV[kBlockN][D + kPad];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row within the 8-row group
  const int t = lane & 3;   // fragment column pair
  const int N = p.N;
  const int q0 = blockIdx.x * kBlockM;
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;

  const __nv_bfloat16* qg = p.q + b * p.stride[0][0] + h * p.stride[0][1];
  const __nv_bfloat16* kg = p.k + b * p.stride[1][0] + h * p.stride[1][1];
  const __nv_bfloat16* vg = p.v + b * p.stride[2][0] + h * p.stride[2][1];
  __nv_bfloat16* og = p.o + b * p.stride[3][0] + h * p.stride[3][1];

  load_tile<D>(sQ, qg, p.stride[0][2], q0, N);
  __syncthreads();

  // Q as A-fragments: rows warp*16 + g (+8), k-steps of 16 along D
  const int r0 = warp * 16 + g;
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    qf[kk][0] = lds32(&sQ[r0][kk * 16 + 2 * t]);
    qf[kk][1] = lds32(&sQ[r0 + 8][kk * 16 + 2 * t]);
    qf[kk][2] = lds32(&sQ[r0][kk * 16 + 8 + 2 * t]);
    qf[kk][3] = lds32(&sQ[r0 + 8][kk * 16 + 8 + 2 * t]);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  }
  // per-thread running stats for rows r0 (index 0) and r0 + 8 (index 1);
  // l holds this thread's partial sum over its columns
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  for (int k0 = 0; k0 < N; k0 += kBlockN) {
    __syncthreads();  // every warp is done reading the previous tile
    load_tile<D>(sK, kg, p.stride[1][2], k0, N);
    load_tile<D>(sV, vg, p.stride[2][2], k0, N);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[kBlockN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t b0 = lds32(&sK[nt * 8 + g][kk * 16 + 2 * t]);
        const uint32_t b1 = lds32(&sK[nt * 8 + g][kk * 16 + 8 + 2 * t]);
        mma_bf16_16816(s[nt], qf[kk], b0, b1);
      }
    }

    // scale into base 2, mask the ragged edge, row max over the tile
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + 2 * t + (e & 1);
        const float x = col < N ? s[nt][e] * p.scale_log2 : -INFINITY;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // the 4 threads of a quad share a row
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_run[i], mx[i]);
      alpha[i] = exp2f(m_run[i] - m_new);  // 0 on the first tile
      m_run[i] = m_new;
      l_run[i] *= alpha[i];
    }
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = exp2f(s[nt][e] - m_run[e >> 1]);
        s[nt][e] = pe;
        l_run[e >> 1] += pe;
      }
    }
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }

    // O += P V: P's accumulator layout is the A-fragment layout
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const int vrow = kk * 16 + (lane & 15);
#pragma unroll
      for (int dt = 0; dt < D / 8; dt += 2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, &sV[vrow][dt * 8 + (lane >> 4) * 8]);
        mma_bf16_16816(acc[dt], a, bv[0], bv[1]);
        mma_bf16_16816(acc[dt + 1], a, bv[2], bv[3]);
      }
    }
  }

  // finish the row sums across the quad and normalise once
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[i] = 1.f / l;
  }
  const int row_a = q0 + r0;
  const int row_b = row_a + 8;
  const long long os = p.stride[3][2];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (row_a < N) {
      *reinterpret_cast<uint32_t*>(og + row_a * os + col) =
          pack_bf16x2(acc[dt][0] * inv[0], acc[dt][1] * inv[0]);
    }
    if (row_b < N) {
      *reinterpret_cast<uint32_t*>(og + row_b * os + col) =
          pack_bf16x2(acc[dt][2] * inv[1], acc[dt][3] * inv[1]);
    }
  }
}

}  // namespace

extern "C" int flash_attention_fwd_bf16(const void* q, const void* k,
                                        const void* v, void* o, int B, int H,
                                        int N, int D,
                                        const long long* strides, float scale,
                                        void* stream) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  for (int i = 0; i < 4; ++i) {
    for (int j = 0; j < 3; ++j) p.stride[i][j] = strides[3 * i + j];
  }
  p.H = H;
  p.N = N;
  p.scale_log2 = scale * 1.4426950408889634f;
  const dim3 grid((N + kBlockM - 1) / kBlockM, B * H);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) {
    flash_fwd_kernel<64><<<grid, kThreads, 0, s>>>(p);
  } else if (D == 32) {
    flash_fwd_kernel<32><<<grid, kThreads, 0, s>>>(p);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
