// Swin window-attention backward for Hopper (sm_90a), bf16 in / bf16 out.
//
// Replaces the Pallas TPU kernel vit_torch_tpu/ops/window_attention.py:
// _bwd_kernel (reached through _bwd_impl).  Same function, per window i and
// head h of (Bn, N, H, D) tensors, keys and queries >= N excluded:
//   S  = scale * Q K^T + bias[h] + mask[i mod nW]    (fp32)
//   P  = softmax(S)                                  (fp32, exact rows)
//   dV = bf16(P)^T dO
//   dP = dO V^T                                      (fp32)
//   Di = rowsum(P o dP)                              (from the fp32 P)
//   dS = P o (dP - Di)                               (fp32)
//   dQ = bf16(dS) K * scale,  dK = bf16(dS)^T Q * scale
//   dbias[h] = sum over windows of the fp32 dS       (unrounded)
// The mask gets no gradient.  It is the backward of the window-attention
// core, and so of the Swin block kernels B8 and B9 (window_block.py).
//
// Design.  As in the forward (window_attention_fwd.cu), N <= 144 and
// D = 32, so one window-head's Q, K, V and dO are 37 KB of bf16 and each
// warp keeps a whole 16-row slice of S in registers: P is recomputed
// exactly, with no log-sum-exp residual, and Di comes from P and dP as in
// the TPU kernel (not from rowsum(dO o O)).
//
// - One block per (head h, mask row j, chunk of images), NT = ceil(N / 16)
//   warps, each owning 16 query rows.  The block loops over the windows
//   i = b * nW + j of its chunk of images b, which all take bias[h] and
//   mask[j]: it stages the fp32 table bias[h] + mask[j] in shared memory
//   once (88 KB at N = 144, rows padded against bank conflicts), so a
//   window reads nothing but its Q, K, V and dO.  Those are staged with
//   cp.async into padded shared rows (rows >= N zero-filled); S = Q K^T
//   and dP = dO V^T run on mma.sync.m16n8k16 bf16 -> fp32.  dP is
//   computed twice, once for Di and once for dS, so that P, dS and the
//   dbias sums fit in registers together.
// - dQ = dS K comes from registers: dS's accumulator layout is the
//   A-fragment layout of the product (K's B-fragments through
//   ldmatrix.trans).  dV = P^T dO and dK = dS^T Q need the transposed
//   scores: bf16 P and bf16 dS go to shared memory (41 KB each at
//   N = 144) and each warp then owns 16 keys, reading P^T and dS^T as
//   A-fragments with ldmatrix.trans.
// - dbias without atomics.  The TPU kernel carries dbias in VMEM scratch
//   along its sequential window axis; here blocks run in no order.  A
//   thread owns the same (row, column) fragment of S in every window, so
//   it adds its fp32 dS up in registers over the block's windows and
//   writes one (N, N) partial per block; a second launch sums each head's
//   partials in a fixed order.  A run is reproducible from its seed.  The
//   chunk count (the wrapper's) keeps the blocks, and so the partials,
//   near two waves: at swin_base_384 stage 1 shifted, 64 mask rows x 4
//   heads x 83 KB = 21 MB.
// - Keys >= N take P = 0; rows >= N take P = 0 and dS = 0, so they add
//   nothing to dbias, dK or dV, and are never stored.
// - The table is read from shared memory in the accumulator layout, two
//   columns at a time when N is even.
// - q, k, v, dO, dq, dk and dv are addressed by (window, row, head)
//   strides with unit stride along D, so q/k/v are views into the
//   window-major (Bn, N, 3, H, D) qkv projection and dq/dk/dv views into
//   one gradient of that shape.
//
// Bound at swin_base_384 stage 1, bs32, (Bn, N, H, D) = (2048, 144, 4, 32):
// 5 products of 2 * N^2 * D flops, 10 * Bn * H * N^2 * D = 54.4 GFLOP
// (0.055 ms at 989 TFLOP/s dense bf16), against q, k, v, dO read and dq,
// dk, dv written, 7 * Bn * N * H * D * 2 = 528 MB (0.158 ms at 3.35 TB/s):
// it is bound by bytes.  This version does 6 products (dP twice) and loads
// each window synchronously.
//
// C entry point (ctypes): window_attention_bwd_bf16(...) launches both
// passes on the given stream and returns the first non-zero cudaError_t; it
// does not synchronise or allocate.

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
constexpr int kRow = kD + kPad;  // a staged Q/K/V/dO row, bf16

enum { kQ = 0, kK, kV, kDO, kDQ, kDK, kDV, kNumTensors };

struct Params {
  const __nv_bfloat16* in[4];   // q, k, v, dO
  __nv_bfloat16* out[3];        // dq, dk, dv
  const float* bias;            // (H, N, N)
  const float* mask;            // (nW, N, N) or null
  float* partial;               // (chunks * nW, H, N, N)
  // element strides: [tensor][window, row, head], tensors in enum order
  long long stride[kNumTensors][3];
  int Bn;
  int N;
  int nW;      // mask rows (1 without a mask)
  int chunks;  // chunks of the Bn / nW images
  int ld;      // row stride of the shared bias + mask table, floats
  float scale;
};

// A row stride for the (N, N) fp32 table with ld = 24 (mod 32): the float2
// reads of 4 rows by a half-warp fall in distinct banks
__host__ __device__ inline int table_ld(int N) {
  return N + ((24 - N) % 32 + 32) % 32;
}

// NT 16-row tiles; EVEN: N is even, so column pairs (2t, 2t + 1) of the
// bias and mask are 8-byte aligned and both in or both out of range
template <int NT, bool EVEN>
__global__ void __launch_bounds__(32 * NT)
    window_attn_bwd_kernel(const Params p) {
  constexpr int NP = 16 * NT;        // padded rows and keys
  constexpr int kThreadsNT = 32 * NT;
  constexpr int kChunks = kD / 8;    // 16-byte chunks per row
  constexpr int kPRow = NP + kPad;   // a P / dS row, bf16
  extern __shared__ __align__(16) unsigned char smem[];
  auto sIn = reinterpret_cast<__nv_bfloat16(*)[NP][kRow]>(smem);  // q k v dO
  auto sP = reinterpret_cast<__nv_bfloat16(*)[kPRow]>(smem + sizeof(
      __nv_bfloat16) * 4 * NP * kRow);
  auto sdS = sP + NP;
  float* sT = reinterpret_cast<float*>(smem + sizeof(__nv_bfloat16) *
                                       (4 * NP * kRow + 2 * NP * kPRow));
  __nv_bfloat16(*sQ)[kRow] = sIn[kQ];
  __nv_bfloat16(*sK)[kRow] = sIn[kK];
  __nv_bfloat16(*sV)[kRow] = sIn[kV];
  __nv_bfloat16(*sdO)[kRow] = sIn[kDO];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int N = p.N;
  const int ld = p.ld;
  const int j = blockIdx.x % p.nW;          // the mask row
  const int chunk = blockIdx.x / p.nW;
  const int h = blockIdx.y;
  const int H = gridDim.y;
  const long long images = p.Bn / p.nW;
  const long long b_begin = images * chunk / p.chunks;
  const long long b_end = images * (chunk + 1) / p.chunks;
  const int r0 = warp * 16 + g;
  const int rows[2] = {r0, r0 + 8};

  // this thread's fragment of dbias[h], summed over the block's windows
  float db[2 * NT][4];
#pragma unroll
  for (int nt = 0; nt < 2 * NT; ++nt) {
    db[nt][0] = db[nt][1] = db[nt][2] = db[nt][3] = 0.f;
  }

  // bias[h] + mask[j], fp32, once for all of the block's windows (the
  // first barrier of the window loop publishes it)
  {
    const float* bias_h = p.bias + static_cast<long long>(h) * N * N;
    const float* mask_j =
        p.mask == nullptr ? nullptr
                          : p.mask + static_cast<long long>(j) * N * N;
    for (int e = threadIdx.x; e < N * N; e += kThreadsNT) {
      sT[(e / N) * ld + e % N] =
          mask_j == nullptr ? bias_h[e] : bias_h[e] + mask_j[e];
    }
  }

  for (long long b = b_begin; b < b_end; ++b) {
    const long long win = b * p.nW + j;
    __syncthreads();  // every warp is done with the previous window's tiles
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const __nv_bfloat16* base =
          p.in[m] + win * p.stride[m][0] + h * p.stride[m][2];
      for (int c = threadIdx.x; c < NP * kChunks; c += kThreadsNT) {
        const int r = c / kChunks;
        const int col = (c % kChunks) * 8;
        const bool ok = r < N;
        cp_async16(&sIn[m][r][col],
                   base + (ok ? r * p.stride[m][1] : 0) + col, ok);
      }
    }
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();

    // this warp's queries and output gradients as A-fragments
    uint32_t qf[kD / 16][4];
    uint32_t dof[kD / 16][4];
    load_a_frags<kD>(qf, sQ, r0, t);
    load_a_frags<kD>(dof, sdO, r0, t);

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

    // scale, then bias + mask in fp32; keys >= N excluded; row max
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
          const float* at = sT + row * ld + col;
          if (EVEN) {
            if (col < N) {
              const float2 b = *reinterpret_cast<const float2*>(at);
              x0 += b.x;
              x1 += b.y;
            }
          } else {
            if (col < N) x0 += at[0];
            if (col + 1 < N) x1 += at[1];
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
    float inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      inv[i] = rows[i] < N ? 1.f / l[i] : 0.f;   // rows >= N: P = 0
    }

    // P normalised in fp32; bf16 P to shared memory for dV
#pragma unroll
    for (int nt = 0; nt < 2 * NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] *= inv[e >> 1];
      const int col = nt * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(&sP[r0][col]) =
          pack_bf16x2(s[nt][0], s[nt][1]);
      *reinterpret_cast<uint32_t*>(&sP[r0 + 8][col]) =
          pack_bf16x2(s[nt][2], s[nt][3]);
    }

    // Di = rowsum(P o dP), dP = dO V^T one n-tile at a time
    float di[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 2 * NT; ++nt) {
      float dp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        const uint32_t b0 = lds32(&sV[nt * 8 + g][kk * 16 + 2 * t]);
        const uint32_t b1 = lds32(&sV[nt * 8 + g][kk * 16 + 8 + 2 * t]);
        mma_bf16_16816(dp, dof[kk], b0, b1);
      }
      di[0] += s[nt][0] * dp[0] + s[nt][1] * dp[1];
      di[1] += s[nt][2] * dp[2] + s[nt][3] * dp[3];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      di[i] += __shfl_xor_sync(0xffffffffu, di[i], 1);
      di[i] += __shfl_xor_sync(0xffffffffu, di[i], 2);
    }

    // dS = P o (dP - Di), dP again; fp32 dS into the dbias sums and in
    // place of P; bf16 dS to shared memory for dK
#pragma unroll
    for (int nt = 0; nt < 2 * NT; ++nt) {
      float dp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        const uint32_t b0 = lds32(&sV[nt * 8 + g][kk * 16 + 2 * t]);
        const uint32_t b1 = lds32(&sV[nt * 8 + g][kk * 16 + 8 + 2 * t]);
        mma_bf16_16816(dp, dof[kk], b0, b1);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float ds = s[nt][e] * (dp[e] - di[e >> 1]);
        db[nt][e] += ds;
        s[nt][e] = ds;
      }
      const int col = nt * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(&sdS[r0][col]) =
          pack_bf16x2(s[nt][0], s[nt][1]);
      *reinterpret_cast<uint32_t*>(&sdS[r0 + 8][col]) =
          pack_bf16x2(s[nt][2], s[nt][3]);
    }

    // dQ = bf16(dS) K * scale: k-steps of 16 keys from registers
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
        uint32_t bk[4];
        ldmatrix_x4_trans(bk, &sK[row][dt * 8 + (lane >> 4) * 8]);
        mma_bf16_16816(acc[dt], a, bk[0], bk[1]);
        mma_bf16_16816(acc[dt + 1], a, bk[2], bk[3]);
      }
    }
    const float scale2[2] = {p.scale, p.scale};
    store_rows<kD>(p.out[0] + win * p.stride[kDQ][0] + h * p.stride[kDQ][2],
                   p.stride[kDQ][1], acc, r0, N, t, scale2);
    __syncthreads();  // every warp's P and dS rows are in shared memory

    // dV = bf16(P)^T dO and dK = bf16(dS)^T Q * scale for this warp's 16
    // keys: P^T and dS^T as A-fragments through ldmatrix.trans, k-steps
    // of 16 queries
    float dva[kD / 8][4];
    float dka[kD / 8][4];
#pragma unroll
    for (int i = 0; i < kD / 8; ++i) {
      dva[i][0] = dva[i][1] = dva[i][2] = dva[i][3] = 0.f;
      dka[i][0] = dka[i][1] = dka[i][2] = dka[i][3] = 0.f;
    }
    const int key0 = warp * 16;
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      // matrices (queries 0-7 | 8-15) x (keys 0-7 | 8-15) of the step
      const int prow = kk * 16 + (lane & 7) + ((lane >> 4) << 3);
      const int pcol = key0 + ((lane >> 3) & 1) * 8;
      uint32_t ap[4];
      uint32_t as[4];
      ldmatrix_x4_trans(ap, &sP[prow][pcol]);
      ldmatrix_x4_trans(as, &sdS[prow][pcol]);
      const int row = kk * 16 + (lane & 15);
#pragma unroll
      for (int dt = 0; dt < kD / 8; dt += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, &sdO[row][dt * 8 + (lane >> 4) * 8]);
        mma_bf16_16816(dva[dt], ap, b[0], b[1]);
        mma_bf16_16816(dva[dt + 1], ap, b[2], b[3]);
        ldmatrix_x4_trans(b, &sQ[row][dt * 8 + (lane >> 4) * 8]);
        mma_bf16_16816(dka[dt], as, b[0], b[1]);
        mma_bf16_16816(dka[dt + 1], as, b[2], b[3]);
      }
    }
    const float one[2] = {1.f, 1.f};
    store_rows<kD>(p.out[2] + win * p.stride[kDV][0] + h * p.stride[kDV][2],
                   p.stride[kDV][1], dva, key0 + g, N, t, one);
    store_rows<kD>(p.out[1] + win * p.stride[kDK][0] + h * p.stride[kDK][2],
                   p.stride[kDK][1], dka, key0 + g, N, t, scale2);
  }

  // this block's (N, N) partial of dbias[h]
  float* part =
      p.partial + (static_cast<long long>(blockIdx.x) * H + h) * N * N;
#pragma unroll
  for (int nt = 0; nt < 2 * NT; ++nt) {
    const int col = nt * 8 + 2 * t;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = rows[i];
      if (row >= N) continue;
      const long long at = static_cast<long long>(row) * N + col;
      if (EVEN) {
        if (col < N) {
          *reinterpret_cast<float2*>(part + at) =
              make_float2(db[nt][2 * i], db[nt][2 * i + 1]);
        }
      } else {
        if (col < N) part[at] = db[nt][2 * i];
        if (col + 1 < N) part[at + 1] = db[nt][2 * i + 1];
      }
    }
  }
}

// dbias[i] = sum over blocks c of partial[c][i], in block order
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

template <int NT>
cudaError_t launch(const Params& p, int H, float* dbias, cudaStream_t s) {
  constexpr int NP = 16 * NT;
  const int smem = static_cast<int>(
      sizeof(__nv_bfloat16) * (4 * NP * kRow + 2 * NP * (NP + kPad)) +
      sizeof(float) * p.N * p.ld);
  void (*kernel)(const Params) = p.N % 2 == 0
                                     ? &window_attn_bwd_kernel<NT, true>
                                     : &window_attn_bwd_kernel<NT, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int parts = p.chunks * p.nW;
  kernel<<<dim3(parts, H), 32 * NT, smem, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long count = static_cast<long long>(H) * p.N * p.N;
  const int blocks = static_cast<int>((count + 255) / 256 < 2048
                                          ? (count + 255) / 256
                                          : 2048);
  dbias_reduce_kernel<<<blocks, 256, 0, s>>>(p.partial, dbias, count,
                                             parts);
  return cudaGetLastError();
}

}  // namespace

// strides: 21 element strides, (window, row, head) for q, k, v, dO, dq, dk,
// dv in that order.  The Bn windows are Bn / nW images of nW windows (nW =
// 1 without a mask); chunks (1 <= chunks <= Bn / nW) splits the images.
// partial is (chunks * nW, H, N, N) fp32 scratch, dbias the (H, N, N) fp32
// result.
extern "C" int window_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* dout, void* dq,
    void* dk, void* dv, const void* bias, const void* mask, void* partial,
    void* dbias, int Bn, int H, int N, int D, int nW, int chunks,
    const long long* strides, float scale, void* stream) {
  if (D != kD || N < 1 || N > 16 * kMaxTiles || nW < 1 || Bn % nW ||
      chunks < 1 || chunks > Bn / nW || H < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.in[0] = static_cast<const __nv_bfloat16*>(q);
  p.in[1] = static_cast<const __nv_bfloat16*>(k);
  p.in[2] = static_cast<const __nv_bfloat16*>(v);
  p.in[3] = static_cast<const __nv_bfloat16*>(dout);
  p.out[0] = static_cast<__nv_bfloat16*>(dq);
  p.out[1] = static_cast<__nv_bfloat16*>(dk);
  p.out[2] = static_cast<__nv_bfloat16*>(dv);
  p.bias = static_cast<const float*>(bias);
  p.mask = static_cast<const float*>(mask);
  p.partial = static_cast<float*>(partial);
  for (int i = 0; i < kNumTensors; ++i) {
    for (int j = 0; j < 3; ++j) p.stride[i][j] = strides[3 * i + j];
  }
  p.Bn = Bn;
  p.N = N;
  p.nW = nW;
  p.chunks = chunks;
  p.ld = table_ld(N);
  p.scale = scale;
  float* db = static_cast<float*>(dbias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((N + 15) / 16) {
    case 1: return static_cast<int>(launch<1>(p, H, db, s));
    case 2: return static_cast<int>(launch<2>(p, H, db, s));
    case 3: return static_cast<int>(launch<3>(p, H, db, s));
    case 4: return static_cast<int>(launch<4>(p, H, db, s));
    case 5: return static_cast<int>(launch<5>(p, H, db, s));
    case 6: return static_cast<int>(launch<6>(p, H, db, s));
    case 7: return static_cast<int>(launch<7>(p, H, db, s));
    case 8: return static_cast<int>(launch<8>(p, H, db, s));
    case 9: return static_cast<int>(launch<9>(p, H, db, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
