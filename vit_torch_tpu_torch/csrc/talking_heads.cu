// CaiT talking-heads attention forward for Hopper (sm_90a), bf16 in / bf16
// out.
//
// Replaces the Pallas TPU kernels vit_torch_tpu/ops/talking_heads.py:
// _kernel (pallas_call at :96, the (B, H, N, D) layout) and _kernel_v2
// (pallas_call at :272, the head-concatenated (B, N, C) layout).  Both
// compute one function, which this kernel reads through strides from
// either layout.  For image b, head j and query row n, with the (H, H) fp32
// mixing tables wl, ww and the (H,) fp32 biases bl, bw:
//   S_i  = scale * Q_i K_i^T                          (fp32, per head i)
//   S'_j = sum_i wl[i, j] S_i + bl[j]                  (pre-softmax mix)
//   P_j  = softmax of S'_j over the N keys             (exact, fp32)
//   A_j  = bf16(sum_i ww[i, j] P_i + bw[j])            (post-softmax mix)
//   O_j  = A_j V_j                                     (fp32 sum, bf16 out)
// which are the einsum reference's rounding points (_ref_forward: fp32
// scores, fp32 mixes and softmax, the mixed weights rounded to the
// activation dtype for PV).
//
// Design.  The mixes couple every head at every score element, and the
// post-softmax mix needs every head's normalised P, so a row cannot be
// finished head by head with an online softmax.  The TPU kernel keeps H
// fp32 (N, N) score stacks in VMEM; on the card that is 803 KB per image at
// cait_m48_448 (H = 16, N = 784), far beyond a block's shared memory.  So:
//
// - One block per (16 query rows, image), 8 warps.  Q's 16 rows of all H
//   heads stay in shared memory; K and V stream through it in tiles of 32
//   keys (cp.async, rows >= N zero-filled), the next tile's K loading while
//   the current one is mixed and its V while the next scores are formed.
// - Two passes over the keys.  Pass 1 forms S'_j tile by tile and keeps a
//   running max and sum per (row, head) for the columns each thread owns;
//   the 16 threads of a row merge theirs at the end.  Pass 2 forms S'_j
//   again, normalises it exactly, mixes with ww, rounds A_j to bf16 in
//   shared memory and accumulates O_j = A_j V_j on the tensor cores.
// - Per head, S_i = Q_i K_i^T runs on mma.sync.m16n8k16 (bf16 -> fp32)
//   over D, so the tensor cores do the least product work: the scores
//   twice and PV once, 6 * N^2 * C flops per image.  (The TPU's v2 form
//   folds the pre-mix into an H-times-wider contraction; here the mixes
//   are H^2 fp32 FMAs per score element on the CUDA cores, from tables in
//   shared memory padded to MH heads so that the loops are static.)
// - PV: each warp owns heads warp and warp + 8; A comes from shared memory
//   as A fragments, V's B fragments through ldmatrix.trans.
//
// Shared memory: (16 + 2 * 32) rows of H * D + 8 bf16, H score planes of
// 16 x 36 fp32, H planes of 16 x 40 bf16 for A, and the tables: 185.7 KB
// at H = 16, D = 48 (one block per SM), 91.4 KB at cait_s24 (two).
//
// Bound at cait_s24_224 bs32, (B, H, N, D) = (32, 8, 196, 48): the least
// work is QK^T and PV, 4 * B * H * N^2 * D = 1.89 GFLOP, plus the two
// mixes, 4 * B * H^2 * N^2 = 0.31 GFLOP (2.2 us at 989 TFLOP/s), against
// q, k, v read and o written, 4 * B * N * H * D * 2 = 19.3 MB (5.8 us at
// 3.35 TB/s): bound by bytes.  This version does 3x the minimal product
// work, reads K twice and V once per 16 query rows (from L2), and runs the
// mixes and softmax on the CUDA cores.
//
// C entry point (ctypes): talking_heads_fwd_bf16(...) returns the
// cudaError_t of the launch; it launches on the given stream and does not
// synchronise or allocate.

#include "flash_common.cuh"

namespace {

constexpr int kRows = 16;           // query rows per block
constexpr int kKeys = 32;           // keys per streamed tile
constexpr int kWarpsTH = 8;
constexpr int kThreadsTH = 32 * kWarpsTH;
constexpr int kSLd = kKeys + 4;     // fp32 score row, padded
constexpr int kALd = kKeys + kPad;  // bf16 A row, padded
constexpr int kMaxHeads = 16;
static_assert(kRows * kKeys == 2 * kThreadsTH, "one column pair a thread");

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  const float* wl;  // (H, H), wl[i, j] mixes score head i into j
  const float* bl;  // (H,)
  const float* ww;  // (H, H)
  const float* bw;  // (H,)
  // element strides: [tensor][batch, head, row] for tensor in q, k, v, o
  long long stride[4][3];
  // element strides of the tables: wl (i, j), ww (i, j), bl, bw; the model
  // passes Linear(H, H) weights transposed, as views
  long long tstride[6];
  int H;
  int N;
  float scale;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// l * exp(m - M): a running sum rescaled to a new max M >= m; an empty sum
// (m = -inf) stays 0.
__device__ __forceinline__ float rescale(float l, float m, float M) {
  return m == -INFINITY ? 0.f : l * exp2f((m - M) * kLog2e);
}

// Starts copying rows [row0, row0 + rows) of all H heads of one image into
// a shared [rows][H * D + kPad] tile, 16 bytes per thread per step; rows
// >= N are zero-filled.  `stride` is (head, row).
template <int D>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          const long long* stride, int H,
                                          int ld, int row0, int rows, int N) {
  constexpr int kChunks = D / 8;
  const int per_row = H * kChunks;
  for (int c = threadIdx.x; c < rows * per_row; c += kThreadsTH) {
    const int r = c / per_row;
    const int rem = c - r * per_row;
    const int h = rem / kChunks;
    const int col = (rem - h * kChunks) * 8;
    const bool ok = row0 + r < N;
    const __nv_bfloat16* g =
        src + h * stride[0] + (ok ? (row0 + r) * stride[1] : 0) + col;
    cp_async16(dst + r * ld + h * D + col, g, ok);
  }
}

// sS[i][r][c] = scale * (Q_i K_i^T)[r][c] for the block's 16 query rows and
// the tile's 32 keys; work items (head, 16-key half) over the warps.
template <int D>
__device__ __forceinline__ void scores(float* sS, const __nv_bfloat16* sQ,
                                       const __nv_bfloat16* sK, int H, int ld,
                                       float scale, int warp, int g, int t) {
  for (int item = warp; item < 2 * H; item += kWarpsTH) {
    const int h = item >> 1;
    const int n0 = (item & 1) * 16;
    const __nv_bfloat16* q = sQ + h * D + 2 * t;
    const __nv_bfloat16* k = sK + h * D + 2 * t;
    float acc[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      a[0] = lds32(q + g * ld + kk * 16);
      a[1] = lds32(q + (g + 8) * ld + kk * 16);
      a[2] = lds32(q + g * ld + kk * 16 + 8);
      a[3] = lds32(q + (g + 8) * ld + kk * 16 + 8);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const __nv_bfloat16* kr = k + (n0 + nt * 8 + g) * ld + kk * 16;
        mma_bf16_16816(acc[nt], a, lds32(kr), lds32(kr + 8));
      }
    }
    float* s = sS + h * kRows * kSLd;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int col = n0 + nt * 8 + 2 * t;
      *reinterpret_cast<float2*>(s + g * kSLd + col) =
          make_float2(acc[nt][0] * scale, acc[nt][1] * scale);
      *reinterpret_cast<float2*>(s + (g + 8) * kSLd + col) =
          make_float2(acc[nt][2] * scale, acc[nt][3] * scale);
    }
  }
}

// x[j] = bias[j] + sum_i w[i][j] * s[i] for a column pair, over MH heads
// (tables zero-padded past H, planes past H read as 0)
template <int MH>
__device__ __forceinline__ void mix(float2 x[MH], const float2 s[MH],
                                   const float* w, const float* bias) {
#pragma unroll
  for (int j = 0; j < MH; ++j) x[j] = make_float2(bias[j], bias[j]);
#pragma unroll
  for (int i = 0; i < MH; ++i) {
#pragma unroll
    for (int j = 0; j < MH; j += 4) {
      const float4 c = *reinterpret_cast<const float4*>(w + i * MH + j);
      x[j].x = fmaf(c.x, s[i].x, x[j].x);
      x[j].y = fmaf(c.x, s[i].y, x[j].y);
      x[j + 1].x = fmaf(c.y, s[i].x, x[j + 1].x);
      x[j + 1].y = fmaf(c.y, s[i].y, x[j + 1].y);
      x[j + 2].x = fmaf(c.z, s[i].x, x[j + 2].x);
      x[j + 2].y = fmaf(c.z, s[i].y, x[j + 2].y);
      x[j + 3].x = fmaf(c.w, s[i].x, x[j + 3].x);
      x[j + 3].y = fmaf(c.w, s[i].y, x[j + 3].y);
    }
  }
}

// MH: the heads rounded up to 4, 8 or 16 (the static loop bound of the
// mixes); each warp owns heads warp and warp + 8 in PV.
template <int D, int MH>
__global__ void __launch_bounds__(kThreadsTH)
    talking_heads_fwd_kernel(const Params p) {
  constexpr int kHPW = (MH + kWarpsTH - 1) / kWarpsTH;  // PV heads a warp
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = p.H;
  const int N = p.N;
  const int ld = H * D + kPad;
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = sQ + kRows * ld;
  __nv_bfloat16* sV = sK + kKeys * ld;
  float* sS = reinterpret_cast<float*>(sV + kKeys * ld);
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(sS + H * kRows * kSLd);
  float* sWl = reinterpret_cast<float*>(sA + H * kRows * kALd);
  float* sWw = sWl + MH * MH;
  float* sBl = sWw + MH * MH;
  float* sBw = sBl + MH;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const long long b = blockIdx.y;
  const int q0 = blockIdx.x * kRows;
  const __nv_bfloat16* qb = p.q + b * p.stride[0][0];
  const __nv_bfloat16* kb = p.k + b * p.stride[1][0];
  const __nv_bfloat16* vb = p.v + b * p.stride[2][0];

  // the tables, zero-padded to MH x MH and MH
  for (int i = tid; i < MH * MH; i += kThreadsTH) {
    const int r = i / MH;
    const int c = i - r * MH;
    const bool in = r < H && c < H;
    sWl[i] = in ? p.wl[r * p.tstride[0] + c * p.tstride[1]] : 0.f;
    sWw[i] = in ? p.ww[r * p.tstride[2] + c * p.tstride[3]] : 0.f;
  }
  for (int i = tid; i < MH; i += kThreadsTH) {
    sBl[i] = i < H ? p.bl[i * p.tstride[4]] : 0.f;
    sBw[i] = i < H ? p.bw[i * p.tstride[5]] : 0.f;
  }

  // the mixes: thread (r, c) owns row r and key columns 2c, 2c + 1 of a tile
  const int r = tid >> 4;
  const int c2 = 2 * (tid & 15);
  const int nkt = (N + kKeys - 1) / kKeys;
  float m[MH], l[MH];
#pragma unroll
  for (int j = 0; j < MH; ++j) {
    m[j] = -INFINITY;
    l[j] = 0.f;
  }

  // ---- pass 1: row max and sum of every mixed head ----
  load_rows<D>(sQ, qb, &p.stride[0][1], H, ld, q0, kRows, N);
  load_rows<D>(sK, kb, &p.stride[1][1], H, ld, 0, kKeys, N);
  cp_async_commit();
  for (int kt = 0; kt < nkt; ++kt) {
    cp_async_wait<0>();
    __syncthreads();
    scores<D>(sS, sQ, sK, H, ld, p.scale, warp, g, t);
    __syncthreads();
    if (kt + 1 < nkt) {
      load_rows<D>(sK, kb, &p.stride[1][1], H, ld, (kt + 1) * kKeys, kKeys,
                   N);
    }
    cp_async_commit();
    float2 s[MH], x[MH];
#pragma unroll
    for (int i = 0; i < MH; ++i) {
      s[i] = i < H ? *reinterpret_cast<const float2*>(
                         sS + (i * kRows + r) * kSLd + c2)
                   : make_float2(0.f, 0.f);
    }
    mix<MH>(x, s, sWl, sBl);
    const int key = kt * kKeys + c2;
#pragma unroll
    for (int j = 0; j < MH; ++j) {
      const float x0 = key < N ? x[j].x : -INFINITY;
      const float x1 = key + 1 < N ? x[j].y : -INFINITY;
      const float mx = fmaxf(x0, x1);
      if (mx == -INFINITY) continue;
      if (mx > m[j]) {
        l[j] = rescale(l[j], m[j], mx);
        m[j] = mx;
      }
      l[j] += exp2f((x0 - m[j]) * kLog2e) + exp2f((x1 - m[j]) * kLog2e);
    }
  }
  // merge the 16 threads of each row (lanes 0-15 and 16-31 of a warp)
#pragma unroll
  for (int j = 0; j < MH; ++j) {
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[j], off);
      const float l2 = __shfl_xor_sync(0xffffffffu, l[j], off);
      const float M = fmaxf(m[j], m2);
      l[j] = rescale(l[j], m[j], M) + rescale(l2, m2, M);
      m[j] = M;
    }
    l[j] = 1.f / l[j];  // every row has a key, so l >= 1
  }

  // ---- pass 2: P, the post-softmax mix, PV ----
  load_rows<D>(sK, kb, &p.stride[1][1], H, ld, 0, kKeys, N);
  cp_async_commit();
  load_rows<D>(sV, vb, &p.stride[2][1], H, ld, 0, kKeys, N);
  cp_async_commit();
  float acc[kHPW][D / 8][4];
#pragma unroll
  for (int i = 0; i < kHPW; ++i) {
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      acc[i][dt][0] = acc[i][dt][1] = acc[i][dt][2] = acc[i][dt][3] = 0.f;
    }
  }
  for (int kt = 0; kt < nkt; ++kt) {
    cp_async_wait<1>();  // K(kt) has landed; V(kt) may be in flight
    __syncthreads();
    scores<D>(sS, sQ, sK, H, ld, p.scale, warp, g, t);
    __syncthreads();
    if (kt + 1 < nkt) {
      load_rows<D>(sK, kb, &p.stride[1][1], H, ld, (kt + 1) * kKeys, kKeys,
                   N);
    }
    cp_async_commit();
    {
      float2 s[MH], x[MH], a[MH];
#pragma unroll
      for (int i = 0; i < MH; ++i) {
        s[i] = i < H ? *reinterpret_cast<const float2*>(
                           sS + (i * kRows + r) * kSLd + c2)
                     : make_float2(0.f, 0.f);
      }
      mix<MH>(x, s, sWl, sBl);
      const int key = kt * kKeys + c2;
      const bool ok0 = key < N;
      const bool ok1 = key + 1 < N;
#pragma unroll
      for (int j = 0; j < MH; ++j) {
        x[j].x = ok0 ? exp2f((x[j].x - m[j]) * kLog2e) * l[j] : 0.f;
        x[j].y = ok1 ? exp2f((x[j].y - m[j]) * kLog2e) * l[j] : 0.f;
      }
      mix<MH>(a, x, sWw, sBw);
#pragma unroll
      for (int j = 0; j < MH; ++j) {
        if (j < H) {
          *reinterpret_cast<uint32_t*>(sA + (j * kRows + r) * kALd + c2) =
              pack_bf16x2(ok0 ? a[j].x : 0.f, ok1 ? a[j].y : 0.f);
        }
      }
    }
    cp_async_wait<1>();  // V(kt) has landed; K(kt + 1) may be in flight
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kHPW; ++i) {
      const int h = warp + i * kWarpsTH;
      if (h >= H) break;
      const __nv_bfloat16* sa = sA + h * kRows * kALd + 2 * t;
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        uint32_t a[4];
        a[0] = lds32(sa + g * kALd + kk * 16);
        a[1] = lds32(sa + (g + 8) * kALd + kk * 16);
        a[2] = lds32(sa + g * kALd + kk * 16 + 8);
        a[3] = lds32(sa + (g + 8) * kALd + kk * 16 + 8);
        const __nv_bfloat16* vr =
            sV + (kk * 16 + (lane & 15)) * ld + h * D + (lane >> 4) * 8;
#pragma unroll
        for (int dt = 0; dt < D / 8; dt += 2) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, vr + dt * 8);
          mma_bf16_16816(acc[i][dt], a, bv[0], bv[1]);
          mma_bf16_16816(acc[i][dt + 1], a, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();
    if (kt + 1 < nkt) {
      load_rows<D>(sV, vb, &p.stride[2][1], H, ld, (kt + 1) * kKeys, kKeys,
                   N);
    }
    cp_async_commit();
  }
  cp_async_wait<0>();

  // O_h rows q0 + g and q0 + g + 8, bf16, through o's strides
#pragma unroll
  for (int i = 0; i < kHPW; ++i) {
    const int h = warp + i * kWarpsTH;
    if (h >= H) break;
    __nv_bfloat16* o = p.o + b * p.stride[3][0] + h * p.stride[3][1];
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const int col = dt * 8 + 2 * t;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = q0 + g + 8 * e;
        if (row < N) {
          *reinterpret_cast<uint32_t*>(o + row * p.stride[3][2] + col) =
              pack_bf16x2(acc[i][dt][2 * e], acc[i][dt][2 * e + 1]);
        }
      }
    }
  }
}

size_t smem_bytes(int D, int H, int MH) {
  const size_t ld = static_cast<size_t>(H) * D + kPad;
  return (kRows + 2 * kKeys) * ld * 2 + H * kRows * kSLd * 4 +
         H * kRows * kALd * 2 + (2 * MH * MH + 2 * MH) * 4;
}

template <int D, int MH>
cudaError_t launch(const Params& p, int B, cudaStream_t s) {
  const size_t smem = smem_bytes(D, p.H, MH);
  auto kernel = talking_heads_fwd_kernel<D, MH>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3((p.N + kRows - 1) / kRows, B), kThreadsTH, smem, s>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(const Params& p, int B, cudaStream_t s) {
  if (p.H <= 4) return launch<D, 4>(p, B, s);
  if (p.H <= 8) return launch<D, 8>(p, B, s);
  return launch<D, 16>(p, B, s);
}

}  // namespace

extern "C" int talking_heads_fwd_bf16(const void* q, const void* k,
                                      const void* v, void* o, const void* wl,
                                      const void* bl, const void* ww,
                                      const void* bw, int B, int H, int N,
                                      int D, const long long* strides,
                                      const long long* table_strides,
                                      float scale, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || H > kMaxHeads || N < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.wl = static_cast<const float*>(wl);
  p.bl = static_cast<const float*>(bl);
  p.ww = static_cast<const float*>(ww);
  p.bw = static_cast<const float*>(bw);
  for (int i = 0; i < 4; ++i) {
    for (int j = 0; j < 3; ++j) p.stride[i][j] = strides[3 * i + j];
  }
  for (int i = 0; i < 6; ++i) p.tstride[i] = table_strides[i];
  p.H = H;
  p.N = N;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return static_cast<int>(launch_d<16>(p, B, s));
    case 32: return static_cast<int>(launch_d<32>(p, B, s));
    case 48: return static_cast<int>(launch_d<48>(p, B, s));
    case 64: return static_cast<int>(launch_d<64>(p, B, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
