// The attention and output projection of a ViT block for Hopper (sm_90a),
// bf16 in / bf16 out, fp32 accumulation:
//   out = bf16(concat_h bf16(softmax(scale q_h k_h^T) v_h) W_proj^T + b)
// over the qkv projection (T = B N rows of 3C, columns in (3, H, D) order)
// of B images of N tokens.
//
// Together with window_gemm.cu's product, which writes that qkv projection
// (bf16(x W_qkv^T + b)), this replaces the Pallas TPU kernels
// vit_torch_tpu/ops/attn_block.py: _kernel (attention_block, "B3") and
// _kernel_packed (attention_block_packed, "B4").  The TPU kernels ran the
// whole block in one program per image (B3) or per 128-row pack of images
// (B4) with the 4 C^2 weights resident in VMEM.  4 C^2 bf16 is 1.2 MB at
// C = 384 and 4.7 MB at C = 768: no SM holds it, so on Hopper the block is
// two launches.  The qkv product is a plain GEMM.  This kernel keeps what
// the TPU kept out of device memory after it: the scores, the probabilities
// and the heads' outputs, which never leave the SM; only the output rows
// are written.  Computing q inside this kernel, as the TPU kernel did,
// would need the 64 x C token tile and the 64 x C head outputs in shared
// memory together, 2 x 97 KB at C = 768 beside the key/value ring: past the
// 227 KB a block may use.  So q comes from the product too, at the cost of
// writing and reading 2 B N C bytes more (19 MB at dino_vits16 bs64, ~6 us
// at 3.35 TB/s).  Fragments are read with 32-bit shared loads: ldmatrix
// measured 2-4% slower here on an H100, so the kernel is not bound by the
// number of load instructions.
//
// Design.  One block of 4 warps takes 64 query rows, each warp 16:
// - B3 (group = 0): rows [64 t, 64 t + 64) of image b, grid (ceil(N/64), B);
// - B4 (group = G = 64 / N): the G whole images [G i, G i + G), grid
//   ceil(B / G).  The block-diagonal mask of the TPU kernel becomes a key
//   range per query row: its own image's rows.  No padding of x or of the
//   batch: rows past the end are zero-filled and never written.
// 1. The block's q rows (64 x C) go to shared memory by cp.async.
// 2. For every head, over the key rows of the block's images in 64-key
//    tiles (K_h and V_h, cp.async, a 3-stage ring over the (head, tile)
//    sequence so the next tiles load while this one computes): S = Q K^T
//    and O += P V on mma.sync.m16n8k16 bf16 -> fp32, keys outside the row's
//    image masked, an online softmax (running max m, running sum l of the
//    unrounded fp32 P; P rounded to bf16 for PV as the TPU kernel rounds
//    its unnormalised exp(s - m)).  At the head's last tile O / l is
//    rounded to bf16 and written over the head's q columns in shared
//    memory: its q is in registers by then, and each warp touches only its
//    own 16 rows.
// 3. The 64 x C head outputs times W_proj^T, 64 output columns at a time,
//    W_proj (nn.Linear layout, (out, in): K-contiguous, as mma's col
//    operand wants it) streamed in 64 x 64 tiles through a 3-stage ring in
//    the same shared memory as the key/value tiles; bias added in fp32,
//    rounded once, each output row written once.
//
// Bound at dino_vits16 @224 bs64 (B = 64, N = 197, C = 384): 8 B N C^2 +
// 4 B N^2 C = 18.7 GFLOP (18.9 us at 989 TFLOP/s) against ~22 MB of x,
// weights and output (6.5 us at 3.35 TB/s): bound by operations.  With
// mma.sync and no wgmma or TMA this first version cannot reach it; each
// block also streams all of W_proj from L2 (C^2 bf16 per 64 rows).
//
// C entry point (ctypes): attn_block_bf16(...) returns the cudaError_t of
// the launch; it launches on the given stream and does not synchronise or
// allocate.

#include "flash_common.cuh"

namespace {

constexpr int kStages = 3;           // depth of both cp.async rings
constexpr int kWTile = 64;           // W_proj tile: 64 outputs x 64 inputs
constexpr int kLdW = kWTile + kPad;
constexpr int kMaxC = 1024;
static_assert(kBlockM == 16 * kWarps, "one warp per 16 query rows");

struct Params {
  const __nv_bfloat16* qkv;   // (T, 3C) rows, columns (3, H, D)
  const __nv_bfloat16* w;     // W_proj (C, C), (out, in)
  const __nv_bfloat16* bias;  // (C) or null
  __nv_bfloat16* out;         // (T, C)
  int T, N, C, H;
  int group;                  // images per block (B4), or 0 (B3)
  float scale_log2;           // scale * log2(e): softmax runs in base 2
};

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

template <int D>
constexpr int kv_tile_elems() { return kBlockN * (D + kPad); }

// dynamic shared memory: the 64 x C q / head-output tile, then a union of
// the key/value ring and the W_proj ring
template <int D>
constexpr int ring_bytes() {
  return (2 * kStages * kv_tile_elems<D>() > kStages * kWTile * kLdW
              ? 2 * kStages * kv_tile_elems<D>()
              : kStages * kWTile * kLdW) * 2;
}

inline int smem_bytes(int C, int D) {
  const int tile = kBlockM * (C + kPad) * 2;
  return tile + (D == 64 ? ring_bytes<64>() : ring_bytes<32>());
}

template <int D>
__global__ void __launch_bounds__(kThreads) attn_block_kernel(const Params p) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  typedef __nv_bfloat16 KVTile[kBlockN][D + kPad];
  typedef __nv_bfloat16 WTile[kWTile][kLdW];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int C = p.C;
  const int N = p.N;
  const int ldA = C + kPad;
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  unsigned char* ring = smem_raw + kBlockM * ldA * 2;
  KVTile* sK = reinterpret_cast<KVTile*>(ring);   // sK[stage], sV[stage]
  KVTile* sV = sK + kStages;
  WTile* sW = reinterpret_cast<WTile*>(ring);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;   // fragment row within the 8-row group
  const int t = lane & 3;    // fragment column pair
  const long long ld = 3LL * C;

  // the block's query rows [q_lo, q_hi) and key rows [k_lo, k_hi), flat
  // over (image, token); the key rows cover whole images
  int q_lo, q_hi;
  if (p.group > 0) {
    q_lo = blockIdx.x * p.group * N;
    q_hi = min(q_lo + p.group * N, p.T);
  } else {
    const int img0 = blockIdx.y * N;
    q_lo = img0 + blockIdx.x * kBlockM;
    q_hi = min(q_lo + kBlockM, img0 + N);
  }
  const int k_lo = (q_lo / N) * N;
  const int k_hi = ((q_hi - 1) / N + 1) * N;
  const int n_kt = (k_hi - k_lo + kBlockN - 1) / kBlockN;

  // this thread's rows r0 and r0 + 8: the key range of each one's image
  // (a row past q_hi takes the last valid row's, so that it stays finite)
  const int r0 = warp * 16 + g;
  int key_lo[2], key_hi[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = min(q_lo + r0 + 8 * i, q_hi - 1);
    key_lo[i] = (row / N) * N;
    key_hi[i] = key_lo[i] + N;
  }

  // 1. the q rows
  for (int c = threadIdx.x; c < kBlockM * (C / 8); c += kThreads) {
    const int r = c / (C / 8);
    const int col = (c - r * (C / 8)) * 8;
    const bool ok = q_lo + r < q_hi;
    cp_async16(sA + r * ldA + col,
               p.qkv + (ok ? (q_lo + r) * ld + col : 0), ok);
  }
  cp_async_commit();

  // 2. attention, head by head, over the (head, key tile) sequence
  const int n_attn = p.H * n_kt;
  auto load_kv = [&](int j) {
    const int h = j / n_kt;
    const int k0 = k_lo + (j - h * n_kt) * kBlockN;
    const int st = j % kStages;
    for (int c = threadIdx.x; c < kBlockN * (D / 8); c += kThreads) {
      const int r = c / (D / 8);
      const int col = (c - r * (D / 8)) * 8;
      const bool ok = k0 + r < k_hi;
      const __nv_bfloat16* src =
          p.qkv + (ok ? (k0 + r) * ld : 0) + C + h * D + col;
      cp_async16(&sK[st][r][col], src, ok);
      cp_async16(&sV[st][r][col], src + C, ok);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_attn) load_kv(s);
    cp_async_commit();
  }

  uint32_t qf[D / 16][4];
  float acc[D / 8][4];
  float m_run[2], l_run[2];
  for (int j = 0; j < n_attn; ++j) {
    cp_async_wait<kStages - 2>();   // tile j (and the q rows) landed
    __syncthreads();                // and every warp is done with j - 1
    if (j + kStages - 1 < n_attn) load_kv(j + kStages - 1);
    cp_async_commit();
    const int h = j / n_kt;
    const int kt = j - h * n_kt;
    const int st = j % kStages;
    if (kt == 0) {
      // q_h as A-fragments: rows r0 and r0 + 8, k-steps of 16 along D
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const __nv_bfloat16* a = sA + r0 * ldA + h * D + kk * 16 + 2 * t;
        qf[kk][0] = lds32(a);
        qf[kk][1] = lds32(a + 8 * ldA);
        qf[kk][2] = lds32(a + 8);
        qf[kk][3] = lds32(a + 8 * ldA + 8);
      }
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
      }
      m_run[0] = m_run[1] = -INFINITY;
      l_run[0] = l_run[1] = 0.f;
    }

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[kBlockN / 8][4];
    mma_abt<D>(s, qf, sK[st], g, t);
    const int k0 = k_lo + kt * kBlockN;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int col = k0 + nt * 8 + 2 * t + (e & 1);
        const float x = (col >= key_lo[i] && col < key_hi[i])
                            ? s[nt][e] * p.scale_log2
                            : -INFINITY;
        s[nt][e] = x;
        mx[i] = fmaxf(mx[i], x);
      }
    }
    float alpha[2], m_use[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // the 4 threads of a quad share a row
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_run[i], mx[i]);
      // a row with no key yet keeps P = 0 instead of exp(-inf + inf)
      m_use[i] = m_new == -INFINITY ? 0.f : m_new;
      alpha[i] = exp2f(m_run[i] - m_use[i]);
      m_run[i] = m_new;
      l_run[i] *= alpha[i];
    }
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = exp2f(s[nt][e] - m_use[e >> 1]);
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
    mma_pv<D>(acc, s, sV[st], lane);

    if (kt == n_kt - 1) {
      // the head's output, normalised and rounded, over its q columns
      float inv[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float l = l_run[i];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        inv[i] = l > 0.f ? 1.f / l : 0.f;
      }
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        __nv_bfloat16* o = sA + r0 * ldA + h * D + dt * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(o) =
            pack_bf16x2(acc[dt][0] * inv[0], acc[dt][1] * inv[0]);
        *reinterpret_cast<uint32_t*>(o + 8 * ldA) =
            pack_bf16x2(acc[dt][2] * inv[1], acc[dt][3] * inv[1]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // every warp is done with the key/value ring

  // 3. the output projection, 64 columns at a time
  const int k_tiles = C / kWTile;
  const int n_proj = k_tiles * k_tiles;
  auto load_w = [&](int j) {
    const int nc = j / k_tiles;
    const int kt = j - nc * k_tiles;
    const int st = j % kStages;
    for (int c = threadIdx.x; c < kWTile * (kWTile / 8); c += kThreads) {
      const int r = c / (kWTile / 8);
      const int col = (c - r * (kWTile / 8)) * 8;
      cp_async16(&sW[st][r][col],
                 p.w + static_cast<long long>(nc * kWTile + r) * C +
                     kt * kWTile + col,
                 true);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_proj) load_w(s);
    cp_async_commit();
  }
  float pacc[kWTile / 8][4];
  for (int j = 0; j < n_proj; ++j) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (j + kStages - 1 < n_proj) load_w(j + kStages - 1);
    cp_async_commit();
    const int nc = j / k_tiles;
    const int kt = j - nc * k_tiles;
    const int st = j % kStages;
    if (kt == 0) {
#pragma unroll
      for (int nt = 0; nt < kWTile / 8; ++nt) {
        pacc[nt][0] = pacc[nt][1] = pacc[nt][2] = pacc[nt][3] = 0.f;
      }
    }
#pragma unroll
    for (int kk = 0; kk < kWTile / 16; ++kk) {
      uint32_t a[4];
      const __nv_bfloat16* ap = sA + r0 * ldA + kt * kWTile + kk * 16 + 2 * t;
      a[0] = lds32(ap);
      a[1] = lds32(ap + 8 * ldA);
      a[2] = lds32(ap + 8);
      a[3] = lds32(ap + 8 * ldA + 8);
#pragma unroll
      for (int nt = 0; nt < kWTile / 8; ++nt) {
        const uint32_t b0 = lds32(&sW[st][nt * 8 + g][kk * 16 + 2 * t]);
        const uint32_t b1 = lds32(&sW[st][nt * 8 + g][kk * 16 + 8 + 2 * t]);
        mma_bf16_16816(pacc[nt], a, b0, b1);
      }
    }
    if (kt == k_tiles - 1) {
#pragma unroll
      for (int nt = 0; nt < kWTile / 8; ++nt) {
        const int col = nc * kWTile + nt * 8 + 2 * t;
        float b0 = 0.f, b1 = 0.f;
        if (p.bias != nullptr) {
          const __nv_bfloat162 bv =
              *reinterpret_cast<const __nv_bfloat162*>(p.bias + col);
          b0 = __low2float(bv);
          b1 = __high2float(bv);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = q_lo + r0 + 8 * i;
          if (row < q_hi) {
            *reinterpret_cast<uint32_t*>(
                p.out + static_cast<long long>(row) * C + col) =
                pack_bf16x2(pacc[nt][2 * i] + b0, pacc[nt][2 * i + 1] + b1);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
}

template <int D>
cudaError_t launch(const Params& p, dim3 grid, cudaStream_t s) {
  static int configured = 0;   // the largest dynamic smem allowed so far
  const int bytes = smem_bytes(p.C, D);
  if (bytes > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        attn_block_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return err;
    configured = bytes;
  }
  attn_block_kernel<D><<<grid, kThreads, bytes, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int attn_block_bf16(const void* qkv, const void* w,
                               const void* bias, void* out, int B, int N,
                               int C, int H, int group, float scale,
                               void* stream) {
  if (B < 1 || N < 1 || H < 1 || C % 64 || C > kMaxC || C % H ||
      group < 0 || group * N > kBlockM ||
      static_cast<long long>(B) * N * 3 * C > 0x7fffffffLL ||
      (group == 0 && B > 65535)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int D = C / H;
  Params p;
  p.qkv = static_cast<const __nv_bfloat16*>(qkv);
  p.w = static_cast<const __nv_bfloat16*>(w);
  p.bias = static_cast<const __nv_bfloat16*>(bias);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.T = B * N;
  p.N = N;
  p.C = C;
  p.H = H;
  p.group = group;
  p.scale_log2 = scale * kLog2e;
  const dim3 grid = group > 0
                        ? dim3((B + group - 1) / group, 1)
                        : dim3((N + kBlockM - 1) / kBlockM, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return static_cast<int>(launch<64>(p, grid, s));
  if (D == 32) return static_cast<int>(launch<32>(p, grid, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
