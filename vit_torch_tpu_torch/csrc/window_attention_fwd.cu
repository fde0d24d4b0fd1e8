// Swin window-attention forward for Hopper (sm_90a), bf16 in / bf16 out.
//
// Replaces the Pallas TPU kernel vit_torch_tpu/ops/window_attention.py:
// _fwd_kernel (def :76, pallas_call :164, reached through _fwd_impl).  Same
// function, per window i and head h of (Bn, N, H, D) tensors:
//   S = scale * Q K^T + bias[h] + mask[i mod nW]     (fp32)
//   P = exp(S - rowmax(S))                            (fp32, unnormalised)
//   O = (bf16(P) V) / rowsum(P)                       (fp32 sum, bf16 out)
// It is also the attention core of the Swin block chains (window_gemm.cu's
// products around it), which launch it once per block.
//
// Bound on an H100: 4 Bn N H D * 2 bytes of q, k, v and o at 3.35 TB/s
// (swin_base_384 bs32: 0.090, 0.045, 0.023 and 0.011 ms at stages 1-4),
// plus each (head, mask row) table once; the products (4 Bn H N^2 D, 22
// GFLOP at stage 1) take a quarter of that at the tensor cores' rate.  So
// the kernel has to stream q, k, v and o at the memory's rate, and keep the
// per-window work (the bias and mask tables, the softmax's exp on the SFU)
// off that stream.  The first design read each window-head's fp32 bias[h]
// and mask[i mod nW] rows from L2: 166 KB against the 37 KB of q, k, v and
// o it moved, so that stage 1 shifted took 0.630 ms against 0.374
// unshifted (H100 80GB HBM3, 700 W; chip_smoke).
//
// Design.  A window holds at most N = 144 tokens (window 12) and every Swin
// config has D = 32: a whole softmax row fits in registers, so the rows are
// exact (no online rescaling), as in the TPU kernel.
// - Persistent blocks of 384 threads, each owning a group (h, j): head h
//   and mask row j (unmasked, the group is h alone), and a run of that
//   group's windows i = j + nW b (ops/window_attention.py:core_plan splits
//   a group's windows into runs so that the blocks fill the card).  Blocks
//   that run together take the H heads of the same windows, so that the
//   L2 lines of a token's qkv row serve all of them.  Before
//   the first window the consumers stage the group's table in shared
//   memory once: bias[h] + mask[j] summed in fp32, rows of N padded with
//   -inf to the keys' width (which excludes keys >= N) and to a stride of
//   an odd multiple of 8 floats (conflict-free pairs).  Pre-summing moves
//   the rounding from (s + b) + m to s + (b + m); the two differ only
//   where the mask is -100, where P is ~e^-100 of the row's largest either
//   way.  The L2 traffic for the tables falls from 166 KB a window-head to
//   83 KB a block.
// - Warpgroup 2's first thread (setmaxnreg 24) streams each window's Q, K
//   and V by TMA, 4-D maps over the tensors' own (window, row, head)
//   strides (sm90::encode_bf16_bhnd: q, k and v are views into the
//   window-major (Bn, N, 3, H, D) qkv), NK rows each, rows at or past N
//   zero-filled, into a ring of 2-6 mbarrier stages (27 KB a stage at
//   N = 144, 4 stages).
// - Warpgroups 0 and 1 (setmaxnreg 240) take alternate windows.  Per 64-row
//   slice of queries (3 at N = 144; a slice past Q's NK rows reads the
//   next tile's rows, whose scores are never used): S = Q K^T by wgmma
//   m64nNKk16 (NK: the keys padded to 16, 32, 64 or 144; 2 k-steps over
//   D = 32, both operands K-major in the 64-byte swizzle); scale, the
//   staged table and the row max in fp32 on S's registers, P = exp2((S -
//   m) log2 e) on the SFU (a warp whose 16 rows all lie at or past N skips
//   it and takes P = 0: a quarter of the rows at N = 144); P rounded to
//   bf16 stays in registers as the A operand of O = P V (sm90::WgmmaRS, V
//   an MN-major tile), the row sum over the fp32 P; O / l rounded into a
//   64 x 32 slice in the 64-byte swizzle and stored by TMA through o's
//   strides (rows past N are not written).  Storing O from registers
//   instead (bf16 pairs), which gives room for a fifth stage, ran a
//   little slower in development.
// - Shared memory at N = 144: 1 KB of alignment, 4 stages of 27 KB, 24 KB
//   of output slices, the 85.5 KB table, the barriers: 223,840 bytes.
//
// This replaces the port's first design: one block per (window, head),
// ceil(N / 16) warps on mma.sync.m16n8k16, cp.async loads, the fp32 bias
// and mask rows read from L2 by every window-head.  Its times on an H100
// 80GB HBM3 at 700 W (chip_smoke, swin_base_384 bs32): 0.630/0.374 ms at
// stage 1 shifted/unshifted, 0.325/0.201, 0.175/0.131 and 0.092 at stages
// 2-4.
//
// C entry point (ctypes): window_attention_fwd_bf16(...) returns the
// cudaError_t of the launch; it launches on the given stream and does not
// synchronise or allocate.  A plan other than core_plan's is refused.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_sm90.cuh"
#include "sm90.cuh"

namespace {

constexpr int kD = 32;               // head dim of every Swin config
constexpr int kMaxN = 144;           // N = w^2 up to window 12
constexpr int kThreads = 384;        // 2 consumer warpgroups + producer
constexpr int kSmemMax = 232448;     // 227 KB a block may use
constexpr int kMaxStages = 6;
constexpr int kSlice = 64 * kD * 2;  // 64 rows of a Q or O tile

struct Params {
  const float* bias;   // (H, N, N)
  const float* mask;   // (nW, N, N) or null
  float scale;
  int N;
  int H;
  int nW;              // groups a head: mask rows, 1 unmasked
  int windows;         // windows a group: Bn / nW
  int per_block;       // windows a block walks
  int stages;
};

// the table's row stride in floats: the keys' width rounded up to an odd
// multiple of 8, so that the 8 rows of a warp's float2 reads hit 8 distinct
// groups of 8 banks (two wavefronts, the least for 256 bytes)
__host__ __device__ constexpr int table_stride(int nk) {
  return (nk % 32 == 8 || nk % 32 == 24) ? nk : nk + 8;
}

// query rows: 64-row slices (wgmma's M) covering NK
__host__ __device__ constexpr int query_rows(int nk) {
  return 64 * ((nk + 63) / 64);
}

template <int NK>
__host__ __device__ constexpr int stage_bytes() {
  return 3 * NK * kD * 2;
}

template <int NK>
__host__ __device__ constexpr int fixed_bytes(int n) {
  return 1024 + 2 * (query_rows(NK) / 64) * kSlice +
         n * table_stride(NK) * 4 + 2 * kMaxStages * 8;
}

template <int NK>
__global__ void __launch_bounds__(kThreads, 1)
    window_attn_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_o,
                           const Params p) {
  constexpr int NQ = query_rows(NK);
  constexpr int NS = NQ / 64;            // query slices
  constexpr int kKV = NK * kD * 2;   // a Q, K or V tile of NK rows
  constexpr int kQ = kKV;
  constexpr int kStage = 3 * kKV;
  constexpr int kTs = table_stride(NK);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = sm90::align1024(smem_raw);
  uint8_t* outs = ring + p.stages * kStage;     // NS slices a warpgroup
  float* table = reinterpret_cast<float*>(outs + 2 * NS * kSlice);
  uint64_t* full = reinterpret_cast<uint64_t*>(table + p.N * kTs);
  uint64_t* empty = full + kMaxStages;

  const int N = p.N;
  // block x: run c = x / groups, group g = x mod groups = j H + h, so that
  // blocks that run together take the heads of one window (neighbours in
  // the qkv rows: their reads share L2 lines, which the tensor maps'
  // 256-byte L2 promotion fetches whole)
  const int groups = p.H * p.nW;
  const int g = blockIdx.x % groups;
  const int j = g / p.H;
  const int h = g - j * p.H;
  const int b0 = (blockIdx.x / groups) * p.per_block;
  const int items = min(p.per_block, p.windows - b0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      sm90::mbar_init(full + s, 1);
      sm90::mbar_init(empty + s, 4);   // the consuming warpgroup's warps
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == 2) {
    // ---- producer: window k of the run in stage k mod stages
    sm90::setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      sm90::tma_prefetch_desc(&tm_q);
      sm90::tma_prefetch_desc(&tm_k);
      sm90::tma_prefetch_desc(&tm_v);
      sm90::RingPos rp;
#pragma unroll 1
      for (int k = 0; k < items; ++k) {
        const int win = j + p.nW * (b0 + k);
        sm90::mbar_wait(empty + rp.stage, rp.phase ^ 1);
        uint8_t* st = ring + rp.stage * kStage;
        sm90::mbar_arrive_expect_tx(full + rp.stage, kStage);
        sm90::tma_load_4d(st, &tm_q, full + rp.stage, 0, 0, h, win);
        sm90::tma_load_4d(st + kQ, &tm_k, full + rp.stage, 0, 0, h, win);
        sm90::tma_load_4d(st + kQ + kKV, &tm_v, full + rp.stage, 0, 0, h,
                          win);
        rp.advance(p.stages);
      }
    }
    return;
  }

  // ---- consumers
  sm90::setmaxnreg_inc<240>();
  const int t = threadIdx.x & 127;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int r0 = 16 * warp + (lane >> 2);
  const int c0 = 2 * (lane & 3);

  // the group's table, bias[h] + mask[j] in fp32, once: 8 loads a thread
  // in flight (one at a time, each L2 round trip would be paid in turn),
  // 16 bytes each where the rows allow it; then the -inf columns
  {
    const float* bias = p.bias + static_cast<long long>(h) * N * N;
    const float* mask =
        p.mask == nullptr ? nullptr
                          : p.mask + static_cast<long long>(j) * N * N;
    constexpr int kBatch = 8;
    const bool wide =
        N % 4 == 0 && ((reinterpret_cast<uintptr_t>(bias) |
                        reinterpret_cast<uintptr_t>(mask)) & 15) == 0;
    if (wide) {
      const int n4 = N * N / 4;
      // each block starts at its own place in the table, so that the
      // blocks of one head (up to 64 at once) do not all ask the same L2
      // lines at the same time
      const int rot = (blockIdx.x * 2053) % n4;
#pragma unroll 1
      for (int e0 = 0; e0 < n4; e0 += 256 * kBatch) {
        float4 v[kBatch];
        int at[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          int e = e0 + 256 * u + threadIdx.x;
          at[u] = -1;
          if (e < n4) {
            e = e + rot < n4 ? e + rot : e + rot - n4;
            at[u] = 4 * e;
            v[u] = __ldg(reinterpret_cast<const float4*>(bias) + e);
            if (mask != nullptr) {
              const float4 m = __ldg(reinterpret_cast<const float4*>(mask) + e);
              v[u].x += m.x;
              v[u].y += m.y;
              v[u].z += m.z;
              v[u].w += m.w;
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int e = at[u];
          if (e >= 0) {
            *reinterpret_cast<float4*>(table + (e / N) * kTs + e % N) = v[u];
          }
        }
      }
    } else {
#pragma unroll 1
      for (int e0 = 0; e0 < N * N; e0 += 256 * kBatch) {
        float v[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int e = e0 + 256 * u + threadIdx.x;
          v[u] = 0.f;
          if (e < N * N) {
            v[u] = __ldg(bias + e);
            if (mask != nullptr) v[u] += __ldg(mask + e);
          }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int e = e0 + 256 * u + threadIdx.x;
          if (e < N * N) table[(e / N) * kTs + e % N] = v[u];
        }
      }
    }
    for (int e = threadIdx.x; e < N * (kTs - N); e += 256) {
      table[(e / (kTs - N)) * kTs + N + e % (kTs - N)] = -INFINITY;
    }
  }
  sm90::named_barrier(1, 256);

  uint8_t* out = outs + wg * NS * kSlice;
  float s[NK / 2];
  float o[kD / 2];
  uint32_t pa[NK / 16][4];
#pragma unroll 1
  for (int k = wg; k < items; k += 2) {
    const int stage = k % p.stages;
    const uint32_t phase = (k / p.stages) & 1;
    const int win = j + p.nW * (b0 + k);
    sm90::mbar_wait(full + stage, phase);
    const uint8_t* st = ring + stage * kStage;
    const uint64_t dk = sm90::make_desc_sw64(st + kQ);
    const uint64_t dv = sm90::make_desc_mn<2 * kD>(st + kQ + kKV);
    // this warpgroup's previous stores have read the output slices
    if (t == 0) sm90::bulk_wait_read<0>();
    sm90::named_barrier(2 + wg, 128);
#pragma unroll 1
    for (int q = 0; q < NS; ++q) {
      // S = Q K^T over the slice's 64 rows and NK keys
      const uint64_t dq = sm90::make_desc_sw64(st + q * kSlice);
      sm90::wgmma_fence();
      sm90::Wgmma<NK>::mma(s, dq, dk, 0);
      sm90::Wgmma<NK>::mma(s, dq + 2, dk + 2, 1);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(s);

      // scale, table, row max, P = exp(S - m) and its fp32 row sum
      float l[2] = {0.f, 0.f};
      if (64 * q + 16 * warp < N) {   // a row of this warp lies before N
        const float* ta = table + min(64 * q + r0, N - 1) * kTs;
        const float* tb = table + min(64 * q + r0 + 8, N - 1) * kTs;
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int i = 0; i < NK / 8; ++i) {
          const float2 a = *reinterpret_cast<const float2*>(ta + 8 * i + c0);
          const float2 b = *reinterpret_cast<const float2*>(tb + 8 * i + c0);
          s[4 * i] = fmaf(s[4 * i], p.scale, a.x);
          s[4 * i + 1] = fmaf(s[4 * i + 1], p.scale, a.y);
          s[4 * i + 2] = fmaf(s[4 * i + 2], p.scale, b.x);
          s[4 * i + 3] = fmaf(s[4 * i + 3], p.scale, b.y);
          mx[0] = fmaxf(mx[0], fmaxf(s[4 * i], s[4 * i + 1]));
          mx[1] = fmaxf(mx[1], fmaxf(s[4 * i + 2], s[4 * i + 3]));
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {   // the 4 threads of a quad share a row
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        }
        const float mlog[2] = {-mx[0] * attn::kLog2e, -mx[1] * attn::kLog2e};
#pragma unroll
        for (int i = 0; i < NK / 2; ++i) {
          const int r = (i >> 1) & 1;
          s[i] = attn::exp2_approx(fmaf(s[i], attn::kLog2e, mlog[r]));
          l[r] += s[i];
        }
      } else {
#pragma unroll
        for (int i = 0; i < NK / 2; ++i) s[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < NK / 8; ++i) {   // bf16(P) as wgmma's register A
        const __nv_bfloat162 lo = __floats2bfloat162_rn(s[4 * i], s[4 * i + 1]);
        const __nv_bfloat162 hi =
            __floats2bfloat162_rn(s[4 * i + 2], s[4 * i + 3]);
        pa[i >> 1][2 * (i & 1)] = *reinterpret_cast<const uint32_t*>(&lo);
        pa[i >> 1][2 * (i & 1) + 1] = *reinterpret_cast<const uint32_t*>(&hi);
      }

      // O = bf16(P) V: 16 keys a k-step
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NK / 16; ++kk) {
        sm90::WgmmaRS<kD>::mma_tb(o, pa[kk], dv + kk * (2 * kD), kk != 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o);
#pragma unroll
      for (int a = 0; a < NK / 16; ++a) sm90::fence_regs(pa[a]);

      // O / l, rounded, into the slice; one TMA store of its 64 rows
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
      }
      uint8_t* slice = out + q * kSlice;
#pragma unroll
      for (int i = 0; i < kD / 8; ++i) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          *reinterpret_cast<__nv_bfloat162*>(
              slice + sm90::swizzle64(r0 + 8 * r, 8 * i + c0)) =
              __floats2bfloat162_rn(o[4 * i + 2 * r] * inv[r],
                                    o[4 * i + 2 * r + 1] * inv[r]);
        }
      }
      sm90::fence_proxy_async();   // st.shared -> the TMA store's reads
      sm90::named_barrier(2 + wg, 128);
      if (t == 0) {
        sm90::tma_store_4d(&tm_o, slice, 0, 64 * q, h, win);
        sm90::bulk_commit();
      }
    }
    if (lane == 0) sm90::mbar_arrive(empty + stage);
  }
  if (t == 0) sm90::bulk_wait<0>();
}

template <int NK>
cudaError_t launch(const Params& p, const CUtensorMap (&maps)[4], int blocks,
                   cudaStream_t s) {
  auto kernel = window_attn_fwd_kernel<NK>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int smem = fixed_bytes<NK>(p.N) + p.stages * stage_bytes<NK>();
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  kernel<<<blocks, kThreads, smem, s>>>(maps[0], maps[1], maps[2], maps[3],
                                        p);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: (Bn, N, H, D) views by element strides (strides[3 t + 0..2]
// = window, row, head of tensor t in q, k, v, o); bias (H, N, N) fp32;
// mask (nW, N, N) fp32 or null (then nW = 1); the plan (keys, per_block,
// stages) is ops/window_attention.py:core_plan's
extern "C" int window_attention_fwd_bf16(const void* q, const void* k,
                                         const void* v, void* o,
                                         const void* bias, const void* mask,
                                         int Bn, int H, int N, int D, int nW,
                                         const long long* strides, float scale,
                                         int keys, int per_block, int stages,
                                         void* stream) {
  const int nk = N <= 16 ? 16 : N <= 32 ? 32 : N <= 64 ? 64 : 144;
  if (D != kD || N < 1 || N > kMaxN || H < 1 || Bn < 1 || nW < 1 ||
      Bn % nW || (mask == nullptr && nW != 1) || keys != nk ||
      per_block < 1 || stages < 2 || stages > kMaxStages) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.bias = static_cast<const float*>(bias);
  p.mask = static_cast<const float*>(mask);
  p.scale = scale;
  p.N = N;
  p.H = H;
  p.nW = nW;
  p.windows = Bn / nW;
  p.per_block = per_block;
  p.stages = stages;
  const long long blocks = static_cast<long long>(H) * nW *
                           ((p.windows + per_block - 1) / per_block);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const void* base[4] = {q, k, v, o};
  const int rows[4] = {nk, nk, nk, 64};
  CUtensorMap maps[4];
  for (int t = 0; t < 4; ++t) {
    const long long* st = strides + 3 * t;
    if (!sm90::encode_bf16_bhnd(&maps[t], base[t], Bn, H, N, kD, st[0], st[2],
                                st[1], rows[t])) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = static_cast<int>(blocks);
  switch (nk) {
    case 16: return static_cast<int>(launch<16>(p, maps, nb, s));
    case 32: return static_cast<int>(launch<32>(p, maps, nb, s));
    case 64: return static_cast<int>(launch<64>(p, maps, nb, s));
    default: return static_cast<int>(launch<144>(p, maps, nb, s));
  }
}
