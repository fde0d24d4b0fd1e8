// Flash-attention backward for Hopper (sm_90a), bf16 in / bf16 out.
//
// Replaces the four Pallas TPU backward kernels of
// vit_torch_tpu/ops/flash_attention.py, all reached through _bwd_impl:
// _bwd_fused_kernel_hb, _bwd_fused_kernel, _bwd_dq_kernel and
// _bwd_dkv_kernel.  Same function over (B, H, N, D), keys >= N masked:
//
//   P  = softmax(scale * Q K^T)                    (fp32)
//   dV = P^T dO                                    (P rounded to bf16)
//   dP = dO V^T                                    (fp32)
//   dS = P o (dP - rowsum(P o dP)) * scale         (rounded to bf16)
//   dQ = dS K,  dK = dS^T Q                        (fp32 accumulation)
//
// Design.  The TPU kernels keep whole K/V rows and the full N x N fp32 P
// in VMEM and recompute exact softmax rows, with no residuals.  At N = 785
// that does not fit in an SM's 227 KB of shared memory, so this kernel
// tiles both sequence axes and takes two residuals from the forward: the
// output O and the per-row log-sum-exp (natural log, fp32, (B*H, N); see
// flash_attention_fwd.cu).  P is recomputed tile by tile as
// exp2(scale*log2(e) * S - log2(e) * LSE), already normalised.
//
// - Di = rowsum(P o dP) equals rowsum(dO o O).  It is computed at the start
//   of the dQ pass from the bf16 dO and O tiles in fp32 and written to a
//   (B*H, N) fp32 scratch buffer, which the dK/dV pass reads; the two
//   passes are launched in that order on one stream.
// - The dQ pass: one block of 4 warps per (64-query tile, b*h); each warp
//   owns 16 query rows and keeps Q and dO as mma A-fragments and dQ in
//   fp32 registers, looping over 64-key tiles of K and V in shared memory:
//   S = Q K^T, dP = dO V^T, dS in registers, dQ += dS K.
// - The dK/dV pass: one block per (64-key tile, b*h); each warp owns 16
//   keys and keeps K and V as A-fragments and dK, dV in fp32 registers,
//   looping over 64-query tiles of Q and dO: S^T = K Q^T, dP^T = V dO^T,
//   dV += P^T dO, dK += dS^T Q.  Computing the transposed products puts
//   P^T and dS^T in the accumulator layout, which is the A-fragment layout
//   of the next product, so neither leaves registers.
// - The loop inside a block takes the place of the TPU's sequential grid
//   axis, which carried dk_acc / dv_acc in scratch; blocks run in no order
//   here, and with one block per output tile no atomics are needed.  The
//   price is that S and dP are computed twice, once in each pass.
// - Tensor cores through mma.sync.m16n8k16 bf16 -> fp32; B-fragments of the
//   row-major K, Q and dO tiles for the second product of each pass come
//   through ldmatrix.trans.  Synchronous tile loads, no pipelining; wgmma,
//   TMA and pipelining are later work.
// - Ragged edges: tile rows >= N are zero-filled.  Keys >= N get P = 0 in
//   the dQ pass.  Queries >= N get LSE = +inf, hence P = 0, and Di = 0 in
//   the dK/dV pass, so they add nothing to dK and dV; rows >= N are never
//   stored.
// - q, k, v, O, dO, dq, dk and dv are addressed by (batch, head, row)
//   strides with unit stride along D, so dq, dk and dv may be written
//   straight into one (B, N, 3, H, D) gradient of the fused qkv projection.
//
// Bound at the training shape B=32, H=12, N=785, D=64: the function needs
// 5 products of 2*N^2*D flops each, 10*B*H*N^2*D = 151.4 GFLOP (0.153 ms at
// 989 TFLOP/s dense bf16), against q, k, v, O, dO read and dq, dk, dv
// written, 8 * 38.6 MB = 309 MB (0.092 ms at 3.35 TB/s): bound by
// operations.  This version does 7 products (S and dP twice).
//
// C entry point (ctypes): flash_attention_bwd_bf16(...) launches both
// passes on the given stream and returns the first non-zero cudaError_t;
// it does not synchronise or allocate.

#include "flash_common.cuh"

namespace {

enum { kQ = 0, kK, kV, kO, kDO, kDQ, kDK, kDV, kNumTensors };

struct BwdParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* o;
  const __nv_bfloat16* dout;
  const float* lse;  // (B*H, N), natural log
  float* di;         // (B*H, N) scratch: rowsum(dO o O)
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  // element strides: [tensor][batch, head, row], tensors in enum order
  long long stride[kNumTensors][3];
  int H;
  int N;
  float scale;       // softmax scale, applied to dS
  float scale_log2;  // scale * log2(e)
};

template <typename T>
__device__ __forceinline__ T* slice(T* base, const BwdParams& p, int which,
                                    int b, int h) {
  return base + b * p.stride[which][0] + h * p.stride[which][1];
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const BwdParams p) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  __shared__ __align__(16) __nv_bfloat16 sQ[kBlockM][D + kPad];
  __shared__ __align__(16) __nv_bfloat16 sdO[kBlockM][D + kPad];
  __shared__ __align__(16) __nv_bfloat16 sK[kBlockN][D + kPad];
  __shared__ __align__(16) __nv_bfloat16 sV[kBlockN][D + kPad];
  __shared__ float sL[kBlockM];
  __shared__ float sDi[kBlockM];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int N = p.N;
  const int q0 = blockIdx.x * kBlockM;
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const long long row_base = static_cast<long long>(blockIdx.y) * N;

  load_tile<D>(sQ, slice(p.q, p, kQ, b, h), p.stride[kQ][2], q0, N);
  load_tile<D>(sdO, slice(p.dout, p, kDO, b, h), p.stride[kDO][2], q0, N);
  // O only feeds Di: stage it in sK's space
  load_tile<D>(sK, slice(p.o, p, kO, b, h), p.stride[kO][2], q0, N);
  __syncthreads();

  // Di = rowsum(dO o O) in fp32: two threads per row, then one shuffle
  {
    const int r = threadIdx.x >> 1;
    const int half = threadIdx.x & 1;
    float acc = 0.f;
#pragma unroll
    for (int c = half * (D / 2); c < (half + 1) * (D / 2); ++c) {
      acc += __bfloat162float(sdO[r][c]) * __bfloat162float(sK[r][c]);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      const bool valid = q0 + r < N;
      sDi[r] = valid ? acc : 0.f;
      sL[r] = valid ? p.lse[row_base + q0 + r] * kLog2e : INFINITY;
      if (valid) p.di[row_base + q0 + r] = acc;
    }
  }
  __syncthreads();

  const int r0 = warp * 16 + g;
  uint32_t qf[D / 16][4];
  uint32_t dof[D / 16][4];
  load_a_frags<D>(qf, sQ, r0, t);
  load_a_frags<D>(dof, sdO, r0, t);
  const float lse2[2] = {sL[r0], sL[r0 + 8]};
  const float di[2] = {sDi[r0], sDi[r0 + 8]};

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  }

  const __nv_bfloat16* kg = slice(p.k, p, kK, b, h);
  const __nv_bfloat16* vg = slice(p.v, p, kV, b, h);
  for (int k0 = 0; k0 < N; k0 += kBlockN) {
    __syncthreads();  // every warp is done with the previous tiles (and O)
    load_tile<D>(sK, kg, p.stride[kK][2], k0, N);
    load_tile<D>(sV, vg, p.stride[kV][2], k0, N);
    __syncthreads();

    float s[kBlockN / 8][4];
    float dp[kBlockN / 8][4];
    mma_abt<D>(s, qf, sK, g, t);     // S = Q K^T
    mma_abt<D>(dp, dof, sV, g, t);   // dP = dO V^T
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + 2 * t + (e & 1);
        const int i = e >> 1;
        const float pe =
            col < N ? exp2f(s[nt][e] * p.scale_log2 - lse2[i]) : 0.f;
        s[nt][e] = pe * (dp[nt][e] - di[i]) * p.scale;  // dS
      }
    }
    mma_pv<D>(acc, s, sK, lane);     // dQ += dS K
  }

  const float one[2] = {1.f, 1.f};
  store_rows<D>(slice(p.dq, p, kDQ, b, h), p.stride[kDQ][2], acc, q0 + r0, N,
                t, one);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const BwdParams p) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  __shared__ __align__(16) __nv_bfloat16 sQ[kBlockM][D + kPad];
  __shared__ __align__(16) __nv_bfloat16 sdO[kBlockM][D + kPad];
  __shared__ float sL[kBlockM];
  __shared__ float sDi[kBlockM];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int N = p.N;
  const int key0 = blockIdx.x * kBlockN;
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const long long row_base = static_cast<long long>(blockIdx.y) * N;

  // K and V of this block's keys, staged through the Q / dO tiles
  load_tile<D>(sQ, slice(p.k, p, kK, b, h), p.stride[kK][2], key0, N);
  load_tile<D>(sdO, slice(p.v, p, kV, b, h), p.stride[kV][2], key0, N);
  __syncthreads();
  const int r0 = warp * 16 + g;
  uint32_t kf[D / 16][4];
  uint32_t vf[D / 16][4];
  load_a_frags<D>(kf, sQ, r0, t);
  load_a_frags<D>(vf, sdO, r0, t);

  float dk[D / 8][4];
  float dv[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    dk[i][0] = dk[i][1] = dk[i][2] = dk[i][3] = 0.f;
    dv[i][0] = dv[i][1] = dv[i][2] = dv[i][3] = 0.f;
  }

  const __nv_bfloat16* qg = slice(p.q, p, kQ, b, h);
  const __nv_bfloat16* dog = slice(p.dout, p, kDO, b, h);
  for (int q0 = 0; q0 < N; q0 += kBlockM) {
    __syncthreads();  // every warp is done with the previous tiles (and K/V)
    load_tile<D>(sQ, qg, p.stride[kQ][2], q0, N);
    load_tile<D>(sdO, dog, p.stride[kDO][2], q0, N);
    if (threadIdx.x < kBlockM) {
      const int row = q0 + threadIdx.x;
      const bool valid = row < N;
      sL[threadIdx.x] = valid ? p.lse[row_base + row] * kLog2e : INFINITY;
      sDi[threadIdx.x] = valid ? p.di[row_base + row] : 0.f;
    }
    __syncthreads();

    float st[kBlockM / 8][4];
    float dpt[kBlockM / 8][4];
    mma_abt<D>(st, kf, sQ, g, t);    // S^T = K Q^T
    mma_abt<D>(dpt, vf, sdO, g, t);  // dP^T = V dO^T
#pragma unroll
    for (int nt = 0; nt < kBlockM / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = nt * 8 + 2 * t + (e & 1);  // query within the tile
        const float pe = exp2f(st[nt][e] * p.scale_log2 - sL[qc]);
        st[nt][e] = pe;                                   // P^T
        dpt[nt][e] = pe * (dpt[nt][e] - sDi[qc]) * p.scale;  // dS^T
      }
    }
    mma_pv<D>(dv, st, sdO, lane);    // dV += P^T dO
    mma_pv<D>(dk, dpt, sQ, lane);    // dK += dS^T Q
  }

  const float one[2] = {1.f, 1.f};
  store_rows<D>(slice(p.dk, p, kDK, b, h), p.stride[kDK][2], dk, key0 + r0,
                N, t, one);
  store_rows<D>(slice(p.dv, p, kDV, b, h), p.stride[kDV][2], dv, key0 + r0,
                N, t, one);
}

template <int D>
int launch(const BwdParams& p, int B, cudaStream_t s) {
  const dim3 grid((p.N + kBlockM - 1) / kBlockM, B * p.H);
  flash_bwd_dq_kernel<D><<<grid, kThreads, 0, s>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkv_kernel<D><<<grid, kThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: 24 element strides, (batch, head, row) for q, k, v, o, dout, dq,
// dk, dv in that order.  lse and di are contiguous (B*H, N) fp32.
extern "C" int flash_attention_bwd_bf16(const void* q, const void* k,
                                        const void* v, const void* o,
                                        const void* dout, const void* lse,
                                        void* di, void* dq, void* dk,
                                        void* dv, int B, int H, int N, int D,
                                        const long long* strides, float scale,
                                        void* stream) {
  BwdParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<const __nv_bfloat16*>(o);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.di = static_cast<float*>(di);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  for (int i = 0; i < kNumTensors; ++i) {
    for (int j = 0; j < 3; ++j) p.stride[i][j] = strides[3 * i + j];
  }
  p.H = H;
  p.N = N;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch<64>(p, B, s);
  if (D == 32) return launch<32>(p, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
