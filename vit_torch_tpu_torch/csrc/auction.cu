// DETR's device matcher for Hopper (sm_90a): the Bertsekas auction over
// a batch of independent (Q, N) assignment problems, one block each, the
// whole loop inside the block.
//
// It replaces no Pallas kernel: vit_torch_tpu/detection/matcher.py:51-120
// (auction_assign) writes the auction as an XLA while_loop, vmapped over
// the leading (layer, image) axes, which runs on the TPU until every
// problem's cond is false.  In PyTorch that data-dependent loop needs
// either a host read of the cond every iteration (the round trip the
// device matcher exists to remove) or a fixed 256-trip loop of some 15
// launches an iteration.  One block a problem, looping until its own cond
// is false, is the direct counterpart of the while_loop.
//
// Arithmetic, that of matcher.py and of the plain version in
// detection/matcher.py, exactly (no operation here rounds differently):
// - benefit (N, Q) = valid ? -cost^T : 0, the zero rows of padded gts
//   included in the spread: eps = max(max(b) - min(b), 1e-6) * eps_frac;
// - every unassigned valid gt bids against the prices at the start of the
//   iteration (Jacobi): v1 = max_q net, i1 its first argmax, v2 the max of
//   net with only [j, i1] replaced by NEG (v2 = v1 on a tie), bid =
//   (prices[i1] + (v1 - v2)) + eps in fp32 (no multiply, nothing to
//   contract; __fadd_rn/__fsub_rn all the same);
// - each query takes its largest bid (the first gt on ties) where that bid
//   is > NEG / 2, then each gt's item is the first query it owns;
// - the loop runs while n_assigned < min(n_valid, Q) and it < max_iters.
//
// Bound on an H100 (3.35 TB/s): the work reads each cost once and writes
// one owner per query, L*B*Q*N*4 + L*B*Q*4 bytes (6 x 8 x 100 x 64 fp32:
// 0.00059 ms); its operations are a few per cost and iteration.  The
// kernel is latency-bound instead: an iteration is three barriers and a
// few dependent shared-memory passes, and DETR's 48 problems fill 48 of
// the 132 SMs.  Simple first, no tensor cores.
//
// Design: 256 threads a block; the (N, Q) benefit, the prices, owners,
// bids and each gt's item live in dynamic shared memory
// (4 (N Q + 2 Q + 4 N) bytes: 25.9 KB at DETR's (Q, N) = (100, 64); at
// most 232,448).  An iteration: one warp a bidding gt (first argmax and
// second max by butterfly over the warp); barrier; one thread a query
// resolves its bids in gt order; barrier; one thread a gt finds its first
// owned query, and a block sum counts the assigned valid gts.
//
// C entry point (ctypes): auction_assign(...) returns the cudaError_t of
// the launch; it launches on the given stream and neither synchronises nor
// allocates.  A shape it does not take is refused with
// cudaErrorInvalidValue before any launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -1e30f;
// dynamic shared memory a block may take beside the static 112 bytes
constexpr int kSmemMax = 232448 - 256;

__device__ __forceinline__ void first_argmax(float& v, int& i) {
  // the largest value over the warp, the smallest index among its ties
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (ov > v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// cost (P, Q, N) fp32; mask (mask_rows, N) fp32, problem p reading row
// p % mask_rows; owner_out (P, Q) int32; iters_out (P) int32
__global__ void __launch_bounds__(kThreads)
    auction_kernel(const float* __restrict__ cost,
                   const float* __restrict__ mask, int* __restrict__ owner_out,
                   int* __restrict__ iters_out, int Q, int N, int mask_rows,
                   float eps_frac, int max_iters) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* benefit = reinterpret_cast<float*>(smem);   // (N, Q)
  float* prices = benefit + N * Q;                   // (Q)
  float* bid = prices + Q;                           // (N)
  int* owner = reinterpret_cast<int*>(bid + N);      // (Q)
  int* item_of_gt = owner + Q;                       // (N)
  int* choice = item_of_gt + N;                      // (N): i1, or -1
  int* valid = choice + N;                           // (N)
  __shared__ float red_max[kWarps], red_min[kWarps];
  __shared__ int red_cnt[kWarps];
  __shared__ float s_eps;
  __shared__ int s_target, s_assigned;

  const int p = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* c = cost + static_cast<size_t>(p) * Q * N;
  const float* m = mask + static_cast<size_t>(p % mask_rows) * N;

  int n_valid = 0;
  for (int j = tid; j < N; j += kThreads) {
    const int v = m[j] > 0.f;
    valid[j] = v;
    n_valid += v;
    item_of_gt[j] = -1;
    choice[j] = -1;
  }
  for (int q = tid; q < Q; q += kThreads) {
    prices[q] = 0.f;
    owner[q] = -1;
  }
  __syncthreads();
  // the benefit, transposed; cost read coalesced (gt fastest)
  float lmax = -INFINITY, lmin = INFINITY;
  for (int e = tid; e < Q * N; e += kThreads) {
    const int q = e / N, j = e - q * N;
    const float b = valid[j] ? -c[e] : 0.f;
    benefit[j * Q + q] = b;
    lmax = fmaxf(lmax, b);
    lmin = fminf(lmin, b);
  }
  lmax = warp_max(lmax);
  lmin = warp_min(lmin);
  n_valid = warp_sum(n_valid);
  if (lane == 0) {
    red_max[warp] = lmax;
    red_min[warp] = lmin;
    red_cnt[warp] = n_valid;
  }
  __syncthreads();
  if (tid == 0) {
    float gmax = red_max[0], gmin = red_min[0];
    int nv = red_cnt[0];
    for (int w = 1; w < kWarps; ++w) {
      gmax = fmaxf(gmax, red_max[w]);
      gmin = fminf(gmin, red_min[w]);
      nv += red_cnt[w];
    }
    const float spread = fmaxf(__fsub_rn(gmax, gmin), 1e-6f);
    s_eps = __fmul_rn(spread, eps_frac);
    s_target = min(nv, Q);
    s_assigned = 0;
  }
  __syncthreads();
  const float eps = s_eps;
  const int target = s_target;

  int it = 0;
  while (s_assigned < target && it < max_iters) {
    // bids: one warp a gt, against the prices of the iteration's start
    for (int j = warp; j < N; j += kWarps) {
      if (!valid[j] || item_of_gt[j] >= 0) {   // warp-uniform
        if (lane == 0) choice[j] = -1;
        continue;
      }
      const float* row = benefit + j * Q;
      float v1 = -INFINITY;
      int i1 = 0x7fffffff;
      for (int q = lane; q < Q; q += 32) {
        const float v = __fsub_rn(row[q], prices[q]);
        if (v > v1) {
          v1 = v;
          i1 = q;
        }
      }
      first_argmax(v1, i1);
      if (i1 == 0x7fffffff) i1 = 0;   // no finite net: argmax's first
      float v2 = kNeg;
      for (int q = lane; q < Q; q += 32) {
        if (q != i1) v2 = fmaxf(v2, __fsub_rn(row[q], prices[q]));
      }
      v2 = warp_max(v2);
      if (lane == 0) {
        bid[j] = __fadd_rn(__fadd_rn(prices[i1], __fsub_rn(v1, v2)), eps);
        choice[j] = i1;
      }
    }
    __syncthreads();
    // each query takes its best bid, the first gt on ties
    for (int q = tid; q < Q; q += kThreads) {
      float best = kNeg;
      int win = -1;
      for (int j = 0; j < N; ++j) {
        if (choice[j] == q && bid[j] > best) {
          best = bid[j];
          win = j;
        }
      }
      if (best > kNeg * 0.5f) {
        owner[q] = win;
        prices[q] = best;
      }
    }
    __syncthreads();
    // each gt's first owned query; the assigned valid gts counted
    int cnt = 0;
    for (int j = tid; j < N; j += kThreads) {
      int item = -1;
      for (int q = 0; q < Q; ++q) {
        if (owner[q] == j) {
          item = q;
          break;
        }
      }
      item_of_gt[j] = item;
      cnt += (item >= 0) && valid[j];
    }
    cnt = warp_sum(cnt);
    if (lane == 0) red_cnt[warp] = cnt;
    __syncthreads();
    if (tid == 0) {
      int s = 0;
      for (int w = 0; w < kWarps; ++w) s += red_cnt[w];
      s_assigned = s;
    }
    ++it;
    __syncthreads();
  }
  for (int q = tid; q < Q; q += kThreads) {
    owner_out[static_cast<size_t>(p) * Q + q] = owner[q];
  }
  if (tid == 0) iters_out[p] = it;
}

}  // namespace

extern "C" int auction_assign(const void* cost, const void* mask, void* owner,
                              void* iters, int P, int Q, int N, int mask_rows,
                              float eps_frac, int max_iters, void* stream) {
  if (P < 1 || Q < 1 || N < 1 || mask_rows < 1 || P % mask_rows ||
      max_iters < 0 || static_cast<long long>(Q) * N > kSmemMax / 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // detection/matcher.py:auction_smem_bytes
  const int smem = 4 * (N * Q + 2 * Q + 4 * N);
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        auction_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auction_kernel<<<P, kThreads, smem, s>>>(
      static_cast<const float*>(cost), static_cast<const float*>(mask),
      static_cast<int*>(owner), static_cast<int*>(iters), Q, N, mask_rows,
      eps_frac, max_iters);
  return static_cast<int>(cudaGetLastError());
}
