// Fused temperature / log-softmax / gumbel-argmax sampling, written by
// hand for Hopper (sm_90a).
//
// Replaces the TPU kernel rl_tpu/kernels/sampling.py `fused_sample`
// (body `_fused_sample_kernel` -> `_kernel_body`).
//
// What it computes, per row r of logits x [S, V] (float32):
//   xs   = x / t
//   xs   = xs >= thr ? xs : -inf        (top_k > 0: thr = the k-th largest
//                                        xs, counted with multiplicity, so
//                                        ties at the threshold all stay, as
//                                        with lax.top_k's value threshold)
//   lps  = (xs - max(xs)) - log(sum(exp(xs - max(xs))))
//   tok  = argmax(noise + lps)          (sampled; noise is gumbel)
//   tok  = argmax(x)                    (greedy: the unscaled logits)
//   lp   = lps[tok]
// Ties go to the first index, as jnp.argmax and torch.argmax do. The plain
// PyTorch version (rl_tpu_torch.kernels.sampling.fused_sample_ref) writes
// the same expression in the same order, so the two differ only in the
// order of the exp-sum.
//
// Bound on an H100: memory. The function must read each logit once (4
// bytes) and, when sampling, each noise value once (4 bytes): 8 bytes per
// vocabulary entry, about 2.1 MB for 8 rows of 32768, ~0.6 us at
// 3.35 TB/s. The arithmetic (a divide, an exp, a few compares per entry)
// is far below the card's rate.
//
// What the design does about it: one thread block per row makes three
// passes over the row. The first pass reads it from device memory; a
// 128 KB row then sits in the 50 MB L2, so the second and third passes
// (and the noise, read once in the third) add little device-memory
// traffic. Nothing is written back but the token and its log-prob.
// Top-k adds a radix select over the float bits of the scaled row: four
// passes of an 8-bit shared-memory histogram, each narrowing the prefix
// of the k-th largest key; the row stays in L2 for all of them.
// A first, simple version: with 8 rows only 8 of 132 SMs work; a later
// version splits each row over several blocks.

#include <cuda_runtime.h>
#include <climits>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < kWarps ? red[lane] : -INFINITY;
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();  // red is reused by the next reduction
  return v;
}

__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < kWarps ? red[lane] : 0.f;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  return v;
}

// float -> uint32 whose unsigned order is the float order
__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_order_key(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// The k-th largest of xr[i] / t (1 <= k <= V), by radix select from the
// most significant byte down.
__device__ float kth_largest(const float* xr, float t, int V, int k, int* hist, int* sel) {
  unsigned prefix = 0, mask = 0;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = threadIdx.x; i < 256; i += kThreads) hist[i] = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < V; i += kThreads) {
      const unsigned key = order_key(xr[i] / t);
      if ((key & mask) == prefix) atomicAdd(&hist[(key >> shift) & 255u], 1);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      int cum = 0, b = 255;
      for (; b > 0; --b) {
        if (cum + hist[b] >= k) break;
        cum += hist[b];
      }
      sel[0] = b;
      sel[1] = k - cum;  // rank of the k-th largest inside bucket b
    }
    __syncthreads();
    prefix |= (unsigned)sel[0] << shift;
    mask |= 255u << shift;
    k = sel[1];
    __syncthreads();  // sel is rewritten by the next pass
  }
  return from_order_key(prefix);
}

// (value, index) argmax; equal values keep the smaller index
__device__ __forceinline__ void arg_better(float& v, int& i, float v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

__device__ __forceinline__ void block_argmax(float& v, int& i, float* red_v, int* red_i) {
  for (int o = 16; o > 0; o >>= 1)
    arg_better(v, i, __shfl_xor_sync(0xffffffffu, v, o), __shfl_xor_sync(0xffffffffu, i, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    red_v[warp] = v;
    red_i[warp] = i;
  }
  __syncthreads();
  v = lane < kWarps ? red_v[lane] : -INFINITY;
  i = lane < kWarps ? red_i[lane] : INT_MAX;
  for (int o = 16; o > 0; o >>= 1)
    arg_better(v, i, __shfl_xor_sync(0xffffffffu, v, o), __shfl_xor_sync(0xffffffffu, i, o));
}

__global__ void __launch_bounds__(kThreads) fused_sample_kernel(
    const float* __restrict__ x, const float* __restrict__ noise, float t,
    int V, int greedy, int top_k, int32_t* __restrict__ tok_out, float* __restrict__ lp_out) {
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ int hist[256];
  __shared__ int sel[2];
  const size_t row = blockIdx.x;
  const float* xr = x + row * (size_t)V;
  const int tid = threadIdx.x;
  // with top_k, entries below the threshold are -inf: they add nothing to
  // the max or the exp-sum and never win the sampled argmax
  const float thr = top_k > 0 ? kth_largest(xr, t, V, top_k, hist, sel) : -INFINITY;

  float mx = -INFINITY;
  for (int i = tid; i < V; i += kThreads) {
    const float xs = xr[i] / t;
    if (xs >= thr) mx = fmaxf(mx, xs);
  }
  mx = block_max(mx, red_v);

  float sum = 0.f;
  for (int i = tid; i < V; i += kThreads) {
    const float xs = xr[i] / t;
    if (xs >= thr) sum += expf(xs - mx);
  }
  const float lse = logf(block_sum(sum, red_v));

  float best = -INFINITY;
  int best_i = INT_MAX;
  if (greedy) {
    for (int i = tid; i < V; i += kThreads) arg_better(best, best_i, xr[i], i);
  } else {
    const float* nr = noise + row * (size_t)V;
    for (int i = tid; i < V; i += kThreads) {
      const float xs = xr[i] / t;
      arg_better(best, best_i, xs >= thr ? nr[i] + ((xs - mx) - lse) : -INFINITY, i);
    }
  }
  block_argmax(best, best_i, red_v, red_i);
  if (tid == 0) {
    if (best_i >= V) best_i = 0;  // an all-NaN row: no index compared greater
    tok_out[row] = best_i;
    lp_out[row] = (xr[best_i] / t - mx) - lse;
  }
}

}  // namespace

extern "C" {

// x, noise: [S, V] float32 (noise may be null when greedy != 0);
// top_k: 0 = no filter, else 1 <= top_k < V; tok_out [S] int32, lp_out [S]
// float32.
int rl_fused_sample(const void* x, const void* noise, float t, int S, int V,
                    int greedy, int top_k, void* tok_out, void* lp_out, void* stream) {
  fused_sample_kernel<<<S, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(noise), t, V,
      greedy, top_k, static_cast<int32_t*>(tok_out), static_cast<float*>(lp_out));
  return (int)cudaGetLastError();
}

const char* rl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
