// Fused temperature / log-softmax / gumbel-argmax sampling, written by
// hand for Hopper (sm_90a).
//
// Replaces the TPU kernel rl_tpu/kernels/sampling.py `fused_sample`
// (body `_fused_sample_kernel` -> `_kernel_body`).
//
// What it computes, per row r of logits x [S, V] (float32, or bfloat16
// widened at load exactly as .float() widens it):
//   xs   = x / t                        (a true IEEE division, __fdiv_rn)
//   xs   = xs >= thr ? xs : -inf        (top_k > 0: thr = the k-th largest
//                                        xs, counted with multiplicity, so
//                                        ties at the threshold all stay, as
//                                        with lax.top_k's value threshold)
//   lps  = (xs - max(xs)) - log(sum(exp(xs - max(xs))))
//   tok  = argmax(noise + lps)          (sampled; noise is gumbel)
//   tok  = argmax(x)                    (greedy: the unscaled logits)
//   lp   = lps[tok]
// Ties go to the first index, as jnp.argmax and torch.argmax do; a row in
// which no score compares (all NaN) gives token 0. The plain PyTorch
// version (rl_tpu_torch.kernels.sampling.fused_sample_ref) writes the same
// expression in the same order, so the two differ only in the order of
// the exp-sum.
//
// Bound on an H100: memory. The function must read each logit once (4
// bytes, 2 in bf16) and, when sampling, each noise value once (4 bytes):
// about 2.1 MB for 8 float32 rows of 32768 with noise, ~0.63 us at
// 3.35 TB/s. The arithmetic (a divide, an exp, a few compares per entry)
// is far below the card's rate.
//
// Design (no top-k). The first version ran one block of 1024 threads per
// row, 8 blocks on 132 SMs, over three passes that each redid the
// division, after the wrapper had cast bf16 logits to a float32 copy:
// 0.038 ms. Now each row is cut into C chunks (ops: sample_plan picks C
// from S and V alone, so that S * C fills the card: C = 16 chunks of 2048
// at S = 8, V = 32768, 256 threads of 8 entries each), and a call is two
// kernels:
//  - sample_chunk_stats, one block per (row, chunk): reads its chunk once
//    in the logits' own type, divides each entry once, and writes the
//    chunk's max and its exp-sum at that max (each thread keeps a running
//    pair over batches of 8 entries, rescaled when its max grows; the
//    block merges the pairs), and for greedy the chunk's argmax of the raw
//    logits, to a float32 scratch; a row's chunk-0 block also zeroes the
//    row's counter;
//  - sample_pick, a programmatic dependent launch (pdl.cuh): it launches
//    while pass 1 runs, loads its chunk's first batch of logits and noise,
//    and only then waits on the device for pass 1. Every warp of a row's
//    blocks merges the row's C pairs into (mx, lse) by one fixed shuffle
//    tree, so all of them hold the same two numbers. When sampling, one
//    block per (row, chunk) reads its chunk again (from L2: the whole [8,
//    32768] problem is 2.1 MB against 50 MB) with its noise, scores
//    noise + ((xs - mx) - lse) in the plain version's order and
//    writes the chunk's best (value, index); the last block of the row to
//    finish (a per-row counter, __threadfence then atomicAdd) reduces the
//    C candidates, first index on ties, and writes tok and lp. Greedy
//    launches one block per row, which reduces pass 1's candidates.
//  The kernel boundary is the grid-wide sync between the two passes: it
//  needs no co-resident grid (a cooperative launch would, and would have
//  to check occupancy for every S * C), and nothing synchronises with the
//  host.
// Top-k keeps the first version's route, one block of 1024 threads per
// row (fused_sample_topk), chosen by top_k alone: a radix select over the
// float bits of the scaled row, four passes of an 8-bit shared-memory
// histogram, each narrowing the prefix of the k-th largest key, then the
// three passes above. No path samples with top-k today.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <climits>
#include <math.h>
#include <stdint.h>

#include "pdl.cuh"

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// (value, index) argmax; equal values keep the smaller index. NaN never
// wins.
__device__ __forceinline__ void arg_better(float& v, int& i, float v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    arg_better(v, i, __shfl_xor_sync(0xffffffffu, v, o), __shfl_xor_sync(0xffffffffu, i, o));
}

// (m, s) <- the merge of two (max, exp-sum at that max) pairs
__device__ __forceinline__ void merge_max_sum(float& m, float& s, float m2, float s2) {
  const float M = fmaxf(m, m2);
  if (M == -INFINITY) return;  // both empty: (-inf, 0)
  s = s * expf(m - M) + s2 * expf(m2 - M);
  m = M;
}

// -- the split route ------------------------------------------------------------

constexpr int kSplitThreads = 256;
constexpr int kSplitWarps = kSplitThreads / 32;
constexpr int kBatch = 8;           // entries a thread holds at once

// Scratch per (row, chunk), 4 words: max, exp-sum, best value, best index
// (the index's bits); then one counter per row.
constexpr int kPart = 4;

template <typename T>
__global__ void __launch_bounds__(kSplitThreads) sample_chunk_stats(
    const T* __restrict__ x, long long ldx, float t, int V, int chunk, int C, int greedy,
    float* __restrict__ part, int* __restrict__ counter) {
  __shared__ float red_m[kSplitWarps], red_s[kSplitWarps], red_v[kSplitWarps];
  __shared__ int red_i[kSplitWarps];
  const int r = blockIdx.x, c = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* xr = x + (size_t)r * ldx;
  const int i0 = c * chunk, i1 = min(V, i0 + chunk);
  pdl::release_dependents();  // sample_pick may launch and wait for this grid

  float m = -INFINITY, s = 0.f, best = -INFINITY;
  int bi = INT_MAX;
  for (int base = i0 + tid; base < i1; base += kBatch * kSplitThreads) {
    float xv[kBatch], xs[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base + u * kSplitThreads;
      xv[u] = i < i1 ? to_f32(xr[i]) : -INFINITY;
    }
    float bm = -INFINITY;
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      xs[u] = __fdiv_rn(xv[u], t);
      bm = fmaxf(bm, xs[u]);
    }
    if (bm > m) {  // the running sum moves to the new max
      s *= expf(m - bm);
      m = bm;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (xs[u] != -INFINITY) s += expf(xs[u] - m);
    if (greedy) {
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = base + u * kSplitThreads;
        if (i < i1) arg_better(best, bi, xv[u], i);
      }
    }
  }

#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    merge_max_sum(m, s, __shfl_xor_sync(0xffffffffu, m, o), __shfl_xor_sync(0xffffffffu, s, o));
  warp_argmax(best, bi);
  if (lane == 0) {
    red_m[warp] = m;
    red_s[warp] = s;
    red_v[warp] = best;
    red_i[warp] = bi;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < kSplitWarps; ++w) {
      merge_max_sum(m, s, red_m[w], red_s[w]);
      arg_better(best, bi, red_v[w], red_i[w]);
    }
    float* p = part + ((size_t)r * C + c) * kPart;
    p[0] = m;
    p[1] = s;
    p[2] = best;
    p[3] = __int_as_float(bi);
    if (c == 0) counter[r] = 0;
  }
}

template <typename T>
__global__ void __launch_bounds__(kSplitThreads) sample_pick(
    const T* __restrict__ x, long long ldx, const float* __restrict__ noise, float t, int V,
    int chunk, int C, int greedy, float* __restrict__ part, int* __restrict__ counter,
    int32_t* __restrict__ tok_out, float* __restrict__ lp_out) {
  __shared__ float red_v[kSplitWarps];
  __shared__ int red_i[kSplitWarps];
  __shared__ int last;
  const int r = blockIdx.x, c = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* xr = x + (size_t)r * ldx;
  float* pr = part + (size_t)r * C * kPart;

  // the chunk's first batch of logits and noise, which do not depend on
  // pass 1, load while pass 1 runs
  const float* nr = greedy ? nullptr : noise + (size_t)r * V;
  const int i0 = c * chunk, i1 = min(V, i0 + chunk);
  float xv[kBatch], nv[kBatch];
  auto load = [&](int base) {
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base + u * kSplitThreads;
      xv[u] = i < i1 ? to_f32(xr[i]) : 0.f;
      nv[u] = i < i1 ? nr[i] : 0.f;
    }
  };
  if (!greedy) load(i0 + tid);
  pdl::wait_primary();

  // the row's max and log-sum-exp from its C chunks: lane j of every warp
  // reads chunks j, j + 32, ..., and the lanes merge by one fixed shuffle
  // tree, so every warp of every block of the row holds the same numbers
  float mx = -INFINITY, sum = 0.f;
  for (int j = lane; j < C; j += 32) merge_max_sum(mx, sum, pr[j * kPart], pr[j * kPart + 1]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    merge_max_sum(mx, sum, __shfl_xor_sync(0xffffffffu, mx, o),
                  __shfl_xor_sync(0xffffffffu, sum, o));
  const float lse = logf(sum);

  if (!greedy) {
    // this chunk's best noise + lps, first index on ties
    float best = -INFINITY;
    int bi = INT_MAX;
    for (int base = i0 + tid; base < i1;) {
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = base + u * kSplitThreads;
        if (i < i1) arg_better(best, bi, nv[u] + ((__fdiv_rn(xv[u], t) - mx) - lse), i);
      }
      base += kBatch * kSplitThreads;
      if (base < i1) load(base);
    }
    warp_argmax(best, bi);
    if (lane == 0) {
      red_v[warp] = best;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < kSplitWarps; ++w) arg_better(best, bi, red_v[w], red_i[w]);
      float* p = pr + c * kPart;
      p[2] = best;
      p[3] = __int_as_float(bi);
      __threadfence();  // the candidate is visible before the count says so
      last = atomicAdd(&counter[r], 1) == C - 1;
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
  }

  // one block per row from here: the C candidates, first index on ties
  if (warp == 0) {
    float best = -INFINITY;
    int bi = INT_MAX;
    for (int j = lane; j < C; j += 32)
      arg_better(best, bi, __ldcg(&pr[j * kPart + 2]), __float_as_int(__ldcg(&pr[j * kPart + 3])));
    warp_argmax(best, bi);
    if (lane == 0) {
      const int tok = bi < V ? bi : 0;  // no score compared (all NaN): token 0
      tok_out[r] = tok;
      lp_out[r] = (__fdiv_rn(to_f32(xr[tok]), t) - mx) - lse;
    }
  }
}

// -- the top-k route: one block per row -----------------------------------------

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
template <typename T>
__device__ float kth_largest(const T* xr, float t, int V, int k, int* hist, int* sel) {
  unsigned prefix = 0, mask = 0;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = threadIdx.x; i < 256; i += kThreads) hist[i] = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < V; i += kThreads) {
      const unsigned key = order_key(__fdiv_rn(to_f32(xr[i]), t));
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

__device__ __forceinline__ void block_argmax(float& v, int& i, float* red_v, int* red_i) {
  warp_argmax(v, i);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    red_v[warp] = v;
    red_i[warp] = i;
  }
  __syncthreads();
  v = lane < kWarps ? red_v[lane] : -INFINITY;
  i = lane < kWarps ? red_i[lane] : INT_MAX;
  warp_argmax(v, i);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) fused_sample_topk(
    const T* __restrict__ x, long long ldx, const float* __restrict__ noise, float t, int V,
    int greedy, int top_k, int32_t* __restrict__ tok_out, float* __restrict__ lp_out) {
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ int hist[256];
  __shared__ int sel[2];
  const size_t row = blockIdx.x;
  const T* xr = x + row * ldx;
  const int tid = threadIdx.x;
  // entries below the threshold are -inf: they add nothing to the max or
  // the exp-sum and never win the sampled argmax
  const float thr = kth_largest(xr, t, V, top_k, hist, sel);

  float mx = -INFINITY;
  for (int i = tid; i < V; i += kThreads) {
    const float xs = __fdiv_rn(to_f32(xr[i]), t);
    if (xs >= thr) mx = fmaxf(mx, xs);
  }
  mx = block_max(mx, red_v);

  float sum = 0.f;
  for (int i = tid; i < V; i += kThreads) {
    const float xs = __fdiv_rn(to_f32(xr[i]), t);
    if (xs >= thr) sum += expf(xs - mx);
  }
  const float lse = logf(block_sum(sum, red_v));

  float best = -INFINITY;
  int best_i = INT_MAX;
  if (greedy) {
    for (int i = tid; i < V; i += kThreads) arg_better(best, best_i, to_f32(xr[i]), i);
  } else {
    const float* nr = noise + row * (size_t)V;
    for (int i = tid; i < V; i += kThreads) {
      const float xs = __fdiv_rn(to_f32(xr[i]), t);
      arg_better(best, best_i, xs >= thr ? nr[i] + ((xs - mx) - lse) : -INFINITY, i);
    }
  }
  block_argmax(best, best_i, red_v, red_i);
  if (tid == 0) {
    if (best_i >= V) best_i = 0;  // an all-NaN row: no index compared greater
    tok_out[row] = best_i;
    lp_out[row] = (__fdiv_rn(to_f32(xr[best_i]), t) - mx) - lse;
  }
}

template <typename T>
int launch(const void* x, long long ldx, const void* noise, float t, int S, int V, int greedy,
           int top_k, int C, int chunk, void* scratch, void* tok_out, void* lp_out,
           cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const float* nz = static_cast<const float*>(noise);
  int32_t* tok = static_cast<int32_t*>(tok_out);
  float* lp = static_cast<float*>(lp_out);
  if (top_k > 0) {
    fused_sample_topk<T><<<S, kThreads, 0, stream>>>(xt, ldx, nz, t, V, greedy, top_k, tok, lp);
    return (int)cudaGetLastError();
  }
  float* part = static_cast<float*>(scratch);
  int* counter = reinterpret_cast<int*>(part + (size_t)S * C * kPart);
  sample_chunk_stats<T><<<dim3(S, C), kSplitThreads, 0, stream>>>(xt, ldx, t, V, chunk, C,
                                                                  greedy, part, counter);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)pdl::launch_dependent(sample_pick<T>, dim3(S, greedy ? 1 : C),
                                    dim3(kSplitThreads), stream, xt, ldx, nz, t, V, chunk, C,
                                    greedy, part, counter, tok, lp);
}

}  // namespace

extern "C" {

// x: [S, V] float32 (dtype 0) or bfloat16 (dtype 1), rows ldx elements
// apart, entries contiguous; noise: [S, V] float32 contiguous (may be
// null when greedy != 0); top_k: 0 = the split route over C chunks of
// `chunk` entries (scratch: S * (4 * C + 1) 32-bit words), else 1 <=
// top_k < V and the one-block route (scratch unused); tok_out [S] int32,
// lp_out [S] float32.
int rl_fused_sample(const void* x, long long ldx, const void* noise, float t, int S, int V,
                    int greedy, int top_k, int dtype, int C, int chunk, void* scratch,
                    void* tok_out, void* lp_out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S <= 0 || V <= 0 || top_k < 0 || top_k >= V || (!greedy && noise == nullptr))
    return (int)cudaErrorInvalidValue;
  if (top_k == 0 && (C < 1 || chunk < 1 || (long long)(C - 1) * chunk >= V ||
                     (long long)C * chunk < V))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(x, ldx, noise, t, S, V, greedy, top_k, C, chunk, scratch, tok_out,
                         lp_out, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, ldx, noise, t, S, V, greedy, top_k, C, chunk, scratch,
                                 tok_out, lp_out, st);
  return (int)cudaErrorInvalidValue;
}

const char* rl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
