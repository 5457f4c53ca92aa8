// Shared pieces of the single-token decode kernels over a dense cache
// (flash_decode.cu) and over an int8 paged pool (paged_decode_int8.cu).
//
// One thread block serves the G = H / Hk query heads of one kv head. It
// keeps in shared memory, all in float32: the group's queries q_s [G, D]
// (already scaled), the output accumulator acc_s [G, D], and per head the
// running max m_s, the running denominator l_s and the last rescale
// factor c_s. Each tile of keys is scored into p_s [G, P] (row stride P,
// -INFINITY where a position is not visible) and then folded into that
// state by fold_tile, the online-softmax recurrence of the reference's
// `_decode_softmax_update`.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace decode {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The group's queries into q_s and a zeroed state; ends synced.
template <int kThreads, typename T>
__device__ __forceinline__ void init_state(const T* __restrict__ q, size_t row0, float* q_s,
                                           float* acc_s, float* m_s, float* l_s, int G, int D) {
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    q_s[i] = to_f32(q[row0 + i]);
    acc_s[i] = 0.f;
  }
  for (int g = threadIdx.x; g < G; g += kThreads) {
    m_s[g] = -INFINITY;
    l_s[g] = 0.f;
  }
  __syncthreads();
}

// Fold the scores of one tile, rows 0 .. n-1 of p_s, into the state:
// p = exp(s - m_new) per head, l = l * corr + sum(p), acc = acc * corr +
// p V, with V's rows in v_s (row stride ldv). While a head has seen no
// visible position (m_new = -inf) nothing is added and nothing becomes
// NaN. Called after a __syncthreads() that published p_s and v_s; ends
// synced.
//
// kCompensated (the int8 kernel): the tile's p V is summed on its own and
// then folded into acc with a Kahan compensation term comp_s [G, D]
// (scaled by corr with acc), and l folds with one rounding (fmaf). In
// the plain fold every p_i v_i of the whole sequence adds to acc with a
// rounding at acc's magnitude: with one dominant key (|o| ~ 10 from a
// grown int8 block) that walk reached 1.25e-5 against a float64 oracle,
// three times the plain version's error (PERF.md §6).
template <int kThreads, bool kCompensated = false>
__device__ __forceinline__ void fold_tile(float* p_s, int P, const float* v_s, int ldv,
                                          float* acc_s, float* m_s, float* l_s, float* c_s,
                                          int G, int D, int n, float* comp_s = nullptr) {
  constexpr int kWarps = kThreads / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int g = warp; g < G; g += kWarps) {
    float mx = -INFINITY;
    for (int i = lane; i < n; i += 32) mx = fmaxf(mx, p_s[g * P + i]);
    mx = warp_max(mx);
    const float m_old = m_s[g];
    const float m_new = fmaxf(m_old, mx);
    const bool none = m_new == -INFINITY;
    float sum = 0.f;
    for (int i = lane; i < n; i += 32) {
      const float p = none ? 0.f : expf(p_s[g * P + i] - m_new);
      p_s[g * P + i] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      const float corr = none ? 1.f : expf(m_old - m_new);
      m_s[g] = m_new;
      l_s[g] = kCompensated ? fmaf(l_s[g], corr, sum) : l_s[g] * corr + sum;
      c_s[g] = corr;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < G * D; idx += kThreads) {
    const int g = idx / D, d = idx - g * D;
    if (kCompensated) {
      float t = 0.f;
      for (int i = 0; i < n; ++i) t = fmaf(p_s[g * P + i], v_s[i * ldv + d], t);
      const float c = c_s[g], a = acc_s[idx] * c;
      const float y = t + comp_s[idx] * c;
      const float sum = a + y;
      comp_s[idx] = y - (sum - a);
      acc_s[idx] = sum;
    } else {
      float a = acc_s[idx] * c_s[g];
      for (int i = 0; i < n; ++i) a += p_s[g * P + i] * v_s[i * ldv + d];
      acc_s[idx] = a;
    }
  }
  __syncthreads();
}

// o = acc / l per head (0 where no position was visible) into out[row0 ..];
// with comp_s, acc + comp.
template <int kThreads, typename T>
__device__ __forceinline__ void write_out(T* __restrict__ out, size_t row0, const float* acc_s,
                                          const float* l_s, int G, int D,
                                          const float* comp_s = nullptr) {
  for (int idx = threadIdx.x; idx < G * D; idx += kThreads) {
    const float l = l_s[idx / D];
    const float a = comp_s != nullptr ? acc_s[idx] + comp_s[idx] : acc_s[idx];
    store(&out[row0 + idx], l == 0.f ? 0.f : a / l);
  }
}

// Dynamic shared memory above 48 KB needs the opt-in attribute.
template <typename K>
__host__ cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace decode
