// Paged single-token decode attention, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel rl_tpu/ops/attention.py `paged_flash_decode`
// (body `_paged_decode_kernel`, online-softmax step `_decode_softmax_update`).
//
// What it computes: for every sequence slot s and query head h,
//   o[s,h] = softmax(q[s,h] . K[s]^T) V[s]
// over the positions p < attend_lens[s] of the slot's paged KV, where
// position p lives in pool block table[s, p / B] at row p % B. Table
// entries <= 0 (0 = reserved scratch, -1 = unassigned) are skipped, and a
// row with no attended key writes zeros. q arrives already multiplied by
// the softmax scale (in q's dtype, as the reference does before its kernel).
//
// Layouts (the reference's): q and out [S, H, D]; pools head-major
// [N, Hk, B, D]; table [S, max_blocks] int32; attend_lens [S] int32.
// H is a multiple of Hk (GQA: query head h reads kv head h / (H / Hk)).
//
// Bound on an H100: memory. Per slot the kernel must read every attended
// K and V row once (2 * attend * Hk * D elements); the arithmetic is
// 4 * H * D flops per attended position, about one flop per byte for MHA
// in bf16, far below the card's ~295 flops per byte ridge. At the serving
// path's shapes (8 slots x ~300 positions x 12 kv heads x 64 x bf16) that
// is a few MB per layer: a few microseconds at 3.35 TB/s.
//
// What the design does about it:
//  - one thread block per (slot, kv head) serves all H/Hk query heads of
//    its group, so each K/V block is read from device memory once per
//    group, not once per query head (the TPU grid ran one cell per q head);
//  - the block walks its table entries in order and stops at
//    ceil(attend / B): blocks past the slot's length are never fetched;
//  - each [B, D] K and V tile is staged in shared memory with consecutive
//    threads on consecutive addresses, and the online-softmax state
//    (m, l, acc) stays in fp32 shared memory for the whole walk; nothing
//    but the final [G, D] output goes back to device memory.
// A first, simple version: no cp.async/TMA double buffering yet, and the
// grid is S * Hk blocks, which leaves SMs idle at small batch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

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

template <typename T>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ pool_k,
    const T* __restrict__ pool_v, const int32_t* __restrict__ table,
    const int32_t* __restrict__ attend_lens, T* __restrict__ out, int H,
    int Hk, int D, int B, int max_blocks) {
  const int s = blockIdx.x;
  const int kvh = blockIdx.y;
  const int G = H / Hk;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ float smem[];
  float* q_s = smem;          // [G, D]
  float* k_s = q_s + G * D;   // [B, D]
  float* v_s = k_s + B * D;   // [B, D]
  float* p_s = v_s + B * D;   // [G, B] scores, then probabilities
  float* acc_s = p_s + G * B; // [G, D]
  float* m_s = acc_s + G * D; // [G] running max
  float* l_s = m_s + G;       // [G] running denominator
  float* c_s = l_s + G;       // [G] this block's rescale factor

  // the group's G query heads are consecutive: rows kvh*G .. kvh*G+G-1
  const size_t row0 = ((size_t)s * H + (size_t)kvh * G) * D;
  for (int i = tid; i < G * D; i += kThreads) {
    q_s[i] = to_f32(q[row0 + i]);
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = -INFINITY;
    l_s[g] = 0.f;
  }
  const int attend = attend_lens[s];
  int n_j = attend > 0 ? (attend + B - 1) / B : 0;
  if (n_j > max_blocks) n_j = max_blocks;
  __syncthreads();

  for (int j = 0; j < n_j; ++j) {
    const int blk = table[(size_t)s * max_blocks + j];
    if (blk <= 0) continue;  // scratch or unassigned: never a key
    const size_t base = ((size_t)blk * Hk + kvh) * (size_t)B * D;
    for (int i = tid; i < B * D; i += kThreads) {
      k_s[i] = to_f32(pool_k[base + i]);
      v_s[i] = to_f32(pool_v[base + i]);
    }
    __syncthreads();

    // scores: one warp per (head, position), lanes split D
    const int kv0 = j * B;
    for (int r = warp; r < G * B; r += kWarps) {
      const int g = r / B, i = r - g * B;
      float dot = 0.f;
      for (int d = lane; d < D; d += 32) dot += q_s[g * D + d] * k_s[i * D + d];
      dot = warp_sum(dot);
      if (lane == 0) p_s[r] = (kv0 + i < attend) ? dot : -INFINITY;
    }
    __syncthreads();

    // online-softmax update: one warp per head. The block holds at least
    // one attended position (kv0 < attend), so m_new is finite.
    for (int g = warp; g < G; g += kWarps) {
      float mx = -INFINITY;
      for (int i = lane; i < B; i += 32) mx = fmaxf(mx, p_s[g * B + i]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int i = lane; i < B; i += 32) {
        const float p = expf(p_s[g * B + i] - m_new);
        p_s[g * B + i] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        m_s[g] = m_new;
        l_s[g] = l_s[g] * corr + sum;
        c_s[g] = corr;
      }
    }
    __syncthreads();

    for (int idx = tid; idx < G * D; idx += kThreads) {
      const int g = idx / D, d = idx - g * D;
      float a = acc_s[idx] * c_s[g];
      for (int i = 0; i < B; ++i) a += p_s[g * B + i] * v_s[i * D + d];
      acc_s[idx] = a;
    }
    __syncthreads();
  }

  for (int idx = tid; idx < G * D; idx += kThreads) {
    const float l = l_s[idx / D];
    store(&out[row0 + idx], l == 0.f ? 0.f : acc_s[idx] / l);
  }
}

template <typename T>
int launch(const void* q, const void* pool_k, const void* pool_v,
           const void* table, const void* attend_lens, void* out, int S,
           int H, int Hk, int D, int B, int max_blocks, cudaStream_t stream) {
  const int G = H / Hk;
  const size_t smem = sizeof(float) * (size_t)(2 * G * D + 2 * B * D + G * B + 3 * G);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(S, Hk);
  paged_decode_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pool_k),
      static_cast<const T*>(pool_v), static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(attend_lens), static_cast<T*>(out), H, Hk,
      D, B, max_blocks);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, pools and out share it).
int rl_paged_decode(const void* q, const void* pool_k, const void* pool_v,
                    const void* table, const void* attend_lens, void* out,
                    int S, int H, int Hk, int D, int B, int max_blocks,
                    int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, pool_k, pool_v, table, attend_lens, out, S, H,
                         Hk, D, B, max_blocks, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, pool_k, pool_v, table, attend_lens, out,
                                 S, H, Hk, D, B, max_blocks, st);
  return (int)cudaErrorInvalidValue;
}

const char* rl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
