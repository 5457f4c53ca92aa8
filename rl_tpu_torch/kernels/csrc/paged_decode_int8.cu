// Paged single-token decode attention over int8 K/V pools, written by
// hand for Hopper (sm_90a).
//
// Replaces the TPU kernel rl_tpu/kernels/paged_attention.py
// `paged_flash_decode_int8` (body `_paged_decode_int8_kernel`).
//
// What it computes: paged_decode.cu's function (for every slot s and
// query head h, softmax(q[s,h] . K[s]^T) V[s] over the positions
// p < attend_lens[s] of the slot's table, entries <= 0 skipped, zeros for
// a row with no position), with K and V stored as int8 and read back as
// int8 * scale, one float32 scale per (pool block, kv head). The scale is
// looked up through the same table entry as the tile, and the kernel only
// multiplies by it: a never-written block's scale of 0 is harmless.
//
// Layouts (the reference's): q and out [S, H, D] float32 or bfloat16;
// pools head-major [N, Hk, B, D] int8; scale_k/scale_v [N, Hk] float32;
// table [S, max_blocks] int32; attend_lens [S] int32.
//
// Bound on an H100: memory. The function must read q, the table and the
// lengths, write out, and read the int8 K and V rows of every attended
// position and the two scales of every attended (block, kv head) once:
//   bytes = 2 * S*H*D*esz + 4 * S*max_blocks + 4 * S
//           + 2 * rows * Hk*D + 2 * 4 * tiles * Hk,
// against 4 * H*D flops per attended row (q.k and p.v). At the serving
// shape (8 slots, 1617 attended rows in 103 tiles, 12 kv heads of 64, bf16
// q) that is ~2.5 MB, about half of paged_decode.cu's bf16 bytes: ~0.75 us
// at 3.35 TB/s, the bound chip_smoke.py computes from the same inputs.
//
// What the design does about it: paged_decode.cu's structure (one block
// per (slot, kv head) serving its GQA group, walking the table up to the
// slot's length); each [B, D] int8 tile arrives as 16-byte vectors (16
// values a load, B * D a multiple of 16) and is widened to float32 and
// multiplied by its scale once, in shared memory, before the scores. The
// online softmax is decode_common.cuh's, in its compensated form: each
// tile's p V summed on its own, then folded into acc with a Kahan term,
// so that a float32 output stays as close to the exact result as the
// plain version's (PERF.md §6: the plain fold's rounding walk read
// 1.25e-5 from a float64 oracle where the plain version read 4.3e-6).
// A first, simple version: no cp.async/TMA double buffering, S * Hk
// blocks.

#include "decode_common.cuh"

namespace {

using namespace decode;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

template <typename T>
__global__ void __launch_bounds__(kThreads) paged_decode_int8_kernel(
    const T* __restrict__ q, const int8_t* __restrict__ pool_k,
    const int8_t* __restrict__ pool_v, const float* __restrict__ scale_k,
    const float* __restrict__ scale_v, const int32_t* __restrict__ table,
    const int32_t* __restrict__ attend_lens, T* __restrict__ out, int H, int Hk, int D, int B,
    int max_blocks) {
  const int s = blockIdx.x;
  const int kvh = blockIdx.y;
  const int G = H / Hk;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ float smem[];
  float* q_s = smem;           // [G, D]
  float* k_s = q_s + G * D;    // [B, D] dequantized
  float* v_s = k_s + B * D;    // [B, D] dequantized
  float* p_s = v_s + B * D;    // [G, B] scores, then probabilities
  float* acc_s = p_s + G * B;  // [G, D]
  float* m_s = acc_s + G * D;  // [G]
  float* l_s = m_s + G;        // [G]
  float* c_s = l_s + G;        // [G]
  float* comp_s = c_s + G;     // [G, D] acc's compensation

  const size_t row0 = ((size_t)s * H + (size_t)kvh * G) * D;
  for (int i = tid; i < G * D; i += kThreads) comp_s[i] = 0.f;
  init_state<kThreads>(q, row0, q_s, acc_s, m_s, l_s, G, D);
  const int attend = attend_lens[s];
  int n_j = attend > 0 ? (attend + B - 1) / B : 0;
  if (n_j > max_blocks) n_j = max_blocks;
  const int vecs = B * D / 16;  // 16-byte int8 vectors per tile

  for (int j = 0; j < n_j; ++j) {
    const int blk = table[(size_t)s * max_blocks + j];
    if (blk <= 0) continue;  // scratch or unassigned: never a key
    const size_t tile = (size_t)blk * Hk + kvh;
    const float sk = scale_k[tile], sv = scale_v[tile];
    const int4* kt = reinterpret_cast<const int4*>(pool_k + tile * B * D);
    const int4* vt = reinterpret_cast<const int4*>(pool_v + tile * B * D);
    for (int i = tid; i < vecs; i += kThreads) {
      const int4 rk = __ldg(kt + i), rv = __ldg(vt + i);
      const int8_t* ek = reinterpret_cast<const int8_t*>(&rk);
      const int8_t* ev = reinterpret_cast<const int8_t*>(&rv);
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        k_s[i * 16 + u] = (float)ek[u] * sk;
        v_s[i * 16 + u] = (float)ev[u] * sv;
      }
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
    fold_tile<kThreads, true>(p_s, B, v_s, D, acc_s, m_s, l_s, c_s, G, D, B, comp_s);
  }
  write_out<kThreads>(out, row0, acc_s, l_s, G, D, comp_s);
}

template <typename T>
int launch(const void* q, const void* pool_k, const void* pool_v, const void* scale_k,
           const void* scale_v, const void* table, const void* attend_lens, void* out, int S,
           int H, int Hk, int D, int B, int max_blocks, cudaStream_t stream) {
  const int G = H / Hk;
  const size_t smem = sizeof(float) * (size_t)(3 * G * D + 2 * B * D + G * B + 3 * G);
  cudaError_t e = allow_smem(paged_decode_int8_kernel<T>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(S, Hk);
  paged_decode_int8_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const int8_t*>(pool_k),
      static_cast<const int8_t*>(pool_v), static_cast<const float*>(scale_k),
      static_cast<const float*>(scale_v), static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(attend_lens), static_cast<T*>(out), H, Hk, D, B, max_blocks);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q and out share it). Pools must be
// 16-byte aligned with B * D a multiple of 16 (the wrapper checks both).
int rl_paged_decode_int8(const void* q, const void* pool_k, const void* pool_v,
                         const void* scale_k, const void* scale_v, const void* table,
                         const void* attend_lens, void* out, int S, int H, int Hk, int D, int B,
                         int max_blocks, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((B * D) % 16 != 0 || H % Hk != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(q, pool_k, pool_v, scale_k, scale_v, table, attend_lens, out, S, H, Hk,
                         D, B, max_blocks, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, pool_k, pool_v, scale_k, scale_v, table, attend_lens, out, S,
                                 H, Hk, D, B, max_blocks, st);
  return (int)cudaErrorInvalidValue;
}

const char* rl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
