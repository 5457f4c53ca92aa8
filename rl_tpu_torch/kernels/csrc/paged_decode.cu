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
// Bound on an H100: memory. The kernel must read every attended K and V
// row once (2 * attend * Hk * D elements per slot) for 4 * H * D flops per
// attended position, about one flop per byte in bf16 MHA, far below the
// card's ~295 flops per byte ridge. At the serving path's shapes (8 slots,
// 1617 attended positions in all, 12 kv heads of 64, bf16) that is 4.97 MB:
// 1.49 us at 3.35 TB/s.
//
// Design (flash-decoding). The first version ran one block per (slot, kv
// head) walking its table entries in turn: 96 blocks on 132 SMs, bound by
// the latency of one 16-row entry after another. Now:
//  - the sequence is split across blocks: grid (n_split, kv head groups,
//    S), each split owning kChunk = 64 positions. n_split comes from
//    max_blocks and B alone (the host never reads the device lengths); a
//    split that starts at or past the slot's length exits at once;
//  - one block serves up to kMaxGroup query heads of one kv head (the GQA
//    group, cut into head groups when larger), so each K/V row is read
//    from device memory once per group;
//  - K/V rows move as 16-byte cp.async copies into shared memory, in their
//    own type (bf16 halves the bytes), converted to float32 at use. A
//    split's two 32-row tiles are both in flight before the first is
//    scored. Each lane reads back only what it copied itself, so the loop
//    has no __syncthreads(): a lane's own cp.async.wait_group is enough;
//  - the lanes of a position split D into 16-byte chunks and reduce the
//    score by shuffles. Each lane group keeps an online-softmax state (m,
//    l, acc) in float32 registers for the block's heads; the groups merge
//    by shuffles, the four warps through shared memory (one barrier);
//  - each split writes its state (m, l, unnormalised acc) to a float32
//    scratch the wrapper allocates, and a second small kernel, launched
//    from the same C call, rescales and sums the live splits of each
//    (slot, head) into out. A split with no visible key leaves m = -inf,
//    l = 0 and contributes nothing; a row with none at all gets zeros.
//    The merge and the combine live in paged_split.cuh, shared with the
//    int8 kernel (paged_decode_int8.cu).
// Measured by chip_smoke.py on an H100 80GB HBM3 at a 700 W power limit,
// one call (split kernel and combine) after an L2 flush: 0.0169-0.0170 ms
// at the serving shape (8 slots of 1-544 positions, bf16), against
// 0.1413-0.1416 ms for the first version, one block per (slot, kv head),
// and 0.0244-0.0247 ms for SDPA over K/V gathered beforehand; bound 0.00149
// ms. At the train collect's shape (8 slots of 513-1024 positions) 0.0254-
// 0.0255 ms, SDPA 0.0300-0.0303, bound 0.00565.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "paged_split.cuh"

namespace {

using namespace async_copy;
using namespace paged_split;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 8;  // query heads one block serves

// Shared memory of one split block, in bytes: the K/V ring, the heads'
// queries and the warps' states for the final merge.
template <typename T, int D, int GM>
constexpr size_t split_smem() {
  return sizeof(T) * kStages * 2 * kTile * D + sizeof(float) * (GM * D + kWarps * GM * (D + 2));
}

// Grid (n_split, Hk * head groups, S). Writes, for each of its heads h and
// its split, acc [D] to part_acc[(s*H + h)*n_split + split] and (m, l) to
// part_ml at the same index.
template <typename T, int D, int GM>
__global__ void __launch_bounds__(kThreads) paged_decode_split(
    const T* __restrict__ q, const T* __restrict__ pool_k, const T* __restrict__ pool_v,
    const int32_t* __restrict__ table, const int32_t* __restrict__ attend_lens,
    float* __restrict__ part_acc, float* __restrict__ part_ml, int H, int Hk, int B,
    int max_blocks, int n_split) {
  constexpr int VEC = Chunk<T>::N;        // elements per 16-byte chunk
  constexpr int LPP = D / VEC;            // lanes per position (4 .. 32)
  constexpr int PPW = 32 / LPP;           // positions a warp scores at once
  constexpr int NPG = kTile / (kWarps * PPW);  // positions per lane group per tile
  static_assert(LPP >= 1 && LPP <= 32 && NPG >= 1, "unsupported head dim");

  const int split = blockIdx.x, s = blockIdx.z;
  const int G = H / Hk, n_hg = (G + GM - 1) / GM;
  const int kvh = blockIdx.y / n_hg, g0 = (blockIdx.y - kvh * n_hg) * GM;
  const int Gb = min(GM, G - g0);
  const int L = min(attend_lens[s], max_blocks * B);
  const int p0 = split * kChunk;
  if (p0 >= L) return;  // past the slot's length: the combine reads nothing of it
  const int p_end = min(L, p0 + kChunk);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane / LPP, c = lane - grp * LPP;  // position group, chunk in the row

  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);  // [kStages][K, V][kTile][D]
  float* q_s = reinterpret_cast<float*>(ring + kStages * 2 * kTile * D);  // [GM][D]
  float* red = q_s + GM * D;  // [kWarps][GM][D + 2]: acc, m, l

  // every tile's copies first: lane (grp, c) copies chunk c of the rows it
  // will score; a hole or a position past the length is zero-filled
  bool ok[kStages][NPG];
#pragma unroll
  for (int t = 0; t < kStages; ++t) {
    T* st = ring + t * 2 * kTile * D;
    const bool live = p0 + t * kTile < p_end;
#pragma unroll
    for (int k = 0; k < NPG; ++k) {
      const int pi = warp * (kTile / kWarps) + k * PPW + grp;
      const int p = p0 + t * kTile + pi;
      const int blk = p < p_end ? __ldg(&table[(size_t)s * max_blocks + p / B]) : 0;
      ok[t][k] = blk > 0;
      const size_t off =
          ok[t][k] ? (((size_t)blk * Hk + kvh) * B + (p % B)) * (size_t)D + c * VEC : 0;
      if (live) {
        cp_async16(st + pi * D + c * VEC, pool_k + off, ok[t][k]);
        cp_async16(st + (kTile + pi) * D + c * VEC, pool_v + off, ok[t][k]);
      }
    }
    cp_async_commit();
  }

  // the heads' queries (already scaled); heads past Gb score zeros and
  // are never written
  const size_t qrow = ((size_t)s * H + (size_t)kvh * G + g0) * D;
  for (int i = tid; i < GM * D; i += kThreads) q_s[i] = i < Gb * D ? to_f32(q[qrow + i]) : 0.f;
  __syncthreads();

  float m[GM], l[GM], acc[GM][VEC];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[g][e] = 0.f;
  }

#pragma unroll
  for (int t = 0; t < kStages; ++t) {
    if (t == 0)
      cp_async_wait<kStages - 1>();
    else
      cp_async_wait<0>();
    if (p0 + t * kTile >= p_end) break;  // uniform: the tile holds no position
    const T* st = ring + t * 2 * kTile * D;

    float sc[NPG][GM];
#pragma unroll
    for (int k = 0; k < NPG; ++k) {
      const int pi = warp * (kTile / kWarps) + k * PPW + grp;
      float kx[VEC];
      Chunk<T>::widen(st + pi * D + c * VEC, kx);
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        const float4* qv = reinterpret_cast<const float4*>(q_s + g * D + c * VEC);
        float d = 0.f;
#pragma unroll
        for (int e4 = 0; e4 < VEC / 4; ++e4) {
          const float4 qq = qv[e4];
          d += qq.x * kx[4 * e4] + qq.y * kx[4 * e4 + 1] + qq.z * kx[4 * e4 + 2] +
               qq.w * kx[4 * e4 + 3];
        }
#pragma unroll
        for (int o = LPP / 2; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
        sc[k][g] = ok[t][k] ? d : -INFINITY;
      }
    }

#pragma unroll
    for (int g = 0; g < GM; ++g) {
      float mx = sc[0][g];
#pragma unroll
      for (int k = 1; k < NPG; ++k) mx = fmaxf(mx, sc[k][g]);
      const float m_new = fmaxf(m[g], mx);
      if (m_new != -INFINITY) {  // else: nothing visible yet, nothing to rescale
        const float corr = expf(m[g] - m_new);
        l[g] *= corr;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[g][e] *= corr;
        m[g] = m_new;
      }
    }

#pragma unroll
    for (int k = 0; k < NPG; ++k) {
      const int pi = warp * (kTile / kWarps) + k * PPW + grp;
      float vx[VEC];
      Chunk<T>::widen(st + (kTile + pi) * D + c * VEC, vx);
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        const float p = ok[t][k] ? expf(sc[k][g] - m[g]) : 0.f;
        l[g] += p;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[g][e] += p * vx[e];
      }
    }
  }

  write_split_state<D, VEC, GM, kThreads>(m, l, acc, red, Gb,
                                          (size_t)s * H + (size_t)kvh * G + g0, split, n_split,
                                          part_acc, part_ml);
}

template <typename T, int D, int GM>
int launch(const void* q, const void* pool_k, const void* pool_v, const void* table,
           const void* attend_lens, void* out, float* scratch, int S, int H, int Hk, int B,
           int max_blocks, int n_split, cudaStream_t stream) {
  const size_t smem = split_smem<T, D, GM>();
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(paged_decode_split<T, D, GM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int G = H / Hk, n_hg = (G + GM - 1) / GM;
  float* part_acc = scratch;
  float* part_ml = scratch + (size_t)S * H * n_split * D;
  const int32_t* lens = static_cast<const int32_t*>(attend_lens);
  paged_decode_split<T, D, GM><<<dim3(n_split, Hk * n_hg, S), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pool_k), static_cast<const T*>(pool_v),
      static_cast<const int32_t*>(table), lens, part_acc, part_ml, H, Hk, B, max_blocks,
      n_split);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return launch_combine<T>(part_acc, part_ml, lens, static_cast<T*>(out), S, H, D,
                           max_blocks * B, n_split, stream);
}

template <typename T, int D>
int by_group(int G, const void* q, const void* pk, const void* pv, const void* table,
             const void* lens, void* out, float* scratch, int S, int H, int Hk, int B,
             int max_blocks, int n_split, cudaStream_t st) {
  if (G == 1)
    return launch<T, D, 1>(q, pk, pv, table, lens, out, scratch, S, H, Hk, B, max_blocks,
                           n_split, st);
  if (G <= 4)
    return launch<T, D, 4>(q, pk, pv, table, lens, out, scratch, S, H, Hk, B, max_blocks,
                           n_split, st);
  return launch<T, D, kMaxGroup>(q, pk, pv, table, lens, out, scratch, S, H, Hk, B,
                                 max_blocks, n_split, st);
}

template <typename T>
int by_dim(int D, int G, const void* q, const void* pk, const void* pv, const void* table,
           const void* lens, void* out, float* scratch, int S, int H, int Hk, int B,
           int max_blocks, int n_split, cudaStream_t st) {
  switch (D) {
    case 32:
      return by_group<T, 32>(G, q, pk, pv, table, lens, out, scratch, S, H, Hk, B, max_blocks,
                             n_split, st);
    case 64:
      return by_group<T, 64>(G, q, pk, pv, table, lens, out, scratch, S, H, Hk, B, max_blocks,
                             n_split, st);
    case 128:
      return by_group<T, 128>(G, q, pk, pv, table, lens, out, scratch, S, H, Hk, B,
                              max_blocks, n_split, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, pools and out share it). scratch:
// S * H * n_split * (D + 2) float32, n_split = ceil(max_blocks * B / 64).
// Launches the split kernel and the combine on `stream`.
int rl_paged_decode(const void* q, const void* pool_k, const void* pool_v, const void* table,
                    const void* attend_lens, void* out, void* scratch, int S, int H, int Hk,
                    int D, int B, int max_blocks, int n_split, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Hk <= 0 || H % Hk != 0 || B <= 0 ||
      (long long)n_split * kChunk < (long long)max_blocks * B)
    return (int)cudaErrorInvalidValue;
  float* sc = static_cast<float*>(scratch);
  const int G = H / Hk;
  if (dtype == 0)
    return by_dim<float>(D, G, q, pool_k, pool_v, table, attend_lens, out, sc, S, H, Hk, B,
                         max_blocks, n_split, st);
  if (dtype == 1)
    return by_dim<__nv_bfloat16>(D, G, q, pool_k, pool_v, table, attend_lens, out, sc, S, H,
                                 Hk, B, max_blocks, n_split, st);
  return (int)cudaErrorInvalidValue;
}

const char* rl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
