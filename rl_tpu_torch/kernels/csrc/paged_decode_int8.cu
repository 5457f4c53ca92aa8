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
// looked up through the same table entry as the row, and the kernel only
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
// Design: paged_decode.cu's split plan (paged_split.cuh), written for
// int8. The first version ran one block per (slot, kv head), walking its
// table entries one 16-row tile after another through float32 shared
// memory: 96 blocks, latency-bound at 0.11 ms. Now:
//  - grid (n_split, kv head groups, S), each split kChunk = 64 positions
//    (it may cross 64 / B table entries, each with its own scales and its
//    own entry <= 0 skip); a split past the slot's length exits at once;
//  - K/V rows move as int8 in 16-byte cp.async copies (16 values) into a
//    two-stage ring, both stages in flight. A position takes D / 16 lanes
//    (2, 4 or 8); a lane reads back only the chunk it copied, so the loop
//    has no barrier. D = 32 blocks have 64 threads, so that each lane
//    group holds one position of each stage, as at D = 64;
//  - each lane widens its chunk to float32 at use and applies the scales
//    there: scale_k to the position's dot product, scale_v to its p. No
//    dequantized tile is written anywhere;
//  - the dot product and its scaling run in float64 (the int8 and float32
//    factors multiply exactly), so that s - m, not s, rounds to float32
//    before the exp. With one grown int8 block |s| reaches tens, and the
//    rounding of a float32 score was the largest error against a float64
//    oracle (the first version, which scored in float32, read 3.08e-6 on
//    chip_smoke's main float32 case); in float64 this one reads 7.4e-7
//    and 1.48e-6 on its two float32 oracle cases, the plain version
//    1.82e-6 and 4.25e-6;
//  - each lane group keeps (m, l, acc) in float32 registers for up to
//    kMaxGroup = 4 heads of the GQA group (larger groups are cut into head
//    groups: acc holds 16 values a head, and 8 heads would cost 128
//    registers for acc alone); the groups and warps merge and the splits
//    combine as in paged_decode.cu. Each split sums at most 64 positions
//    by a tree of merges, so the float32 rounding walk that needed a
//    compensated fold in the first version (PERF.md §6, C1) stays short.
// Measured by chip_smoke.py on an H100 80GB HBM3 at a 700 W power limit,
// one call (split kernel and combine) after an L2 flush: 0.0192 ms at the
// serving shape (8 slots of 1-544 positions, bf16 q), against 0.1102-
// 0.1104 ms for the first version in the same run and 0.0242 ms for SDPA
// over K/V gathered and dequantized beforehand; bound 0.00075 ms. At the
// train collect's shape (8 slots of 513-1024 positions) 0.0266-0.0269 ms,
// SDPA 0.0300-0.0304, bound 0.00284.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "paged_split.cuh"

namespace {

using namespace async_copy;
using namespace paged_split;

constexpr int kVec = 16;      // int8 values per 16-byte copy
constexpr int kMaxGroup = 4;  // query heads one block serves

// threads of a block: each lane group holds one position per stage at D =
// 32 and 64, two at D = 128
__host__ __device__ constexpr int threads_for(int D) { return D == 32 ? 64 : 128; }

// 16 int8 values in shared memory, widened to float32.
__device__ __forceinline__ void widen16(const int8_t* p, float (&x)[kVec]) {
  const int4 v = *reinterpret_cast<const int4*>(p);
  const int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int b = 0; b < 4; ++b) x[4 * i + b] = (float)(int8_t)(w[i] >> (8 * b));
}

// Shared memory of one split block, in bytes: the int8 K/V ring, the
// heads' queries and the warps' states for the final merge.
template <int D, int GM>
constexpr size_t split_smem() {
  return (size_t)kStages * 2 * kTile * D +
         sizeof(float) * (GM * D + threads_for(D) / 32 * GM * (D + 2));
}
static_assert(split_smem<128, kMaxGroup>() <= 48 * 1024, "a split block needs no opt-in");

// Grid (n_split, Hk * head groups, S). Writes, for each of its heads h and
// its split, acc [D] to part_acc[(s*H + h)*n_split + split] and (m, l) to
// part_ml at the same index.
template <typename T, int D, int GM>
__global__ void __launch_bounds__(D == 32 ? 64 : 128) paged_decode_int8_split(
    const T* __restrict__ q, const int8_t* __restrict__ pool_k,
    const int8_t* __restrict__ pool_v, const float* __restrict__ scale_k,
    const float* __restrict__ scale_v, const int32_t* __restrict__ table,
    const int32_t* __restrict__ attend_lens, float* __restrict__ part_acc,
    float* __restrict__ part_ml, int H, int Hk, int B, int max_blocks, int n_split) {
  constexpr int kThreads = threads_for(D);
  constexpr int kWarps = kThreads / 32;
  constexpr int LPP = D / kVec;                // lanes per position (2, 4, 8)
  constexpr int PPW = 32 / LPP;                // positions a warp holds at once
  constexpr int NPG = kTile / (kWarps * PPW);  // positions per lane group per stage
  static_assert(NPG >= 1 && NPG * kWarps * PPW == kTile, "unsupported head dim");

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
  int8_t* ring = reinterpret_cast<int8_t*>(smem);  // [kStages][K, V][kTile][D]
  float* q_s = reinterpret_cast<float*>(ring + kStages * 2 * kTile * D);  // [GM][D]
  float* red = q_s + GM * D;  // [kWarps][GM][D + 2]: acc, m, l

  // every stage's copies first: lane (grp, c) copies chunk c of the rows
  // it will score, and loads their scales; a hole or a position past the
  // length is zero-filled and scores -inf
  bool ok[kStages][NPG];
  float sk[kStages][NPG], sv[kStages][NPG];
#pragma unroll
  for (int t = 0; t < kStages; ++t) {
    int8_t* st = ring + t * 2 * kTile * D;
    const bool live = p0 + t * kTile < p_end;
#pragma unroll
    for (int k = 0; k < NPG; ++k) {
      const int pi = warp * (kTile / kWarps) + k * PPW + grp;
      const int p = p0 + t * kTile + pi;
      const int blk = p < p_end ? __ldg(&table[(size_t)s * max_blocks + p / B]) : 0;
      ok[t][k] = blk > 0;
      const size_t tile = ok[t][k] ? (size_t)blk * Hk + kvh : 0;
      const size_t off = ok[t][k] ? (tile * B + (p % B)) * (size_t)D + c * kVec : 0;
      sk[t][k] = ok[t][k] ? __ldg(&scale_k[tile]) : 0.f;
      sv[t][k] = ok[t][k] ? __ldg(&scale_v[tile]) : 0.f;
      if (live) {
        cp_async16(st + pi * D + c * kVec, pool_k + off, ok[t][k]);
        cp_async16(st + (kTile + pi) * D + c * kVec, pool_v + off, ok[t][k]);
      }
    }
    cp_async_commit();
  }

  // the heads' queries (already scaled); heads past Gb score zeros and
  // are never written
  const size_t qrow = ((size_t)s * H + (size_t)kvh * G + g0) * D;
  for (int i = tid; i < GM * D; i += kThreads) q_s[i] = i < Gb * D ? to_f32(q[qrow + i]) : 0.f;
  __syncthreads();

  float m[GM], l[GM], acc[GM][kVec];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[g][e] = 0.f;
  }

#pragma unroll
  for (int t = 0; t < kStages; ++t) {
    if (t == 0)
      cp_async_wait<kStages - 1>();
    else
      cp_async_wait<0>();
    if (p0 + t * kTile >= p_end) break;  // uniform: the stage holds no position
    const int8_t* st = ring + t * 2 * kTile * D;

    // scores: the int8 row's dot product with q, times the row's scale,
    // in float64 (four chains of exact products), so that s - m, not s,
    // is what rounds to float32
    double sc[NPG][GM];
#pragma unroll
    for (int k = 0; k < NPG; ++k) {
      const int pi = warp * (kTile / kWarps) + k * PPW + grp;
      float kx[kVec];
      widen16(st + pi * D + c * kVec, kx);
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        const float4* qv = reinterpret_cast<const float4*>(q_s + g * D + c * kVec);
        double d0 = 0, d1 = 0, d2 = 0, d3 = 0;
#pragma unroll
        for (int e4 = 0; e4 < kVec / 4; ++e4) {
          const float4 qq = qv[e4];
          d0 = fma((double)qq.x, (double)kx[4 * e4], d0);
          d1 = fma((double)qq.y, (double)kx[4 * e4 + 1], d1);
          d2 = fma((double)qq.z, (double)kx[4 * e4 + 2], d2);
          d3 = fma((double)qq.w, (double)kx[4 * e4 + 3], d3);
        }
        double d = (d0 + d1) + (d2 + d3);
#pragma unroll
        for (int o = LPP / 2; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
        sc[k][g] = ok[t][k] ? d * (double)sk[t][k] : -INFINITY;
      }
    }

#pragma unroll
    for (int g = 0; g < GM; ++g) {
      float mx = (float)sc[0][g];
#pragma unroll
      for (int k = 1; k < NPG; ++k) mx = fmaxf(mx, (float)sc[k][g]);
      const float m_new = fmaxf(m[g], mx);
      if (m_new != -INFINITY) {  // else: nothing visible yet, nothing to rescale
        const float corr = expf(m[g] - m_new);
        l[g] *= corr;
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[g][e] *= corr;
        m[g] = m_new;
      }
    }

    // p V with the row's scale on p
#pragma unroll
    for (int k = 0; k < NPG; ++k) {
      const int pi = warp * (kTile / kWarps) + k * PPW + grp;
      float vx[kVec];
      widen16(st + (kTile + pi) * D + c * kVec, vx);
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        const float p = ok[t][k] ? expf((float)(sc[k][g] - (double)m[g])) : 0.f;
        l[g] += p;
        const float pv = p * sv[t][k];
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[g][e] += pv * vx[e];
      }
    }
  }

  write_split_state<D, kVec, GM, kThreads>(m, l, acc, red, Gb,
                                           (size_t)s * H + (size_t)kvh * G + g0, split,
                                           n_split, part_acc, part_ml);
}

template <typename T, int D, int GM>
int launch(const void* q, const void* pool_k, const void* pool_v, const void* scale_k,
           const void* scale_v, const void* table, const void* attend_lens, void* out,
           float* scratch, int S, int H, int Hk, int B, int max_blocks, int n_split,
           cudaStream_t stream) {
  const size_t smem = split_smem<D, GM>();  // at most 26,752 B: no opt-in needed
  const int G = H / Hk, n_hg = (G + GM - 1) / GM;
  float* part_acc = scratch;
  float* part_ml = scratch + (size_t)S * H * n_split * D;
  const int32_t* lens = static_cast<const int32_t*>(attend_lens);
  paged_decode_int8_split<T, D, GM>
      <<<dim3(n_split, Hk * n_hg, S), threads_for(D), smem, stream>>>(
          static_cast<const T*>(q), static_cast<const int8_t*>(pool_k),
          static_cast<const int8_t*>(pool_v), static_cast<const float*>(scale_k),
          static_cast<const float*>(scale_v), static_cast<const int32_t*>(table), lens,
          part_acc, part_ml, H, Hk, B, max_blocks, n_split);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return launch_combine<T>(part_acc, part_ml, lens, static_cast<T*>(out), S, H, D,
                           max_blocks * B, n_split, stream);
}

template <typename T, int D>
int by_group(int G, const void* q, const void* pk, const void* pv, const void* sk,
             const void* sv, const void* table, const void* lens, void* out, float* scratch,
             int S, int H, int Hk, int B, int max_blocks, int n_split, cudaStream_t st) {
  if (G == 1)
    return launch<T, D, 1>(q, pk, pv, sk, sv, table, lens, out, scratch, S, H, Hk, B,
                           max_blocks, n_split, st);
  return launch<T, D, kMaxGroup>(q, pk, pv, sk, sv, table, lens, out, scratch, S, H, Hk, B,
                                 max_blocks, n_split, st);
}

template <typename T>
int by_dim(int D, int G, const void* q, const void* pk, const void* pv, const void* sk,
           const void* sv, const void* table, const void* lens, void* out, float* scratch,
           int S, int H, int Hk, int B, int max_blocks, int n_split, cudaStream_t st) {
  switch (D) {
    case 32:
      return by_group<T, 32>(G, q, pk, pv, sk, sv, table, lens, out, scratch, S, H, Hk, B,
                             max_blocks, n_split, st);
    case 64:
      return by_group<T, 64>(G, q, pk, pv, sk, sv, table, lens, out, scratch, S, H, Hk, B,
                             max_blocks, n_split, st);
    case 128:
      return by_group<T, 128>(G, q, pk, pv, sk, sv, table, lens, out, scratch, S, H, Hk, B,
                              max_blocks, n_split, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q and out share it). Pools must be
// 16-byte aligned (the wrapper checks). scratch: S * H * n_split * (D + 2)
// float32, n_split = ceil(max_blocks * B / 64). Launches the split kernel
// and the combine on `stream`.
int rl_paged_decode_int8(const void* q, const void* pool_k, const void* pool_v,
                         const void* scale_k, const void* scale_v, const void* table,
                         const void* attend_lens, void* out, void* scratch, int S, int H, int Hk,
                         int D, int B, int max_blocks, int n_split, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Hk <= 0 || H % Hk != 0 || B <= 0 ||
      (long long)n_split * kChunk < (long long)max_blocks * B)
    return (int)cudaErrorInvalidValue;
  float* sc = static_cast<float*>(scratch);
  const int G = H / Hk;
  if (dtype == 0)
    return by_dim<float>(D, G, q, pool_k, pool_v, scale_k, scale_v, table, attend_lens, out, sc,
                         S, H, Hk, B, max_blocks, n_split, st);
  if (dtype == 1)
    return by_dim<__nv_bfloat16>(D, G, q, pool_k, pool_v, scale_k, scale_v, table, attend_lens,
                                 out, sc, S, H, Hk, B, max_blocks, n_split, st);
  return (int)cudaErrorInvalidValue;
}

const char* rl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
