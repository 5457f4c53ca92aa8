// Dense-cache single-token decode attention, written by hand for Hopper
// (sm_90a).
//
// Replaces the TPU kernel rl_tpu/ops/attention.py `flash_decode` (body
// `_decode_kernel`).
//
// What it computes: for every batch row b and query head h,
//   o[b,h] = softmax(q[b,h] . K[b]^T) V[b]
// over the cache positions t < cache_len whose kv_mask[b, t] is set (all
// of them without a mask). A row with no such position writes zeros. q
// arrives already multiplied by the softmax scale (in q's dtype, as the
// reference does before its kernel). cache_len is a launch argument: the
// caller keeps it on the host, so nothing is read back from the device.
//
// Layouts (the reference's): q and out [B, H, D]; k and v [B, S, Hk, D];
// kv_mask [B, S] bytes or null. H is a multiple of Hk (GQA: query head h
// reads kv head h / (H / Hk)).
//
// Bound on an H100: memory. The function must read q, write out, read
// the kv_mask bytes below cache_len and read the K and V rows of every
// visible position once:
//   bytes = 2 * B*H*D*esz + B*cache_len + 2 * visible * Hk*D*esz,
// against 4 * H*D flops per visible position (q.k and p.v), about one
// flop per byte for MHA in bf16, far below the card's ~295 flops per byte
// ridge. At the evaluate shape (8 rows, cache_len 768 of which the first
// 480 or so are left padding, 12 kv heads of 64, bf16) that is 2304
// visible positions, ~7.1 MB: ~2.1 us at 3.35 TB/s, the bound
// chip_smoke.py computes from the same inputs.
//
// Design: the split plan of the paged decode (paged_split.cuh), written
// for the dense layout. The first version ran one block per (b, kv head),
// 96 blocks at the evaluate shape, each walking every 64-row tile below
// cache_len in turn through float32 shared memory, masked rows included
// (~18.9 MB there): 0.076 ms, 2.9x SDPA. Now:
//  - grid (B, kv head groups, n_split) with n_split = ceil(cache_len /
//    kChunk), kChunk = 64 positions a split. cache_len is a host int, so
//    the grid holds exactly the splits that have a position below it: no
//    block is launched to exit at once (the paged kernels, whose lengths
//    live on the device, launch splits for the whole table instead), and
//    the combine takes the same n_split for every row;
//  - a lane first reads the kv_mask bytes of the positions it will copy
//    and score. A masked position is never fetched: its 16-byte copies are
//    zero-fills that read nothing, and it scores -inf. A split whose bytes
//    are all 0 (a left pad covers it) fetches no K or V at all: it writes
//    m = -inf, l = 0, which the combine skips (the scratch is not zeroed,
//    and that split's acc is never written or read). Against the plain
//    version this differs only where a masked V row holds a non-finite
//    value: the plain version's 0 * NaN gives NaN, the kernel never reads
//    the row. Cache rows under the mask hold pad tokens' finite K/V;
//  - K/V rows move in their own type as 16-byte cp.async copies into two
//    32-row stages, both in flight before the first is scored. Positions
//    lie Hk * D elements apart; a position's D elements are contiguous.
//    Each lane reads back only its own copies, so the loop has no barrier;
//  - the lanes of a position split D into 16-byte chunks, widen them to
//    float32 at use, and reduce the score by shuffles. No tensor cores: at
//    G = 1 (the evaluate's MHA) each kv head has one query row, a matrix-
//    vector product, where mma.sync tiles would idle 15 of 16 rows;
//  - the score runs in float64 (exact products of float32 factors), so
//    that s - m, not s, rounds to float32 before the exp, as in the int8
//    kernel (paged_decode_int8.cu): at |s| of tens the float32 score's
//    rounding was the larger error against a float64 oracle;
//  - each lane group keeps (m, l, acc) in float32 registers for up to
//    kMaxGroup heads of the GQA group (larger groups are cut into head
//    groups, each reading its K/V rows once); lane groups and warps merge
//    and the splits combine as in the paged kernels (paged_split.cuh),
//    the combine here with one host-side length for every row. It is a
//    programmatic dependent launch (pdl.cuh): it launches while the split
//    kernel runs and waits on the device for its states.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "paged_split.cuh"
#include "pdl.cuh"

namespace {

using namespace async_copy;
using namespace paged_split;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 4;  // query heads one block serves

// Shared memory of one split block, in bytes: the K/V ring in the cache's
// type, the heads' queries and the warps' states for the final merge.
template <typename T, int D, int GM>
constexpr size_t split_smem() {
  return sizeof(T) * kStages * 2 * kTile * D + sizeof(float) * (GM * D + kWarps * GM * (D + 2));
}
static_assert(split_smem<float, 128, kMaxGroup>() <= 232448,
              "the largest split block fits one Hopper block's shared memory");

// Grid (B, Hk * head groups, n_split). Writes, for each of its heads h and
// its split, acc [D] to part_acc[(b*H + h)*n_split + split] and (m, l) to
// part_ml at the same index.
template <typename T, int D, int GM>
__global__ void __launch_bounds__(kThreads) flash_decode_split(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const uint8_t* __restrict__ kv_mask, float* __restrict__ part_acc,
    float* __restrict__ part_ml, int S, int H, int Hk, int cache_len, int n_split) {
  constexpr int VEC = Chunk<T>::N;             // elements per 16-byte chunk
  constexpr int LPP = D / VEC;                 // lanes per position (4 .. 32)
  constexpr int PPW = 32 / LPP;                // positions a warp scores at once
  constexpr int NPG = kTile / (kWarps * PPW);  // positions per lane group per stage
  static_assert(LPP >= 1 && LPP <= 32 && NPG >= 1, "unsupported head dim");

  const int b = blockIdx.x, split = blockIdx.z;
  const int G = H / Hk, n_hg = (G + GM - 1) / GM;
  const int kvh = blockIdx.y / n_hg, g0 = (blockIdx.y - kvh * n_hg) * GM;
  const int Gb = min(GM, G - g0);
  const int p0 = split * kChunk;  // below cache_len: the grid holds no other split
  const int p_end = min(cache_len, p0 + kChunk);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane / LPP, c = lane - grp * LPP;  // position group, chunk in the row
  const size_t row0 = (size_t)b * H + (size_t)kvh * G + g0;  // the block's first head
  pdl::release_dependents();  // the combine may launch and wait for this grid

  // which of the positions this lane copies and scores are visible
  const uint8_t* mask = kv_mask == nullptr ? nullptr : kv_mask + (size_t)b * S;
  bool ok[kStages][NPG];
  bool any = false;
#pragma unroll
  for (int t = 0; t < kStages; ++t)
#pragma unroll
    for (int j = 0; j < NPG; ++j) {
      const int p = p0 + t * kTile + warp * (kTile / kWarps) + j * PPW + grp;
      ok[t][j] = p < p_end && (mask == nullptr || __ldg(&mask[p]) != 0);
      any = any || ok[t][j];
    }
  if (mask != nullptr && !__syncthreads_or(any)) {
    // the mask hides the whole split: no K/V fetched, nothing to add
    if (tid < Gb) {
      const size_t idx = (row0 + tid) * n_split + split;
      part_ml[2 * idx] = -INFINITY;
      part_ml[2 * idx + 1] = 0.f;
    }
    return;
  }

  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);  // [kStages][K, V][kTile][D]
  float* q_s = reinterpret_cast<float*>(ring + kStages * 2 * kTile * D);  // [GM][D]
  float* red = q_s + GM * D;  // [kWarps][GM][D + 2]: acc, m, l

  // every stage's copies first: lane (grp, c) copies chunk c of the rows it
  // will score; a masked position or one past cache_len is zero-filled
  const size_t rstride = (size_t)Hk * D;  // elements between positions
  const size_t head0 = (size_t)b * S * rstride + (size_t)kvh * D + c * VEC;
#pragma unroll
  for (int t = 0; t < kStages; ++t) {
    T* st = ring + t * 2 * kTile * D;
    const bool live = p0 + t * kTile < p_end;
#pragma unroll
    for (int j = 0; j < NPG; ++j) {
      const int pi = warp * (kTile / kWarps) + j * PPW + grp;
      const size_t off = ok[t][j] ? head0 + (size_t)(p0 + t * kTile + pi) * rstride : 0;
      if (live) {
        cp_async16(st + pi * D + c * VEC, k + off, ok[t][j]);
        cp_async16(st + (kTile + pi) * D + c * VEC, v + off, ok[t][j]);
      }
    }
    cp_async_commit();
  }

  // the heads' queries (already scaled); heads past Gb score zeros and
  // are never written
  const size_t qrow = row0 * D;
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
    if (p0 + t * kTile >= p_end) break;  // uniform: the stage holds no position
    const T* st = ring + t * 2 * kTile * D;

    // scores in float64 (four chains of exact products), so that s - m,
    // not s, is what rounds to float32
    double sc[NPG][GM];
#pragma unroll
    for (int j = 0; j < NPG; ++j) {
      const int pi = warp * (kTile / kWarps) + j * PPW + grp;
      float kx[VEC];
      Chunk<T>::widen(st + pi * D + c * VEC, kx);
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        const float4* qv = reinterpret_cast<const float4*>(q_s + g * D + c * VEC);
        double d0 = 0, d1 = 0, d2 = 0, d3 = 0;
#pragma unroll
        for (int e4 = 0; e4 < VEC / 4; ++e4) {
          const float4 qq = qv[e4];
          d0 = fma((double)qq.x, (double)kx[4 * e4], d0);
          d1 = fma((double)qq.y, (double)kx[4 * e4 + 1], d1);
          d2 = fma((double)qq.z, (double)kx[4 * e4 + 2], d2);
          d3 = fma((double)qq.w, (double)kx[4 * e4 + 3], d3);
        }
        double d = (d0 + d1) + (d2 + d3);
#pragma unroll
        for (int o = LPP / 2; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
        sc[j][g] = ok[t][j] ? d : -INFINITY;
      }
    }

#pragma unroll
    for (int g = 0; g < GM; ++g) {
      float mx = (float)sc[0][g];
#pragma unroll
      for (int j = 1; j < NPG; ++j) mx = fmaxf(mx, (float)sc[j][g]);
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
    for (int j = 0; j < NPG; ++j) {
      const int pi = warp * (kTile / kWarps) + j * PPW + grp;
      float vx[VEC];
      Chunk<T>::widen(st + (kTile + pi) * D + c * VEC, vx);
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        const float p = ok[t][j] ? expf((float)(sc[j][g] - (double)m[g])) : 0.f;
        l[g] += p;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[g][e] += p * vx[e];
      }
    }
  }

  write_split_state<D, VEC, GM, kThreads>(m, l, acc, red, Gb, row0, split, n_split, part_acc,
                                          part_ml);
}

// One block of D threads per (b, h): every row's n_split splits wrote a
// state (a hidden split's says l = 0).
template <typename T>
__global__ void flash_decode_combine(const float* __restrict__ part_acc,
                                     const float* __restrict__ part_ml, T* __restrict__ out,
                                     int D, int n_split) {
  pdl::wait_primary();
  combine_splits(part_acc, part_ml, out, blockIdx.x, D, n_split, n_split);
}

template <typename T, int D, int GM>
int launch(const void* q, const void* k, const void* v, const void* kv_mask, void* out,
           float* scratch, int B, int S, int H, int Hk, int cache_len, int n_split,
           cudaStream_t stream) {
  constexpr size_t smem = split_smem<T, D, GM>();
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(flash_decode_split<T, D, GM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int G = H / Hk, n_hg = (G + GM - 1) / GM;
  float* part_acc = scratch;
  float* part_ml = scratch + (size_t)B * H * n_split * D;
  if (n_split > 0) {  // cache_len 0: the combine alone writes zeros
    flash_decode_split<T, D, GM><<<dim3(B, Hk * n_hg, n_split), kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const uint8_t*>(kv_mask), part_acc, part_ml, S, H, Hk, cache_len, n_split);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)pdl::launch_dependent(flash_decode_combine<T>, dim3(B * H), dim3(D), stream,
                                    part_acc, part_ml, static_cast<T*>(out), D, n_split);
}

template <typename T, int D>
int by_group(const void* q, const void* k, const void* v, const void* mask, void* out,
             float* scratch, int B, int S, int H, int Hk, int cache_len, int n_split,
             cudaStream_t st) {
  if (H == Hk)
    return launch<T, D, 1>(q, k, v, mask, out, scratch, B, S, H, Hk, cache_len, n_split, st);
  return launch<T, D, kMaxGroup>(q, k, v, mask, out, scratch, B, S, H, Hk, cache_len, n_split,
                                 st);
}

template <typename T>
int by_dim(int D, const void* q, const void* k, const void* v, const void* mask, void* out,
           float* scratch, int B, int S, int H, int Hk, int cache_len, int n_split,
           cudaStream_t st) {
  switch (D) {
    case 32:
      return by_group<T, 32>(q, k, v, mask, out, scratch, B, S, H, Hk, cache_len, n_split, st);
    case 64:
      return by_group<T, 64>(q, k, v, mask, out, scratch, B, S, H, Hk, cache_len, n_split, st);
    case 128:
      return by_group<T, 128>(q, k, v, mask, out, scratch, B, S, H, Hk, cache_len, n_split, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it); kv_mask
// may be null. k and v must be 16-byte aligned (the wrapper sees to it).
// scratch: B * H * n_split * (D + 2) float32, n_split = ceil(cache_len /
// 64). Launches the split kernel and the combine on `stream`.
int rl_flash_decode(const void* q, const void* k, const void* v, const void* kv_mask, void* out,
                    void* scratch, int B, int S, int H, int Hk, int D, int cache_len, int n_split,
                    int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Hk <= 0 || H % Hk != 0 || cache_len < 0 || cache_len > S ||
      n_split != (cache_len + kChunk - 1) / kChunk)
    return (int)cudaErrorInvalidValue;
  float* sc = static_cast<float*>(scratch);
  if (dtype == 0)
    return by_dim<float>(D, q, k, v, kv_mask, out, sc, B, S, H, Hk, cache_len, n_split, st);
  if (dtype == 1)
    return by_dim<__nv_bfloat16>(D, q, k, v, kv_mask, out, sc, B, S, H, Hk, cache_len, n_split,
                                 st);
  return (int)cudaErrorInvalidValue;
}

const char* rl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
