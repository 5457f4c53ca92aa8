// The split plan of the single-token decode, shared by the paged kernels
// over float32/bf16 pools (paged_decode.cu, B4) and over int8 pools
// (paged_decode_int8.cu, B6), and by the dense-cache kernel
// (flash_decode.cu, B3).
//
// Each sequence is cut into kChunk-position splits, one block per (split,
// kv head group, sequence); a block moves its split as kStages tiles of
// kTile positions, all in flight at once. Its lane groups keep an
// online-softmax state (m, l, unnormalised acc) per head in float32
// registers; write_split_state merges them, first the lane groups of a
// warp by shuffles, then the warps through shared memory, and writes the
// split's state to a float32 scratch. A combine kernel then rescales the
// live splits of each (sequence, head) to their common max and sums them
// into out (combine_splits): the paged kernels' combine reads each slot's
// length from the device, the dense kernel's takes one length from the
// host for every row. A split with no visible key leaves m = -inf, l = 0
// and contributes nothing; a row with none at all gets zeros.
//
// Scratch (ops/attention.py paged_decode_plan, flash_decode_plan):
// part_acc [S, H, n_split, D], then part_ml [S, H, n_split, 2]; only the
// splits that start below the sequence's length write.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace paged_split {

constexpr int kChunk = 64;  // positions per split (PAGED_SPLIT_CHUNK in ops/attention.py)
constexpr int kTile = 32;   // positions per cp.async stage
constexpr int kStages = kChunk / kTile;  // every tile of a split in flight at once
static_assert(kStages == 2, "the kernels' wait sequence assumes two stages");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// One 16-byte chunk in shared memory, widened to float32.
template <typename T>
struct Chunk;

template <>
struct Chunk<float> {
  static constexpr int N = 4;
  __device__ static void widen(const float* p, float (&x)[4]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  }
};

template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void widen(const __nv_bfloat16* p, float (&x)[8]) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
};

// Merge the block's lane-group states and write the split's state. Lane
// (grp, c) of a warp holds elements [c * VEC, c * VEC + VEC) of acc for
// the positions of group grp; lanes LPP = D / VEC apart share a chunk.
// red: [kThreads / 32][GM][D + 2] float32 of shared memory. Heads past
// Gb are not written. row0: s * H + the block's first head.
template <int D, int VEC, int GM, int kThreads>
__device__ __forceinline__ void write_split_state(float (&m)[GM], float (&l)[GM],
                                                  float (&acc)[GM][VEC], float* red, int Gb,
                                                  size_t row0, int split, int n_split,
                                                  float* __restrict__ part_acc,
                                                  float* __restrict__ part_ml) {
  constexpr int LPP = D / VEC;
  constexpr int kWarps = kThreads / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane / LPP, c = lane - grp * LPP;

  // the lane groups of the warp
#pragma unroll
  for (int o = LPP; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], o);
      float ao[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) ao[e] = __shfl_xor_sync(0xffffffffu, acc[g][e], o);
      const float mn = fmaxf(m[g], mo);
      if (mn != -INFINITY) {
        const float a = expf(m[g] - mn), b = expf(mo - mn);
        l[g] = l[g] * a + lo * b;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[g][e] = acc[g][e] * a + ao[e] * b;
        m[g] = mn;
      }
    }
  }

  // then the warps, through shared memory
  if (grp == 0) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      float* r = red + (warp * GM + g) * (D + 2);
#pragma unroll
      for (int e = 0; e < VEC; ++e) r[c * VEC + e] = acc[g][e];
      if (c == 0) {
        r[D] = m[g];
        r[D + 1] = l[g];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < Gb * D; i += kThreads) {
    const int g = i / D, d = i - g * D;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, red[(w * GM + g) * (D + 2) + D]);
    float a = 0.f, lsum = 0.f;
    if (M != -INFINITY) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float* r = red + (w * GM + g) * (D + 2);
        const float f = expf(r[D] - M);
        a += f * r[d];
        lsum += f * r[D + 1];
      }
    }
    const size_t idx = (row0 + g) * n_split + split;
    part_acc[idx * D + d] = a;
    if (d == 0) {
      part_ml[2 * idx] = M;
      part_ml[2 * idx + 1] = lsum;
    }
  }
}

// Row `row` (s * H + h) of out: the first n splits' states, rescaled to
// their common max and summed, over their summed l (zeros when no split
// saw a visible key). The D threads of a block each write one element.
template <typename T>
__device__ __forceinline__ void combine_splits(const float* __restrict__ part_acc,
                                               const float* __restrict__ part_ml,
                                               T* __restrict__ out, int row, int D, int n,
                                               int n_split) {
  const float* ml = part_ml + (size_t)row * n_split * 2;
  float M = -INFINITY;
  for (int i = 0; i < n; ++i)
    if (ml[2 * i + 1] > 0.f) M = fmaxf(M, ml[2 * i]);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float num = 0.f, den = 0.f;
    for (int i = 0; i < n; ++i) {
      const float li = ml[2 * i + 1];
      if (li > 0.f) {
        const float w = expf(ml[2 * i] - M);
        num += w * part_acc[((size_t)row * n_split + i) * D + d];
        den += w * li;
      }
    }
    store(&out[(size_t)row * D + d], den > 0.f ? num / den : 0.f);
  }
}

// One block of D threads per (slot, head): the splits that start below
// the slot's length wrote a state.
template <typename T>
__global__ void paged_decode_combine(const float* __restrict__ part_acc,
                                     const float* __restrict__ part_ml,
                                     const int32_t* __restrict__ attend_lens, T* __restrict__ out,
                                     int H, int D, int n_pos, int n_split) {
  const int row = blockIdx.x;  // s * H + h
  const int L = min(attend_lens[row / H], n_pos);
  const int n = L > 0 ? (L + kChunk - 1) / kChunk : 0;  // the splits that wrote a state
  combine_splits(part_acc, part_ml, out, row, D, n, n_split);
}

// Launch the combine on `stream` after a split kernel wrote the scratch.
template <typename T>
int launch_combine(const float* part_acc, const float* part_ml, const int32_t* lens, T* out,
                   int S, int H, int D, int n_pos, int n_split, cudaStream_t stream) {
  paged_decode_combine<T><<<S * H, D, 0, stream>>>(part_acc, part_ml, lens, out, H, D, n_pos,
                                                   n_split);
  return (int)cudaGetLastError();
}

}  // namespace paged_split
