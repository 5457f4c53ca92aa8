// Shared pieces of the flash-attention kernels (flash_fwd.cu, flash_bwd.cu).
//
// Layouts (the reference's public ones): q, o, dq, do [B, T, H, D];
// k, v, dk, dv [B, T, Hk, D] with H a multiple of Hk (GQA: query head h
// reads kv head h / (H / Hk)); lse and delta [B, H, T] float32; optional
// segment ids qseg, kseg [B, T] int32. A query row and a key attend each
// other when both lie inside T, the key is not in the query's future
// (causal) and, with segment ids, their ids are equal.
//
// Tiles are 64 query rows by 64 keys, staged in shared memory as float32
// with a row stride of D + 1 so that a warp reading one column of 16
// different rows hits 16 different banks. 256 threads: thread (ty, tx) =
// (tid / 16, tid % 16) owns rows ty*4 .. ty*4+3 of a tile and columns
// tx, tx+16, tx+32, tx+48 (keys) or tx, tx+16, ... (head dims), so the
// 16 threads that share a row sit in one half-warp and reduce it with
// shuffles.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace flash {

constexpr int kTile = 64;       // query rows and keys per tile
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;  // the reference's _NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Rows row0 .. row0+63 of head h of a [B, T, Hx, D] tensor into a
// [64][D + 1] float32 tile; rows past T read as zeros.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int b,
                                          int row0, int T_, int Hx, int h) {
  for (int idx = threadIdx.x; idx < kTile * D; idx += kThreads) {
    const int r = idx / D, d = idx - r * D;
    const int t = row0 + r;
    dst[r * (D + 1) + d] =
        t < T_ ? to_f32(src[(((size_t)b * T_ + t) * Hx + h) * D + d]) : 0.f;
  }
}

// Segment ids of rows row0 .. row0+63 (0 past T or without ids).
__device__ __forceinline__ void load_seg(int* dst, const int32_t* __restrict__ seg, int b,
                                         int row0, int T_) {
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const int t = row0 + r;
    dst[r] = (seg != nullptr && t < T_) ? seg[(size_t)b * T_ + t] : 0;
  }
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ bool attends(int qpos, int kpos, int T_, int causal, bool has_seg,
                                        int qs, int ks) {
  return qpos < T_ && kpos < T_ && (!causal || qpos >= kpos) && (!has_seg || qs == ks);
}

// Dynamic shared memory above 48 KB needs the opt-in attribute.
template <typename K>
__host__ cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace flash
