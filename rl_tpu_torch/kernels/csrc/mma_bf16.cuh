// Warp-level bf16 tensor-core pieces (mma.sync.m16n8k16 with float32
// accumulators, ldmatrix) shared by the bf16 flash kernels
// (flash_fwd.cu, flash_bwd.cu).
//
// Fragment layouts of m16n8k16 (row.col): lane l holds rows l / 4 and
// l / 4 + 8, columns 2 (l % 4) and 2 (l % 4) + 1 of an accumulator tile,
// so an accumulator pair of two n-tiles is an A fragment of the next
// product with no trip through shared memory (split_pair).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma_bf16 {

using bf16 = __nv_bfloat16;

// The 32-bit shared-space address of p, as ldmatrix takes it.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8 and receives row l / 4, columns 2 (l % 4) and
// 2 (l % 4) + 1 of each (of each transposed, for ldsm_x4_t). Either a
// pointer or a shared-space byte address.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], unsigned a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], unsigned a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  ldsm_x4(r, smem_addr(p));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  ldsm_x4_t(r, smem_addr(p));
}

// c += a (16x16, row) * b (16x8, col), float32 accumulators.
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// The pair (x0, x1) as bf16 hi and lo parts, x0 in the low half of each.
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x0 - __low2float(h), x1 - __high2float(h)));
}

}  // namespace mma_bf16
