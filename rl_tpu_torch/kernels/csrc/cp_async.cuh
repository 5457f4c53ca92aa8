// cp.async: 16-byte copies from device memory to shared memory that run
// while the issuing thread goes on (sm_80 and later). Used by the paged
// decode (paged_decode.cu) and the bf16 flash kernels (flash_fwd.cu,
// flash_bwd.cu).
//
// A thread's copies become visible to that thread after its
// cp_async_wait<N>(); copies made by other threads need a barrier on top.
// Both addresses must be 16-byte aligned.

#pragma once

#include <cuda_runtime.h>

namespace async_copy {

// Copy 16 bytes, or write 16 zero bytes and read nothing when !valid
// (src may then be any pointer).
__device__ __forceinline__ void cp_async16(void* dst_smem, const void* src, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(dst_smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n)
               : "memory");
}

// Close the group of copies issued since the last commit.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace async_copy
