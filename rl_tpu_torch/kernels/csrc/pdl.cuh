// Programmatic dependent launch (sm_90): the second kernel of a call is
// launched while the first still runs and waits on the device for the
// first one's results, so that its launch latency, and whatever loads of
// its own do not depend on the first kernel, overlap the first kernel's
// work. Used by the dense decode's combine (flash_decode.cu) and the
// sampler's second pass (fused_sample.cu).

#pragma once

#include <cuda_runtime.h>

namespace pdl {

// In the first kernel: the dependent grid may launch once every block of
// this grid has called this (or exited).
__device__ __forceinline__ void release_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// In the dependent kernel: wait until the first grid has finished and its
// writes are visible.
__device__ __forceinline__ void wait_primary() { asm volatile("griddepcontrol.wait;" ::: "memory"); }

// Launch `kernel` on `stream` as a programmatic dependent of the kernel
// enqueued before it.
template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), dim3 grid, dim3 block,
                             cudaStream_t stream, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
}

}  // namespace pdl
