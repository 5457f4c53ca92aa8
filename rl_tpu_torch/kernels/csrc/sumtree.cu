// Prioritized-replay sum-tree update (kernel B7), written by hand for
// Hopper (sm_90a).
//
// Replaces the TPU kernel rl_tpu/kernels/sumtree.py `sumtree_update`
// (body `_sumtree_update_kernel`).
//
// What it computes, for a batch of B updates (idx [B] int64, delta [B]
// float32) on the two levels of the flat PER tree (priorities [P] and
// esum [NB] float32, NB * fanout >= P), in place:
//   priorities[idx[i]]          += delta[i]
//   esum[idx[i] / fanout]       += delta[i]
// with every target receiving its adds one at a time in batch order:
// ((x + d_i) + d_j) + d_k for i < j < k. That is the order of the
// reference's stock scatter-adds, which its Pallas kernel is bit-exact
// against, and it is what the plain version
// (rl_tpu_torch.kernels.sumtree.sumtree_update_ref) does. Each level
// takes its index as the reference's `.at[...].add` does, on its own: a
// negative leaf index i counts from the end (i + P), the block index is
// floor(i / fanout) and, if negative, counts from the end too (+ NB), and
// a target still outside its array is skipped. So -1 adds to the last leaf
// and the last block, and P <= i < NB * fanout adds to a block only.
//
// Bound on an H100: memory, and at the sizes of the off-policy path
// (B = 256, P = 1,000,000) launch latency. The function must read idx and
// delta (12 bytes an update) and read and write one 32-byte sector for
// each distinct leaf and each distinct block: ~34 KB at B = 256, about
// 0.01 us at 3.35 TB/s. A few microseconds of launch dominate.
//
// What the design does about order: no atomics (their order changes from
// run to run, and stratified indices put several updates into one block)
// and no pre-summing (e + (d1 + d2) is not (e + d1) + d2). Instead the
// first update that targets a leaf (or a block), in batch order, owns it:
// its thread reads the target once, folds acc = acc + delta[j] over every
// j >= i with the same target in increasing j, and writes once. Each
// thread scans the whole batch, staged tile by tile in shared memory, to
// learn whether an earlier update owns its target and to fold the later
// ones: O(B^2) compares, ~65k at B = 256, spread over one thread per
// update and ceil(B / 256) blocks. Distinct owners write distinct
// addresses, so blocks need no order among themselves.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// The leaf and the block that update index t adds to, or -1 where the
// reference's scatter drops it (see the header).
__device__ __forceinline__ long long leaf_of(long long t, long long P) {
  if (t < 0) t += P;
  return (t >= 0 && t < P) ? t : -1;
}

__device__ __forceinline__ long long block_of(long long t, int fanout, long long NB) {
  long long b = t >= 0 ? t / fanout : -((-t + fanout - 1) / fanout);  // floor division
  if (b < 0) b += NB;
  return (b >= 0 && b < NB) ? b : -1;
}

__global__ void sumtree_update_kernel(float* __restrict__ priorities, float* __restrict__ esum,
                                      const long long* __restrict__ idx,
                                      const float* __restrict__ delta, int B, long long P,
                                      long long NB, int fanout) {
  __shared__ long long s_leaf[kThreads];
  __shared__ long long s_blk[kThreads];
  __shared__ float s_delta[kThreads];

  const int i = blockIdx.x * kThreads + threadIdx.x;
  long long leaf = -1, blk = -1;
  if (i < B) {
    leaf = leaf_of(idx[i], P);
    blk = block_of(idx[i], fanout, NB);
  }
  bool own_leaf = leaf >= 0, own_blk = blk >= 0;
  float acc_leaf = own_leaf ? priorities[leaf] : 0.0f;
  float acc_blk = own_blk ? esum[blk] : 0.0f;

  for (int base = 0; base < B; base += kThreads) {
    const int j = base + threadIdx.x;
    long long tl = -1, tb = -1;
    float d = 0.0f;
    if (j < B) {
      tl = leaf_of(idx[j], P);
      tb = block_of(idx[j], fanout, NB);
      d = delta[j];
    }
    s_leaf[threadIdx.x] = tl;
    s_blk[threadIdx.x] = tb;
    s_delta[threadIdx.x] = d;
    __syncthreads();
    if (own_leaf || own_blk) {
      const int n = min(kThreads, B - base);
      for (int k = 0; k < n; ++k) {
        const int jj = base + k;
        if (own_leaf && s_leaf[k] == leaf) {
          if (jj < i) own_leaf = false;  // an earlier update owns this leaf
          else acc_leaf = __fadd_rn(acc_leaf, s_delta[k]);
        }
        if (own_blk && s_blk[k] == blk) {
          if (jj < i) own_blk = false;
          else acc_blk = __fadd_rn(acc_blk, s_delta[k]);
        }
      }
    }
    __syncthreads();  // the tile is overwritten next
  }
  if (own_leaf) priorities[leaf] = acc_leaf;
  if (own_blk) esum[blk] = acc_blk;
}

}  // namespace

extern "C" {

int rl_sumtree_update(void* priorities, void* esum, const void* idx, const void* delta, int B,
                      long long P, long long NB, int fanout, void* stream) {
  const int grid = (B + kThreads - 1) / kThreads;
  sumtree_update_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(priorities), static_cast<float*>(esum),
      static_cast<const long long*>(idx), static_cast<const float*>(delta), B, P, NB, fanout);
  return static_cast<int>(cudaGetLastError());
}

const char* rl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
