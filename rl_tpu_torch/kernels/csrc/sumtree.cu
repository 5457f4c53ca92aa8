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
// 0.01 us at 3.35 TB/s. The launch and two dependent loads (idx, then the
// targets it names) set the floor.
//
// No atomics (their order changes from run to run, and stratified
// indices put several updates into one block) and no pre-summing (e +
// (d1 + d2) is not (e + d1) + d2): the first update of each target in
// batch order owns it, folds the target's deltas in batch order and
// writes once. Two routes, chosen by B alone in rl_sumtree_update:
//  - segments (B <= kSegmentCap = 4096), one block of up to 1024 threads,
//    up to 4 updates each. Each update's index becomes two 32-bit
//    targets (the wrapper checks P and NB * fanout < 2^31; the range test
//    runs on the 64-bit index, the division by the fanout in 32 bits) and,
//    per level, a composite key (target << 32) | position in shared
//    memory; each thread also loads its targets' values right away, so
//    that load overlaps what follows. A block-wide test finds whether a
//    level's keys already ascend (the sampler's stratified indices do);
//    only a level that does not is sorted, by a bitonic network in shared
//    memory (positions break ties, so batch order within a target
//    survives). The first key of each run of equal targets is the owner:
//    its thread folds the run's deltas with __fadd_rn, starting from the
//    value its run's first update loaded, and writes once;
//  - scan (B > kSegmentCap), the first design: one thread per update,
//    ceil(B / 256) blocks, each thread scanning the whole batch, staged
//    tile by tile in shared memory, to learn whether an earlier update
//    owns its target and to fold the later ones: O(B^2) compares.
// Distinct owners write distinct addresses in both routes.
//
// Measured by chip_smoke.py on an H100 80GB HBM3 at a 700 W power limit,
// one launch after an L2 flush, at the main shape (1M leaves, fanout 16,
// 256 sorted updates): the segment route 0.0073-0.0074 ms, against two
// index_add_ calls' 0.0090-0.0092 (not order-exact) and the first
// design's 0.0361 (the scan kernel alone, timed in the same run). The
// segment route's sort at B = 4096 (unsorted, duplicates over the whole
// range) takes 0.094 ms; the scan route at B = 6000, 0.58 ms.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kDropped = 0xffffffffu;  // a target the reference's scatter drops
constexpr int kSegmentCap = 4096;           // updates the segment route takes
constexpr int kSegmentThreads = 1024;
constexpr int kScanThreads = 256;

// The leaf and the block that update index t adds to, or kDropped (see
// the header). P and span = NB * fanout are below 2^31.
struct Targets {
  unsigned leaf, blk;
};

__device__ __forceinline__ Targets targets_of(long long t, int P, int NB, int fanout) {
  const long long span = (long long)NB * fanout;
  const long long leaf = t < 0 ? t + P : t;
  Targets r;
  r.leaf = (leaf >= 0 && leaf < P) ? (unsigned)leaf : kDropped;
  // floor(t / fanout) + NB for t < 0 is (t + span) / fanout
  r.blk = (t >= -span && t < span) ? (unsigned)(t < 0 ? t + span : t) / (unsigned)fanout
                                   : kDropped;
  return r;
}

__device__ __forceinline__ unsigned target(unsigned long long key) {
  return (unsigned)(key >> 32);
}

__device__ __forceinline__ unsigned position(unsigned long long key) { return (unsigned)key; }

// Shared memory of the segment route for n2 (a power of two >= B) keys:
// two levels of keys, the deltas, and two levels of loaded values.
__host__ __device__ constexpr size_t segment_smem(int n2) {
  return (size_t)n2 * (2 * sizeof(unsigned long long) + 3 * sizeof(float));
}

// One block of n2 / R threads (n2 a power of two >= B). R updates a thread.
template <int R>
__global__ void __launch_bounds__(kSegmentThreads)
    sumtree_segments(float* __restrict__ priorities, float* __restrict__ esum,
                     const long long* __restrict__ idx, const float* __restrict__ delta, int B,
                     int n2, int P, int NB, int fanout) {
  extern __shared__ unsigned long long keys[];   // [2][n2]: level 0 leaves, 1 blocks
  float* d_s = reinterpret_cast<float*>(keys + 2 * n2);  // [n2] deltas by position
  float* base_s = d_s + n2;                              // [2][n2] values by position
  const int T = blockDim.x, tid = threadIdx.x;
  float* const level[2] = {priorities, esum};

  float base[2][R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = tid + r * T;
    Targets t = {kDropped, kDropped};
    if (i < B) {
      t = targets_of(idx[i], P, NB, fanout);
      d_s[i] = delta[i];
    }
    const unsigned tg[2] = {t.leaf, t.blk};
#pragma unroll
    for (int lv = 0; lv < 2; ++lv) {
      keys[lv * n2 + i] = ((unsigned long long)tg[lv] << 32) | (unsigned)i;
      base[lv][r] = tg[lv] != kDropped ? level[lv][tg[lv]] : 0.f;
    }
  }
  __syncthreads();

  // does each level already come in (target, position) order?
  bool asc[2] = {true, true};
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = tid + r * T;
#pragma unroll
    for (int lv = 0; lv < 2; ++lv)
      if (i + 1 < n2) asc[lv] = asc[lv] && keys[lv * n2 + i] < keys[lv * n2 + i + 1];
  }
  const bool in_order[2] = {__syncthreads_and(asc[0]) != 0, __syncthreads_and(asc[1]) != 0};

  if (!(in_order[0] && in_order[1])) {
    // the values by position, for owners that are not their first update
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int lv = 0; lv < 2; ++lv) base_s[lv * n2 + tid + r * T] = base[lv][r];
    // bitonic sort of each level out of order, ascending
    for (int k = 2; k <= n2; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int pr = tid; pr < n2 / 2; pr += T) {
          const int a = ((pr & ~(j - 1)) << 1) | (pr & (j - 1)), b = a + j;
          const bool up = (a & k) == 0;
#pragma unroll
          for (int lv = 0; lv < 2; ++lv) {
            if (in_order[lv]) continue;
            unsigned long long* kl = keys + lv * n2;
            const unsigned long long x = kl[a], y = kl[b];
            if ((x > y) == up) {
              kl[a] = y;
              kl[b] = x;
            }
          }
        }
        __syncthreads();
      }
    }
  }

  // one owner per run of equal targets: the run's first key
#pragma unroll
  for (int lv = 0; lv < 2; ++lv) {
    const unsigned long long* kl = keys + lv * n2;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int k = tid + r * T;
      if (k >= B) continue;
      const unsigned long long x = kl[k];
      const unsigned tg = target(x);
      if (tg == kDropped || (k > 0 && target(kl[k - 1]) == tg)) continue;
      // in order, key k is this thread's own update k
      float acc = in_order[lv] ? base[lv][r] : base_s[lv * n2 + position(x)];
      for (int j = k; j < B; ++j) {
        const unsigned long long y = kl[j];
        if (target(y) != tg) break;
        acc = __fadd_rn(acc, d_s[position(y)]);
      }
      level[lv][tg] = acc;
    }
  }
}

__global__ void __launch_bounds__(kScanThreads)
    sumtree_scan(float* __restrict__ priorities, float* __restrict__ esum,
                 const long long* __restrict__ idx, const float* __restrict__ delta, int B, int P,
                 int NB, int fanout) {
  __shared__ unsigned s_leaf[kScanThreads];
  __shared__ unsigned s_blk[kScanThreads];
  __shared__ float s_delta[kScanThreads];

  const int i = blockIdx.x * kScanThreads + threadIdx.x;
  Targets own = {kDropped, kDropped};
  if (i < B) own = targets_of(idx[i], P, NB, fanout);
  bool own_leaf = own.leaf != kDropped, own_blk = own.blk != kDropped;
  float acc_leaf = own_leaf ? priorities[own.leaf] : 0.0f;
  float acc_blk = own_blk ? esum[own.blk] : 0.0f;

  for (int base = 0; base < B; base += kScanThreads) {
    const int j = base + threadIdx.x;
    Targets t = {kDropped, kDropped};
    float d = 0.0f;
    if (j < B) {
      t = targets_of(idx[j], P, NB, fanout);
      d = delta[j];
    }
    s_leaf[threadIdx.x] = t.leaf;
    s_blk[threadIdx.x] = t.blk;
    s_delta[threadIdx.x] = d;
    __syncthreads();
    if (own_leaf || own_blk) {
      const int n = min(kScanThreads, B - base);
      for (int k = 0; k < n; ++k) {
        const int jj = base + k;
        if (own_leaf && s_leaf[k] == own.leaf) {
          if (jj < i) own_leaf = false;  // an earlier update owns this leaf
          else acc_leaf = __fadd_rn(acc_leaf, s_delta[k]);
        }
        if (own_blk && s_blk[k] == own.blk) {
          if (jj < i) own_blk = false;
          else acc_blk = __fadd_rn(acc_blk, s_delta[k]);
        }
      }
    }
    __syncthreads();  // the tile is overwritten next
  }
  if (own_leaf) priorities[own.leaf] = acc_leaf;
  if (own_blk) esum[own.blk] = acc_blk;
}

template <int R>
int launch_segments(float* pri, float* esum, const long long* idx, const float* delta, int B,
                    int n2, int P, int NB, int fanout, cudaStream_t st) {
  const size_t smem = segment_smem(n2);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sumtree_segments<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  sumtree_segments<R><<<1, n2 / R, smem, st>>>(pri, esum, idx, delta, B, n2, P, NB, fanout);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The segment route up to kSegmentCap updates, the scan route above. P
// and NB * fanout must be below 2^31 (the wrapper checks).
int rl_sumtree_update(void* priorities, void* esum, const void* idx, const void* delta, int B,
                      int P, int NB, int fanout, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pri = static_cast<float*>(priorities);
  float* es = static_cast<float*>(esum);
  const long long* ix = static_cast<const long long*>(idx);
  const float* d = static_cast<const float*>(delta);
  if (B <= 0 || fanout < 1 || (long long)NB * fanout >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (B > kSegmentCap) {
    sumtree_scan<<<(B + kScanThreads - 1) / kScanThreads, kScanThreads, 0, st>>>(
        pri, es, ix, d, B, P, NB, fanout);
    return (int)cudaGetLastError();
  }
  int n2 = 1;
  while (n2 < B) n2 <<= 1;
  if (n2 <= kSegmentThreads)
    return launch_segments<1>(pri, es, ix, d, B, n2, P, NB, fanout, st);
  if (n2 == 2 * kSegmentThreads)
    return launch_segments<2>(pri, es, ix, d, B, n2, P, NB, fanout, st);
  return launch_segments<4>(pri, es, ix, d, B, n2, P, NB, fanout, st);
}

const char* rl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
