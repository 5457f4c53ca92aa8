// Flash-attention backward (FlashAttention-2 recompute scheme), written by
// hand for Hopper (sm_90a): two kernels.
//
// Replaces the TPU kernels of rl_tpu/ops/attention.py `_flash_bwd_bhtd`:
// `_bwd_dq_kernel` (dQ, walking K/V) and `_bwd_dkv_kernel` (dK and dV,
// walking Q), reached from the custom VJP of `flash_attention`.
//
// What they compute, with P rebuilt from the forward's saved lse and
// delta = sum_d do * o computed by the wrapper:
//   p[t, u]  = attended(t, u) ? exp(scale * q_t . k_u - lse_t) : 0
//   ds[t, u] = p[t, u] * (do_t . v_u - delta_t) * scale
//   dq_t = sum_u ds[t, u] k_u
//   dk_u = sum_(t, h in u's group) ds[t, u] q_t,   dv_u = sum_(t, h) p[t, u] do_t
// The mask is applied with a select, never left to underflow: a pad query
// with no attended key has lse = -1e30, and exp(s - lse) would be 1 there.
//
// Bound on an H100, at the training shape [8, 1024, 12, 64] bf16 causal:
// bytes. The dQ kernel does 3 products per attended pair (QK^T, dO V^T,
// dS K), the dK/dV kernel 4 (QK^T, dO V^T, P^T dO, dS^T Q); with the main
// shape's left pads (30.7 M attended pairs) that is 12 and 16 us at 989
// TFLOP/s, against 63.7 MB (q, do, k, v, lse, delta, dq; 19.0 us at 3.35
// TB/s) and 76 MB (22.8 us). Padded keys lower the operations, not the
// bytes.
//
// Hopper blocks run in parallel and carry nothing between them, so
// instead of the TPU's sequential grid with VMEM accumulators each block
// owns its output tile and loops inside:
//  - dQ: one block per (64-row query tile, b, h) walks the key tiles the
//    mask needs, causal blocks issued longest first;
//  - dK/dV: one block per (64-key tile, b, kv head) walks every query head
//    of its GQA group and the query tiles at or below the diagonal. The
//    group sum happens inside the block, in a fixed order, with no
//    atomics: the result is deterministic and no per-query-head dK/dV
//    ever reaches device memory.
//
// Two bodies, chosen by dtype:
//
// float32 (flash_bwd_dq_kernel, flash_bwd_dkv_kernel; the first version,
// kept for the float32 training check): float32 FMA 4x4 register tiles on
// float32 shared-memory tiles (flash_common.cuh), P and dS through shared
// memory, no copy pipelining.
//
// bfloat16 (flash_bwd_dq_bf16_kernel, flash_bwd_dkv_bf16_kernel; FA2's
// backward on mma.sync.m16n8k16, flash_fwd.cu's machinery from
// mma_bf16.cuh and cp_async.cuh): four warps, each owning 16 rows of the
// block's tile.
//  - dQ: Q and dO load once into shared memory. K and V stream through a
//    cp.async ring of two 64-row stages, rows padded by 16 bytes so that
//    ldmatrix is free of bank conflicts. S = Q K^T and dP = dO V^T
//    accumulate in float32 registers, 32 keys at a time; dS is made there
//    and enters dQ += dS K as A fragments straight from those registers,
//    K read with ldmatrix.trans.
//  - dK/dV: K and V load once, Q and dO (with lse and delta beside them)
//    stream through the ring over (group member, query tile). S^T = K Q^T
//    and dP^T = V dO^T accumulate in float32, 16 queries at a time; P^T
//    and dS^T enter dV += P^T dO and dK += dS^T Q as A fragments from the
//    accumulators, dO and Q read with ldmatrix.trans. dK and dV stay
//    float32 registers until one bf16 store.
//  - Per element: P = 2^(s scale log2(e) - lse log2(e)), one FFMA and
//    one ex2; dS = P (dP - delta), the softmax scale applied once to dQ
//    and dK at their stores. Each step's body is compiled twice, with the
//    masks and without: a tile that attends wholly (most of them) runs
//    straight-line code with no branch or select, which the compiler
//    schedules far better (PERF.md §6: 24% off dQ). Fragments are
//    addressed by 32-bit shared-space addresses.
//  - Registers: the A fragments of the loaded-once tiles are read from
//    shared memory at each use, and S is made in chunks, so that no
//    instantiation spills. dK/dV needs 186 at D = 64 (two blocks an SM);
//    a cap of 168 (three) spills and was not taken. At D = 128 dK/dV
//    keeps only the masked body: its accumulators alone take 128.
//  - Rounding points: P (into dV) and dS (into dK and dQ) each enter as
//    two bf16 parts, hi = bf16(x) and lo = bf16(x - hi), both multiplied
//    into the same float32 accumulator. One bf16 rounding carries ~1e-3
//    relative error per term; dS has both signs and dK, dQ sum it with
//    cancellation, so near 0 that exceeds the unchanged gate of
//    chip_smoke.py (one bf16 step of |x| + 1e-3 rms(x)). The CPU model
//    (tests/test_torch_flash_bwd_bf16.py) shows one rounding of P
//    breaking it in dV and one of dS in dQ and dK, and hi + lo (~2^-16)
//    holding it. This doubles the three gradient products.
//  - Skipped tiles, flash_fwd.cu's rule: before its loop a block
//    classifies the tiles it walks from the segment ids against the
//    [min, max] ids of its own tile: 0 when no row of the tile has an id
//    inside that range, 2 when every row is inside T with the block's one
//    id, else 1. Class 0 tiles and tiles above the causal diagonal are
//    neither loaded nor computed; masks are evaluated per element only on
//    class-1 tiles and on the diagonal. The test is conservative: it
//    never drops a tile in which a pair attends. dQ: a query tile of pad
//    rows under a left-padded kv_mask finds every key tile class 0 and
//    writes zeros; dK/dV: a left-pad key tile finds every query tile
//    class 0 and writes zeros.
// Measured by chip_smoke.py on an H100 80GB HBM3 at a 700 W power limit,
// one launch after an L2 flush, at the training shape [8, 1024, 12, 64]
// bf16 causal with left pads of up to 511 keys: dQ 0.102 ms and dK/dV
// 0.175 ms, against 1.00 and 1.27 ms for the float32 FMA bodies on bf16
// inputs (the first version); the whole backward, the wrapper's delta
// pre-pass included, 0.348 ms against 0.301 ms for SDPA's (cuDNN)
// backward; bounds 0.019 and 0.023 ms (bytes). What holds it back:
// PERF.md §6.

#include <climits>
#include <type_traits>

#include "cp_async.cuh"
#include "flash_common.cuh"
#include "mma_bf16.cuh"

namespace {

using namespace flash;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const int32_t* __restrict__ qseg,
    const int32_t* __restrict__ kseg, T* __restrict__ dq, int T_, int H, int Hk, int causal,
    float scale) {
  constexpr int LD = D + 1, NJ = D / 16;
  extern __shared__ float smem[];
  float* q_s = smem;                // [64][LD]
  float* do_s = q_s + kTile * LD;   // [64][LD]
  float* k_s = do_s + kTile * LD;   // [64][LD]
  float* v_s = k_s + kTile * LD;    // [64][LD]
  float* ds_s = v_s + kTile * LD;   // [64][65]
  int* qseg_s = reinterpret_cast<int*>(ds_s + kTile * (kTile + 1));
  int* kseg_s = qseg_s + kTile;

  const int nq = (T_ + kTile - 1) / kTile;
  const int qt = causal ? nq - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int b = blockIdx.y / H, h = blockIdx.y - b * H;
  const int hk = h / (H / Hk);
  const int q0 = qt * kTile;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const bool has_seg = kseg != nullptr;

  load_tile<T, D>(q_s, q, b, q0, T_, H, h);
  load_tile<T, D>(do_s, dout, b, q0, T_, H, h);
  load_seg(qseg_s, qseg, b, q0, T_);
  __syncthreads();
  int qpos[4], qsg[4];
  float lse_r[4], delta_r[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    qpos[i] = q0 + ty * 4 + i;
    qsg[i] = qseg_s[ty * 4 + i];
    const bool in = qpos[i] < T_;
    const size_t row = ((size_t)b * H + h) * T_ + qpos[i];
    lse_r[i] = in ? lse[row] : 0.f;
    delta_r[i] = in ? delta[row] : 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  int nk = (T_ + kTile - 1) / kTile;
  if (causal) nk = min(nk, qt + 1);
  for (int jt = 0; jt < nk; ++jt) {
    const int k0 = jt * kTile;
    __syncthreads();
    load_tile<T, D>(k_s, k, b, k0, T_, Hk, hk);
    load_tile<T, D>(v_s, v, b, k0, T_, Hk, hk);
    load_seg(kseg_s, kseg, b, k0, T_);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], gv[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = q_s[(ty * 4 + i) * LD + d];
        gv[i] = do_s[(ty * 4 + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = k_s[(tx + 16 * j) * LD + d];
        vv[j] = v_s[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] += qv[i] * kv[j];
          dp[i][j] += gv[i] * vv[j];
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const bool ok = attends(qpos[i], k0 + c, T_, causal, has_seg, qsg[i], kseg_s[c]);
        const float p = ok ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        ds_s[(ty * 4 + i) * (kTile + 1) + c] = p * (dp[i][j] - delta_r[i]) * scale;
      }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float dv4[4], kv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) dv4[i] = ds_s[(ty * 4 + i) * (kTile + 1) + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) kv[j] = k_s[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] += dv4[i] * kv[j];
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (qpos[i] >= T_) continue;
    T* row = dq + (((size_t)b * T_ + qpos[i]) * H + h) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) store(&row[tx + 16 * j], acc[i][j]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const int32_t* __restrict__ qseg,
    const int32_t* __restrict__ kseg, T* __restrict__ dk, T* __restrict__ dv, int T_, int H,
    int Hk, int causal, float scale) {
  constexpr int LD = D + 1, NJ = D / 16, LP = kTile + 1;
  extern __shared__ float smem[];
  float* k_s = smem;                 // [64][LD]
  float* v_s = k_s + kTile * LD;     // [64][LD]
  float* q_s = v_s + kTile * LD;     // [64][LD]
  float* do_s = q_s + kTile * LD;    // [64][LD]
  float* pt_s = do_s + kTile * LD;   // [64 keys][65] P^T
  float* dst_s = pt_s + kTile * LP;  // [64 keys][65] dS^T
  float* lse_s = dst_s + kTile * LP; // [64]
  float* delta_s = lse_s + kTile;    // [64]
  int* qseg_s = reinterpret_cast<int*>(delta_s + kTile);
  int* kseg_s = qseg_s + kTile;

  const int nq = (T_ + kTile - 1) / kTile;
  const int kt = blockIdx.x;
  const int b = blockIdx.y / Hk, hk = blockIdx.y - b * Hk;
  const int G = H / Hk;
  const int k0 = kt * kTile;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const bool has_seg = kseg != nullptr;

  load_tile<T, D>(k_s, k, b, k0, T_, Hk, hk);
  load_tile<T, D>(v_s, v, b, k0, T_, Hk, hk);
  load_seg(kseg_s, kseg, b, k0, T_);
  __syncthreads();
  int kpos[4], ksg[4];
  float dk_acc[4][NJ], dv_acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    kpos[i] = k0 + ty * 4 + i;
    ksg[i] = kseg_s[ty * 4 + i];
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;
  }

  // query tiles at or below the diagonal (tile size is shared)
  const int i0 = causal ? kt : 0;
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    for (int it = i0; it < nq; ++it) {
      const int q0 = it * kTile;
      __syncthreads();
      load_tile<T, D>(q_s, q, b, q0, T_, H, h);
      load_tile<T, D>(do_s, dout, b, q0, T_, H, h);
      load_seg(qseg_s, qseg, b, q0, T_);
      for (int r = tid; r < kTile; r += kThreads) {
        const int t = q0 + r;
        const size_t row = ((size_t)b * H + h) * T_ + t;
        lse_s[r] = t < T_ ? lse[row] : 0.f;
        delta_s[r] = t < T_ ? delta[row] : 0.f;
      }
      __syncthreads();

      // this thread: keys ty*4+i, queries tx+16j (S^T and dP^T tiles)
      float st[4][4], dpt[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kv[4], vv[4], qv[4], gv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = k_s[(ty * 4 + i) * LD + d];
          vv[i] = v_s[(ty * 4 + i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qv[j] = q_s[(tx + 16 * j) * LD + d];
          gv[j] = do_s[(tx + 16 * j) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            st[i][j] += kv[i] * qv[j];
            dpt[i][j] += vv[i] * gv[j];
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = tx + 16 * j;
          const bool ok = attends(q0 + r, kpos[i], T_, causal, has_seg, qseg_s[r], ksg[i]);
          const float p = ok ? expf(st[i][j] * scale - lse_s[r]) : 0.f;
          pt_s[(ty * 4 + i) * LP + r] = p;
          dst_s[(ty * 4 + i) * LP + r] = p * (dpt[i][j] - delta_s[r]) * scale;
        }
      __syncthreads();

#pragma unroll 4
      for (int r = 0; r < kTile; ++r) {
        float pv[4], dsv[4], gv[NJ], qv[NJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = pt_s[(ty * 4 + i) * LP + r];
          dsv[i] = dst_s[(ty * 4 + i) * LP + r];
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          gv[j] = do_s[r * LD + tx + 16 * j];
          qv[j] = q_s[r * LD + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            dv_acc[i][j] += pv[i] * gv[j];
            dk_acc[i][j] += dsv[i] * qv[j];
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (kpos[i] >= T_) continue;
    const size_t row = (((size_t)b * T_ + kpos[i]) * Hk + hk) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      store(&dk[row + tx + 16 * j], dk_acc[i][j]);
      store(&dv[row + tx + 16 * j], dv_acc[i][j]);
    }
  }
}


// -- bfloat16: tensor cores (mma.sync.m16n8k16) --------------------------------

using namespace mma_bf16;
using async_copy::cp_async16;
using async_copy::cp_async_commit;
using async_copy::cp_async_wait;

constexpr int kBT = 64;           // rows of every tile (queries or keys)
constexpr int kMmaThreads = 128;  // four warps of 16 rows
constexpr unsigned kFull = 0xffffffffu;

// Dynamic shared memory of either bf16 kernel: two 64-row tiles loaded
// once and a ring of two stages of two 64-row tiles (bf16, rows of D + 8);
// per stage three 64-word rows (dK/dV: the query tile's lse, delta and
// segment ids; dQ: the key tile's segment ids); one class per tile and
// two ints.
template <int D>
constexpr size_t bwd_bf16_smem(int T_) {
  return sizeof(bf16) * 6 * kBT * (D + 8) + sizeof(float) * 6 * kBT +
         sizeof(int) * ((T_ + kBT - 1) / kBT + 2);
}

// Classes of tiles 0 .. n-1 of the segment-id row `tile_seg` of batch row
// b against the [min, max] ids of the block's own rows r0 .. r0 + 63 in
// `own_seg` (see the header): tiles below j0 get 0. No ids: 2 for tiles
// wholly inside T, 1 for the ragged last. Ends synced.
__device__ __forceinline__ void classify_tiles(int* cls_s, int* range_s,
                                               const int32_t* __restrict__ own_seg,
                                               const int32_t* __restrict__ tile_seg, int b,
                                               int r0, int j0, int n, int T_) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool has_seg = own_seg != nullptr;
  if (tid == 0) {
    range_s[0] = INT_MAX;
    range_s[1] = INT_MIN;
  }
  __syncthreads();
  if (has_seg && tid < kBT && r0 + tid < T_) {
    const int sg = own_seg[(size_t)b * T_ + r0 + tid];
    atomicMin(&range_s[0], sg);
    atomicMax(&range_s[1], sg);
  }
  __syncthreads();
  const int lo = range_s[0], hi = range_s[1];
  for (int j = warp; j < n; j += kMmaThreads / 32) {
    bool any = false, all = true;
#pragma unroll
    for (int i = 0; i < kBT / 32; ++i) {
      const int u = j * kBT + i * 32 + lane;
      const bool in = u < T_;
      const int sg = (has_seg && in) ? tile_seg[(size_t)b * T_ + u] : 0;
      any |= in && (!has_seg || (sg >= lo && sg <= hi));
      all &= in && (!has_seg || (lo == hi && sg == lo));
    }
    any = __any_sync(kFull, any);
    all = __all_sync(kFull, all);
    if (lane == 0) cls_s[j] = j < j0 ? 0 : any ? (all ? 2 : 1) : 0;
  }
  __syncthreads();
}

// Rows row0 .. row0 + 63 of head hx of a [B, T, Hx, D] bf16 tensor into a
// [64][D + 8] tile by 16-byte cp.async copies; rows past T are zeros.
template <int D>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* __restrict__ src, int b,
                                          int row0, int T_, int Hx, int hx) {
  constexpr int LDS = D + 8, CPR = D / 8;
  for (int i = threadIdx.x; i < kBT * CPR; i += kMmaThreads) {
    const int r = i / CPR, cc = i - r * CPR, t = row0 + r;
    cp_async16(dst + r * LDS + cc * 8,
               src + (((size_t)b * T_ + min(t, T_ - 1)) * Hx + hx) * D + cc * 8, t < T_);
  }
}

// Fragments of a [rows][D + 8] bf16 tile at shared-space byte address
// `tile` (32-bit addresses keep the loops' registers and arithmetic low).
// The element (row, col) lies at tile + 2 (row (D + 8) + col).
template <int D>
__device__ __forceinline__ unsigned at(unsigned tile, int row, int col) {
  return tile + 2u * (row * (D + 8) + col);
}

// The A fragment of rows 16 w .. 16 w + 15, columns 16 kk .. 16 kk + 15
// (w: this warp).
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], unsigned tile, int kk) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  ldsm_x4(a, at<D>(tile, warp * 16 + (lane & 15), kk * 16 + (lane >> 4) * 8));
}

// B fragments of n-tiles 2 jn and 2 jn + 1 (rows 16 jn .. 16 jn + 15 as the
// n dimension), k-step kk: for X Y^T with Y's rows in the tile.
template <int D>
__device__ __forceinline__ void load_b(uint32_t (&r)[4], unsigned tile, int jn, int kk) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(r, at<D>(tile, jn * 16 + (lane >> 4) * 8 + (lane & 7), kk * 16 + ((lane >> 3) & 1) * 8));
}

// B fragments of d-tiles 2 dn and 2 dn + 1, k-step kk over the tile's
// rows: for P Y with Y's rows in the tile (ldmatrix.trans).
template <int D>
__device__ __forceinline__ void load_b_t(uint32_t (&r)[4], unsigned tile, int kk, int dn) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_t(r, at<D>(tile, kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7), dn * 16 + (lane >> 4) * 8));
}

// acc += X Y over k-steps kk = 0 .. KS-1: X's k-step kk is the float32
// accumulator pair x[2 kk], x[2 kk + 1] (16 rows x 16 k), entering as bf16
// hi + lo A fragments; Y's is rows 16 kk .. 16 kk + 15 of the tile, by
// ldmatrix.trans.
template <int D, int KS>
__device__ __forceinline__ void accumulate_split(float (&acc)[D / 8][4], const float (&x)[2 * KS][4],
                                                 unsigned tile) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t xh[4], xl[4];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int j = 2 * kk + half;
      split_pair(x[j][0], x[j][1], xh[2 * half], xl[2 * half]);
      split_pair(x[j][2], x[j][3], xh[2 * half + 1], xl[2 * half + 1]);
    }
#pragma unroll
    for (int dn = 0; dn < D / 16; ++dn) {
      uint32_t yb[4];
      load_b_t<D>(yb, tile, kk, dn);
      mma16816(acc[2 * dn], xh, yb[0], yb[1]);
      mma16816(acc[2 * dn], xl, yb[0], yb[1]);
      mma16816(acc[2 * dn + 1], xh, yb[2], yb[3]);
      mma16816(acc[2 * dn + 1], xl, yb[2], yb[3]);
    }
  }
}

// 2^x (MUFU ex2; x = -inf gives 0). The kernels take P = 2^(s scale log2 e
// - lse log2 e): one FFMA and one ex2 per element.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f;

// The float32 pair (x0, x1) as one bf16x2 store.
__device__ __forceinline__ void store_pair(bf16* p, float x0, float x1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads) flash_bwd_dq_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const int32_t* __restrict__ qseg,
    const int32_t* __restrict__ kseg, bf16* __restrict__ dq, int T_, int H, int Hk, int causal,
    float scale) {
  constexpr int LDS = D + 8;
  constexpr int KD = D / 16;     // k-steps of Q K^T
  constexpr int ND = D / 8;      // n-tiles of dQ
  constexpr int KC = kBT / 2;    // keys of S at a time
  constexpr int NN = KC / 8;     // n-tiles of S
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [64][LDS]
  bf16* do_s = q_s + kBT * LDS;                    // [64][LDS]
  bf16* k_s = do_s + kBT * LDS;                    // [2][64][LDS]
  bf16* v_s = k_s + 2 * kBT * LDS;                 // [2][64][LDS]
  int* kseg_s = reinterpret_cast<int*>(v_s + 2 * kBT * LDS);  // [2][64] key tile ids
  int* cls_s = kseg_s + 6 * kBT;
  const int nkt = (T_ + kBT - 1) / kBT;
  int* range_s = cls_s + nkt;

  const int qt = causal ? nkt - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int b = blockIdx.y / H, h = blockIdx.y - b * H;
  const int hk = h / (H / Hk);
  const int q0 = qt * kBT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool has_seg = kseg != nullptr;
  const int nk = causal ? min(nkt, qt + 1) : nkt;

  load_rows<D>(q_s, q, b, q0, T_, H, h);
  load_rows<D>(do_s, dout, b, q0, T_, H, h);
  cp_async_commit();
  classify_tiles(cls_s, range_s, qseg, kseg, b, q0, 0, nk, T_);

  auto next_live = [&](int j) {
    while (j < nk && cls_s[j] == 0) ++j;
    return j;
  };
  auto load_kv = [&](int jt, int stage) {
    load_rows<D>(k_s + stage * kBT * LDS, k, b, jt * kBT, T_, Hk, hk);
    load_rows<D>(v_s + stage * kBT * LDS, v, b, jt * kBT, T_, Hk, hk);
    if (has_seg)
      for (int r = tid; r < kBT; r += kMmaThreads) {
        const int u = jt * kBT + r;
        kseg_s[stage * kBT + r] = u < T_ ? kseg[(size_t)b * T_ + u] : 0;
      }
  };

  int cur = next_live(0);
  if (cur < nk) load_kv(cur, 0);
  cp_async_commit();
  cp_async_wait<1>();  // Q and dO
  __syncthreads();

  // lane holds rows r0 and r0 + 8, columns 2 tq + {0, 1} of each n-tile;
  // lse in base 2; rows past T get lse = +inf, so p = 0 there. dS enters
  // the product unscaled and dQ is scaled once at its store.
  const int r0 = q0 + warp * 16 + (lane >> 2), tq = lane & 3;
  const float scale2 = scale * kLog2e;
  float lse_r[2], delta_r[2];
  int qs_r[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int t = r0 + 8 * hf;
    const size_t row = ((size_t)b * H + h) * T_ + t;
    lse_r[hf] = t < T_ ? lse[row] * kLog2e : INFINITY;
    delta_r[hf] = t < T_ ? delta[row] : 0.f;
    qs_r[hf] = (has_seg && t < T_) ? qseg[(size_t)b * T_ + t] : 0;
  }
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  int stage = 0;
  while (cur < nk) {
    const int nxt = next_live(cur + 1);
    if (nxt < nk) load_kv(nxt, stage ^ 1);  // its readers finished before the last barrier
    cp_async_commit();
    cp_async_wait<1>();  // this tile's copies, for this thread
    __syncthreads();     // ... and for every thread
    const unsigned ks = smem_addr(k_s + stage * kBT * LDS);
    const unsigned vs = smem_addr(v_s + stage * kBT * LDS);
    const int k0 = cur * kBT;
    // per-element masks: the causal test on the diagonal tile, the ids and
    // T only on class-1 tiles (a class-2 tile attends wholly)
    const bool diag = causal && k0 + kBT - 1 > q0;
    const bool ids = cls_s[cur] == 1;
    const int* ksg = kseg_s + stage * kBT;
    // the step's body twice, with and without the masks, so that a tile
    // that attends wholly runs code with no branch or select in it
    auto step = [&](auto with_masks) {
      constexpr bool kMask = decltype(with_masks)::value;
#pragma unroll
    for (int c0 = 0; c0 < kBT; c0 += KC) {
      // S = Q K^T and dP = dO V^T over keys c0 .. c0 + KC - 1
      float s[NN][4], dp[NN][4];
#pragma unroll
      for (int j = 0; j < NN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t aq[4], ad[4];
        load_a<D>(aq, smem_addr(q_s), kk);
        load_a<D>(ad, smem_addr(do_s), kk);
#pragma unroll
        for (int jn = 0; jn < NN / 2; ++jn) {
          uint32_t kb[4], vb[4];
          load_b<D>(kb, ks + 2 * c0 * LDS, jn, kk);
          load_b<D>(vb, vs + 2 * c0 * LDS, jn, kk);
          mma16816(s[2 * jn], aq, kb[0], kb[1]);
          mma16816(s[2 * jn + 1], aq, kb[2], kb[3]);
          mma16816(dp[2 * jn], ad, vb[0], vb[1]);
          mma16816(dp[2 * jn + 1], ad, vb[2], vb[3]);
        }
      }

      // dS = P (dP - delta) scale into s; P = 0 where a pair does not attend
#pragma unroll
      for (int j = 0; j < NN; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hf = e >> 1;
          const int c = c0 + 8 * j + 2 * tq + (e & 1);  // key within the tile
          bool ok = true;
          if constexpr (kMask)
            ok = (!diag | (r0 + 8 * hf >= k0 + c)) &
                 (!ids | ((k0 + c < T_) & (!has_seg | (qs_r[hf] == ksg[c]))));
          const float p = ok ? exp2_approx(s[j][e] * scale2 - lse_r[hf]) : 0.f;
          s[j][e] = p * (dp[j][e] - delta_r[hf]);
        }
      }
      // dQ += dS K (dS as bf16 hi + lo, K by ldmatrix.trans)
      accumulate_split<D, KC / 16>(acc, s, ks + 2 * c0 * LDS);
    }
    };
    if (diag || ids)
      step(std::true_type{});
    else
      step(std::false_type{});
    __syncthreads();  // every warp is done with this stage before it is refilled
    stage ^= 1;
    cur = nxt;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int t = r0 + 8 * hf;
    if (t >= T_) continue;
    bf16* row = dq + (((size_t)b * T_ + t) * H + h) * D + 2 * tq;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      store_pair(row + 8 * j, acc[j][2 * hf] * scale, acc[j][2 * hf + 1] * scale);
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads) flash_bwd_dkv_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const int32_t* __restrict__ qseg,
    const int32_t* __restrict__ kseg, bf16* __restrict__ dk, bf16* __restrict__ dv, int T_,
    int H, int Hk, int causal, float scale) {
  constexpr int LDS = D + 8;
  constexpr int KD = D / 16;     // k-steps of K Q^T
  constexpr int ND = D / 8;      // n-tiles of dK, dV
  constexpr int QC = kBT / 4;    // queries of S^T at a time
  constexpr int NQ = QC / 8;     // n-tiles of S^T
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);  // [64][LDS]
  bf16* v_s = k_s + kBT * LDS;                     // [64][LDS]
  bf16* q_s = v_s + kBT * LDS;                     // [2][64][LDS]
  bf16* do_s = q_s + 2 * kBT * LDS;                // [2][64][LDS]
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * kBT * LDS);  // [2][64]
  float* delta_s = lse_s + 2 * kBT;                                // [2][64]
  int* qseg_s = reinterpret_cast<int*>(delta_s + 2 * kBT);         // [2][64]
  int* cls_s = qseg_s + 2 * kBT;                                   // [nq] query-tile classes
  const int nq = (T_ + kBT - 1) / kBT;
  int* range_s = cls_s + nq;

  const int kt = blockIdx.x;
  const int b = blockIdx.y / Hk, hk = blockIdx.y - b * Hk;
  const int G = H / Hk;
  const int k0 = kt * kBT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool has_seg = kseg != nullptr;
  const int i0 = causal ? kt : 0;  // query tiles at or below the diagonal

  load_rows<D>(k_s, k, b, k0, T_, Hk, hk);
  load_rows<D>(v_s, v, b, k0, T_, Hk, hk);
  cp_async_commit();
  classify_tiles(cls_s, range_s, kseg, qseg, b, k0, i0, nq, T_);

  // steps g * nq + it over (group member, query tile), the live ones only
  const int steps = G * nq;
  auto next_live = [&](int st) {
    while (st < steps && cls_s[st % nq] == 0) ++st;
    return st;
  };
  auto load_q = [&](int st, int stage) {
    const int g = st / nq, it = st - g * nq, h = hk * G + g, q0 = it * kBT;
    load_rows<D>(q_s + stage * kBT * LDS, q, b, q0, T_, H, h);
    load_rows<D>(do_s + stage * kBT * LDS, dout, b, q0, T_, H, h);
    for (int r = tid; r < kBT; r += kMmaThreads) {  // rows past T: lse = +inf, p = 0
      const int t = q0 + r;
      const size_t row = ((size_t)b * H + h) * T_ + t;
      lse_s[stage * kBT + r] = t < T_ ? lse[row] * kLog2e : INFINITY;  // base 2
      delta_s[stage * kBT + r] = t < T_ ? delta[row] : 0.f;
      qseg_s[stage * kBT + r] = (has_seg && t < T_) ? qseg[(size_t)b * T_ + t] : 0;
    }
  };

  int cur = next_live(0);
  if (cur < steps) load_q(cur, 0);
  cp_async_commit();
  cp_async_wait<1>();  // K and V
  __syncthreads();

  // lane holds key rows r0 and r0 + 8, query columns 2 tq + {0, 1} of
  // each n-tile
  const int r0 = k0 + warp * 16 + (lane >> 2), tq = lane & 3;
  const float scale2 = scale * kLog2e;
  int ks_r[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int u = r0 + 8 * hf;
    ks_r[hf] = (has_seg && u < T_) ? kseg[(size_t)b * T_ + u] : 0;
  }
  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  int stage = 0;
  while (cur < steps) {
    const int nxt = next_live(cur + 1);
    if (nxt < steps) load_q(nxt, stage ^ 1);  // its readers finished before the last barrier
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int it = cur % nq, q0 = it * kBT;
    const unsigned qs = smem_addr(q_s + stage * kBT * LDS);
    const unsigned dos = smem_addr(do_s + stage * kBT * LDS);
    const float* lses = lse_s + stage * kBT;
    const float* dls = delta_s + stage * kBT;
    const int* qsg = qseg_s + stage * kBT;
    const bool diag = causal && it == kt;  // as in the dQ kernel
    const bool ids = cls_s[it] == 1;
    auto step = [&](auto with_masks) {  // as in the dQ kernel
      constexpr bool kMask = decltype(with_masks)::value;
#pragma unroll
    for (int c0 = 0; c0 < kBT; c0 += QC) {
      // S^T = K Q^T and dP^T = V dO^T over queries c0 .. c0 + QC - 1
      float st[NQ][4], dpt[NQ][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t ak[4], av[4];
        load_a<D>(ak, smem_addr(k_s), kk);
        load_a<D>(av, smem_addr(v_s), kk);
#pragma unroll
        for (int jn = 0; jn < NQ / 2; ++jn) {
          uint32_t qb[4], db[4];
          load_b<D>(qb, qs + 2 * c0 * LDS, jn, kk);
          load_b<D>(db, dos + 2 * c0 * LDS, jn, kk);
          mma16816(st[2 * jn], ak, qb[0], qb[1]);
          mma16816(st[2 * jn + 1], ak, qb[2], qb[3]);
          mma16816(dpt[2 * jn], av, db[0], db[1]);
          mma16816(dpt[2 * jn + 1], av, db[2], db[3]);
        }
      }

      // P^T into st, dS^T = P^T (dP^T - delta) scale into dpt
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = c0 + 8 * j + 2 * tq + (e & 1);  // query within the tile
          const int u = r0 + 8 * (e >> 1);
          bool ok = true;
          if constexpr (kMask)
            ok = (!diag | (q0 + c >= u)) &
                 (!ids | ((q0 + c < T_) & (u < T_) & (!has_seg | (qsg[c] == ks_r[e >> 1]))));
          const float p = ok ? exp2_approx(st[j][e] * scale2 - lses[c]) : 0.f;
          dpt[j][e] = p * (dpt[j][e] - dls[c]);  // dK is scaled at its store
          st[j][e] = p;
        }
      }
      // dV += P^T dO and dK += dS^T Q (bf16 hi + lo, dO and Q by ldmatrix.trans)
      accumulate_split<D, QC / 16>(dva, st, dos + 2 * c0 * LDS);
      accumulate_split<D, QC / 16>(dka, dpt, qs + 2 * c0 * LDS);
    }
    };
    // at D = 128 one body only: two would spill its 128 accumulator registers
    if (D > 64 || diag || ids)
      step(std::true_type{});
    else
      step(std::false_type{});
    __syncthreads();  // every warp is done with this stage before it is refilled
    stage ^= 1;
    cur = nxt;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int u = r0 + 8 * hf;
    if (u >= T_) continue;
    const size_t row = (((size_t)b * T_ + u) * Hk + hk) * D + 2 * tq;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      store_pair(dk + row + 8 * j, dka[j][2 * hf] * scale, dka[j][2 * hf + 1] * scale);
      store_pair(dv + row + 8 * j, dva[j][2 * hf], dva[j][2 * hf + 1]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta, *qseg, *kseg;
  int B, T, H, Hk, causal;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D>
int launch_dq(const Args& a, void* dq) {
  const size_t smem =
      sizeof(float) * (4 * kTile * (D + 1) + kTile * (kTile + 1)) + 2 * kTile * sizeof(int);
  cudaError_t e = allow_smem(flash_bwd_dq_kernel<T, D>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.T + kTile - 1) / kTile, a.B * a.H);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<const int32_t*>(a.qseg),
      static_cast<const int32_t*>(a.kseg), static_cast<T*>(dq), a.T, a.H, a.Hk, a.causal,
      a.scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const Args& a, void* dk, void* dv) {
  const size_t smem = sizeof(float) * (4 * kTile * (D + 1) + 2 * kTile * (kTile + 1) +
                                       2 * kTile) +
                      2 * kTile * sizeof(int);
  cudaError_t e = allow_smem(flash_bwd_dkv_kernel<T, D>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.T + kTile - 1) / kTile, a.B * a.Hk);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<const int32_t*>(a.qseg),
      static_cast<const int32_t*>(a.kseg), static_cast<T*>(dk), static_cast<T*>(dv), a.T,
      a.H, a.Hk, a.causal, a.scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq_bf16(const Args& a, void* dq) {
  const size_t smem = bwd_bf16_smem<D>(a.T);
  cudaError_t e = allow_smem(flash_bwd_dq_bf16_kernel<D>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.T + kBT - 1) / kBT, a.B * a.H);
  flash_bwd_dq_bf16_kernel<D><<<grid, kMmaThreads, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<const int32_t*>(a.qseg), static_cast<const int32_t*>(a.kseg),
      static_cast<bf16*>(dq), a.T, a.H, a.Hk, a.causal, a.scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_bf16(const Args& a, void* dk, void* dv) {
  const size_t smem = bwd_bf16_smem<D>(a.T);
  cudaError_t e = allow_smem(flash_bwd_dkv_bf16_kernel<D>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.T + kBT - 1) / kBT, a.B * a.Hk);
  flash_bwd_dkv_bf16_kernel<D><<<grid, kMmaThreads, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<const int32_t*>(a.qseg), static_cast<const int32_t*>(a.kseg),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), a.T, a.H, a.Hk, a.causal, a.scale);
  return (int)cudaGetLastError();
}

// which = 0: dQ into out0; which = 1: dK, dV into out0, out1.
template <int D>
int run(int which, int dtype, const Args& a, void* out0, void* out1) {
  if (dtype == 0)
    return which == 0 ? launch_dq<float, D>(a, out0) : launch_dkv<float, D>(a, out0, out1);
  return which == 0 ? launch_dq_bf16<D>(a, out0) : launch_dkv_bf16<D>(a, out0, out1);
}

int dispatch(int which, int D, int dtype, const Args& a, void* out0, void* out1) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 32: return run<32>(which, dtype, a, out0, out1);
    case 64: return run<64>(which, dtype, a, out0, out1);
    case 128: return run<128>(which, dtype, a, out0, out1);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, do and the gradients share
// it); lse and delta [B, H, T] float32; qseg/kseg both null or [B, T] int32.
// bfloat16 needs q, k, v and do 16-byte aligned (the wrapper copies a
// view that is not).
int rl_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, const void* qseg, const void* kseg,
                    void* dq, int B, int T, int H, int Hk, int D, int causal, float scale,
                    int dtype, void* stream) {
  const Args a{q, k, v, dout, lse, delta, qseg, kseg, B, T, H, Hk, causal, scale,
               static_cast<cudaStream_t>(stream)};
  return dispatch(0, D, dtype, a, dq, nullptr);
}

int rl_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, const void* qseg, const void* kseg,
                     void* dk, void* dv, int B, int T, int H, int Hk, int D, int causal,
                     float scale, int dtype, void* stream) {
  const Args a{q, k, v, dout, lse, delta, qseg, kseg, B, T, H, Hk, causal, scale,
               static_cast<cudaStream_t>(stream)};
  return dispatch(1, D, dtype, a, dk, dv);
}

const char* rl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
