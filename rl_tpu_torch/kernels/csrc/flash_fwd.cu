// Flash-attention forward, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel rl_tpu/ops/attention.py `_flash_fwd_bhtd`
// (body `_fwd_kernel`), reached from `flash_attention`.
//
// What it computes, per batch row b, query head h and query position t:
//   s[t, u] = scale * (q[b, t, h] . k[b, u, h / G])       (G = H / Hk)
//   o[b, t, h] = sum_u softmax_u(s[t, :] over attended u) v[b, u, h / G]
//   lse[b, h, t] = log sum_u exp(s[t, u]) over attended u
// where u is attended when it lies inside T, is not in t's future
// (causal) and has t's segment id (segment ids lower both the padding
// mask and packed sequences; see flash_common.cuh). The scale multiplies
// the float32 product, as the reference does (q is not pre-scaled). A row
// with no attended key (a left-padded prompt's pad queries) gets o = 0
// and lse = -1e30: its probabilities are masked to 0, not left to
// exp(-1e30 - (-1e30)) = 1.
//
// Bound on an H100: bytes. Per (b, h) the causal product is 2 * T^2 * D
// multiply-adds (QK^T and PV, halved by the mask); at the training shape
// [8, 1024, 12, 64] bf16 with no padding that is 12.9 GFLOP (13.0 us at
// 989 TFLOP/s) against 50.3 MB of q, k, v and o plus 0.4 MB of lse
// (15.1 us at 3.35 TB/s). Padded keys lower the operations, not the bytes.
//
// Two bodies, chosen by dtype:
//
// float32 (flash_fwd_kernel, the first version, kept for the float32
// training check): one block per (64-row query tile, b, h) walks the key
// tiles the causal mask needs, with float32 FMA 4x4 register tiles on
// float32 shared-memory tiles (flash_common.cuh), P through shared memory.
//
// bfloat16 (flash_fwd_bf16_kernel; FA2 on mma.sync.m16n8k16): one block
// of four warps per (64-row query tile, b, h), causal blocks issued
// longest first.
//  - Each warp owns 16 query rows, loaded once as A fragments with
//    ldmatrix. K and V stay bf16 in shared memory, rows padded by 16 bytes
//    so that the 8 rows of an ldmatrix fall in 8 different bank groups,
//    filled by 16-byte cp.async copies in a ring of two stages: the next
//    live key tile loads while this one is computed.
//  - S = Q K^T accumulates in float32 registers; the scale multiplies the
//    float32 product. The online softmax stays in registers: a row lives
//    in the four lanes of a quad, which reduce its max and sum by shuffles.
//  - P goes to the PV product as A fragments straight from the S
//    registers, with no trip through shared memory. It is split into two
//    bf16 parts, P = hi + lo (lo = bf16(P - hi)), and both are multiplied
//    by V into the float32 accumulator. One bf16 rounding of P would carry
//    ~1.5e-3 relative error per term, which the unchanged gate of
//    chip_smoke.py (one bf16 step of |o| + 1e-3 rms(o)) does not admit
//    near o = 0 (tests/test_torch_flash_fwd_bf16.py holds both models to
//    it); hi + lo leaves ~2^-16. This costs a third more tensor-core work.
//  - Before the loop the block classifies its key tiles from the segment
//    ids: 0 when no key of the tile has an id inside the [min, max] of
//    the block's query ids (left-pad tiles under kv_mask: pads are -1,
//    queries 1), 2 when every key is inside T and equal to the block's one
//    query id, else 1. Tiles of class 0 and tiles above the causal
//    diagonal are neither loaded nor computed; masks are evaluated per
//    element only on class-1 tiles and on the diagonal. The class test is
//    conservative: it never drops a tile in which a pair attends.
// Measured by chip_smoke.py on an H100 80GB HBM3 at a 700 W power limit,
// one launch after an L2 flush, at the training shape [8, 1024, 12, 64]
// bf16 causal with left pads of up to 511 keys: 0.1110-0.1116 ms, against
// 0.7430-0.7494 ms for the float32 FMA body on bf16 inputs (the first
// version) and 0.1444-0.1453 ms for SDPA with the same mask; bound 0.01516
// ms (bytes).

#include <climits>

#include "cp_async.cuh"
#include "flash_common.cuh"
#include "mma_bf16.cuh"

namespace {

using namespace flash;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int32_t* __restrict__ qseg, const int32_t* __restrict__ kseg, T* __restrict__ o,
    float* __restrict__ lse, int T_, int H, int Hk, int causal, float scale) {
  constexpr int LD = D + 1, NJ = D / 16;
  extern __shared__ float smem[];
  float* q_s = smem;                  // [64][LD]
  float* k_s = q_s + kTile * LD;      // [64][LD]
  float* v_s = k_s + kTile * LD;      // [64][LD]
  float* p_s = v_s + kTile * LD;      // [64][65] probabilities
  int* qseg_s = reinterpret_cast<int*>(p_s + kTile * (kTile + 1));  // [64]
  int* kseg_s = qseg_s + kTile;       // [64]

  const int nq = (T_ + kTile - 1) / kTile;
  const int qt = causal ? nq - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int b = blockIdx.y / H, h = blockIdx.y - b * H;
  const int hk = h / (H / Hk);
  const int q0 = qt * kTile;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const bool has_seg = kseg != nullptr;

  load_tile<T, D>(q_s, q, b, q0, T_, H, h);
  load_seg(qseg_s, qseg, b, q0, T_);
  __syncthreads();
  int qpos[4], qsg[4];
  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    qpos[i] = q0 + ty * 4 + i;
    qsg[i] = qseg_s[ty * 4 + i];
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  int nk = (T_ + kTile - 1) / kTile;
  if (causal) nk = min(nk, qt + 1);  // tiles above the diagonal: nothing to attend
  for (int jt = 0; jt < nk; ++jt) {
    const int k0 = jt * kTile;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(k_s, k, b, k0, T_, Hk, hk);
    load_tile<T, D>(v_s, v, b, k0, T_, Hk, hk);
    load_seg(kseg_s, kseg, b, k0, T_);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(ty * 4 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = k_s[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += qv[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        ok[j] = attends(qpos[i], k0 + c, T_, causal, has_seg, qsg[i], kseg_s[c]);
        s[i][j] = ok[j] ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        p_s[(ty * 4 + i) * (kTile + 1) + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * corr + half_warp_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float pv[4], vv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(ty * 4 + i) * (kTile + 1) + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vv[j] = v_s[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] += pv[i] * vv[j];
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = qpos[i];
    if (t >= T_) continue;
    const float denom = l[i] > 0.f ? l[i] : 1.f;  // no attended key: o = 0
    T* orow = o + (((size_t)b * T_ + t) * H + h) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) store(&orow[tx + 16 * j], acc[i][j] / denom);
    if (tx == 0) lse[((size_t)b * H + h) * T_ + t] = m[i] + logf(denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* qseg, const void* kseg,
           void* o, void* lse, int B, int T_, int H, int Hk, int causal, float scale,
           cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (3 * kTile * (D + 1) + kTile * (kTile + 1)) + 2 * kTile * sizeof(int);
  cudaError_t e = allow_smem(flash_fwd_kernel<T, D>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((T_ + kTile - 1) / kTile, B * H);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int32_t*>(qseg), static_cast<const int32_t*>(kseg),
      static_cast<T*>(o), static_cast<float*>(lse), T_, H, Hk, causal, scale);
  return (int)cudaGetLastError();
}

// -- bfloat16: tensor cores (mma.sync.m16n8k16) --------------------------------

using namespace mma_bf16;
using async_copy::cp_async16;
using async_copy::cp_async_commit;
using async_copy::cp_async_wait;

constexpr int kBM = 64;  // query rows per block, 16 per warp
constexpr int kBN = 64;  // keys per tile
constexpr int kMmaThreads = 128;

template <int D>
constexpr size_t bf16_smem(int T_) {
  return sizeof(bf16) * (kBM + 4 * kBN) * (D + 8) + sizeof(int) * ((T_ + kBN - 1) / kBN + 2);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads) flash_fwd_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const int32_t* __restrict__ qseg, const int32_t* __restrict__ kseg, bf16* __restrict__ o,
    float* __restrict__ lse, int T_, int H, int Hk, int causal, float scale) {
  constexpr int LDS = D + 8;  // padded row, in elements
  constexpr int KD = D / 16;  // k-steps of Q K^T
  constexpr int ND = D / 8;   // n-tiles of O
  constexpr int NN = kBN / 8; // n-tiles of S
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [kBM][LDS]
  bf16* k_s = q_s + kBM * LDS;                     // [2][kBN][LDS]
  bf16* v_s = k_s + 2 * kBN * LDS;                 // [2][kBN][LDS]
  const int nkt = (T_ + kBN - 1) / kBN;
  int* cls_s = reinterpret_cast<int*>(v_s + 2 * kBN * LDS);  // [nkt] key-tile classes
  int* qrange = cls_s + nkt;                                  // min, max query segment id

  const int nq = (T_ + kBM - 1) / kBM;
  const int qt = causal ? nq - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int b = blockIdx.y / H, h = blockIdx.y - b * H;
  const int hk = h / (H / Hk);
  const int q0 = qt * kBM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool has_seg = kseg != nullptr;
  const int nk = causal ? min(nkt, (q0 + kBM - 1) / kBN + 1) : nkt;

  // the query tile, its own cp.async group; rows past T are zeros
  for (int i = tid; i < kBM * CPR; i += kMmaThreads) {
    const int r = i / CPR, cc = i - r * CPR, t = q0 + r;
    cp_async16(q_s + r * LDS + cc * 8,
               q + (((size_t)b * T_ + min(t, T_ - 1)) * H + h) * D + cc * 8, t < T_);
  }
  cp_async_commit();

  // classify the key tiles (see the header): one warp per tile
  if (tid == 0) {
    qrange[0] = INT_MAX;
    qrange[1] = INT_MIN;
  }
  __syncthreads();
  if (has_seg && tid < kBM && q0 + tid < T_) {
    const int sg = qseg[(size_t)b * T_ + q0 + tid];
    atomicMin(&qrange[0], sg);
    atomicMax(&qrange[1], sg);
  }
  __syncthreads();
  const int qmin = qrange[0], qmax = qrange[1];
  for (int jt = warp; jt < nk; jt += kMmaThreads / 32) {
    bool any = false, all = true;
#pragma unroll
    for (int i = 0; i < kBN / 32; ++i) {
      const int u = jt * kBN + i * 32 + lane;
      const bool in = u < T_;
      const int ks = (has_seg && in) ? kseg[(size_t)b * T_ + u] : 0;
      any |= in && (!has_seg || (ks >= qmin && ks <= qmax));
      all &= in && (!has_seg || (qmin == qmax && ks == qmin));
    }
    any = __any_sync(0xffffffffu, any);
    all = __all_sync(0xffffffffu, all);
    if (lane == 0) cls_s[jt] = any ? (all ? 2 : 1) : 0;
  }
  __syncthreads();

  auto next_live = [&](int j) {
    while (j < nk && cls_s[j] == 0) ++j;
    return j;
  };
  auto load_kv = [&](int jt, int stage) {
    bf16* ks = k_s + stage * kBN * LDS;
    bf16* vs = v_s + stage * kBN * LDS;
    for (int i = tid; i < kBN * CPR; i += kMmaThreads) {
      const int r = i / CPR, cc = i - r * CPR, u = jt * kBN + r;
      const size_t off = (((size_t)b * T_ + min(u, T_ - 1)) * Hk + hk) * D + cc * 8;
      cp_async16(ks + r * LDS + cc * 8, k + off, u < T_);
      cp_async16(vs + r * LDS + cc * 8, v + off, u < T_);
    }
  };

  int cur = next_live(0);
  if (cur < nk) load_kv(cur, 0);
  cp_async_commit();
  cp_async_wait<1>();  // the query tile
  __syncthreads();

  uint32_t qa[KD][4];  // this warp's 16 rows as A fragments
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
    ldsm_x4(qa[kk], q_s + (warp * 16 + (lane & 15)) * LDS + kk * 16 + (lane >> 4) * 8);

  // lane holds rows r0 and r0 + 8, columns 2 (lane % 4) + {0, 1} of each n-tile
  const int r0 = q0 + warp * 16 + (lane >> 2), tq = lane & 3;
  int qs0 = 0, qs1 = 0;
  if (has_seg) {
    qs0 = r0 < T_ ? qseg[(size_t)b * T_ + r0] : 0;
    qs1 = r0 + 8 < T_ ? qseg[(size_t)b * T_ + r0 + 8] : 0;
  }
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // l: this lane's share
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
    const bf16* ks = k_s + stage * kBN * LDS;
    const bf16* vs = v_s + stage * kBN * LDS;

    float sacc[NN][4];
#pragma unroll
    for (int j = 0; j < NN; ++j) sacc[j][0] = sacc[j][1] = sacc[j][2] = sacc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int jn = 0; jn < NN / 2; ++jn) {
        uint32_t kb[4];  // B fragments of n-tiles 2 jn and 2 jn + 1
        ldsm_x4(kb, ks + (jn * 16 + (lane >> 4) * 8 + (lane & 7)) * LDS + kk * 16 +
                        ((lane >> 3) & 1) * 8);
        mma16816(sacc[2 * jn], qa[kk], kb[0], kb[1]);
        mma16816(sacc[2 * jn + 1], qa[kk], kb[2], kb[3]);
      }
    }

    // scale; -inf where a pair does not attend (then p = 0 exactly, also
    // while the row max is still -1e30)
    const int k0 = cur * kBN;
    const bool masked = cls_s[cur] == 1 || (causal && k0 + kBN - 1 > q0);
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < NN; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sacc[j][e] * scale;
        if (masked) {
          const int col = k0 + 8 * j + 2 * tq + (e & 1);
          const int row = e < 2 ? r0 : r0 + 8;
          const bool ok = col < T_ && (!causal || row >= col) &&
                          (!has_seg || (e < 2 ? qs0 : qs1) == kseg[(size_t)b * T_ + col]);
          x = ok ? x : -INFINITY;
        }
        sacc[j][e] = x;
        if (e < 2)
          mx0 = fmaxf(mx0, x);
        else
          mx1 = fmaxf(mx1, x);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = expf(m0 - mn0), c1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= c0;
    l1 *= c1;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      acc[j][0] *= c0;
      acc[j][1] *= c0;
      acc[j][2] *= c1;
      acc[j][3] *= c1;
    }

    // O += P V, P = exp(S - m) as bf16 hi + lo A fragments
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      uint32_t ph[4], pl[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = 2 * kk + half;
        const float p0 = __expf(sacc[j][0] - mn0), p1 = __expf(sacc[j][1] - mn0);
        const float p2 = __expf(sacc[j][2] - mn1), p3 = __expf(sacc[j][3] - mn1);
        l0 += p0 + p1;
        l1 += p2 + p3;
        split_pair(p0, p1, ph[2 * half], pl[2 * half]);
        split_pair(p2, p3, ph[2 * half + 1], pl[2 * half + 1]);
      }
#pragma unroll
      for (int dn = 0; dn < ND / 2; ++dn) {
        uint32_t vb[4];  // B fragments of d-tiles 2 dn and 2 dn + 1
        ldsm_x4_t(vb, vs + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LDS + dn * 16 +
                          (lane >> 4) * 8);
        mma16816(acc[2 * dn], ph, vb[0], vb[1]);
        mma16816(acc[2 * dn], pl, vb[0], vb[1]);
        mma16816(acc[2 * dn + 1], ph, vb[2], vb[3]);
        mma16816(acc[2 * dn + 1], pl, vb[2], vb[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
    stage ^= 1;
    cur = nxt;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float d0 = l0 > 0.f ? l0 : 1.f, d1 = l1 > 0.f ? l1 : 1.f;  // no attended key: o = 0
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = r0 + 8 * half;
    if (t >= T_) continue;
    const float den = half ? d1 : d0;
    bf16* orow = o + (((size_t)b * T_ + t) * H + h) * D + 2 * tq;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(acc[j][2 * half] / den, acc[j][2 * half + 1] / den);
    if (tq == 0) lse[((size_t)b * H + h) * T_ + t] = (half ? m1 : m0) + logf(den);
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, const void* qseg,
                const void* kseg, void* o, void* lse, int B, int T_, int H, int Hk, int causal,
                float scale, cudaStream_t stream) {
  const size_t smem = bf16_smem<D>(T_);
  cudaError_t e = allow_smem(flash_fwd_bf16_kernel<D>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((T_ + kBM - 1) / kBM, B * H);
  flash_fwd_bf16_kernel<D><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int32_t*>(qseg), static_cast<const int32_t*>(kseg),
      static_cast<bf16*>(o), static_cast<float*>(lse), T_, H, Hk, causal, scale);
  return (int)cudaGetLastError();
}

int by_dim_f32(int D, const void* q, const void* k, const void* v, const void* qseg,
               const void* kseg, void* o, void* lse, int B, int T_, int H, int Hk, int causal,
               float scale, cudaStream_t st) {
  switch (D) {
    case 32: return launch<float, 32>(q, k, v, qseg, kseg, o, lse, B, T_, H, Hk, causal, scale, st);
    case 64: return launch<float, 64>(q, k, v, qseg, kseg, o, lse, B, T_, H, Hk, causal, scale, st);
    case 128: return launch<float, 128>(q, k, v, qseg, kseg, o, lse, B, T_, H, Hk, causal, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

int by_dim_bf16(int D, const void* q, const void* k, const void* v, const void* qseg,
                const void* kseg, void* o, void* lse, int B, int T_, int H, int Hk, int causal,
                float scale, cudaStream_t st) {
  switch (D) {
    case 32: return launch_bf16<32>(q, k, v, qseg, kseg, o, lse, B, T_, H, Hk, causal, scale, st);
    case 64: return launch_bf16<64>(q, k, v, qseg, kseg, o, lse, B, T_, H, Hk, causal, scale, st);
    case 128: return launch_bf16<128>(q, k, v, qseg, kseg, o, lse, B, T_, H, Hk, causal, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it). qseg and kseg
// are both null (no segment ids) or both [B, T] int32. bfloat16 needs q, k,
// v and o 16-byte aligned (the wrapper checks).
int rl_flash_fwd(const void* q, const void* k, const void* v, const void* qseg,
                 const void* kseg, void* o, void* lse, int B, int T, int H, int Hk, int D,
                 int causal, float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return by_dim_f32(D, q, k, v, qseg, kseg, o, lse, B, T, H, Hk, causal, scale, st);
  if (dtype == 1)
    return by_dim_bf16(D, q, k, v, qseg, kseg, o, lse, B, T, H, Hk, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}

const char* rl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
