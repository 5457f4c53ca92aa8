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
// What the design does about it: one block per (64-row query tile, b, h)
// walks the key tiles the causal mask needs (never the ones above the
// diagonal), keeping the online-softmax state (m, l) and the [64, D]
// accumulator in registers and one K and one V tile in shared memory, so
// the [T, T] score matrix never reaches device memory. Causal blocks are
// issued longest first. A first, simple version: float32 FMA loops on
// shared-memory tiles (no tensor cores, no cp.async/TMA pipelining), so it
// runs at a fraction of the bf16 tensor-core rate.

#include "flash_common.cuh"

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

template <typename T>
int by_dim(int D, const void* q, const void* k, const void* v, const void* qseg,
           const void* kseg, void* o, void* lse, int B, int T_, int H, int Hk, int causal,
           float scale, cudaStream_t st) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, qseg, kseg, o, lse, B, T_, H, Hk, causal, scale, st);
    case 64: return launch<T, 64>(q, k, v, qseg, kseg, o, lse, B, T_, H, Hk, causal, scale, st);
    case 128: return launch<T, 128>(q, k, v, qseg, kseg, o, lse, B, T_, H, Hk, causal, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it). qseg and kseg
// are both null (no segment ids) or both [B, T] int32.
int rl_flash_fwd(const void* q, const void* k, const void* v, const void* qseg,
                 const void* kseg, void* o, void* lse, int B, int T, int H, int Hk, int D,
                 int causal, float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return by_dim<float>(D, q, k, v, qseg, kseg, o, lse, B, T, H, Hk, causal, scale, st);
  if (dtype == 1)
    return by_dim<__nv_bfloat16>(D, q, k, v, qseg, kseg, o, lse, B, T, H, Hk, causal, scale,
                                 st);
  return (int)cudaErrorInvalidValue;
}

const char* rl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
