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
// Bound on an H100, at the training shape [8, 1024, 12, 64] bf16 causal
// with no padding: operations, barely. The dQ kernel does 3 products per
// attended pair (QK^T, dO V^T, dS K): 19.3 GFLOP, 19.6 us at 989 TFLOP/s,
// against 63.7 MB of q, do, k, v, lse, delta and dq, 19.0 us at 3.35 TB/s.
// The dK/dV kernel does 4 (QK^T, dO V^T, P^T dO, dS^T Q): 25.8 GFLOP, 26.1
// us, against 76 MB, 22.8 us. Padded keys lower the operations, not the
// bytes, so a left-padded batch is bound by bytes.
//
// What the design does about it: Hopper blocks run in parallel and carry
// nothing between them, so instead of the TPU's sequential grid with VMEM
// accumulators, each block owns its output tile and loops inside:
//  - dQ: one block per (64-row query tile, b, h) walks the key tiles the
//    causal mask needs, accumulating the [64, D] dQ tile in registers;
//  - dK/dV: one block per (64-key tile, b, kv head) walks every query head
//    of its GQA group and the query tiles at or below the diagonal,
//    accumulating dK and dV in registers. The group sum therefore happens
//    inside the block, in a fixed order, with no atomics: the result is
//    deterministic and no per-query-head dK/dV ever reaches device memory.
// A first, simple version like the forward: float32 FMA loops on
// shared-memory tiles, no tensor cores, no copy pipelining.

#include "flash_common.cuh"

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

// which = 0: dQ into out0; which = 1: dK, dV into out0, out1.
template <typename T, int D>
int run(int which, const Args& a, void* out0, void* out1) {
  return which == 0 ? launch_dq<T, D>(a, out0) : launch_dkv<T, D>(a, out0, out1);
}

int dispatch(int which, int D, int dtype, const Args& a, void* out0, void* out1) {
  if (dtype == 0) {
    switch (D) {
      case 32: return run<float, 32>(which, a, out0, out1);
      case 64: return run<float, 64>(which, a, out0, out1);
      case 128: return run<float, 128>(which, a, out0, out1);
    }
  } else if (dtype == 1) {
    switch (D) {
      case 32: return run<__nv_bfloat16, 32>(which, a, out0, out1);
      case 64: return run<__nv_bfloat16, 64>(which, a, out0, out1);
      case 128: return run<__nv_bfloat16, 128>(which, a, out0, out1);
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, do and the gradients share
// it); lse and delta [B, H, T] float32; qseg/kseg both null or [B, T] int32.
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
