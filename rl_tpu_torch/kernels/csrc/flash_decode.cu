// Dense-cache single-token decode attention, written by hand for Hopper
// (sm_90a).
//
// Replaces the TPU kernel rl_tpu/ops/attention.py `flash_decode` (body
// `_decode_kernel`).
//
// What it computes: for every batch row b and query head h,
//   o[b,h] = softmax(q[b,h] . K[b]^T) V[b]
// over the cache positions t < cache_len whose kv_mask[b, t] is set (all
// of them without a mask). A row with no such position writes zeros. q
// arrives already multiplied by the softmax scale (in q's dtype, as the
// reference does before its kernel). cache_len is a launch argument: the
// caller keeps it on the host, so nothing is read back from the device.
//
// Layouts (the reference's): q and out [B, H, D]; k and v [B, S, Hk, D];
// kv_mask [B, S] bytes or null. H is a multiple of Hk (GQA: query head h
// reads kv head h / (H / Hk)).
//
// Bound on an H100: memory. The function must read q, write out, read
// the kv_mask bytes below cache_len and read the K and V rows of every
// visible position once:
//   bytes = 2 * B*H*D*esz + B*cache_len + 2 * visible * Hk*D*esz,
// against 4 * H*D flops per visible position (q.k and p.v), about one
// flop per byte for MHA in bf16, far below the card's ~295 flops per byte
// ridge. At the evaluate shape (8 rows, cache_len 768 of which the first
// 480 are left padding, 12 kv heads of 64, bf16) that is 2304 visible
// positions, ~7.1 MB: ~2.1 us at 3.35 TB/s, the bound chip_smoke.py
// computes from the same inputs. This kernel reads every row below
// cache_len, masked or not (~18.9 MB there).
//
// What the design does about it:
//  - one thread block per (b, kv head) serves all H/Hk query heads of its
//    group, so each K/V row is read from device memory once per group;
//  - the block walks 64-row tiles only up to cache_len: positions at or
//    past it are never fetched (the point of the reference's clamped index
//    map); the last tile is cut by bounds checks, not padding;
//  - rows are fetched as 16-byte vectors into float32 shared memory (K
//    with a row stride of D + 1, so the per-thread dot products of 32
//    consecutive rows hit 32 banks); the online-softmax state stays in
//    shared memory for the whole walk (decode_common.cuh).
// A first, simple version: float32 FMA dot products (no tensor cores), no
// cp.async/TMA double buffering, and B * Hk blocks (96 at the evaluate
// shape, on 132 SMs); splitting the sequence across blocks
// (flash-decoding) is later work.

#include "decode_common.cuh"

namespace {

using namespace decode;

constexpr int kThreads = 128;
constexpr int kTile = 64;  // cache rows per tile (_DECODE_TILE in ops/attention.py)

// One 16-byte vector of T from global memory into float32 dst[0 ..].
template <typename T>
__device__ __forceinline__ void load_vec(float* dst, const T* src) {
  constexpr int n = 16 / sizeof(T);
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int u = 0; u < n; ++u) dst[u] = to_f32(e[u]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const uint8_t* __restrict__ kv_mask, T* __restrict__ out, int S, int H, int Hk, int D,
    int cache_len) {
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int G = H / Hk;
  const int tid = threadIdx.x;
  const int ldk = D + 1;

  extern __shared__ float smem[];
  float* q_s = smem;               // [G, D]
  float* k_s = q_s + G * D;        // [kTile, D + 1]
  float* v_s = k_s + kTile * ldk;  // [kTile, D]
  float* p_s = v_s + kTile * D;    // [G, kTile] scores, then probabilities
  float* acc_s = p_s + G * kTile;  // [G, D]
  float* m_s = acc_s + G * D;      // [G]
  float* l_s = m_s + G;            // [G]
  float* c_s = l_s + G;            // [G]

  // the group's G query heads are consecutive: rows kvh*G .. kvh*G+G-1
  const size_t row0 = ((size_t)b * H + (size_t)kvh * G) * D;
  init_state<kThreads>(q, row0, q_s, acc_s, m_s, l_s, G, D);

  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  const int chunks = D / kVec;
  const size_t rstride = (size_t)Hk * D;  // elements between positions
  const size_t head0 = (size_t)b * S * rstride + (size_t)kvh * D;
  const uint8_t* mask = kv_mask == nullptr ? nullptr : kv_mask + (size_t)b * S;

  for (int t0 = 0; t0 < cache_len; t0 += kTile) {
    const int n = min(kTile, cache_len - t0);
    for (int idx = tid; idx < n * chunks; idx += kThreads) {
      const int i = idx / chunks, c = idx - i * chunks;
      const size_t off = head0 + (size_t)(t0 + i) * rstride + (size_t)c * kVec;
      load_vec(k_s + i * ldk + c * kVec, k + off);
      load_vec(v_s + i * D + c * kVec, v + off);
    }
    __syncthreads();

    // scores: one thread per (head, position), a float32 dot over D
    for (int r = tid; r < G * n; r += kThreads) {
      const int g = r / n, i = r - g * n;
      const float* qr = q_s + g * D;
      const float* kr = k_s + i * ldk;
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
      const bool visible = mask == nullptr || mask[t0 + i] != 0;
      p_s[g * kTile + i] = visible ? dot : -INFINITY;
    }
    __syncthreads();
    fold_tile<kThreads>(p_s, kTile, v_s, D, acc_s, m_s, l_s, c_s, G, D, n);
  }
  write_out<kThreads>(out, row0, acc_s, l_s, G, D);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* kv_mask, void* out, int B,
           int S, int H, int Hk, int D, int cache_len, cudaStream_t stream) {
  const int G = H / Hk;
  const size_t smem =
      sizeof(float) * (size_t)(2 * G * D + kTile * (D + 1) + kTile * D + G * kTile + 3 * G);
  cudaError_t e = allow_smem(flash_decode_kernel<T>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B, Hk);
  flash_decode_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(kv_mask), static_cast<T*>(out), S, H, Hk, D, cache_len);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it); kv_mask
// may be null. k and v must be 16-byte aligned (the wrapper sees to it).
int rl_flash_decode(const void* q, const void* k, const void* v, const void* kv_mask, void* out,
                    int B, int S, int H, int Hk, int D, int cache_len, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D % 8 != 0 || H % Hk != 0 || cache_len < 0 || cache_len > S)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(q, k, v, kv_mask, out, B, S, H, Hk, D, cache_len, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, kv_mask, out, B, S, H, Hk, D, cache_len, st);
  return (int)cudaErrorInvalidValue;
}

const char* rl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
