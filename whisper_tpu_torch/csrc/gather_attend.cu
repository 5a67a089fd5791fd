// Fused gather + append + single-query attention on the ping-pong KV planes (K3).
//
// Replaces: whisper_tpu/ops/fused_step.py:328 `fused_gather_attend` (the
// Pallas kernel `_kernel`, :108, and its XLA epilogue, :432-467). For one
// decoder layer, on caches [2, L, BK, ctx, HD] (HD = H*Dh) in the storage
// dtype:
//
//   plane[1-parity][layer][b][0:pos] = plane[parity][layer][idx[b]][0:pos]   (raw bytes)
//   plane[1-parity][layer][b][pos]   = new_rows[b]                           (raw bytes)
//   attn[b] = attention of q[b] over the written window [0, pos]
//
// with JAX's arithmetic: K/V cast to q's dtype, f32 scores times Dh^-1/2,
// per (row, head) the max m and l = sum exp(s - m) in f32, the weights
// exp(s - m) rounded to q's dtype, the value sum in f32, then the new row's
// own term merged by exact online softmax:
//   m2 = max(m, s_self), alpha = exp(m - m2), beta = exp(s_self - m2),
//   attn = (attn_u * alpha + beta * v_new) / (l * alpha + beta)
// (m = -inf when pos == 0, so alpha is 0 exactly). The wrapper
// (whisper_tpu_torch/ops/gather_attend.py) casts the new rows to the
// storage dtype first, so the plane bytes equal K2's (permute_append.cu).
//
// Bound: bytes. K2's traffic (each distinct source row's window read once,
// the window and the new row written once, K and V) plus q read and attn
// written; the 4*BK*pos*HD flops are negligible. At large-v3 beam 5 batch 4
// in fp8 (BK = 20, HD = 1280, pos 35) that is about 3 MB, 0.9 us at
// 3.35 TB/s: one launch per layer, so launch latency weighs most.
//
// Design: one block of 128 threads per (head, destination row): 400 blocks
// at the flagship's shapes. A head's slice of a position is VP 16-byte
// vectors (VP a power of two <= 32); VP neighbouring threads take one
// position, 128/VP positions per pass. Pass 1 copies the K slice of the
// window and, while the bytes are in registers, takes the dot products with
// q, reduced over the VP threads by warp shuffles, into one f32 score per
// position in shared memory. Then the max over the scores, and only then
// the exponentials: the same two-pass order as the plain version, so the
// rounding of the weights to q's dtype matches. Pass 2 copies the V slice
// and accumulates weight * v in f32; the position groups' partial sums are
// reduced through shared memory. No two blocks write the same bytes, and
// duplicate source rows are only read, so there is no race. An index
// outside [0, BK) traps (no host check, so no sync). Not yet used: wgmma,
// TMA, cp.async pipelines.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (whisper_tpu_torch/ops/build.py).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// Storage element -> f32 (exact for every storage dtype).
__device__ __forceinline__ float to_float(uint8_t x) {  // float8_e4m3fn
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(x, __NV_E4M3)));
}
__device__ __forceinline__ float to_float(uint16_t x) {  // bfloat16 bits
  return __uint_as_float(static_cast<uint32_t>(x) << 16);
}
__device__ __forceinline__ float to_float(float x) { return x; }

// Round to the compute dtype (q's), kept in an f32 register.
template <bool kBf16>
__device__ __forceinline__ float round_c(float x) {
  return kBf16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

template <bool kBf16>
__device__ __forceinline__ float load_c(const void* p, int64_t i) {
  return kBf16 ? to_float(static_cast<const uint16_t*>(p)[i]) : static_cast<const float*>(p)[i];
}

template <bool kBf16>
__device__ __forceinline__ void store_c(void* p, int64_t i, float x) {
  if (kBf16) {
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(x);
  } else {
    static_cast<float*>(p)[i] = x;
  }
}

template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* wred) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float other = __shfl_xor_sync(kFull, v, o);
    v = kMax ? fmaxf(v, other) : v + other;
  }
  if ((threadIdx.x & 31) == 0) wred[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = wred[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = kMax ? fmaxf(r, wred[w]) : r + wred[w];
  __syncthreads();  // wred may be reused, and shared writes before the call are visible
  return r;
}

template <typename S, bool kBf16>
__global__ void __launch_bounds__(kThreads)
    gather_attend_kernel(uint4* ck, uint4* cv, const uint4* __restrict__ k_new,
                         const uint4* __restrict__ v_new, const int* __restrict__ idx,
                         const void* __restrict__ q, void* __restrict__ out, int n_layer, int bk,
                         int ctx, int hd, int n_head, int layer, int pos, int parity,
                         float scale) {
  constexpr int E = 16 / sizeof(S);  // elements per 16-byte vector
  extern __shared__ float sc[];      // [pos] scores, then rounded weights
  __shared__ float red[kThreads * E];  // partial value sums: [position group][Dh]
  __shared__ float wred[kWarps];
  __shared__ float s_self_sh;

  const int h = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
  const int dh = hd / n_head;
  const int vp = dh / E;          // vectors of one head's slice of a position
  const int pp = kThreads / vp;   // positions per pass
  const int j = t % vp, pg = t / vp;
  const int row_vecs = hd / E;    // vectors per position
  const int src = idx[b];
  if (src < 0 || src >= bk) __trap();
  const int64_t cache_row = (int64_t)ctx * row_vecs;
  const int64_t src_base =
      (((int64_t)parity * n_layer + layer) * bk + src) * cache_row + (int64_t)h * vp;
  const int64_t dst_base =
      (((int64_t)(1 - parity) * n_layer + layer) * bk + b) * cache_row + (int64_t)h * vp;
  const int64_t head0 = (int64_t)b * hd + (int64_t)h * dh;  // element offset of this head

  float qv[E];
#pragma unroll
  for (int e = 0; e < E; ++e) qv[e] = load_c<kBf16>(q, head0 + j * E + e);

  // Pass 1: copy the K window, scores into shared memory. The loop bound
  // is uniform over the block, so every lane reaches the shuffles.
  for (int base = 0; base < pos; base += pp) {
    const int p = base + pg;
    float part = 0.f;
    if (p < pos) {
      const uint4 raw = ck[src_base + (int64_t)p * row_vecs + j];
      ck[dst_base + (int64_t)p * row_vecs + j] = raw;
      const S* el = reinterpret_cast<const S*>(&raw);
#pragma unroll
      for (int e = 0; e < E; ++e) part = fmaf(round_c<kBf16>(to_float(el[e])), qv[e], part);
    }
    for (int o = vp / 2; o > 0; o >>= 1) part += __shfl_xor_sync(kFull, part, o);
    if (p < pos && j == 0) sc[p] = part * scale;
  }
  // The new rows at pos, and the self score (JAX: the stored rows in f32).
  if (t < vp) {
    ck[dst_base + (int64_t)pos * row_vecs + t] = k_new[(int64_t)b * row_vecs + h * vp + t];
    cv[dst_base + (int64_t)pos * row_vecs + t] = v_new[(int64_t)b * row_vecs + h * vp + t];
  }
  if (t < 32) {
    const S* kn = reinterpret_cast<const S*>(k_new);
    float part = 0.f;
    for (int d = t; d < dh; d += 32) part = fmaf(load_c<kBf16>(q, head0 + d), to_float(kn[head0 + d]), part);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(kFull, part, o);
    if (t == 0) s_self_sh = part * scale;
  }
  __syncthreads();

  // Max first, then the exponentials (two passes, as the plain version).
  float m = -INFINITY;
  for (int p = t; p < pos; p += kThreads) m = fmaxf(m, sc[p]);
  m = block_reduce<true>(m, wred);
  float l = 0.f;
  for (int p = t; p < pos; p += kThreads) {
    const float e = expf(sc[p] - m);
    l += e;
    sc[p] = round_c<kBf16>(e);
  }
  l = block_reduce<false>(l, wred);

  // Pass 2: copy the V window, weight * v summed in f32.
  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;
  for (int base = 0; base < pos; base += pp) {
    const int p = base + pg;
    if (p < pos) {
      const uint4 raw = cv[src_base + (int64_t)p * row_vecs + j];
      cv[dst_base + (int64_t)p * row_vecs + j] = raw;
      const S* el = reinterpret_cast<const S*>(&raw);
      const float w = sc[p];
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = fmaf(w, round_c<kBf16>(to_float(el[e])), acc[e]);
    }
  }
  // red[pg * dh + d] with d = j * E + e: thread t's slot is t * E + e.
#pragma unroll
  for (int e = 0; e < E; ++e) red[t * E + e] = acc[e];
  __syncthreads();

  const float s_self = s_self_sh;
  const float m2 = fmaxf(m, s_self);
  const float alpha = expf(m - m2);  // 0 exactly when pos == 0 (m = -inf)
  const float beta = expf(s_self - m2);
  const float denom = l * alpha + beta;
  const S* vn = reinterpret_cast<const S*>(v_new);
  for (int d = t; d < dh; d += kThreads) {
    float a = 0.f;
    for (int g = 0; g < pp; ++g) a += red[g * dh + d];
    store_c<kBf16>(out, head0 + d, (a * alpha + beta * to_float(vn[head0 + d])) / denom);
  }
}

template <typename S, bool kBf16>
cudaError_t launch(dim3 grid, size_t smem, cudaStream_t stream, void* ck, void* cv,
                   const void* k_new, const void* v_new, const int* idx, const void* q,
                   void* out, int n_layer, int bk, int ctx, int hd, int n_head, int layer,
                   int pos, int parity, float scale) {
  gather_attend_kernel<S, kBf16><<<grid, kThreads, smem, stream>>>(
      static_cast<uint4*>(ck), static_cast<uint4*>(cv), static_cast<const uint4*>(k_new),
      static_cast<const uint4*>(v_new), idx, q, out, n_layer, bk, ctx, hd, n_head, layer, pos,
      parity, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float8_e4m3fn, 1 bfloat16, 2 float32 (the planes and new rows);
// compute: 1 bfloat16, 2 float32 (q and attn). Returns the cudaError of the
// launch.
extern "C" int gather_attend(void* ck, void* cv, const void* k_new, const void* v_new,
                             const int* idx, const void* q, void* out, int n_layer, int bk,
                             int ctx, int hd, int n_head, int layer, int pos, int parity,
                             int dtype, int compute, float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)n_head, (unsigned)bk);
  const size_t smem = (size_t)(pos > 0 ? pos : 1) * sizeof(float);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GA_LAUNCH(S, BF16)                                                                     \
  return (int)launch<S, BF16>(grid, smem, s, ck, cv, k_new, v_new, idx, q, out, n_layer, bk, \
                              ctx, hd, n_head, layer, pos, parity, scale)
  const bool bf16 = compute == 1;
  if (compute != 1 && compute != 2) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      if (bf16) GA_LAUNCH(uint8_t, true);
      GA_LAUNCH(uint8_t, false);
    case 1:
      if (bf16) GA_LAUNCH(uint16_t, true);
      GA_LAUNCH(uint16_t, false);
    case 2:
      if (bf16) GA_LAUNCH(float, true);
      GA_LAUNCH(float, false);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef GA_LAUNCH
}
