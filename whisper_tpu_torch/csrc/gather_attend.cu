// Fused gather + append + single-query attention on the ping-pong KV planes (K3).
//
// Replaces: whisper_tpu/ops/fused_step.py:328 `fused_gather_attend` (the
// Pallas kernel `_kernel`, :108, and its XLA epilogue, :432-467). For one
// decoder layer, on caches [2, L, BK, ctx, HD] (HD = H*Dh) in the storage
// dtype:
//
//   plane[1-parity][layer][b][0:pos] = plane[parity][layer][idx[b]][0:pos]   (raw bytes)
//   plane[1-parity][layer][b][pos]   = new_rows[b].to(storage dtype)
//   attn[b] = attention of q[b] over the written window [0, pos]
//
// with JAX's arithmetic: K/V cast to q's dtype, f32 scores times Dh^-1/2,
// per (row, head) the max m and l = sum exp(s - m) in f32, the weights
// exp(s - m) rounded to q's dtype, the value sum in f32, then the new row's
// own term merged by exact online softmax:
//   m2 = max(m, s_self), alpha = exp(m - m2), beta = exp(s_self - m2),
//   attn = (attn_u * alpha + beta * v_new) / (l * alpha + beta)
// (m = -inf when pos == 0, so alpha is 0 exactly). The new rows come as
// the caller has them (f32, bf16 or f16 at any strides, or already in the
// storage dtype) and are converted as they are stored, bitwise as
// PyTorch's `.to()` (store_cast.cuh, K2's conversion), so the plane bytes
// equal K2's (permute_append.cu) and one call is one launch. The self score
// and the self term read the stored value back, as JAX does.
//
// Bound: bytes. K2's traffic (each distinct source row's window read once,
// the window and the new row written once, K and V) plus q read and attn
// written; the 4*BK*pos*HD flops are negligible. At large-v3 beam 5 batch 4
// in fp8 (BK = 20, HD = 1280, pos 35) that is about 3 MB, 0.9 us at
// 3.35 TB/s: one launch per layer, so latency weighs most. The kernel's
// floor is its chain of dependent steps, so the design shortens the chain.
//
// Design: one block of 128 threads per (head, destination row): 400 blocks
// at the flagship's shapes. A head's slice of a position is VP 16-byte
// vectors (VP a power of two <= 32); VP neighbouring threads take one
// position, 128/VP positions per pass. The chain:
//   1. the block converts its head's slice of the new K and V rows into the
//      write plane (no dependence on idx, so it overlaps the index load);
//   2. every thread loads its K AND V vectors of the window at once: into
//      registers when the window is at most four passes (fp8 Dh 64: pos <=
//      128, the flagship's ctx 68), otherwise V goes by cp.async into
//      dynamic shared memory (up to 448 x 64 B in fp8, 448 x 128 B in bf16)
//      while K streams through registers four passes at a time. Each copy
//      to the write plane is stored as soon as its bytes are in;
//   3. the scores (dot products reduced over the VP threads by shuffles)
//      go to shared memory; one barrier;
//   4. every warp reduces the max over all scores, then l, by shuffles on
//      its own (no block barrier), in the same two-pass order as the plain
//      version, so the weights rounded to q's dtype match;
//   5. the weighted V sum from registers or shared memory, the position
//      groups' partial sums through shared memory; one barrier; the self
//      term merged.
// Two barriers (the parent: six, and the V loads after the softmax). No two
// blocks write the same bytes, and duplicate source rows are only read, so
// there is no race. An index outside [0, BK) traps (no host check, so no
// sync). The params are read with constant indices only: an index from
// blockIdx would put the whole struct on every thread's stack (ptxas
// reports it in phase 2 of chip_smoke.py).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (whisper_tpu_torch/ops/build.py).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "store_cast.cuh"  // load, float_to_e4m3, dtype codes

namespace {

constexpr int kThreads = 128;
constexpr int kRegPasses = 4;  // window passes held in registers
constexpr int kMaxDh = 512;    // a head's slice is at most 512 bytes
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  uint8_t* planes[2];      // K, V: [2, L, BK, ctx, HD] storage dtype
  const uint8_t* rows[2];  // new K, V rows
  int64_t row_stride[2];   // bytes between new rows
  int64_t elem_stride[2];  // elements between a new row's elements
  const int* idx;
  const void* q;           // [BK, HD] compute dtype, contiguous
  void* out;               // [BK, HD] compute dtype
  int n_layer, bk, ctx, hd, n_head, layer, pos, parity, row_dtype, row_itemsize;
  bool e4m3_saturates;     // the installed PyTorch's e4m3 overflow rule (store_cast.cuh)
  float scale;
};

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

// Element i of a new row (dtype `src`, at `in` with element stride
// `stride`) stored into `out` in the storage type S, bitwise as `.to()`
// (store_cast.cuh's conversions); returns the stored value in f32 for the
// self term. One element per thread: store_cast's row loop, eight elements
// deep for K2's whole rows, would cost more issue slots than the block's
// 64-element slice is worth on K3's critical path.
template <typename S>
__device__ __forceinline__ float store_new(const uint8_t* in, int64_t stride, int src, S* out, int i,
                                           bool saturates) {
  using namespace store_cast;
  constexpr int D = sizeof(S) == 1 ? kE4M3 : sizeof(S) == 2 ? kBF16 : kF32;
  if (src == D) {  // already in the storage dtype: raw bytes
    const S x = reinterpret_cast<const S*>(in)[i * stride];
    out[i] = x;
    return to_float(x);
  }
  float x;
  switch (src) {
    case kF32: x = load<kF32>(in, i * stride); break;
    case kBF16: x = load<kBF16>(in, i * stride); break;
    case kF16: x = load<kF16>(in, i * stride); break;
    default: __trap();  // the wrapper refuses every other pair
  }
  if constexpr (D == kE4M3) {
    const uint8_t b = float_to_e4m3(x, saturates);
    out[i] = b;
    return to_float(b);
  } else if constexpr (D == kBF16) {
    const uint16_t b = __bfloat16_as_ushort(__float2bfloat16(x));
    out[i] = b;
    return to_float(b);
  } else {
    out[i] = x;
    return x;
  }
}

// q . k over one 16-byte vector of K, in f32, K rounded to q's dtype.
template <typename S, bool kBf16>
__device__ __forceinline__ float dot(const uint4& raw, const float* qv) {
  constexpr int E = 16 / sizeof(S);
  const S* el = reinterpret_cast<const S*>(&raw);
  float part = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) part = fmaf(round_c<kBf16>(to_float(el[e])), qv[e], part);
  return part;
}

template <typename S, bool kBf16>
__device__ __forceinline__ void accumulate(const uint4& raw, float w, float* acc) {
  constexpr int E = 16 / sizeof(S);
  const S* el = reinterpret_cast<const S*>(&raw);
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = fmaf(w, round_c<kBf16>(to_float(el[e])), acc[e]);
}

// kSmemV: V's window goes through dynamic shared memory (more than
// kRegPasses passes); otherwise K and V are held in registers.
template <typename S, bool kBf16, bool kSmemV>
__global__ void __launch_bounds__(kThreads)
    gather_attend_kernel(const __grid_constant__ Args a) {
  constexpr int E = 16 / sizeof(S);  // elements per 16-byte vector
  extern __shared__ uint4 dyn[];     // [pos] scores (padded to 16 B), then V's window
  __shared__ float red[kThreads / 32 * kMaxDh];  // the warps' value sums: [warp][Dh]
  __shared__ float self_k[kMaxDh], self_v[kMaxDh];  // the stored new rows, in f32

  const int h = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
  const int pos = a.pos;
  const int dh = a.hd / a.n_head;
  const int vp = dh / E;          // vectors of one head's slice of a position
  const int pp = kThreads / vp;   // positions per pass
  const int j = t % vp, pg = t / vp;
  const int row_vecs = a.hd / E;  // vectors per position
  const int n_pass = (pos + pp - 1) / pp;
  float* sc = reinterpret_cast<float*>(dyn);
  uint4* vs = dyn + (pos + 3) / 4;  // [pos][vp] V vectors (kSmemV)
  uint4* ck = reinterpret_cast<uint4*>(a.planes[0]);
  uint4* cv = reinterpret_cast<uint4*>(a.planes[1]);
  const int64_t cache_row = (int64_t)a.ctx * row_vecs;
  const int64_t dst_base =
      (((int64_t)(1 - a.parity) * a.n_layer + a.layer) * a.bk + b) * cache_row + (int64_t)h * vp;
  const int64_t head0 = (int64_t)b * a.hd + (int64_t)h * dh;  // element offset of this head

  // 1. The source row and q: the head of the chain, loaded first (a load
  // after a store through another pointer is not hoisted above it).
  const int src = a.idx[b];
  float qv[E];
#pragma unroll
  for (int e = 0; e < E; ++e) qv[e] = load_c<kBf16>(a.q, head0 + j * E + e);
  if (src < 0 || src >= a.bk) __trap();
  const int64_t src_base =
      (((int64_t)a.parity * a.n_layer + a.layer) * a.bk + src) * cache_row + (int64_t)h * vp;

  // 2. The window: K and V loads issued together (V by cp.async past
  // kRegPasses passes), then the new rows, then the copies.
  if (kSmemV) {
    for (int p = pg; p < pos; p += pp) cp_async16(vs + p * vp + j, cv + src_base + (int64_t)p * row_vecs + j);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  uint4 kr[kRegPasses], vr[kRegPasses];
#pragma unroll
  for (int i = 0; i < kRegPasses; ++i) {
    const int p = i * pp + pg;
    if (p < pos) {
      kr[i] = ck[src_base + (int64_t)p * row_vecs + j];
      if (!kSmemV) vr[i] = cv[src_base + (int64_t)p * row_vecs + j];
    }
  }
  // The new rows' head slice, converted into the write plane at pos (K by
  // threads [0, Dh), V by [Dh, 2 Dh) and so on), their values kept for the
  // self term.
  const int64_t self_vec = dst_base + (int64_t)pos * row_vecs;
  for (int i = t; i < 2 * dh; i += kThreads) {
    const bool v = i >= dh;
    const int d = v ? i - dh : i;
    const uint8_t* in = (v ? a.rows[1] + b * a.row_stride[1] : a.rows[0] + b * a.row_stride[0]) +
                        (int64_t)h * dh * (v ? a.elem_stride[1] : a.elem_stride[0]) * a.row_itemsize;
    const float x = store_new(in, v ? a.elem_stride[1] : a.elem_stride[0], a.row_dtype,
                              reinterpret_cast<S*>(v ? cv + self_vec : ck + self_vec), d, a.e4m3_saturates);
    (v ? self_v : self_k)[d] = x;
  }
  for (int i0 = 0; i0 < n_pass; i0 += kRegPasses) {  // one batch unless kSmemV
    if (i0 > 0) {
#pragma unroll
      for (int i = 0; i < kRegPasses; ++i) {
        const int p = (i0 + i) * pp + pg;
        if (p < pos) kr[i] = ck[src_base + (int64_t)p * row_vecs + j];
      }
    }
#pragma unroll
    for (int i = 0; i < kRegPasses; ++i) {
      const int p = (i0 + i) * pp + pg;
      if (p < pos) {
        ck[dst_base + (int64_t)p * row_vecs + j] = kr[i];
        if (!kSmemV) cv[dst_base + (int64_t)p * row_vecs + j] = vr[i];
      }
    }
    // 3. The scores, reduced over the VP threads of a position.
#pragma unroll
    for (int i = 0; i < kRegPasses; ++i) {
      if (i0 + i >= n_pass) break;  // uniform over the block: every lane reaches the shuffles
      const int p = (i0 + i) * pp + pg;
      float part = p < pos ? dot<S, kBf16>(kr[i], qv) : 0.f;
      for (int o = vp / 2; o > 0; o >>= 1) part += __shfl_xor_sync(kFull, part, o);
      if (p < pos && j == 0) sc[p] = part * a.scale;
    }
  }
  if (kSmemV) asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();  // scores, V's window in shared memory, the new rows' values: visible
  if (kSmemV)
    for (int p = pg; p < pos; p += pp) cv[dst_base + (int64_t)p * row_vecs + j] = vs[p * vp + j];

  // The self score: every thread's slice of q against the stored new K row,
  // reduced over the VP threads (each position group holds it whole).
  float s_self = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) s_self = fmaf(qv[e], self_k[j * E + e], s_self);
  for (int o = vp / 2; o > 0; o >>= 1) s_self += __shfl_xor_sync(kFull, s_self, o);
  s_self *= a.scale;

  // 4. Max first, then l (two passes, as the plain version), each warp alone.
  float m = -INFINITY;
  for (int p = t & 31; p < pos; p += 32) m = fmaxf(m, sc[p]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
  float l = 0.f;
  for (int p = t & 31; p < pos; p += 32) l += expf(sc[p] - m);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(kFull, l, o);

  // 5. weight * v summed in f32, the weights rounded to q's dtype.
  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;
  if (kSmemV) {
    for (int p = pg; p < pos; p += pp)
      accumulate<S, kBf16>(vs[p * vp + j], round_c<kBf16>(expf(sc[p] - m)), acc);
  } else {
#pragma unroll
    for (int i = 0; i < kRegPasses; ++i) {
      const int p = i * pp + pg;
      if (p < pos) accumulate<S, kBf16>(vr[i], round_c<kBf16>(expf(sc[p] - m)), acc);
    }
  }
  // The position groups' sums: by shuffles over the groups of a warp (lane
  // bits above VP's), then the warps' through shared memory.
  for (int o = 16; o >= vp; o >>= 1) {  // E independent shuffles per level
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] += __shfl_xor_sync(kFull, acc[e], o);
  }
  const int warp = t >> 5;
  if ((t & 31) < vp) {
#pragma unroll
    for (int e = 0; e < E; ++e) red[warp * dh + j * E + e] = acc[e];
  }
  __syncthreads();

  const float m2 = fmaxf(m, s_self);
  const float alpha = expf(m - m2);  // 0 exactly when pos == 0 (m = -inf)
  const float beta = expf(s_self - m2);
  const float denom = l * alpha + beta;
  for (int d = t; d < dh; d += kThreads) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) sum += red[w * dh + d];
    store_c<kBf16>(a.out, head0 + d, (sum * alpha + beta * self_v[d]) / denom);
  }
}

template <typename S, bool kBf16>
cudaError_t launch(const Args& a, int device, cudaStream_t stream) {
  constexpr int E = 16 / sizeof(S);
  const int vp = a.hd / a.n_head / E;
  const int n_pass = (a.pos + kThreads / vp - 1) / (kThreads / vp);
  const size_t sc_bytes = (size_t)((a.pos + 3) / 4) * 16 + 16;
  const dim3 grid((unsigned)a.n_head, (unsigned)a.bk);
  if (n_pass <= kRegPasses) {
    gather_attend_kernel<S, kBf16, false><<<grid, kThreads, sc_bytes, stream>>>(a);
    return cudaGetLastError();
  }
  const size_t smem = sc_bytes + (size_t)a.pos * vp * 16;
  static bool opted_in[64] = {false};  // the window may pass 48 KB: opt in once per device
  if (smem > 48 * 1024 && device >= 0 && device < 64 && !opted_in[device]) {
    int max_optin = 0;
    cudaError_t err = cudaDeviceGetAttribute(&max_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(gather_attend_kernel<S, kBf16, true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 max_optin - (int)((kThreads / 32 + 2) * kMaxDh * sizeof(float)));
    if (err != cudaSuccess) return err;
    opted_in[device] = true;
  }
  gather_attend_kernel<S, kBf16, true><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Dtype codes are store_cast.cuh's: the planes 3 (float8_e4m3fn), 1
// (bfloat16) or 0 (float32); q and attn 1 or 0; the new rows any code the
// conversion takes from them into the planes (the wrapper checks the
// pair). Row strides in bytes, element strides in elements of the rows'
// dtype. Returns the cudaError of the launch.
extern "C" int gather_attend(void* ck, void* cv, const void* k_new, const void* v_new,
                             int64_t k_row_stride, int64_t k_elem_stride, int64_t v_row_stride,
                             int64_t v_elem_stride, int row_dtype, int row_itemsize,
                             int storage_dtype, int e4m3_saturates, const int* idx, const void* q,
                             void* out, int compute_dtype, int n_layer, int bk, int ctx, int hd,
                             int n_head, int layer, int pos, int parity, float scale, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Args a;
  a.planes[0] = static_cast<uint8_t*>(ck);
  a.planes[1] = static_cast<uint8_t*>(cv);
  a.rows[0] = static_cast<const uint8_t*>(k_new);
  a.rows[1] = static_cast<const uint8_t*>(v_new);
  a.row_stride[0] = k_row_stride;
  a.elem_stride[0] = k_elem_stride;
  a.row_stride[1] = v_row_stride;
  a.elem_stride[1] = v_elem_stride;
  a.idx = idx;
  a.q = q;
  a.out = out;
  a.n_layer = n_layer;
  a.bk = bk;
  a.ctx = ctx;
  a.hd = hd;
  a.n_head = n_head;
  a.layer = layer;
  a.pos = pos;
  a.parity = parity;
  a.row_dtype = row_dtype;
  a.row_itemsize = row_itemsize;
  a.e4m3_saturates = e4m3_saturates != 0;
  a.scale = scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bf16 = compute_dtype == store_cast::kBF16;
  if (!bf16 && compute_dtype != store_cast::kF32) return (int)cudaErrorInvalidValue;
  switch (storage_dtype) {
    case store_cast::kE4M3:
      return (int)(bf16 ? launch<uint8_t, true>(a, device, s) : launch<uint8_t, false>(a, device, s));
    case store_cast::kBF16:
      return (int)(bf16 ? launch<uint16_t, true>(a, device, s) : launch<uint16_t, false>(a, device, s));
    case store_cast::kF32:
      return (int)(bf16 ? launch<float, true>(a, device, s) : launch<float, false>(a, device, s));
    default:
      return (int)cudaErrorInvalidValue;
  }
}
