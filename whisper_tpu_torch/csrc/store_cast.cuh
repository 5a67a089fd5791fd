// Conversion of new cache rows to the cache's storage dtype, inside the
// kernel that stores them (K2, permute_append.cu; K3, gather_attend.cu).
//
// The result must be BITWISE what PyTorch's `tensor.to(storage_dtype)`
// gives on the card: the eager beam step writes its cache with `.to()`
// (models/decoder.py), and the hybrid step's K2 must store the same bytes
// so that the two step modes give equal tokens. So each conversion is the
// one PyTorch's CUDA cast runs:
//   - to bf16 and f16: the CUDA intrinsics `__float2bfloat16` and
//     `__float2half` (round to nearest even), as c10's BFloat16 and Half
//     constructors call them in device code;
//   - to float8_e4m3fn and float8_e5m2: c10's bit algorithm
//     (c10/util/Float8_e4m3fn.h and Float8_e5m2.h, or
//     torch/headeronly/util/ in newer releases), written out below: ties to
//     even, subnormals by one float addition, the sign kept. e5m2: NaN ->
//     0x7F, inf and |x| >= 65536 -> ±inf. e4m3's overflow changed between
//     PyTorch releases: up to 2.11 NaN, inf and every |x| > 464 (what
//     rounds past 448; 464 itself ties to even, 448) give ±NaN (0x7F);
//     later releases keep NaN but send
//     inf and that overflow to ±448 (0x7E). The wrapper reads the installed
//     release's rule from `.to()` once and passes it as `e4m3_saturates`.
//     `__nv_cvt_float_to_fp8` is not used: it has one overflow rule for
//     both formats, and c10 gives inf for e5m2's overflow where its
//     saturating mode gives the largest finite value.
// A source in bf16 or f16 is widened to f32 first (exact), as PyTorch's
// casts between float types go through float. A row already in the
// storage dtype is copied as raw bytes (`.to()` of the same dtype is the
// tensor itself).
//
// Dtype codes are those of whisper_tpu_torch/ops/fused_step.py
// (DTYPE_CODES); the wrapper refuses every pair this header does not take.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace store_cast {

enum Dtype : int { kF32 = 0, kBF16 = 1, kF16 = 2, kE4M3 = 3, kE5M2 = 4 };

__device__ __forceinline__ uint8_t float_to_e4m3(float f, bool saturates) {
  constexpr uint32_t kOverflow = 1087u << 20;  // 480.0f, the first value past e4m3's range
  constexpr uint32_t kDenorm = 141u << 23;     // ((127 - 7) + (23 - 3) + 1) << 23
  uint32_t bits = __float_as_uint(f);
  const uint32_t sign = bits & 0x80000000u;
  bits ^= sign;
  uint8_t out;
  if (bits >= kOverflow) {  // NaN stays NaN; inf and overflow to 448 or NaN
    out = bits > 0x7F800000u || !saturates ? 0x7F : 0x7E;
  } else if (bits < (121u << 23)) {  // below 2^-6, e4m3's smallest normal
    out = static_cast<uint8_t>(
        __float_as_uint(__fadd_rn(__uint_as_float(bits), __uint_as_float(kDenorm))) - kDenorm);
  } else {
    const uint32_t odd = (bits >> 20) & 1;  // ties to even
    bits += (static_cast<uint32_t>(7 - 127) << 23) + 0x7FFFFu + odd;
    out = static_cast<uint8_t>(bits >> 20);
    if (out == 0x7F && saturates) out = 0x7E;  // rounding up into the NaN pattern
  }
  return out | static_cast<uint8_t>(sign >> 24);
}

__device__ __forceinline__ uint8_t float_to_e5m2(float f) {
  constexpr uint32_t kInf = 255u << 23;
  constexpr uint32_t kOverflow = 143u << 23;  // 65536.0f
  constexpr uint32_t kDenorm = 134u << 23;    // ((127 - 15) + (23 - 2) + 1) << 23
  uint32_t bits = __float_as_uint(f);
  const uint32_t sign = bits & 0x80000000u;
  bits ^= sign;
  uint8_t out;
  if (bits >= kOverflow) {
    out = bits > kInf ? 0x7F : 0x7C;  // NaN; inf and overflow go to inf
  } else if (bits < (113u << 23)) {  // below 2^-14, e5m2's smallest normal
    out = static_cast<uint8_t>(
        __float_as_uint(__fadd_rn(__uint_as_float(bits), __uint_as_float(kDenorm))) - kDenorm);
  } else {
    const uint32_t odd = (bits >> 21) & 1;
    bits += (static_cast<uint32_t>(15 - 127) << 23) + 0xFFFFFu + odd;
    out = static_cast<uint8_t>(bits >> 21);
  }
  return out | static_cast<uint8_t>(sign >> 24);
}

template <int S>
__device__ __forceinline__ float load(const void* p, int64_t i) {
  if constexpr (S == kF32) return static_cast<const float*>(p)[i];
  if constexpr (S == kBF16)
    return __uint_as_float(static_cast<uint32_t>(static_cast<const uint16_t*>(p)[i]) << 16);
  if constexpr (S == kF16) return __half2float(static_cast<const __half*>(p)[i]);
  return 0.0f;
}

template <int D>
__device__ __forceinline__ void store(uint8_t* out, int i, float x, bool saturates) {
  if constexpr (D == kF32) reinterpret_cast<float*>(out)[i] = x;
  if constexpr (D == kBF16)
    reinterpret_cast<uint16_t*>(out)[i] = __bfloat16_as_ushort(__float2bfloat16(x));
  if constexpr (D == kF16) reinterpret_cast<uint16_t*>(out)[i] = __half_as_ushort(__float2half(x));
  if constexpr (D == kE4M3) out[i] = float_to_e4m3(x, saturates);
  if constexpr (D == kE5M2) out[i] = float_to_e5m2(x);
}

// A row's elements i·stride (i < n) of `in` converted into `out`; thread t
// of the nt threads that share the row takes the i with i % nt == t.
struct Row {
  const void* in;
  int64_t stride;  // in elements of the source dtype
  uint8_t* out;
  int n, t, nt;
  bool saturates;  // e4m3's overflow rule (above)
};

// Each thread issues the loads of a batch of kBatch elements before their
// stores: loop by loop, a store could alias the next load, and the row's
// round trips to memory would run one after another on the block's
// critical path.
constexpr int kBatch = 8;

template <int S, int D>
__device__ __forceinline__ void convert_row(const Row r) {
  for (int i0 = r.t; i0 < r.n; i0 += kBatch * r.nt) {
    float x[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (i0 + u * r.nt < r.n) x[u] = load<S>(r.in, (int64_t)(i0 + u * r.nt) * r.stride);
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (i0 + u * r.nt < r.n) store<D>(r.out, i0 + u * r.nt, x[u], r.saturates);
  }
}

template <typename T>
__device__ __forceinline__ void raw_row(const Row r) {
  for (int i0 = r.t; i0 < r.n; i0 += kBatch * r.nt) {
    T x[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (i0 + u * r.nt < r.n) x[u] = static_cast<const T*>(r.in)[(int64_t)(i0 + u * r.nt) * r.stride];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (i0 + u * r.nt < r.n) reinterpret_cast<T*>(r.out)[i0 + u * r.nt] = x[u];
  }
}

template <int S>
__device__ __forceinline__ void convert_from(int dst, const Row r) {
  switch (dst) {
    case kF32: convert_row<S, kF32>(r); break;
    case kBF16: convert_row<S, kBF16>(r); break;
    case kF16: convert_row<S, kF16>(r); break;
    case kE4M3: convert_row<S, kE4M3>(r); break;
    case kE5M2: convert_row<S, kE5M2>(r); break;
    default: __trap();
  }
}

// Row `r` in dtype `src` stored contiguously in dtype `dst`.
__device__ __forceinline__ void store_row(int src, int dst, const Row r) {
  if (src == dst) {  // already in the storage dtype: raw bytes
    if (src == kF32) raw_row<uint32_t>(r);
    else if (src == kBF16 || src == kF16) raw_row<uint16_t>(r);
    else raw_row<uint8_t>(r);
    return;
  }
  switch (src) {
    case kF32: convert_from<kF32>(dst, r); break;
    case kBF16: convert_from<kBF16>(dst, r); break;
    case kF16: convert_from<kF16>(dst, r); break;
    default: __trap();  // an fp8 row into another dtype: the wrapper refuses it
  }
}

}  // namespace store_cast
