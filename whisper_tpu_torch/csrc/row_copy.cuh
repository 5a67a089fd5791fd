// Gather core shared by K2's window (permute_append.cu) and K4
// (permute_rows.cu).
//
// Both kernels copy cache rows, selected by an index, as raw bytes: one
// block moves one chunk of one destination row with 16-byte vector loads
// and stores. A row is a run of contiguous 16-byte vectors; the wrappers
// check the alignment and raise where it does not hold. Nothing is
// converted, so every storage dtype (f32, bf16, fp8) moves alike.
//
// Bound: bytes. A permutation computes nothing: each byte of the window is
// read once and written once, so the least time is the window's bytes,
// twice, over the card's memory rate (3.35 TB/s on an H100 SXM). The design
// keeps many blocks in flight (a row is cut into chunks of kChunkVecs
// vectors) and every thread holds kUnroll independent 16-byte loads in
// registers before it stores them, so each SM has many loads outstanding.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace row_copy {

constexpr int kThreads = 256;                  // threads per block
constexpr int kUnroll = 2;                     // vectors in flight per thread
constexpr int kChunkVecs = kThreads * kUnroll;  // 8 KB per block

// Chunks needed to cover `n_vecs` vectors.
inline int64_t chunks(int64_t n_vecs) { return (n_vecs + kChunkVecs - 1) / kChunkVecs; }

// Copy the vectors [v0, v0 + kChunkVecs) ∩ [0, n) of a row. All loads are
// issued before the first store.
__device__ __forceinline__ void copy_chunk(const uint4* __restrict__ src, uint4* __restrict__ dst,
                                           int64_t v0, int64_t n) {
  uint4 buf[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int64_t v = v0 + threadIdx.x + (int64_t)u * kThreads;
    if (v < n) buf[u] = src[v];
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int64_t v = v0 + threadIdx.x + (int64_t)u * kThreads;
    if (v < n) dst[v] = buf[u];
  }
}

}  // namespace row_copy
