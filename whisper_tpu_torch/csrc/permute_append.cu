// Pending beam permutation plus append on the ping-pong KV planes (K2).
//
// Replaces: whisper_tpu/ops/fused_step.py:628 `permute_append` (the Pallas
// grouped-DMA kernel `_dma_kernel`, :532, plus the append by
// dynamic-update-slice, :720-733). For one decoder layer, for K and V:
//
//   plane[1-parity][layer][r][0:pos] = plane[parity][layer][idx[r]][0:pos]
//   plane[1-parity][layer][r][pos]   = new_rows[r]
//
// on caches [2, L, BK, ctx, HD] (HD = H*Dh) in the storage dtype, as raw
// bytes. The wrapper (whisper_tpu_torch/ops/fused_step.py) casts the new
// rows to the storage dtype first, so the kernel converts nothing. Only the
// window [0, pos] of the write plane is defined afterwards (the JAX kernel
// copies whole rows; its contract leaves positions past pos unspecified
// too, and every reader reads [0, pos] only).
//
// Bound: bytes, 2 (K and V) x BK x (2*pos + 1) x HD x itemsize: the window
// read once, the window and the new row written once. At large-v3 beam 5
// batch 4 in fp8 (BK = 20, HD = 1280) and pos = 36 that is 3.7 MB, about
// 1.1 us at 3.35 TB/s; one launch per layer per decode step, so launch
// latency weighs as much as the copy.
//
// Design: grid (chunks of the window, BK destination rows, 2 for K and V);
// each block copies one 8 KB chunk of one destination row with 16-byte
// vectors (row_copy.cuh). A block reads its own source index; an index
// outside [0, BK) traps, which surfaces as a CUDA error at the next
// synchronising call, as PyTorch's own device-side index checks do (a
// host-side check would cost a synchronisation per launch). Not yet used:
// cp.async or TMA bulk copies, and folding the per-layer launches of a
// step into one graph.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (whisper_tpu_torch/ops/build.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "row_copy.cuh"

namespace {

__global__ void __launch_bounds__(row_copy::kThreads)
    permute_append_kernel(uint4* ck, uint4* cv, const uint4* __restrict__ k_new,
                          const uint4* __restrict__ v_new, const int* __restrict__ idx,
                          int n_layer, int bk, int ctx, int row_vecs, int layer, int pos,
                          int parity) {
  const int r = blockIdx.y;
  const bool is_v = blockIdx.z != 0;
  uint4* planes = is_v ? cv : ck;
  const int src = idx[r];
  if (src < 0 || src >= bk) __trap();
  const int64_t cache_row = (int64_t)ctx * row_vecs;  // vectors per [ctx, HD] row
  const uint4* src_row =
      planes + (((int64_t)parity * n_layer + layer) * bk + src) * cache_row;
  uint4* dst_row = planes + (((int64_t)(1 - parity) * n_layer + layer) * bk + r) * cache_row;
  const uint4* fresh = (is_v ? v_new : k_new) + (int64_t)r * row_vecs;
  const int64_t old_vecs = (int64_t)pos * row_vecs;
  row_copy::copy_chunk(src_row, fresh, old_vecs, dst_row,
                       (int64_t)blockIdx.x * row_copy::kChunkVecs, old_vecs + row_vecs);
}

}  // namespace

// row_vecs = HD * itemsize / 16. Returns the cudaError of the launch.
extern "C" int permute_append(void* ck, void* cv, const void* k_new, const void* v_new,
                              const int* idx, int n_layer, int bk, int ctx, int row_vecs,
                              int layer, int pos, int parity, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int64_t n_chunks = row_copy::chunks((int64_t)(pos + 1) * row_vecs);
  dim3 grid((unsigned)n_chunks, (unsigned)bk, 2);
  permute_append_kernel<<<grid, row_copy::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(ck), static_cast<uint4*>(cv), static_cast<const uint4*>(k_new),
      static_cast<const uint4*>(v_new), idx, n_layer, bk, ctx, row_vecs, layer, pos, parity);
  return (int)cudaGetLastError();
}
