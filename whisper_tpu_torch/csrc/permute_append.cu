// Pending beam permutation plus append on the ping-pong KV planes (K2),
// and the same on one data shard of a mesh (K2′).
//
// K2 replaces: whisper_tpu/ops/fused_step.py:628 `permute_append` (the
// Pallas grouped-DMA kernel `_dma_kernel`, :532, plus the append by
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
// K2′ replaces: whisper_tpu/ops/fused_step.py:737 `permute_append_sharded`
// (shard_map over K2's kernel; the per-shard body :777-784). On a data
// mesh each rank's planes hold its BK/d rows, whole samples of `beam`
// rows each, and `idx` holds those rows' GLOBAL source rows. A beam
// permutation never crosses samples, so the local source row is the
// destination's sample base plus the source's slot:
//
//   src = (r / beam) * beam + idx[r] % beam
//
// the same integer operation as JAX's `(r//K)*K + rem(idx, K)` (C's % and
// lax.rem both truncate), done in the block that loads the index. The copy
// is K2's, byte for byte.
//
// Bound: bytes, 2 (K and V) x BK x (2*pos + 1) x HD x itemsize: the window
// read once, the window and the new row written once (fewer reads where
// rows repeat: a repeated source row is served from L2). At large-v3 beam
// 5 batch 4 in fp8 (BK = 20, HD = 1280) and pos = 36 that is 3.7 MB, about
// 1.1 us at 3.35 TB/s; a rank of a 2-way mesh moves half of it. One launch
// per layer per decode step, so launch latency weighs as much as the copy.
//
// Design: grid (chunks of the window, BK destination rows, 2 for K and V);
// each block copies one 8 KB chunk of one destination row with 16-byte
// vectors (row_copy.cuh). A block reads its own source index (K2′:
// localises it first); an index outside [0, BK) traps, which surfaces as a
// CUDA error at the next synchronising call, as PyTorch's own device-side
// index checks do (a host-side check would cost a synchronisation per
// launch). K2 and K2′ are two __global__ functions over one body, so a
// profiler trace tells them apart. Not yet used: cp.async or TMA bulk
// copies, and folding the per-layer launches of a step into one graph.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (whisper_tpu_torch/ops/build.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "row_copy.cuh"

namespace {

struct Planes {
  uint4* ck;
  uint4* cv;
  const uint4* k_new;
  const uint4* v_new;
  int n_layer, bk, ctx, row_vecs, layer, pos, parity;
};

// One chunk of destination row blockIdx.y of K (blockIdx.z == 0) or V,
// from local source row `src`.
__device__ __forceinline__ void permute_append_chunk(const Planes& p, int src) {
  const int r = blockIdx.y;
  const bool is_v = blockIdx.z != 0;
  if (src < 0 || src >= p.bk) __trap();
  uint4* planes = is_v ? p.cv : p.ck;
  const int64_t cache_row = (int64_t)p.ctx * p.row_vecs;  // vectors per [ctx, HD] row
  const uint4* src_row =
      planes + (((int64_t)p.parity * p.n_layer + p.layer) * p.bk + src) * cache_row;
  uint4* dst_row =
      planes + (((int64_t)(1 - p.parity) * p.n_layer + p.layer) * p.bk + r) * cache_row;
  const uint4* fresh = (is_v ? p.v_new : p.k_new) + (int64_t)r * p.row_vecs;
  const int64_t old_vecs = (int64_t)p.pos * p.row_vecs;
  row_copy::copy_chunk(src_row, fresh, old_vecs, dst_row,
                       (int64_t)blockIdx.x * row_copy::kChunkVecs, old_vecs + p.row_vecs);
}

// K2: idx holds local source rows.
__global__ void __launch_bounds__(row_copy::kThreads)
    permute_append_kernel(Planes p, const int* __restrict__ idx) {
  permute_append_chunk(p, idx[blockIdx.y]);
}

// K2′: idx holds global source rows, made local here.
__global__ void __launch_bounds__(row_copy::kThreads)
    permute_append_sharded_kernel(Planes p, const int* __restrict__ idx, int beam) {
  const int r = blockIdx.y;
  permute_append_chunk(p, (r / beam) * beam + idx[r] % beam);
}

// beam == 0: K2; beam > 0: K2′ with samples of `beam` rows.
int launch(void* ck, void* cv, const void* k_new, const void* v_new, const int* idx,
           int n_layer, int bk, int ctx, int row_vecs, int layer, int pos, int parity,
           int beam, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Planes p{static_cast<uint4*>(ck), static_cast<uint4*>(cv),
                 static_cast<const uint4*>(k_new), static_cast<const uint4*>(v_new),
                 n_layer, bk, ctx, row_vecs, layer, pos, parity};
  const int64_t n_chunks = row_copy::chunks((int64_t)(pos + 1) * row_vecs);
  const dim3 grid((unsigned)n_chunks, (unsigned)bk, 2);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (beam == 0) {
    permute_append_kernel<<<grid, row_copy::kThreads, 0, s>>>(p, idx);
  } else {
    permute_append_sharded_kernel<<<grid, row_copy::kThreads, 0, s>>>(p, idx, beam);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// row_vecs = HD * itemsize / 16. Each returns the cudaError of the launch.
extern "C" int permute_append(void* ck, void* cv, const void* k_new, const void* v_new,
                              const int* idx, int n_layer, int bk, int ctx, int row_vecs,
                              int layer, int pos, int parity, int device, void* stream) {
  return launch(ck, cv, k_new, v_new, idx, n_layer, bk, ctx, row_vecs, layer, pos, parity, 0,
                device, stream);
}

// bk is this rank's row count, a multiple of beam > 0 (the wrapper checks).
extern "C" int permute_append_sharded(void* ck, void* cv, const void* k_new, const void* v_new,
                                      const int* idx, int n_layer, int bk, int ctx,
                                      int row_vecs, int layer, int pos, int parity, int beam,
                                      int device, void* stream) {
  return launch(ck, cv, k_new, v_new, idx, n_layer, bk, ctx, row_vecs, layer, pos, parity,
                beam, device, stream);
}
