// Pending beam permutation plus append on the ping-pong KV planes (K2),
// and the same on one data shard of a mesh (K2′).
//
// K2 replaces: whisper_tpu/ops/fused_step.py:628 `permute_append` (the
// Pallas grouped-DMA kernel `_dma_kernel`, :532, plus the append by
// dynamic-update-slice of the rows cast to the storage dtype, :720-733).
// For one decoder layer, for K and V:
//
//   plane[1-parity][layer][r][0:pos] = plane[parity][layer][idx[r]][0:pos]
//   plane[1-parity][layer][r][pos]   = new_rows[r].to(storage dtype)
//
// on caches [2, L, BK, ctx, HD] (HD = H*Dh) in the storage dtype. The
// window is moved as raw bytes. The new rows come as the caller has them
// (f32, bf16 or f16, any row and element strides, or already in the
// storage dtype) and are converted as they are stored, bitwise as
// PyTorch's `.to()` (store_cast.cuh), so one launch does the whole layer.
// Only the window [0, pos] of the write plane is defined afterwards (the
// JAX kernel copies whole rows; its contract leaves positions past pos
// unspecified too, and every reader reads [0, pos] only).
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
// lax.rem both truncate), done in the block that loads the index.
//
// Bound: bytes, 2 (K and V) x HD x (n_src * pos * itemsize + BK * (pos + 1)
// * itemsize + BK * row itemsize): each distinct source row's window read
// once (a repeated row is served from L2), every destination window and
// new row written once, the new rows read once. At large-v3 beam 5 batch 4
// in fp8 (BK = 20, HD = 1280) that is about 3 MB at pos 35, under a
// microsecond at 3.35 TB/s, so one launch per layer and step is what
// costs; at pos 440, near the end of the 448-token text context, about
// 37 MB, 11 us.
//
// Design: grid (chunks of the window + 1, BK destination rows, 2 for K and
// V). Each block but the last along x copies one 8 KB chunk of a
// destination row's window [0, pos) with 16-byte vectors, the body K4
// shares (row_copy.cuh); the last one stores the new row at pos,
// converting it, so the append neither waits for a copy nor holds one up.
// Hopper's 1-D bulk copies (global -> shared -> global on mbarriers, 8-32
// KB chunks sized to the card) and a body with four vectors in flight per
// thread were both built and timed over pos 35-440 of the 448-token
// context: neither beat this body on the copy alone (PERF.md §6). The
// params are read with constant indices only: an index from blockIdx puts
// the whole struct on every thread's stack, which made the kernel 1.6-2.7x
// slower on the H100. A block reads its own source index (K2′: localises
// it first); an index outside [0, BK) traps, which surfaces as a CUDA
// error at the next synchronising call, as PyTorch's own device-side index
// checks do (a host-side check would cost a synchronisation per launch).
// K2 and K2′ are two __global__ functions over one body, so a profiler
// trace tells them apart.
//
// Device position (K2 only): a decode step captured as a CUDA graph fixes
// its launch arguments at capture, so the entry may instead take a
// pointer to the position as an int64 on the card. The grid then covers
// the longest window the planes hold ([0, ctx - 1)), every block reads the
// position, and the blocks past the window copy nothing; a position
// outside [0, ctx) traps. The bytes moved are those of the launch-argument
// form at the same position.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (whisper_tpu_torch/ops/build.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "row_copy.cuh"
#include "store_cast.cuh"

namespace {

struct Args {
  uint8_t* planes[2];        // K, V: [2, L, BK, ctx, HD] storage dtype
  const uint8_t* rows[2];    // new K, V rows
  int64_t row_stride[2];     // bytes between new rows
  int64_t elem_stride[2];    // elements between a new row's elements
  int n_layer, bk, ctx, hd, row_bytes, layer, pos, parity, row_dtype, storage_dtype;
  bool e4m3_saturates;       // the installed PyTorch's e4m3 overflow rule (store_cast.cuh)
};

// Block (chunk blockIdx.x, destination row blockIdx.y, K or V blockIdx.z)
// with local source row `src`, the new rows at `pos`.
__device__ __forceinline__ void permute_append_block(const Args& a, int src, int pos) {
  if (src < 0 || src >= a.bk) __trap();
  const int r = blockIdx.y;
  // K or V by constant indices: an index from blockIdx would put the whole
  // parameter struct on the stack of every thread.
  const bool v = blockIdx.z != 0;
  uint8_t* plane = v ? a.planes[1] : a.planes[0];
  const int64_t plane_row = (int64_t)a.ctx * a.row_bytes;
  uint8_t* dst = plane + (((int64_t)(1 - a.parity) * a.n_layer + a.layer) * a.bk + r) * plane_row;
  if (blockIdx.x + 1 < gridDim.x) {  // a chunk of the window [0, pos)
    const uint8_t* from = plane + (((int64_t)a.parity * a.n_layer + a.layer) * a.bk + src) * plane_row;
    row_copy::copy_chunk(reinterpret_cast<const uint4*>(from), reinterpret_cast<uint4*>(dst),
                         (int64_t)blockIdx.x * row_copy::kChunkVecs, (int64_t)pos * a.row_bytes / 16);
    return;
  }
  const store_cast::Row row{
      v ? a.rows[1] + r * a.row_stride[1] : a.rows[0] + r * a.row_stride[0],
      v ? a.elem_stride[1] : a.elem_stride[0], dst + (int64_t)pos * a.row_bytes, a.hd,
      (int)threadIdx.x, row_copy::kThreads, a.e4m3_saturates};
  store_cast::store_row(a.row_dtype, a.storage_dtype, row);
}

// K2: idx holds local source rows; the position is a.pos, or *pos_at
// where that is not NULL.
__global__ void __launch_bounds__(row_copy::kThreads)
    permute_append_kernel(Args a, const int* __restrict__ idx, const int64_t* __restrict__ pos_at) {
  int pos = a.pos;
  if (pos_at != nullptr) {
    const int64_t p = *pos_at;
    if (p < 0 || p >= a.ctx) __trap();
    pos = (int)p;
  }
  permute_append_block(a, idx[blockIdx.y], pos);
}

// K2′: idx holds global source rows, made local here.
__global__ void __launch_bounds__(row_copy::kThreads)
    permute_append_sharded_kernel(Args a, const int* __restrict__ idx, int beam) {
  const int r = blockIdx.y;
  permute_append_block(a, (r / beam) * beam + idx[r] % beam, a.pos);
}

}  // namespace

// Row strides in bytes, element strides in elements of the row dtype;
// dtype codes and e4m3_saturates as store_cast.cuh. beam == 0 is K2, beam
// > 0 K2′ (bk is then the rank's row count, a multiple of beam; the
// wrapper checks). pos_at: NULL, or (K2 only) the position on the card,
// which replaces pos. Returns the cudaError of the launch.
extern "C" int permute_append(void* ck, void* cv, const void* k_new, const void* v_new,
                              int64_t k_row_stride, int64_t k_elem_stride, int64_t v_row_stride,
                              int64_t v_elem_stride, int row_dtype, int storage_dtype,
                              int e4m3_saturates, const int* idx, int n_layer, int bk,
                              int ctx, int hd, int itemsize, int layer, int pos, int parity,
                              int beam, int device, void* stream, const int64_t* pos_at) {
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
  a.n_layer = n_layer;
  a.bk = bk;
  a.ctx = ctx;
  a.hd = hd;
  a.row_bytes = hd * itemsize;
  a.layer = layer;
  a.pos = pos;
  a.parity = parity;
  a.row_dtype = row_dtype;
  a.storage_dtype = storage_dtype;
  a.e4m3_saturates = e4m3_saturates != 0;
  if (pos_at != nullptr && beam != 0) return (int)cudaErrorInvalidValue;
  const int64_t window = pos_at != nullptr ? ctx - 1 : pos;  // the longest window copied
  const int64_t chunks = row_copy::chunks(window * a.row_bytes / 16);
  const dim3 grid((unsigned)(chunks + 1), (unsigned)bk, 2);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (beam == 0) permute_append_kernel<<<grid, row_copy::kThreads, 0, s>>>(a, idx, pos_at);
  else permute_append_sharded_kernel<<<grid, row_copy::kThreads, 0, s>>>(a, idx, beam);
  return (int)cudaGetLastError();
}
