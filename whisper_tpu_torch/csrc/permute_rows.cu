// Row permutation of a stacked cache (K4): out[l, n, :w] = x[l, idx[n], :w].
//
// Replaces: whisper_tpu/ops/gather.py:71 `permute_rows` (Pallas `_kernel`,
// :45, a block copy per (layer group, destination row) with the source row
// picked by a scalar-prefetched index). In the port it is the beam cache
// reorder of every CUDA tensor (decode/beam.py reorder_cache, step mode
// "off"). x and out are [L, N, ...] in any dtype; each row x[l, n] is a run
// of row_vecs contiguous 16-byte vectors, and the rows of both are reached
// through their own strides, so a window view cache[:, :, :w] is read and
// written without a copy. Duplicate indices are plain repeated reads; out
// must not overlap x (the wrapper checks).
//
// Bound: bytes, 2 x L x N x (row bytes): each row read once and written
// once. At large-v3 beam 5 batch 4 in fp8 (L = 32, N = 20, a window of 72
// positions of 1280 bytes, K and V) that is 118 MB per step, about 35 us
// at 3.35 TB/s.
//
// Design: grid (chunks of a row, N destination rows, L layers); each block
// copies one 8 KB chunk with 16-byte vectors (row_copy.cuh). An index
// outside [0, N) traps (see permute_append.cu). Not yet used: cp.async or
// TMA bulk copies.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (whisper_tpu_torch/ops/build.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "row_copy.cuh"

namespace {

__global__ void __launch_bounds__(row_copy::kThreads)
    permute_rows_kernel(const uint4* __restrict__ x, uint4* __restrict__ out,
                        const int* __restrict__ idx, int n_rows, int64_t x_stride0,
                        int64_t x_stride1, int64_t o_stride0, int64_t o_stride1,
                        int64_t row_vecs) {
  const int n = blockIdx.y;
  const int64_t l = blockIdx.z;
  const int src = idx[n];
  if (src < 0 || src >= n_rows) __trap();
  const uint4* src_row = x + l * x_stride0 + src * x_stride1;
  uint4* dst_row = out + l * o_stride0 + n * o_stride1;
  row_copy::copy_chunk(src_row, dst_row, (int64_t)blockIdx.x * row_copy::kChunkVecs, row_vecs);
}

}  // namespace

// Strides and row_vecs are in 16-byte vectors. Returns the cudaError of the
// launch.
extern "C" int permute_rows(const void* x, void* out, const int* idx, int n_layer,
                            int n_rows, int64_t x_stride0, int64_t x_stride1,
                            int64_t o_stride0, int64_t o_stride1, int64_t row_vecs,
                            int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)row_copy::chunks(row_vecs), (unsigned)n_rows, (unsigned)n_layer);
  permute_rows_kernel<<<grid, row_copy::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(out), idx, n_rows, x_stride0,
      x_stride1, o_stride0, o_stride1, row_vecs);
  return (int)cudaGetLastError();
}
