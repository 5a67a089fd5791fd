// fp8 -> bf16 streaming upcast of a contiguous plane (K6): dst[i] = bf16(src[i]).
//
// Replaces: tools/probe_cross.py:119 `dma_upcast` (Pallas `_dma_upcast_kernel`,
// :63, `pallas_call` :124), which streams one layer's cross K or V plane
// [B*H*Dh, Tk] fp8 through VMEM, two 64-row chunks in flight, and casts it
// to bf16 in an HBM scratch. In the port it is the `dmastage` formulation of
// the cross-attention probe (whisper_tpu_torch/utils/probe_cross.py), two
// launches per decoder layer.
//
// Every float8_e4m3fn and float8_e5m2 value is exact in half and in bf16,
// so the result equals `.to(torch.bfloat16)` bitwise; the NaN codes (e4m3fn
// 0x7F and 0xFF, e5m2's) come out NaN.
//
// Bound: bytes. n bytes read, 2n written: at the probe's shape [20480,
// 1500], 30.72 MB + 61.44 MB = 92.16 MB, 27.5 us at 3.35 TB/s. There is no
// arithmetic to speak of (one conversion instruction per pair).
//
// Design: none of the TPU kernel's structure (VMEM slots, DMA semaphores,
// chunks) carries over. A grid-stride loop over the flattened plane, one
// wave of resident blocks: each thread loads 16 fp8 values with one 16-byte
// load, converts them a pair at a time (fp8x2 -> half2 -> float2 -> bf162,
// every step exact) and writes two 16-byte stores. The elements past the
// last whole vector (fewer than 16) are converted one at a time by the
// first threads of block 0. The wrapper checks that src is 16-byte aligned
// and contiguous; dst is a fresh allocation. Not yet used: TMA bulk copies,
// more than one vector in flight per thread.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (whisper_tpu_torch/ops/build.py).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 2048 / kThreads;  // a full SM: one resident wave

// Two fp8 values (low byte first) -> two bf16 values (low half first).
template <__nv_fp8_interpretation_t kFmt>
__device__ __forceinline__ uint32_t cvt_pair(uint32_t pair) {
  const __half2 h(__nv_cvt_fp8x2_to_halfraw2(static_cast<__nv_fp8x2_storage_t>(pair), kFmt));
  const float2 f = __half22float2(h);
  const __nv_bfloat162 b = __floats2bfloat162_rn(f.x, f.y);
  return *reinterpret_cast<const uint32_t*>(&b);
}

template <__nv_fp8_interpretation_t kFmt>
__device__ __forceinline__ uint2 cvt_word(uint32_t w) {  // 4 fp8 -> 4 bf16
  return make_uint2(cvt_pair<kFmt>(w & 0xffffu), cvt_pair<kFmt>(w >> 16));
}

template <__nv_fp8_interpretation_t kFmt>
__global__ void __launch_bounds__(kThreads)
    fp8_upcast_kernel(const uint4* __restrict__ src, uint4* __restrict__ dst, int64_t n_vec,
                      int tail) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n_vec;
       i += stride) {
    const uint4 v = __ldg(src + i);
    const uint2 a = cvt_word<kFmt>(v.x), b = cvt_word<kFmt>(v.y);
    const uint2 c = cvt_word<kFmt>(v.z), d = cvt_word<kFmt>(v.w);
    dst[2 * i] = make_uint4(a.x, a.y, b.x, b.y);
    dst[2 * i + 1] = make_uint4(c.x, c.y, d.x, d.y);
  }
  if (blockIdx.x == 0 && threadIdx.x < tail) {
    const int64_t j = n_vec * 16 + threadIdx.x;
    const __half h(__nv_cvt_fp8_to_halfraw(reinterpret_cast<const uint8_t*>(src)[j], kFmt));
    reinterpret_cast<__nv_bfloat16*>(dst)[j] = __float2bfloat16_rn(__half2float(h));
  }
}

}  // namespace

// n elements; e5m2 != 0 reads float8_e5m2, else float8_e4m3fn. Returns the
// cudaError of the launch.
extern "C" int fp8_upcast(const void* src, void* dst, int64_t n, int e5m2, int device,
                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int n_sm = 0;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int64_t n_vec = n / 16;
  const int tail = static_cast<int>(n % 16);
  const int64_t need = (n_vec + kThreads - 1) / kThreads;
  const int64_t wave = static_cast<int64_t>(n_sm) * kBlocksPerSm;
  const unsigned grid = static_cast<unsigned>(need < 1 ? 1 : (need < wave ? need : wave));
  auto s = static_cast<cudaStream_t>(stream);
  auto in = static_cast<const uint4*>(src);
  auto out = static_cast<uint4*>(dst);
  if (e5m2) {
    fp8_upcast_kernel<__NV_E5M2><<<grid, kThreads, 0, s>>>(in, out, n_vec, tail);
  } else {
    fp8_upcast_kernel<__NV_E4M3><<<grid, kThreads, 0, s>>>(in, out, n_vec, tail);
  }
  return (int)cudaGetLastError();
}
