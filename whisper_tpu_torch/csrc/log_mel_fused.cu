// Fused log-mel frontend for the fixed 30 s window (K5).
//
// Replaces: whisper_tpu/frontend/mel_pallas.py:102
// `log_mel_spectrogram_fused` (the Pallas kernel `_mel_kernel`, :89, on the
// constants of `_basis`, :64-86). For each utterance b and frame f of 3000:
//
//   frame[i]  = x[b][160 f + i] for i < 400, 0 past sample 480000
//   re, im    = frame . W[:, cos], frame . W[:, sin]    (windowed real DFT, 201 bins)
//   mel[m]    = sum_k (re_k^2 + im_k^2) * F[k][m]       (F: filterbank with the
//                                                        mirrored-bin fold pre-scaled)
//   out[b][m][f] = log10(max(mel[m], 1e-10))
//
// The per-utterance floor at max - 8 and the affine (x + 4) / 4 run after
// it in torch (whisper_tpu_torch/frontend/mel_fused.py), as JAX runs them
// in XLA after its Pallas call.
//
// Bound: operations. 3000 frames x (2*400*402 + 2*201*n_mels) flops per
// utterance: at [4, 480000] and 128 mels, 4.5 GFLOP, 0.067 ms at the
// H100's 67 TFLOP/s of float32 outside the tensor cores; its 13.8 MB move
// in 0.004 ms. The arithmetic is f32 FMA on the CUDA cores, not TF32: the
// DFT sums 400 windowed terms with cancellation in quiet bins, which a
// 10-bit mantissa would not hold to the 2e-4 contract.
//
// Design: one block of 256 threads per 32 frames of one utterance (94
// tiles, the last one ragged). The block stages its samples (32 * 160 +
// 240 floats, zeros past the end) in shared memory, then runs the DFT as a
// register-tiled SGEMM [32 x 400] x [400 x 448]: the basis (cos and sin, 201
// bins each padded to 224) streams through shared memory in chunks of 8
// rows; each thread owns 4 frames x 7 bins, cos and sin (56 sums), so the
// power needs no exchange. The power goes to shared memory (row stride 225:
// no bank conflicts), and the mel product gives each warp 32 consecutive
// frames of one mel, so the log10 stores coalesce (frames contiguous). Not
// yet used: tensor cores (3xTF32 or split bf16), cp.async double buffering
// of the basis.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (whisper_tpu_torch/ops/build.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kSamples = 480000;
constexpr int kHop = 160;
constexpr int kFft = 400;
constexpr int kFrames = 3000;
constexpr int kBins = 201;
constexpr int kBinPad = 224;          // 7 bins for each of 32 thread columns
constexpr int kCols = 2 * kBinPad;    // cos ++ sin
constexpr int kMelPad = 128;
constexpr int kTile = 32;             // frames per block
constexpr int kThreads = 256;
constexpr int kChunk = 8;             // basis rows per shared-memory chunk
constexpr int kStage = kTile * kHop + (kFft - kHop);  // 5360 samples
constexpr int kPowStride = kBinPad + 1;               // 225: conflict-free
constexpr int kBinsPerThread = kBinPad / 32;          // 7
constexpr int kFramesPerThread = kTile / (kThreads / 32);  // 4
constexpr int kMelsPerThread = kMelPad / (kThreads / 32);  // 16
constexpr int kBuf = kStage + kChunk * kCols;              // 8944 floats
static_assert(kTile * kPowStride <= kBuf, "the power tile reuses the staging buffer");
static_assert((kStage * 4) % 16 == 0, "the basis chunk must be 16-byte aligned");

__global__ void __launch_bounds__(kThreads, 2)
    log_mel_fused_kernel(const float* __restrict__ x, const float* __restrict__ basis,
                         const float* __restrict__ filt, float* __restrict__ out, int n_mels) {
  __shared__ __align__(16) float buf[kBuf];
  float* xs = buf;           // [kStage] samples of this tile
  float* ws = buf + kStage;  // [kChunk][kCols] basis chunk
  float* pw = buf;           // [kTile][kPowStride] power, after the DFT

  const int t = threadIdx.x;
  const int b = blockIdx.y;
  const int frame0 = blockIdx.x * kTile;
  const float* xb = x + (int64_t)b * kSamples;
  const int s0 = frame0 * kHop;
  for (int i = t; i < kStage; i += kThreads) {
    const int g = s0 + i;
    xs[i] = g < kSamples ? xb[g] : 0.f;
  }

  // DFT: thread (fg, bg) owns frames fg*4 .. fg*4+3 and bins bg + 32*jj.
  const int fg = t / 32, bg = t % 32;
  float acc[kFramesPerThread][kBinsPerThread][2];
#pragma unroll
  for (int r = 0; r < kFramesPerThread; ++r)
#pragma unroll
    for (int jj = 0; jj < kBinsPerThread; ++jj) acc[r][jj][0] = acc[r][jj][1] = 0.f;

  for (int k0 = 0; k0 < kFft; k0 += kChunk) {
    __syncthreads();  // the staging (first chunk) or the last chunk's reads are done
    const float4* src = reinterpret_cast<const float4*>(basis + (int64_t)k0 * kCols);
    float4* dst = reinterpret_cast<float4*>(ws);
    for (int i = t; i < kChunk * kCols / 4; i += kThreads) dst[i] = src[i];
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kChunk; ++kk) {
      float a[kFramesPerThread];
#pragma unroll
      for (int r = 0; r < kFramesPerThread; ++r)
        a[r] = xs[(fg * kFramesPerThread + r) * kHop + k0 + kk];  // one address per warp
      const float* wrow = ws + kk * kCols + bg;
#pragma unroll
      for (int jj = 0; jj < kBinsPerThread; ++jj) {
        const float c = wrow[32 * jj];
        const float s = wrow[kBinPad + 32 * jj];
#pragma unroll
        for (int r = 0; r < kFramesPerThread; ++r) {
          acc[r][jj][0] = fmaf(a[r], c, acc[r][jj][0]);
          acc[r][jj][1] = fmaf(a[r], s, acc[r][jj][1]);
        }
      }
    }
  }
  __syncthreads();  // every read of xs and ws is done: pw overwrites them
#pragma unroll
  for (int r = 0; r < kFramesPerThread; ++r)
#pragma unroll
    for (int jj = 0; jj < kBinsPerThread; ++jj) {
      const float re = acc[r][jj][0], im = acc[r][jj][1];
      pw[(fg * kFramesPerThread + r) * kPowStride + bg + 32 * jj] = re * re + im * im;
    }
  __syncthreads();

  // Mel product: thread (mg, f) owns frame f and mels mg + 8*jm.
  const int f = t % 32, mg = t / 32;
  float mel[kMelsPerThread];
#pragma unroll
  for (int jm = 0; jm < kMelsPerThread; ++jm) mel[jm] = 0.f;
  const float* prow = pw + f * kPowStride;
  for (int k = 0; k < kBins; ++k) {
    const float p = prow[k];
    const float* frow = filt + k * kMelPad + mg;
#pragma unroll
    for (int jm = 0; jm < kMelsPerThread; ++jm) mel[jm] = fmaf(p, __ldg(frow + 8 * jm), mel[jm]);
  }
  const int frame = frame0 + f;
  if (frame < kFrames) {
#pragma unroll
    for (int jm = 0; jm < kMelsPerThread; ++jm) {
      const int m = mg + 8 * jm;
      if (m < n_mels)
        out[((int64_t)b * n_mels + m) * kFrames + frame] = log10f(fmaxf(mel[jm], 1e-10f));
    }
  }
}

}  // namespace

// x [B, 480000] f32; basis [400, 448] f32; filt [201, 128] f32 (fold
// pre-scaled, mels past n_mels zero); out [B, n_mels, 3000] f32. Returns
// the cudaError of the launch.
extern "C" int log_mel_fused(const void* x, const void* basis, const void* filt, void* out,
                             int batch, int n_mels, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_mels < 1 || n_mels > kMelPad || batch < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((kFrames + kTile - 1) / kTile, (unsigned)batch);
  log_mel_fused_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(basis),
      static_cast<const float*>(filt), static_cast<float*>(out), n_mels);
  return (int)cudaGetLastError();
}
