// Fused log-mel frontend for the fixed 30 s window (K5).
//
// Replaces: whisper_tpu/frontend/mel_pallas.py:102
// `log_mel_spectrogram_fused` (the Pallas kernel `_mel_kernel`, :89, on the
// constants of `_basis`, :64-86). For each utterance b and frame f of 3000:
//
//   frame[n]  = x[b][160 f + n] * hann[n] for n < 400, 0 past sample 480000
//   X[k]      = sum_n frame[n] e^(-2 pi i n k / 400)     (201 bins, k <= 200)
//   mel[m]    = sum_k |X[k]|^2 F[k][m]                   (F: filterbank with the
//                                                         mirrored-bin fold pre-scaled)
//   out[b][m][f] = log10(max(mel[m], 1e-10))
//
// The per-utterance floor at max - 8 and the affine (x + 4) / 4 run after
// it in torch (whisper_tpu_torch/frontend/mel_fused.py), as JAX runs them
// in XLA after its Pallas call.
//
// Algorithm: a factorised real DFT, 400 = 20 x 20 (Cooley-Tukey, one
// level). With n = 20 n1 + n2 and k = k1 + 20 k2:
//
//   Y[k1][n2] = sum_n1 frame[20 n1 + n2] e^(-2 pi i n1 k1 / 20)          (stage 1)
//   X[k1 + 20 k2] = sum_n2 (Y[k1][n2] e^(-2 pi i n2 k1 / 400)) e^(-2 pi i n2 k2 / 20)
//                                                       (twiddle, then stage 2)
// Stage 1 reads real data, so it keeps only the Hermitian half, k1 <= 10
// (Y[20 - k1] = conj Y[k1]), and folds its input pairs n1, 20 - n1. Stage 2
// computes only the bins the power needs: for each k1 of 0..19 the k2 with
// k1 + 20 k2 <= 200, and folds its input pairs n2, 20 - n2 too. 20 x 20
// rather than 16 x 25: the two stages are equally long, both use the one
// 20-point table (kernel parameters, so every coefficient is a constant-bank
// operand of its FMA: the loops are unrolled and the indices are known at
// compile time), and 20 columns map onto 10 warps with no remainder.
//
// Operations per frame (FMA = 2): window 400; stage 1, 20 x 371 = 7,420;
// twiddle + stage 2, 19 x 926 + 1,003 = 18,597 (k1 = 0 and 10 run the
// complex path on real data); power inside that; mel product 2 x nnz
// (about 2 x 201: each bin lies in at most two triangles, with per-mel
// [lo, hi) ranges in place of the dense 201 x n_mels product); log 1 per
// mel. About 27.3k flops per frame against the dense DFT's 2 x 400 x 402 +
// 2 x 201 x n_mels (373k at 128 mels). `mel_fused.kernel_flops` counts it.
//
// Bound: bytes. [4, 480000] in and [4, 128, 3000] out is 13.8 MB, 0.0041 ms
// at 3.35 TB/s; the 0.33 GFLOP above need 0.0049 ms at 67 TFLOP/s of f32,
// and the function itself (a real FFT) less. The arithmetic is f32 FMA on
// the CUDA cores, not TF32: quiet bins are sums with cancellation that a
// 10-bit mantissa would not hold to the 2e-4 contract.
//
// Design: a persistent grid, one block of 320 threads (10 warps) per SM
// slot, walking the (utterance, tile of 32 frames) pairs; 94 tiles per
// utterance, the last one ragged. A tile's samples (32 x 160 + 240 floats,
// zeros past the end) arrive by cp.async (16 bytes, zero-filled past sample
// 480000) into one of two buffers while the block computes the previous
// tile. Lane = frame throughout, so every shared-memory access of the
// stages is 32 consecutive words:
//   1. the window is applied as the samples move into a [400][33] frame
//      tile (position-major, padded: the transposing writes hit 32 banks);
//   2. stage 1: warp w takes n2 = w and w + 10 of its 32 frames and writes
//      Y in place ([20 re/im rows][20 n2][33]);
//   3. stage 2: warp w takes k1 = w and 20 - w (warp 0: k1 = 0 and 10),
//      which read the same Y row; the twiddles of a warp's k1 are uniform
//      across its lanes (shared-memory broadcast); the power |X|^2 goes in
//      place to a [201][33] tile;
//   4. the mel product: warp w takes mels w, w + 10, ..., each over its
//      own [lo, hi) bins with uniform weights (broadcast), then log10 and
//      stores coalesced along frames.
// Seven barriers per tile. No atomics and nothing across frames: a frame's
// result does not depend on its batch or on the block that computes it, so
// an utterance alone equals its row in a batch bitwise. The constants (the
// window, the twiddles, the sparse filterbank, the 20-point table) are built
// on the host in float64 and rounded to f32 (frontend/mel_fused.py).
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
constexpr int kTile = 32;                              // frames per tile: one per lane
constexpr int kWarps = 10;
constexpr int kThreads = 32 * kWarps;
constexpr int kTilesPerUtt = (kFrames + kTile - 1) / kTile;  // 94
constexpr int kStage = kTile * kHop + (kFft - kHop);  // 5360 samples per tile
constexpr int kStageVecs = kStage / 4;                 // 1340 16-byte chunks
constexpr int kLd = kTile + 1;                         // 33: row stride of the tiles
constexpr int kWinSteps = kTile * kFft / kThreads;      // 40 window elements per thread
constexpr int kWinBatch = 8;
constexpr int kMelMax = 128;
constexpr int kMaxNnz = 416;                           // filterbank non-zeros, padded
// Table offsets (floats), as frontend/mel_fused.py packs them.
constexpr int kWinOff = 0;
constexpr int kTwCos = kFft;
constexpr int kTwSin = 2 * kFft;
constexpr int kMelW = 3 * kFft;
constexpr int kTable = kMelW + kMaxNnz;
static_assert(kStage % 4 == 0 && kSamples % 4 == 0, "16-byte chunks never straddle the end");
static_assert(kWinSteps * kThreads == kTile * kFft && kWinSteps % kWinBatch == 0, "whole window batches");

// cos and sin of 2 pi j / 20, j < 20: read with constant indices only.
struct Dft20 {
  float c[20];
  float s[20];
};

struct Smem {
  float raw[2][kStage];     // samples of this tile and of the next (cp.async)
  float tile[kFft * kLd];   // windowed frames -> Y -> power
  float table[kTable];      // window, twiddles, mel weights
  int mel_lo[kMelMax];
  int mel_off[kMelMax + 1];
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::); }

// Issue the copies of tile `tile`'s samples into `dst` (zeros past the end).
__device__ __forceinline__ void stage_tile(const float* __restrict__ x, int tile, float* dst) {
  const int b = tile / kTilesPerUtt;
  const int s0 = (tile % kTilesPerUtt) * kTile * kHop;
  const float* xb = x + (int64_t)b * kSamples;
  for (int c = threadIdx.x; c < kStageVecs; c += kThreads) {
    const int g = s0 + 4 * c;
    const bool in = g < kSamples;
    cp_async16(dst + 4 * c, in ? xb + g : xb, in ? 16 : 0);
  }
}

// Stage 2 for one k1 of one frame: twiddle the 20 values of Y's row (conj
// when k1 > 10), a 20-point DFT over n2 folded by pairs n2, 20 - n2, and the
// power of bins k1 + 20 k2, k2 < NK, into `pw` (row stride kLd).
template <int NK>
__device__ __forceinline__ void stage2(const Dft20& d, const float (&yr)[20], const float (&yi)[20],
                                       float conj, const float* tw_c, const float* tw_s, float* pw,
                                       int k1) {
  float zr[20], zi[20];
#pragma unroll
  for (int n = 0; n < 20; ++n) {  // Z = Y' W, W = c - i s, Y' = (yr, conj * yi)
    const float c = tw_c[n], s = tw_s[n], im = conj * yi[n];
    zr[n] = fmaf(yr[n], c, im * s);
    zi[n] = fmaf(im, c, -yr[n] * s);
  }
  float sr[10], si[10], dr[10], di[10];
#pragma unroll
  for (int n = 1; n < 10; ++n) {
    sr[n] = zr[n] + zr[20 - n];
    si[n] = zi[n] + zi[20 - n];
    dr[n] = zr[n] - zr[20 - n];
    di[n] = zi[n] - zi[20 - n];
  }
#pragma unroll
  for (int k2 = 0; k2 < NK; ++k2) {
    float re = (k2 & 1) ? zr[0] - zr[10] : zr[0] + zr[10];
    float im = (k2 & 1) ? zi[0] - zi[10] : zi[0] + zi[10];
#pragma unroll
    for (int n = 1; n < 10; ++n) {  // S cos - i D sin
      const int j = (n * k2) % 20;
      re = fmaf(sr[n], d.c[j], fmaf(di[n], d.s[j], re));
      im = fmaf(si[n], d.c[j], fmaf(-dr[n], d.s[j], im));
    }
    pw[(k1 + 20 * k2) * kLd] = fmaf(re, re, im * im);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    log_mel_fused_kernel(const float* __restrict__ x, const float* __restrict__ table,
                         const int* __restrict__ mel_ranges, float* __restrict__ out, int batch,
                         int n_mels, const __grid_constant__ Dft20 d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int t = threadIdx.x, f = t & 31, w = t >> 5;
  const int n_tiles = batch * kTilesPerUtt;

  for (int i = t; i < kTable; i += kThreads) sm.table[i] = table[i];
  for (int i = t; i < n_mels; i += kThreads) sm.mel_lo[i] = mel_ranges[i];
  for (int i = t; i <= n_mels; i += kThreads) sm.mel_off[i] = mel_ranges[n_mels + i];

  int buf = 0;
  if (blockIdx.x < n_tiles) stage_tile(x, blockIdx.x, sm.raw[0]);
  cp_async_commit();
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, buf ^= 1) {
    const int next = tile + gridDim.x;
    if (next < n_tiles) stage_tile(x, next, sm.raw[buf ^ 1]);
    cp_async_commit();
    cp_async_wait_one();  // this thread's copies of `tile` have landed
    __syncthreads();      // everyone's have; the last tile's reads of `tile[]` are done

    // 1. Window, into position-major frames.
    // Element i = t + 320 k (k < 40) is position n = i % 400 of frame
    // i / 400; eight loads go out before their stores (the two buffers
    // share one struct, so the compiler keeps the order it is given).
    const float* raw = sm.raw[buf];
    for (int k0 = 0, n = t, fr = 0; k0 < kWinSteps; k0 += kWinBatch) {
      float v[kWinBatch];
      int at[kWinBatch];
#pragma unroll
      for (int u = 0; u < kWinBatch; ++u) {
        v[u] = raw[fr * kHop + n] * sm.table[kWinOff + n];
        at[u] = n * kLd + fr;
        n += kThreads;
        if (n >= kFft) {
          n -= kFft;
          ++fr;
        }
      }
#pragma unroll
      for (int u = 0; u < kWinBatch; ++u) sm.tile[at[u]] = v[u];
    }
    __syncthreads();

    // 2. Stage 1, in place: frame f, columns n2 = w and w + 10.
    float xv[2][20];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int n1 = 0; n1 < 20; ++n1) xv[h][n1] = sm.tile[(20 * n1 + w + 10 * h) * kLd + f];
    __syncthreads();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n2 = w + 10 * h;
      float a[10], dd[10];
#pragma unroll
      for (int n = 1; n < 10; ++n) {
        a[n] = xv[h][n] + xv[h][20 - n];
        dd[n] = xv[h][n] - xv[h][20 - n];
      }
      const float even = xv[h][0] + xv[h][10], odd = xv[h][0] - xv[h][10];
#pragma unroll
      for (int k1 = 0; k1 <= 10; ++k1) {  // Re Y: rows 0..10
        float re = (k1 & 1) ? odd : even;
#pragma unroll
        for (int n = 1; n < 10; ++n) re = fmaf(a[n], d.c[(n * k1) % 20], re);
        sm.tile[(k1 * 20 + n2) * kLd + f] = re;
      }
#pragma unroll
      for (int k1 = 1; k1 < 10; ++k1) {  // Im Y: rows 11..19
        float im = dd[1] * d.s[k1 % 20];
#pragma unroll
        for (int n = 2; n < 10; ++n) im = fmaf(dd[n], d.s[(n * k1) % 20], im);
        sm.tile[((10 + k1) * 20 + n2) * kLd + f] = -im;
      }
    }
    __syncthreads();

    // 3. Twiddle + stage 2, in place: k1 = w and 20 - w (warp 0: 0 and 10).
    float yr[20], yi[20];
    const int ka = w, kb = w == 0 ? 10 : 20 - w;
#pragma unroll
    for (int n = 0; n < 20; ++n) {
      yr[n] = sm.tile[(w * 20 + n) * kLd + f];
      yi[n] = w == 0 ? sm.tile[(10 * 20 + n) * kLd + f] : sm.tile[((10 + w) * 20 + n) * kLd + f];
    }
    __syncthreads();
    float* pw = sm.tile + f;
    const float* twc = sm.table + kTwCos;
    const float* tws = sm.table + kTwSin;
    if (w == 0) {  // Y[0] and Y[10] are real: yi holds Y[10]'s real part
      float zero[20], y10[20];
#pragma unroll
      for (int n = 0; n < 20; ++n) {
        zero[n] = 0.f;
        y10[n] = yi[n];
      }
      stage2<11>(d, yr, zero, 1.f, twc, tws, pw, 0);
      stage2<10>(d, y10, zero, 1.f, twc + 10 * 20, tws + 10 * 20, pw, 10);
    } else {
      stage2<10>(d, yr, yi, 1.f, twc + ka * 20, tws + ka * 20, pw, ka);
      stage2<10>(d, yr, yi, -1.f, twc + kb * 20, tws + kb * 20, pw, kb);
    }
    __syncthreads();

    // 4. Sparse mel product, log10, coalesced stores along frames.
    const int b = tile / kTilesPerUtt;
    const int frame = (tile % kTilesPerUtt) * kTile + f;
    for (int m = w; m < n_mels; m += kWarps) {
      const int lo = sm.mel_lo[m], o0 = sm.mel_off[m], o1 = sm.mel_off[m + 1];
      float acc = 0.f;
      for (int o = o0; o < o1; ++o) acc = fmaf(sm.tile[(lo + o - o0) * kLd + f], sm.table[kMelW + o], acc);
      if (frame < kFrames) out[((int64_t)b * n_mels + m) * kFrames + frame] = log10f(fmaxf(acc, 1e-10f));
    }
  }
}

int grid_size(int device) {
  static int cached[64] = {0};
  if (device < 0 || device >= 64) return 0;
  if (cached[device] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess) return 0;
    if (cudaFuncSetAttribute(log_mel_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sizeof(Smem)) != cudaSuccess)
      return 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, log_mel_fused_kernel, kThreads,
                                                      sizeof(Smem)) != cudaSuccess || per_sm < 1)
      return 0;
    cached[device] = sms * per_sm;
  }
  return cached[device];
}

}  // namespace

// x [B, 480000] f32, 16-byte aligned; table [kTable] f32 (window, twiddle
// cos and sin [k1][n2], the mel weights of each mel's bins in order);
// mel_ranges int32 [lo[n_mels], offset[n_mels + 1]] into the weights;
// dft20 [40] f32 on the host (cos, then sin, of 2 pi j / 20); out [B,
// n_mels, 3000] f32. Returns the cudaError of the launch.
extern "C" int log_mel_fused(const void* x, const void* table, const void* mel_ranges,
                             const float* dft20, void* out, int batch, int n_mels, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_mels < 1 || n_mels > kMelMax || batch < 1) return (int)cudaErrorInvalidValue;
  const int slots = grid_size(device);
  if (slots == 0) return (int)cudaErrorInvalidConfiguration;
  Dft20 d;
  for (int j = 0; j < 20; ++j) {
    d.c[j] = dft20[j];
    d.s[j] = dft20[20 + j];
  }
  const int n_tiles = batch * kTilesPerUtt;
  const int grid = n_tiles < slots ? n_tiles : slots;
  log_mel_fused_kernel<<<grid, kThreads, sizeof(Smem), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(table),
      static_cast<const int*>(mel_ranges), static_cast<float*>(out), batch, n_mels, d);
  return (int)cudaGetLastError();
}
