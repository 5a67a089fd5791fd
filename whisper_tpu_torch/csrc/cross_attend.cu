// Cross-attention of one decoder layer against its stored K/V, in one launch
// (ops/cross_attend.py):
//
//   S = (Q K) * scale          f32 sums of exact products, over the 64 dims
//   W = softmax(S) over all Tk  f32: row max, exp, sum, then W = e / sum,
//                               each weight rounded to bf16
//   O = W V^T                  f32 sums over Tk, rounded to bf16
//
// for each batch row b and head h: Q [Tq, 64] bf16 (a beam's K queries of
// T rows folded onto the row), K and V [64, Tk] in their stored layout
// [B, H, 64, Tk] and stored type (bf16, float8_e4m3fn or float8_e5m2).
//
// Replaces no TPU kernel: on the TPU, whisper_tpu/models/layers.py's
// cross_attention_T is two einsums that XLA fuses with the fp8 upcast into
// the operand loads. The port ran the same function as PyTorch ops, about
// nine kernels a layer: the fp8 upcast, an f32 copy of K, an f32 score
// product, scale, softmax, casts and a bf16 value product, which moved
// about six times the stored bytes (ROADMAP Queue 4 item 1).
//
// Arithmetic: that of the plain version, with only the order of sums
// changed. Every bf16, e4m3 and e5m2 value is exact in f32 and in TF32, so
// the products run on the tensor cores as TF32 (mma.sync m16n8k8) with f32
// sums: each product of two bf16 values is exact there, as it is in the
// plain version's f32 product. The weights are rounded to bf16 after the
// normalisation, where the plain version rounds them before its bf16 value
// product; the whole row of scores is held in shared memory, so no
// online-softmax rescaling rounds them elsewhere.
//
// Bound on an H100 SXM: bytes. At the flagship's step (16 rows, 5 queries a
// row, 20 heads, Tk 1500, fp8) a layer reads 2 * 16 * 20 * 64 * 1500 B =
// 61.4 MB, 18.3 us at 3.35 TB/s, against 2 * 16 * 20 * 8 * 1500 * 64 * 2 =
// 1 GFLOP of padded TF32 products. Prefills with long prompts (hundreds of
// queries a row) are bound by the products.
//
// Design: one block of 8 warps per (batch row, head, tile of 8 or 16
// queries); blocks of one (row, head) are adjacent in the grid, so a tile's
// re-read of K/V comes from L2. At 8 queries a tile the scores and Q take
// 50 KB of shared memory at Tk 1500, so the flagship's 320 blocks are all
// resident at once (three an SM, 80 registers a thread). Three passes:
//   1. scores: each warp takes 64 keys at a time and multiplies them over
//      all 64 dims. The tile's rows are keys permuted so that a lane reads
//      4 consecutive keys of a row of K per load, straight into registers
//      (no staging), as wide as the rows' alignment allows: a row of Tk
//      1500 starts 4-byte aligned in fp8 and 8-byte aligned in bf16, so
//      one 4- or 8-byte load a lane, 4 rows of 32 contiguous bytes a warp;
//      an odd Tk is read a key at a time. Q^T, the B operand, is read from
//      shared memory. Scaled scores go to shared memory.
//   2. softmax: one warp a query row: the max over the whole Tk, then
//      e = exp(s - max) in place of the scores and the row's sum.
//   3. values: O^T = V W^T, each warp 32 keys at a time (V rows are the
//      A operand, read as in pass 1; the weights, e / sum rounded to bf16
//      as they are read with 16-byte shared loads, are the B operand), all
//      64 dims; the 8 warps' partial sums are added in a fixed order
//      through shared memory and rounded once.
// The loads bound the kernel: each warp keeps two chunks of raw keys in
// registers (8 fp8 or bf16 segments each), both in flight while the one
// before them is multiplied, across groups of keys and ahead of the
// barriers (K's first two chunks before Q is staged, V's before the
// softmax); the normalisation runs in pass 3, under V's loads. Measured
// against alternatives on the card: one chunk at a time reads at 50% of
// the bound in the flagship's step, chunks of 16 fp8 segments spill.
// Keys past Tk are loaded as zeros (their loads skipped) and weigh zero.
// A launch allocates nothing and does not synchronise; it can be captured
// in a CUDA graph.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (whisper_tpu_torch/ops/build.py).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace xa {

constexpr int kDh = 64;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kKeys1 = 64;  // keys a warp scores at a time: 16 tile rows x 4 tiles
constexpr int kKeys3 = 32;  // keys a warp sums at a time: 4 k-steps of 8
constexpr int kSmemMax = 232448;  // shared bytes a block may opt in to on an H100

enum Store { kBf16 = 0, kE4m3 = 1, kE5m2 = 2 };

struct Args {
  const __nv_bfloat16* q;  // [B, Tq, H, 64], strides q_sb, q_st, q_sh (elements) and 1
  const uint8_t* k;        // [B, H, 64, Tk], the stored type
  const uint8_t* v;
  __nv_bfloat16* out;  // [B, Tq, H, 64]
  int64_t q_sb, q_st, q_sh;
  int tq, heads, tk;
  int pitch;    // floats in a row of scores: Tk rounded up to kKeys1
  int q_tiles;  // tiles of queries a (row, head)
  float scale;
};

// Four consecutive keys t..t+3 of one row, loaded KPL keys at a time (the
// wrapper picks KPL so that each load is aligned: Tk and the base are
// multiples of KPL keys). A load at or past tk is skipped and reads zero.
template <int S, int KPL>
__device__ __forceinline__ uint2 load4(const uint8_t* row, int t, int tk) {
  constexpr int IS = S == kBf16 ? 2 : 1;
  const uint8_t* p = row + t * IS;
  uint2 r = make_uint2(0u, 0u);
  if constexpr (KPL == 4) {
    if (t < tk) {
      if constexpr (IS == 1) {
        r.x = __ldg(reinterpret_cast<const unsigned int*>(p));
      } else {
        r = __ldg(reinterpret_cast<const uint2*>(p));
      }
    }
  } else if constexpr (KPL == 2) {
    if constexpr (IS == 1) {
      const unsigned short* p2 = reinterpret_cast<const unsigned short*>(p);
      const unsigned lo = t < tk ? __ldg(p2) : 0u;
      const unsigned hi = t + 2 < tk ? __ldg(p2 + 1) : 0u;
      r.x = lo | (hi << 16);
    } else {
      const unsigned int* p4 = reinterpret_cast<const unsigned int*>(p);
      r.x = t < tk ? __ldg(p4) : 0u;
      r.y = t + 2 < tk ? __ldg(p4 + 1) : 0u;
    }
  } else {
    unsigned e[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if constexpr (IS == 1) {
        e[j] = t + j < tk ? __ldg(p + j) : 0u;
      } else {
        e[j] = t + j < tk ? __ldg(reinterpret_cast<const unsigned short*>(p) + j) : 0u;
      }
    }
    if constexpr (IS == 1) {
      r.x = e[0] | (e[1] << 8) | (e[2] << 16) | (e[3] << 24);
    } else {
      r.x = e[0] | (e[1] << 16);
      r.y = e[2] | (e[3] << 16);
    }
  }
  return r;
}

// The four keys as f32 (exact; NaN codes stay NaN), lowest address first.
template <int S>
__device__ __forceinline__ float4 widen(uint2 r) {
  if constexpr (S == kBf16) {
    return make_float4(__uint_as_float(r.x << 16), __uint_as_float(r.x & 0xffff0000u),
                       __uint_as_float(r.y << 16), __uint_as_float(r.y & 0xffff0000u));
  } else {
    constexpr __nv_fp8_interpretation_t kFmt = S == kE4m3 ? __NV_E4M3 : __NV_E5M2;
    const float2 a = __half22float2(__half2(
        __nv_cvt_fp8x2_to_halfraw2(static_cast<__nv_fp8x2_storage_t>(r.x & 0xffffu), kFmt)));
    const float2 b = __half22float2(__half2(
        __nv_cvt_fp8x2_to_halfraw2(static_cast<__nv_fp8x2_storage_t>(r.x >> 16), kFmt)));
    return make_float4(a.x, a.y, b.x, b.y);
  }
}

__device__ __forceinline__ float at(const float4& f, int i) {
  return i == 0 ? f.x : i == 1 ? f.y : i == 2 ? f.z : f.w;
}

// c += A (16 x 8, row-major) B (8 x 8, column-major), TF32 operands, f32 sums.
__device__ __forceinline__ void mma(float (&c)[4], float a0, float a1, float a2, float a3,
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(__float_as_uint(a0)), "r"(__float_as_uint(a1)), "r"(__float_as_uint(a2)),
        "r"(__float_as_uint(a3)), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Fragment layouts of m16n8k8 (PTX ISA), lane = 4 g + c: A a0 (g, c),
// a1 (g + 8, c), a2 (g, c + 4), a3 (g + 8, c + 4); B b0 (k c, n g),
// b1 (k c + 4, n g); C c0 (g, 2c), c1 (g, 2c + 1), c2 (g + 8, 2c),
// c3 (g + 8, 2c + 1).
//
// Pass 1: tile i's row r (r < 16) is key t0 + 4 (r % 8) + 32 (r / 8) + i,
// so a lane's keys are ta .. ta + 3 (rows g) and tb .. tb + 3 (rows g + 8);
// k-step s spans dims 8s .. 8s + 7. A chunk is kKS k-steps: 8 segments
// (8 registers of raw fp8 keys, 16 of bf16).
constexpr int kKS = 2;
constexpr int kCH = 8 / kKS;  // chunks a group of 64 keys

template <int S, int KPL>
__device__ __forceinline__ void load1(uint2 (&raw)[kKS][4], const uint8_t* kp, int64_t row_bytes,
                                      int grp, int ch, int g, int c, int tk) {
  const int ta = grp * kKeys1 + 4 * g, tb = ta + 32;
#pragma unroll
  for (int j = 0; j < kKS; ++j) {
    const uint8_t* r0 = kp + (8 * (ch * kKS + j) + c) * row_bytes;  // dim 8s + c
    const uint8_t* r1 = r0 + 4 * row_bytes;                          // dim 8s + c + 4
    raw[j][0] = load4<S, KPL>(r0, ta, tk);
    raw[j][1] = load4<S, KPL>(r0, tb, tk);
    raw[j][2] = load4<S, KPL>(r1, ta, tk);
    raw[j][3] = load4<S, KPL>(r1, tb, tk);
  }
}

constexpr int kQPitch = 68;  // floats a row of Q in shared memory: 4 g + c spans the 32 banks

// acc[n][i] += the chunk's keys (tile i) times Q^T (queries 8n .. 8n + 7),
// Q^T's B operand read from sq [QT][kQPitch] (f32 bits).
template <int S, int QN>
__device__ __forceinline__ void mma1(float (&acc)[QN][4][4], const uint2 (&raw)[kKS][4],
                                     const uint32_t* sq, int ch, int g, int c) {
#pragma unroll
  for (int j = 0; j < kKS; ++j) {
    const int s = ch * kKS + j;
    const float4 a0 = widen<S>(raw[j][0]), a1 = widen<S>(raw[j][1]);
    const float4 a2 = widen<S>(raw[j][2]), a3 = widen<S>(raw[j][3]);
#pragma unroll
    for (int n = 0; n < QN; ++n) {
      const uint32_t* qr = sq + (8 * n + g) * kQPitch + 8 * s + c;
      const uint32_t b0 = qr[0], b1 = qr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) mma(acc[n][i], at(a0, i), at(a1, i), at(a2, i), at(a3, i), b0, b1);
    }
  }
}

// Pass 3: m-tile j holds dims 16j + g and 16j + g + 8; k-step s's column c
// is key t0 + 4c + s (ta + s), column c + 4 is key t0 + 16 + 4c + s
// (tb + s). A chunk is two m-tiles: 8 segments.
template <int S, int KPL>
__device__ __forceinline__ void load3(uint2 (&raw)[2][4], const uint8_t* vp, int64_t row_bytes,
                                      int grp, int ch, int g, int c, int tk) {
  const int ta = grp * kKeys3 + 4 * c, tb = ta + 16;
#pragma unroll
  for (int jj = 0; jj < 2; ++jj) {
    const uint8_t* r0 = vp + (16 * (2 * ch + jj) + g) * row_bytes;
    const uint8_t* r1 = r0 + 8 * row_bytes;
    raw[jj][0] = load4<S, KPL>(r0, ta, tk);
    raw[jj][1] = load4<S, KPL>(r1, ta, tk);
    raw[jj][2] = load4<S, KPL>(r0, tb, tk);
    raw[jj][3] = load4<S, KPL>(r1, tb, tk);
  }
}

// Normalised weights e / sum, each rounded to bf16 (kept as f32).
__device__ __forceinline__ float4 weights(float4 e, float sum) {
  return make_float4(__bfloat162float(__float2bfloat16_rn(e.x / sum)),
                     __bfloat162float(__float2bfloat16_rn(e.y / sum)),
                     __bfloat162float(__float2bfloat16_rn(e.z / sum)),
                     __bfloat162float(__float2bfloat16_rn(e.w / sum)));
}

template <int S, int QN>
__device__ __forceinline__ void mma3(float (&o)[QN][4][4], const uint2 (&raw)[2][4], int ch,
                                     const float4 (&wa)[QN], const float4 (&wb)[QN]) {
#pragma unroll
  for (int jj = 0; jj < 2; ++jj) {
    const float4 v0 = widen<S>(raw[jj][0]), v1 = widen<S>(raw[jj][1]);
    const float4 v2 = widen<S>(raw[jj][2]), v3 = widen<S>(raw[jj][3]);
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int n = 0; n < QN; ++n)
        mma(o[n][2 * ch + jj], at(v0, s), at(v1, s), at(v2, s), at(v3, s),
            __float_as_uint(at(wa[n], s)), __float_as_uint(at(wb[n], s)));
  }
}

// Shared memory: the scores [QT][pitch] (then e = exp(s - max)), Q as f32
// bits [QT][kQPitch] and the rows' sums [QT] after them; at the end the
// warps' partial sums [kWarps][QT][64] over all three.
template <int S, int QN, int KPL>
__device__ __forceinline__ void body(const Args& p) {
  constexpr int QT = 8 * QN;  // queries a block
  extern __shared__ __align__(16) float sm[];
  uint32_t* sq = reinterpret_cast<uint32_t*>(sm + QT * p.pitch);
  float* rsum = sm + QT * (p.pitch + kQPitch);  // [QT] each row's sum of e
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, c = lane & 3;
  const int bh = blockIdx.x / p.q_tiles;
  const int q0 = (blockIdx.x % p.q_tiles) * QT;
  const int h = bh % p.heads, b = bh / p.heads;
  const int64_t row_bytes = static_cast<int64_t>(p.tk) * (S == kBf16 ? 2 : 1);
  const uint8_t* kp = p.k + static_cast<int64_t>(bh) * kDh * row_bytes;
  const uint8_t* vp = p.v + static_cast<int64_t>(bh) * kDh * row_bytes;
  const int groups1 = (p.tk + kKeys1 - 1) / kKeys1;
  const int groups3 = (p.tk + kKeys3 - 1) / kKeys3;

  uint2 ra[kKS][4], rb[kKS][4];
  if (warp < groups1) {
    load1<S, KPL>(ra, kp, row_bytes, warp, 0, g, c, p.tk);
    load1<S, KPL>(rb, kp, row_bytes, warp, 1, g, c, p.tk);
  }
  // Q as f32 bits; queries past Tq are zero.
  for (int i = threadIdx.x; i < QT * kDh; i += kThreads) {
    const int r = i / kDh, d = i % kDh, row = q0 + r;
    const unsigned short* qr = reinterpret_cast<const unsigned short*>(p.q);
    sq[r * kQPitch + d] =
        row < p.tq ? static_cast<uint32_t>(__ldg(qr + b * p.q_sb + row * p.q_st + h * p.q_sh + d)) << 16
                   : 0u;
  }
  __syncthreads();

  // Pass 1: scaled scores into shared memory.
  for (int grp = warp; grp < groups1; grp += kWarps) {
    float acc[QN][4][4];
#pragma unroll
    for (int n = 0; n < QN; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][i][0] = acc[n][i][1] = acc[n][i][2] = acc[n][i][3] = 0.f;
#pragma unroll
    for (int ch = 0; ch < kCH; ch += 2) {  // chunks ch and ch + 1 are in flight
      mma1<S, QN>(acc, ra, sq, ch, g, c);
      if (ch + 2 < kCH) {
        load1<S, KPL>(ra, kp, row_bytes, grp, ch + 2, g, c, p.tk);
      } else if (grp + kWarps < groups1) {
        load1<S, KPL>(ra, kp, row_bytes, grp + kWarps, 0, g, c, p.tk);
      }
      mma1<S, QN>(acc, rb, sq, ch + 1, g, c);
      if (ch + 3 < kCH) {
        load1<S, KPL>(rb, kp, row_bytes, grp, ch + 3, g, c, p.tk);
      } else if (grp + kWarps < groups1) {
        load1<S, KPL>(rb, kp, row_bytes, grp + kWarps, 1, g, c, p.tk);
      }
    }
    const int ta = grp * kKeys1 + 4 * g, tb = ta + 32;
    const float k = p.scale;
#pragma unroll
    for (int n = 0; n < QN; ++n) {
      float* r0 = sm + (8 * n + 2 * c) * p.pitch;  // query 8n + 2c
      float* r1 = r0 + p.pitch;                      // query 8n + 2c + 1
      *reinterpret_cast<float4*>(r0 + ta) =
          make_float4(acc[n][0][0] * k, acc[n][1][0] * k, acc[n][2][0] * k, acc[n][3][0] * k);
      *reinterpret_cast<float4*>(r1 + ta) =
          make_float4(acc[n][0][1] * k, acc[n][1][1] * k, acc[n][2][1] * k, acc[n][3][1] * k);
      *reinterpret_cast<float4*>(r0 + tb) =
          make_float4(acc[n][0][2] * k, acc[n][1][2] * k, acc[n][2][2] * k, acc[n][3][2] * k);
      *reinterpret_cast<float4*>(r1 + tb) =
          make_float4(acc[n][0][3] * k, acc[n][1][3] * k, acc[n][2][3] * k, acc[n][3][3] * k);
    }
  }
  uint2 va[2][4], vb[2][4];
  if (warp < groups3) {
    load3<S, KPL>(va, vp, row_bytes, warp, 0, g, c, p.tk);
    load3<S, KPL>(vb, vp, row_bytes, warp, 1, g, c, p.tk);
  }
  __syncthreads();

  // Pass 2: each row's max over [0, Tk), then e = exp(s - max) in place of
  // the scores, zeros from Tk to the pitch, and the row's sum of e. Pass 3
  // divides by the sum and rounds the weight to bf16 as it reads it.
  for (int r = warp; r < QT; r += kWarps) {
    float* row = sm + r * p.pitch;
    float m = -INFINITY;
    for (int t = lane; t < p.tk; t += 32) m = fmaxf(m, row[t]);
    m = warp_max(m);
    float sum = 0.f;
    for (int t = lane; t < p.tk; t += 32) {
      const float e = expf(row[t] - m);
      row[t] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int t = p.tk + lane; t < p.pitch; t += 32) row[t] = 0.f;
    if (lane == 0) rsum[r] = sum;
  }
  __syncthreads();

  // Pass 3: O^T [64 dims, QT] = V W^T.
  float o[QN][4][4];
#pragma unroll
  for (int n = 0; n < QN; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[n][j][0] = o[n][j][1] = o[n][j][2] = o[n][j][3] = 0.f;
  float sums[QN];
#pragma unroll
  for (int n = 0; n < QN; ++n) sums[n] = rsum[8 * n + g];
  for (int grp = warp; grp < groups3; grp += kWarps) {
    const int ta = grp * kKeys3 + 4 * c, tb = ta + 16;
    float4 wa[QN], wb[QN];  // weights of query 8n + g at keys ta .. ta + 3, tb .. tb + 3
#pragma unroll
    for (int n = 0; n < QN; ++n) {
      const float* wr = sm + (8 * n + g) * p.pitch;
      wa[n] = weights(*reinterpret_cast<const float4*>(wr + ta), sums[n]);
      wb[n] = weights(*reinterpret_cast<const float4*>(wr + tb), sums[n]);
    }
    mma3<S, QN>(o, va, 0, wa, wb);  // chunks 0 and 1 of this group are in flight
    if (grp + kWarps < groups3) load3<S, KPL>(va, vp, row_bytes, grp + kWarps, 0, g, c, p.tk);
    mma3<S, QN>(o, vb, 1, wa, wb);
    if (grp + kWarps < groups3) load3<S, KPL>(vb, vp, row_bytes, grp + kWarps, 1, g, c, p.tk);
  }
  __syncthreads();  // every warp is done with the weights and Q

  float* red = sm;  // [kWarps][QT][64]
#pragma unroll
  for (int n = 0; n < QN; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float* w = red + (warp * QT + 8 * n + 2 * c) * kDh + 16 * j + g;
      w[0] = o[n][j][0];
      w[kDh] = o[n][j][1];
      w[8] = o[n][j][2];
      w[kDh + 8] = o[n][j][3];
    }
  __syncthreads();
  for (int i = threadIdx.x; i < QT * kDh; i += kThreads) {
    const int r = i / kDh, d = i % kDh, row = q0 + r;
    if (row >= p.tq) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[(w * QT + r) * kDh + d];
    p.out[((static_cast<int64_t>(b) * p.tq + row) * p.heads + h) * kDh + d] = __float2bfloat16_rn(s);
  }
}

}  // namespace xa

// One kernel per (store, query tiles of 8 or 16, keys a load); the names
// begin with cross_attend (ops/cross_attend.KERNEL_SYMBOL).
#define XA_NAME(ST, QN, KPL) cross_attend_##ST##_q##QN##_k##KPL
#define XA_VARIANTS(X)                                                                     \
  X(bf16, xa::kBf16, 1, 4) X(bf16, xa::kBf16, 1, 2) X(bf16, xa::kBf16, 1, 1)               \
  X(bf16, xa::kBf16, 2, 4) X(bf16, xa::kBf16, 2, 2) X(bf16, xa::kBf16, 2, 1)               \
  X(e4m3, xa::kE4m3, 1, 4) X(e4m3, xa::kE4m3, 1, 2) X(e4m3, xa::kE4m3, 1, 1)               \
  X(e4m3, xa::kE4m3, 2, 4) X(e4m3, xa::kE4m3, 2, 2) X(e4m3, xa::kE4m3, 2, 1)               \
  X(e5m2, xa::kE5m2, 1, 4) X(e5m2, xa::kE5m2, 1, 2) X(e5m2, xa::kE5m2, 1, 1)               \
  X(e5m2, xa::kE5m2, 2, 4) X(e5m2, xa::kE5m2, 2, 2) X(e5m2, xa::kE5m2, 2, 1)

#define XA_DEFINE(ST, S, QN, KPL)                                                          \
  extern "C" __global__ void __launch_bounds__(xa::kThreads, QN == 1 ? 3 : 2)             \
      XA_NAME(ST, QN, KPL)(const xa::Args p) {                                             \
    xa::body<S, QN, KPL>(p);                                                               \
  }
XA_VARIANTS(XA_DEFINE)

namespace {

#define XA_ENTRY(ST, S, QN, KPL) reinterpret_cast<const void*>(&XA_NAME(ST, QN, KPL)),
const void* const kKernels[] = {XA_VARIANTS(XA_ENTRY)};
bool g_ready[sizeof(kKernels) / sizeof(kKernels[0])] = {};

int kpl_index(int kpl) { return kpl == 4 ? 0 : kpl == 2 ? 1 : kpl == 1 ? 2 : -1; }

}  // namespace

// out [B, Tq, H, 64] bf16 (contiguous) = cross-attention of q [B, Tq, H, 64]
// bf16 (strides q_sb, q_st, q_sh in elements, and 1) over k, v [B, H, 64,
// Tk] of `store` (0 bf16, 1 float8_e4m3fn, 2 float8_e5m2), contiguous. qn:
// query tiles of 8 qn; kpl: keys a load (4, 2 or 1; Tk and the bases of k
// and v are multiples of kpl keys); both from the wrapper's plan. The
// shared-memory layout is this file's: the scores' pitch, Tk rounded up to
// kKeys1, and the block's bytes, the larger of body()'s two uses.
// Returns the cudaError of the launch, or -1 where the scores of Tk keys
// do not fit a block's shared memory.
extern "C" int cross_attend(const void* q, const void* k, const void* v, void* out,
                            int64_t q_sb, int64_t q_st, int64_t q_sh, int b, int tq, int heads,
                            int tk, int store, int qn, int kpl, float scale, void* stream) {
  const int ki = kpl_index(kpl);
  if (store < 0 || store > 2 || qn < 1 || qn > 2 || ki < 0 || b < 1 || tq < 1 || heads < 1 ||
      tk < 1 || tk % kpl)
    return (int)cudaErrorInvalidValue;
  const int pitch = (tk + xa::kKeys1 - 1) / xa::kKeys1 * xa::kKeys1;
  const long long scores = 8LL * qn * (pitch + xa::kQPitch + 1) * 4;
  const long long partials = 1LL * xa::kWarps * 8 * qn * xa::kDh * 4;
  const long long smem = scores > partials ? scores : partials;
  if (smem > xa::kSmemMax) return -1;
  const int vi = (store * 2 + qn - 1) * 3 + ki;
  if (!g_ready[vi]) {  // once, before any capture: the first call is eager
    const cudaError_t err = cudaFuncSetAttribute(
        kKernels[vi], cudaFuncAttributeMaxDynamicSharedMemorySize, xa::kSmemMax);
    if (err != cudaSuccess) return (int)err;
    g_ready[vi] = true;
  }
  xa::Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const uint8_t*>(k);
  a.v = static_cast<const uint8_t*>(v);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.q_sb = q_sb;
  a.q_st = q_st;
  a.q_sh = q_sh;
  a.tq = tq;
  a.heads = heads;
  a.tk = tk;
  a.pitch = pitch;
  a.q_tiles = (tq + 8 * qn - 1) / (8 * qn);
  a.scale = scale;
  const long long grid = static_cast<long long>(b) * heads * a.q_tiles;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  void* params[] = {&a};
  return (int)cudaLaunchKernel(kKernels[vi], dim3(static_cast<unsigned>(grid)), dim3(xa::kThreads),
                               params, static_cast<size_t>(smem), static_cast<cudaStream_t>(stream));
}
