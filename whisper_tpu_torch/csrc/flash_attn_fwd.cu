// Non-causal flash-attention forward for the Whisper encoder (K1).
//
// Replaces: whisper_tpu/ops/attention.py:33 `fused_self_attention`, which
// goes to JAX's Pallas TPU `flash_attention`. Computes
// softmax(Q K^T / sqrt(Dh)) V for q, k, v of shape [B, T, H, Dh] (read
// through their strides, no transpose copies); output [B, T, H, Dh] in the
// input dtype. Scores, the running max and sum (online softmax) and the
// output accumulators are f32.
//
// Bound on an H100 SXM: compute. The two products do 4*B*H*T^2*Dh FLOP: at
// large-v3 (T = 1500, H = 20, Dh = 64) and B = 1 that is 11.5 GFLOP per
// layer, at least 11.6 us at 989 TFLOP/s bf16. The function moves
// 4*B*T*H*Dh*2 bytes (q, k, v read once, o written once) = 15.4 MB, about
// 4.6 us at 3.35 TB/s. Scores never leave the chip, so the T^2 term is
// paid in tensor-core operations, not in memory traffic.
//
// Design: one CTA per (64-row query tile, head, batch). Four warps each own
// 16 query rows. The loop walks K/V in tiles of 64 rows staged through
// shared memory; Q K^T and P V run on the tensor cores as
// mma.sync.m16n8k16 bf16 with f32 accumulation, and the S accumulator
// fragments are re-packed in registers as the A operand of P V (no shared
// round trip for P). T is tiled as it is: keys past T in the last tile get
// zero weight inside the kernel and query rows past T are not stored, so
// no padded copy of the inputs is made. The f32 variant (parity runs) does
// the same walk with one thread per query row and plain FMA. Not yet used:
// TMA, wgmma, warp specialisation and cp.async double buffering.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (whisper_tpu_torch/ops/build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_M = 64;  // query rows per CTA
constexpr int BLOCK_N = 64;  // key rows per K/V tile
constexpr int PAD = 8;       // bf16 elements of row padding in shared memory

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  uint32_t l = *reinterpret_cast<uint16_t*>(&lo);
  uint32_t h = *reinterpret_cast<uint16_t*>(&hi);
  return l | (h << 16);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Copy rows [row0, row0 + 64) of one (b, h) slice into shared memory; rows
// at or past T are zero-filled. 16-byte vector loads (the wrapper checks
// the alignment).
template <int D>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16 (*dst)[D + PAD],
                                               const __nv_bfloat16* base,
                                               int64_t stride_t, int row0, int T) {
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < BLOCK_N * CHUNKS; c += blockDim.x) {
    int r = c / CHUNKS;
    int col = (c % CHUNKS) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < T) {
      val = *reinterpret_cast<const uint4*>(base + (int64_t)(row0 + r) * stride_t + col);
    }
    *reinterpret_cast<uint4*>(&dst[r][col]) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(128)
flash_fwd_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int T,
               int64_t q_sb, int64_t q_st, int64_t q_sh, int64_t k_sb, int64_t k_st,
               int64_t k_sh, int64_t v_sb, int64_t v_st, int64_t v_sh, int64_t o_sb,
               int64_t o_st, int64_t o_sh, float scale) {
  __shared__ __align__(16) __nv_bfloat16 q_s[BLOCK_M][D + PAD];
  __shared__ __align__(16) __nv_bfloat16 k_s[BLOCK_N][D + PAD];
  __shared__ __align__(16) __nv_bfloat16 v_s[BLOCK_N][D + PAD];

  const int m0 = blockIdx.x * BLOCK_M;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // fragment row group
  const int t = lane % 4;  // thread within the group

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + h * v_sh;

  load_tile_bf16<D>(q_s, qb, q_st, m0, T);
  __syncthreads();

  // This warp's 16 query rows as A fragments, one set per 16-wide k-step.
  const int r0 = warp * 16 + g;
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    int c = kk * 16 + 2 * t;
    qa[kk][0] = *reinterpret_cast<const uint32_t*>(&q_s[r0][c]);
    qa[kk][1] = *reinterpret_cast<const uint32_t*>(&q_s[r0 + 8][c]);
    qa[kk][2] = *reinterpret_cast<const uint32_t*>(&q_s[r0][c + 8]);
    qa[kk][3] = *reinterpret_cast<const uint32_t*>(&q_s[r0 + 8][c + 8]);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  // Row state for rows r0 (index 0) and r0 + 8 (index 1). l is this
  // thread's partial sum; the four threads of a row group add up at the end.
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  for (int n0 = 0; n0 < T; n0 += BLOCK_N) {
    __syncthreads();  // the previous tile is no longer read
    load_tile_bf16<D>(k_s, kb, k_st, n0, T);
    load_tile_bf16<D>(v_s, vb, v_st, n0, T);
    __syncthreads();

    // S = Q K^T for 16 rows x 64 keys: 8 n-tiles of 8 keys.
    float s[BLOCK_N / 8][4];
#pragma unroll
    for (int j = 0; j < BLOCK_N / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        int c = kk * 16 + 2 * t;
        uint32_t b0 = *reinterpret_cast<const uint32_t*>(&k_s[j * 8 + g][c]);
        uint32_t b1 = *reinterpret_cast<const uint32_t*>(&k_s[j * 8 + g][c + 8]);
        mma_bf16(s[j], qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3], b0, b1);
      }
    }

    // Scale, mask the ragged tail, and take the tile's row maxima.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BLOCK_N / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int key = n0 + j * 8 + 2 * t + (e & 1);
        float val = key < T ? s[j][e] * scale : -INFINITY;
        s[j][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    }
    // Key n0 < T is in every tile, so each row's new max is finite.
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float m_new = fmaxf(m_run[i], mx[i]);
      alpha[i] = expf(m_run[i] - m_new);
      m_run[i] = m_new;
      l_run[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < BLOCK_N / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = expf(s[j][e] - m_run[e >> 1]);
        s[j][e] = p;
        l_run[e >> 1] += p;
      }
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // O += P V. The C fragments of S n-tiles 2kk and 2kk+1 are exactly the
    // A fragment of k-step kk over keys.
#pragma unroll
    for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
      uint32_t a0 = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      uint32_t a1 = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      uint32_t a2 = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      uint32_t a3 = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      int key = kk * 16 + 2 * t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        int col = j * 8 + g;
        uint32_t b0 = pack_raw(v_s[key][col], v_s[key + 1][col]);
        uint32_t b1 = pack_raw(v_s[key + 8][col], v_s[key + 9][col]);
        mma_bf16(acc[j], a0, a1, a2, a3, b0, b1);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
  }
  const float inv[2] = {1.f / l_run[0], 1.f / l_run[1]};
  const int rows[2] = {m0 + r0, m0 + r0 + 8};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= T) continue;
    __nv_bfloat16* orow = o + b * o_sb + (int64_t)rows[i] * o_st + h * o_sh;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(orow + j * 8 + 2 * t) =
          pack_bf16(acc[j][2 * i] * inv[i], acc[j][2 * i + 1] * inv[i]);
    }
  }
}

// f32 variant: one thread per query row, K/V tiles in shared memory, an
// online softmax update per key.
template <int D>
__global__ void __launch_bounds__(BLOCK_M)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int T, int64_t q_sb,
              int64_t q_st, int64_t q_sh, int64_t k_sb, int64_t k_st, int64_t k_sh,
              int64_t v_sb, int64_t v_st, int64_t v_sh, int64_t o_sb, int64_t o_st,
              int64_t o_sh, float scale) {
  __shared__ float k_s[BLOCK_N][D];
  __shared__ float v_s[BLOCK_N][D];

  const int row = blockIdx.x * BLOCK_M + threadIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;

  float qr[D];
  float acc[D];
  const bool live = row < T;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = live ? q[b * q_sb + (int64_t)row * q_st + h * q_sh + d] : 0.f;
    acc[d] = 0.f;
  }
  float m_run = -INFINITY;
  float l_run = 0.f;

  for (int n0 = 0; n0 < T; n0 += BLOCK_N) {
    __syncthreads();
    for (int c = threadIdx.x; c < BLOCK_N * D; c += blockDim.x) {
      int r = c / D;
      int d = c % D;
      bool ok = n0 + r < T;
      k_s[r][d] = ok ? kb[(int64_t)(n0 + r) * k_st + d] : 0.f;
      v_s[r][d] = ok ? vb[(int64_t)(n0 + r) * v_st + d] : 0.f;
    }
    __syncthreads();
    const int n_keys = min(BLOCK_N, T - n0);
    for (int j = 0; j < n_keys; ++j) {
      float sc = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) sc = fmaf(qr[d], k_s[j][d], sc);
      sc *= scale;
      float m_new = fmaxf(m_run, sc);
      float alpha = expf(m_run - m_new);
      float p = expf(sc - m_new);
      l_run = l_run * alpha + p;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(p, v_s[j][d], acc[d] * alpha);
      m_run = m_new;
    }
  }
  if (!live) return;
  float* orow = o + b * o_sb + (int64_t)row * o_st + h * o_sh;
  const float inv = 1.f / l_run;
#pragma unroll
  for (int d = 0; d < D; ++d) orow[d] = acc[d] * inv;
}

template <int D>
void launch(int dtype, const void* q, const void* k, const void* v, void* o, int B,
            int T, int H, const int64_t* s, float scale, cudaStream_t stream) {
  dim3 grid((T + BLOCK_M - 1) / BLOCK_M, H, B);
  if (dtype == 1) {
    flash_fwd_bf16<D><<<grid, 128, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), T, s[0],
        s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11], scale);
  } else {
    flash_fwd_f32<D><<<grid, BLOCK_M, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), T, s[0], s[1], s[2], s[3],
        s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11], scale);
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16.
// strides: 12 element strides, (batch, time, head) for q, k, v, o in turn;
// the head_dim axis is contiguous. Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                              int B, int T, int H, int D, int dtype,
                              const int64_t* strides, float scale, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) {
    launch<64>(dtype, q, k, v, o, B, T, H, strides, scale, st);
  } else if (D == 32) {
    launch<32>(dtype, q, k, v, o, B, T, H, strides, scale, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
