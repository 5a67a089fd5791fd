// Non-causal flash-attention forward for the Whisper encoder (K1).
//
// Replaces: whisper_tpu/ops/attention.py:33 `fused_self_attention`, which
// goes to JAX's Pallas TPU `flash_attention`. Computes
// softmax(Q K^T / sqrt(Dh)) V for q, k, v of shape [B, T, H, Dh] (read
// through their strides, no transpose copies); output [B, T, H, Dh] in the
// input dtype. Scores, the running max and sum (online softmax) and the
// output accumulators are f32; the unnormalised weights are rounded to bf16
// for the value product.
//
// Bound on an H100 SXM: compute. The two products do 4*B*H*T^2*Dh FLOP: at
// large-v3 (T = 1500, H = 20, Dh = 64) and B = 4 that is 46.1 GFLOP per
// layer, at least 46.6 us at 989 TFLOP/s bf16. The function moves
// 4*B*T*H*Dh*2 bytes (q, k, v read once, o written once) = 61.4 MB, about
// 18.3 us at 3.35 TB/s. Scores never leave the chip, so the T^2 term is
// paid in tensor-core operations, not in memory traffic. At Dh = 64 the
// exponentials are a second ceiling as high as the first: the tensor cores
// finish the 4 * 64 FLOP of a score at 16 scores per clock per SM, and the
// special function unit does 16 ex2 per clock per SM. So the design keeps
// the tensor cores busy while the exponentials run.
//
// Design of the bf16 body (Hopper, sm_90a): a persistent grid of one CTA
// per SM, 512 threads in two roles, walking units of (192-row query tile,
// head, batch): CTA i takes units i, i + grid, ...
// - Warpgroup 3 is the producer (setmaxnreg down to 24 registers). One
//   lane issues TMA loads: each unit's Q tile into one of two buffers, then
//   its K and V tiles of 128 keys into a ring of three stages that runs on
//   across units, K and V each with its own "full" mbarrier (so Q K^T
//   starts before V has landed). A stage is refilled when all consumers
//   have released it (an "empty" mbarrier per stage; a Q buffer likewise),
//   so the loads of the next two tiles, and the next unit's first ones,
//   overlap the math of this one.
// - Warpgroups 0-2 are consumers (setmaxnreg up to 160), 64 query rows
//   each. S = Q K^T is wgmma m64n128k16 with both operands in shared
//   memory (K-major). The f32 accumulator layout of S is the register-A
//   layout of the next wgmma, so P = exp2(S * scale * log2 e - m) is
//   rounded to bf16 in registers and O += P V is wgmma m64nDk16 with A in
//   registers and V in shared memory as a transposed (MN-major) B: V's
//   reduction axis, the key, is its strided one. Within a warpgroup, tile
//   n's Q K^T and tile n-1's P V are issued together, and tile n's softmax
//   runs while P V is on the tensor cores; across warpgroups, one's softmax
//   overlaps the others' products.
// - Shared tiles are rows of Dh in the swizzle that wgmma reads: 128-byte
//   swizzle for Dh = 64 (a row is 128 bytes), 64-byte for Dh = 32; every
//   tile starts on a 1024-byte boundary, so the swizzle phase is the same
//   for TMA and wgmma.
// Each load is a box of 64 rows of a 4-D tensor map over (Dh, H, T, B)
// with the byte strides of the view (made by `tensor_map_layout` in
// ops/attention.py; three encodes per call with cuTensorMapEncodeTiled,
// reached through the runtime's cudaGetDriverEntryPoint[ByVersion], so the
// library links against nothing beyond the CUDA runtime). TMA fills rows
// past T with zeros; only the last K/V tile, when T is not a multiple of
// 128, gives its keys past T weight zero (score -inf), and query rows past
// T are never stored.
//
// The f32 variant (parity runs) walks K/V tiles of 64 keys with one thread
// per query row and plain FMA.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (whisper_tpu_torch/ops/build.py).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// ---- bf16 body: TMA + wgmma + warp specialisation -------------------------

constexpr int BOX = 64;                  // rows of one TMA box
constexpr int KEYS = 2 * BOX;            // keys per K/V tile
constexpr int CONSUMERS = 3;             // consumer warpgroups, one box of query rows each
constexpr int QROWS = BOX * CONSUMERS;   // query rows per CTA
constexpr int STAGES = 3;                // K/V ring depth
constexpr int THREADS = 128 * (CONSUMERS + 1);  // + the producer warpgroup
// setmaxnreg: 512 threads start at 128 registers each (the whole register
// file); the producer warpgroup gives back 104 per thread, which lets the
// consumers rise to 160 (S, P and O live across the pipelined loop).
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 160;
static_assert(128 * (PRODUCER_REGS + CONSUMERS * CONSUMER_REGS) <= 65536, "register file");
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Smem {
  static constexpr int BOX_BYTES = BOX * D * 2;     // one [64][D] bf16 box
  static constexpr int TILE = KEYS * D * 2;         // one [128][D] K or V tile
  static constexpr int QBYTES = QROWS * D * 2;      // one [QROWS][D] Q tile
  static constexpr int Q = 0;                       // + (unit & 1) * QBYTES
  static constexpr int K = 2 * QBYTES;              // + stage * TILE
  static constexpr int V = K + STAGES * TILE;       // + stage * TILE
  static constexpr int BAR = V + STAGES * TILE;
  // q_full[2], q_empty[2], k_full[S], v_full[S], empty[S]; 1024 bytes of
  // slack to align the base to the 1024-byte swizzle period.
  static constexpr int BYTES = BAR + 8 * (4 + 3 * STAGES) + 1024;
  static constexpr uint32_t SWIZZLE_BYTES = D * 2;          // 128 or 64
  static constexpr uint64_t LAYOUT = D == 64 ? 1 : 2;       // wgmma: 1 = 128B, 2 = 64B
  static constexpr uint32_t GROUP = 8 * SWIZZLE_BYTES;      // 8 rows: one swizzle atom
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of the 4-D map at (0, h, row, b) into shared memory.
__device__ __forceinline__ void tma_load(const CUtensorMap* map, uint32_t dst, uint32_t bar,
                                         int h, int row, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(0), "r"(h), "r"(row), "r"(b)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle mode in bits 62-63.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                         uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pins registers that an async wgmma reads or writes (accumulators, the
// register A operand) until the wait that retires it: the compiler may
// neither read them early nor reuse them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// S[64 x 128] (+)= A[64 x 16] * B[16 x 128], both K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t da, uint64_t db,
                                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// O[64 x 64] += A[64 x 16] (registers) * B[16 x 64] (shared, MN-major).
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O[64 x 32] += A[64 x 16] (registers) * B[16 x 32] (shared, MN-major).
__device__ __forceinline__ void wgmma_m64n32k16_rs(float (&d)[16], const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// S = Q K^T for this warpgroup's 64 rows and one 128-key tile: Dh/16
// k-steps, each advancing both K-major descriptors by 32 bytes inside the
// swizzled row.
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[64], uint32_t q_tile, uint32_t k_tile) {
  using L = Smem<D>;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wgmma_m64n128k16_ss(s, desc(q_tile + kk * 32, 16, L::GROUP, L::LAYOUT),
                        desc(k_tile + kk * 32, 16, L::GROUP, L::LAYOUT), kk > 0);
  }
  wgmma_commit();
}

// O += P V over one tile: 8 k-steps of 16 keys. P's k-step kk is the S
// accumulator's n-blocks 2kk and 2kk+1. V is MN-major (Dh contiguous, keys
// strided): a k-step is 16 key rows further; the 8-row groups are one
// swizzle atom apart (both offsets set to it: the N extent is one atom).
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&p)[32],
                                         uint32_t v_tile) {
  using L = Smem<D>;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KEYS / 16; ++kk) {
    const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
    const uint64_t db = desc(v_tile + kk * 16 * L::SWIZZLE_BYTES, L::GROUP, L::GROUP, L::LAYOUT);
    if constexpr (D == 64) {
      wgmma_m64n64k16_rs(o, a, db);
    } else {
      wgmma_m64n32k16_rs(o, a, db);
    }
  }
  wgmma_commit();
}

// Online softmax over one tile of scores, in place: s becomes the
// unnormalised weights exp2(s * scale * log2 e - m) in f32, m and l move to
// the new running max and sum, alpha is the factor for the output rows.
// valid >= 0 (the ragged last tile only): keys at or past it score -inf.
// This thread holds rows g and g + 8 at columns 8 j + 2 t and + 1.
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m_run)[2], float (&l_run)[2],
                                             float (&alpha)[2], float scale_log2, int valid,
                                             int t) {
  if (valid >= 0) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (8 * j + 2 * t + (e & 1) >= valid) s[4 * j + e] = -INFINITY;
      }
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  float neg_ms[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    // The tile's first key is below T, so each row's new max is finite.
    const float m_new = fmaxf(m_run[i], mx[i]);
    alpha[i] = ex2((m_run[i] - m_new) * scale_log2);
    m_run[i] = m_new;
    neg_ms[i] = -m_new * scale_log2;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[4 * j + e] = ex2(fmaf(s[4 * j + e], scale_log2, neg_ms[e >> 1]));
      sum[e >> 1] += s[4 * j + e];
    }
  }
  l_run[0] = l_run[0] * alpha[0] + sum[0];
  l_run[1] = l_run[1] * alpha[1] + sum[1];
}

// The weights as the bf16 A operand of P V: k-step kk holds n-blocks 2kk
// and 2kk+1, rows g and g + 8.
__device__ __forceinline__ void pack_weights(uint32_t (&p)[32], const float (&s)[64]) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    p[2 * j] = pack_bf16(s[4 * j], s[4 * j + 1]);
    p[2 * j + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_bf16(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o, int T,
               int H, int units, int64_t o_sb, int64_t o_st, int64_t o_sh, float scale_log2) {
  using L = Smem<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar = base + L::BAR;
  auto q_full = [&](int i) { return bar + 8u * i; };
  auto q_empty = [&](int i) { return bar + 8u * (2 + i); };
  auto k_full = [&](int s) { return bar + 8u * (4 + s); };
  auto v_full = [&](int s) { return bar + 8u * (4 + STAGES + s); };
  auto empty = [&](int s) { return bar + 8u * (4 + 2 * STAGES + s); };

  const int m_tiles = (T + QROWS - 1) / QROWS;
  const int n_tiles = (T + KEYS - 1) / KEYS;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(q_full(i), 1);
      mbar_init(q_empty(i), 128 * CONSUMERS);
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), 128 * CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Persistent: this CTA takes units blockIdx.x, + gridDim.x, ...; a unit
  // is one (query tile, head, batch). Q is double-buffered by the unit's
  // parity, and the K/V ring runs on across units, so the next unit's
  // first loads overlap this unit's last tiles and its stores.
  if (warp >= 4 * CONSUMERS) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (warp == 4 * CONSUMERS && lane == 0) {
      int it = 0;  // K/V tiles loaded so far
      for (int u = blockIdx.x, i = 0; u < units; u += gridDim.x, ++i) {
        const int m0 = (u % m_tiles) * QROWS;
        const int h = (u / m_tiles) % H;
        const int b = u / (m_tiles * H);
        if (i >= 2) mbar_wait(q_empty(i & 1), ((i >> 1) - 1) & 1);
        // Boxes past T are filled with zeros and still count their bytes.
        mbar_expect_tx(q_full(i & 1), CONSUMERS * L::BOX_BYTES);
        for (int c = 0; c < CONSUMERS; ++c) {
          tma_load(&tm_q, base + L::Q + (i & 1) * L::QBYTES + c * L::BOX_BYTES, q_full(i & 1),
                   h, m0 + c * BOX, b);
        }
        for (int n = 0; n < n_tiles; ++n, ++it) {
          const int s = it % STAGES;
          const int round = it / STAGES;
          if (round > 0) mbar_wait(empty(s), (round - 1) & 1);
          mbar_expect_tx(k_full(s), L::TILE);
          for (int half = 0; half < 2; ++half) {
            tma_load(&tm_k, base + L::K + s * L::TILE + half * L::BOX_BYTES, k_full(s), h,
                     n * KEYS + half * BOX, b);
          }
          mbar_expect_tx(v_full(s), L::TILE);
          for (int half = 0; half < 2; ++half) {
            tma_load(&tm_v, base + L::V + s * L::TILE + half * L::BOX_BYTES, v_full(s), h,
                     n * KEYS + half * BOX, b);
          }
        }
      }
    }
    return;
  }

  // Consumer warpgroup wg: query rows [m0 + 64 wg, m0 + 64 wg + 64) of each unit.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int wg = warp / 4;
  const int t = lane % 4;  // accumulator column pair
  auto k_tile = [&](int n) { return base + L::K + (n % STAGES) * L::TILE; };
  auto v_tile = [&](int n) { return base + L::V + (n % STAGES) * L::TILE; };
  auto parity = [](int n) { return static_cast<uint32_t>((n / STAGES) & 1); };
  const bool ragged = T % KEYS != 0;

  int it = 0;  // K/V tiles consumed so far
  for (int u = blockIdx.x, i = 0; u < units; u += gridDim.x, ++i, it += n_tiles) {
    const int m0 = (u % m_tiles) * QROWS;
    const int h = (u / m_tiles) % H;
    const int b = u / (m_tiles * H);
    const uint32_t q_tile = base + L::Q + (i & 1) * L::QBYTES + wg * L::BOX_BYTES;

    float acc[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;
    // Rows g and g + 8 of this warp's 16 (g = lane / 4): running max (raw
    // score units) and this thread's share of the running sum.
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.f, 0.f};
    float alpha[2];
    float s[64];
    uint32_t p[32];

    mbar_wait(q_full(i & 1), (i >> 1) & 1);
    mbar_wait(k_full(it % STAGES), parity(it));
    issue_qk<D>(s, q_tile, k_tile(it));
    wgmma_wait<0>();
    fence_regs(s);
    softmax_tile(s, m_run, l_run, alpha, scale_log2, ragged && n_tiles == 1 ? T : -1, t);
    pack_weights(p, s);

    // Tile n: Q K_n^T and P_{n-1} V_{n-1} are issued together; the softmax
    // of S_n runs while P_{n-1} V_{n-1} is on the tensor cores.
    for (int n = 1; n < n_tiles; ++n) {
      mbar_wait(k_full((it + n) % STAGES), parity(it + n));
      issue_qk<D>(s, q_tile, k_tile(it + n));
      mbar_wait(v_full((it + n - 1) % STAGES), parity(it + n - 1));
      fence_regs(acc);
      fence_regs(p);
      issue_pv<D>(acc, p, v_tile(it + n - 1));
      wgmma_wait<1>();  // S_n has landed; P_{n-1} V_{n-1} may still run
      fence_regs(s);
      softmax_tile(s, m_run, l_run, alpha, scale_log2,
                   ragged && n == n_tiles - 1 ? T - n * KEYS : -1, t);
      fence_regs(s);  // the exponentials stay ahead of the wait
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(p);
      mbar_arrive(empty((it + n - 1) % STAGES));  // K_{n-1} and V_{n-1} are read
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[4 * j] *= alpha[0];
        acc[4 * j + 1] *= alpha[0];
        acc[4 * j + 2] *= alpha[1];
        acc[4 * j + 3] *= alpha[1];
      }
      pack_weights(p, s);
    }
    mbar_arrive(q_empty(i & 1));  // every Q K^T of this unit is done
    const int last = it + n_tiles - 1;
    mbar_wait(v_full(last % STAGES), parity(last));
    fence_regs(acc);
    fence_regs(p);
    issue_pv<D>(acc, p, v_tile(last));
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(p);
    mbar_arrive(empty(last % STAGES));

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    }
    const float inv[2] = {1.f / l_run[0], 1.f / l_run[1]};
    const int row0 = m0 + wg * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= T) continue;
      __nv_bfloat16* orow = o + b * o_sb + static_cast<int64_t>(row) * o_st + h * o_sh;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t) =
            pack_bf16(acc[4 * j + 2 * r] * inv[r], acc[4 * j + 2 * r + 1] * inv[r]);
      }
    }
  }
}

// ---- f32 variant: one thread per query row, FMA ---------------------------

constexpr int F32_ROWS = 64;  // query rows per CTA
constexpr int F32_KEYS = 64;  // keys per K/V tile

template <int D>
__global__ void __launch_bounds__(F32_ROWS)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int T, int64_t q_sb,
              int64_t q_st, int64_t q_sh, int64_t k_sb, int64_t k_st, int64_t k_sh,
              int64_t v_sb, int64_t v_st, int64_t v_sh, int64_t o_sb, int64_t o_st,
              int64_t o_sh, float scale) {
  __shared__ float k_s[F32_KEYS][D];
  __shared__ float v_s[F32_KEYS][D];

  const int row = blockIdx.x * F32_ROWS + threadIdx.x;
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

  for (int n0 = 0; n0 < T; n0 += F32_KEYS) {
    __syncthreads();
    for (int c = threadIdx.x; c < F32_KEYS * D; c += blockDim.x) {
      int r = c / D;
      int d = c % D;
      bool ok = n0 + r < T;
      k_s[r][d] = ok ? kb[(int64_t)(n0 + r) * k_st + d] : 0.f;
      v_s[r][d] = ok ? vb[(int64_t)(n0 + r) * v_st + d] : 0.f;
    }
    __syncthreads();
    const int n_keys = min(F32_KEYS, T - n0);
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

// ---- host side ------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// `layout`: 11 values, as ops/attention.py `tensor_map_layout` makes them:
// dims (Dh, H, T, B), byte strides of H, T, B, box (Dh, 1, 64, 1).
template <int D>
int make_map(CUtensorMap* map, const void* ptr, const uint64_t* layout) {
  const cuuint32_t box[4] = {(cuuint32_t)layout[7], (cuuint32_t)layout[8],
                             (cuuint32_t)layout[9], (cuuint32_t)layout[10]};
  if (layout[0] != D || box[0] != D || box[1] != 1 || box[2] != BOX || box[3] != 1) {
    return (int)cudaErrorInvalidValue;  // the box must be the kernel's
  }
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {layout[0], layout[1], layout[2], layout[3]};
  const cuuint64_t strides[3] = {layout[4], layout[5], layout[6]};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                      D == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1000 + (int)r;
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int T, int H,
                const int64_t* s, const uint64_t* layouts, float scale, int device,
                cudaStream_t stream) {
  constexpr int MAX_DEVICES = 64;
  static int sms[MAX_DEVICES] = {};  // SMs of each device; 0 until it is set up
  if (device < 0 || device >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  CUtensorMap tm[3];
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    int rc = make_map<D>(&tm[i], ptrs[i], layouts + 11 * i);
    if (rc != 0) return rc;
  }
  if (sms[device] == 0) {
    // Above 48 KB of dynamic shared memory.
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<D>::BYTES);
    if (err != cudaSuccess) return (int)err;
    // setmaxnreg.inc waits for registers the producer gave back: the CTA
    // must start with enough of them, or the consumers would wait forever.
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, flash_fwd_bf16<D>);
    if (err != cudaSuccess) return (int)err;
    if (attr.numRegs * THREADS < 128 * (PRODUCER_REGS + CONSUMERS * CONSUMER_REGS)) {
      return (int)cudaErrorInvalidConfiguration;
    }
    int n = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    sms[device] = n;
  }
  const int units = (T + QROWS - 1) / QROWS * H * B;
  const int grid = units < sms[device] ? units : sms[device];  // persistent: one CTA per SM
  flash_fwd_bf16<D><<<grid, THREADS, Smem<D>::BYTES, stream>>>(
      tm[0], tm[1], tm[2], static_cast<__nv_bfloat16*>(o), T, H, units, s[9], s[10], s[11],
      scale * LOG2E);
  return (int)cudaGetLastError();
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B, int T, int H,
               const int64_t* s, float scale, cudaStream_t stream) {
  dim3 grid((T + F32_ROWS - 1) / F32_ROWS, H, B);
  flash_fwd_f32<D><<<grid, F32_ROWS, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), T, s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9],
      s[10], s[11], scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16.
// strides: 12 element strides, (batch, time, head) for q, k, v, o in turn;
// the head_dim axis is contiguous. layouts (bfloat16 only; may be null for
// float32): 33 values, the tensor-map layouts of q, k and v (see
// make_map). Returns 0 on success, else a cudaError_t (the launch's
// cudaGetLastError(), or a refused argument), or 1000 + the CUresult of a
// failed tensor-map encode.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v, void* o, int B,
                              int T, int H, int D, int dtype, const int64_t* strides,
                              const uint64_t* layouts, float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && layouts == nullptr) return (int)cudaErrorInvalidValue;
  if (D == 64) {
    return dtype == 1 ? launch_bf16<64>(q, k, v, o, B, T, H, strides, layouts, scale, device, st)
                      : launch_f32<64>(q, k, v, o, B, T, H, strides, scale, st);
  }
  if (D == 32) {
    return dtype == 1 ? launch_bf16<32>(q, k, v, o, B, T, H, strides, layouts, scale, device, st)
                      : launch_f32<32>(q, k, v, o, B, T, H, strides, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}
