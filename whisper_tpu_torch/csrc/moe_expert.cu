// The routed experts of a mixture-of-experts layer: two grouped products
// over the (token, slot) pairs sorted by expert (ops/moe_expert.py).
//
// Replaces no TPU kernel: the JAX package runs no mixture of experts. Added
// for the audio language models of config.AUDIO_LM_DIMS, whose tokens route
// to 0, 1 or 2 routed SwiGLU experts, a choice known only on the device.
//
//   moe_expert_gate_up_*: h[r] = silu(x[t] W_gate[e]) * (x[t] W_up[e]),
//     rounded to bf16, for each sorted pair r = (token t, expert e);
//   moe_expert_down_*:    y[t] += weight[r] * h[r] W_down[e], f32 atomics.
//
// The plan on the device (ops/moe_expert.plan): `order` lists the pair ids
// t * top_k + j expert by expert, `counts` each expert's pairs. The grid is
// (cdiv(P, BM) + E) row blocks times the column tiles, a function of the
// batch's shape only, so a launch can be captured in a CUDA graph. Each
// block finds its expert and its rows from `counts` and returns at once
// where its row block is empty: an expert with no row has none of its
// weights read. A token has at most two routed slots, so each element of y
// receives at most two adds onto zero, and 0 + a + b == 0 + b + a: the
// result does not depend on their order.
//
// Bound on an H100 SXM: bytes in a decode step (each touched expert's three
// matrices, 3 * d * f * 2 bytes = 407 MB at d 3584, f 18944, against a few
// dozen rows: ~0.12 ms an expert at 3.35 TB/s), operations in a prefill
// (6 * d * f FLOP a routed row at 989 TFLOP/s).
//
// Design: bf16 mma.sync m16n8k16 with f32 accumulators; tiles of A (rows of
// x gathered through `order`, or rows of h) and of B (the expert's weight,
// row-major [K][N]) come through a ring of STAGES shared-memory buffers by
// 16-byte cp.async, STAGES - 1 tiles in flight while one is multiplied; A
// fragments by ldmatrix, B fragments by ldmatrix.trans from the [K][N]
// rows; both tiles 16-byte-chunk XOR-swizzled so that each ldmatrix phase
// hits 8 distinct bank groups. A warp skips the 16-row slices of its tile
// that lie past the block's last row (a decode's experts see ~25 rows, not
// BM). Blocks are rasterised in groups of `group` column tiles: within a
// group, the column tiles of one row block run next to each other, so in a
// prefill A is read once per group and a group's weight tiles stay in L2
// while every row block passes. Variants (tile shapes, stages) are the
// table below; ops/moe_expert.py picks the decode's or the prefill's by
// the number of pairs.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (whisper_tpu_torch/ops/build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace moe {

struct Args {
  const __nv_bfloat16* a;   // x [N, K] (gate/up) or h [P, K] (down)
  const __nv_bfloat16* w0;  // W_gate or W_down [E, K, Nc]
  const __nv_bfloat16* w1;  // W_up (gate/up only)
  __nv_bfloat16* h;         // out (gate/up): [P, Nc]
  float* y;                 // out (down): [N, Nc], zeroed by the caller
  const int* order;         // [P] pair ids sorted by expert
  const int* counts;        // [E]
  const float* weight;      // [P] the gate's weight of each pair id
  int k;                    // reduction width
  int nc;                   // output columns
  int top_k;
  int n_experts;
  int m_blocks;             // cdiv(P, BM) + E
  int n_tiles;              // nc / BN
  int group;                // column tiles rasterised together
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;  // 0: the 16 bytes are filled with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The 16-byte chunk a logical (row, chunk) lands on in a tile whose rows
// hold C chunks: eight consecutive rows at one logical chunk fall on eight
// distinct bank groups.
template <int C>
__device__ __forceinline__ int swz(int row, int chunk) {
  if constexpr (C >= 8) return chunk ^ (row & 7);
  else if constexpr (C == 4) return chunk ^ ((row >> 1) & 3);
  else if constexpr (C == 2) return chunk ^ ((row >> 2) & 1);
  else return chunk;
}

template <int BM, int BN, int BK, int WARPS_M, int WARPS_N, int STAGES, bool GATED>
struct Tile {
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int WM = BM / WARPS_M;
  static constexpr int WN = BN / WARPS_N;
  static constexpr int MI = WM / 16;
  static constexpr int NI = WN / 8;
  static constexpr int NB = GATED ? 2 : 1;
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int B_BYTES = BK * BN * 2;
  static constexpr int STAGE_BYTES = A_BYTES + NB * B_BYTES;
  static constexpr int SMEM = STAGES * STAGE_BYTES;
  static_assert(WM % 16 == 0 && WN % 16 == 0 && BK % 16 == 0, "tile shape");
};

template <int BM, int BN, int BK, int WARPS_M, int WARPS_N, int STAGES, bool GATED, bool FULL>
__device__ __forceinline__ void tile(const Args& p, int e_sel, int row0, int rows, int n_tile,
                                     const int* tok_s, const float* wt_s);

template <int BM, int BN, int BK, int WARPS_M, int WARPS_N, int STAGES, bool GATED>
__device__ __forceinline__ void body(const Args& p) {
  using T = Tile<BM, BN, BK, WARPS_M, WARPS_N, STAGES, GATED>;
  __shared__ int tok_s[BM];
  __shared__ float wt_s[BM];

  // Rasterise: `group` column tiles of one row block are neighbours.
  const int lin = blockIdx.x;
  const int per_group = p.m_blocks * p.group;
  const int grp = lin / per_group;
  const int first_n = grp * p.group;
  const int gsz = min(p.group, p.n_tiles - first_n);
  const int idx = lin - grp * per_group;
  const int n_tile = first_n + idx % gsz;
  const int mb = idx / gsz;

  // This row block's expert and rows of the sorted pairs, from the counts.
  int e_sel = -1, row0 = 0, row_end = 0, bstart = 0, off = 0;
  for (int e = 0; e < p.n_experts; ++e) {
    const int c = p.counts[e];
    const int nb = (c + BM - 1) / BM;
    if (mb >= bstart && mb < bstart + nb) {
      e_sel = e;
      row0 = off + (mb - bstart) * BM;
      row_end = off + c;
    }
    bstart += nb;
    off += c;
  }
  if (e_sel < 0) return;
  const int rows = min(BM, row_end - row0);

  for (int r = threadIdx.x; r < BM; r += T::THREADS) {
    int t = 0;
    float w = 0.f;
    if (r < rows) {
      const int pair = p.order[row0 + r];
      t = pair / p.top_k;
      w = p.weight[pair];
    }
    tok_s[r] = t;
    wt_s[r] = w;
  }
  __syncthreads();

  if (rows == BM)
    tile<BM, BN, BK, WARPS_M, WARPS_N, STAGES, GATED, true>(p, e_sel, row0, rows, n_tile, tok_s, wt_s);
  else
    tile<BM, BN, BK, WARPS_M, WARPS_N, STAGES, GATED, false>(p, e_sel, row0, rows, n_tile, tok_s, wt_s);
}

// One block's tile: rows [row0, row0 + rows) of the sorted pairs (tokens
// tok_s, gate weights wt_s), columns [n_tile * BN, ...) of expert e_sel.
// FULL: rows == BM, so no 16-row slice is skipped and no row is masked.
template <int BM, int BN, int BK, int WARPS_M, int WARPS_N, int STAGES, bool GATED, bool FULL>
__device__ __forceinline__ void tile(const Args& p, int e_sel, int row0, int rows, int n_tile,
                                     const int* tok_s, const float* wt_s) {
  using T = Tile<BM, BN, BK, WARPS_M, WARPS_N, STAGES, GATED>;
  extern __shared__ __align__(1024) unsigned char smem[];
  const int n0 = n_tile * BN;
  const size_t w_off = static_cast<size_t>(e_sel) * p.k * p.nc;
  const __nv_bfloat16* w0 = p.w0 + w_off;
  const __nv_bfloat16* w1 = GATED ? p.w1 + w_off : nullptr;
  const uint32_t base = smem_u32(smem);
  constexpr int AC = BK / 8;  // chunks in a row of A's tile
  constexpr int BC = BN / 8;  // chunks in a row of B's tile

  auto load = [&](int slot, int kt) {
    const uint32_t sa = base + slot * T::STAGE_BYTES;
    const int k0 = kt * BK;
    // Rows past the block's last are not loaded: an output row reads its
    // own A row only, and those rows are never stored.
    for (int i = threadIdx.x; i < BM * AC; i += T::THREADS) {
      const int r = i / AC, c = i % AC;
      if (!FULL && r >= rows) break;
      const size_t src_row = GATED ? static_cast<size_t>(tok_s[r]) : static_cast<size_t>(row0 + r);
      cp_async16(sa + r * (BK * 2) + swz<AC>(r, c) * 16, p.a + src_row * p.k + k0 + c * 8, true);
    }
#pragma unroll
    for (int m = 0; m < T::NB; ++m) {
      const __nv_bfloat16* w = m == 0 ? w0 : w1;
      const uint32_t sb = sa + T::A_BYTES + m * T::B_BYTES;
      for (int i = threadIdx.x; i < BK * BC; i += T::THREADS) {
        const int r = i / BC, c = i % BC;
        cp_async16(sb + r * (BN * 2) + swz<BC>(r, c) * 16,
                   w + static_cast<size_t>(k0 + r) * p.nc + n0 + c * 8, true);
      }
    }
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  float acc[T::NB][T::MI][T::NI][4];
#pragma unroll
  for (int m = 0; m < T::NB; ++m)
#pragma unroll
    for (int i = 0; i < T::MI; ++i)
#pragma unroll
      for (int j = 0; j < T::NI; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[m][i][j][q] = 0.f;

  const int kts = p.k / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < kts) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < kts; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nk = kt + STAGES - 1;
    if (nk < kts) load(nk % STAGES, nk);
    cp_async_commit();

    const uint32_t sa = base + (kt % STAGES) * T::STAGE_BYTES;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[T::MI][4];
#pragma unroll
      for (int i = 0; i < T::MI; ++i) {
        if (FULL || wm * T::WM + i * 16 < rows) {
          const int r = wm * T::WM + i * 16 + lane % 16;
          ldmatrix_x4(a[i], sa + r * (BK * 2) + swz<AC>(r, kk * 2 + lane / 16) * 16);
        }
      }
#pragma unroll
      for (int m = 0; m < T::NB; ++m) {
        const uint32_t sb = sa + T::A_BYTES + m * T::B_BYTES;
        uint32_t b[T::NI][2];
#pragma unroll
        for (int j = 0; j < T::NI / 2; ++j) {
          const int r = kk * 16 + ((lane >> 3) & 1) * 8 + lane % 8;
          const int c = (wn * T::WN + j * 16) / 8 + (lane >> 4);
          uint32_t q[4];
          ldmatrix_x4_trans(q, sb + r * (BN * 2) + swz<BC>(r, c) * 16);
          b[2 * j][0] = q[0];
          b[2 * j][1] = q[1];
          b[2 * j + 1][0] = q[2];
          b[2 * j + 1][1] = q[3];
        }
#pragma unroll
        for (int i = 0; i < T::MI; ++i) {
          if (FULL || wm * T::WM + i * 16 < rows) {
#pragma unroll
            for (int j = 0; j < T::NI; ++j) mma_bf16(acc[m][i][j], a[i], b[j][0], b[j][1]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // Epilogue: the fragment's rows lane / 4 and lane / 4 + 8 of each 16-row
  // slice, columns 2 * (lane % 4) and one more of each 8-column slice.
#pragma unroll
  for (int i = 0; i < T::MI; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wm * T::WM + i * 16 + lane / 4 + half * 8;
      if (!FULL && r >= rows) continue;
#pragma unroll
      for (int j = 0; j < T::NI; ++j) {
        const int col = n0 + wn * T::WN + j * 8 + (lane % 4) * 2;
        const float v0 = acc[0][i][j][half * 2], v1 = acc[0][i][j][half * 2 + 1];
        if constexpr (GATED) {
          const float u0 = acc[T::NB - 1][i][j][half * 2], u1 = acc[T::NB - 1][i][j][half * 2 + 1];
          const float h0 = v0 / (1.f + __expf(-v0)) * u0;
          const float h1 = v1 / (1.f + __expf(-v1)) * u1;
          *reinterpret_cast<__nv_bfloat162*>(p.h + static_cast<size_t>(row0 + r) * p.nc + col) =
              __floats2bfloat162_rn(h0, h1);
        } else {
          float* dst = p.y + static_cast<size_t>(tok_s[r]) * p.nc + col;
          atomicAdd(dst, wt_s[r] * v0);
          atomicAdd(dst + 1, wt_s[r] * v1);
        }
      }
    }
  }
}

}  // namespace moe

// The variants: (BM, BN, BK, warps along M, along N, stages). Each is one
// __global__ function with a plain name that begins with moe_expert_, the
// name a profiler trace shows. Chosen by a sweep on an H100 at the
// published widths (PERF.md, section 6): 0 and 2 for a decode step (64
// tokens), 1 and 3 for a prefill (14,848 tokens).
#define MOE_VARIANTS(X)                            \
  X(gate_up, true, 64, 64, 64, 1, 4, 3)    /* 0 */ \
  X(gate_up, true, 128, 128, 64, 2, 4, 3)  /* 1 */ \
  X(down, false, 64, 64, 128, 2, 2, 3)     /* 2 */ \
  X(down, false, 128, 128, 64, 2, 4, 3)    /* 3 */

#define MOE_NAME(KIND, BM, BN, BK, WMW, WNW, ST) \
  moe_expert_##KIND##_##BM##x##BN##x##BK##_w##WMW##x##WNW##_s##ST

#define MOE_DEFINE(KIND, GATED, BM, BN, BK, WMW, WNW, ST)                                  \
  extern "C" __global__ void __launch_bounds__(32 * WMW * WNW)                             \
      MOE_NAME(KIND, BM, BN, BK, WMW, WNW, ST)(const moe::Args p) {                        \
    moe::body<BM, BN, BK, WMW, WNW, ST, GATED>(p);                                         \
  }
MOE_VARIANTS(MOE_DEFINE)

namespace {

struct Variant {
  const void* fn;
  bool gated;
  int bm, bn, bk, threads, smem;
};

#define MOE_ENTRY(KIND, GATED, BM, BN, BK, WMW, WNW, ST)                                   \
  {reinterpret_cast<const void*>(&MOE_NAME(KIND, BM, BN, BK, WMW, WNW, ST)), GATED, BM, BN, \
   BK, 32 * WMW * WNW, moe::Tile<BM, BN, BK, WMW, WNW, ST, GATED>::SMEM},
const Variant kVariants[] = {MOE_VARIANTS(MOE_ENTRY)};
constexpr int kNumVariants = sizeof(kVariants) / sizeof(kVariants[0]);
bool g_ready[kNumVariants] = {};

int launch(int v, moe::Args args, int p_pairs, cudaStream_t s) {
  const Variant& var = kVariants[v];
  if (!g_ready[v]) {  // once, before any capture: the first call is eager
    cudaError_t err = cudaFuncSetAttribute(var.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           var.smem);
    if (err != cudaSuccess) return (int)err;
    g_ready[v] = true;
  }
  args.m_blocks = (p_pairs + var.bm - 1) / var.bm + args.n_experts;
  args.n_tiles = args.nc / var.bn;
  if (args.group < 1) args.group = args.n_tiles;
  const unsigned grid = static_cast<unsigned>(args.m_blocks) * args.n_tiles;
  void* params[] = {&args};
  return (int)cudaLaunchKernel(var.fn, dim3(grid), dim3(var.threads), params, var.smem, s);
}

}  // namespace

extern "C" int moe_expert_variants() { return kNumVariants; }

// Variant v's (gated, BM, BN, BK, threads, shared bytes) into out[6].
extern "C" int moe_expert_variant(int v, int* out) {
  if (v < 0 || v >= kNumVariants) return -1;
  const Variant& var = kVariants[v];
  out[0] = var.gated;
  out[1] = var.bm;
  out[2] = var.bn;
  out[3] = var.bk;
  out[4] = var.threads;
  out[5] = var.smem;
  return 0;
}

// Both launches on `stream`: h [P, F] = SwiGLU of the sorted pairs (variant
// vg, a gated one), then y [N, D] += weight * h W_down (variant vd). x
// [N, D]; W_gate, W_up [E, D, F]; W_down [E, F, D]; order [P], counts [E],
// weight [P]. D and F are multiples of the variants' BK and BN (the
// wrapper checks). Returns the first cudaError, 0 if none.
extern "C" int moe_expert(const void* x, const void* w_gate, const void* w_up,
                          const void* w_down, void* h, void* y, const void* order,
                          const void* counts, const void* weight, int p_pairs, int d, int f,
                          int n_experts, int top_k, int vg, int vd, int group_g, int group_d,
                          void* stream) {
  if (vg < 0 || vg >= kNumVariants || vd < 0 || vd >= kNumVariants || !kVariants[vg].gated ||
      kVariants[vd].gated)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  moe::Args a{};
  a.order = static_cast<const int*>(order);
  a.counts = static_cast<const int*>(counts);
  a.weight = static_cast<const float*>(weight);
  a.top_k = top_k;
  a.n_experts = n_experts;

  a.a = static_cast<const __nv_bfloat16*>(x);
  a.w0 = static_cast<const __nv_bfloat16*>(w_gate);
  a.w1 = static_cast<const __nv_bfloat16*>(w_up);
  a.h = static_cast<__nv_bfloat16*>(h);
  a.k = d;
  a.nc = f;
  a.group = group_g;
  int err = launch(vg, a, p_pairs, s);
  if (err) return err;

  moe::Args b = a;
  b.a = static_cast<const __nv_bfloat16*>(h);
  b.w0 = static_cast<const __nv_bfloat16*>(w_down);
  b.w1 = nullptr;
  b.h = nullptr;
  b.y = static_cast<float*>(y);
  b.k = f;
  b.nc = d;
  b.group = group_d;
  return launch(vd, b, p_pairs, s);
}
