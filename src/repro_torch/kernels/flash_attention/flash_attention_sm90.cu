// Prefill attention of the LM serving path on Hopper's bf16 tensor cores.
//
// Replaces the Pallas kernel `flash_attention` of
// src/repro/kernels/flash_attention/kernel.py:77 (body `_flash_kernel`,
// :34-70) for bf16 inputs: softmax(q kᵀ · scale) v for q (B, H, Sq, D),
// k (B, Hkv, Sk, D) and v (B, Hkv, Sk, Dv), causal or not, GQA through the
// kv head h / (H / Hkv), output (B, H, Sq, Dv) in bf16.  The kernel is a
// template on the pair (D, Dv): D = Dv at 16, 32, 64 and 128, and (96, 64),
// the width pair of MLA's prefill (q/k 64 + 32 rope, v 64).  As there, the
// logits are scaled after the dot, masked logits are -1e30, the running
// max and sum are carried in fp32 and the final sum is floored at 1e-30.  Rows and keys past Sq / Sk are
// masked, so any S is taken (the TPU wrapper's `s // tq` drops a ragged
// tail).  fp32 inputs stay on the CUDA-core kernel of flash_attention.cu:
// the tensor cores would take them only as TF32 (ROADMAP rule b).
//
// What bounds it on this card: operations.  2·(D + Dv) per (query, key)
// pair it must score (4·D at equal widths), halved when causal — 5.4989e11 a layer at the Yi-6B prefill
// shape (4 x 32 x 4,096² x 128) — at the 989 TFLOP/s dense bf16 rate is
// 0.556 ms; its 302 MB of q, k, v and output take 0.090 ms at 3.35 TB/s.
// So the design keeps the two products on the tensor cores and everything
// else off their path:
//
// * One block per (128-row query tile, h, b), the query tile the slowest
//   grid axis so that the heaviest causal tiles of every head start first.
//   Three warpgroups: one warp of the first issues TMA loads and gives its
//   registers away (`setmaxnreg`); the other two each own 64 query rows and
//   take 240 registers a thread.
// * TMA loads the query tile once and streams 128-key K and V tiles
//   through a two-stage shared-memory ring with full and empty mbarriers,
//   so the loads of tile j+1 overlap the math on tile j.  Operands stay
//   bf16 in shared memory, in the swizzled layout the wgmma descriptors
//   read (128-byte swizzle at D = 64 and 128, 64 and 32 bytes at D = 32
//   and 16; at D = 96 three 32-wide column blocks with the 64-byte swizzle,
//   so S = Q·Kᵀ takes six k-steps of 16).  V and O take their own width's
//   geometry; where it differs from Q's, O is staged in a tile of its own.
//   The tensor maps are 4-D over the caller's (B, H, S, D) strides (the
//   model passes transposed views), K and V at the kv head: no GQA copy.  TMA zero-fills rows past Sq and Sk.
// * S = Q·Kᵀ by wgmma m64n128k16 from shared memory into fp32 registers;
//   scale, then mask only the tiles that cross the diagonal or Sk; online
//   softmax in registers, the row max reduced over the 4 threads that
//   share a row (the sum is reduced once, at the end).
// * O += P·V by wgmma with P as the register A operand (the accumulator
//   layout of S is the A-fragment layout of P·V), and V read from shared
//   memory in its natural (keys, D) layout through the transpose bit; O
//   accumulates in fp32 registers.  P is split into bf16 hi + lo halves,
//   two wgmmas a k-step: P rounded once to bf16 (2^-9 relative) breaks
//   the bf16 tolerance where a row's v values are large and its output
//   small, which the model's 1/√L weight scale makes (PERF.md §6).
//   The split costs one more P·V product, a third more tensor-core work.
// * The epilogue divides by max(l, 1e-30), writes bf16 into the
//   warpgroup's rows of the output tile in shared memory (at equal widths
//   the query tile, in the same swizzle) and stores them with one TMA
//   store, which clips rows past Sq.
//
// wgmma, TMA and mbarriers are written as inline PTX; no CuTe or CUTLASS.

#include "hopper.cuh"

namespace {

constexpr int kBM = 128;        // query rows of a block
constexpr int kBN = 128;        // keys of a K / V tile
constexpr int kThreads = 384;   // producer warpgroup + two consumers
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of a block at q/k width DQK and v width DV: Q, then two ring
// stages of (K, V), then the output staging tile when the widths differ
// (at equal widths the epilogue writes into each warpgroup's own Q rows,
// whose layout is the output's), then the mbarriers.
template <int DQK, int DV>
struct Smem {
  static constexpr int kQ = Geo<DQK>::kTile;
  static constexpr int kStage = Geo<DQK>::kTile + Geo<DV>::kTile;
  static constexpr int kO = DQK == DV ? 0 : Geo<DV>::kTile;
  static constexpr int kBars = kQ + 2 * kStage + kO;
  static constexpr int kBytes = kBars + 1024 + 64;  // + alignment, barriers
};

// LSE: write each row's log-sum-exp into ``lse`` (training); the serving
// instantiation (LSE false) carries no code for it
template <int DQK, int DV, bool LSE>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                                const __grid_constant__ CUtensorMap tm_k,
                                const __grid_constant__ CUtensorMap tm_v,
                                const __grid_constant__ CUtensorMap tm_o,
                                int group, int sq, int sk, float scale,
                                int causal, float* __restrict__ lse) {
  using G = Geo<DQK>;   // Q and K tiles
  using GV = Geo<DV>;   // V and output tiles
  using SM = Smem<DQK, DV>;
  constexpr int W = G::kW;
  constexpr int WV = GV::kW;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle patterns repeat every 1,024 bytes of shared address
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t kv_s = base + SM::kQ;  // stage s: K, then V, at s * kStage
  const uint32_t o_s = SM::kO ? kv_s + 2 * SM::kStage : q_s;
  const uint32_t bars = base + SM::kBars;
  const uint32_t bar_q = bars;
  // full_k[s] = bars + 8 (1 + s), full_v[s] = bars + 8 (3 + s),
  // empty[s] = bars + 8 (5 + s)

  const int hh = blockIdx.x, b = blockIdx.y;
  const int n_q = gridDim.z;
  const int qtile = causal ? n_q - 1 - static_cast<int>(blockIdx.z)
                           : static_cast<int>(blockIdx.z);
  const int q0 = qtile * kBM;
  const int kvh = hh / group;
  int n_tiles = (sk + kBN - 1) / kBN;
  if (causal) n_tiles = min(n_tiles, (min(q0 + kBM, sq) - 1) / kBN + 1);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(bars + 8 * (1 + s), 1);
      mbar_init(bars + 8 * (3 + s), 1);
      mbar_init(bars + 8 * (5 + s), 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread issues every TMA load of the block
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, G::kTile);
#pragma unroll
      for (int a = 0; a < G::kAtoms; ++a)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          tma_load(q_s + a * kBM * W + half * 64 * W, &tm_q, a * G::kBox,
                   q0 + 64 * half, hh, b, bar_q);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j & 1;
        if (j >= 2) mbar_wait(bars + 8 * (5 + s), ((j >> 1) - 1) & 1);
        const uint32_t k_dst = kv_s + s * SM::kStage;
        const uint32_t v_dst = k_dst + G::kTile;
        mbar_expect_tx(bars + 8 * (1 + s), G::kTile);
#pragma unroll
        for (int a = 0; a < G::kAtoms; ++a)
          tma_load(k_dst + a * kBN * W, &tm_k, a * G::kBox, j * kBN, kvh, b,
                   bars + 8 * (1 + s));
        mbar_expect_tx(bars + 8 * (3 + s), GV::kTile);
#pragma unroll
        for (int a = 0; a < GV::kAtoms; ++a)
          tma_load(v_dst + a * kBN * WV, &tm_v, a * GV::kBox, j * kBN, kvh,
                   b, bars + 8 * (3 + s));
      }
    }
    return;
  }

  // consumers: warpgroup cw owns query rows q0 + 64 cw .. + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int cw = wg - 1;
  const int t = threadIdx.x - 128 * wg;
  const int warp = t >> 5, lane = t & 31;
  // this thread's rows (r, r + 8) and first column pair in each 8-column
  // chunk of a wgmma accumulator
  const int r_loc = 64 * cw + 16 * warp + (lane >> 2);
  const int row = q0 + r_loc;
  const int c_loc = 2 * (lane & 3);
  const uint32_t q_wg = q_s + 64 * cw * W;
  const uint32_t o_wg = o_s + 64 * cw * WV;

  float o[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  mbar_wait(bar_q, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j & 1;
    const uint32_t parity = (j >> 1) & 1;
    const uint32_t k_s = kv_s + s * SM::kStage;
    const uint32_t v_s = k_s + G::kTile;
    const int k0 = j * kBN;

    // S = Q Kᵀ (64 x 128 per warpgroup), fp32 accumulators
    float sacc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) sacc[i] = 0.f;
    mbar_wait(bars + 8 * (1 + s), parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DQK / 16; ++kk) {
      const int a = kk / (G::kBox / 16);
      const uint32_t off = a * kBM * W + (kk % (G::kBox / 16)) * 32;
      wgmma_ss_n128(sacc, make_desc(q_wg + off, 16, 8 * W, G::kLayout),
                    make_desc(k_s + off, 16, 8 * W, G::kLayout), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sacc);

    // logits = dot · scale; masked -1e30 only where the tile crosses the
    // diagonal or Sk; running max over the row's 4 threads
    const bool edge = k0 + kBN > sk || (causal && k0 + kBN > q0 + 64 * cw);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      float x = sacc[i] * scale;
      if (edge) {
        const int col = k0 + 8 * (i >> 2) + c_loc + (i & 1);
        const int r = row + 8 * ((i >> 1) & 1);
        if (col >= sk || (causal && col > r)) x = kNegInf;
      }
      sacc[i] = x;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
    }
    float alpha[2], mb[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      alpha[h] = exp2_approx((m[h] - mx[h]) * kLog2e);
      m[h] = mx[h];
      mb[h] = mx[h] * kLog2e;
      l[h] *= alpha[h];
    }
    // P = exp(logits - max), summed in fp32, split into bf16 hi + lo as
    // the A operands: k-step kk takes accumulator chunks 2kk and 2kk+1
    uint32_t pa[kBN / 16][4], pb[kBN / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      float p[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int h = (e >> 1) & 1;
        p[e] = exp2_approx(fmaf(sacc[8 * kk + e], kLog2e, -mb[h]));
        l[h] += p[e];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split_bf16(p[2 * r], p[2 * r + 1], pa[kk][r], pb[kk][r]);
    }
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

    // O += P V (64 x D per warpgroup); V tile [keys][D] is MN-major
    mbar_wait(bars + 8 * (3 + s), parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      const uint64_t dv =
          make_desc(v_s + kk * 16 * WV, kBN * WV, 8 * WV, GV::kLayout);
      wgmma_pv<DV>(o, pa[kk], dv);
      wgmma_pv<DV>(o, pb[kk], dv);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      fence_regs(pa[kk]);
      fence_regs(pb[kk]);
    }
    if (lane == 0) mbar_arrive(bars + 8 * (5 + s));
  }

  // epilogue: O / max(l, 1e-30) in bf16 into this warpgroup's rows of the
  // output tile in shared memory (the query tile's at equal widths; the V
  // tiles' swizzle), then one TMA store a column block, clipped at Sq
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    inv[h] = 1.f / fmaxf(l[h], 1e-30f);
    // the row's log-sum-exp, for the backward (flash_attention_bwd.cu)
    if constexpr (LSE) {
      if ((lane & 3) == 0 && row + 8 * h < sq)
        lse[(static_cast<long long>(b) * gridDim.x + hh) * sq + row + 8 * h] =
            m[h] + logf(fmaxf(l[h], 1e-30f));
    }
  }
#pragma unroll
  for (int i = 0; i < DV / 2; i += 2) {
    const int h = (i >> 1) & 1;
    const int col = 8 * (i >> 2) + c_loc;
    const uint32_t off = (col / GV::kBox) * kBM * WV + (r_loc + 8 * h) * WV +
                         (col % GV::kBox) * 2;
    const uint32_t phys = off ^ ((off >> 3) & (WV - 16));
    const uint32_t v = pack_bf16(o[i] * inv[h], o[i + 1] * inv[h]);
    asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(o_s + phys), "r"(v)
                 : "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
  if (t == 0 && q0 + 64 * cw < sq) {
#pragma unroll
    for (int a = 0; a < GV::kAtoms; ++a)
      tma_store(&tm_o, o_wg + a * kBM * WV, a * GV::kBox, q0 + 64 * cw, hh,
                b);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}


template <int DQK, int DV>
int attention_sm90_d(const void* q, const void* k, const void* v, void* out,
                     int b, int h, int hkv, int sq, int sk, long long qsb,
                     long long qsh, long long qss, long long ksb,
                     long long ksh, long long kss, long long vsb,
                     long long vsh, long long vss, float scale, int causal,
                     float* lse, cudaStream_t stream) {
  using G = Geo<DQK>;
  using GV = Geo<DV>;
  constexpr int kSmem = Smem<DQK, DV>::kBytes;
  CUtensorMap tq, tk, tv, to;
  if (!make_map(&tq, q, DQK, sq, h, b, qss, qsh, qsb, G::kBox, 64,
                G::kSwizzle) ||
      !make_map(&tk, k, DQK, sk, hkv, b, kss, ksh, ksb, G::kBox, kBN,
                G::kSwizzle) ||
      !make_map(&tv, v, DV, sk, hkv, b, vss, vsh, vsb, GV::kBox, kBN,
                GV::kSwizzle) ||
      !make_map(&to, out, DV, sq, h, b, DV, static_cast<long long>(sq) * DV,
                static_cast<long long>(h) * sq * DV, GV::kBox, 64,
                GV::kSwizzle))
    return -2;
  auto kern = lse != nullptr ? flash_attention_sm90_kernel<DQK, DV, true>
                             : flash_attention_sm90_kernel<DQK, DV, false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(h, b, (sq + kBM - 1) / kBM);
  kern<<<grid, kThreads, kSmem, stream>>>(tq, tk, tv, to, h / hkv, sq, sk,
                                          scale, causal, lse);
  return 0;
}

}  // namespace

// Prefill attention on bf16 inputs: one 384-thread block per (h, b,
// 128-row query tile).  q, k (q/k width d) and v (width dv) bf16 with unit
// stride along the width and the given element strides along (B, H, S) —
// 16-byte-aligned bases and strides, as TMA takes them (the wrapper
// checks); out (B, H, Sq, dv) contiguous bf16; lse, when not null, (B, H,
// Sq) fp32 takes each row's log-sum-exp (max + log(max(sum, 1e-30)) of the
// scaled, masked logits) for the backward.  Built for the width pairs
// (16, 16), (32, 32), (64, 64), (128, 128) and (96, 64) (MLA: 64 + 32
// q/k, 64 v).  Returns 0 when launched (the caller checks the launch), -1
// for a width pair it is not built for, -2 when a tensor map cannot be
// made, or the CUDA error of the shared-memory attribute.
int flash_attention_sm90_launch(const void* q, const void* k, const void* v,
                                void* out, int b, int h, int hkv, int sq,
                                int sk, int d, int dv, long long qsb,
                                long long qsh, long long qss, long long ksb,
                                long long ksh, long long kss, long long vsb,
                                long long vsh, long long vss, float scale,
                                int causal, float* lse, cudaStream_t stream) {
#define FA_SM90_CASE(DQK, DV)                                                \
  if (d == DQK && dv == DV)                                                  \
    return attention_sm90_d<DQK, DV>(q, k, v, out, b, h, hkv, sq, sk, qsb,   \
                                     qsh, qss, ksb, ksh, kss, vsb, vsh, vss, \
                                     scale, causal, lse, stream);
  FA_SM90_CASE(16, 16)
  FA_SM90_CASE(32, 32)
  FA_SM90_CASE(64, 64)
  FA_SM90_CASE(128, 128)
  FA_SM90_CASE(96, 64)
#undef FA_SM90_CASE
  return -1;
}
