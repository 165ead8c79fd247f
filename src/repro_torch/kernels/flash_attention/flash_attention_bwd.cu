// Backward of the LM family's prefill attention (kernel 8), for training.
//
// The TPU reference has no backward kernel: it trains through
// `chunked_attention` (src/repro/models/attention.py:35-76), a checkpointed
// lax.scan that autodiff differentiates.  On the card the forward is the
// hand-written prefill kernel (flash_attention_sm90.cu for bf16,
// flash_attention.cu for fp32), which writes each row's log-sum-exp when
// asked; this file holds the gradients of the same function.  For q (B, H,
// Sq, D), k (B, Hkv, Sk, D), v (B, Hkv, Sk, Dv), the forward output o (B,
// H, Sq, Dv), its per-row log-sum-exp lse (B, H, Sq, fp32: max + log(max(
// sum, 1e-30)) of the scaled, masked logits) and the output's gradient do
// (B, H, Sq, Dv):
//
//   P  = exp(scale · q kᵀ - lse)      (0 where masked: causal, ragged tails)
//   D  = rowsum(do ∘ o)                (fp32, a pre-pass kernel)
//   dV = Pᵀ do,  dP = do vᵀ,  dS = P ∘ (dP - D)
//   dQ = scale · dS k,  dK = scale · dSᵀ q
//
// What bounds it on this card: operations.  Five products a (query, key)
// pair it must score — S, dQ and dK at the q/k width, dP and dV at the v
// width: 2·(3·D + 2·Dv) operations — halved when causal, at 989 TFLOP/s
// in bf16 and 67 TFLOP/s in fp32.  Every sum is taken in a fixed order in
// one block, with no float atomics (ROADMAP rule d): two launches on the
// same inputs give the same bits.
//
// bf16 (Hopper's tensor cores, the forward's machinery of hopper.cuh): two
// kernels of three warpgroups, a producer warp issuing TMA loads through
// an mbarrier ring and two consumer warpgroups that take turns issuing a
// tile's first products (named barriers), so that one's exp and masking
// overlap the other's products.
//
// * dK/dV: one block per (128-key tile, kv head, b), the heavy causal
//   tiles (the first keys) first.  The producer streams each query head
//   of the kv head's group, in head order, as 64-row tiles of Q and dO
//   with their rows of lse and D (four stages); each consumer warpgroup
//   keeps 64 keys of K and V resident and computes, a tile at a time, Sᵀ =
//   K·Qᵀ and dPᵀ = V·doᵀ (wgmma from shared memory), Pᵀ and dSᵀ in fp32
//   registers, then dV += Pᵀ·do and dK += dSᵀ·q with Pᵀ and dSᵀ as
//   register A operands.  dK and dV stay in registers over the whole
//   loop.  Causal tiles wholly above a warpgroup's keys are skipped.
// * dQ: one block per (128-row query tile, h, b), the heavy causal tiles
//   (the last rows) first; Q, dO, lse and D resident, K and V streamed as
//   128-key tiles (two stages; the wider tile halves the shared-memory
//   reads of S and dP a FLOP); S and dP recomputed, P formed while dP
//   runs, dQ += dS·k with dS from registers.  S and dP are thus computed
//   twice (7 products a pair in all); per-KV-tile dQ partials would avoid
//   that but cost more in memory than they save at the training shapes
//   (≈ 2.2 GB at Yi-6B's call).
// * P and dS enter their products rounded once to bf16, not split into
//   hi + lo halves as the forward splits P: measured with
//   `ops.flash_attention_backward_tc_plain` on every recorded and edge
//   call, one rounding stays within half of the bf16 bar (PERF.md §6).
//
// fp32 (CUDA cores, no TF32, ROADMAP rule b): one kernel per (KV tile of
// up to 256 keys, kv head, b) computes S and dP once a pair.  For each
// query tile of the group's heads (in head order) it forms Pᵀ and dSᵀ in
// shared memory from 4 x 4 register tiles fed by float4 loads (rows padded
// by 4 floats: aligned and free of bank conflicts), adds Pᵀ·do and dSᵀ·q
// into dK and dV held in registers, and the tile's dS·k into dQ: written
// directly when the block's tile holds every key (BERT4Rec's S 200, the
// cross-check's 64), else as a per-KV-tile partial that a second kernel
// sums in KV-tile order.

#include <climits>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

// bf16: tiles, threads, ring stages
constexpr int kRes = 128;        // resident rows (keys of dK/dV, rows of dQ)
constexpr int kStream = 64;      // rows of a streamed tile
constexpr int kTcThreads = 384;  // producer warpgroup + two consumers
constexpr int kStages = 4;       // ring stages of dK/dV's streamed tiles
constexpr int kDqKeys = 128;     // keys of dQ's streamed K and V tiles
constexpr int kDqStages = 2;     // ring stages of dQ's streamed tiles
constexpr float kLog2e = 1.4426950408889634f;
// fp32 and the pre-pass
constexpr int kF32Threads = 256;
constexpr int kDeltaThreads = 256;

struct Strides {
  long long b, h, s;  // element strides of the (B, H, S) axes; D is unit
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// D = rowsum(do ∘ o) of every (b, h, row): one warp a row, fp32.
template <typename T>
__global__ void __launch_bounds__(kDeltaThreads)
    bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                     float* __restrict__ delta, long long rows, int dv) {
  const long long row =
      (static_cast<long long>(blockIdx.x) * kDeltaThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* orow = o + row * dv;
  const T* drow = dout + row * dv;
  float s = 0.f;
  for (int d = lane; d < dv; d += 32) s += to_f32(orow[d]) * to_f32(drow[d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[row] = s;
}

// ---------------------------------------------------------------------------
// bf16: wgmma fed by TMA
// ---------------------------------------------------------------------------

// A 1-D grid over (tile, head, b), the tile slowest, so that blocks start in
// tile order: `heavy_last` reverses it (dQ's causal tiles grow with the
// row, dK/dV's shrink with the key).
struct TileHead {
  int tile, head, b;
};
__device__ __forceinline__ TileHead tile_head(int n_heads, int n_b,
                                              int n_tiles, int heavy_last) {
  const int per = n_heads * n_b;
  const int idx = static_cast<int>(blockIdx.x);
  const int t = idx / per, rest = idx % per;
  return {heavy_last ? n_tiles - 1 - t : t, rest % n_heads, rest / n_heads};
}

// Accumulator registers of a 64 x N wgmma, rounded to bf16, as the A
// operands of N / 16 k-steps of 16 (the accumulator's columns 16kk ..
// 16kk + 15 are k-step kk).
template <int N>
__device__ __forceinline__ void to_frags(const float (&c)[N / 2],
                                         uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack_bf16(c[8 * kk + 2 * r], c[8 * kk + 2 * r + 1]);
}

// The two consumer warpgroups take turns issuing a tile's first products
// (named barriers 1 and 2 of 256 threads: one warpgroup waits at its own,
// the other arrives), so that one's exp and masking overlap the other's
// products.  Warpgroup 1 lets 0 go first and does not pass its last turn,
// so every arrival is matched.
__device__ __forceinline__ void turn_wait(int cw) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + cw) : "memory");
}
__device__ __forceinline__ void turn_pass(int cw) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - cw) : "memory");
}

// acc (64 x D) += a (64 x 16, registers) · rows 16kk .. 16kk + 15 of a
// bf16 tile of ROWS rows (ROWS x D, MN-major) at shared address `tile`.
// At D = 96 one 32-wide product a column block; else one over the width.
template <int D, int ROWS>
__device__ __forceinline__ void rs_product(float (&acc)[D / 2],
                                           const uint32_t (&a)[4],
                                           uint32_t tile, int kk) {
  using G = Geo<D>;
  constexpr int W = G::kW;
  if constexpr (D == 96) {
#pragma unroll
    for (int at = 0; at < 3; ++at)
      wgmma_rs_n32(*reinterpret_cast<float(*)[16]>(acc + 16 * at), a,
                   make_desc(tile + at * ROWS * W + kk * 16 * W, ROWS * W,
                             8 * W, G::kLayout));
  } else {
    wgmma_pv<D>(acc, a, make_desc(tile + kk * 16 * W, ROWS * W, 8 * W,
                                  G::kLayout));
  }
}

// c (64 x N) = rows a_row .. a_row + 63 of a resident tile (128 rows) ·
// the streamed tile's (N rows, 64 or 128) transposed, over width D: both
// K-major, the width in k-steps of 16 through the tiles' column blocks.
template <int D, int N>
__device__ __forceinline__ void ss_product(float (&c)[N / 2], uint32_t a_tile,
                                           int a_row, uint32_t b_tile) {
  using G = Geo<D>;
  constexpr int W = G::kW;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int at = kk / (G::kBox / 16);
    const uint32_t off = (kk % (G::kBox / 16)) * 32;
    const uint64_t a = make_desc(a_tile + at * kRes * W + a_row * W + off, 16,
                                 8 * W, G::kLayout);
    const uint64_t b =
        make_desc(b_tile + at * N * W + off, 16, 8 * W, G::kLayout);
    if constexpr (N == 64)
      wgmma_ss_n64(c, a, b, kk > 0);
    else
      wgmma_ss_n128(c, a, b, kk > 0);
  }
}

// TMA loads of `rows` (64 or 128) rows from `row0` of head `hh` of batch
// `b` into a tile of that many rows, 64 rows a box.
template <int D>
__device__ __forceinline__ void load_rows(uint32_t dst, const CUtensorMap* map,
                                          int rows, int row0, int hh, int b,
                                          uint32_t bar) {
  using G = Geo<D>;
#pragma unroll
  for (int at = 0; at < G::kAtoms; ++at)
    for (int half = 0; half < rows / 64; ++half)
      tma_load(dst + at * rows * G::kW + half * 64 * G::kW, map,
               at * G::kBox, row0 + 64 * half, hh, b, bar);
}

// Shared memory of the dK/dV kernel: K and V (128 rows) resident, the ring
// stages' (Q, dO) tiles (64 rows), their rows of lse·log2(e) and D, the
// mbarriers.  Every tile starts on a 1,024-byte boundary.
template <int D, int DV>
struct DkdvSmem {
  static constexpr int kK = Geo<D>::kTile;
  static constexpr int kV = Geo<DV>::kTile;
  static constexpr int kQ = Geo<D>::kTile / 2;
  static constexpr int kTiles = kQ + Geo<DV>::kTile / 2;  // a stage's tiles
  static constexpr int kRowsOff = kK + kV + kStages * kTiles;
  static constexpr int kBars = kRowsOff + kStages * 2 * kStream * 4;
  static constexpr int kBytes = kBars + 1024 + 8 * (1 + 2 * kStages);
};

// Shared memory of the dQ kernel: Q and dO (128 rows) resident, the ring
// stages' (K, V) tiles (kDqKeys rows), the mbarriers.
template <int D, int DV>
struct DqSmem {
  static constexpr int kQ = Geo<D>::kTile;
  static constexpr int kDo = Geo<DV>::kTile;
  static constexpr int kK = Geo<D>::kTile * kDqKeys / 128;
  static constexpr int kStage = kK + Geo<DV>::kTile * kDqKeys / 128;
  static constexpr int kBars = kQ + kDo + kDqStages * kStage;
  static constexpr int kBytes = kBars + 1024 + 8 * (1 + 2 * kDqStages);
};

// dK / dV.  Barriers: the resident tiles' (1 arrival), full[s] (the
// producer warp's 32 lanes: lse and D rows written, and the TMA bytes),
// empty[s] (the 8 consumer warps).
template <int D, int DV>
__global__ void __launch_bounds__(kTcThreads, 1)
    bwd_dkdv_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_do,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       bf16* __restrict__ dk, bf16* __restrict__ dv,
                       int n_kv_heads, int n_b, int group, int sq, int sk,
                       float scale, int causal) {
  using SM = DkdvSmem<D, DV>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t k_s = base, v_s = base + SM::kK;
  const uint32_t ring = base + SM::kK + SM::kV;  // stage s: Q, dO
  float* rows_s = reinterpret_cast<float*>(smem_raw + (base - raw) +
                                           SM::kRowsOff);
  const uint32_t bars = base + SM::kBars;
  // bars: resident; full[s] at 8 (1 + s); empty[s] at 8 (1 + kStages + s)

  const int n_kt = (sk + kRes - 1) / kRes;
  const TileHead th = tile_head(n_kv_heads, n_b, n_kt, 0);
  const int kvh = th.head, b = th.b, k0 = th.tile * kRes;
  const int n_heads = n_kv_heads * group;
  const int first = causal ? k0 : 0;  // the first query row with work
  const int n_qt = (sq - first + kStream - 1) / kStream;
  const int n_iter = n_qt > 0 ? group * n_qt : 0;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * (1 + s), 32);
      mbar_init(bars + 8 * (1 + kStages + s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_expect_tx(bars, SM::kK + SM::kV);
        load_rows<D>(k_s, &tm_k, kRes, k0, kvh, b, bars);
        load_rows<DV>(v_s, &tm_v, kRes, k0, kvh, b, bars);
      }
      for (int it = 0; it < n_iter; ++it) {
        const int s = it % kStages;
        const int hh = kvh * group + it / n_qt;
        const int q0 = first + (it % n_qt) * kStream;
        const uint32_t full = bars + 8 * (1 + s);
        if (it >= kStages)
          mbar_wait(bars + 8 * (1 + kStages + s), (it / kStages - 1) & 1);
        const long long bh = static_cast<long long>(b) * n_heads + hh;
        float* rs = rows_s + s * 2 * kStream;
        for (int r = lane; r < kStream; r += 32) {
          const int row = q0 + r;
          rs[r] = row < sq ? lse[bh * sq + row] * kLog2e : 0.f;
          rs[kStream + r] = row < sq ? delta[bh * sq + row] : 0.f;
        }
        if (lane == 0) {
          const uint32_t q_dst = ring + s * SM::kTiles;
          mbar_expect_tx(full, SM::kTiles);
          load_rows<D>(q_dst, &tm_q, kStream, q0, hh, b, full);
          load_rows<DV>(q_dst + SM::kQ, &tm_do, kStream, q0, hh, b, full);
        } else {
          mbar_arrive(full);
        }
      }
    }
    return;
  }

  // consumers: warpgroup cw owns keys k0 + 64 cw .. + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int cw = wg - 1;
  const int t = threadIdx.x - 128 * wg;
  const int warp = t >> 5, lane = t & 31;
  // this thread's keys (key, key + 8) and first column pair in each
  // 8-column chunk of an accumulator
  const int r_loc = 64 * cw + 16 * warp + (lane >> 2);
  const int key = k0 + r_loc;
  const int c_loc = 2 * (lane & 3);
  const int key_lo = k0 + 64 * cw;
  const float sl2 = scale * kLog2e;

  float acc_k[D / 2], acc_v[DV / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_k[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) acc_v[i] = 0.f;

  // A tile's products are committed as two groups: Sᵀ and dPᵀ, then dV
  // and dK.
  uint32_t pa[4][4], da[4][4];
  if (cw == 1 && n_iter > 0) turn_pass(cw);
  mbar_wait(bars, 0);
  for (int it = 0; it < n_iter; ++it) {
    const int s = it % kStages;
    const int q0 = first + (it % n_qt) * kStream;
    const uint32_t q_t = ring + s * SM::kTiles, do_t = q_t + SM::kQ;
    const float* rs = rows_s + s * 2 * kStream;
    const bool pass = cw == 0 || it + 1 < n_iter;
    mbar_wait(bars + 8 * (1 + s), (it / kStages) & 1);
    turn_wait(cw);
    // causal: a tile wholly above this warpgroup's keys adds nothing
    if (causal && q0 + kStream <= key_lo) {
      if (pass) turn_pass(cw);
      if (lane == 0) mbar_arrive(bars + 8 * (1 + kStages + s));
      continue;
    }
    // Sᵀ = K Qᵀ and dPᵀ = V dOᵀ: 64 keys x 64 query rows
    float st[32], dpt[32];
    wgmma_fence();
    ss_product<D, kStream>(st, k_s, 64 * cw, q_t);
    ss_product<DV, kStream>(dpt, v_s, 64 * cw, do_t);
    wgmma_commit();
    if (pass) turn_pass(cw);
    wgmma_wait_all();
    fence_regs(st);
    fence_regs(dpt);
    const bool edge = q0 + kStream > sq || key_lo + 64 > sk ||
                      (causal && q0 < key_lo + 64);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = 8 * (i >> 2) + c_loc + (i & 1);
      float p = exp2_approx(fmaf(st[i], sl2, -rs[col]));
      if (edge) {
        const int row = q0 + col, kr = key + 8 * ((i >> 1) & 1);
        if (row >= sq || kr >= sk || (causal && kr > row)) p = 0.f;
      }
      st[i] = p;
      dpt[i] = p * (dpt[i] - rs[kStream + col]);
    }
    to_frags<kStream>(st, pa);
    to_frags<kStream>(dpt, da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      rs_product<DV, kStream>(acc_v, pa[kk], do_t, kk);
      rs_product<D, kStream>(acc_k, da[kk], q_t, kk);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc_v);
    fence_regs(acc_k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      fence_regs(pa[kk]);
      fence_regs(da[kk]);
    }
    if (lane == 0) mbar_arrive(bars + 8 * (1 + kStages + s));
  }

  const long long bkv = static_cast<long long>(b) * n_kv_heads + kvh;
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int kr = key + 8 * ((i >> 1) & 1);
    if (kr < sk)
      *reinterpret_cast<__nv_bfloat162*>(dk + (bkv * sk + kr) * D +
                                         8 * (i >> 2) + c_loc) =
          __floats2bfloat162_rn(acc_k[i] * scale, acc_k[i + 1] * scale);
  }
#pragma unroll
  for (int i = 0; i < DV / 2; i += 2) {
    const int kr = key + 8 * ((i >> 1) & 1);
    if (kr < sk)
      *reinterpret_cast<__nv_bfloat162*>(dv + (bkv * sk + kr) * DV +
                                         8 * (i >> 2) + c_loc) =
          __floats2bfloat162_rn(acc_v[i], acc_v[i + 1]);
  }
}

// dQ.  Barriers: the resident tiles' (1 arrival), full[s] (1: the TMA
// bytes), empty[s] (the 8 consumer warps).
template <int D, int DV>
__global__ void __launch_bounds__(kTcThreads, 1)
    bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dq,
                     int n_heads, int n_b, int group, int sq, int sk,
                     float scale, int causal) {
  using SM = DqSmem<D, DV>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base, do_s = base + SM::kQ;
  const uint32_t ring = base + SM::kQ + SM::kDo;  // stage s: K, V
  const uint32_t bars = base + SM::kBars;

  const int n_q = (sq + kRes - 1) / kRes;
  const TileHead th = tile_head(n_heads, n_b, n_q, causal);
  const int hh = th.head, b = th.b, q0 = th.tile * kRes;
  const int kvh = hh / group;
  int n_kv = (sk + kDqKeys - 1) / kDqKeys;
  if (causal) n_kv = min(n_kv, (min(q0 + kRes, sq) - 1) / kDqKeys + 1);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int s = 0; s < kDqStages; ++s) {
      mbar_init(bars + 8 * (1 + s), 1);
      mbar_init(bars + 8 * (1 + kDqStages + s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(bars, SM::kQ + SM::kDo);
      load_rows<D>(q_s, &tm_q, kRes, q0, hh, b, bars);
      load_rows<DV>(do_s, &tm_do, kRes, q0, hh, b, bars);
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % kDqStages;
        const uint32_t full = bars + 8 * (1 + s);
        if (j >= kDqStages)
          mbar_wait(bars + 8 * (1 + kDqStages + s), (j / kDqStages - 1) & 1);
        const uint32_t k_dst = ring + s * SM::kStage;
        mbar_expect_tx(full, SM::kStage);
        load_rows<D>(k_dst, &tm_k, kDqKeys, j * kDqKeys, kvh, b, full);
        load_rows<DV>(k_dst + SM::kK, &tm_v, kDqKeys, j * kDqKeys, kvh, b,
                      full);
      }
    }
    return;
  }

  // consumers: warpgroup cw owns query rows q0 + 64 cw .. + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int cw = wg - 1;
  const int t = threadIdx.x - 128 * wg;
  const int warp = t >> 5, lane = t & 31;
  const int row_lo = q0 + 64 * cw;
  const int row = row_lo + 16 * warp + (lane >> 2);  // and row + 8
  const int c_loc = 2 * (lane & 3);
  const float sl2 = scale * kLog2e;
  const long long bh = static_cast<long long>(b) * n_heads + hh;
  float lse2[2], del[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int r = row + 8 * h2;
    lse2[h2] = r < sq ? lse[bh * sq + r] * kLog2e : 0.f;
    del[h2] = r < sq ? delta[bh * sq + r] : 0.f;
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  // A tile's products are committed as three groups: S, dP, dQ; P is
  // formed while dP runs.
  constexpr int N = kDqKeys;
  uint32_t da[N / 16][4];
  if (cw == 1 && n_kv > 0) turn_pass(cw);
  mbar_wait(bars, 0);
  for (int j = 0; j < n_kv; ++j) {
    const int s = j % kDqStages;
    const int k0 = j * N;
    const uint32_t k_t = ring + s * SM::kStage, v_t = k_t + SM::kK;
    const bool pass = cw == 0 || j + 1 < n_kv;
    mbar_wait(bars + 8 * (1 + s), (j / kDqStages) & 1);
    turn_wait(cw);
    // causal: a tile wholly right of this warpgroup's rows adds nothing
    if (causal && k0 >= row_lo + 64) {
      if (pass) turn_pass(cw);
      if (lane == 0) mbar_arrive(bars + 8 * (1 + kDqStages + s));
      continue;
    }
    // S = Q Kᵀ and dP = dO Vᵀ: 64 query rows x N keys
    float sa[N / 2], dpa[N / 2];
    wgmma_fence();
    ss_product<D, N>(sa, q_s, 64 * cw, k_t);
    wgmma_commit();
    ss_product<DV, N>(dpa, do_s, 64 * cw, v_t);
    wgmma_commit();
    if (pass) turn_pass(cw);
    wgmma_wait<1>();  // S is done
    fence_regs(sa);
    // P = exp(scale s - lse), 0 where masked
    const bool edge = k0 + N > sk || row_lo + 64 > sq ||
                      (causal && k0 + N > row_lo + 1);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const int h2 = (i >> 1) & 1;
      float p = exp2_approx(fmaf(sa[i], sl2, -lse2[h2]));
      if (edge) {
        const int kc = k0 + 8 * (i >> 2) + c_loc + (i & 1);
        const int r = row + 8 * h2;
        if (kc >= sk || r >= sq || (causal && kc > r)) p = 0.f;
      }
      sa[i] = p;
    }
    wgmma_wait<0>();  // dP is done
    fence_regs(dpa);
    // dS = P (dP - D); dQ += dS K, dS as the register A operand
#pragma unroll
    for (int i = 0; i < N / 2; ++i) sa[i] *= dpa[i] - del[(i >> 1) & 1];
    to_frags<N>(sa, da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) rs_product<D, N>(acc, da[kk], k_t, kk);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) fence_regs(da[kk]);
    if (lane == 0) mbar_arrive(bars + 8 * (1 + kDqStages + s));
  }

  bf16* out = dq + bh * sq * D;
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int r = row + 8 * ((i >> 1) & 1);
    if (r < sq)
      *reinterpret_cast<__nv_bfloat162*>(out + static_cast<long long>(r) * D +
                                         8 * (i >> 2) + c_loc) =
          __floats2bfloat162_rn(acc[i] * scale, acc[i + 1] * scale);
  }
}

template <typename Kernel>
cudaError_t smem_attr(Kernel kern, size_t bytes) {
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int D, int DV>
int backward_tc(const void* q, const void* k, const void* v,
                const void* dout, const float* lse, const float* delta,
                void* dq, void* dk, void* dv, int b, int h, int hkv, int sq,
                int sk, Strides qs, Strides ks, Strides vs, float scale,
                int causal, cudaStream_t stream) {
  using G = Geo<D>;
  using GV = Geo<DV>;
  CUtensorMap tq, tk, tv, tdo;
  if (!make_map(&tq, q, D, sq, h, b, qs.s, qs.h, qs.b, G::kBox, 64,
                G::kSwizzle) ||
      !make_map(&tk, k, D, sk, hkv, b, ks.s, ks.h, ks.b, G::kBox, 64,
                G::kSwizzle) ||
      !make_map(&tv, v, DV, sk, hkv, b, vs.s, vs.h, vs.b, GV::kBox, 64,
                GV::kSwizzle) ||
      !make_map(&tdo, dout, DV, sq, h, b, DV,
                static_cast<long long>(sq) * DV,
                static_cast<long long>(h) * sq * DV, GV::kBox, 64,
                GV::kSwizzle))
    return -2;
  auto kq = bwd_dq_tc_kernel<D, DV>;
  auto kkv = bwd_dkdv_tc_kernel<D, DV>;
  cudaError_t err;
  if ((err = smem_attr(kq, DqSmem<D, DV>::kBytes)) != cudaSuccess ||
      (err = smem_attr(kkv, DkdvSmem<D, DV>::kBytes)) != cudaSuccess)
    return static_cast<int>(err);
  const int group = h / hkv;
  const long long n_q = (sq + kRes - 1) / kRes, n_kt = (sk + kRes - 1) / kRes;
  if (n_q * h * b > INT_MAX || n_kt * hkv * b > INT_MAX) return -4;
  kq<<<static_cast<unsigned>(n_q * h * b), kTcThreads,
       DqSmem<D, DV>::kBytes, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<bf16*>(dq), h, b, group, sq,
      sk, scale, causal);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  kkv<<<static_cast<unsigned>(n_kt * hkv * b), kTcThreads,
        DkdvSmem<D, DV>::kBytes, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), hkv, b, group, sq, sk, scale, causal);
  return 0;
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores, register tiles (no TF32)
// ---------------------------------------------------------------------------

// The fp32 kernel's tiles at widths (D, DV), 256 threads.  A KV tile of
// kKeys keys (all of S up to 256 at the narrow widths); query tiles of
// kRows rows, so that a tile's kKeys x kRows pairs are 4 x 4 a thread
// (phase 1: keys and rows strided by a quarter of the tile).  In phase 2
// (dK, dV) thread (kg, g4) owns keys 4kg .. 4kg + 3 and kCK columns of dK
// and kCV of dV; in phase 3 (the tile's dQ) 4 rows x kC3 columns over one
// of kSlices interleaved slices of the keys, the slices summed in order.
template <int D, int DV>
struct F32 {
  static constexpr int kKeys = D + DV <= 64 ? 256 : D + DV <= 160 ? 128 : 64;
  static constexpr int kRows = 4096 / kKeys;
  static constexpr int kLQ = D + 4, kLV = DV + 4, kLP = kKeys + 4;
  static constexpr int kKG = kKeys / 4;           // key groups (phases 1, 2)
  static constexpr int kRG = kRows / 4;           // row groups (phase 1)
  static constexpr int kCG = kF32Threads / kKG;   // column groups (phase 2)
  static constexpr int kWK = kKG / 8;             // warps along the keys
  static constexpr int kCK = D / kCG, kCV = DV / kCG;
  static constexpr int kC3 = D == 128 ? 8 : D == 96 ? 12 : 4;
  static constexpr int kTiles3 = kRG * (D / kC3);
  static constexpr int kSlices = kF32Threads / kTiles3;
  // shared floats: K, V, Q, dO, Pᵀ and dSᵀ as [row][key], lse, D, and the
  // dQ partials of slices 1 ..
  static constexpr int kK = 0, kV = kK + kKeys * kLQ, kQ = kV + kKeys * kLV;
  static constexpr int kDo = kQ + kRows * kLQ, kP = kDo + kRows * kLV;
  static constexpr int kDs = kP + kRows * kLP, kLse = kDs + kRows * kLP;
  static constexpr int kDel = kLse + kRows, kRed = kDel + kRows;
  static constexpr int kFloats = kRed + (kSlices - 1) * kRows * D;
  // floats of the next query tile's Q and dO rows a thread reads ahead
  // (none where they would not fit in registers beside the tiles')
  static constexpr int kPre =
      kRows * (D + DV) <= 20 * kF32Threads ? kRows * (D + DV) / kF32Threads
                                            : 0;
  static constexpr bool kPrefetch = kPre > 0;
  static_assert(kCK % 4 == 0 && kCV % 4 == 0 && kC3 % 4 == 0 &&
                    kTiles3 * kSlices == kF32Threads,
                "fp32 backward tiling");
};

// Rows r0 .. r0 + ROWS - 1 of a (S, W) fp32 slice with row stride `ss` into
// a [ROWS][LD] tile; rows at or past `limit` are 0.
template <int W, int LD, int ROWS>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src,
                                              long long ss, int r0,
                                              int limit) {
  for (int i = threadIdx.x; i < ROWS * W; i += kF32Threads) {
    const int r = i / W, c = i % W;
    dst[r * LD + c] = r0 + r < limit ? src[(r0 + r) * ss + c] : 0.f;
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// The rows q0 .. q0 + kRows - 1 of a query tile: Q (row stride `qss`), dO
// (contiguous), lse and D (from `off`), 0 past Sq; `read` takes this
// thread's share into registers, `write` stores it into the tiles, and
// `direct` copies them at once.
template <int D, int DV>
struct TileRows {
  using F = F32<D, DV>;
  static constexpr int kQ = F::kRows * D / kF32Threads;   // slots of Q
  float x[F::kPre > 0 ? F::kPre : 1];
  float l, dl;

  __device__ __forceinline__ void read(const float* qb, long long qss,
                                       const float* dob, const float* lse,
                                       const float* delta, long long off,
                                       int q0, int sq) {
#pragma unroll
    for (int m = 0; m < F::kPre; ++m) {
      if (m < kQ) {
        const int e = threadIdx.x + m * kF32Threads, r = e / D;
        x[m] = q0 + r < sq ? qb[(q0 + r) * qss + e % D] : 0.f;
      } else {
        const int e = threadIdx.x + (m - kQ) * kF32Threads, r = e / DV;
        x[m] = q0 + r < sq ? dob[static_cast<long long>(q0 + r) * DV +
                                 e % DV]
                           : 0.f;
      }
    }
    const int r = q0 + static_cast<int>(threadIdx.x);
    const bool in = threadIdx.x < F::kRows && r < sq;
    l = in ? lse[off + r] : 0.f;
    dl = in ? delta[off + r] : 0.f;
  }

  __device__ __forceinline__ void write(float* q_s, float* do_s,
                                        float* lse_s, float* del_s) const {
#pragma unroll
    for (int m = 0; m < F::kPre; ++m) {
      if (m < kQ) {
        const int e = threadIdx.x + m * kF32Threads;
        q_s[(e / D) * F::kLQ + e % D] = x[m];
      } else {
        const int e = threadIdx.x + (m - kQ) * kF32Threads;
        do_s[(e / DV) * F::kLV + e % DV] = x[m];
      }
    }
    if (threadIdx.x < F::kRows) {
      lse_s[threadIdx.x] = l;
      del_s[threadIdx.x] = dl;
    }
  }

  static __device__ __forceinline__ void direct(
      float* q_s, float* do_s, float* lse_s, float* del_s, const float* qb,
      long long qss, const float* dob, const float* lse, const float* delta,
      long long off, int q0, int sq) {
    load_rows_f32<D, F::kLQ, F::kRows>(q_s, qb, qss, q0, sq);
    load_rows_f32<DV, F::kLV, F::kRows>(do_s, dob, DV, q0, sq);
    if (threadIdx.x < F::kRows) {
      const int r = q0 + threadIdx.x;
      lse_s[threadIdx.x] = r < sq ? lse[off + r] : 0.f;
      del_s[threadIdx.x] = r < sq ? delta[off + r] : 0.f;
    }
  }
};

template <int D, int DV>
__global__ void __launch_bounds__(kF32Threads, 1)
    bwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const float* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dq,
                   float* __restrict__ dq_part, float* __restrict__ dk,
                   float* __restrict__ dv, Strides qs, Strides ks,
                   Strides vs, int n_kv_heads, int n_b, int group, int sq,
                   int sk, float scale, int causal) {
  using F = F32<D, DV>;
  extern __shared__ float4 f32_smem[];
  float* sm = reinterpret_cast<float*>(f32_smem);
  float *k_s = sm + F::kK, *v_s = sm + F::kV, *q_s = sm + F::kQ;
  float *do_s = sm + F::kDo, *p_s = sm + F::kP, *ds_s = sm + F::kDs;
  float *lse_s = sm + F::kLse, *del_s = sm + F::kDel, *red = sm + F::kRed;

  const int n_kt = (sk + F::kKeys - 1) / F::kKeys;
  const TileHead th = tile_head(n_kv_heads, n_b, n_kt, 0);
  const int kvh = th.head, b = th.b, kt = th.tile, k0 = kt * F::kKeys;
  const int n_heads = n_kv_heads * group;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // a warp's lanes: 8 key groups x 4 row (phase 1) or column (phase 2)
  // groups, so its float4 loads read 8 and 4 distinct padded rows
  const int kg = (warp % F::kWK) * 8 + (lane & 7);
  const int g4 = (warp / F::kWK) * 4 + (lane >> 3);
  // phase 1: keys kg + i kKG, rows g4 + j kRG
  // phase 2: keys 4 kg .., columns g4 kCK .. (dK), g4 kCV .. (dV)
  // phase 3: tile (r3, c3) of rows r3 + i kRG and columns c3 kC3 .., slice
  // sl
  const int t3 = tid % F::kTiles3, sl = tid / F::kTiles3;
  const int r3 = t3 % F::kRG, c3 = t3 / F::kRG;

  load_rows_f32<D, F::kLQ, F::kKeys>(k_s, k + b * ks.b + kvh * ks.h, ks.s,
                                     k0, sk);
  load_rows_f32<DV, F::kLV, F::kKeys>(v_s, v + b * vs.b + kvh * vs.h, vs.s,
                                      k0, sk);
  float acc_k[4][F::kCK], acc_v[4][F::kCV];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < F::kCK; ++c) acc_k[i][c] = 0.f;
#pragma unroll
    for (int c = 0; c < F::kCV; ++c) acc_v[i][c] = 0.f;
  }

  // the tile's keys below Sk: a warp skips its keys past them (phase 1
  // a warp's 8 keys of each i, phase 2 a thread's 4, phase 3 4-key chunks)
  const int n_keys = min(F::kKeys, sk - k0);
  const int n_chunks = (n_keys + 3) / 4;
  bool live[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    live[i] = (warp % F::kWK) * 8 + i * F::kKG < n_keys;

  // the query tiles of the group's heads, in head order; the next tile's
  // rows of Q, dO, lse and D are read into registers while this one is
  // computed, where they fit (kPre floats a thread)
  const int first = causal ? (k0 / F::kRows) * F::kRows : 0;
  const int n_qt = (sq - first + F::kRows - 1) / F::kRows;
  const int n_iter = n_qt > 0 ? group * n_qt : 0;
  TileRows<D, DV> next;
  if constexpr (F::kPrefetch)
    if (n_iter > 0)
      next.read(q + b * qs.b + kvh * group * qs.h, qs.s,
                dout + (static_cast<long long>(b) * n_heads + kvh * group) *
                           sq * DV,
                lse, delta, (static_cast<long long>(b) * n_heads +
                             kvh * group) * sq, first, sq);
  for (int it = 0; it < n_iter; ++it) {
    const int hh = kvh * group + it / n_qt;
    const int q0 = first + (it % n_qt) * F::kRows;
    const long long bh = static_cast<long long>(b) * n_heads + hh;
    __syncthreads();  // the last tile's readers are done
    if constexpr (F::kPrefetch) {
      next.write(q_s, do_s, lse_s, del_s);
    } else {
      TileRows<D, DV>::direct(q_s, do_s, lse_s, del_s,
                              q + b * qs.b + hh * qs.h, qs.s,
                              dout + bh * sq * DV, lse, delta, bh * sq, q0,
                              sq);
    }
    __syncthreads();

    // phase 1: Sᵀ and dPᵀ of this thread's 4 keys x 4 rows
    {
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) s[i][jj] = dp[i][jj] = 0.f;
#pragma unroll 2
      for (int d = 0; d < D; d += 4) {
        float4 q4[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          q4[jj] = ld4(q_s + (g4 + jj * F::kRG) * F::kLQ + d);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (!live[i]) continue;
          const float4 kv4 = ld4(k_s + (kg + i * F::kKG) * F::kLQ + d);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            s[i][jj] = fmaf(kv4.x, q4[jj].x, s[i][jj]);
            s[i][jj] = fmaf(kv4.y, q4[jj].y, s[i][jj]);
            s[i][jj] = fmaf(kv4.z, q4[jj].z, s[i][jj]);
            s[i][jj] = fmaf(kv4.w, q4[jj].w, s[i][jj]);
          }
        }
      }
#pragma unroll 2
      for (int d = 0; d < DV; d += 4) {
        float4 q4[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          q4[jj] = ld4(do_s + (g4 + jj * F::kRG) * F::kLV + d);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (!live[i]) continue;
          const float4 kv4 = ld4(v_s + (kg + i * F::kKG) * F::kLV + d);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            dp[i][jj] = fmaf(kv4.x, q4[jj].x, dp[i][jj]);
            dp[i][jj] = fmaf(kv4.y, q4[jj].y, dp[i][jj]);
            dp[i][jj] = fmaf(kv4.z, q4[jj].z, dp[i][jj]);
            dp[i][jj] = fmaf(kv4.w, q4[jj].w, dp[i][jj]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (!live[i]) continue;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int kc = kg + i * F::kKG, rc = g4 + jj * F::kRG;
          const int key = k0 + kc, row = q0 + rc;
          const bool ok = key < sk && row < sq && (!causal || key <= row);
          const float p = ok ? expf(s[i][jj] * scale - lse_s[rc]) : 0.f;
          p_s[rc * F::kLP + kc] = p;
          ds_s[rc * F::kLP + kc] = p * (dp[i][jj] - del_s[rc]);
        }
      }
    }
    __syncthreads();
    if constexpr (F::kPrefetch) {
      if (it + 1 < n_iter) {
        const int hn = kvh * group + (it + 1) / n_qt;
        const long long bhn = static_cast<long long>(b) * n_heads + hn;
        next.read(q + b * qs.b + hn * qs.h, qs.s, dout + bhn * sq * DV, lse,
                  delta, bhn * sq, first + ((it + 1) % n_qt) * F::kRows, sq);
      }
    }

    // phase 2: dK += dSᵀ Q and dV += Pᵀ dO over the tile's rows
    if (4 * kg < n_keys) {
#pragma unroll 2
      for (int r = 0; r < F::kRows; ++r) {
        const float4 p4 = ld4(p_s + r * F::kLP + 4 * kg);
        const float4 d4 = ld4(ds_s + r * F::kLP + 4 * kg);
        const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
        const float dsv[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
        for (int c = 0; c < F::kCK; c += 4) {
          const float4 x = ld4(q_s + r * F::kLQ + g4 * F::kCK + c);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc_k[i][c] = fmaf(dsv[i], x.x, acc_k[i][c]);
            acc_k[i][c + 1] = fmaf(dsv[i], x.y, acc_k[i][c + 1]);
            acc_k[i][c + 2] = fmaf(dsv[i], x.z, acc_k[i][c + 2]);
            acc_k[i][c + 3] = fmaf(dsv[i], x.w, acc_k[i][c + 3]);
          }
        }
#pragma unroll
        for (int c = 0; c < F::kCV; c += 4) {
          const float4 x = ld4(do_s + r * F::kLV + g4 * F::kCV + c);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc_v[i][c] = fmaf(pv[i], x.x, acc_v[i][c]);
            acc_v[i][c + 1] = fmaf(pv[i], x.y, acc_v[i][c + 1]);
            acc_v[i][c + 2] = fmaf(pv[i], x.z, acc_v[i][c + 2]);
            acc_v[i][c + 3] = fmaf(pv[i], x.w, acc_v[i][c + 3]);
          }
        }
      }
    }

    // phase 3: this slice's dS K over its keys (chunks of 4 keys,
    // sl, sl + kSlices, ...), 4 rows x kC3 columns
    float a3[4][F::kC3];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < F::kC3; ++c) a3[i][c] = 0.f;
#pragma unroll 2
    for (int ch = sl; ch < n_chunks; ch += F::kSlices) {
      float dsr[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 x = ld4(ds_s + (r3 + i * F::kRG) * F::kLP + 4 * ch);
        dsr[i][0] = x.x;
        dsr[i][1] = x.y;
        dsr[i][2] = x.z;
        dsr[i][3] = x.w;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int c = 0; c < F::kC3; c += 4) {
          const float4 x = ld4(k_s + (4 * ch + kk) * F::kLQ + c3 * F::kC3 + c);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            a3[i][c] = fmaf(dsr[i][kk], x.x, a3[i][c]);
            a3[i][c + 1] = fmaf(dsr[i][kk], x.y, a3[i][c + 1]);
            a3[i][c + 2] = fmaf(dsr[i][kk], x.z, a3[i][c + 2]);
            a3[i][c + 3] = fmaf(dsr[i][kk], x.w, a3[i][c + 3]);
          }
        }
    }
    if (sl > 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < F::kC3; ++c)
          red[((sl - 1) * F::kRows + r3 + i * F::kRG) * D + c3 * F::kC3 + c] =
              a3[i][c];
    }
    __syncthreads();
    if (sl == 0) {
      // the slices in order; one KV tile writes dQ, several their partials
      float* out = n_kt == 1 ? dq + bh * sq * D
                             : dq_part + (kt * n_b * n_heads + bh) * sq * D;
      const float mul = n_kt == 1 ? scale : 1.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int rr = r3 + i * F::kRG;
        if (q0 + rr >= sq) continue;
#pragma unroll
        for (int c = 0; c < F::kC3; ++c) {
          float x = a3[i][c];
          for (int o = 1; o < F::kSlices; ++o)
            x += red[((o - 1) * F::kRows + rr) * D + c3 * F::kC3 + c];
          out[static_cast<long long>(q0 + rr) * D + c3 * F::kC3 + c] =
              x * mul;
        }
      }
    }
  }

  const long long bkv = static_cast<long long>(b) * n_kv_heads + kvh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + 4 * kg + i;
    if (key >= sk) continue;
    float* dkr = dk + (bkv * sk + key) * D + g4 * F::kCK;
    float* dvr = dv + (bkv * sk + key) * DV + g4 * F::kCV;
#pragma unroll
    for (int c = 0; c < F::kCK; ++c) dkr[c] = acc_k[i][c] * scale;
#pragma unroll
    for (int c = 0; c < F::kCV; ++c) dvr[c] = acc_v[i][c];
  }
}

// dQ from per-KV-tile partials (B, H, Sq, D) each: scale times their sum in
// KV-tile order, over the tiles that hold a key at or before the row when
// causal.  One thread an element.
__global__ void __launch_bounds__(kF32Threads)
    bwd_dq_sum_kernel(const float* __restrict__ part, float* __restrict__ dq,
                      long long n, int sq, int d, int n_kt, int keys,
                      float scale, int causal) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kF32Threads + threadIdx.x;
  if (i >= n) return;
  const int row = static_cast<int>((i / d) % sq);
  const int last = causal ? min(n_kt - 1, row / keys) : n_kt - 1;
  float s = 0.f;
  for (int t = 0; t <= last; ++t) s += part[t * n + i];
  dq[i] = s * scale;
}

template <int D, int DV>
int backward_f32(const float* q, const float* k, const float* v,
                 const float* dout, const float* lse, const float* delta,
                 float* dq, float* dq_part, float* dk, float* dv, int b,
                 int h, int hkv, int sq, int sk, Strides qs, Strides ks,
                 Strides vs, float scale, int causal, cudaStream_t stream) {
  using F = F32<D, DV>;
  const size_t smem = sizeof(float) * F::kFloats;
  auto kern = bwd_f32_kernel<D, DV>;
  cudaError_t err;
  if ((err = smem_attr(kern, smem)) != cudaSuccess)
    return static_cast<int>(err);
  const int n_kt = (sk + F::kKeys - 1) / F::kKeys;
  if (n_kt > 1 && dq_part == nullptr) return -3;
  if (static_cast<long long>(n_kt) * hkv * b > INT_MAX) return -4;
  kern<<<static_cast<unsigned>(n_kt) * hkv * b, kF32Threads, smem, stream>>>(
      q, k, v, dout, lse, delta, dq, dq_part, dk, dv, qs, ks, vs, hkv, b,
      h / hkv, sq, sk, scale, causal);
  if (n_kt == 1) return 0;
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const long long n = static_cast<long long>(b) * h * sq * D;
  bwd_dq_sum_kernel<<<static_cast<unsigned>((n + kF32Threads - 1) /
                                            kF32Threads),
                      kF32Threads, 0, stream>>>(dq_part, dq, n, sq, D, n_kt,
                                                F::kKeys, scale, causal);
  return 0;
}

}  // namespace

// Backward of prefill attention: given q, k (width d), v (width dv) with
// unit stride along the width and the given element strides along (B, H,
// S) — for bf16, 16-byte-aligned bases and strides, as TMA takes them (the
// wrapper checks) — the forward output o and its gradient dout (B, H, Sq,
// dv) contiguous (bf16: dout 16-byte aligned), the forward's lse (B, H, Sq)
// fp32 and fp32 scratch `delta` of B·H·Sq values, writes dq (B, H, Sq, d),
// dk (B, Hkv, Sk, d) and dv_out (B, Hkv, Sk, dv), contiguous, in the
// inputs' type (bf16 when `bf16_in`, else fp32).  fp32 takes `dq_part`,
// scratch of ceil(Sk / keys) · B·H·Sq·d floats where Sk exceeds the KV tile
// (`keys` = 256 at d + dv <= 64, 128 at <= 160, else 64; null otherwise).
// Built for the width pairs of the forward.  Returns 0 when launched (the
// caller checks the last launch), -1 for a width pair it is not built for,
// -2 when a tensor map cannot be made, -3 for missing scratch, -4 for a
// grid past 2^31 - 1 blocks, or the CUDA error of a shared-memory
// attribute or an earlier launch.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* o, const void* dout,
                               const float* lse, float* delta, void* dq,
                               void* dk, void* dv_out, float* dq_part,
                               int bf16_in, int b, int h, int hkv, int sq,
                               int sk, int d, int dv, long long qsb,
                               long long qsh, long long qss, long long ksb,
                               long long ksh, long long kss, long long vsb,
                               long long vsh, long long vss, float scale,
                               int causal, cudaStream_t stream) {
  const bool built = (d == dv && (d == 16 || d == 32 || d == 64 ||
                                  d == 128)) ||
                     (d == 96 && dv == 64);
  if (!built) return -1;
  const long long rows = static_cast<long long>(b) * h * sq;
  const unsigned blocks =
      static_cast<unsigned>((rows * 32 + kDeltaThreads - 1) / kDeltaThreads);
  if (bf16_in)
    bwd_delta_kernel<bf16><<<blocks, kDeltaThreads, 0, stream>>>(
        static_cast<const bf16*>(o), static_cast<const bf16*>(dout), delta,
        rows, dv);
  else
    bwd_delta_kernel<float><<<blocks, kDeltaThreads, 0, stream>>>(
        static_cast<const float*>(o), static_cast<const float*>(dout), delta,
        rows, dv);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss};
#define FA_BWD_CASE(D, DV)                                                   \
  if (d == D && dv == DV)                                                    \
    return bf16_in                                                           \
               ? backward_tc<D, DV>(q, k, v, dout, lse, delta, dq, dk,       \
                                    dv_out, b, h, hkv, sq, sk, qs, ks, vs,   \
                                    scale, causal, stream)                   \
               : backward_f32<D, DV>(                                        \
                     static_cast<const float*>(q),                           \
                     static_cast<const float*>(k),                           \
                     static_cast<const float*>(v),                           \
                     static_cast<const float*>(dout), lse, delta,            \
                     static_cast<float*>(dq), dq_part,                       \
                     static_cast<float*>(dk), static_cast<float*>(dv_out),   \
                     b, h, hkv, sq, sk, qs, ks, vs, scale, causal, stream);
  FA_BWD_CASE(16, 16)
  FA_BWD_CASE(32, 32)
  FA_BWD_CASE(64, 64)
  FA_BWD_CASE(128, 128)
  FA_BWD_CASE(96, 64)
#undef FA_BWD_CASE
  return -1;
}
