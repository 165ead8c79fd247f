// Backward of the LM family's prefill attention (kernel 8), for training.
//
// The TPU reference has no backward kernel: it trains through
// `chunked_attention` (src/repro/models/attention.py:35-76), a checkpointed
// lax.scan that autodiff differentiates.  On the card the forward is the
// hand-written prefill kernel (flash_attention_sm90.cu for bf16,
// flash_attention.cu for fp32), which writes each row's log-sum-exp when
// asked; this file holds the gradients of the same function, in the
// FlashAttention-2 form.  For q (B, H, Sq, D), k (B, Hkv, Sk, D), v (B, Hkv,
// Sk, Dv), the forward output o (B, H, Sq, Dv), its per-row log-sum-exp lse
// (B, H, Sq, fp32: max + log(max(sum, 1e-30)) of the scaled, masked logits)
// and the output's gradient do (B, H, Sq, Dv):
//
//   P  = exp(scale · q kᵀ - lse)      (0 where masked: causal, ragged tails)
//   D  = rowsum(do ∘ o)                (fp32, a pre-pass kernel)
//   dV = Pᵀ do,  dP = do vᵀ,  dS = P ∘ (dP - D)
//   dQ = scale · dS k,  dK = scale · dSᵀ q
//
// Three kernels, launched in that order on the caller's stream:
//
// * `bwd_delta_kernel`: D, one warp a row, the row's products summed in a
//   fixed order.
// * dQ: one block per (query tile, h, b), the heavy causal tiles first; it
//   loops over the KV tiles up to the diagonal, recomputes P and dS and
//   accumulates dQ in registers.
// * dK/dV: one block per (KV tile, kv head, b); it loops over the kv head's
//   group of query heads in head order and, for each, over the query tiles
//   from the diagonal on, accumulating dK and dV in registers.  So a kv
//   head's gradients sum its group's heads inside one block, in one fixed
//   order, with no float atomics (ROADMAP rule d): two launches on the same
//   inputs give the same bits.
//
// bf16 inputs run on the tensor cores through warp-level mma.sync
// (m16n8k16, fp32 accumulation), as kernel 9's decode does: four warps a
// block, each owning 16 rows of the block's resident tile (64 keys for
// dK/dV, 64 query rows for dQ), the streamed tile 32 rows deep, every tile
// staged in shared memory as bf16 in rows padded by 16 bytes (fragment loads
// free of bank conflicts).  The accumulator of one product is the A operand
// of the next (Sᵀ's registers hold Pᵀ for Pᵀ·do, dSᵀ for dSᵀ·q; S's hold dS
// for dS·k), so P and dS never go to shared memory.  P and dS are computed
// in fp32 and enter their products split into bf16 hi + lo halves, two
// mma's a k-step, as the forward splits P: rounded once to bf16 (2^-9
// relative) they would put a one-ulp error on every term of the sums.  fp32
// inputs run on the CUDA cores with no TF32 (ROADMAP rule b): the same
// grids, 256 threads a block, every operand in shared memory as fp32.
//
// What bounds it on this card: operations.  The function needs five
// products a (query, key) pair against the forward's two — S and dV, dQ
// and dK at the q/k width, dP and dV at the v width: 2·(3·D + 2·Dv)
// operations a pair it must score, halved when causal — at 989 TFLOP/s in
// bf16 and 67 TFLOP/s in fp32.  This first design does more: S and dP are
// computed once for dQ and once more for dK/dV, and the hi + lo halves
// double the three products that take P or dS; its staging is synchronous,
// with no wgmma or TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTcThreads = 128;  // four warps
constexpr int kTcRes = 64;       // resident rows of a tensor-core block
constexpr int kTcStream = 32;    // rows of a streamed tile
constexpr int kPadBf = 8;        // bf16 row padding (16 bytes)
constexpr int kF32Threads = 256;
constexpr int kF32Keys = 64;     // keys of an fp32 KV tile
constexpr int kF32Rows = 32;     // query rows of an fp32 query tile
constexpr int kDeltaThreads = 256;

struct Strides {
  long long b, h, s;  // element strides of the (B, H, S) axes; D is unit
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ unsigned pack_bf16(float x, float y) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const unsigned*>(&p);
}

__device__ __forceinline__ unsigned pack_raw(bf16 lo, bf16 hi) {
  return static_cast<unsigned>(__bfloat16_as_ushort(lo)) |
         (static_cast<unsigned>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ unsigned ld32(const bf16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// d (16 x 8, fp32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float* d, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment (rows m0.., columns k0.. of 16 x 16) of a row-major bf16
// tile whose rows are `ld` elements apart; lane (g, t) = (lane / 4, lane % 4).
__device__ __forceinline__ void frag_a(unsigned (&a)[4], const bf16* t,
                                       int ld, int m0, int k0, int g,
                                       int tq) {
  const bf16* r0 = t + (m0 + g) * ld + k0 + 2 * tq;
  const bf16* r1 = r0 + 8 * ld;
  a[0] = ld32(r0);
  a[1] = ld32(r1);
  a[2] = ld32(r0 + 8);
  a[3] = ld32(r1 + 8);
}

// The B fragment (16 x 8) with B[k][n] = t[n0 + n][k0 + k]: the tile's rows
// are B's columns (a product with the tile transposed).
__device__ __forceinline__ void frag_b_rows(unsigned& b0, unsigned& b1,
                                            const bf16* t, int ld, int n0,
                                            int k0, int g, int tq) {
  const bf16* r = t + (n0 + g) * ld + k0 + 2 * tq;
  b0 = ld32(r);
  b1 = ld32(r + 8);
}

// The B fragment (16 x 8) with B[k][n] = t[k0 + k][n0 + n]: the tile's rows
// are B's rows.
__device__ __forceinline__ void frag_b_cols(unsigned& b0, unsigned& b1,
                                            const bf16* t, int ld, int k0,
                                            int n0, int g, int tq) {
  const bf16* c = t + (k0 + 2 * tq) * ld + n0 + g;
  b0 = pack_raw(c[0], c[ld]);
  b1 = pack_raw(c[8 * ld], c[9 * ld]);
}

// Two 16 x 8 accumulators (columns 0-7 and 8-15 of a k-step) as the bf16
// hi and lo halves of one 16 x 16 A fragment: hi rounds each value, lo
// rounds what hi leaves.
__device__ __forceinline__ void split_frag(unsigned (&hi)[4],
                                           unsigned (&lo)[4], const float* c0,
                                           const float* c1) {
  const float v[8] = {c0[0], c0[1], c0[2], c0[3], c1[0], c1[1], c1[2], c1[3]};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * r], v[2 * r + 1]);
    const float2 hf = __bfloat1622float2(h);
    hi[r] = *reinterpret_cast<const unsigned*>(&h);
    lo[r] = pack_bf16(v[2 * r] - hf.x, v[2 * r + 1] - hf.y);
  }
}

// Rows r0 .. r0 + ROWS - 1 of a (S, W) bf16 slice with row stride `ss` into
// a [ROWS][W + kPadBf] tile, 16 bytes a load; rows at or past `limit` are 0.
template <int W, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long ss, int r0, int limit) {
  constexpr int kPer = W / 8;
  for (int i = threadIdx.x; i < ROWS * kPer; i += blockDim.x) {
    const int r = i / kPer, c = (i % kPer) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < limit)
      val = *reinterpret_cast<const uint4*>(src + (r0 + r) * ss + c);
    *reinterpret_cast<uint4*>(dst + r * (W + kPadBf) + c) = val;
  }
}

// Rows r0 .. r0 + ROWS - 1 of a (S, W) slice into a [ROWS][W + 1] fp32
// tile; rows at or past `limit` are 0.
template <typename T, int W, int ROWS>
__device__ __forceinline__ void load_tile_f32(float* dst, const T* src,
                                              long long ss, int r0,
                                              int limit) {
  for (int i = threadIdx.x; i < ROWS * W; i += blockDim.x) {
    const int r = i / W, c = i % W;
    dst[r * (W + 1) + c] =
        r0 + r < limit ? to_f32(src[(r0 + r) * ss + c]) : 0.f;
  }
}

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
// bf16: tensor cores (mma.sync)
// ---------------------------------------------------------------------------

template <int D, int DV>
constexpr int tc_smem_bytes() {
  return 2 * (kTcRes + kTcStream) * (D + DV + 2 * kPadBf) +
         2 * kTcStream * 4;
}

// dQ: block (query tile of 64, h, b); warp w owns query rows 16w .. 16w+15
// of the tile and loops over KV tiles of 32 keys.
template <int D, int DV>
__global__ void __launch_bounds__(kTcThreads)
    bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dq,
                     Strides qs, Strides ks, Strides vs, int group, int sq,
                     int sk, float scale, int causal) {
  constexpr int LQ = D + kPadBf, LV = DV + kPadBf;
  extern __shared__ uint4 tc_smem[];
  bf16* q_s = reinterpret_cast<bf16*>(tc_smem);  // [kTcRes][LQ]
  bf16* do_s = q_s + kTcRes * LQ;                 // [kTcRes][LV]
  bf16* k_s = do_s + kTcRes * LV;                 // [kTcStream][LQ]
  bf16* v_s = k_s + kTcStream * LQ;               // [kTcStream][LV]

  const int n_q = gridDim.x, n_heads = gridDim.y;
  const int qtile = causal ? n_q - 1 - static_cast<int>(blockIdx.x)
                           : static_cast<int>(blockIdx.x);
  const int hh = blockIdx.y, b = blockIdx.z, kvh = hh / group;
  const int q0 = qtile * kTcRes;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3, m0 = 16 * warp;
  const long long bh = static_cast<long long>(b) * n_heads + hh;
  const bf16* kb = k + b * ks.b + kvh * ks.h;
  const bf16* vb = v + b * vs.b + kvh * vs.h;

  load_tile<D, kTcRes>(q_s, q + b * qs.b + hh * qs.h, qs.s, q0, sq);
  load_tile<DV, kTcRes>(do_s, dout + bh * sq * DV, DV, q0, sq);
  const int row_a = q0 + m0 + g, row_b = row_a + 8;
  const float lse_a = row_a < sq ? lse[bh * sq + row_a] : 0.f;
  const float lse_b = row_b < sq ? lse[bh * sq + row_b] : 0.f;
  const float del_a = row_a < sq ? delta[bh * sq + row_a] : 0.f;
  const float del_b = row_b < sq ? delta[bh * sq + row_b] : 0.f;

  int n_kv = (sk + kTcStream - 1) / kTcStream;
  if (causal) n_kv = min(n_kv, (min(q0 + kTcRes, sq) - 1) / kTcStream + 1);

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * kTcStream;
    __syncthreads();  // the last tile is read
    load_tile<D, kTcStream>(k_s, kb, ks.s, k0, sk);
    load_tile<DV, kTcStream>(v_s, vb, vs.s, k0, sk);
    __syncthreads();

    // S = Q Kᵀ and dP = dO Vᵀ: 16 rows x 32 keys a warp
    float s[4][4], dp[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      unsigned a[4];
      frag_a(a, q_s, LQ, m0, 16 * kk, g, tq);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        unsigned b0, b1;
        frag_b_rows(b0, b1, k_s, LQ, 8 * nt, 16 * kk, g, tq);
        mma_bf16(s[nt], a, b0, b1);
      }
    }
#pragma unroll
    for (int kk = 0; kk < DV / 16; ++kk) {
      unsigned a[4];
      frag_a(a, do_s, LV, m0, 16 * kk, g, tq);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        unsigned b0, b1;
        frag_b_rows(b0, b1, v_s, LV, 8 * nt, 16 * kk, g, tq);
        mma_bf16(dp[nt], a, b0, b1);
      }
    }
    // dS = P (dP - D), P = exp(scale s - lse), 0 where masked
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * nt + 2 * tq + (e & 1);
        const int row = e < 2 ? row_a : row_b;
        const bool ok = key < sk && row < sq && (!causal || key <= row);
        const float p =
            ok ? expf(s[nt][e] * scale - (e < 2 ? lse_a : lse_b)) : 0.f;
        s[nt][e] = p * (dp[nt][e] - (e < 2 ? del_a : del_b));
      }
    // dQ += dS K, dS as hi + lo A fragments
#pragma unroll
    for (int k2 = 0; k2 < kTcStream / 16; ++k2) {
      unsigned hi[4], lo[4];
      split_frag(hi, lo, s[2 * k2], s[2 * k2 + 1]);
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        unsigned b0, b1;
        frag_b_cols(b0, b1, k_s, LQ, 16 * k2, 8 * nt, g, tq);
        mma_bf16(acc[nt], hi, b0, b1);
        mma_bf16(acc[nt], lo, b0, b1);
      }
    }
  }

  bf16* out = dq + bh * sq * D;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int row = h2 ? row_b : row_a;
      if (row < sq)
        *reinterpret_cast<__nv_bfloat162*>(out + row * D + 8 * nt + 2 * tq) =
            __floats2bfloat162_rn(acc[nt][2 * h2] * scale,
                                  acc[nt][2 * h2 + 1] * scale);
    }
}

// dK / dV: block (KV tile of 64, kv head, b); warp w owns keys 16w .. 16w+15
// of the tile and loops over the group's query heads, in head order, and
// their query tiles of 32 rows from the diagonal on.
template <int D, int DV>
__global__ void __launch_bounds__(kTcThreads)
    bwd_dkdv_tc_kernel(const bf16* __restrict__ q,
                       const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       bf16* __restrict__ dk, bf16* __restrict__ dv,
                       Strides qs, Strides ks, Strides vs, int group, int sq,
                       int sk, float scale, int causal) {
  constexpr int LQ = D + kPadBf, LV = DV + kPadBf;
  extern __shared__ uint4 tc_smem[];
  bf16* k_s = reinterpret_cast<bf16*>(tc_smem);  // [kTcRes][LQ]
  bf16* v_s = k_s + kTcRes * LQ;                  // [kTcRes][LV]
  bf16* q_s = v_s + kTcRes * LV;                  // [kTcStream][LQ]
  bf16* do_s = q_s + kTcStream * LQ;              // [kTcStream][LV]
  float* lse_s = reinterpret_cast<float*>(do_s + kTcStream * LV);
  float* del_s = lse_s + kTcStream;

  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int n_kv_heads = gridDim.y, n_heads = n_kv_heads * group;
  const int k0 = kt * kTcRes;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3, m0 = 16 * warp;
  const int key_a = k0 + m0 + g, key_b = key_a + 8;

  load_tile<D, kTcRes>(k_s, k + b * ks.b + kvh * ks.h, ks.s, k0, sk);
  load_tile<DV, kTcRes>(v_s, v + b * vs.b + kvh * vs.h, vs.s, k0, sk);

  float acc_k[D / 8][4], acc_v[DV / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[i][e] = 0.f;
#pragma unroll
  for (int i = 0; i < DV / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_v[i][e] = 0.f;

  // causal: the first query tile with a row at or past the tile's first key
  const int first = causal ? (k0 / kTcStream) * kTcStream : 0;
  for (int j = 0; j < group; ++j) {
    const int hh = kvh * group + j;
    const long long bh = static_cast<long long>(b) * n_heads + hh;
    const bf16* qb = q + b * qs.b + hh * qs.h;
    const bf16* dob = dout + bh * sq * DV;
    for (int q0 = first; q0 < sq; q0 += kTcStream) {
      __syncthreads();  // the last tile is read
      load_tile<D, kTcStream>(q_s, qb, qs.s, q0, sq);
      load_tile<DV, kTcStream>(do_s, dob, DV, q0, sq);
      if (tid < kTcStream) {
        const int r = q0 + tid;
        lse_s[tid] = r < sq ? lse[bh * sq + r] : 0.f;
        del_s[tid] = r < sq ? delta[bh * sq + r] : 0.f;
      }
      __syncthreads();

      // Sᵀ = K Qᵀ and dPᵀ = V dOᵀ: 16 keys x 32 query rows a warp
      float s[4][4], dp[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        unsigned a[4];
        frag_a(a, k_s, LQ, m0, 16 * kk, g, tq);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          unsigned b0, b1;
          frag_b_rows(b0, b1, q_s, LQ, 8 * nt, 16 * kk, g, tq);
          mma_bf16(s[nt], a, b0, b1);
        }
      }
#pragma unroll
      for (int kk = 0; kk < DV / 16; ++kk) {
        unsigned a[4];
        frag_a(a, v_s, LV, m0, 16 * kk, g, tq);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          unsigned b0, b1;
          frag_b_rows(b0, b1, do_s, LV, 8 * nt, 16 * kk, g, tq);
          mma_bf16(dp[nt], a, b0, b1);
        }
      }
      // Pᵀ into s, dSᵀ = Pᵀ (dPᵀ - D) into dp
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = 8 * nt + 2 * tq + (e & 1);
          const int row = q0 + qc;
          const int key = e < 2 ? key_a : key_b;
          const bool ok = key < sk && row < sq && (!causal || key <= row);
          const float p = ok ? expf(s[nt][e] * scale - lse_s[qc]) : 0.f;
          s[nt][e] = p;
          dp[nt][e] = p * (dp[nt][e] - del_s[qc]);
        }
      // dV += Pᵀ dO and dK += dSᵀ Q, the A operands as hi + lo halves
#pragma unroll
      for (int k2 = 0; k2 < kTcStream / 16; ++k2) {
        unsigned hi[4], lo[4];
        split_frag(hi, lo, s[2 * k2], s[2 * k2 + 1]);
#pragma unroll
        for (int nt = 0; nt < DV / 8; ++nt) {
          unsigned b0, b1;
          frag_b_cols(b0, b1, do_s, LV, 16 * k2, 8 * nt, g, tq);
          mma_bf16(acc_v[nt], hi, b0, b1);
          mma_bf16(acc_v[nt], lo, b0, b1);
        }
        split_frag(hi, lo, dp[2 * k2], dp[2 * k2 + 1]);
#pragma unroll
        for (int nt = 0; nt < D / 8; ++nt) {
          unsigned b0, b1;
          frag_b_cols(b0, b1, q_s, LQ, 16 * k2, 8 * nt, g, tq);
          mma_bf16(acc_k[nt], hi, b0, b1);
          mma_bf16(acc_k[nt], lo, b0, b1);
        }
      }
    }
  }

  const long long bkv = static_cast<long long>(b) * n_kv_heads + kvh;
  bf16* dkb = dk + bkv * sk * D;
  bf16* dvb = dv + bkv * sk * DV;
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int key = h2 ? key_b : key_a;
    if (key >= sk) continue;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(dkb + key * D + 8 * nt + 2 * tq) =
          __floats2bfloat162_rn(acc_k[nt][2 * h2] * scale,
                                acc_k[nt][2 * h2 + 1] * scale);
#pragma unroll
    for (int nt = 0; nt < DV / 8; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(dvb + key * DV + 8 * nt + 2 * tq) =
          __floats2bfloat162_rn(acc_v[nt][2 * h2], acc_v[nt][2 * h2 + 1]);
  }
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores (no TF32)
// ---------------------------------------------------------------------------

template <int D, int DV>
constexpr int f32_dq_smem_floats() {
  return (kF32Rows + kF32Keys) * (D + DV + 2) + kF32Rows * (kF32Keys + 1);
}

template <int D, int DV>
constexpr int f32_dkdv_smem_floats() {
  return (kF32Keys + kF32Rows) * (D + DV + 2) +
         2 * kF32Keys * (kF32Rows + 1) + 2 * kF32Rows;
}

// dQ: block (query tile of 32, h, b) of 256 threads; thread (r, c) = (tid /
// 8, tid % 8) owns row r, keys c + 8i of each KV tile and columns c + 8i of
// dQ.
template <int D, int DV>
__global__ void __launch_bounds__(kF32Threads)
    bwd_dq_f32_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      float* __restrict__ dq, Strides qs, Strides ks,
                      Strides vs, int group, int sq, int sk, float scale,
                      int causal) {
  constexpr int LQ = D + 1, LV = DV + 1, LS = kF32Keys + 1;
  extern __shared__ float4 f32_smem[];
  float* q_s = reinterpret_cast<float*>(f32_smem);  // [kF32Rows][LQ]
  float* do_s = q_s + kF32Rows * LQ;                 // [kF32Rows][LV]
  float* k_s = do_s + kF32Rows * LV;                 // [kF32Keys][LQ]
  float* v_s = k_s + kF32Keys * LQ;                  // [kF32Keys][LV]
  float* ds_s = v_s + kF32Keys * LV;                 // [kF32Rows][LS]

  const int n_q = gridDim.x, n_heads = gridDim.y;
  const int qtile = causal ? n_q - 1 - static_cast<int>(blockIdx.x)
                           : static_cast<int>(blockIdx.x);
  const int hh = blockIdx.y, b = blockIdx.z, kvh = hh / group;
  const int q0 = qtile * kF32Rows;
  const int tid = threadIdx.x, r = tid >> 3, c = tid & 7;
  const long long bh = static_cast<long long>(b) * n_heads + hh;
  const float* kb = k + b * ks.b + kvh * ks.h;
  const float* vb = v + b * vs.b + kvh * vs.h;

  load_tile_f32<float, D, kF32Rows>(q_s, q + b * qs.b + hh * qs.h, qs.s, q0,
                                    sq);
  load_tile_f32<float, DV, kF32Rows>(do_s, dout + bh * sq * DV, DV, q0, sq);
  const int row = q0 + r;
  const float lse_r = row < sq ? lse[bh * sq + row] : 0.f;
  const float del_r = row < sq ? delta[bh * sq + row] : 0.f;

  int n_kv = (sk + kF32Keys - 1) / kF32Keys;
  if (causal) n_kv = min(n_kv, (min(q0 + kF32Rows, sq) - 1) / kF32Keys + 1);

  float acc[D / 8];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * kF32Keys;
    __syncthreads();
    load_tile_f32<float, D, kF32Keys>(k_s, kb, ks.s, k0, sk);
    load_tile_f32<float, DV, kF32Keys>(v_s, vb, vs.s, k0, sk);
    __syncthreads();
#pragma unroll 2
    for (int i = 0; i < kF32Keys / 8; ++i) {
      const int kc = c + 8 * i, key = k0 + kc;
      float s = 0.f, dp = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) s = fmaf(q_s[r * LQ + d], k_s[kc * LQ + d], s);
#pragma unroll 8
      for (int d = 0; d < DV; ++d)
        dp = fmaf(do_s[r * LV + d], v_s[kc * LV + d], dp);
      const bool ok = key < sk && row < sq && (!causal || key <= row);
      const float p = ok ? expf(s * scale - lse_r) : 0.f;
      ds_s[r * LS + kc] = p * (dp - del_r);
    }
    __syncthreads();
    for (int kk = 0; kk < kF32Keys; ++kk) {
      const float ds = ds_s[r * LS + kk];
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        acc[i] = fmaf(ds, k_s[kk * LQ + c + 8 * i], acc[i]);
    }
  }
  if (row < sq) {
    float* out = dq + (bh * sq + row) * D;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) out[c + 8 * i] = acc[i] * scale;
  }
}

// dK / dV: block (KV tile of 64, kv head, b) of 256 threads; thread (kr, c)
// = (tid / 4, tid % 4) owns key kr, query rows c + 4i of each query tile and
// columns c + 4i of dK and dV.  The group's heads in head order, each from
// the diagonal on.
template <int D, int DV>
__global__ void __launch_bounds__(kF32Threads)
    bwd_dkdv_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dk, float* __restrict__ dv,
                        Strides qs, Strides ks, Strides vs, int group, int sq,
                        int sk, float scale, int causal) {
  constexpr int LQ = D + 1, LV = DV + 1, LP = kF32Rows + 1;
  extern __shared__ float4 f32_smem[];
  float* k_s = reinterpret_cast<float*>(f32_smem);  // [kF32Keys][LQ]
  float* v_s = k_s + kF32Keys * LQ;                  // [kF32Keys][LV]
  float* q_s = v_s + kF32Keys * LV;                  // [kF32Rows][LQ]
  float* do_s = q_s + kF32Rows * LQ;                 // [kF32Rows][LV]
  float* p_s = do_s + kF32Rows * LV;                 // [kF32Keys][LP]
  float* ds_s = p_s + kF32Keys * LP;                 // [kF32Keys][LP]
  float* lse_s = ds_s + kF32Keys * LP;
  float* del_s = lse_s + kF32Rows;

  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int n_kv_heads = gridDim.y, n_heads = n_kv_heads * group;
  const int k0 = kt * kF32Keys;
  const int tid = threadIdx.x, kr = tid >> 2, c = tid & 3;
  const int key = k0 + kr;

  load_tile_f32<float, D, kF32Keys>(k_s, k + b * ks.b + kvh * ks.h, ks.s, k0,
                                    sk);
  load_tile_f32<float, DV, kF32Keys>(v_s, v + b * vs.b + kvh * vs.h, vs.s,
                                     k0, sk);
  float acc_k[D / 4], acc_v[DV / 4];
#pragma unroll
  for (int i = 0; i < D / 4; ++i) acc_k[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DV / 4; ++i) acc_v[i] = 0.f;

  const int first = causal ? (k0 / kF32Rows) * kF32Rows : 0;
  for (int j = 0; j < group; ++j) {
    const int hh = kvh * group + j;
    const long long bh = static_cast<long long>(b) * n_heads + hh;
    const float* qb = q + b * qs.b + hh * qs.h;
    const float* dob = dout + bh * sq * DV;
    for (int q0 = first; q0 < sq; q0 += kF32Rows) {
      __syncthreads();
      load_tile_f32<float, D, kF32Rows>(q_s, qb, qs.s, q0, sq);
      load_tile_f32<float, DV, kF32Rows>(do_s, dob, DV, q0, sq);
      if (tid < kF32Rows) {
        const int rr = q0 + tid;
        lse_s[tid] = rr < sq ? lse[bh * sq + rr] : 0.f;
        del_s[tid] = rr < sq ? delta[bh * sq + rr] : 0.f;
      }
      __syncthreads();
#pragma unroll 2
      for (int i = 0; i < kF32Rows / 4; ++i) {
        const int qc = c + 4 * i, row = q0 + qc;
        float s = 0.f, dp = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d)
          s = fmaf(k_s[kr * LQ + d], q_s[qc * LQ + d], s);
#pragma unroll 8
        for (int d = 0; d < DV; ++d)
          dp = fmaf(v_s[kr * LV + d], do_s[qc * LV + d], dp);
        const bool ok = key < sk && row < sq && (!causal || key <= row);
        const float p = ok ? expf(s * scale - lse_s[qc]) : 0.f;
        p_s[kr * LP + qc] = p;
        ds_s[kr * LP + qc] = p * (dp - del_s[qc]);
      }
      __syncthreads();
      for (int qq = 0; qq < kF32Rows; ++qq) {
        const float p = p_s[kr * LP + qq], ds = ds_s[kr * LP + qq];
#pragma unroll
        for (int i = 0; i < DV / 4; ++i)
          acc_v[i] = fmaf(p, do_s[qq * LV + c + 4 * i], acc_v[i]);
#pragma unroll
        for (int i = 0; i < D / 4; ++i)
          acc_k[i] = fmaf(ds, q_s[qq * LQ + c + 4 * i], acc_k[i]);
      }
    }
  }
  if (key < sk) {
    const long long bkv = static_cast<long long>(b) * n_kv_heads + kvh;
    float* dkr = dk + (bkv * sk + key) * D;
    float* dvr = dv + (bkv * sk + key) * DV;
#pragma unroll
    for (int i = 0; i < D / 4; ++i) dkr[c + 4 * i] = acc_k[i] * scale;
#pragma unroll
    for (int i = 0; i < DV / 4; ++i) dvr[c + 4 * i] = acc_v[i];
  }
}

template <typename Kernel>
cudaError_t smem_attr(Kernel kern, size_t bytes) {
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int D, int DV>
int backward_d(int tc, const void* q, const void* k, const void* v,
               const void* dout, const float* lse, const float* delta,
               void* dq, void* dk, void* dv, int b, int h, int hkv, int sq,
               int sk, Strides qs, Strides ks, Strides vs, float scale,
               int causal, cudaStream_t stream) {
  const int group = h / hkv;
  cudaError_t err;
  if (tc) {
    const size_t smem = tc_smem_bytes<D, DV>();
    auto kq = bwd_dq_tc_kernel<D, DV>;
    auto kkv = bwd_dkdv_tc_kernel<D, DV>;
    if ((err = smem_attr(kq, smem)) != cudaSuccess ||
        (err = smem_attr(kkv, smem)) != cudaSuccess)
      return static_cast<int>(err);
    kq<<<dim3((sq + kTcRes - 1) / kTcRes, h, b), kTcThreads, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
        delta, static_cast<bf16*>(dq), qs, ks, vs, group, sq, sk, scale,
        causal);
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
    kkv<<<dim3((sk + kTcRes - 1) / kTcRes, hkv, b), kTcThreads, smem,
          stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
        delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), qs, ks, vs,
        group, sq, sk, scale, causal);
    return 0;
  }
  const size_t smem_q = sizeof(float) * f32_dq_smem_floats<D, DV>();
  const size_t smem_kv = sizeof(float) * f32_dkdv_smem_floats<D, DV>();
  auto kq = bwd_dq_f32_kernel<D, DV>;
  auto kkv = bwd_dkdv_f32_kernel<D, DV>;
  if ((err = smem_attr(kq, smem_q)) != cudaSuccess ||
      (err = smem_attr(kkv, smem_kv)) != cudaSuccess)
    return static_cast<int>(err);
  kq<<<dim3((sq + kF32Rows - 1) / kF32Rows, h, b), kF32Threads, smem_q,
       stream>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                 static_cast<const float*>(v),
                 static_cast<const float*>(dout), lse, delta,
                 static_cast<float*>(dq), qs, ks, vs, group, sq, sk, scale,
                 causal);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  kkv<<<dim3((sk + kF32Keys - 1) / kF32Keys, hkv, b), kF32Threads, smem_kv,
        stream>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v),
                  static_cast<const float*>(dout), lse, delta,
                  static_cast<float*>(dk), static_cast<float*>(dv), qs, ks,
                  vs, group, sq, sk, scale, causal);
  return 0;
}

}  // namespace

// Backward of prefill attention: given q, k (width d), v (width dv) with
// unit stride along the width and the given element strides along (B, H,
// S) — for bf16, 16-byte-aligned bases and strides (the wrapper checks) —
// the forward output o and its gradient dout (B, H, Sq, dv) contiguous, the
// forward's lse (B, H, Sq) fp32 and fp32 scratch `delta` of B·H·Sq values,
// writes dq (B, H, Sq, d), dk (B, Hkv, Sk, d) and dv_out (B, Hkv, Sk, dv),
// contiguous, in the inputs' type (bf16 when `bf16`, else fp32).  Built for
// the width pairs of the forward.  Returns 0 when launched (the caller
// checks the last launch), -1 for a width pair it is not built for, or the
// CUDA error of a shared-memory attribute or an earlier launch.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* o, const void* dout,
                               const float* lse, float* delta, void* dq,
                               void* dk, void* dv_out, int bf16_in, int b,
                               int h, int hkv, int sq, int sk, int d, int dv,
                               long long qsb, long long qsh, long long qss,
                               long long ksb, long long ksh, long long kss,
                               long long vsb, long long vsh, long long vss,
                               float scale, int causal, cudaStream_t stream) {
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
#define FA_BWD_CASE(D, DV)                                                  \
  if (d == D && dv == DV)                                                   \
    return backward_d<D, DV>(bf16_in, q, k, v, dout, lse, delta, dq, dk,    \
                             dv_out, b, h, hkv, sq, sk, qs, ks, vs, scale,  \
                             causal, stream);
  FA_BWD_CASE(16, 16)
  FA_BWD_CASE(32, 32)
  FA_BWD_CASE(64, 64)
  FA_BWD_CASE(128, 128)
  FA_BWD_CASE(96, 64)
#undef FA_BWD_CASE
  return -1;
}
