// Attention of the LM serving path: tiled online-softmax prefill attention
// on fp32 inputs and split-KV single-token decode.
//
// Replaces the two Pallas kernels of repro/kernels/flash_attention/kernel.py:
//
// * `flash_attention` (body `_flash_kernel`) on fp32 inputs:
//   softmax(q kᵀ · scale) v for q (B, H, Sq, D), k (B, Hkv, Sk, D) and v
//   (B, Hkv, Sk, Dv), causal or not, GQA through the kv head h / (H /
//   Hkv), fp32 math and output (B, H, Sq, Dv); built for D = Dv at 16 to
//   128 and for (D, Dv) = (96, 64), MLA's prefill.  bf16 inputs go to the
//   tensor-core kernel of flash_attention_sm90.cu.  The TPU kernel walks KV
//   tiles along a sequential grid axis and carries (m, l, acc) in VMEM from
//   one grid step to the next; blocks on the card run in no order, so here
//   one block of 8 warps owns a 128-row query tile of one (b, h) and loops
//   over the KV tiles itself, stopping at the block's diagonal when causal.
//   The geometry is `Fwd` below (mirrored by ops.f32_forward_tiles): KV
//   tiles of 64 keys (32 at q/k + v widths from 65 to 160) stream through a
//   two-stage ring, so the next tile loads while the current one computes,
//   one barrier a tile, 3 blocks an SM at widths up to 64 (BERT4Rec's 32 /
//   32).  Q, K and V are staged by 16-byte cp.async (4-byte copies where a
//   view's rows are not 16-byte aligned; no copy of the view), K and Q
//   row-major with rows padded to 4 floats mod 32 banks, V unpadded.  Each
//   warp owns 16 query rows and steps over its keys 32 at a time, an online
//   softmax step each: lane (rg, g) of the warp computes the scores of rows
//   rg + 4i and keys g + 8j (i, j < 4) from float4 loads that hit 8
//   distinct K rows and 4 distinct Q rows (no bank conflict, the rest
//   broadcast), the row maxima are shuffles over the 8 lanes of a row
//   group, P goes to the warp's own shared rows (key g + 8j at column 4g +
//   j, so a float4 of P is 4 keys 8 apart), and the same lane then owns
//   rows rg + 4i and columns of the (16 x Dv) accumulator: a float4 (a
//   float2 at Dv = 16) at 4g (2g), repeated every 32 columns, so every lane
//   has columns at every Dv.  A warp skips its rows past Sq and its keys
//   past Sk (and past its last row when causal) in groups of 4 rows and 8
//   keys.  P stays fp32 (no bf16 rounding, no TF32), logits are scaled
//   after the dot as the TPU kernel does, masked logits are -1e30 and the
//   final sum is floored at 1e-30, as there; each row's sum is kept as the
//   8 lanes' parts and added once at the end, in a fixed order (no atomics:
//   two launches give the same bits).  Any S is taken (the TPU wrapper's
//   `s // tq` drops a ragged tail).
//
// * `flash_decode` (body `_decode_kernel`): one query token per (b, h)
//   against a cache (B, Hkv, T, D) masked by kv_len (B,).  One block per
//   (512-position split, kv head, b) holds the query heads of the kv
//   head's group, so each K and V byte below kv_len is read once, not once
//   per query head.  K and then V stream through a ring of 64-position
//   chunks in shared memory (16-byte cp.async, chunks in flight while the
//   block computes).  On bf16 caches the group's heads are the 16 rows of
//   warp-level mma.sync products (S = Q·Kᵀ, then P·V with P split into
//   bf16 hi + lo); on fp32 caches one thread per (head, position) takes a
//   score and one per (head, two columns) the P·V sum on the CUDA cores.
//   Each split's max and sum are a warp's per head.  The partial (acc, m,
//   l) of each split goes to fp32 scratch, and a second kernel, one block
//   per (h, b), merges the splits in split order (log-sum-exp, as the TPU
//   wrapper merges outside its kernel) and writes the output in q's type.
//   The last split may be ragged (the TPU wrapper's `s // tk` drops it).
//   A split that starts at or past kv_len[b] > 0 reads nothing and writes
//   (0, -1e30, 0): in the merge its weight exp(-1e30 - m*) is 0, as the
//   TPU kernel's all-masked split (m = -1e30, l = tk) gets, so the merged
//   output is unchanged.  With kv_len[b] <= 0 every position is masked and
//   every split is read, which gives the reference's uniform average.

// What bounds them on this card.  Prefill is operations:
// 2·B·H·Sq·Sk·(D + Dv) (halved when causal), held on fp32 inputs to the 67
// TFLOP/s of the fp32 CUDA cores, since the tensor cores would take fp32
// only as TF32 (ROADMAP rule b).  The kernel keeps every operand of the
// inner products in shared memory or registers: a lane's 4 x 4 register
// tile takes 64 FMAs per eight 16-byte shared loads in both products
// (scores and P·V at Dv >= 32), and it does only the work the call needs
// (rows below Sq, keys below Sk, tiles below the diagonal).  On the H100
// it reaches 28-37 % of that bound: it is latency-bound (more warps an SM
// helped, fewer loads a FMA at fewer warps did not; PERF.md).  The bf16
// prefill of the served model runs on the tensor cores (wgmma fed by TMA)
// in flash_attention_sm90.cu.  Decode is bytes: the valid part of the
// cache read once (33.6 MB a layer at 4 x 4,100 Yi-6B positions, 10 µs);
// the kernel reads it once, with chunks in flight on every block.  Its
// arithmetic, 4·D operations per head and position, is little beside the
// bytes, but on the CUDA cores each operation costs its shared-memory
// loads and conversions too, enough instructions to bound a bf16 call; the
// tensor cores take that part.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kSplit = 512;      // cache positions a decode block reduces
constexpr int kDecodeThreads = 256;
constexpr int kDecodeHeads = 8;  // query heads a decode block takes at once
constexpr int kChunk = 64;       // cache positions of a staged chunk
constexpr int kStages = 3;       // chunks of the cp.async ring

__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

struct Strides {
  long long b, h, s;  // element strides of the (B, H, S) axes; D is unit
};

// 16 bytes from global to shared memory, asynchronously (cp.async).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}
// 16 (or, with `wide` false, 4) bytes from global to shared memory,
// asynchronously; with `ok` false the destination is filled with zeros and
// nothing is read.
__device__ __forceinline__ void cp_async_zfill(void* smem, const void* gmem,
                                               bool ok, bool wide) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if (wide)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(gmem), "r"(ok ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                 "l"(gmem), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Butterfly over the 8 lanes of a row group (lanes 8rg .. 8rg + 7): every
// lane ends with the same bits (each step adds or compares two values that
// both lanes hold).
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The fp32 prefill's geometry at widths (D, DV), mirrored by
// ops.f32_forward_tiles.  kWarps warps of kRowsW query rows (kRL a lane);
// KV tiles of kKeys keys in a ring of kStages, each taken kChunk keys a
// softmax step; kMinBlocks blocks an SM (the launch bounds; shared memory
// allows them): 24 warps at D + DV <= 64, 16 up to 160, 8 at (128, 128),
// whose 64-key tiles take 219 KB.  (On the H100 a 256-key tile staged once
// at 16 warps, and 8 rows a lane at 8 warps, were slower: the kernel waits
// on latency more than on shared-memory bandwidth.)  A lane's
// accumulator: kRL rows x kNU blocks of kVec columns.  Shared floats: Q
// [kRows][kLQ], the ring's stages (K [kKeys][kLQ], then V [kKeys][DV]),
// and each warp's P [kRowsW][kLP].
template <int D, int DV>
struct Fwd {
  static constexpr int kRL = 4;
  static constexpr int kWarps = 8;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kRowsW = 4 * kRL;
  static constexpr int kRows = kRowsW * kWarps;
  static constexpr int kChunk = 32;
  static constexpr int kKeys = D + DV <= 64 || D + DV > 160 ? 64 : 32;
  static constexpr int kStages = 2;
  static constexpr int kMinBlocks = D + DV <= 64 ? 3 : D + DV <= 160 ? 2 : 1;
  static constexpr int kLQ = D + 4;
  static constexpr int kLP = kChunk + 4;
  static constexpr int kVec = DV >= 32 ? 4 : DV / 8;
  static constexpr int kNU = DV / (8 * kVec);
  static constexpr int kStageFloats = kKeys * (kLQ + DV);
  static constexpr int kKV = kRows * kLQ;
  static constexpr int kP = kKV + kStages * kStageFloats;
  static constexpr int kFloats = kP + kWarps * kRowsW * kLP;
  static_assert(D % 4 == 0 && DV % (8 * kVec) == 0 && kKeys % kChunk == 0 &&
                    (kVec == 2 || kVec == 4) && kStages >= 2,
                "fp32 prefill tiling");
};

// Rows r0 .. r0 + n - 1 of a (S, W) slice (row stride `ss` floats, unit
// stride along W) into rows 0 .. n - 1 of a [.][LD] tile by cp.async,
// rows at or past `limit` zero-filled: 16-byte copies where `wide`, else
// 4-byte ones.
template <int W, int LD, int THREADS>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           long long ss, int r0, int n,
                                           int limit, bool wide) {
  if (wide) {
    for (int i = threadIdx.x; i < n * (W / 4); i += THREADS) {
      const int r = i / (W / 4), c = i % (W / 4) * 4;
      const bool ok = r0 + r < limit;
      cp_async_zfill(dst + r * LD + c, ok ? src + (r0 + r) * ss + c : src,
                     ok, true);
    }
  } else {
    for (int i = threadIdx.x; i < n * W; i += THREADS) {
      const int r = i / W, c = i % W;
      const bool ok = r0 + r < limit;
      cp_async_zfill(dst + r * LD + c, ok ? src + (r0 + r) * ss + c : src,
                     ok, false);
    }
  }
}

// One softmax step of a warp over 32 keys of a staged tile: the scores of
// its rows (q_w: its first Q row) and the keys at k_c (their K rows, V rows
// at v_c), the running max m, the lane's part l of each row's sum, and the
// accumulator rescaled and added to.  row0 / key0: the first row's and
// key's index in the sequence; n_rows / n_keys: the warp's rows below Sq
// and the step's keys it needs (FULL: 16 and 32, nothing skipped).
template <int D, int DV, bool FULL>
__device__ __forceinline__ void softmax_step(
    const float* q_w, const float* k_c, const float* v_c, float* p_w,
    float (&m)[Fwd<D, DV>::kRL], float (&l)[Fwd<D, DV>::kRL],
    float (&acc)[Fwd<D, DV>::kRL][Fwd<D, DV>::kNU * Fwd<D, DV>::kVec],
    int row0,
    int key0, int n_rows, int n_keys, int sk, int causal, float scale,
    int rg, int g) {
  using F = Fwd<D, DV>;
  float s[F::kRL][4];
#pragma unroll
  for (int i = 0; i < F::kRL; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 a[F::kRL];
#pragma unroll
    for (int i = 0; i < F::kRL; ++i)
      a[i] = FULL || 4 * i < n_rows ? ld4(q_w + (rg + 4 * i) * F::kLQ + d)
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (!FULL && 8 * j >= n_keys) continue;
      const float4 c = ld4(k_c + (g + 8 * j) * F::kLQ + d);
#pragma unroll
      for (int i = 0; i < F::kRL; ++i) {
        if (!FULL && 4 * i >= n_rows) continue;
        s[i][j] = fmaf(a[i].x, c.x, s[i][j]);
        s[i][j] = fmaf(a[i].y, c.y, s[i][j]);
        s[i][j] = fmaf(a[i].z, c.z, s[i][j]);
        s[i][j] = fmaf(a[i].w, c.w, s[i][j]);
      }
    }
  }

  __syncwarp();  // the last step's P is read
#pragma unroll
  for (int i = 0; i < F::kRL; ++i) {
    if (!FULL && 4 * i >= n_rows) continue;
    const int row = row0 + rg + 4 * i;
    float mt = kNegInf;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = key0 + g + 8 * j;
      const bool ok = (FULL || 8 * j < n_keys) && key < sk &&
                      (!causal || key <= row);
      s[i][j] = ok ? s[i][j] * scale : kNegInf;
      mt = fmaxf(mt, s[i][j]);
    }
    const float m_new = fmaxf(m[i], group_max(mt));
    const float alpha = expf(m[i] - m_new);
    float p[4], rs = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      p[j] = expf(s[i][j] - m_new);
      rs += p[j];
    }
    l[i] = l[i] * alpha + rs;
    m[i] = m_new;
#pragma unroll
    for (int c = 0; c < F::kNU * F::kVec; ++c) acc[i][c] *= alpha;
    *reinterpret_cast<float4*>(p_w + (rg + 4 * i) * F::kLP + 4 * g) =
        make_float4(p[0], p[1], p[2], p[3]);
  }
  __syncwarp();  // P is written

  // acc += P V: column 4c + jj of P is key c + 8jj
  const int n_groups = FULL ? 4 : (n_keys + 7) / 8;
#pragma unroll 2
  for (int c = 0; c < 8; ++c) {
    float pr[F::kRL][4];
#pragma unroll
    for (int i = 0; i < F::kRL; ++i) {
      const float4 x = FULL || 4 * i < n_rows
                           ? ld4(p_w + (rg + 4 * i) * F::kLP + 4 * c)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
      pr[i][0] = x.x;
      pr[i][1] = x.y;
      pr[i][2] = x.z;
      pr[i][3] = x.w;
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      if (!FULL && jj >= n_groups) continue;
      const float* vr = v_c + (c + 8 * jj) * DV + g * F::kVec;
#pragma unroll
      for (int u = 0; u < F::kNU; ++u) {
        float w[4];
        if constexpr (F::kVec == 4) {
          const float4 x = ld4(vr + 32 * u);
          w[0] = x.x;
          w[1] = x.y;
          w[2] = x.z;
          w[3] = x.w;
        } else {
          const float2 x = *reinterpret_cast<const float2*>(vr + 16 * u);
          w[0] = x.x;
          w[1] = x.y;
        }
#pragma unroll
        for (int i = 0; i < F::kRL; ++i) {
          if (!FULL && 4 * i >= n_rows) continue;
#pragma unroll
          for (int e = 0; e < F::kVec; ++e)
            acc[i][u * F::kVec + e] =
                fmaf(pr[i][jj], w[e], acc[i][u * F::kVec + e]);
        }
      }
    }
  }
}

template <int D, int DV>
__global__ void __launch_bounds__(Fwd<D, DV>::kThreads,
                                  Fwd<D, DV>::kMinBlocks)
    flash_attention_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           float* __restrict__ out, Strides qs, Strides ks,
                           Strides vs, int n_heads, int group, int sq,
                           int sk, float scale, int causal, int wide,
                           float* __restrict__ lse) {
  using F = Fwd<D, DV>;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rg = lane >> 3, g = lane & 7;
  float* p_w = sm + F::kP + warp * F::kRowsW * F::kLP;

  // heavy (late) causal tiles first, so the short ones fill the tail
  const int qtile = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qtile * F::kRows;
  const int hh = blockIdx.y, b = blockIdx.z;
  const int kvh = hh / group;
  const float* qb = q + b * qs.b + hh * qs.h;
  const float* kb = k + b * ks.b + kvh * ks.h;
  const float* vb = v + b * vs.b + kvh * vs.h;

  // the block's rows below Sq and the keys it needs (below Sk, and up to
  // its last row when causal); a warp's rows and keys
  const int n_rows = min(F::kRows, sq - q0);
  const int k_end = causal ? min(sk, q0 + n_rows) : sk;
  const int n_tiles = (k_end + F::kKeys - 1) / F::kKeys;
  const int w0 = warp * F::kRowsW;
  const int w_rows = min(F::kRowsW, n_rows - w0);
  const int w_end = causal ? min(sk, q0 + w0 + w_rows) : sk;

  // a tile's keys up to the 8-key group that holds its last needed one
  // (the groups a warp reads), zero past Sk
  auto stage_kv = [&](int t, int st) {
    const int k0 = t * F::kKeys;
    const int n = min(F::kKeys, (k_end - k0 + 7) & ~7);
    float* k_s = sm + F::kKV + st * F::kStageFloats;
    stage_rows<D, F::kLQ, F::kThreads>(k_s, kb, ks.s, k0, n, sk, wide);
    stage_rows<DV, DV, F::kThreads>(k_s + F::kKeys * F::kLQ, vb, vs.s, k0, n,
                                    sk, wide);
  };
  stage_rows<D, F::kLQ, F::kThreads>(sm, qb, qs.s, q0,
                                     min(F::kRows, (n_rows + 3) & ~3), sq,
                                     wide);
#pragma unroll
  for (int t = 0; t < F::kStages - 1; ++t) {
    if (t < n_tiles) stage_kv(t, t);
    cp_async_commit();
  }

  float m[F::kRL], l[F::kRL], acc[F::kRL][F::kNU * F::kVec];
#pragma unroll
  for (int i = 0; i < F::kRL; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < F::kNU * F::kVec; ++c) acc[i][c] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<F::kStages - 2>();  // tile t (and Q) have landed
    __syncthreads();
    // into the stage of tile t - 1, which every warp is done with
    if (t + F::kStages - 1 < n_tiles)
      stage_kv(t + F::kStages - 1, (t + F::kStages - 1) % F::kStages);
    cp_async_commit();
    if (w_rows <= 0) continue;
    const int k0 = t * F::kKeys;
    const float* k_s = sm + F::kKV + (t % F::kStages) * F::kStageFloats;
    const float* v_s = k_s + F::kKeys * F::kLQ;
    for (int c0 = 0; c0 < F::kKeys && k0 + c0 < w_end; c0 += F::kChunk) {
      const int nk = min(F::kChunk, w_end - k0 - c0);
      if (w_rows == F::kRowsW && nk == F::kChunk)
        softmax_step<D, DV, true>(sm + w0 * F::kLQ, k_s + c0 * F::kLQ,
                                  v_s + c0 * DV, p_w, m, l, acc, q0 + w0,
                                  k0 + c0, w_rows, nk, sk, causal, scale, rg,
                                  g);
      else
        softmax_step<D, DV, false>(sm + w0 * F::kLQ, k_s + c0 * F::kLQ,
                                   v_s + c0 * DV, p_w, m, l, acc, q0 + w0,
                                   k0 + c0, w_rows, nk, sk, causal, scale,
                                   rg, g);
    }
  }
  if (w_rows <= 0) return;

  const long long bh = static_cast<long long>(b) * n_heads + hh;
#pragma unroll
  for (int i = 0; i < F::kRL; ++i) {
    const float sum = fmaxf(group_sum(l[i]), 1e-30f);
    const int row = q0 + w0 + rg + 4 * i;
    if (4 * i >= w_rows || row >= sq) continue;
    // the row's log-sum-exp, for the backward (flash_attention_bwd.cu)
    if (lse != nullptr && g == 0) lse[bh * sq + row] = m[i] + logf(sum);
    const float inv = 1.f / sum;
    float* orow = out + (bh * sq + row) * DV + g * F::kVec;
#pragma unroll
    for (int u = 0; u < F::kNU; ++u) {
      const int c = u * F::kVec;
      if constexpr (F::kVec == 4)
        *reinterpret_cast<float4*>(orow + 32 * u) =
            make_float4(acc[i][c] * inv, acc[i][c + 1] * inv,
                        acc[i][c + 2] * inv, acc[i][c + 3] * inv);
      else
        *reinterpret_cast<float2*>(orow + 16 * u) =
            make_float2(acc[i][c] * inv, acc[i][c + 1] * inv);
    }
  }
}

// fp32 split-KV decode partials on the CUDA cores.  Block (split, kv head,
// b) of kDecodeThreads threads; the kv head's `group` query heads in passes
// of kDecodeHeads.  Shared memory: the ring of kStages chunks, q of the
// pass's heads, the scores then weights of the split (kDecodeHeads x
// kSplit) and each head's max and sum.
template <int D>
__global__ void __launch_bounds__(kDecodeThreads)
    flash_decode_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const int* __restrict__ kv_len,
                        float* __restrict__ acc_out, float* __restrict__ m_out,
                        float* __restrict__ l_out, int n_heads, int group,
                        int t_len, int n_sp, float scale) {
  constexpr int kRow = D * 4;  // bytes of a row
  constexpr int kPieces = kRow / 16;
  constexpr int kChunkBytes = kChunk * kRow;
  constexpr int kPairs = D / 2;
  constexpr int kPerThread =
      (kDecodeHeads * kPairs + kDecodeThreads - 1) / kDecodeThreads;
  extern __shared__ float4 decode_smem4[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(decode_smem4);
  unsigned char* qs = ring + kStages * kChunkBytes;
  float* ss = reinterpret_cast<float*>(qs + kDecodeHeads * kRow);
  float* ms = ss + kDecodeHeads * kSplit;
  float* ls = ms + kDecodeHeads;

  const int sp = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = kv_len[b];
  const int start = sp * kSplit;
  const int n = min(kSplit, t_len - start);
  const int n_ch = (n + kChunk - 1) / kChunk;
  // (b, first query head of the group, sp); a head's slots are n_sp apart
  const long long slot0 =
      (static_cast<long long>(b) * n_heads + kvh * group) * n_sp + sp;

  if (len > 0 && start >= len) {  // wholly past the valid cache: weight 0
    for (int i = tid; i < group * D; i += kDecodeThreads)
      acc_out[(slot0 + static_cast<long long>(i / D) * n_sp) * D + i % D] =
          0.f;
    for (int g = tid; g < group; g += kDecodeThreads) {
      m_out[slot0 + static_cast<long long>(g) * n_sp] = kNegInf;
      l_out[slot0 + static_cast<long long>(g) * n_sp] = 0.f;
    }
    return;
  }

  const long long row0 =
      (static_cast<long long>(b) * (n_heads / group) + kvh) * t_len + start;
  const unsigned char* kb = reinterpret_cast<const unsigned char*>(k + row0 * D);
  const unsigned char* vb = reinterpret_cast<const unsigned char*>(v + row0 * D);
  // chunk c < n_ch is K's chunk c, then V's chunk c - n_ch; every thread
  // commits a group for every c, empty or not, so the waits count alike
  auto fetch = [&](int c) {
    if (c < 2 * n_ch) {
      const int cc = c < n_ch ? c : c - n_ch;
      const unsigned char* src =
          (c < n_ch ? kb : vb) + static_cast<long long>(cc) * kChunkBytes;
      const int bytes = min(kChunk, n - cc * kChunk) * kRow;
      unsigned char* dst = ring + (c % kStages) * kChunkBytes;
      for (int off = tid * 16; off < bytes; off += kDecodeThreads * 16)
        cp_async16(dst + off, src + off);
    }
    cp_async_commit();
  };

  for (int g0 = 0; g0 < group; g0 += kDecodeHeads) {
    const int ng = min(kDecodeHeads, group - g0);
    const unsigned char* qb = reinterpret_cast<const unsigned char*>(
        q + (static_cast<long long>(b) * n_heads + kvh * group + g0) * D);
    for (int i = tid; i < ng * kPieces; i += kDecodeThreads)
      *reinterpret_cast<uint4*>(qs + i * 16) =
          *reinterpret_cast<const uint4*>(qb + i * 16);
    float acc0[kPerThread], acc1[kPerThread];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) acc0[j] = acc1[j] = 0.f;

    for (int c = 0; c < kStages - 1; ++c) fetch(c);
    for (int c = 0; c < 2 * n_ch; ++c) {
      fetch(c + kStages - 1);
      cp_async_wait<kStages - 1>();  // chunk c has landed
      __syncthreads();
      const unsigned char* buf = ring + (c % kStages) * kChunkBytes;
      if (c < n_ch) {
        // scores: thread (head g, position t) dots q_g with the staged K
        // row; its 16-byte pieces rotated by t, so that a quarter warp
        // reads distinct banks
        const int p0 = c * kChunk;
        const int rows = min(kChunk, n - p0);
        for (int i = tid; i < ng * kChunk; i += kDecodeThreads) {
          const int g = i / kChunk, t = i % kChunk;
          if (t >= rows) continue;
          const unsigned char* kr = buf + t * kRow;
          const unsigned char* qr = qs + g * kRow;
          float dot = 0.f;
#pragma unroll
          for (int j = 0; j < kPieces; ++j) {
            const int pc = (j + t) % kPieces;
            const float4 kf = *reinterpret_cast<const float4*>(kr + pc * 16);
            const float4 qf = *reinterpret_cast<const float4*>(qr + pc * 16);
            dot = fmaf(qf.x, kf.x, dot);
            dot = fmaf(qf.y, kf.y, dot);
            dot = fmaf(qf.z, kf.z, dot);
            dot = fmaf(qf.w, kf.w, dot);
          }
          ss[g * kSplit + p0 + t] =
              start + p0 + t < len ? dot * scale : kNegInf;
        }
      } else {
        if (c == n_ch) {
          // every score of the split is in: a warp per head takes the max
          // (each score >= -1e30), the weights and their sum
          for (int g = warp; g < ng; g += kDecodeThreads / 32) {
            float* sg = ss + g * kSplit;
            float mx = kNegInf;
            for (int t = lane; t < n; t += 32) mx = fmaxf(mx, sg[t]);
#pragma unroll
            for (int o = 16; o > 0; o >>= 1)
              mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
            float sum = 0.f;
            for (int t = lane; t < n; t += 32) {
              const float p = expf(sg[t] - mx);
              sg[t] = p;
              sum += p;
            }
#pragma unroll
            for (int o = 16; o > 0; o >>= 1)
              sum += __shfl_xor_sync(0xffffffffu, sum, o);
            if (lane == 0) {
              ms[g] = mx;
              ls[g] = sum;
            }
          }
          __syncthreads();
        }
        // P·V: thread (head g, columns e, e + 1) over the staged V rows
        const int p0 = (c - n_ch) * kChunk;
        const int rows = min(kChunk, n - p0);
#pragma unroll
        for (int j = 0; j < kPerThread; ++j) {
          const int i = tid + j * kDecodeThreads;
          if (i < ng * kPairs) {
            const int g = i / kPairs, e = (i % kPairs) * 2;
            const float* pg = ss + g * kSplit + p0;
            const float* vr = reinterpret_cast<const float*>(buf) + e;
            float a0 = acc0[j], a1 = acc1[j];
            for (int t = 0; t < rows; ++t) {
              const float2 x = *reinterpret_cast<const float2*>(vr + t * D);
              a0 = fmaf(pg[t], x.x, a0);
              a1 = fmaf(pg[t], x.y, a1);
            }
            acc0[j] = a0;
            acc1[j] = a1;
          }
        }
      }
      __syncthreads();  // the stage is read before it is refilled
    }
    cp_async_wait<0>();

    const long long slot = slot0 + static_cast<long long>(g0) * n_sp;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int i = tid + j * kDecodeThreads;
      if (i < ng * kPairs) {
        const int g = i / kPairs, e = (i % kPairs) * 2;
        float* o = acc_out + (slot + static_cast<long long>(g) * n_sp) * D + e;
        o[0] = acc0[j];
        o[1] = acc1[j];
      }
    }
    if (tid < ng) {
      m_out[slot + static_cast<long long>(tid) * n_sp] = ms[tid];
      l_out[slot + static_cast<long long>(tid) * n_sp] = ls[tid];
    }
    __syncthreads();  // q, the scores and the stats are refilled next pass
  }
}

// bf16 split-KV decode partials on the tensor cores: the block of
// flash_decode_kernel, with the group's query heads (16 at a time) as the
// rows of warp-level mma.sync m16n8k16 products.  S = Q·Kᵀ: warp w takes
// the chunk's keys 8w..8w+7, Q's A fragments held in registers from global
// memory (rows past the group zero), K's B fragments read from the staged
// rows as 32-bit pairs.  P·V: warp w takes output columns 8j..8j+7 for j =
// w, w + 8, ...; P from the scores in shared memory, split into bf16 hi +
// lo (P rounded once to bf16 would carry 2^-9 of each weight into the
// output; the two halves carry 2^-17), V's B fragments by ldmatrix.trans.
// Products and sums are fp32.  Staged rows are padded by 16 bytes, so the
// fragment loads of a warp's 8 rows hit distinct banks; the chunk past the
// split's end is zeroed, so no stale value reaches a product.
constexpr int kTcHeads = 16;   // query heads a pass (the mma's 16 rows)
constexpr int kTcStages = 4;   // chunks of the cp.async ring
constexpr int kSsLd = kSplit + 8;  // score row stride (floats)
static_assert(kDecodeThreads / 32 * 8 == kChunk,
              "a warp scores 8 keys of a chunk");

// Two floats as one register of bf16 (x in the low half).
__device__ __forceinline__ unsigned pack_bf16(float x, float y) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const unsigned*>(&p);
}

__device__ __forceinline__ void mma_bf16(float* d, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int D>
__global__ void __launch_bounds__(kDecodeThreads)
    flash_decode_tc_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const int* __restrict__ kv_len,
                           float* __restrict__ acc_out,
                           float* __restrict__ m_out,
                           float* __restrict__ l_out, int n_heads, int group,
                           int t_len, int n_sp, float scale) {
  constexpr int kRow = D * 2;             // bytes of a cache row
  constexpr int kLdRow = kRow + 16;       // bytes of a staged row
  constexpr int kChunkBytes = kChunk * kLdRow;
  constexpr int kKSteps = D / 16;         // k-steps of S = Q·Kᵀ
  constexpr int kNTiles = D / 8;          // 8-column tiles of the output
  constexpr int kWarps = kDecodeThreads / 32;
  constexpr int kTilesPerWarp = (kNTiles + kWarps - 1) / kWarps;
  extern __shared__ float4 decode_tc_smem4[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(decode_tc_smem4);
  float* ss = reinterpret_cast<float*>(ring + kTcStages * kChunkBytes);
  float* ms = ss + kTcHeads * kSsLd;
  float* ls = ms + kTcHeads;

  const int sp = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = lane >> 2, c0 = (lane & 3) * 2;  // fragment row, column
  const int len = kv_len[b];
  const int start = sp * kSplit;
  const int n = min(kSplit, t_len - start);
  const int n_ch = (n + kChunk - 1) / kChunk;
  const long long slot0 =
      (static_cast<long long>(b) * n_heads + kvh * group) * n_sp + sp;

  if (len > 0 && start >= len) {  // wholly past the valid cache: weight 0
    for (int i = tid; i < group * D; i += kDecodeThreads)
      acc_out[(slot0 + static_cast<long long>(i / D) * n_sp) * D + i % D] =
          0.f;
    for (int g = tid; g < group; g += kDecodeThreads) {
      m_out[slot0 + static_cast<long long>(g) * n_sp] = kNegInf;
      l_out[slot0 + static_cast<long long>(g) * n_sp] = 0.f;
    }
    return;
  }

  const long long row0 =
      (static_cast<long long>(b) * (n_heads / group) + kvh) * t_len + start;
  const unsigned char* kb = reinterpret_cast<const unsigned char*>(k + row0 * D);
  const unsigned char* vb = reinterpret_cast<const unsigned char*>(v + row0 * D);
  auto fetch = [&](int c) {
    if (c < 2 * n_ch) {
      const int cc = c < n_ch ? c : c - n_ch;
      const unsigned char* src =
          (c < n_ch ? kb : vb) + static_cast<long long>(cc) * kChunk * kRow;
      const int rows = min(kChunk, n - cc * kChunk);
      unsigned char* dst = ring + (c % kTcStages) * kChunkBytes;
      for (int i = tid; i < kChunk * (kRow / 16); i += kDecodeThreads) {
        const int r = i / (kRow / 16), off = (i % (kRow / 16)) * 16;
        if (r < rows)
          cp_async16(dst + r * kLdRow + off, src + r * kRow + off);
        else
          *reinterpret_cast<uint4*>(dst + r * kLdRow + off) =
              make_uint4(0u, 0u, 0u, 0u);
      }
    }
    cp_async_commit();
  };

  for (int g0 = 0; g0 < group; g0 += kTcHeads) {
    const int ng = min(kTcHeads, group - g0);
    // Q's A fragments: rows r0 and r0 + 8 (heads), columns c0 + {0, 1}
    // and c0 + 8 + {0, 1} of each k-step
    unsigned qa[kKSteps][4];
    const __nv_bfloat16* qb =
        q + (static_cast<long long>(b) * n_heads + kvh * group + g0) * D;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + (i & 1) * 8, col = kk * 16 + c0 + (i >> 1) * 8;
        qa[kk][i] = row < ng ? *reinterpret_cast<const unsigned*>(
                                   qb + static_cast<long long>(row) * D + col)
                             : 0u;
      }
    }
    float o[kTilesPerWarp][4];
#pragma unroll
    for (int j = 0; j < kTilesPerWarp; ++j)
      o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

    for (int c = 0; c < kTcStages - 1; ++c) fetch(c);
    for (int c = 0; c < 2 * n_ch; ++c) {
      fetch(c + kTcStages - 1);
      cp_async_wait<kTcStages - 1>();  // chunk c has landed
      __syncthreads();
      const unsigned char* buf = ring + (c % kTcStages) * kChunkBytes;
      if (c < n_ch) {
        // S for the chunk's keys 8w..8w+7: key r0 of the tile holds the B
        // fragment's column, its d pairs c0 and c0 + 8 of each k-step
        const int p0 = c * kChunk;
        const unsigned char* kr = buf + (warp * 8 + r0) * kLdRow;
        float sacc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < kKSteps; ++kk) {
          const unsigned b0 =
              *reinterpret_cast<const unsigned*>(kr + (kk * 16 + c0) * 2);
          const unsigned b1 =
              *reinterpret_cast<const unsigned*>(kr + (kk * 16 + c0 + 8) * 2);
          mma_bf16(sacc, qa[kk], b0, b1);
        }
        // sacc: heads r0 (0, 1) and r0 + 8 (2, 3), keys c0 + {0, 1}
        const int t = p0 + warp * 8 + c0;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int g = r0 + (i >> 1) * 8, pos = t + (i & 1);
          if (g < ng && pos < n)
            ss[g * kSsLd + pos] =
                start + pos < len ? sacc[i] * scale : kNegInf;
        }
      } else {
        if (c == n_ch) {
          for (int g = warp; g < ng; g += kWarps) {
            float* sg = ss + g * kSsLd;
            float mx = kNegInf;
            for (int t = lane; t < n; t += 32) mx = fmaxf(mx, sg[t]);
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
              mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            float sum = 0.f;
            for (int t = lane; t < n; t += 32) {
              const float p = expf(sg[t] - mx);
              sg[t] = p;
              sum += p;
            }
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
              sum += __shfl_xor_sync(0xffffffffu, sum, off);
            if (lane == 0) {
              ms[g] = mx;
              ls[g] = sum;
            }
          }
          __syncthreads();
        }
        // O += P·V over the chunk's 64 keys, two k-steps an ldmatrix
        const int p0 = (c - n_ch) * kChunk;
#pragma unroll
        for (int kp = 0; kp < kChunk / 32; ++kp) {
          unsigned ph[2][4], pl[2][4];  // P's hi and lo A fragments
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int g = r0 + (i & 1) * 8;
              const int key = kp * 32 + h2 * 16 + c0 + (i >> 1) * 8;
              float2 pv = make_float2(0.f, 0.f);
              if (g < ng) {
                pv.x = p0 + key < n ? ss[g * kSsLd + p0 + key] : 0.f;
                pv.y = p0 + key + 1 < n ? ss[g * kSsLd + p0 + key + 1] : 0.f;
              }
              const __nv_bfloat162 hi = __floats2bfloat162_rn(pv.x, pv.y);
              const float2 hf = __bfloat1622float2(hi);
              ph[h2][i] = *reinterpret_cast<const unsigned*>(&hi);
              pl[h2][i] = pack_bf16(pv.x - hf.x, pv.y - hf.y);
            }
          }
#pragma unroll
          for (int j = 0; j < kTilesPerWarp; ++j) {
            const int nt = warp + j * kWarps;
            if (nt < kNTiles) {
              // keys kp*32 + 8m + (lane & 7) of matrix m = lane / 8, the
              // tile's 8 columns: b0, b1 of k-step 2kp, then of 2kp + 1
              const unsigned char* addr =
                  buf + (kp * 32 + lane) * kLdRow + nt * 16;
              unsigned vb0, vb1, vb2, vb3;
              asm volatile(
                  "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
                  "{%0, %1, %2, %3}, [%4];\n"
                  : "=r"(vb0), "=r"(vb1), "=r"(vb2), "=r"(vb3)
                  : "r"(static_cast<unsigned>(__cvta_generic_to_shared(addr))));
              mma_bf16(o[j], ph[0], vb0, vb1);
              mma_bf16(o[j], pl[0], vb0, vb1);
              mma_bf16(o[j], ph[1], vb2, vb3);
              mma_bf16(o[j], pl[1], vb2, vb3);
            }
          }
        }
      }
      __syncthreads();  // the stage is read before it is refilled
    }
    cp_async_wait<0>();

    const long long slot = slot0 + static_cast<long long>(g0) * n_sp;
#pragma unroll
    for (int j = 0; j < kTilesPerWarp; ++j) {
      const int nt = warp + j * kWarps;
      if (nt < kNTiles) {
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int g = r0 + h2 * 8;
          if (g < ng)
            *reinterpret_cast<float2*>(
                acc_out + (slot + static_cast<long long>(g) * n_sp) * D +
                nt * 8 + c0) = make_float2(o[j][2 * h2], o[j][2 * h2 + 1]);
        }
      }
    }
    if (tid < ng) {
      m_out[slot + static_cast<long long>(tid) * n_sp] = ms[tid];
      l_out[slot + static_cast<long long>(tid) * n_sp] = ls[tid];
    }
    __syncthreads();  // the scores and the stats are refilled next pass
  }
}

// The log-sum-exp merge of the splits: one block of D threads per (h, b),
// the splits taken in order, so the result does not depend on scheduling:
// Σ e^{m_i - m*} acc_i / max(Σ e^{m_i - m*} l_i, 1e-30), written in T.
template <typename T, int D>
__global__ void __launch_bounds__(D)
    flash_decode_merge_kernel(const float* __restrict__ acc,
                              const float* __restrict__ m,
                              const float* __restrict__ l,
                              T* __restrict__ out, int n_sp) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const long long bh = static_cast<long long>(b) * gridDim.x + h;
  const float* mb = m + bh * n_sp;
  const float* lb = l + bh * n_sp;
  float m_star = mb[0];
  for (int s = 1; s < n_sp; ++s) m_star = fmaxf(m_star, mb[s]);
  float denom = 0.f, a = 0.f;
  for (int s = 0; s < n_sp; ++s) {
    const float w = expf(mb[s] - m_star);
    denom += w * lb[s];
    a += w * acc[(bh * n_sp + s) * D + d];
  }
  store_as(&out[bh * D + d], a / fmaxf(denom, 1e-30f));
}

// Whether a (B, H, S, W) view's rows all start on a 16-byte boundary: its
// base and each stride of an axis longer than 1 (W is unit stride and a
// multiple of 4).
bool rows_aligned(const void* p, const Strides& s, int nb, int nh, int ns) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0 &&
         (nb == 1 || s.b % 4 == 0) && (nh == 1 || s.h % 4 == 0) &&
         (ns == 1 || s.s % 4 == 0);
}

template <int D, int DV>
int attention_d(const void* q, const void* k, const void* v, void* out,
                int b, int h, int hkv, int sq, int sk, Strides qs,
                Strides ks, Strides vs, float scale, int causal, float* lse,
                cudaStream_t stream) {
  using F = Fwd<D, DV>;
  const size_t smem = sizeof(float) * F::kFloats;
  auto kern = flash_attention_kernel<D, DV>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  // 16-byte copies where every staged row starts on a 16-byte boundary
  const bool wide = rows_aligned(q, qs, b, h, sq) &&
                    rows_aligned(k, ks, b, hkv, sk) &&
                    rows_aligned(v, vs, b, hkv, sk);
  const dim3 grid((sq + F::kRows - 1) / F::kRows, h, b);
  kern<<<grid, F::kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), qs, ks, vs, h,
      h / hkv, sq, sk, scale, causal, wide ? 1 : 0, lse);
  return 0;
}

// The built (q/k width, v width) pairs: equal widths 16 to 128, and (96, 64)
// for MLA's prefill.
int attention_f32(int d, int dv, const void* q, const void* k, const void* v,
                  void* out, int b, int h, int hkv, int sq, int sk,
                  Strides qs, Strides ks, Strides vs, float scale, int causal,
                  float* lse, cudaStream_t stream) {
#define FA_CASE(D, DV)                                                      \
  if (d == D && dv == DV)                                                   \
    return attention_d<D, DV>(q, k, v, out, b, h, hkv, sq, sk, qs, ks, vs,  \
                              scale, causal, lse, stream);
  FA_CASE(16, 16)
  FA_CASE(32, 32)
  FA_CASE(64, 64)
  FA_CASE(128, 128)
  FA_CASE(96, 64)
#undef FA_CASE
  return -1;
}

// Launches a split kernel over (split, kv head, b) with `smem` bytes of
// dynamic shared memory; returns the CUDA error of the attribute or launch.
template <typename T, typename Kernel>
cudaError_t launch_split(Kernel kern, size_t smem, const void* q,
                         const void* k, const void* v, const int* kv_len,
                         float* acc, float* m, float* l, int b, int h,
                         int hkv, int t_len, int n_sp, float scale,
                         cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kern<<<dim3(n_sp, hkv, b), kDecodeThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_len, acc, m, l, h, h / hkv, t_len, n_sp,
      scale);
  return cudaGetLastError();
}

// The splits on the tensor cores for bf16, on the CUDA cores for fp32 (no
// TF32, ROADMAP rule b), then the merge.
template <typename T, int D>
int decode_d(const void* q, const void* k, const void* v, const int* kv_len,
             float* part, void* out, int b, int h, int hkv, int t_len,
             float scale, cudaStream_t stream) {
  const int n_sp = (t_len + kSplit - 1) / kSplit;
  float* acc = part;
  float* m = acc + static_cast<size_t>(b) * h * n_sp * D;
  float* l = m + static_cast<size_t>(b) * h * n_sp;
  cudaError_t err;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const size_t smem = static_cast<size_t>(kTcStages) * kChunk * (D * 2 + 16)
                        + sizeof(float) * (kTcHeads * kSsLd + 2 * kTcHeads);
    err = launch_split<T>(flash_decode_tc_kernel<D>, smem, q, k, v, kv_len,
                          acc, m, l, b, h, hkv, t_len, n_sp, scale, stream);
  } else {
    const size_t smem =
        static_cast<size_t>(kStages * kChunk + kDecodeHeads) * D * sizeof(T) +
        sizeof(float) * (kDecodeHeads * kSplit + 2 * kDecodeHeads);
    err = launch_split<T>(flash_decode_kernel<D>, smem, q, k, v, kv_len, acc,
                          m, l, b, h, hkv, t_len, n_sp, scale, stream);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_decode_merge_kernel<T, D><<<dim3(h, b), D, 0, stream>>>(
      acc, m, l, static_cast<T*>(out), n_sp);
  return 0;
}

template <typename T>
int decode_t(int d, const void* q, const void* k, const void* v,
             const int* kv_len, float* part, void* out, int b, int h,
             int hkv, int t_len, float scale, cudaStream_t stream) {
  switch (d) {
    case 16: return decode_d<T, 16>(q, k, v, kv_len, part, out, b, h, hkv,
                                    t_len, scale, stream);
    case 32: return decode_d<T, 32>(q, k, v, kv_len, part, out, b, h, hkv,
                                    t_len, scale, stream);
    case 64: return decode_d<T, 64>(q, k, v, kv_len, part, out, b, h, hkv,
                                    t_len, scale, stream);
    case 128: return decode_d<T, 128>(q, k, v, kv_len, part, out, b, h, hkv,
                                      t_len, scale, stream);
    default: return -1;
  }
}

}  // namespace

// Prefill attention on fp32 inputs: one 256-thread block per (128-row query
// tile, h, b).  q, k (width d), v (width dv): fp32, unit stride along the
// width, the given element strides along (B, H, S) (rows off a 16-byte
// boundary are staged 4 bytes a copy); out (B, H, Sq, dv)
// contiguous fp32; lse, when not null, (B, H, Sq) fp32 takes each row's
// log-sum-exp of its scaled, masked logits (max + log(max(sum, 1e-30))),
// which the backward reads.  Returns 0 when launched (the caller checks the
// launch), -1 for a width pair it is not built for, or the CUDA error of
// the shared-memory attribute.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int b, int h, int hkv, int sq, int sk,
                           int d, int dv, long long qsb, long long qsh,
                           long long qss, long long ksb, long long ksh,
                           long long kss, long long vsb, long long vsh,
                           long long vss, float scale, int causal,
                           float* lse, cudaStream_t stream) {
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss};
  return attention_f32(d, dv, q, k, v, out, b, h, hkv, sq, sk, qs, ks, vs,
                       scale, causal, lse, stream);
}

// Split-KV decode: one 256-thread block per (512-position split, kv head,
// b) writes the splits' partials into `part` (fp32 scratch of B·H·n_sp·(D
// + 2) values: acc (B, H, n_sp, D), then m and l (B, H, n_sp)), then one
// block per (h, b) merges them into `out` (B, H, D) in q's type.  q (B, H,
// D) and the caches (B, Hkv, T, D) contiguous and 16-byte aligned, fp32 or
// bf16; kv_len (B,) int32.  Returns 0 when launched (the caller checks the
// merge's launch), -1 for a head width it is not built for, or the CUDA
// error of the shared-memory attribute or of the first launch.
int flash_decode_launch(const void* q, const void* k, const void* v,
                        const int* kv_len, float* part, void* out, int bf16,
                        int b, int h, int hkv, int t_len, int d, float scale,
                        cudaStream_t stream) {
  if (bf16)
    return decode_t<__nv_bfloat16>(d, q, k, v, kv_len, part, out, b, h, hkv,
                                   t_len, scale, stream);
  return decode_t<float>(d, q, k, v, kv_len, part, out, b, h, hkv, t_len,
                         scale, stream);
}
