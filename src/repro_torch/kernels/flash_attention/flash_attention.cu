// Attention of the LM serving path: tiled online-softmax prefill attention
// and split-KV single-token decode.
//
// Replaces the two Pallas kernels of repro/kernels/flash_attention/kernel.py:
//
// * `flash_attention` (body `_flash_kernel`) on fp32 inputs:
//   softmax(q kᵀ · scale) v for q (B, H, Sq, D), k (B, Hkv, Sk, D) and v
//   (B, Hkv, Sk, Dv), causal or not, GQA through the kv head h / (H /
//   Hkv), fp32 math and output (B, H, Sq, Dv); built for D = Dv at 16 to
//   128 and for (D, Dv) = (96, 64), MLA's prefill.  bf16 inputs go to the tensor-core kernel of
//   flash_attention_sm90.cu.  The TPU kernel walks KV tiles along a
//   sequential grid axis and carries (m, l, acc) in VMEM from one grid
//   step to the next; blocks on the card run in no order, so here one
//   block owns a 64-row query tile of one (b, h) and loops over the KV
//   tiles itself, stopping at the diagonal when causal.  Q, each K tile (transposed) and then each V
//   tile are staged in shared memory as fp32, K and V read straight from
//   the kv head's rows, so no GQA copy is made.  Each of the 256 threads
//   holds a 4 x 4 block of the 64 x 64 score tile and a 4-row x 4·⌈Dv/64⌉
//   block of the fp32 accumulator in registers, with its rows' running
//   max and sum; row reductions are shuffles over the 16 threads that
//   share the rows.  P stays fp32 (no bf16 rounding, no TF32), logits are
//   scaled after the dot as the TPU kernel does, masked logits are -1e30
//   and the final sum is floored at 1e-30, as there.  Rows and keys past
//   Sq / Sk are masked, so any S is taken (the TPU wrapper's `s // tq`
//   drops a ragged tail).
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
// only as TF32 (ROADMAP rule b).  The kernel keeps every operand of the inner products in
// shared memory or registers (16 FMAs per two 16-byte shared loads in the
// score loop) and skips the tiles above the diagonal.  The bf16 prefill
// of the served model runs on the tensor cores (wgmma fed by TMA) in
// flash_attention_sm90.cu.  Decode is bytes: the
// valid part of the cache read once (33.6 MB a layer at 4 x 4,100 Yi-6B
// positions, 10 µs); the kernel reads it once, with chunks in flight on
// every block.  Its arithmetic, 4·D operations per head and position, is
// little beside the bytes, but on the CUDA cores each operation costs its
// shared-memory loads and conversions too, enough instructions to bound a
// bf16 call; the tensor cores take that part.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64;          // query rows of a prefill block
constexpr int kBK = 64;          // keys of a KV tile
constexpr int kPad = 4;          // row padding of the transposed tiles
constexpr int kLd = kBK + kPad;  // row stride of qt / kt / ps (16 B multiple)
constexpr int kThreads = 256;    // 16 x 16 threads, each 4 rows x 4 keys
constexpr int kSplit = 512;      // cache positions a decode block reduces
constexpr int kDecodeThreads = 256;
constexpr int kDecodeHeads = 8;  // query heads a decode block takes at once
constexpr int kChunk = 64;       // cache positions of a staged chunk
constexpr int kStages = 3;       // chunks of the cp.async ring

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Reductions over the 16 lanes that share a row (lanes 0-15 or 16-31).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

struct Strides {
  long long b, h, s;  // element strides of the (B, H, S) axes; D is unit
};

// The shared-memory floats of a block at q/k width D and v width DV: Q
// transposed, one K (transposed) or V tile, the P tile.
template <int D, int DV>
constexpr int attention_smem_floats() {
  return D * kLd + (D * kLd > kBK * DV ? D * kLd : kBK * DV) + kBQ * kLd;
}

template <typename T, int D, int DV>
__global__ void __launch_bounds__(kThreads, 2)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           Strides qs, Strides ks, Strides vs, int n_heads,
                           int group, int sq, int sk, float scale,
                           int causal, float* __restrict__ lse) {
  constexpr int kNU = (DV + 63) / 64;  // 4-wide accumulator column groups
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // [D][kLd], rows as columns
  float* kv = qt + D * kLd;                    // K as [D][kLd] or V [kBK][DV]
  float* ps = kv + (D * kLd > kBK * DV ? D * kLd : kBK * DV);  // [kBQ][kLd]

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  // heavy (late) causal tiles first, so the short ones fill the tail
  const int qtile = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qtile * kBQ;
  const int hh = blockIdx.y, b = blockIdx.z;
  const int kvh = hh / group;
  const T* qb = q + b * qs.b + hh * qs.h;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    qt[d * kLd + r] = q0 + r < sq ? to_f32(qb[(q0 + r) * qs.s + d]) : 0.f;
  }

  float m[4], l[4], acc[4][4 * kNU];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * kNU; ++c) acc[i][c] = 0.f;
  }

  int n_tiles = (sk + kBK - 1) / kBK;
  if (causal) {
    const int last = (min(q0 + kBQ, sq) - 1) / kBK + 1;
    n_tiles = min(n_tiles, last);
  }
  for (int jt = 0; jt < n_tiles; ++jt) {
    const int k0 = jt * kBK;
    // K tile, transposed: kv[d][j]
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int j = i / D, d = i % D;
      kv[d * kLd + j] = k0 + j < sk ? to_f32(kb[(k0 + j) * ks.s + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&qt[d * kLd + ty * 4]);
      const float4 c = *reinterpret_cast<const float4*>(&kv[d * kLd + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += av[i] * cv[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx * 4 + j;
        const bool ok = col < sk && (!causal || col <= row);
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mt = fmaxf(mt, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mt));
      const float alpha = expf(m[i] - m_new);
      float p[4], rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[j] = expf(s[i][j] - m_new);
        rs += p[j];
      }
      l[i] = l[i] * alpha + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * kNU; ++c) acc[i][c] *= alpha;
      *reinterpret_cast<float4*>(&ps[(ty * 4 + i) * kLd + tx * 4]) =
          make_float4(p[0], p[1], p[2], p[3]);
    }
    __syncthreads();  // kt fully read, ps written

    // V tile: kv[j][d]
    for (int i = tid; i < kBK * DV; i += kThreads) {
      const int j = i / DV, d = i % DV;
      kv[j * DV + d] = k0 + j < sk ? to_f32(vb[(k0 + j) * vs.s + d]) : 0.f;
    }
    __syncthreads();

#pragma unroll 2
    for (int j4 = 0; j4 < kBK; j4 += 4) {
      float pr[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 t =
            *reinterpret_cast<const float4*>(&ps[(ty * 4 + i) * kLd + j4]);
        pr[i][0] = t.x;
        pr[i][1] = t.y;
        pr[i][2] = t.z;
        pr[i][3] = t.w;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int u = 0; u < kNU; ++u) {
          const int d0 = tx * 4 + 64 * u;
          if (d0 < DV) {
            const float4 w =
                *reinterpret_cast<const float4*>(&kv[(j4 + jj) * DV + d0]);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              acc[i][4 * u + 0] += pr[i][jj] * w.x;
              acc[i][4 * u + 1] += pr[i][jj] * w.y;
              acc[i][4 * u + 2] += pr[i][jj] * w.z;
              acc[i][4 * u + 3] += pr[i][jj] * w.w;
            }
          }
        }
      }
    }
    __syncthreads();  // kv and ps are rewritten by the next tile
  }

  T* ob = out + (static_cast<long long>(b) * n_heads + hh) * sq * DV;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    // the row's log-sum-exp, for the backward (flash_attention_bwd.cu)
    if (lse != nullptr && tx == 0)
      lse[(static_cast<long long>(b) * n_heads + hh) * sq + row] =
          m[i] + logf(fmaxf(l[i], 1e-30f));
#pragma unroll
    for (int u = 0; u < kNU; ++u) {
      const int d0 = tx * 4 + 64 * u;
      if (d0 < DV) {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          store_as(&ob[static_cast<long long>(row) * DV + d0 + c],
                   acc[i][4 * u + c] * inv);
      }
    }
  }
}

// 16 bytes from global to shared memory, asynchronously (cp.async).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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

template <typename T, int D, int DV>
int attention_d(const void* q, const void* k, const void* v, void* out,
                int b, int h, int hkv, int sq, int sk, Strides qs,
                Strides ks, Strides vs, float scale, int causal, float* lse,
                cudaStream_t stream) {
  const size_t smem = sizeof(float) * attention_smem_floats<D, DV>();
  auto kern = flash_attention_kernel<T, D, DV>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kBQ - 1) / kBQ, h, b);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), qs, ks, vs, h, h / hkv,
      sq, sk, scale, causal, lse);
  return 0;
}

// The built (q/k width, v width) pairs: equal widths 16 to 128, and (96, 64)
// for MLA's prefill.
template <typename T>
int attention_t(int d, int dv, const void* q, const void* k, const void* v,
                void* out, int b, int h, int hkv, int sq, int sk, Strides qs,
                Strides ks, Strides vs, float scale, int causal, float* lse,
                cudaStream_t stream) {
#define FA_CASE(D, DV)                                                      \
  if (d == D && dv == DV)                                                   \
    return attention_d<T, D, DV>(q, k, v, out, b, h, hkv, sq, sk, qs, ks,   \
                                 vs, scale, causal, lse, stream);
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

// Prefill attention on fp32 inputs: one 256-thread block per (64-row query
// tile, h, b).  q, k (width d), v (width dv): fp32, unit stride along the
// width, the given element strides along (B, H, S); out (B, H, Sq, dv)
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
  return attention_t<float>(d, dv, q, k, v, out, b, h, hkv, sq, sk, qs, ks,
                            vs, scale, causal, lse, stream);
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
