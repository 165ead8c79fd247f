// Attention of the LM serving path: tiled online-softmax prefill attention
// and split-KV single-token decode.
//
// Replaces the two Pallas kernels of repro/kernels/flash_attention/kernel.py:
//
// * `flash_attention` (body `_flash_kernel`) on fp32 inputs:
//   softmax(q kᵀ · scale) v for q (B, H, Sq, D) and k, v (B, Hkv, Sk, D),
//   causal or not, GQA through the kv head h / (H / Hkv), fp32 math and
//   output.  bf16 inputs go to the tensor-core kernel of
//   flash_attention_sm90.cu.  The TPU kernel walks KV tiles along a
//   sequential grid axis and carries (m, l, acc) in VMEM from one grid
//   step to the next; blocks on the card run in no order, so here one
//   block owns a 64-row query tile of one (b, h) and loops over the KV
//   tiles itself, stopping at the diagonal when causal.  Q, each K tile (transposed) and then each V
//   tile are staged in shared memory as fp32, K and V read straight from
//   the kv head's rows, so no GQA copy is made.  Each of the 256 threads
//   holds a 4 x 4 block of the 64 x 64 score tile and a 4-row x 4·⌈D/64⌉
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
//   (b, h, 512-position split) writes the split's partial (acc, m, l) in
//   fp32; the log-sum-exp merge of the splits stays in the wrapper
//   (ops.py), as the TPU wrapper merges outside its kernel.  The last
//   split may be ragged (the TPU wrapper's `s // tk` drops it).  A split
//   that starts at or past kv_len[b] > 0 reads nothing and writes
//   (0, -1e30, 0): in the merge its weight exp(-1e30 - m*) is 0, as the
//   TPU kernel's all-masked split (m = -1e30, l = tk) gets, so the merged
//   output is unchanged.  With kv_len[b] <= 0 every position is masked and
//   every split is read, which gives the reference's uniform average.
//
// What bounds them on this card.  Prefill is operations: 4·B·H·Sq·Sk·D
// (halved when causal), held on fp32 inputs to the 67 TFLOP/s of the fp32
// CUDA cores, since the tensor cores would take fp32 only as TF32 (ROADMAP
// rule b).  The kernel keeps every operand of the inner products in
// shared memory or registers (16 FMAs per two 16-byte shared loads in the
// score loop) and skips the tiles above the diagonal.  The bf16 prefill
// of the served model runs on the tensor cores (wgmma fed by TMA) in
// flash_attention_sm90.cu.  Decode is bytes: the
// valid part of the cache read once (33.6 MB a layer at 4 x 4,100 Yi-6B
// positions, 10 µs).  Here each block re-reads its kv head's split once
// per query head of the group (8x for Yi-6B), through L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64;          // query rows of a prefill block
constexpr int kBK = 64;          // keys of a KV tile
constexpr int kPad = 4;          // row padding of the transposed tiles
constexpr int kLd = kBK + kPad;  // row stride of qt / kt / ps (16 B multiple)
constexpr int kThreads = 256;    // 16 x 16 threads, each 4 rows x 4 keys
constexpr int kSplit = 512;      // cache positions a decode block reduces
constexpr int kDecodeThreads = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }

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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           Strides qs, Strides ks, Strides vs, int n_heads,
                           int group, int sq, int sk, float scale,
                           int causal) {
  constexpr int kNU = (D + 63) / 64;  // 4-wide accumulator column groups
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // [D][kLd], rows as columns
  float* kv = qt + D * kLd;                     // K as [D][kLd] or V [kBK][D]
  float* ps = kv + (D * kLd > kBK * D ? D * kLd : kBK * D);  // [kBQ][kLd]

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
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int j = i / D, d = i % D;
      kv[j * D + d] = k0 + j < sk ? to_f32(vb[(k0 + j) * vs.s + d]) : 0.f;
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
          if (d0 < D) {
            const float4 w =
                *reinterpret_cast<const float4*>(&kv[(j4 + jj) * D + d0]);
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

  T* ob = out + (static_cast<long long>(b) * n_heads + hh) * sq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int u = 0; u < kNU; ++u) {
      const int d0 = tx * 4 + 64 * u;
      if (d0 < D) {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          store_as(&ob[static_cast<long long>(row) * D + d0 + c],
                   acc[i][4 * u + c] * inv);
      }
    }
  }
}

// Block-wide reduction of 128 threads through `red` (4 floats).
template <bool kMax>
__device__ __forceinline__ float block_reduce(float x, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, o);
    x = kMax ? fmaxf(x, y) : x + y;
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kDecodeThreads / 32; ++w)
    r = kMax ? fmaxf(r, red[w]) : r + red[w];
  __syncthreads();  // red may be reused
  return r;
}

template <typename T, int D>
__global__ void __launch_bounds__(kDecodeThreads)
    flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ kv_len,
                        float* __restrict__ acc_out, float* __restrict__ m_out,
                        float* __restrict__ l_out, int n_heads, int group,
                        int t_len, int n_sp, float scale) {
  __shared__ float qsh[D];
  __shared__ float ss[kSplit];
  __shared__ float red[kDecodeThreads / 32];
  const int sp = blockIdx.x, hh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = kv_len[b];
  const int start = sp * kSplit;
  const int n = min(kSplit, t_len - start);
  const long long slot = (static_cast<long long>(b) * n_heads + hh) * n_sp + sp;

  if (len > 0 && start >= len) {  // wholly past the valid cache: weight 0
    for (int d = tid; d < D; d += kDecodeThreads) acc_out[slot * D + d] = 0.f;
    if (tid == 0) {
      m_out[slot] = kNegInf;
      l_out[slot] = 0.f;
    }
    return;
  }

  const long long row0 =
      (static_cast<long long>(b) * (n_heads / group) + hh / group) * t_len +
      start;
  const T* kb = k + row0 * D;
  const T* vb = v + row0 * D;
  for (int d = tid; d < D; d += kDecodeThreads)
    qsh[d] = to_f32(q[(static_cast<long long>(b) * n_heads + hh) * D + d]);
  __syncthreads();

  for (int t = warp; t < n; t += kDecodeThreads / 32) {
    float dot = 0.f;
#pragma unroll
    for (int d = lane; d < D; d += 32) dot += qsh[d] * to_f32(kb[t * D + d]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      dot += __shfl_xor_sync(0xffffffffu, dot, o);
    if (lane == 0) ss[t] = start + t < len ? dot * scale : kNegInf;
  }
  __syncthreads();

  float mx = kNegInf;  // every score is >= -1e30
  for (int t = tid; t < n; t += kDecodeThreads) mx = fmaxf(mx, ss[t]);
  mx = block_reduce<true>(mx, red);
  float sum = 0.f;
  for (int t = tid; t < n; t += kDecodeThreads) {
    const float p = expf(ss[t] - mx);
    ss[t] = p;
    sum += p;
  }
  sum = block_reduce<false>(sum, red);  // its barriers publish ss

  for (int d = tid; d < D; d += kDecodeThreads) {
    float a = 0.f;
    for (int t = 0; t < n; ++t) a += ss[t] * to_f32(vb[t * D + d]);
    acc_out[slot * D + d] = a;
  }
  if (tid == 0) {
    m_out[slot] = mx;
    l_out[slot] = sum;
  }
}

template <typename T, int D>
int attention_d(const void* q, const void* k, const void* v, void* out,
                int b, int h, int hkv, int sq, int sk, Strides qs,
                Strides ks, Strides vs, float scale, int causal,
                cudaStream_t stream) {
  const int ld = D * kLd > kBK * D ? D * kLd : kBK * D;
  const size_t smem = sizeof(float) * (D * kLd + ld + kBQ * kLd);
  auto kern = flash_attention_kernel<T, D>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kBQ - 1) / kBQ, h, b);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), qs, ks, vs, h, h / hkv,
      sq, sk, scale, causal);
  return 0;
}

template <typename T>
int attention_t(int d, const void* q, const void* k, const void* v,
                void* out, int b, int h, int hkv, int sq, int sk, Strides qs,
                Strides ks, Strides vs, float scale, int causal,
                cudaStream_t stream) {
  switch (d) {
    case 16: return attention_d<T, 16>(q, k, v, out, b, h, hkv, sq, sk, qs,
                                       ks, vs, scale, causal, stream);
    case 32: return attention_d<T, 32>(q, k, v, out, b, h, hkv, sq, sk, qs,
                                       ks, vs, scale, causal, stream);
    case 64: return attention_d<T, 64>(q, k, v, out, b, h, hkv, sq, sk, qs,
                                       ks, vs, scale, causal, stream);
    case 128: return attention_d<T, 128>(q, k, v, out, b, h, hkv, sq, sk,
                                         qs, ks, vs, scale, causal, stream);
    default: return -1;
  }
}

template <typename T, int D>
int decode_d(const void* q, const void* k, const void* v, const int* kv_len,
             float* acc, float* m, float* l, int b, int h, int hkv,
             int t_len, float scale, cudaStream_t stream) {
  const int n_sp = (t_len + kSplit - 1) / kSplit;
  const dim3 grid(n_sp, h, b);
  flash_decode_kernel<T, D><<<grid, kDecodeThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_len, acc, m, l, h, h / hkv, t_len, n_sp,
      scale);
  return 0;
}

template <typename T>
int decode_t(int d, const void* q, const void* k, const void* v,
             const int* kv_len, float* acc, float* m, float* l, int b, int h,
             int hkv, int t_len, float scale, cudaStream_t stream) {
  switch (d) {
    case 16: return decode_d<T, 16>(q, k, v, kv_len, acc, m, l, b, h, hkv,
                                    t_len, scale, stream);
    case 32: return decode_d<T, 32>(q, k, v, kv_len, acc, m, l, b, h, hkv,
                                    t_len, scale, stream);
    case 64: return decode_d<T, 64>(q, k, v, kv_len, acc, m, l, b, h, hkv,
                                    t_len, scale, stream);
    case 128: return decode_d<T, 128>(q, k, v, kv_len, acc, m, l, b, h, hkv,
                                      t_len, scale, stream);
    default: return -1;
  }
}

}  // namespace

// Prefill attention on fp32 inputs: one 256-thread block per (64-row query
// tile, h, b).  q, k, v: fp32, unit stride along D, the given element
// strides along (B, H, S); out (B, H, Sq, D) contiguous fp32.
// Returns 0 when launched (the caller checks the launch), -1 for a head
// width it is not built for, or the CUDA error of the shared-memory
// attribute.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int b, int h, int hkv, int sq, int sk,
                           int d, long long qsb, long long qsh, long long qss,
                           long long ksb, long long ksh, long long kss,
                           long long vsb, long long vsh, long long vss,
                           float scale, int causal, cudaStream_t stream) {
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss};
  return attention_t<float>(d, q, k, v, out, b, h, hkv, sq, sk, qs, ks, vs,
                            scale, causal, stream);
}

// Split-KV decode partials: one 128-thread block per (512-position split,
// h, b).  q (B, H, D) and the caches (B, Hkv, T, D) contiguous, fp32 or
// bf16; kv_len (B,) int32; acc (B, H, n_sp, D), m and l (B, H, n_sp) fp32.
// Returns 0 when launched, -1 for a head width it is not built for.
int flash_decode_launch(const void* q, const void* k, const void* v,
                        const int* kv_len, float* acc, float* m, float* l,
                        int bf16, int b, int h, int hkv, int t_len, int d,
                        float scale, cudaStream_t stream) {
  if (bf16)
    return decode_t<__nv_bfloat16>(d, q, k, v, kv_len, acc, m, l, b, h, hkv,
                                   t_len, scale, stream);
  return decode_t<float>(d, q, k, v, kv_len, acc, m, l, b, h, hkv, t_len,
                         scale, stream);
}
