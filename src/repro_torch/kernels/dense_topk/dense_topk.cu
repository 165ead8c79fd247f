// Dense Stage-1 retrieval: the top-k of q_emb @ doc_emb^T per query.
//
// Replaces the Pallas kernel `dense_topk_tiles` (body `_dense_topk_kernel`)
// of repro/kernels/dense_topk/kernel.py.  The TPU kernel walks a
// (query, doc tile) grid in order and folds each tile into a running top-k
// held in an output block that every step of the row revisits.  A CUDA grid
// runs in no order, so the same function is computed in two passes:
//
//   1. dense_topk_chunks, one block per (query, chunk of `chunk` docs):
//      each doc's score is a sequential chain of fp32 FMAs (no tensor
//      cores, no TF32), its 64-bit sort key goes to shared memory, a
//      bitonic sort orders the chunk, and the first kp keys (kp = k rounded
//      up to a power of two) go to a scratch list (Q, n_chunks, kp).
//   2. dense_topk_merge, one block per query: a running top-kp list and up
//      to group-1 chunk lists at a time sit in shared memory and are merged
//      pairwise, each merge keeping the larger of A[i] and B[kp-1-i] (the
//      kp largest of the two lists, as a bitonic sequence) and sorting that
//      with a bitonic merge.  The first k keys are decoded to (score, id).
//
// Order and ties: a key is (score mapped to an order-preserving uint32) in
// the high half and (0xFFFFFFFF - doc id) in the low half, so "larger key"
// is "higher score, then lower doc id" -- the cascade's tie rule, which the
// TPU kernel gets from lax.top_k keeping the earliest index.  Keys are
// distinct, so the result does not depend on scheduling.  -0.0 is keyed as
// +0.0 (they compare equal as scores).  Ghost rows past n_docs get key 0,
// below every real key; the wrapper keeps k <= n_docs, so none surfaces.
//
// Exactness: the serving embeddings lie on the 1/64 grid with |x| <= 2, so
// every product and partial sum of a dot product is exact in fp32 and any
// summation order gives the plain version's score bit for bit.
//
// What bounds it on the card: bytes.  The call must read the (N, d) f32
// embeddings once; at Q = 32 and d = 32 the FMAs take less time than that.
// Blocks run query-fastest (blockIdx.x = query), so the Q blocks of one
// chunk run close together and all but the first read it through L2.  The
// sorts (about log2(chunk)^2 / 2 compare-exchange steps a block) and the
// scratch list are what this first version spends beyond the bound.

#include <cfloat>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

using sort_key = unsigned long long;

__device__ __forceinline__ sort_key make_key(float score, int doc) {
  unsigned int u = __float_as_uint(score == 0.0f ? 0.0f : score);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<sort_key>(u) << 32) |
         static_cast<sort_key>(0xFFFFFFFFu - static_cast<unsigned int>(doc));
}

__device__ __forceinline__ float key_score(sort_key key) {
  unsigned int u = static_cast<unsigned int>(key >> 32);
  u = (u & 0x80000000u) ? (u & 0x7FFFFFFFu) : ~u;
  return __uint_as_float(u);
}

__device__ __forceinline__ int64_t key_doc(sort_key key) {
  return static_cast<int64_t>(0xFFFFFFFFu -
                              static_cast<unsigned int>(key & 0xFFFFFFFFu));
}

// Sorts the n (a power of two) keys of `a` in shared memory, largest first.
__device__ void bitonic_sort_desc(sort_key* a, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < (n >> 1); t += blockDim.x) {
        const int lo = 2 * t - (t & (stride - 1));
        const int hi = lo + stride;
        const bool desc = (lo & size) == 0;
        const sort_key x = a[lo], y = a[hi];
        if ((x < y) == desc) {
          a[lo] = y;
          a[hi] = x;
        }
      }
      __syncthreads();
    }
  }
}

__global__ void dense_topk_chunks(const float4* __restrict__ q_emb,
                                  const float4* __restrict__ doc_emb,
                                  sort_key* __restrict__ part, int n_docs,
                                  int d4, int chunk, int n_chunks, int kp) {
  extern __shared__ __align__(16) sort_key smem_k[];
  sort_key* keys = smem_k;                                // chunk keys
  float4* q = reinterpret_cast<float4*>(smem_k + chunk);  // the query row
  const int qi = blockIdx.x;
  const int c = blockIdx.y;
  for (int j = threadIdx.x; j < d4; j += blockDim.x)
    q[j] = q_emb[static_cast<size_t>(qi) * d4 + j];
  __syncthreads();

  const int lo = c * chunk;
  for (int i = threadIdx.x; i < chunk; i += blockDim.x) {
    const int doc = lo + i;
    sort_key key = 0ull;  // ghost row: below every real key
    if (doc < n_docs) {
      const float4* row = doc_emb + static_cast<size_t>(doc) * d4;
      float s = 0.0f;
#pragma unroll 8
      for (int j = 0; j < d4; ++j) {
        const float4 e = row[j];
        const float4 w = q[j];
        s = fmaf(w.x, e.x, s);
        s = fmaf(w.y, e.y, s);
        s = fmaf(w.z, e.z, s);
        s = fmaf(w.w, e.w, s);
      }
      key = make_key(s, doc);
    }
    keys[i] = key;
  }
  __syncthreads();
  bitonic_sort_desc(keys, chunk);

  sort_key* out = part + (static_cast<size_t>(qi) * n_chunks + c) * kp;
  for (int i = threadIdx.x; i < kp; i += blockDim.x) out[i] = keys[i];
}

__global__ void dense_topk_merge(const sort_key* __restrict__ part,
                                 float* __restrict__ out_scores,
                                 int64_t* __restrict__ out_ids, int n_chunks,
                                 int kp, int log_kp, int k, int group) {
  // `group` lists of kp keys; list 0 is the running top-kp
  extern __shared__ __align__(16) sort_key buf[];
  const int qi = blockIdx.x;
  const sort_key* src = part + static_cast<size_t>(qi) * n_chunks * kp;
  const int half = kp >> 1;
  for (int i = threadIdx.x; i < kp; i += blockDim.x) buf[i] = 0ull;

  for (int c0 = 0; c0 < n_chunks; c0 += group - 1) {
    const int n_new = min(group - 1, n_chunks - c0) * kp;
    for (int i = threadIdx.x; i < (group - 1) * kp; i += blockDim.x)
      buf[kp + i] = i < n_new ? src[static_cast<size_t>(c0) * kp + i] : 0ull;
    __syncthreads();
    // tree of pairwise merges: list 2*span*p absorbs list 2*span*p + span
    for (int span = 1; span < group; span <<= 1) {
      const int pairs = group / (2 * span);
      for (int t = threadIdx.x; t < pairs * kp; t += blockDim.x) {
        const int p = t >> log_kp;
        const int i = t & (kp - 1);
        sort_key* a = buf + static_cast<size_t>(2 * span * p) * kp;
        const sort_key y = a[static_cast<size_t>(span) * kp + kp - 1 - i];
        if (a[i] < y) a[i] = y;
      }
      __syncthreads();
      for (int stride = half; stride > 0; stride >>= 1) {
        for (int t = threadIdx.x; t < pairs * half; t += blockDim.x) {
          const int p = t / half;
          const int u = t - p * half;
          sort_key* a = buf + static_cast<size_t>(2 * span * p) * kp;
          const int lo = 2 * u - (u & (stride - 1));
          const int hi = lo + stride;
          const sort_key x = a[lo], y = a[hi];
          if (x < y) {
            a[lo] = y;
            a[hi] = x;
          }
        }
        __syncthreads();
      }
    }
  }

  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    const sort_key key = buf[i];
    const size_t o = static_cast<size_t>(qi) * k + i;
    out_scores[o] = key ? key_score(key) : -FLT_MAX;
    out_ids[o] = key ? key_doc(key) : -1;
  }
}

}  // namespace

// Launches both passes on `stream`.  part is the (n_q, n_chunks, kp) int64
// scratch list; chunk and kp are powers of two with kp <= chunk <= 2048,
// and d4 = d / 4 (the wrapper pads d to a multiple of 4 and keeps both
// embedding arrays 16-byte aligned).  The caller checks the launch
// (C10_CUDA_KERNEL_LAUNCH_CHECK in binding.cpp).
void dense_topk_launch(const float* q_emb, const float* doc_emb,
                       int64_t* part, float* out_scores, int64_t* out_ids,
                       int n_q, int n_docs, int d4, int k, int kp, int chunk,
                       int n_chunks, cudaStream_t stream) {
  if (n_q == 0 || n_chunks == 0) return;
  sort_key* keys = reinterpret_cast<sort_key*>(part);
  const dim3 grid1(n_q, n_chunks);
  const size_t smem1 = sizeof(sort_key) * chunk + sizeof(float4) * d4;
  dense_topk_chunks<<<grid1, chunk / 2, smem1, stream>>>(
      reinterpret_cast<const float4*>(q_emb),
      reinterpret_cast<const float4*>(doc_emb), keys, n_docs, d4, chunk,
      n_chunks, kp);
  int log_kp = 0;
  while ((1 << log_kp) < kp) ++log_kp;
  int group = 4096 / kp;
  group = group < 2 ? 2 : (group > 64 ? 64 : group);
  const size_t smem2 = sizeof(sort_key) * group * kp;
  dense_topk_merge<<<n_q, 512, smem2, stream>>>(keys, out_scores, out_ids,
                                                n_chunks, kp, log_kp, k,
                                                group);
}
