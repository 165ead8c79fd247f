// Dense Stage-1 retrieval: the top-k of q_emb @ doc_emb^T per query.
//
// Replaces the Pallas kernel `dense_topk_tiles` (body `_dense_topk_kernel`)
// of repro/kernels/dense_topk/kernel.py.  The TPU kernel walks a
// (query, doc tile) grid in order and folds each tile into a running top-k
// held in an output block that every step of the row revisits.  A CUDA grid
// runs in no order, so the same function is computed in two passes:
//
//   1. dense_topk_keys, one block per (tile of kTileDocs docs, group of up
//      to kGroup queries): the tile's embeddings are staged in shared memory
//      once with cp.async (kDims dimensions at a time, rows padded so that
//      the lanes of a warp read consecutive rows without bank conflicts),
//      and every (query, doc) score of the tile is a sequential chain of
//      fp32 FMAs on the CUDA cores (no tensor cores, no TF32: ROADMAP rule
//      b).  A thread holds kQ x kD scores in registers (a warp's kQ queries,
//      the lane's kD docs), so that shared-memory reads, not FMAs, stay
//      below a quarter of the instructions: one doc a thread, reading every
//      query from shared memory, was bound by those reads (a first probe on
//      the card: 0.027 ms for the pass).  Each score's order-preserving
//      uint32 key goes to a (Q, N) scratch (the wrapper allocates it),
//      coalesced along the docs.
//   2. dense_topk_select, one cluster of topk_select::kCluster blocks per
//      query: the shared exact select of topk_select.cuh over the query's
//      row of keys (radix rounds for the k-th key, an ordered compaction,
//      a sort of the k selected words), ties to the lower doc id.  Block 0
//      decodes its sorted words to (score, id).
//
// Order and ties: the key maps a score to a uint32 whose unsigned order is
// the scores' order, with -0.0 keyed as +0.0 (they compare equal as
// scores); the select takes equal keys in index order, so "higher score,
// then lower doc id" -- the cascade's tie rule, which the TPU kernel gets
// from lax.top_k keeping the earliest index.  The result does not depend
// on scheduling.
//
// Exactness: the serving embeddings lie on the 1/64 grid with |x| <= 2, so
// every product and partial sum of a dot product is exact in fp32 and any
// summation order gives the plain version's score bit for bit.
//
// What bounds it on the card: bytes.  The function must read the (N, d)
// f32 embeddings once (25.2 MB at N = 196,608, d = 32); at Q = 32 the
// FMAs (0.2 G) take less time than that.  Pass 1 reads them from device
// memory once per query group and writes the Q x N keys (25.2 MB at
// Q = 32, within L2's 50 MB); pass 2 reads each query's keys kRounds + 1
// times (four radix rounds and the compaction), from L2.  A block's range
// (96 KB at N = 196,608) fits in shared memory, but staging it there left
// one block an SM, and on the card that ran slower than two blocks an SM
// reading L2 (a probe of both builds in one call).  The key write, the key
// passes, the cluster barriers between them and the sort are what this
// design spends beyond the bound.

#include <cstdint>

#include <cuda_runtime.h>

#include "../topk_select.cuh"

namespace {

namespace cg = cooperative_groups;
namespace ts = topk_select;

constexpr int kTileDocs = 256;   // docs a block of pass 1 scores
constexpr int kGroup = 32;       // queries a block of pass 1 scores
constexpr int kThreads1 = 256;   // a warp per 4 queries, a lane per 8 docs
constexpr int kQ = 4;            // queries a thread scores
constexpr int kD = 8;            // docs a thread scores: lane + 32 m
constexpr int kDims = 32;        // dimensions staged at a time
constexpr int kRow = kDims + 4;  // a staged row, padded (floats)

__device__ __forceinline__ unsigned make_key(float score) {
  const unsigned u = __float_as_uint(score == 0.0f ? 0.0f : score);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_score(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7FFFFFFFu) : ~key);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// A thread scores kQ queries x kD docs from registers: per 4 dimensions,
// kD row reads (lanes read consecutive padded rows: no bank conflicts) and
// kQ query reads (the warp's queries: broadcasts) feed kQ x kD x 4 FMAs.
__global__ void __launch_bounds__(kThreads1)
    dense_topk_keys(const float4* __restrict__ q_emb,
                    const float4* __restrict__ doc_emb,
                    unsigned* __restrict__ keys, int n_q, int n_docs,
                    int d4) {
  __shared__ __align__(16) float tile[kTileDocs * kRow];
  __shared__ float4 qs[kGroup * (kDims / 4)];
  const int t = threadIdx.x, lane = t & 31, qw = (t >> 5) * kQ;
  const int doc0 = blockIdx.x * kTileDocs;
  const int q0 = blockIdx.y * kGroup;
  const int nq = min(kGroup, n_q - q0);
  float acc[kQ][kD];
#pragma unroll
  for (int i = 0; i < kQ; ++i)
#pragma unroll
    for (int m = 0; m < kD; ++m) acc[i][m] = 0.0f;

  for (int c4 = 0; c4 < d4; c4 += kDims / 4) {
    const int w4 = min(kDims / 4, d4 - c4);
    for (int e = t; e < kTileDocs * w4; e += kThreads1) {
      const int r = e / w4, c = e - r * w4;
      float4* dst = reinterpret_cast<float4*>(tile + r * kRow) + c;
      const int doc = doc0 + r;
      if (doc < n_docs)
        cp_async16(dst, doc_emb + static_cast<size_t>(doc) * d4 + c4 + c);
      else
        *dst = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    for (int e = t; e < nq * w4; e += kThreads1) {
      const int qi = e / w4, c = e - qi * w4;
      qs[qi * (kDims / 4) + c] =
          q_emb[static_cast<size_t>(q0 + qi) * d4 + c4 + c];
    }
    asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();
    if (qw < nq) {
      for (int j = 0; j < w4; ++j) {
        float4 dv[kD], qv[kQ];
#pragma unroll
        for (int m = 0; m < kD; ++m)
          dv[m] = reinterpret_cast<const float4*>(
              tile + (lane + 32 * m) * kRow)[j];
#pragma unroll
        for (int i = 0; i < kQ; ++i) qv[i] = qs[(qw + i) * (kDims / 4) + j];
#pragma unroll
        for (int i = 0; i < kQ; ++i)
#pragma unroll
          for (int m = 0; m < kD; ++m) {
            float s = acc[i][m];
            s = fmaf(qv[i].x, dv[m].x, s);
            s = fmaf(qv[i].y, dv[m].y, s);
            s = fmaf(qv[i].z, dv[m].z, s);
            s = fmaf(qv[i].w, dv[m].w, s);
            acc[i][m] = s;
          }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kQ; ++i) {
    if (qw + i >= nq) break;
    unsigned* out = keys + static_cast<size_t>(q0 + qw + i) * n_docs;
#pragma unroll
    for (int m = 0; m < kD; ++m) {
      const int doc = doc0 + lane + 32 * m;
      if (doc < n_docs) out[doc] = make_key(acc[i][m]);
    }
  }
}

// A query's row of keys, read through the read-only path (pass 1 wrote it
// in an earlier launch); L2 holds it between the select's passes.
struct RowKeys {
  const unsigned* row;
  __device__ __forceinline__ unsigned operator()(int i) const {
    return __ldg(row + i);
  }
};

// Two blocks an SM (at most 64 registers a thread), so that twice as many
// clusters run at once as with one.
__global__ void __cluster_dims__(ts::kCluster, 1, 1)
    __launch_bounds__(ts::kThreads, 2)
    dense_topk_select(const unsigned* __restrict__ keys,
                      float* __restrict__ out_scores,
                      int64_t* __restrict__ out_ids, int n_docs, int k,
                      int kp) {
  __shared__ ts::Smem sm;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int q = blockIdx.y;
  const RowKeys row{keys + static_cast<size_t>(q) * n_docs};
  int lo, hi;
  ts::block_range(n_docs, rank, lo, hi);
  ts::init(sm);
  __syncthreads();
  ts::radix_kth(sm, cluster, row, lo, hi, k);
  ts::select(sm, cluster, row, lo, hi, k, kp);
  if (rank == 0) {
    for (int i = threadIdx.x; i < k; i += ts::kThreads) {
      const unsigned long long w = sm.sel[i];
      const size_t o = static_cast<size_t>(q) * k + i;
      out_scores[o] = key_score(static_cast<unsigned>(w >> 32));
      out_ids[o] = ts::word_index(w);
    }
  }
}

}  // namespace

// Launches both passes on `stream`; returns the launches' error (0 when
// both were taken).  keys is the (n_q, n_docs) uint32 scratch;
// 1 <= k <= min(n_docs, topk_select::kMaxK) and kp is k rounded up to a
// power of two; d4 = d / 4 (the wrapper pads d to a multiple of 4 and keeps
// both embedding arrays 16-byte aligned).  The caller checks the launches
// (binding.cpp).
int dense_topk_launch(const float* q_emb, const float* doc_emb, int* keys,
                      float* out_scores, int64_t* out_ids, int n_q,
                      int n_docs, int d4, int k, int kp,
                      cudaStream_t stream) {
  if (n_q == 0 || n_docs == 0) return 0;
  unsigned* ukeys = reinterpret_cast<unsigned*>(keys);
  const dim3 grid1((n_docs + kTileDocs - 1) / kTileDocs,
                   (n_q + kGroup - 1) / kGroup);
  dense_topk_keys<<<grid1, kThreads1, 0, stream>>>(
      reinterpret_cast<const float4*>(q_emb),
      reinterpret_cast<const float4*>(doc_emb), ukeys, n_q, n_docs, d4);
  const dim3 grid2(ts::kCluster, n_q);
  dense_topk_select<<<grid2, ts::kThreads, 0, stream>>>(
      ukeys, out_scores, out_ids, n_docs, k, kp);
  return static_cast<int>(cudaGetLastError());
}
