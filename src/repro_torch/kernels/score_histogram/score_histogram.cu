// Histogram of integer (quantized) scores, fused with the exact histogram
// top-k that it serves.
//
// Replaces the Pallas kernel `score_histogram` (body `_hist_kernel`) of
// repro/kernels/score_histogram/kernel.py: counts of the (N,) int32 scores
// per bin, negative scores ignored and scores >= n_bins counted in bin
// n_bins - 1, into an (n_bins,) int32 output.  The reference's
// `histogram_topk` (repro/kernels/score_histogram/ops.py) follows it with a
// scan for the threshold t (the largest bin with at least k scores at or
// above it, 0 when fewer than k scores are >= 0) and a top-k of the keys
// score + n_bins above t, t at t, 0 below: the exact top-k, ties to the
// lower index.  Here one launch does all of it.
//
// The TPU kernel adds each grid step's one-hot-matmul histogram into one
// output block that every step revisits, which relies on the TPU running
// its grid in order.  Here one thread-block cluster of
// topk_select::kCluster blocks serves the call:
//
// 1. Each block histograms its contiguous range of the scores in shared
//    memory with integer atomics, each thread counting its hot bin in a
//    register (topk_select::Counter: a JASS accumulator is mostly zeros),
//    and, when the range fits, keeps the scores it reads in shared memory
//    for the select.
// 2. After a cluster barrier, block b sums the cluster's counts of its
//    share of the bins through distributed shared memory and writes them:
//    the histogram output, every bin written once (no zeroed output, no
//    atomics on it).
// 3. With k > 0, every block finds t the same way: the shares' sums, then
//    a suffix scan of the one share that holds t, a few bins a thread.
//    Below the last bin, the histogram already gives the k-th key (t) and
//    each block's counts of keys above it (scores above t) and equal to it
//    (scores equal to t; at t = 0, every score <= 0, negatives included,
//    so they tie with the zeros and go by index, as in the reference); the
//    select's radix rounds run only at t = n_bins - 1, where clipped
//    scores hide how many lie above t.
// 4. The shared select of topk_select.cuh over the keys (formed from the
//    scores on the fly): the ordered compaction and the sort, in block 0,
//    which writes (scores[i], i) of the k selected in order.
//
// Exactness: integer counts, integer atomics only; every output position
// follows from counts and ranks, not from the blocks' order (ROADMAP
// rules c and d).  The histogram and the selection are the plain version's
// exactly (ops.py).
//
// What bounds it on the card: bytes, 4 B a score read once (0.79 MB for a
// 196,608-doc accumulator, a quarter of a microsecond at 3.35 TB/s), far
// below one launch.  The scores are read from device memory once, by the
// kCluster SMs of one cluster, and a second time from shared memory (from
// device memory past kStageBytes); the per-score work of the two passes on
// those few SMs, the cluster barriers and the sort are the rest.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "../topk_select.cuh"

namespace {

namespace cg = cooperative_groups;
namespace ts = topk_select;

// A block's range of the scores up to kStageBytes (with its bins) stays in
// its shared memory for the select's pass.
constexpr long long kStageBytes = 160 * 1024;

// The scores: in global memory, or a block's range of them staged in
// shared memory.
struct GlobalScores {
  const int* scores;
  __device__ __forceinline__ int operator()(int i) const {
    return __ldg(scores + i);
  }
};

struct StagedScores {
  const int* stage;
  int lo;
  __device__ __forceinline__ int operator()(int i) const {
    return stage[i - lo];
  }
};

// The key of the score at index i: above the threshold t, score + n_bins;
// at t, t; below it (negatives included), 0.
template <class Scores>
struct ScoreKeys {
  Scores scores;
  int t;
  unsigned n_bins;
  __device__ __forceinline__ unsigned operator()(int i) const {
    const int s = scores(i);
    return s > t ? static_cast<unsigned>(s) + n_bins
                 : (s == t ? static_cast<unsigned>(t) : 0u);
  }
};

// The kernel's body: `src` reads the scores for the select; with `staged`
// (the block's range in shared memory), the histogram pass writes each
// score there as it reads it from device memory.
template <class Scores>
__device__ void histogram_topk(const Scores& src, int* staged,
                               const int* __restrict__ scores,
                               int* __restrict__ hist_out,
                               int* __restrict__ values, int* __restrict__ idx,
                               int* bins, int n_bins, int k, int kp, int lo,
                               int hi, ts::Smem& sm, int& share_sum,
                               int& thresh, cg::cluster_group& cluster) {
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int share = (n_bins + ts::kCluster - 1) / ts::kCluster;
  int* tot = bins + n_bins;

  // 1. this block's histogram
  ts::Counter counter{reinterpret_cast<unsigned*>(bins)};
  for (int base = lo; base < hi; base += ts::kThreads * ts::kUnroll) {
    int s[ts::kUnroll];
#pragma unroll
    for (int u = 0; u < ts::kUnroll; ++u)
      s[u] = __ldg(scores + min(base + u * ts::kThreads + tid, hi - 1));
#pragma unroll
    for (int u = 0; u < ts::kUnroll; ++u) {
      const int i = base + u * ts::kThreads + tid;
      if (staged != nullptr && i < hi) staged[i - lo] = s[u];
      counter.add(static_cast<unsigned>(min(s[u], n_bins - 1)),
                  i < hi && s[u] >= 0);
    }
  }
  counter.flush();
  cluster.sync();

  // 2. the cluster's counts of this block's share of the bins
  const int s0 = min(n_bins, rank * share), s1 = min(n_bins, s0 + share);
  int part = 0;
  for (int j = s0 + tid; j < s1; j += ts::kThreads) {
    int c = 0;
    for (int b = 0; b < ts::kCluster; ++b)
      c += *cluster.map_shared_rank(&bins[j], b);
    tot[j - s0] = c;
    hist_out[j] = c;
    part += c;
  }
  part = ts::block_sum(sm, part);
  if (tid == 0) share_sum = part;
  cluster.sync();
  if (k == 0) return;

  // 3. the threshold t: the shares' suffix sums (warp 0), then a suffix
  // scan of the share that holds t, a few bins a thread
  if (tid < 32) {
    int g = tid < ts::kCluster ? *cluster.map_shared_rank(&share_sum, tid)
                               : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_down_sync(ts::kFull, g, off);
      if (tid + off < 32) g += y;
    }
    // g: the count of scores in shares >= tid (0 past the last share)
    const unsigned ok =
        __ballot_sync(ts::kFull, tid < ts::kCluster && g >= k);
    const int bs = ok != 0u ? 31 - __clz(ok) : -1;  // the last with >= k
    const int g_next = __shfl_sync(ts::kFull, g, bs + 1);
    if (tid == 0) {
      sm.base[0] = bs;
      sm.base[1] = g_next;   // scores in the shares above it
      thresh = -1;
    }
  }
  __syncthreads();
  const int bs = sm.base[0];
  if (bs >= 0) {
    const int* tb = cluster.map_shared_rank(tot, bs);
    const int len = min(share, n_bins - bs * share);
    const int per = (len + ts::kThreads - 1) / ts::kThreads;
    const int j0 = min(len, tid * per), j1 = min(len, j0 + per);
    int mine = 0;
    for (int j = j0; j < j1; ++j) mine += tb[j];
    int total;
    const int before = ts::block_exclusive_scan(sm, mine, total);
    // walk this thread's bins down from the top: ge(j) = scores >= bin j
    int ge = sm.base[1] + total - before - mine;
    for (int j = j1 - 1; j >= j0; --j) {
      ge += tb[j];
      if (ge >= k) {
        atomicMax(&thresh, bs * share + j);
        break;
      }
    }
  }
  __syncthreads();
  const int t = max(thresh, 0);
  const ScoreKeys<Scores> keys{src, t, static_cast<unsigned>(n_bins)};
  if (t < n_bins - 1) {
    // K = t; this block's counts from its histogram
    int above = 0, positive = 0;
    for (int j = tid; j < n_bins; j += ts::kThreads) {
      above += j > t ? bins[j] : 0;
      positive += j >= 1 ? bins[j] : 0;
    }
    above = ts::block_sum(sm, above);
    positive = ts::block_sum(sm, positive);
    if (tid == 0) {
      sm.kth = static_cast<unsigned>(t);
      sm.counts[0] = above;
      sm.counts[1] = t > 0 ? bins[t] : (hi - lo) - positive;
    }
    __syncthreads();
  } else {
    ts::radix_kth(sm, cluster, keys, lo, hi, k);
  }

  // 4. the select
  ts::select(sm, cluster, keys, lo, hi, k, kp);
  if (rank == 0) {
    for (int i = tid; i < k; i += ts::kThreads) {
      const int j = ts::word_index(sm.sel[i]);
      idx[i] = j;
      values[i] = scores[j];
    }
  }
}

// Dynamic shared memory: this block's n_bins counts, its share of the
// cluster's counts and, with kStaged, its range of the scores.
template <bool kStaged>
__global__ void __cluster_dims__(ts::kCluster, 1, 1)
    __launch_bounds__(ts::kThreads)
    histogram_topk_kernel(const int* __restrict__ scores,
                          int* __restrict__ hist_out,
                          int* __restrict__ values, int* __restrict__ idx,
                          int n, int n_bins, int k, int kp) {
  extern __shared__ int dyn[];
  __shared__ ts::Smem sm;
  __shared__ int share_sum, thresh;
  cg::cluster_group cluster = cg::this_cluster();
  const int share = (n_bins + ts::kCluster - 1) / ts::kCluster;
  int lo, hi;
  ts::block_range(n, static_cast<int>(cluster.block_rank()), lo, hi);
  for (int j = threadIdx.x; j < n_bins; j += ts::kThreads) dyn[j] = 0;
  ts::init(sm);
  __syncthreads();
  if constexpr (kStaged) {
    int* staged = dyn + n_bins + share;
    histogram_topk(StagedScores{staged, lo}, staged, scores, hist_out, values,
                   idx, dyn, n_bins, k, kp, lo, hi, sm, share_sum, thresh,
                   cluster);
  } else {
    histogram_topk(GlobalScores{scores}, nullptr, scores, hist_out, values,
                   idx, dyn, n_bins, k, kp, lo, hi, sm, share_sum, thresh,
                   cluster);
  }
}

}  // namespace

// Launches one cluster on `stream` and returns the launch's error (0 when
// it was taken): the (n_bins,) histogram into `hist` and, for k > 0, the
// top-k (values and indices, (k,) each; kp is k rounded up to a power of
// two) into `values` and `idx`.  1 <= k <= min(n, topk_select::kMaxK) or
// k = 0; n_bins >= 1.  The caller checks the launch (binding.cpp).
int histogram_topk_launch(const int* scores, int* hist, int* values,
                          int* idx, int n, int n_bins, int k, int kp,
                          cudaStream_t stream) {
  const int share = (n_bins + ts::kCluster - 1) / ts::kCluster;
  const int bins = 4 * (n_bins + share);
  const long long staged =
      bins + 4LL * ((n + ts::kCluster - 1) / ts::kCluster);
  if (staged <= kStageBytes) {
    cudaFuncSetAttribute(histogram_topk_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(staged));
    histogram_topk_kernel<true>
        <<<ts::kCluster, ts::kThreads, static_cast<int>(staged), stream>>>(
            scores, hist, values, idx, n, n_bins, k, kp);
  } else {
    cudaFuncSetAttribute(histogram_topk_kernel<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, bins);
    histogram_topk_kernel<false><<<ts::kCluster, ts::kThreads, bins, stream>>>(
        scores, hist, values, idx, n, n_bins, k, kp);
  }
  return static_cast<int>(cudaGetLastError());
}
