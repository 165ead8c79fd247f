// The exact top-k select shared by the dense top-k (dense_topk.cu, pass 2)
// and the fused histogram top-k (score_histogram.cu).
//
// One thread-block cluster of kCluster blocks selects the k largest of a
// row of n 32-bit keys, ties to the lower index, and leaves them sorted
// (key descending, index ascending) in the shared memory of the cluster's
// block 0.  The row's keys are read through a functor (`keys(i)`).  Block
// b owns the contiguous index range [b * per, (b + 1) * per),
// per = ceil(n / kCluster).
//
// 1. The k-th key K: radix rounds of kDigitBits bits, from the top.  In
//    round r every block histograms, in shared memory, the digit r of the
//    keys of its range that match the prefix of the digits chosen so far,
//    with integer atomics, each thread counting its hot digit in a
//    register (Counter).  After a cluster barrier every block sums the
//    kCluster histograms through distributed shared memory and takes the
//    same digit: the bin that holds the k_rem-th largest key.
//    A block's own count of keys above K is the sum, over the rounds, of
//    its bins above the chosen digit; its count of keys equal to K is its
//    last round's bin.  A caller that knows K and those counts (the
//    histogram top-k, mostly) skips the rounds.
// 2. The ordered compaction.  The blocks exchange their counts through
//    distributed shared memory.  Each block then walks its range in index
//    order, a chunk of kPer keys a thread at a time (coalesced: key e of a
//    thread is e * kThreads past the chunk's start), and places each key
//    from ballots within the warp and an exclusive scan of the chunk's
//    per-(key slot, warp) counts of keys above K and equal to K (a warp
//    with no key at or above K counts zeros without ballots).  Every key
//    above K is taken (fewer than k in all), at its block's offset;
//    keys equal to K are taken in index order while their rank over the
//    whole row (the blocks before this one first) is below k minus the
//    count above.  The block stops once it has placed all it may.  Each
//    selected (key, index) goes to block 0's shared memory as one 64-bit
//    word, (key << 32) | ~index, so that "larger word" is "higher key,
//    then lower index".
// 3. Block 0 sorts the k words: up to kRankSort by rank (each word counts
//    the larger ones: one pass, no barrier between steps), more with a
//    bitonic network over kp, k rounded up to a power of two (the pad is 0,
//    below every selected word).
//
// Exactness: only integer atomics on counters (no float atomics, ROADMAP
// rule d); every position a key is written to follows from counts and
// ranks, not from the order in which blocks or warps run (rule c); any
// number of keys equal to K is handled by the same compaction.  k <= kMaxK
// and k <= n; the caller checks both.

#pragma once

#include <cooperative_groups.h>
#include <cstdint>

namespace topk_select {

namespace cg = cooperative_groups;

constexpr int kCluster = 8;        // blocks of a cluster (the portable limit)
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kDigitBits = 8;
constexpr int kDigits = 1 << kDigitBits;
constexpr int kRounds = 32 / kDigitBits;
constexpr int kMaxK = 2048;
constexpr int kPer = 16;           // keys a thread compacts in a chunk
constexpr int kChunk = kPer * kThreads;
constexpr int kUnroll = 16;        // loads in flight a thread, histograms
constexpr unsigned kFull = 0xffffffffu;
static_assert(kPer * kWarps <= kThreads, "a chunk's counts: one a thread");
constexpr int kRankSort = 256;     // selections sorted by rank, one a thread
static_assert(kRankSort <= kThreads, "the rank sort: one word a thread");

struct Smem {
  unsigned hist[kRounds][kDigits];   // this block's digit histograms
  unsigned long long sel[kMaxK];     // block 0: the selection
  int scan[kWarps];
  int wtot[2][kPer * kWarps];        // a chunk's (warp, key slot) counts
  int digit[kRounds];
  unsigned kth;                      // the k-th key
  int counts[2];                     // this block: keys above K, equal to K
  int base[3];                       // above offset, equal offset, equal take
  int k_rem;                         // the rank of K among the prefix's keys
};

// [lo, hi): the index range of cluster block `rank` over n keys.
__device__ __forceinline__ void block_range(int n, int rank, int& lo,
                                            int& hi) {
  const int per = (n + kCluster - 1) / kCluster;
  lo = min(n, rank * per);
  hi = min(n, lo + per);
}

// Zeroes the digit histograms; the caller synchronises before use.
__device__ __forceinline__ void init(Smem& sm) {
  for (int i = threadIdx.x; i < kRounds * kDigits; i += kThreads)
    (&sm.hist[0][0])[i] = 0u;
}

// Histogram updates of one thread: add(bin, live) adds one to `bin` when
// `live`.  Keys crowd into a few bins (the top digits of float keys, the
// zeros of an accumulator), and atomics of many threads on one
// shared-memory word queue behind each other, so each thread keeps the
// count of its hot bin (the first bin it meets) in a register and adds the
// others with atomics.  flush(), which all 32 lanes of a warp call, adds
// the hot counts, those of the lanes that share lane 0's hot bin together.
struct Counter {
  unsigned* hist;
  unsigned hot = kFull;
  unsigned n_hot = 0u;

  __device__ __forceinline__ void add(unsigned bin, bool live) {
    if (!live) return;
    if (hot == kFull) hot = bin;
    if (bin == hot)
      ++n_hot;
    else
      atomicAdd(&hist[bin], 1u);
  }

  __device__ __forceinline__ void flush() {
    const unsigned b0 = __shfl_sync(kFull, hot, 0);
    const bool same = hot == b0;
    const unsigned n = __reduce_add_sync(kFull, same ? n_hot : 0u);
    if ((threadIdx.x & 31) == 0 && n != 0u) atomicAdd(&hist[b0], n);
    if (!same && n_hot != 0u) atomicAdd(&hist[hot], n_hot);
  }
};

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// The sum of `v` over the block; every thread gets it.
__device__ __forceinline__ int block_sum(Smem& sm, int v) {
  v = warp_sum(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) sm.scan[threadIdx.x >> 5] = v;
  __syncthreads();
  int s = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += sm.scan[w];
  return s;
}

// Exclusive prefix sum of `v` over the block in thread order; `total` gets
// the block's sum.
__device__ __forceinline__ int block_exclusive_scan(Smem& sm, int v,
                                                    int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x += y;
  }
  __syncthreads();
  if (lane == 31) sm.scan[warp] = x;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int s = sm.scan[w];
    before += w < warp ? s : 0;
    total += s;
  }
  return before + x - v;
}

// Step 1: sets sm.kth and sm.counts.  Every thread of every block of the
// cluster calls it; sm.hist must be zeroed and synchronised.
template <class Keys>
__device__ void radix_kth(Smem& sm, cg::cluster_group& cluster,
                          const Keys& keys, int lo, int hi, int k) {
  const int tid = threadIdx.x;
  unsigned prefix = 0u;
  int k_rem = k;
  for (int r = 0; r < kRounds; ++r) {
    const int shift = 32 - kDigitBits * (r + 1);
    const unsigned above_mask = r == 0 ? 0u : kFull << (shift + kDigitBits);
    unsigned* h = sm.hist[r];
    Counter c{h};
    for (int base = lo; base < hi; base += kThreads * kUnroll) {
      // unconditional loads (the index clamped into the range; the lanes
      // past it are masked below), so that all are in flight at once
      unsigned key[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        key[u] = keys(min(base + u * kThreads + tid, hi - 1));
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = base + u * kThreads + tid;
        c.add((key[u] >> shift) & (kDigits - 1),
              i < hi && ((key[u] ^ prefix) & above_mask) == 0u);
      }
    }
    c.flush();
    cluster.sync();
    // the cluster's bin `tid`, and the count at or above it (a suffix sum
    // over the kDigits bins, which threads 0 .. kDigits - 1 hold)
    unsigned tot = 0u;
    if (tid < kDigits)
      for (int b = 0; b < kCluster; ++b)
        tot += *cluster.map_shared_rank(&h[tid], b);
    unsigned ge = tot;
    const int lane = tid & 31;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned y = __shfl_down_sync(kFull, ge, off);
      if (lane + off < 32) ge += y;
    }
    if (lane == 0 && tid < kDigits) sm.scan[tid >> 5] = static_cast<int>(ge);
    __syncthreads();
    if (tid < kDigits) {
      for (int w = (tid >> 5) + 1; w < kDigits / 32; ++w)
        ge += static_cast<unsigned>(sm.scan[w]);
      const unsigned above = ge - tot;
      if (above < static_cast<unsigned>(k_rem)
          && ge >= static_cast<unsigned>(k_rem)) {
        sm.digit[r] = tid;
        sm.k_rem = k_rem - static_cast<int>(above);
      }
    }
    __syncthreads();
    prefix |= static_cast<unsigned>(sm.digit[r]) << shift;
    k_rem = sm.k_rem;
  }
  int above = 0;
  if (tid < kDigits)
#pragma unroll
    for (int r = 0; r < kRounds; ++r)
      above += tid > sm.digit[r] ? static_cast<int>(sm.hist[r][tid]) : 0;
  above = block_sum(sm, above);
  if (tid == 0) {
    sm.kth = prefix;
    sm.counts[0] = above;
    sm.counts[1] =
        static_cast<int>(sm.hist[kRounds - 1][sm.digit[kRounds - 1]]);
  }
  __syncthreads();
}

// Sorts the n (a power of two) words of `a` in shared memory, largest first.
__device__ __forceinline__ void bitonic_sort_desc(unsigned long long* a,
                                                  int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < (n >> 1); t += kThreads) {
        const int lo = 2 * t - (t & (stride - 1));
        const int hi = lo + stride;
        const bool desc = (lo & size) == 0;
        const unsigned long long x = a[lo], y = a[hi];
        if ((x < y) == desc) {
          a[lo] = y;
          a[hi] = x;
        }
      }
      __syncthreads();
    }
  }
}

// Sorts the k distinct words of `a` in shared memory, largest first: up to
// kRankSort words by rank (one pass, each word counts the larger ones),
// more with a bitonic network over kp (a[k, kp) hold 0).
__device__ __forceinline__ void sort_desc(unsigned long long* a, int k,
                                          int kp) {
  if (kp > kRankSort) {
    bitonic_sort_desc(a, kp);
    return;
  }
  const int tid = threadIdx.x;
  unsigned long long w = 0ull;
  int r = 0;
  if (tid < k) {
    w = a[tid];
    for (int j = 0; j < k; ++j) r += a[j] > w;
  }
  __syncthreads();
  if (tid < k) a[r] = w;
  __syncthreads();
}

// Steps 2 and 3, after sm.kth and sm.counts are set: block 0's sm.sel[0, k)
// holds the selection, sorted, when it returns.  Every thread of every block
// calls it.
template <class Keys>
__device__ void select(Smem& sm, cg::cluster_group& cluster,
                       const Keys& keys, int lo, int hi, int k, int kp) {
  const int tid = threadIdx.x;
  const int rank = static_cast<int>(cluster.block_rank());
  if (rank == 0)
    for (int i = k + tid; i < kp; i += kThreads) sm.sel[i] = 0ull;
  cluster.sync();
  if (tid < 32) {
    int a = 0, e = 0;
    if (tid < kCluster) {
      const int* c = cluster.map_shared_rank(sm.counts, tid);
      a = c[0];
      e = c[1];
    }
    const int a_before = warp_sum(tid < rank ? a : 0);
    const int e_before = warp_sum(tid < rank ? e : 0);
    const int a_total = warp_sum(a);
    if (tid == 0) {
      sm.base[0] = a_before;
      sm.base[1] = a_total + e_before;
      sm.base[2] = max(0, min(sm.counts[1], k - a_total - e_before));
    }
  }
  __syncthreads();
  const unsigned kth = sm.kth;
  const int n_above = sm.counts[0];
  const int n_take = sm.base[2];
  int pos_a = sm.base[0];
  const int pos_e = sm.base[1];
  unsigned long long* out = cluster.map_shared_rank(sm.sel, 0);
  int placed_a = 0, seen_e = 0;
  const int lane = tid & 31, warp = tid >> 5;
  const unsigned lower = (1u << lane) - 1u;
  for (int base = lo, c = 0;
       base < hi && (placed_a < n_above || seen_e < n_take);
       base += kChunk, c ^= 1) {
    // key e of a thread is index base + e * kThreads + tid: coalesced loads;
    // index order is (e, warp, lane) order
    unsigned key[kPer];
#pragma unroll
    for (int e = 0; e < kPer; ++e)
      key[e] = keys(min(base + e * kThreads + tid, hi - 1));
    int* wt = sm.wtot[c];
    // most warps hold no key at or above K: they count zeros at once
    bool flagged = false;
#pragma unroll
    for (int e = 0; e < kPer; ++e)
      flagged |= base + e * kThreads + tid < hi && key[e] >= kth;
    const bool any = __any_sync(kFull, flagged);
    if (any) {
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        const bool in = base + e * kThreads + tid < hi;
        const int na = __popc(__ballot_sync(kFull, in && key[e] > kth));
        const int ne = __popc(__ballot_sync(kFull, in && key[e] == kth));
        if (lane == 0) wt[e * kWarps + warp] = (na << 16) | ne;
      }
    } else if (lane < kPer) {
      wt[lane * kWarps + warp] = 0;
    }
    __syncthreads();
    // exclusive prefix of the (e, warp) counts, above << 16 | equal
    int total = 0;
    {
      const int v = tid < kPer * kWarps ? wt[tid] : 0;
      int x = v;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(kFull, x, off);
        if (lane >= off) x += y;
      }
      if (lane == 31) sm.scan[warp] = x;
      __syncthreads();
      int before = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int s = sm.scan[w];
        before += w < warp ? s : 0;
        total += s;
      }
      if (tid < kPer * kWarps) wt[tid] = before + x - v;
      __syncthreads();
    }
#pragma unroll
    for (int e = 0; e < kPer && any; ++e) {
      const int i = base + e * kThreads + tid;
      const bool in = i < hi;
      const unsigned ba = __ballot_sync(kFull, in && key[e] > kth);
      const unsigned be = __ballot_sync(kFull, in && key[e] == kth);
      if (((ba | be) >> lane & 1u) == 0u) continue;
      const int off = wt[e * kWarps + warp];
      const unsigned long long w =
          (static_cast<unsigned long long>(key[e]) << 32)
          | (0xffffffffu - static_cast<unsigned>(i));
      if (key[e] > kth) {
        out[pos_a + (off >> 16) + __popc(ba & lower)] = w;
      } else {
        const int re = seen_e + (off & 0xffff) + __popc(be & lower);
        if (re < n_take) out[pos_e + re] = w;
      }
    }
    pos_a += total >> 16;
    placed_a += total >> 16;
    seen_e += total & 0xffff;
  }
  cluster.sync();
  if (rank == 0) sort_desc(sm.sel, k, kp);
}

// The index of a selected word.
__device__ __forceinline__ int word_index(unsigned long long w) {
  return static_cast<int>(0xffffffffu - static_cast<unsigned>(w));
}

}  // namespace topk_select
