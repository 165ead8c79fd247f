// Stage-2 query-document feature gather over compacted posting lanes.
//
// Replaces the Pallas kernel `qd_feature_gather_lanes` (body
// `_qd_gather_kernel`) of repro/kernels/qd_feature_gather/kernel.py.  Per
// (query q, candidate c) it returns the sum of the scores, the largest
// score and the count of the query's posting lanes whose doc equals the
// candidate: (Q, C) f32, f32, int32.  -1 lanes and -1 candidates never
// match; the max starts at 0.0f, as the TPU kernel's does; the sum is
// taken in lane order from 0.0f, the order of the plain version (ops.py)
// and of the reference's term-by-term sum, bit for bit.
//
// What bounds it on the card: bytes.  The function needs each lane's doc
// read once (4 B), the score of only the lanes that match a candidate,
// the candidates read and the outputs written once; one lookup per live
// lane and one add per match.  The TPU design compares every lane with
// every candidate (P x C compares; 57 M at the main path's largest call).
// A lane matches at most a few of a batch's 128 candidates, so here a
// lane costs one probe of a candidate table instead.
//
// The design: one cluster of kCluster blocks per (query, group of up to
// kCandGroup candidate columns); blockIdx.x is the block's rank in the
// cluster, blockIdx.y the query, blockIdx.z the column group.  At Q = 32
// that is 256 blocks on the card's 132 SMs.
//
// 1. Every block builds the same candidate table in shared memory: an
//    open-addressing hash of the group's docs (4x as many entries as
//    columns), each entry holding its doc and its owner, the lowest column
//    that holds the doc, behind a 64 Kbit filter of the docs.  Duplicate
//    columns share their owner; -1 columns are not inserted, so they
//    match nothing.
// 2. The lanes are cut into chunks of kChunk (4 a thread), and block r
//    walks chunks r, r + kCluster, ...: the live lanes are a prefix of
//    the row (a query's postings, then a dead tail; 15 % live at the main
//    path's largest call), and contiguous segments left one or two blocks
//    of each cluster with all the probes.  A thread loads 4 lanes of
//    each of kUnroll chunks (coalesced 4-byte loads, all in flight)
//    before it probes them.  A live lane that passes the filter probes
//    the table; on a hit it takes the next of the owner's kRecords record
//    slots with a shared-memory int atomic and writes its lane position
//    and score there.  The owner's count goes on past kRecords.
// 3. cluster.sync(); then each column is reduced by one warp, the columns
//    spread over the cluster's warps.  The warp reads the owner's count in
//    every block of the cluster (distributed shared memory).  If no block
//    overflowed its records and the total is at most 32, each lane takes
//    one record; its rank is the number of records at a lower lane
//    position, and the warp adds the scores in rank order from 0.0f: lane
//    order.  Otherwise (any number of matches: a repeated query term
//    repeats lanes) the warp rescans all the query's lanes from device
//    memory, 32 a step, and adds each step's matches in lane order.  Both
//    paths give the same bits.  The max (from 0.0f) and the count do not
//    depend on the order.
// 4. cluster.sync() again, so no block leaves while its records are read.
//
// No float atomics (ROADMAP rule d): the only atomics are integer slot
// counters; records are written once and read after the cluster barrier.
// The TPU kernel revisits one output block across a sequential grid of
// lane tiles; a CUDA grid runs in no order, so here every output is
// written once, after the cluster has seen all the lanes.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;       // blocks of a cluster: lane segments
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCandGroup = 128;   // candidate columns of a cluster
constexpr int kTableBits = 9;     // 512 entries for 128 columns
constexpr int kTable = 1 << kTableBits;
constexpr int kRecords = 16;      // match records of an owner in a block
constexpr int kChunk = 4 * kThreads;  // lanes of a chunk: 4 a thread
constexpr int kUnroll = 4;        // chunks of a block in flight
constexpr int kFilterWords = 2048;  // the 64 Kbit doc filter
constexpr int kEmpty = -1;
constexpr unsigned kFull = 0xffffffffu;

struct Smem {
  int keys[kTable];                // doc, or kEmpty
  int owner[kTable];               // the lowest column holding the doc
  int count[kCandGroup];           // matches of each owner in this segment
  int rec_lane[kCandGroup * kRecords];
  float rec_score[kCandGroup * kRecords];
  unsigned filt[kFilterWords];     // bit (doc & 65535): some column's doc
};

__device__ __forceinline__ unsigned hash_doc(int doc) {
  return (static_cast<unsigned>(doc) * 2654435761u) >> (32 - kTableBits);
}

// The entry of `doc` (>= 0), claimed if the doc is not in the table yet.
__device__ __forceinline__ int insert(int* keys, int doc) {
  for (unsigned h = hash_doc(doc);; h = (h + 1u) & (kTable - 1u)) {
    const int prev = atomicCAS(&keys[h], kEmpty, doc);
    if (prev == kEmpty || prev == doc) return static_cast<int>(h);
  }
}

// The entry of `doc` (>= 0), or -1 when no column holds it.
__device__ __forceinline__ int find(const int* keys, int doc) {
  for (unsigned h = hash_doc(doc);; h = (h + 1u) & (kTable - 1u)) {
    const int k = keys[h];
    if (k == doc) return static_cast<int>(h);
    if (k == kEmpty) return -1;
  }
}

// Lane j with doc `doc`: on a table hit, the next record of its owner.
// The filter rejects almost every lane of a query with one word's test.
__device__ __forceinline__ void probe(Smem& sm, int doc, int j,
                                      const float* __restrict__ scores) {
  if (doc < 0
      || !((sm.filt[(doc >> 5) & (kFilterWords - 1)] >> (doc & 31)) & 1u))
    return;
  const int e = find(sm.keys, doc);
  if (e < 0) return;
  const int o = sm.owner[e];
  const int slot = atomicAdd(&sm.count[o], 1);
  if (slot < kRecords) {
    sm.rec_lane[o * kRecords + slot] = j;
    sm.rec_score[o * kRecords + slot] = scores[j];
  }
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
    qd_feature_gather_kernel(const int* __restrict__ lane_docs,
                             const float* __restrict__ lane_scores,
                             const int* __restrict__ cand,
                             float* __restrict__ bm25, float* __restrict__ mx,
                             int* __restrict__ cnt, int n_lanes, int n_cand) {
  __shared__ Smem sm;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int q = blockIdx.y;
  const int c0 = blockIdx.z * kCandGroup;
  const int nc = min(kCandGroup, n_cand - c0);
  const int* cq = cand + static_cast<size_t>(q) * n_cand + c0;
  const int* docs = lane_docs + static_cast<size_t>(q) * n_lanes;
  const float* scores = lane_scores + static_cast<size_t>(q) * n_lanes;

  for (int i = threadIdx.x; i < kTable; i += kThreads) {
    sm.keys[i] = kEmpty;
    sm.owner[i] = kCandGroup;
  }
  for (int i = threadIdx.x; i < kCandGroup; i += kThreads) sm.count[i] = 0;
  for (int i = threadIdx.x; i < kFilterWords; i += kThreads) sm.filt[i] = 0u;
  __syncthreads();
  // 1. the candidate table and its filter
  for (int c = threadIdx.x; c < nc; c += kThreads) {
    const int doc = cq[c];
    if (doc < 0) continue;
    atomicMin(&sm.owner[insert(sm.keys, doc)], c);
    atomicOr(&sm.filt[(doc >> 5) & (kFilterWords - 1)], 1u << (doc & 31));
  }
  __syncthreads();

  // 2. this block's chunks, k = rank, rank + kCluster, ...: one probe a
  // live lane, a record a match
  for (int k = rank; k * kChunk < n_lanes; k += kCluster * kUnroll) {
    int d[kUnroll][4];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = (k + kCluster * u) * kChunk + i * kThreads + threadIdx.x;
        d[u][i] = j < n_lanes ? docs[j] : kEmpty;
      }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        probe(sm, d[u][i],
              (k + kCluster * u) * kChunk + i * kThreads + threadIdx.x,
              scores);
  }
  cluster.sync();

  // 3. one warp per column, in lane order
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int c = rank + kCluster * warp; c < nc; c += kCluster * kWarps) {
    const int doc = cq[c];
    float acc = 0.0f, best = 0.0f;
    int n = 0;
    if (doc >= 0) {
      const int o = sm.owner[find(sm.keys, doc)];
      // lane b < kCluster: the owner's count in block b
      const int nb = lane < kCluster
          ? *cluster.map_shared_rank(&sm.count[o], lane) : 0;
      const bool fits = nb <= kRecords;
      int start = nb;  // inclusive prefix over the blocks, then exclusive
#pragma unroll
      for (int s = 1; s < kCluster; s <<= 1) {
        const int v = __shfl_up_sync(kFull, start, s);
        if (lane >= s) start += v;
      }
      n = __shfl_sync(kFull, start, kCluster - 1);
      start -= nb;
      if (__all_sync(kFull, fits) && n <= 32) {
        // lane f < n takes record f: the last block b with start[b] <= f,
        // slot f - start[b]
        int b = 0;
        for (int k = 1; k < kCluster; ++k)
          if (__shfl_sync(kFull, start, k) <= lane) b = k;
        const int slot = lane - __shfl_sync(kFull, start, b);
        int pos = 0x7fffffff;
        float sc = 0.0f;
        if (lane < n) {
          pos = *cluster.map_shared_rank(&sm.rec_lane[o * kRecords + slot],
                                         b);
          sc = *cluster.map_shared_rank(&sm.rec_score[o * kRecords + slot],
                                        b);
        }
        int rk = 0;  // records at a lower lane position
        for (int k = 0; k < n; ++k) rk += __shfl_sync(kFull, pos, k) < pos;
        for (int r = 0; r < n; ++r) {
          const int src = __ffs(__ballot_sync(kFull, lane < n && rk == r)) - 1;
          const float v = __shfl_sync(kFull, sc, src);
          acc += v;
          best = fmaxf(best, v);
        }
      } else {
        // overflow: rescan the query's lanes, each step's matches in order
        n = 0;
        for (int base = 0; base < n_lanes; base += 32) {
          const int j = base + lane;
          const bool hit = j < n_lanes && docs[j] == doc;
          unsigned m = __ballot_sync(kFull, hit);
          const float sc = hit ? scores[j] : 0.0f;
          n += __popc(m);
          for (; m != 0u; m &= m - 1u) {
            const float v = __shfl_sync(kFull, sc, __ffs(m) - 1);
            acc += v;
            best = fmaxf(best, v);
          }
        }
      }
    }
    if (lane == 0) {
      const size_t out = static_cast<size_t>(q) * n_cand + c0 + c;
      bm25[out] = acc;
      mx[out] = best;
      cnt[out] = n;
    }
  }
  // 4. the records stay readable until every block of the cluster is done
  cluster.sync();
}

}  // namespace

// Launches one cluster of kCluster blocks per (query, group of kCandGroup
// candidate columns) on `stream`; `out` holds the (Q, C) planes of the
// sum, the max and (as int32) the count.  The caller checks the launch
// (C10_CUDA_KERNEL_LAUNCH_CHECK in binding.cpp).
void qd_feature_gather_launch(const int* lane_docs, const float* lane_scores,
                              const int* cand, float* out, int n_q,
                              int n_lanes, int n_cand, cudaStream_t stream) {
  if (n_q == 0 || n_cand == 0) return;
  const size_t plane = static_cast<size_t>(n_q) * n_cand;
  float* bm25 = out;
  float* mx = out + plane;
  int* cnt = reinterpret_cast<int*>(out + 2 * plane);
  const dim3 grid(kCluster, n_q, (n_cand + kCandGroup - 1) / kCandGroup);
  qd_feature_gather_kernel<<<grid, kThreads, 0, stream>>>(
      lane_docs, lane_scores, cand, bm25, mx, cnt, n_lanes, n_cand);
}
