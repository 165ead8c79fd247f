// BMW (DAAT) exact scoring: two kernels.
//
// 1. `blockmax_score_kernel`, over the shard's bucketed doc-tile mirror for
//    a batch of queries (the batched DAAT engine).
// 2. `blockmax_score_bucketed_kernel`, over one query's own postings
//    bucketed by doc tile (the per-query DAAT path); notes further down.
//
// Kernel 1 replaces the Pallas kernel `blockmax_score_batched` (body
// `_score_kernel_batched`) of repro/kernels/blockmax_score/kernel.py.  Per
// (query q, doc tile t) it sums the f32 BM25 scores of the tile's postings
// whose term is one of the query's terms and whose 64-doc pruning block
// survives (survive_b), into a (Q, n_tiles, tile_d) f32 output.  A tile
// with survive_t == 0 writes its zeros without reading the mirror (the
// output comes from torch.empty, so the zeros must be written).
//
// What bounds it on the card: integer operations and bytes about equally.
// Each surviving (query, tile) block streams its tile's doc, term and score
// lanes once and tests each lane against the query's L terms (int32
// compares, 64 a clock per SM); pruned tiles cost one flag read and a
// 512-byte store.  Blocks run query-fastest (blockIdx.x = query) so the
// queries that share a tile read it through L2, and device memory sees
// about one pass over the tiles some query needs.
//
// Determinism without float atomics: postings are unique (term, doc) pairs,
// so a doc gets at most one lane per query term.  Each live lane writes its
// score to its own (query-term slot, doc) cell in shared memory, claimed by
// the FIRST slot holding its term (membership: a repeated query term scores
// once); no two lanes share a cell.  Each doc's sum is then taken over the
// slots in slot order, starting from 0.0f.  The result does not depend on
// scheduling, and it is the order the plain version (ops.py) sums in, bit
// for bit.  The TPU's one-hot f32 matmul adds the same terms in another
// order, so the two agree to float rounding.

#include <cuda_runtime.h>

namespace {

__global__ void blockmax_score_kernel(
    const int* __restrict__ tile_docs, const int* __restrict__ tile_terms,
    const float* __restrict__ tile_scores, const int* __restrict__ qterms,
    const int* __restrict__ survive_b, const int* __restrict__ survive_t,
    float* __restrict__ out, int n_tiles, int cap, int n_terms, int tile_d,
    int block_size) {
  extern __shared__ float smem_f[];
  const int q = blockIdx.x;
  const int t = blockIdx.y;
  const size_t qt_idx = static_cast<size_t>(q) * n_tiles + t;
  float* o = out + qt_idx * tile_d;
  if (survive_t[qt_idx] == 0) {
    for (int i = threadIdx.x; i < tile_d; i += blockDim.x) o[i] = 0.0f;
    return;
  }
  const int bpt = tile_d / block_size;
  float* contrib = smem_f;                                     // n_terms x tile_d
  int* qt = reinterpret_cast<int*>(contrib + n_terms * tile_d);  // n_terms
  int* sb = qt + n_terms;                                      // bpt
  for (int i = threadIdx.x; i < n_terms * tile_d; i += blockDim.x)
    contrib[i] = 0.0f;
  for (int i = threadIdx.x; i < n_terms; i += blockDim.x)
    qt[i] = qterms[q * n_terms + i];
  for (int i = threadIdx.x; i < bpt; i += blockDim.x)
    sb[i] = survive_b[qt_idx * bpt + i];
  __syncthreads();

  const size_t row = static_cast<size_t>(t) * cap;
  for (int j = threadIdx.x; j < cap; j += blockDim.x) {
    const int d = tile_docs[row + j];
    if (d < 0) continue;  // padding lane
    if (sb[d / block_size] == 0) continue;
    const int term = tile_terms[row + j];
    int slot = -1;
    for (int l = n_terms - 1; l >= 0; --l)
      if (qt[l] == term) slot = l;
    if (slot >= 0) contrib[slot * tile_d + d] = tile_scores[row + j];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < tile_d; i += blockDim.x) {
    float s = 0.0f;
    for (int l = 0; l < n_terms; ++l) s += contrib[l * tile_d + i];
    o[i] = s;
  }
}

}  // namespace

// Launches one block per (query, tile) on `stream`.  The caller checks the
// launch (C10_CUDA_KERNEL_LAUNCH_CHECK in binding.cpp).
void blockmax_score_launch(const int* tile_docs, const int* tile_terms,
                           const float* tile_scores, const int* qterms,
                           const int* survive_b, const int* survive_t,
                           float* out, int n_q, int n_tiles, int cap,
                           int n_terms, int tile_d, int block_size,
                           cudaStream_t stream) {
  if (n_q == 0 || n_tiles == 0) return;
  const dim3 grid(n_q, n_tiles);
  const size_t smem = sizeof(float) * n_terms * tile_d
                      + sizeof(int) * (n_terms + tile_d / block_size);
  blockmax_score_kernel<<<grid, 256, smem, stream>>>(
      tile_docs, tile_terms, tile_scores, qterms, survive_b, survive_t, out,
      n_tiles, cap, n_terms, tile_d, block_size);
}

// ---------------------------------------------------------------------------
// Kernel 2: one query's postings, bucketed by doc tile.
//
// Replaces the Pallas kernel `blockmax_score_bucketed` (body `_score_kernel`)
// of repro/kernels/blockmax_score/kernel.py.  Per doc tile t it sums the f32
// scores of the bucket's lanes by tile-local doc, skipping the bucket of a
// tile with survive_t == 0, then adds the tile's overflow residue — the
// sorted run's lanes [run_start[t] + cap, run_start[t + 1]) — which the
// reference adds after its kernel with a scatter.  Lanes whose doc is
// outside [0, tile_d) (the bucket's -1 padding) add nothing.  Output
// (n_tiles, tile_d) f32.
//
// What bounds it on the card: bytes.  The function needs each live lane of
// the surviving tiles and the residue read once (doc and score, 8 B) and
// one f32 add per lane.  The design keeps the work proportional to the
// lanes: one warp per tile reads the bucket row (and then the residue) 32
// lanes a step with coalesced loads, kUnroll steps in flight; a step with
// no live lane costs its loads and one ballot.  Within a step,
// `__match_any_sync` groups the live lanes by doc, and the lowest lane of
// each group adds the group's scores to the doc's running sum in shared
// memory in lane order (the others' scores by shuffle); groups of distinct
// docs add in parallel.
//
// Determinism without float atomics: steps run in order, lanes within a
// step in lane order, the bucket before the residue; so each doc's lanes
// are added in lane order from 0.0f whatever the scheduling — the bucket
// keeps the flat lanes' order inside a tile (stable sort) and the residue
// follows it.  The plain version (ops.py) adds in the same order and
// agrees bit for bit; the TPU's one-hot f32 matmul adds the same terms in
// another order.

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kTileWarps = 4;  // tiles (one warp each) of a block
constexpr int kUnroll = 8;     // 32-lane steps loaded before they are added

// One 32-lane step: each live lane's score added to acc[doc], in lane order.
__device__ __forceinline__ void add_step(int doc, float score, int tile_d,
                                         float* acc, int lane) {
  const bool live = doc >= 0 && doc < tile_d;
  if (__ballot_sync(kFull, live) == 0) return;  // uniform over the warp
  const unsigned peers = __match_any_sync(kFull, live ? doc : -1);
  const bool leader = live && __ffs(peers) - 1 == lane;
  unsigned rest = leader ? peers : 0u;  // the group, lowest lane first
  float a = leader ? acc[doc] : 0.0f;
  while (__any_sync(kFull, rest != 0u)) {
    const float v = __shfl_sync(kFull, score, rest ? __ffs(rest) - 1 : lane);
    if (rest) {
      a += v;
      rest &= rest - 1u;
    }
  }
  if (leader) acc[doc] = a;
  __syncwarp();  // the next step's leaders read what this one wrote
}

// Lanes [lo, hi) of (docs, scores) added into acc by one warp, in order.
__device__ void add_lanes(const int* __restrict__ docs,
                          const float* __restrict__ scores, long long lo,
                          long long hi, int tile_d, float* acc, int lane) {
  for (long long base = lo; base < hi; base += 32 * kUnroll) {
    int d[kUnroll];
    float s[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = base + 32 * u + lane;
      d[u] = j < hi ? docs[j] : -1;
      s[u] = j < hi ? scores[j] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) add_step(d[u], s[u], tile_d, acc, lane);
  }
}

__global__ void __launch_bounds__(kTileWarps * 32)
    blockmax_score_bucketed_kernel(
        const int* __restrict__ docs_b, const float* __restrict__ scores_b,
        const int* __restrict__ survive_t, const int* __restrict__ run_docs,
        const float* __restrict__ run_scores,
        const int* __restrict__ run_start, float* __restrict__ out,
        int n_tiles, int cap, int tile_d) {
  extern __shared__ float acc_all[];  // kTileWarps x tile_d running sums
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = blockIdx.x * kTileWarps + warp;
  if (t >= n_tiles) return;  // the whole warp; no block barrier follows
  float* acc = acc_all + warp * tile_d;
  for (int i = lane; i < tile_d; i += 32) acc[i] = 0.0f;
  __syncwarp();
  if (survive_t[t] != 0) {
    const long long row = static_cast<long long>(t) * cap;
    add_lanes(docs_b, scores_b, row, row + cap, tile_d, acc, lane);
  }
  add_lanes(run_docs, run_scores, static_cast<long long>(run_start[t]) + cap,
            run_start[t + 1], tile_d, acc, lane);
  __syncwarp();
  float* o = out + static_cast<long long>(t) * tile_d;
  for (int i = lane; i < tile_d; i += 32) o[i] = acc[i];
}

}  // namespace

// Launches one warp per tile, kTileWarps tiles a block, on `stream`.  The
// caller checks the launch.
void blockmax_score_bucketed_launch(const int* docs_b, const float* scores_b,
                                    const int* survive_t, const int* run_docs,
                                    const float* run_scores,
                                    const int* run_start, float* out,
                                    int n_tiles, int cap, int tile_d,
                                    cudaStream_t stream) {
  if (n_tiles == 0) return;
  const int blocks = (n_tiles + kTileWarps - 1) / kTileWarps;
  const size_t smem = sizeof(float) * kTileWarps * tile_d;
  blockmax_score_bucketed_kernel<<<blocks, kTileWarps * 32, smem, stream>>>(
      docs_b, scores_b, survive_t, run_docs, run_scores, run_start, out,
      n_tiles, cap, tile_d);
}
