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
// survives (survive_b), into a (Q, n_tiles, tile_d) f32 output; a tile
// with survive_t == 0 gives zeros.
//
// What bounds it on the card: bytes.  The function needs, of the tiles
// some query keeps, each live term lane read once (4 B) and the doc and
// score (8 B) of the lanes whose term a keeping query holds, the flags
// once, and the output written once.  The TPU design's grid step is one
// (query, tile) pair that tests every lane of a kept tile against the
// query's L terms: a pass over the mirror's three arrays and lanes x L
// compares per query.  Here the term lanes are read once per group of 32
// queries; the per-lane lookup and the blocks' shared memory, which
// limits them to one or two an SM, cost more time than the stream of the
// term rows alone (PERF.md, kernel table).
//
// The design: one block per (tile, group of up to 32 queries); blockIdx.x
// is the tile, blockIdx.y the group.  The block first reads the group's
// survive_t flags; if no query keeps the tile it writes the group's zero
// rows and returns without touching the mirror.  Otherwise it builds the
// group's term table in shared memory (term_table.cuh, behind a 64 Kbit
// filter), each entry holding beside the query mask a 4-bit code per
// query: the FIRST slot of the query that holds the term (membership: a
// repeated term scores once).  It walks the tile's term lanes with
// coalesced 4-byte loads, 8 a thread in flight, the next step's loads
// issued before this step's lookups; a lane whose term no query holds
// costs its load and one filter test.  A matching lane of a keeping query
// reads its doc and score and, for each keeping query whose survive_b
// block flag is set, writes the score to that query's cell (first slot,
// doc).
//
// Shared memory: the cells take qg x L x tile_d x 4 B, 128 KB at a group
// of 32, L = 8 and tile_d = 128, so the launch opts in to dynamic shared
// memory above 48 KB (cudaFuncSetAttribute; 227 KB a block on the H100).
// Groups of 32 keep one read of the term lanes per 32 queries, as in the
// SAAT kernel, at the cost of one 512-thread block per SM for a full
// group (two at the main path's 10-20 queries).  Only the kept queries'
// cells are cleared and summed.
//
// Determinism without float atomics: postings are unique (term, doc)
// pairs, so no cell is written twice.  The epilogue sums each (query, doc)
// over its L cells in slot order, starting from 0.0f, empty cells
// included: the order of blockmax_score_plain (ops.py), which the kernel
// equals bit for bit, whatever the scheduling.  The TPU's one-hot f32
// matmul adds the same terms in another order, so the two agree to float
// rounding.

#include <cuda_runtime.h>

#include "../term_table.cuh"

namespace {

using term_table::kEmpty;
using term_table::kGroup;

constexpr int kBatchThreads = 512;
constexpr int kBatchUnroll = 8;          // term loads of a thread in flight
constexpr int kCodeWords = kGroup / 8;   // 4-bit first-slot codes of a term

__global__ void __launch_bounds__(kBatchThreads) blockmax_score_kernel(
    const int* __restrict__ tile_docs, const int* __restrict__ tile_terms,
    const float* __restrict__ tile_scores, const int* __restrict__ qterms,
    const int* __restrict__ survive_b, const int* __restrict__ survive_t,
    float* __restrict__ out, int n_q, int n_tiles, int cap, int n_terms,
    int tile_d, int block_size, int bits) {
  extern __shared__ int smem[];
  const int t = blockIdx.x;
  const int q0 = blockIdx.y * kGroup;
  const int qg = min(kGroup, n_q - q0);
  unsigned* kept_s = reinterpret_cast<unsigned*>(smem);
  if (threadIdx.x < 32) {
    const bool keep = static_cast<int>(threadIdx.x) < qg
        && survive_t[static_cast<size_t>(q0 + threadIdx.x) * n_tiles + t] > 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (threadIdx.x == 0) *kept_s = ballot;
  }
  __syncthreads();
  const unsigned kept = *kept_s;   // bit i: the group's query i keeps t
  if (kept == 0u) {                // the group's zero rows, no mirror read
    for (int i = threadIdx.x; i < qg * tile_d; i += kBatchThreads) {
      const int qi = i / tile_d;
      out[(static_cast<size_t>(q0 + qi) * n_tiles + t) * tile_d
          + (i - qi * tile_d)] = 0.0f;
    }
    return;
  }

  const int size = 1 << bits;
  const int bpt = tile_d / block_size;
  const int row_cells = n_terms * tile_d;                      // a query's
  int* keys = smem + 1;                                        // size
  unsigned* masks = reinterpret_cast<unsigned*>(keys + size);  // size
  unsigned* codes = masks + size;                    // size x kCodeWords
  unsigned* filt = codes + size * kCodeWords;              // kFilterWords
  int* sb = reinterpret_cast<int*>(filt + term_table::kFilterWords);
  float* cells = reinterpret_cast<float*>(sb + qg * bpt);  // qg x L x tile_d
  for (int i = threadIdx.x; i < size; i += kBatchThreads) {
    keys[i] = kEmpty;
    masks[i] = 0u;
  }
  for (int i = threadIdx.x; i < term_table::kFilterWords; i += kBatchThreads)
    filt[i] = 0u;
  for (int i = threadIdx.x; i < size * kCodeWords; i += kBatchThreads)
    codes[i] = 0u;
  for (int i = threadIdx.x; i < qg * bpt; i += kBatchThreads) {
    const int qi = i / bpt;
    sb[i] = survive_b[(static_cast<size_t>(q0 + qi) * n_tiles + t) * bpt
                      + (i - qi * bpt)];
  }
  for (int i = threadIdx.x; i < qg * row_cells; i += kBatchThreads)
    if ((kept >> (i / row_cells)) & 1u) cells[i] = 0.0f;
  __syncthreads();

  // the group's term table: every (query, slot) in parallel; the first
  // slot of a query holding a term sets the query's bit and code
  const int* qt = qterms + static_cast<size_t>(q0) * n_terms;
  for (int i = threadIdx.x; i < qg * n_terms; i += kBatchThreads) {
    const int term = qt[i];
    if (term < 0) continue;
    const int qi = i / n_terms;
    const int slot = i - qi * n_terms;
    bool first = true;
    for (int l = 0; l < slot; ++l) first &= qt[qi * n_terms + l] != term;
    if (!first) continue;
    const int e = term_table::insert(keys, term, bits);
    atomicOr(&masks[e], 1u << qi);
    atomicOr(&codes[e * kCodeWords + (qi >> 3)],
             static_cast<unsigned>(slot) << (4 * (qi & 7)));
    term_table::filter_add(filt, term);
  }
  __syncthreads();

  // the tile's term lanes: the next step's loads go out before this
  // step's lanes are looked up
  const size_t row = static_cast<size_t>(t) * cap;
  const int* terms = tile_terms + row;
  constexpr int kStep = kBatchUnroll * kBatchThreads;
  int cur[kBatchUnroll];
  term_table::load_terms<kBatchThreads>(cur, terms, threadIdx.x, cap);
  for (int j0 = threadIdx.x; j0 < cap; j0 += kStep) {
    int nxt[kBatchUnroll];
    term_table::load_terms<kBatchThreads>(nxt, terms, j0 + kStep, cap);
#pragma unroll
    for (int u = 0; u < kBatchUnroll; ++u) {
      if (!term_table::filter_test(filt, cur[u])) continue;
      const int e = term_table::find(keys, cur[u], bits);
      if (e < 0) continue;
      const unsigned held = masks[e] & kept;
      if (held == 0u) continue;
      const size_t j = row + j0 + u * kBatchThreads;
      const int d = tile_docs[j];
      const float s = tile_scores[j];
      if (static_cast<unsigned>(d) >= static_cast<unsigned>(tile_d)) continue;
      const int blk = d / block_size;
      for (unsigned m = held; m != 0u; m &= m - 1u) {
        const int qi = __ffs(m) - 1;
        if (sb[qi * bpt + blk] <= 0) continue;
        const int slot = (codes[e * kCodeWords + (qi >> 3)] >> (4 * (qi & 7)))
                         & 15u;
        cells[qi * row_cells + slot * tile_d + d] = s;
      }
    }
#pragma unroll
    for (int u = 0; u < kBatchUnroll; ++u) cur[u] = nxt[u];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < qg * tile_d; i += kBatchThreads) {
    const int qi = i / tile_d;
    const int d = i - qi * tile_d;
    float s = 0.0f;
    if ((kept >> qi) & 1u) {
      const float* c = cells + qi * row_cells + d;
      for (int l = 0; l < n_terms; ++l) s += c[l * tile_d];
    }
    out[(static_cast<size_t>(q0 + qi) * n_tiles + t) * tile_d + d] = s;
  }
}

}  // namespace

// Launches one block per (tile, group of up to 32 queries) on `stream`,
// with the shared memory the group needs (opted in above 48 KB).  The
// caller checks the launch (C10_CUDA_KERNEL_LAUNCH_CHECK in binding.cpp);
// the wrapper (ops.py) raises first on what the card cannot hold.
void blockmax_score_launch(const int* tile_docs, const int* tile_terms,
                           const float* tile_scores, const int* qterms,
                           const int* survive_b, const int* survive_t,
                           float* out, int n_q, int n_tiles, int cap,
                           int n_terms, int tile_d, int block_size,
                           cudaStream_t stream) {
  if (n_q == 0 || n_tiles == 0) return;
  const int gq = n_q < kGroup ? n_q : kGroup;
  const int bits = term_table::bits_for(gq * n_terms);
  const size_t smem = sizeof(int) * (1 + (size_t{1} << bits) * (2 + kCodeWords)
                                     + term_table::kFilterWords
                                     + size_t{1} * gq * (tile_d / block_size)
                                     + size_t{1} * gq * n_terms * tile_d);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(blockmax_score_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  const dim3 grid(n_tiles, (n_q + kGroup - 1) / kGroup);
  blockmax_score_kernel<<<grid, kBatchThreads, smem, stream>>>(
      tile_docs, tile_terms, tile_scores, qterms, survive_b, survive_t, out,
      n_q, n_tiles, cap, n_terms, tile_d, block_size, bits);
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
