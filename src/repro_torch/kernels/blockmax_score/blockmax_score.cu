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
// reference adds after its kernel with a scatter.  Output (n_tiles, tile_d)
// f32.
//
// Determinism without float atomics: one thread per local doc (blockDim =
// tile_d) owns that doc's sum.  The block stages the bucket into shared
// memory STAGE lanes at a time and every thread walks the staged lanes in
// order (a broadcast read), adding the scores of its own doc from 0.0f;
// then the residue, the same way.  So each doc's lanes are added in lane
// order — the bucket keeps the flat lanes' order inside a tile (stable
// sort) and the residue follows it — whatever the scheduling.  The plain
// version (ops.py) adds in the same order and agrees bit for bit; the TPU's
// one-hot f32 matmul adds the same terms in another order.
//
// What bounds it on the card: bytes.  The function needs each live lane of
// the surviving tiles read once (doc and score, 8 B) and one f32 add per
// lane.  This design spends instructions instead: every thread tests every
// lane of its tile (tile_d x CAP compares a tile, from shared memory), a
// cost the bound does not count; a later design can sort a tile's lanes
// by doc and keep the order.

namespace {

constexpr int STAGE = 1024;  // lanes staged in shared memory at a time

__device__ float walk_lanes(const int* __restrict__ docs,
                            const float* __restrict__ scores, size_t lo,
                            size_t hi, int me, float acc, int* s_doc,
                            float* s_score) {
  for (size_t base = lo; base < hi; base += STAGE) {
    const size_t left = hi - base;
    const int n = left < STAGE ? static_cast<int>(left) : STAGE;
    __syncthreads();  // the previous stage has been read
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      s_doc[i] = docs[base + i];
      s_score[i] = scores[base + i];
    }
    __syncthreads();
    for (int i = 0; i < n; ++i)
      if (s_doc[i] == me) acc += s_score[i];
  }
  return acc;
}

__global__ void blockmax_score_bucketed_kernel(
    const int* __restrict__ docs_b, const float* __restrict__ scores_b,
    const int* __restrict__ survive_t, const int* __restrict__ run_docs,
    const float* __restrict__ run_scores, const int* __restrict__ run_start,
    float* __restrict__ out, int cap, int tile_d) {
  __shared__ int s_doc[STAGE];
  __shared__ float s_score[STAGE];
  const int t = blockIdx.x;
  const int me = threadIdx.x;  // this thread's tile-local doc
  float acc = 0.0f;
  if (survive_t[t] != 0) {  // uniform over the block
    const size_t row = static_cast<size_t>(t) * cap;
    acc = walk_lanes(docs_b, scores_b, row, row + cap, me, acc, s_doc,
                     s_score);
  }
  const size_t lo = static_cast<size_t>(run_start[t]) + cap;
  const size_t hi = static_cast<size_t>(run_start[t + 1]);
  acc = walk_lanes(run_docs, run_scores, lo, hi, me, acc, s_doc, s_score);
  out[static_cast<size_t>(t) * tile_d + me] = acc;
}

}  // namespace

// Launches one block of tile_d threads per tile on `stream`.  The caller
// checks the launch.
void blockmax_score_bucketed_launch(const int* docs_b, const float* scores_b,
                                    const int* survive_t, const int* run_docs,
                                    const float* run_scores,
                                    const int* run_start, float* out,
                                    int n_tiles, int cap, int tile_d,
                                    cudaStream_t stream) {
  if (n_tiles == 0) return;
  blockmax_score_bucketed_kernel<<<n_tiles, tile_d, 0, stream>>>(
      docs_b, scores_b, survive_t, run_docs, run_scores, run_start, out, cap,
      tile_d);
}
