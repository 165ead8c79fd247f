// BMW (DAAT) exact scoring over the shard's bucketed doc-tile mirror.
//
// Replaces the Pallas kernel `blockmax_score_batched` (body
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
