// SAAT (JASS) impact accumulation: two kernels.
//
// 1. `impact_accumulate_kernel`, over the shard's bucketed doc-tile mirror
//    for a batch of queries (the batched SAAT engine).
// 2. `impact_accumulate_bucketed_kernel`, over one query's own postings
//    bucketed by doc tile (the per-query SAAT path); notes further down.
//
// Kernel 1 replaces the Pallas kernel `impact_accumulate_batched` (body
// `_accumulate_kernel_batched`) of repro/kernels/impact_accumulate/kernel.py.
// Per (query q, doc tile t) it sums the quantized impacts of the tile's
// postings whose term is one of the query's terms and whose impact reaches
// the query's level cut lstar[q], into a (Q, n_tiles, tile_d) int32 output.
//
// What bounds it on the card: integer operations.  Every (query, tile)
// block tests each lane of its tile against the query's L terms: Q x lanes
// x L int32 compares a batch, which the card issues at 64 a clock per SM (a
// quarter of its fp32 FMA rate); on a full batch that takes about twice as
// long as one pass over the mirror (three (n_tiles, cap) int32 arrays).
// Bytes stay near that one pass: blocks are launched query-fastest
// (blockIdx.x = query), so the Q blocks that read one tile run close
// together and all but the first find the tile in L2.
//
// The TPU kernel reduces with a one-hot f32 matmul and casts to int32
// (exact while sums stay below 2^24: impacts <= 255, at most L terms per
// doc).  Here the sum is kept in int32 from the start, with shared-memory
// integer atomics: integer addition is exact in any order, so the result
// does not depend on scheduling.

#include <cuda_runtime.h>

namespace {

__global__ void impact_accumulate_kernel(
    const int* __restrict__ tile_docs, const int* __restrict__ tile_terms,
    const int* __restrict__ tile_imps, const int* __restrict__ qterms,
    const int* __restrict__ lstar, int* __restrict__ out, int n_tiles,
    int cap, int n_terms, int tile_d) {
  extern __shared__ int smem[];
  int* acc = smem;            // tile_d accumulators
  int* qt = smem + tile_d;    // the query's terms, -1 in empty slots
  const int q = blockIdx.x;
  const int t = blockIdx.y;
  for (int i = threadIdx.x; i < tile_d; i += blockDim.x) acc[i] = 0;
  for (int i = threadIdx.x; i < n_terms; i += blockDim.x)
    qt[i] = qterms[q * n_terms + i];
  __syncthreads();

  const int cut = lstar[q];
  const size_t row = static_cast<size_t>(t) * cap;
  for (int j = threadIdx.x; j < cap; j += blockDim.x) {
    const int d = tile_docs[row + j];
    if (d < 0) continue;  // padding lane
    const int imp = tile_imps[row + j];
    if (imp < cut) continue;
    const int term = tile_terms[row + j];
    bool hit = false;
    for (int l = 0; l < n_terms; ++l) hit |= (qt[l] == term);
    if (hit) atomicAdd(&acc[d], imp);
  }
  __syncthreads();
  int* o = out + (static_cast<size_t>(q) * n_tiles + t) * tile_d;
  for (int i = threadIdx.x; i < tile_d; i += blockDim.x) o[i] = acc[i];
}

}  // namespace

// Launches one block per (query, tile) on `stream`.  The caller checks the
// launch (C10_CUDA_KERNEL_LAUNCH_CHECK in binding.cpp).
void impact_accumulate_launch(const int* tile_docs, const int* tile_terms,
                              const int* tile_imps, const int* qterms,
                              const int* lstar, int* out, int n_q, int n_tiles,
                              int cap, int n_terms, int tile_d,
                              cudaStream_t stream) {
  if (n_q == 0 || n_tiles == 0) return;
  const dim3 grid(n_q, n_tiles);
  const size_t smem = sizeof(int) * (tile_d + n_terms);
  impact_accumulate_kernel<<<grid, 256, smem, stream>>>(
      tile_docs, tile_terms, tile_imps, qterms, lstar, out, n_tiles, cap,
      n_terms, tile_d);
}

// ---------------------------------------------------------------------------
// Kernel 2: one query's postings, bucketed by doc tile.
//
// Replaces the Pallas kernel `impact_accumulate_bucketed` (body
// `_accumulate_kernel`) of repro/kernels/impact_accumulate/kernel.py.  Per
// doc tile t it sums the impacts of the bucket's lanes with a tile-local
// doc in [0, tile_d) and impact >= the scalar cut *lstar, into an
// (n_tiles, tile_d) int32 output.  The wrapper (ops.py) buckets the flat
// lanes with a stable sort and adds the lanes past a tile's CAP after the
// kernel.
//
// What bounds it on the card: bytes.  It streams each bucket lane once
// (doc and impact, 8 B) and does one compare and one add per live lane;
// the bucket is one query's, read by no other block, so there is no reuse
// to exploit.  One block per tile (1,536 at 196,608 docs), 256 threads
// walking the tile's CAP lanes with coalesced loads; the tile's tile_d
// accumulators live in shared memory.
//
// The TPU kernel reduces with a one-hot f32 matmul and casts to int32,
// which is exact only while a tile-doc sum stays below 2^24.  Here the sum
// is int32 from the start, with shared-memory integer atomics: exact in any
// order, so the result does not depend on scheduling.

namespace {

__global__ void impact_accumulate_bucketed_kernel(
    const int* __restrict__ docs_b, const int* __restrict__ imps_b,
    const int* __restrict__ lstar, int* __restrict__ out, int cap,
    int tile_d) {
  extern __shared__ int acc_b[];  // tile_d accumulators
  const int t = blockIdx.x;
  for (int i = threadIdx.x; i < tile_d; i += blockDim.x) acc_b[i] = 0;
  __syncthreads();

  const int cut = *lstar;
  const size_t row = static_cast<size_t>(t) * cap;
  for (int j = threadIdx.x; j < cap; j += blockDim.x) {
    const int d = docs_b[row + j];
    if (d < 0 || d >= tile_d) continue;  // padding lane
    const int imp = imps_b[row + j];
    if (imp >= cut) atomicAdd(&acc_b[d], imp);
  }
  __syncthreads();
  int* o = out + static_cast<size_t>(t) * tile_d;
  for (int i = threadIdx.x; i < tile_d; i += blockDim.x) o[i] = acc_b[i];
}

}  // namespace

// Launches one block per tile on `stream`.  The caller checks the launch.
void impact_accumulate_bucketed_launch(const int* docs_b, const int* imps_b,
                                       const int* lstar, int* out,
                                       int n_tiles, int cap, int tile_d,
                                       cudaStream_t stream) {
  if (n_tiles == 0) return;
  impact_accumulate_bucketed_kernel<<<n_tiles, 256, sizeof(int) * tile_d,
                                      stream>>>(docs_b, imps_b, lstar, out,
                                                cap, tile_d);
}
