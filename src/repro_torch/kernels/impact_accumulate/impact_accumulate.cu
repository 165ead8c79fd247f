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
// What bounds it on the card: bytes.  The function needs each live term
// lane of the mirror read once (4 B), the doc and impact (8 B) of only the
// lanes whose term some query holds (a batch holds ~130 of 32,768 terms),
// and the output written once.  The TPU design's grid step is one (query,
// tile) pair that tests every lane of the tile against the query's L
// terms: Q passes over the mirror's three arrays and Q x lanes x L
// compares.  Here the term lanes are read once per group of 32 queries;
// the per-lane lookup's instructions cost about as much time again as
// the stream of the term rows alone (PERF.md, kernel table).
//
// The design: one block per (tile, group of up to 32 queries); blockIdx.x
// is the tile, blockIdx.y the group.  The block builds the group's term
// table in shared memory (term_table.cuh: term -> mask of the group's
// queries holding it, behind a 64 Kbit filter; a repeated term sets its
// bit once, -1 slots are skipped), then walks the tile's term lanes with
// coalesced 4-byte loads, 8 a thread in flight, the next step's loads
// issued before this step's lookups.  A lane whose term no query holds
// costs its load and one filter test.  A matching lane loads its doc and
// impact and, if the doc lies in [0, tile_d), for each query bit whose
// cut it reaches adds the impact to that query's row of int32
// accumulators in shared memory (32 x tile_d x 4 B = 16 KB at tile_d
// 128).  The epilogue writes the group's rows with coalesced stores.
//
// The TPU kernel reduces with a one-hot f32 matmul and casts to int32
// (exact while sums stay below 2^24: impacts <= 255, at most L terms per
// doc).  Here the sum is kept in int32 from the start, with shared-memory
// integer atomics: integer addition is exact in any order, so the result
// does not depend on scheduling and equals the plain versions bit for bit.

#include <cuda_runtime.h>

#include "../term_table.cuh"

namespace {

using term_table::kEmpty;
using term_table::kGroup;

constexpr int kBatchThreads = 256;
constexpr int kBatchUnroll = 8;   // term loads of a thread in flight

__global__ void __launch_bounds__(kBatchThreads) impact_accumulate_kernel(
    const int* __restrict__ tile_docs, const int* __restrict__ tile_terms,
    const int* __restrict__ tile_imps, const int* __restrict__ qterms,
    const int* __restrict__ lstar, int* __restrict__ out, int n_q,
    int n_tiles, int cap, int n_terms, int tile_d, int bits) {
  extern __shared__ int smem[];
  const int t = blockIdx.x;
  const int q0 = blockIdx.y * kGroup;
  const int qg = min(kGroup, n_q - q0);
  const int size = 1 << bits;
  int* keys = smem;                                            // size
  unsigned* masks = reinterpret_cast<unsigned*>(keys + size);  // size
  unsigned* filt = masks + size;                         // kFilterWords
  int* cut = reinterpret_cast<int*>(filt + term_table::kFilterWords);
  int* acc = cut + kGroup;                                     // qg x tile_d
  for (int i = threadIdx.x; i < size; i += kBatchThreads) {
    keys[i] = kEmpty;
    masks[i] = 0u;
  }
  for (int i = threadIdx.x; i < term_table::kFilterWords; i += kBatchThreads)
    filt[i] = 0u;
  for (int i = threadIdx.x; i < qg * tile_d; i += kBatchThreads) acc[i] = 0;
  if (threadIdx.x < qg) cut[threadIdx.x] = lstar[q0 + threadIdx.x];
  __syncthreads();

  // the group's term table: every (query, slot) in parallel
  const int* qt = qterms + static_cast<size_t>(q0) * n_terms;
  for (int i = threadIdx.x; i < qg * n_terms; i += kBatchThreads) {
    const int term = qt[i];
    if (term < 0) continue;
    atomicOr(&masks[term_table::insert(keys, term, bits)],
             1u << (i / n_terms));
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
      const size_t j = row + j0 + u * kBatchThreads;
      const int d = tile_docs[j];
      const int imp = tile_imps[j];
      if (static_cast<unsigned>(d) >= static_cast<unsigned>(tile_d)) continue;
      for (unsigned m = masks[e]; m != 0u; m &= m - 1u) {
        const int i = __ffs(m) - 1;
        if (imp >= cut[i]) atomicAdd(&acc[i * tile_d + d], imp);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatchUnroll; ++u) cur[u] = nxt[u];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < qg * tile_d; i += kBatchThreads) {
    const int qi = i / tile_d;
    out[(static_cast<size_t>(q0 + qi) * n_tiles + t) * tile_d
        + (i - qi * tile_d)] = acc[i];
  }
}

}  // namespace

// Launches one block per (tile, group of up to 32 queries) on `stream`,
// with the shared memory the group needs (opted in above 48 KB).  The
// caller checks the launch (C10_CUDA_KERNEL_LAUNCH_CHECK in binding.cpp);
// the wrapper (ops.py) raises first on what the card cannot hold.
void impact_accumulate_launch(const int* tile_docs, const int* tile_terms,
                              const int* tile_imps, const int* qterms,
                              const int* lstar, int* out, int n_q, int n_tiles,
                              int cap, int n_terms, int tile_d,
                              cudaStream_t stream) {
  if (n_q == 0 || n_tiles == 0) return;
  const int gq = n_q < kGroup ? n_q : kGroup;
  const int bits = term_table::bits_for(gq * n_terms);
  const size_t smem =
      sizeof(int) * ((size_t{2} << bits) + term_table::kFilterWords + kGroup
                     + size_t{1} * gq * tile_d);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(impact_accumulate_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  const dim3 grid(n_tiles, (n_q + kGroup - 1) / kGroup);
  impact_accumulate_kernel<<<grid, kBatchThreads, smem, stream>>>(
      tile_docs, tile_terms, tile_imps, qterms, lstar, out, n_q, n_tiles, cap,
      n_terms, tile_d, bits);
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
// What bounds it on the card: bytes.  The function needs each live lane
// of the bucket read once (doc and impact, 8 B), the cut, and the output
// written once; one compare and one add per live lane.  The bucket's rows
// are prefix-packed (kernels/buckets.py: slot j of row t holds the tile's
// j-th sorted lane, then -1), and at the per-query path's largest call 6 %
// of the slots are live: a design that scans every slot spends half its
// time reading padding.  So the launch takes each row's live length
// (`lens`, min(lanes of the tile, CAP), from the bucketing's tile starts)
// and reads only that prefix; without `lens` it reads whole rows, which
// is the reference's function for a bucket of unknown packing.
//
// The design: one warp per tile, kTileWarps tiles a block, so a row of
// ~60 live lanes occupies one warp for two 32-lane steps instead of
// idling a 256-thread block.  A warp issues kUnroll steps' coalesced
// loads of doc and impact before it adds them; a live lane with doc in
// [0, tile_d) and impact >= cut adds into the warp's tile_d int32
// accumulators in shared memory.  The epilogue writes every tile's row,
// empty rows included, with coalesced stores.
//
// The TPU kernel reduces with a one-hot f32 matmul and casts to int32,
// which is exact only while a tile-doc sum stays below 2^24.  Here the sum
// is int32 from the start, with shared-memory integer atomics: exact in any
// order, so the result does not depend on scheduling and equals the plain
// version bit for bit.

namespace {

constexpr int kTileWarps = 8;  // tiles (one warp each) of a block
constexpr int kUnroll = 4;     // 32-lane steps loaded before they are added

__global__ void __launch_bounds__(kTileWarps * 32)
    impact_accumulate_bucketed_kernel(const int* __restrict__ docs_b,
                                      const int* __restrict__ imps_b,
                                      const int* __restrict__ lstar,
                                      const int* __restrict__ lens,
                                      int* __restrict__ out, int n_tiles,
                                      int cap, int tile_d) {
  extern __shared__ int acc_all[];  // kTileWarps x tile_d accumulators
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = blockIdx.x * kTileWarps + warp;
  if (t >= n_tiles) return;  // the whole warp; no block barrier follows
  int* acc = acc_all + warp * tile_d;
  for (int i = lane; i < tile_d; i += 32) acc[i] = 0;
  __syncwarp();

  const int cut = *lstar;
  const int len = lens == nullptr ? cap : min(max(lens[t], 0), cap);
  const int* docs = docs_b + static_cast<size_t>(t) * cap;
  const int* imps = imps_b + static_cast<size_t>(t) * cap;
  for (int base = 0; base < len; base += 32 * kUnroll) {
    int d[kUnroll], v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + 32 * u + lane;
      d[u] = j < len ? docs[j] : -1;
      v[u] = j < len ? imps[j] : 0;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (static_cast<unsigned>(d[u]) < static_cast<unsigned>(tile_d)
          && v[u] >= cut)
        atomicAdd(&acc[d[u]], v[u]);
  }
  __syncwarp();
  int* o = out + static_cast<size_t>(t) * tile_d;
  for (int i = lane; i < tile_d; i += 32) o[i] = acc[i];
}

}  // namespace

// Launches one warp per tile, kTileWarps tiles a block, on `stream`;
// `lens` may be null (whole rows).  The caller checks the launch.
void impact_accumulate_bucketed_launch(const int* docs_b, const int* imps_b,
                                       const int* lstar, const int* lens,
                                       int* out, int n_tiles, int cap,
                                       int tile_d, cudaStream_t stream) {
  if (n_tiles == 0) return;
  const int blocks = (n_tiles + kTileWarps - 1) / kTileWarps;
  const size_t smem = sizeof(int) * kTileWarps * tile_d;
  impact_accumulate_bucketed_kernel<<<blocks, kTileWarps * 32, smem,
                                      stream>>>(docs_b, imps_b, lstar, lens,
                                                out, n_tiles, cap, tile_d);
}
