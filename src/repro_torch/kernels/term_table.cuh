// The query-group term table of the batched mirror kernels
// (impact_accumulate.cu and blockmax_score.cu).
//
// A block serves one doc tile for a group of up to kGroup queries.  Before
// it reads the tile it builds, in shared memory, an open-addressing hash
// table of the group's query terms: each entry holds a term (>= 0) and the
// 32-bit mask of the group's queries that hold it (bit i: the group's
// query i).  Beside it, a 64 Kbit filter holds one bit per (term & 65535)
// of the group's terms.  A lane of the tile then costs one load of its
// term and one filter test; a lane that passes probes the table, and only
// a lane whose term some query holds goes on to read its doc and value.
// term_table.py builds the same table in PyTorch for the kernels' plain
// twins.
//
// The table has at least twice as many entries as the group has query
// slots (and at least 32), so a probe always meets the term or an empty
// entry.  Inserts use shared-memory atomicCAS and atomicOr; lookups run
// after the block's __syncthreads.

#pragma once

namespace term_table {

constexpr int kGroup = 32;   // queries a block serves: one bit each of a mask
constexpr int kEmpty = -1;   // an unused entry (query terms are >= 0)
constexpr int kFilterWords = 2048;   // the 64 Kbit filter

// log2 of the table size for `n_slots` query slots; term_table.table_bits
// in Python is the same.
__host__ __device__ inline int bits_for(int n_slots) {
  int b = 5;
  while ((1 << b) < 2 * n_slots) ++b;
  return b;
}

// Multiplicative (Fibonacci) hash of a term into 2^bits entries.
__device__ __forceinline__ unsigned hash(int term, int bits) {
  return (static_cast<unsigned>(term) * 2654435761u) >> (32 - bits);
}

// The entry of `term` (>= 0), claimed if the term is not in the table yet.
__device__ __forceinline__ int insert(int* keys, int term, int bits) {
  const unsigned wrap = (1u << bits) - 1u;
  for (unsigned h = hash(term, bits);; h = (h + 1u) & wrap) {
    const int prev = atomicCAS(&keys[h], kEmpty, term);
    if (prev == kEmpty || prev == term) return static_cast<int>(h);
  }
}

// The entry of `term` (>= 0), or -1 if no query of the group holds it.
__device__ __forceinline__ int find(const int* keys, int term, int bits) {
  const unsigned wrap = (1u << bits) - 1u;
  for (unsigned h = hash(term, bits);; h = (h + 1u) & wrap) {
    const int k = keys[h];
    if (k == term) return static_cast<int>(h);
    if (k == kEmpty) return -1;
  }
}

// Sets the filter bit of `term` (>= 0).
__device__ __forceinline__ void filter_add(unsigned* filt, int term) {
  atomicOr(&filt[(term >> 5) & (kFilterWords - 1)], 1u << (term & 31));
}

// False when no query of the group holds `term` (lanes with term < 0
// included); true for the group's terms and the few others that share
// their filter bit.
__device__ __forceinline__ bool filter_test(const unsigned* filt, int term) {
  return term >= 0
      && ((filt[(term >> 5) & (kFilterWords - 1)] >> (term & 31)) & 1u);
}

// The terms of lanes j0, j0 + kThreads, ... (kUnroll of them) of a tile
// row of `cap` lanes, kEmpty past its end: coalesced 4-byte loads, all in
// flight together.
template <int kThreads, int kUnroll>
__device__ __forceinline__ void load_terms(int (&v)[kUnroll],
                                           const int* __restrict__ terms,
                                           int j0, int cap) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int j = j0 + u * kThreads;
    v[u] = j < cap ? terms[j] : kEmpty;
  }
}

}  // namespace term_table
