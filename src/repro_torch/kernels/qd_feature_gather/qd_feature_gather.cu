// Stage-2 query-document feature gather over compacted posting lanes.
//
// Replaces the Pallas kernel `qd_feature_gather_lanes` (body
// `_qd_gather_kernel`) of repro/kernels/qd_feature_gather/kernel.py.  Per
// (query q, candidate c) it returns the sum of the scores, the largest
// score and the count of the query's posting lanes whose doc equals the
// candidate: (Q, C) f32, f32, int32.  -1 lanes and -1 candidates never
// match; the max starts at 0.0f, as the TPU kernel's does.
//
// What bounds it on the card: operations.  Each query's P lanes are
// compared with each of its C candidates (P x C integer compares); the
// lanes themselves are read once per candidate block.  One thread owns one
// candidate and walks every lane of its query in order, so its sum is taken
// in lane order from 0.0f: the same order as the plain version (ops.py) and
// as the reference's term-by-term sum, bit for bit.  The lanes stream
// through shared memory in chunks, where every thread reads the same word
// (a broadcast).
//
// The TPU kernel revisits one output block across a sequential grid of lane
// tiles; a CUDA grid runs in no order, so here the loop over lane tiles
// lives inside the block and each output is written once.

#include <cuda_runtime.h>

namespace {

constexpr int kCandPerBlock = 32;
constexpr int kLaneChunk = 2048;

__global__ void qd_feature_gather_kernel(const int* __restrict__ lane_docs,
                                         const float* __restrict__ lane_scores,
                                         const int* __restrict__ cand,
                                         float* __restrict__ bm25,
                                         float* __restrict__ mx,
                                         int* __restrict__ cnt, int n_lanes,
                                         int n_cand) {
  __shared__ int sd[kLaneChunk];
  __shared__ float ss[kLaneChunk];
  const int q = blockIdx.y;
  const int c = blockIdx.x * kCandPerBlock + threadIdx.x;
  const int mine = (c < n_cand) ? cand[static_cast<size_t>(q) * n_cand + c] : -1;
  const size_t lane0 = static_cast<size_t>(q) * n_lanes;
  float acc = 0.0f;
  float best = 0.0f;
  int n = 0;
  for (int base = 0; base < n_lanes; base += kLaneChunk) {
    const int len = min(kLaneChunk, n_lanes - base);
    __syncthreads();
    for (int i = threadIdx.x; i < len; i += kCandPerBlock) {
      sd[i] = lane_docs[lane0 + base + i];
      ss[i] = lane_scores[lane0 + base + i];
    }
    __syncthreads();
    if (mine >= 0) {
      for (int i = 0; i < len; ++i) {
        if (sd[i] == mine) {
          const float s = ss[i];
          acc += s;
          best = fmaxf(best, s);
          ++n;
        }
      }
    }
  }
  if (c < n_cand) {
    const size_t o = static_cast<size_t>(q) * n_cand + c;
    bm25[o] = acc;
    mx[o] = best;
    cnt[o] = n;
  }
}

}  // namespace

// Launches one block per (query, 32-candidate group) on `stream`.  The
// caller checks the launch (C10_CUDA_KERNEL_LAUNCH_CHECK in binding.cpp).
void qd_feature_gather_launch(const int* lane_docs, const float* lane_scores,
                              const int* cand, float* bm25, float* mx,
                              int* cnt, int n_q, int n_lanes, int n_cand,
                              cudaStream_t stream) {
  if (n_q == 0 || n_cand == 0) return;
  const dim3 grid((n_cand + kCandPerBlock - 1) / kCandPerBlock, n_q);
  qd_feature_gather_kernel<<<grid, kCandPerBlock, 0, stream>>>(
      lane_docs, lane_scores, cand, bm25, mx, cnt, n_lanes, n_cand);
}
