// Histogram of integer (quantized) scores.
//
// Replaces the Pallas kernel `score_histogram` (body `_hist_kernel`) of
// repro/kernels/score_histogram/kernel.py: counts of the (N,) int32 scores
// per bin, negative scores ignored and scores >= n_bins counted in bin
// n_bins - 1, into an (n_bins,) int32 output.
//
// The TPU kernel adds each grid step's one-hot-matmul histogram into one
// output block that every step revisits, which relies on the TPU running
// its grid in order.  Blocks on the card run in no order, so each block
// builds its own histogram in shared memory (n_bins ints, 8 KB at 2,048
// bins) with integer atomics over a grid-stride share of the scores, then
// adds its non-zero bins into the output with integer atomicAdd.  Integer
// addition is exact in any order, so the result does not depend on
// scheduling.  The output must be zeroed by the caller (the wrapper
// allocates it with torch.zeros).  Unlike the TPU kernel it takes any N.
//
// What bounds it on the card: bytes, 4 B a score read once (0.79 MB for a
// 196,608-doc accumulator, a quarter of a microsecond at 3.35 TB/s), far
// below one launch.  Scores that share a bin contend on one shared-memory
// address (a JASS accumulator is mostly zeros); a later design can count
// a warp's equal bins once with __match_any_sync.

#include <cuda_runtime.h>

namespace {

__global__ void score_histogram_kernel(const int* __restrict__ scores,
                                       int* __restrict__ out, long long n,
                                       int n_bins) {
  extern __shared__ int hist[];
  for (int i = threadIdx.x; i < n_bins; i += blockDim.x) hist[i] = 0;
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                     + threadIdx.x;
       i < n; i += stride) {
    const int s = scores[i];
    if (s >= 0) atomicAdd(&hist[s < n_bins ? s : n_bins - 1], 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_bins; i += blockDim.x)
    if (hist[i] != 0) atomicAdd(&out[i], hist[i]);
}

}  // namespace

// Launches up to 1,024 blocks of 256 threads (about 2,048 scores a block)
// on `stream`.  The caller checks the launch.
void score_histogram_launch(const int* scores, int* out, long long n,
                            int n_bins, cudaStream_t stream) {
  if (n == 0) return;
  const long long per_block = 2048;
  long long blocks = (n + per_block - 1) / per_block;
  if (blocks > 1024) blocks = 1024;
  score_histogram_kernel<<<static_cast<int>(blocks), 256,
                           sizeof(int) * n_bins, stream>>>(scores, out, n,
                                                           n_bins);
}
