// Split histograms of one tree level of the GBRT fit, and the boosting
// update of the fit's running prediction.
//
// Replaces no Pallas kernel.  The reference fits its forests inside one jit
// (repro/core/gbrt.py `_fit_binned`), and the hot loop of every tree level
// is `jax.ops.segment_sum` in `_level_histograms`
// (repro/core/trees.py:69): per (node, feature, bin) cell, the sum of g·w
// and of w over the rows whose node and bin are the cell's.  XLA on the
// CPU adds each cell's rows one at a time, in increasing row order, from
// 0.0.  A split compares those sums, and one ulp can move an argmax, so
// the card must add in the same order: a float scatter-add through atomics
// (`index_add_` on CUDA) adds in no fixed order and is not used (ROADMAP
// rule d).
//
// `level_histogram_kernel`: one block per (feature, slice of up to 512
// cells), one thread per (node, bin) cell.  The block walks the rows in
// tiles staged in shared memory (each row's key node·n_bins + bin, its g·w
// and its w).  Every warp reads each key (a broadcast) and only the warp
// that holds the key's cell branches in, where the cell's thread adds the
// row: each cell's sum is its rows added one at a time, in row order, from
// 0.0, the reference's order exactly.  No atomics at all; every output
// written once.
//
// What bounds it on the card: the bytes are few (the (F, n) uint8 bins,
// the node ids and two floats a row, read once; two float histograms
// written once), and the design spends a few warp-uniform instructions a
// row in every warp of a block, n · cells / 32 · F warp-steps in all, some
// twenty million at Stage-0's widths (4,096 rows, 147 features, 1,024
// cells at depth 5): instruction issue bounds it, by design, for an order
// that needs no sort and no atomics.
//
// `boost_update_kernel`: f[i] = fma(raw[leaf[i]], lr, f[i]), one thread a
// row.  Inside the reference's jit XLA contracts `f + leaves[leaf_id]`
// with `leaves = raw * lr` into that fused multiply-add; `__fmaf_rn` is
// written out here so that no compiler choice decides it.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kRows = 1024;    // rows staged in shared memory a tile
constexpr int kThreads = 512;  // cells a block

__global__ void __launch_bounds__(kThreads)
    level_histogram_kernel(const uint8_t* __restrict__ xbt,
                           const int* __restrict__ node,
                           const float* __restrict__ gw,
                           const float* __restrict__ w,
                           float* __restrict__ hist_g,
                           float* __restrict__ hist_w, int n, int n_feat,
                           int n_bins, int n_cells) {
  __shared__ __align__(16) int key[kRows];
  __shared__ float sg[kRows];
  __shared__ float sw[kRows];
  const int f = blockIdx.x;
  const int base = blockIdx.y * blockDim.x;  // the block's first cell
  const int cell = base + threadIdx.x;
  const int me = threadIdx.x;
  const uint8_t* xf = xbt + static_cast<size_t>(f) * n;
  float acc_g = 0.0f;
  float acc_w = 0.0f;
  for (int r0 = 0; r0 < n; r0 += kRows) {
    const int m = min(kRows, n - r0);
    const int m4 = (m + 3) & ~3;
    __syncthreads();
    for (int i = threadIdx.x; i < m4; i += blockDim.x) {
      // the tail past the last row keys -1, which no cell matches
      if (i < m) {
        key[i] = node[r0 + i] * n_bins + xf[r0 + i];
        sg[i] = gw[r0 + i];
        sw[i] = w[r0 + i];
      } else {
        key[i] = -1;
      }
    }
    __syncthreads();
    for (int i = 0; i < m4; i += 4) {
      const int4 k4 = *reinterpret_cast<const int4*>(key + i);
      const int k[4] = {k4.x - base, k4.y - base, k4.z - base, k4.w - base};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // one vote a warp: only the warp that holds the row's cell
        // branches in, and there only the cell's thread adds
        if (__any_sync(0xffffffffu, k[j] == me) && k[j] == me) {
          acc_g += sg[i + j];
          acc_w += sw[i + j];
        }
      }
    }
  }
  if (cell < n_cells) {
    const int nd = cell / n_bins;
    const int b = cell - nd * n_bins;
    const size_t o = (static_cast<size_t>(nd) * n_feat + f) * n_bins + b;
    hist_g[o] = acc_g;
    hist_w[o] = acc_w;
  }
}

__global__ void boost_update_kernel(const float* __restrict__ f,
                                    const float* __restrict__ raw,
                                    const int* __restrict__ leaf, float lr,
                                    float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = __fmaf_rn(raw[leaf[i]], lr, f[i]);
}

}  // namespace

void level_histogram_launch(const uint8_t* xbt, const int* node,
                            const float* gw, const float* w, float* hist_g,
                            float* hist_w, int n, int n_feat, int n_nodes,
                            int n_bins, cudaStream_t stream) {
  const int n_cells = n_nodes * n_bins;
  if (n_feat == 0 || n_cells == 0) return;
  const int threads = std::min(kThreads, (n_cells + 31) / 32 * 32);
  const dim3 grid(n_feat, (n_cells + threads - 1) / threads);
  level_histogram_kernel<<<grid, threads, 0, stream>>>(
      xbt, node, gw, w, hist_g, hist_w, n, n_feat, n_bins, n_cells);
}

void boost_update_launch(const float* f, const float* raw, const int* leaf,
                         float lr, float* out, int n, cudaStream_t stream) {
  const int threads = 256;
  if (n == 0) return;
  boost_update_kernel<<<(n + threads - 1) / threads, threads, 0, stream>>>(
      f, raw, leaf, lr, out, n);
}
