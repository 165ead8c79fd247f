// One tree level of the GBRT and random-forest fits: the split histograms,
// the split choice and the routing of the rows, and the boosting update of
// the fit's running prediction.
//
// Replaces no Pallas kernel.  The reference fits its forests inside one jit
// (repro/core/gbrt.py `_fit_binned`, repro/core/random_forest.py
// `_fit_binned`, whose trees are one `vmap`), and each tree level of
// `build_tree` (repro/core/trees.py:82-129) is XLA's: `jax.ops.segment_sum`
// in `_level_histograms` (:69) gives per (node, feature, bin) cell the sum
// of g·w and of w over the cell's rows, `jnp.cumsum` the prefix sums over
// the bins, then the gains, the first maximum over (feature, bin) and the
// rows' new nodes.  XLA on the CPU adds each cell's rows one at a time, in
// increasing row order, from 0.0, and scans the bins in windows of 16.  A
// split compares those sums, and one ulp can move an argmax, so the card
// adds in the same orders: no float atomics (ROADMAP rule d).
//
// `level_kernel`: one block per (tree, feature, group of nodes), the group's
// (node, bin) cells at most kMaxCells.  The block walks the rows in tiles of
// at most kMaxRows and sorts each tile's rows by cell, stably:
//   1. each warp takes a contiguous chunk of the tile, in row order, and
//      counts its rows per cell (integer counts per (warp, cell), one
//      `__match_any_sync` a step of 32 rows; each row keeps its rank among
//      the warp's earlier rows of its cell);
//   2. the counts are scanned over (cell, warp);
//   3. every row goes to its cell's offset + its warp's offset + its rank,
//      its g·w and w beside it: each cell's rows now lie in row order;
//   4. the thread of each cell adds its run one row at a time into the
//      cell's sums, which carry from tile to tile.
// Each cell's sum is so its rows added in row order from 0.0, the
// reference's order exactly.  The longest serial chain is the largest
// cell's count (a constant feature at depth 0: every row).
//
// Two instantiations.  `level_histogram` writes the sums (n_nodes, F,
// n_bins).  `level_split` goes on, for each (node, feature) of the block:
// the bins' prefix sums in `jnp.cumsum`'s XLA-CPU order (windows of 16
// scanned left to right, the windows' totals scanned the same way, each
// later window's elements plus the running total of the ones before), the
// gain cg²/(cw+λ) + (tg−cg)²/(tw−cw+λ) − tg²/(tw+λ) in torch's order of
// operations with every operation rounded on its own (`__fmul_rn`,
// `__fdiv_rn`, ...: nothing left for the compiler to contract), the
// `min_child_weight` mask (masked cells take NEG_INF), and the first
// maximum over the bins; a feature outside the tree's mask writes (NEG_INF,
// bin 0) without reading a row, as the reference's masked cells would give.
//
// `level_route_kernel`: one block per (tree, 4,096 rows).  Each node takes
// the first maximum over the features of those candidates (so the first
// over the flattened (feature, bin) order, torch.argmax's and jnp.argmax's
// choice, NaN first), applies the dead rule (best gain <= NEG_INF/2: feature
// 0, the last bin), writes feat and thresh into row `level` of the (depth,
// 2^(depth-1)) outputs, and routes its rows: node = 2·node + (bin of the
// node's feature > its threshold), in place.
//
// What bounds them: the bytes are few (the bins, the node ids, g and w read
// once; the histograms or candidates written once: 0.2-0.6 µs at the
// fit's widths).  The sort is a few shared-memory passes a tile and the sums
// a serial chain a cell, so latency and block scheduling bound a level
// (a few µs); the host's two launches a level are what the fit pays.
//
// `boost_update_kernel`: f[i] = fma(raw[leaf[i]], lr, f[i]), one thread a
// row.  Inside the reference's jit XLA contracts `f + leaves[leaf_id]`
// with `leaves = raw * lr` into that fused multiply-add; `__fmaf_rn` is
// written out here so that no compiler choice decides it.

#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxRows = 4096;        // rows a tile
constexpr int kMaxCells = 1024;       // (node, bin) cells a block
constexpr int kRouteThreads = 512;
constexpr int kRouteRows = 4096;      // rows a routing block
constexpr unsigned kNone = 0xffffffffu;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegInf = -1e30f;     // trees.NEG_INF as float32
constexpr float kDeadAt = -5e29f;     // NEG_INF / 2 as float32

// The dynamic shared memory of a level_kernel block: the tile's sorted
// (g·w, w) pairs and packed (cell, rank) keys, the (warp, cell) counts, the
// cells' run starts and sums and, for the split, the cells' gains and each
// node's window carries.
struct Smem {
  int rows, cells, nodes, windows;
  bool split;
  __host__ __device__ size_t sorted() const { return 0; }
  __host__ __device__ size_t packed() const { return sorted() + 8ull * rows; }
  __host__ __device__ size_t counts() const { return packed() + 4ull * rows; }
  __host__ __device__ size_t starts() const {
    return counts() + 4ull * kWarps * cells;
  }
  __host__ __device__ size_t sums() const {
    return starts() + 4ull * (cells + 1);
  }
  __host__ __device__ size_t gains() const { return sums() + 8ull * cells; }
  __host__ __device__ size_t carries() const { return gains() + 4ull * cells; }
  __host__ __device__ size_t bytes() const {
    return split ? carries() + 8ull * nodes * windows : gains();
  }
};

// (a, ia) before (b, ib) in torch.argmax's order: a NaN before any number,
// then the larger value, then the lower index.  A total order, so any
// reduction tree gives the same first maximum.
__device__ __forceinline__ bool beats(float a, int ia, float b, int ib) {
  const bool na = a != a, nb = b != b;  // NaN (no fast-math: kept)
  if (na != nb) return na;
  if (!na && a != b) return a > b;
  return ia < ib;
}

// Exclusive scan of v[0..len) in place by the whole block; v[len] = total.
__device__ void block_exclusive_scan(int* v, int len, int* wsum) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (len + kThreads - 1) / kThreads;
  const int a = min(tid * per, len), b = min(a + per, len);
  int sum = 0;
  for (int i = a; i < b; ++i) sum += v[i];
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int x = lane < kWarps ? wsum[lane] : 0;
    int s = x;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const int y = __shfl_up_sync(kFull, s, o);
      if (lane >= o) s += y;
    }
    if (lane < kWarps) wsum[lane] = s - x;
    if (lane == kWarps - 1) wsum[kWarps] = s;
  }
  __syncthreads();
  int off = wsum[warp] + incl - sum;
  for (int i = a; i < b; ++i) {
    const int x = v[i];
    v[i] = off;
    off += x;
  }
  if (tid == 0) v[len] = wsum[kWarps];
}

// gridDim = (F, T, node groups).  kSplit: g is (n,) and each row's g·w is
// formed here; otherwise g holds g·w, T = 1, and out_a / out_b receive the
// (n_nodes, F, n_bins) histograms.  kSplit writes each (tree, node,
// feature)'s best gain and bin to out_a / out_bin, (T, n_nodes, F).
template <bool kSplit>
__global__ void __launch_bounds__(kThreads)
    level_kernel(const uint8_t* __restrict__ xbt, const int* __restrict__ node,
                 const float* __restrict__ g, const float* __restrict__ w,
                 const uint8_t* __restrict__ fmask, float* __restrict__ out_a,
                 float* __restrict__ out_b, int* __restrict__ out_bin, int n,
                 int n_feat, int n_nodes, int n_bins, int group, int tile,
                 float lam, float mcw) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int wsum[kWarps + 1];
  const int f = blockIdx.x;
  const int t = blockIdx.y;
  const int n0 = blockIdx.z * group;
  const int nodes = min(group, n_nodes - n0);
  const int cells = nodes * n_bins;
  const int windows = (n_bins + 15) / 16;
  const Smem lay{tile, group * n_bins, group, windows, kSplit};
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (kSplit && !fmask[static_cast<size_t>(t) * n_feat + f]) {
    for (int i = tid; i < nodes; i += kThreads) {
      const size_t o = (static_cast<size_t>(t) * n_nodes + n0 + i) * n_feat + f;
      out_a[o] = kNegInf;
      out_bin[o] = 0;
    }
    return;
  }

  float2* sorted = reinterpret_cast<float2*>(smem + lay.sorted());
  unsigned* packed = reinterpret_cast<unsigned*>(smem + lay.packed());
  int* counts = reinterpret_cast<int*>(smem + lay.counts());
  int* starts = reinterpret_cast<int*>(smem + lay.starts());
  float* sum_g = reinterpret_cast<float*>(smem + lay.sums());
  float* sum_w = sum_g + lay.cells;
  const uint8_t* xf = xbt + static_cast<size_t>(f) * n;
  const int* nt = node + static_cast<size_t>(t) * n;
  const float* wt = w + static_cast<size_t>(t) * n;
  int* mine = counts + warp * cells;

  for (int c = tid; c < cells; c += kThreads) {
    sum_g[c] = 0.0f;
    sum_w[c] = 0.0f;
  }
  const int chunk = tile / kWarps;
  for (int r0 = 0; r0 < n; r0 += tile) {
    const int m = min(tile, n - r0);
    const int lo = warp * chunk;
    const int hi = min(lo + chunk, m);
    for (int i = tid; i < kWarps * cells; i += kThreads) counts[i] = 0;
    __syncthreads();
    // 1. count: each row's cell and its rank among the warp's earlier rows
    // of that cell
    for (int s = lo; s < hi; s += 32) {
      const int i = s + lane;
      unsigned k = kNone;
      if (i < hi) {
        const unsigned nd = static_cast<unsigned>(nt[r0 + i] - n0);
        const unsigned b = xf[r0 + i];
        if (nd < static_cast<unsigned>(nodes) &&
            b < static_cast<unsigned>(n_bins))
          k = nd * n_bins + b;
      }
      const unsigned peers = __match_any_sync(kFull, k);
      const unsigned lower = peers & ((1u << lane) - 1u);
      const int prior = k != kNone ? mine[k] : 0;
      __syncwarp();
      if (k != kNone && lower == 0) mine[k] = prior + __popc(peers);
      __syncwarp();
      if (i < hi)
        packed[i] = k == kNone
                        ? kNone
                        : k | static_cast<unsigned>(prior + __popc(lower))
                                  << 16;
    }
    __syncthreads();
    // 2. scan over (cell, warp): each warp's offset within its cell, then
    // the cells' starts
    for (int c = tid; c < cells; c += kThreads) {
      int run = 0;
#pragma unroll
      for (int q = 0; q < kWarps; ++q) {
        const int x = counts[q * cells + c];
        counts[q * cells + c] = run;
        run += x;
      }
      starts[c] = run;
    }
    __syncthreads();
    block_exclusive_scan(starts, cells, wsum);
    __syncthreads();
    // 3. place each row at its cell's start + its warp's offset + its rank
    for (int s = lo; s < hi; s += 32) {
      const int i = s + lane;
      if (i < hi) {
        const unsigned p = packed[i];
        if (p != kNone) {
          const unsigned k = p & 0xffffu;
          const int pos = starts[k] + mine[k] + static_cast<int>(p >> 16);
          const float wr = wt[r0 + i];
          const float gr = kSplit ? __fmul_rn(g[r0 + i], wr) : g[r0 + i];
          sorted[pos] = make_float2(gr, wr);
        }
      }
    }
    __syncthreads();
    // 4. each cell's run added in row order
    for (int c = tid; c < cells; c += kThreads) {
      float ag = sum_g[c], aw = sum_w[c];
      const int e = starts[c + 1];
#pragma unroll 4
      for (int i = starts[c]; i < e; ++i) {
        const float2 v = sorted[i];
        ag = __fadd_rn(ag, v.x);
        aw = __fadd_rn(aw, v.y);
      }
      sum_g[c] = ag;
      sum_w[c] = aw;
    }
    __syncthreads();
  }

  if (!kSplit) {
    for (int c = tid; c < cells; c += kThreads) {
      const int nd = c / n_bins;
      const int b = c - nd * n_bins;
      const size_t o = (static_cast<size_t>(n0 + nd) * n_feat + f) * n_bins + b;
      out_a[o] = sum_g[c];
      out_b[o] = sum_w[c];
    }
    return;
  }

  float* gains = reinterpret_cast<float*>(smem + lay.gains());
  float* carry_g = reinterpret_cast<float*>(smem + lay.carries());
  float* carry_w = carry_g + group * windows;
  // the bins' prefix sums: each window of 16 scanned left to right, in
  // place
  for (int p = tid; p < nodes * windows; p += kThreads) {
    const int nd = p / windows;
    const int j = p - nd * windows;
    const int base = nd * n_bins + j * 16;
    const int len = min(16, n_bins - j * 16);
    float sg = sum_g[base], sw = sum_w[base];
    for (int i = 1; i < len; ++i) {
      sg = __fadd_rn(sg, sum_g[base + i]);
      sw = __fadd_rn(sw, sum_w[base + i]);
      sum_g[base + i] = sg;
      sum_w[base + i] = sw;
    }
  }
  __syncthreads();
  // the windows' totals scanned left to right: carry[j] = total of windows
  // 0..j
  for (int nd = tid; nd < nodes; nd += kThreads) {
    float cg = 0.0f, cw = 0.0f;
    for (int j = 0; j + 1 < windows; ++j) {
      const int last = nd * n_bins + j * 16 + 15;
      cg = j == 0 ? sum_g[last] : __fadd_rn(cg, sum_g[last]);
      cw = j == 0 ? sum_w[last] : __fadd_rn(cw, sum_w[last]);
      carry_g[nd * windows + j] = cg;
      carry_w[nd * windows + j] = cw;
    }
  }
  __syncthreads();
  for (int c = tid; c < cells; c += kThreads) {
    const int nd = c / n_bins;
    const int j = (c - nd * n_bins) / 16;
    float cg = sum_g[c], cw = sum_w[c];
    if (j > 0) {
      cg = __fadd_rn(cg, carry_g[nd * windows + j - 1]);
      cw = __fadd_rn(cw, carry_w[nd * windows + j - 1]);
    }
    const int last = nd * n_bins + n_bins - 1;
    float tg = sum_g[last], tw = sum_w[last];
    if (windows > 1) {
      tg = __fadd_rn(tg, carry_g[nd * windows + windows - 2]);
      tw = __fadd_rn(tw, carry_w[nd * windows + windows - 2]);
    }
    const float rest_g = __fsub_rn(tg, cg);
    const float rest_w = __fsub_rn(tw, cw);
    const float left = __fdiv_rn(__fmul_rn(cg, cg), __fadd_rn(cw, lam));
    const float right =
        __fdiv_rn(__fmul_rn(rest_g, rest_g), __fadd_rn(rest_w, lam));
    const float whole = __fdiv_rn(__fmul_rn(tg, tg), __fadd_rn(tw, lam));
    const float gain = __fsub_rn(__fadd_rn(left, right), whole);
    const bool ok = cw >= mcw && rest_w >= mcw;
    gains[c] = ok ? gain : kNegInf;
  }
  __syncthreads();
  // each node's first maximum over the bins, one warp a node
  for (int nd = warp; nd < nodes; nd += kWarps) {
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int i = lane; i < n_bins; i += 32) {
      const float v = gains[nd * n_bins + i];
      if (beats(v, i, bv, bi)) {
        bv = v;
        bi = i;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(kFull, bv, o);
      const int oi = __shfl_xor_sync(kFull, bi, o);
      if (beats(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      const size_t o = (static_cast<size_t>(t) * n_nodes + n0 + nd) * n_feat + f;
      out_a[o] = bv;
      out_bin[o] = bi;
    }
  }
}

// gridDim = (row blocks, T).  Every block takes each node's split from the
// candidates (the writes of feat and thresh are block 0's), then routes
// its rows in place.
__global__ void __launch_bounds__(kRouteThreads)
    level_route_kernel(const uint8_t* __restrict__ xbt, int* __restrict__ node,
                       const float* __restrict__ gain,
                       const int* __restrict__ bin, int* __restrict__ feat,
                       int* __restrict__ thresh, int n, int n_feat,
                       int n_nodes, int n_bins, int level, int depth,
                       int width) {
  extern __shared__ int split[];  // [n_nodes] features, [n_nodes] bins
  const int t = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int nd = warp; nd < n_nodes; nd += n_warps) {
    const size_t row = (static_cast<size_t>(t) * n_nodes + nd) * n_feat;
    float bv = -INFINITY;
    int bf = INT_MAX, bb = 0;
    for (int f = lane; f < n_feat; f += 32) {
      const float v = gain[row + f];
      if (beats(v, f, bv, bf)) {
        bv = v;
        bf = f;
        bb = bin[row + f];
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(kFull, bv, o);
      const int of = __shfl_xor_sync(kFull, bf, o);
      const int ob = __shfl_xor_sync(kFull, bb, o);
      if (beats(ov, of, bv, bf)) {
        bv = ov;
        bf = of;
        bb = ob;
      }
    }
    if (lane == 0) {
      const bool dead = bv <= kDeadAt;
      const int sf = dead ? 0 : bf;
      const int sb = dead ? n_bins - 1 : bb;
      split[nd] = sf;
      split[n_nodes + nd] = sb;
      if (blockIdx.x == 0) {
        const size_t o = (static_cast<size_t>(t) * depth + level) * width + nd;
        feat[o] = sf;
        thresh[o] = sb;
      }
    }
  }
  __syncthreads();
  int* nt = node + static_cast<size_t>(t) * n;
  const int r1 = min(n, (blockIdx.x + 1) * kRouteRows);
  for (int r = blockIdx.x * kRouteRows + threadIdx.x; r < r1;
       r += blockDim.x) {
    const int nd = nt[r];
    const int x = xbt[static_cast<size_t>(split[nd]) * n + r];
    nt[r] = 2 * nd + (x > split[n_nodes + nd] ? 1 : 0);
  }
}

__global__ void boost_update_kernel(const float* __restrict__ f,
                                    const float* __restrict__ raw,
                                    const int* __restrict__ leaf, float lr,
                                    float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = __fmaf_rn(raw[leaf[i]], lr, f[i]);
}

// Launches one level_kernel instantiation: node groups of at most
// kMaxCells cells, row tiles of at most kMaxRows (a multiple of the block's
// 256 threads).  Returns the CUDA error of the launch, 0 when it went out.
template <bool kSplit>
int launch_level(const uint8_t* xbt, const int* node, const float* g,
                 const float* w, const uint8_t* fmask, float* out_a,
                 float* out_b, int* out_bin, int n_trees, int n, int n_feat,
                 int n_nodes, int n_bins, float lam, float mcw,
                 cudaStream_t stream) {
  if (n_trees == 0 || n_feat == 0 || n_nodes == 0) return 0;
  const int group = std::max(1, std::min(n_nodes, kMaxCells / n_bins));
  const int groups = (n_nodes + group - 1) / group;
  const int tile =
      std::min(kMaxRows, (std::max(n, 1) + kThreads - 1) / kThreads * kThreads);
  const Smem lay{tile, group * n_bins, group, (n_bins + 15) / 16, kSplit};
  const size_t bytes = lay.bytes();
  cudaError_t err = cudaFuncSetAttribute(
      level_kernel<kSplit>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_feat, n_trees, groups);
  level_kernel<kSplit><<<grid, kThreads, bytes, stream>>>(
      xbt, node, g, w, fmask, out_a, out_b, out_bin, n, n_feat, n_nodes,
      n_bins, group, tile, lam, mcw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

int level_histogram_launch(const uint8_t* xbt, const int* node,
                           const float* gw, const float* w, float* hist_g,
                           float* hist_w, int n, int n_feat, int n_nodes,
                           int n_bins, cudaStream_t stream) {
  return launch_level<false>(xbt, node, gw, w, nullptr, hist_g, hist_w,
                             nullptr, 1, n, n_feat, n_nodes, n_bins, 0.0f,
                             0.0f, stream);
}

int level_split_launch(const uint8_t* xbt, const int* node, const float* g,
                       const float* w, const uint8_t* fmask, float* gain,
                       int* bin, int n_trees, int n, int n_feat, int n_nodes,
                       int n_bins, float lam, float mcw, cudaStream_t stream) {
  return launch_level<true>(xbt, node, g, w, fmask, gain, nullptr, bin,
                            n_trees, n, n_feat, n_nodes, n_bins, lam, mcw,
                            stream);
}

int level_route_launch(const uint8_t* xbt, int* node, const float* gain,
                       const int* bin, int* feat, int* thresh, int n_trees,
                       int n, int n_feat, int n_nodes, int n_bins, int level,
                       int depth, int width, cudaStream_t stream) {
  if (n_trees == 0 || n == 0) return 0;
  const dim3 grid((n + kRouteRows - 1) / kRouteRows, n_trees);
  const size_t bytes = 8ull * n_nodes;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        level_route_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  level_route_kernel<<<grid, kRouteThreads, bytes, stream>>>(
      xbt, node, gain, bin, feat, thresh, n, n_feat, n_nodes, n_bins, level,
      depth, width);
  return static_cast<int>(cudaGetLastError());
}

void boost_update_launch(const float* f, const float* raw, const int* leaf,
                         float lr, float* out, int n, cudaStream_t stream) {
  const int threads = 256;
  if (n == 0) return;
  boost_update_kernel<<<(n + threads - 1) / threads, threads, 0, stream>>>(
      f, raw, leaf, lr, out, n);
}
