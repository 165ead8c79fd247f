// Stage-0 of the cascade and of the ISN step: the 147 pre-retrieval
// features of a batch, and the stacked GBRTs' predictions.
//
// Replaces no Pallas kernel.  The reference computes both inside its jit
// (repro/core/features.py `extract`, repro/core/gbrt.py `predict_stacked`,
// repro/isn/shard.py `_stage0`), where XLA fuses them into a few loops.
// The port ran them as plain tensor ops: some 500 launches a cascade batch
// and 900 an ISN step, each a few µs of the host's time and a fraction of
// that on the card.  Here each is one launch.
//
// Exactness.  A route compares a prediction with a threshold, and a tree
// compares a feature with a bin edge taken from the reference's own
// features, so every value is the reference's float32 bit for bit: each
// add, multiply and divide is written as `__fadd_rn`, `__fmul_rn`,
// `__fdiv_rn` (nvcc may contract nothing the reference does not), and a
// fused multiply-add `__fmaf_rn` exactly where the reference's compiled
// program fuses one (the plain versions' `_fma`).
//
// `stage0_features_kernel`: one block of 64 threads a query.  Thread c < 36
// gathers statistic column c of the query's L term rows and reduces it left
// to right over the L slots, padded slots included, as `_sum_terms` does:
// max and min of the masked values (±1e30 where masked; NaN wins, +0 above
// -0, as the reference's max and min reduce), the mean (Σ stats·m / n) and
// the variance (Σ (d·d)·m / n).  Thread 36 computes the term count (the
// mask summed, at least 1) and log1p of the summed and of the least df, in
// `xla_log1p`'s polynomial.  What bounds it: the bytes are a few KB a query
// (L rows of 36 statistics); the serial chains are L long, so latency and
// one launch are the cost.
//
// `stage0_forest_kernel`: one block of 256 threads a query, for all M
// stacked models at once.
//   1. bins: each warp takes (edge set, feature) rows, 8 at a time (their
//      loads in flight together); its lanes compare the feature with 32
//      edges at a time and a ballot counts those below (NaN: none).  Edges
//      are per model, or one set shared by the models;
//   2. descent: a thread per (model, tree) walks node = 2·node + (bin of
//      the node's feature > its threshold) for `depth` levels and puts the
//      leaf's value in shared memory;
//   3. sum: a thread per model adds its trees' leaves in `_sum_trees`'s
//      order — up to 32 trees XLA-CPU's 8-lane loop (left to right below
//      16 trees unless a multiple of 8), more its windows of 32 with
//      ⌊pad/2⌋ zeros before and the rest after, the window sums left to
//      right (windowed again past 32 windows) — then adds the base and,
//      where asked, takes `xla_expm1`.
// What bounds it: the edges, trees and leaves (some 200 KB at the cells'
// shapes, from L2 after the first block) and the depth's chain of dependent
// loads; a few µs a launch.

#include <cuda_runtime.h>

#include <cassert>
#include <cstdint>

namespace {

constexpr int kStats = 36;
constexpr int kFeatures = 4 * kStats + 3;
constexpr int kFeatureThreads = 64;
constexpr int kForestThreads = 256;
constexpr int kBinRows = 8;           // edge rows a warp counts at once
constexpr unsigned kFull = 0xffffffffu;

// float32 constants of the compiled program (features.py / ops.py)
constexpr float kMinNormal = 0x1.0p-126f;
constexpr float kSqrtHf = 0x1.6a09e6p-1f;
constexpr float kLogQ1 = -0x1.bd0106p-13f;
constexpr float kLogQ2 = 0x1.63p-1f;
__constant__ float kLogP[9] = {
    0x1.204376p-4f, -0x1.d7a37p-4f, 0x1.de4a34p-4f, -0x1.fcba9ep-4f,
    0x1.23d37ep-3f, -0x1.555cap-3f, 0x1.999d58p-3f, -0x1.fffff8p-3f,
    0x1.555554p-2f};
__constant__ float kL1pNum[7] = {
    0x1.7bc096p-15f, 0x1.fe818ap-2f, 0x1.a509f4p+2f, 0x1.de9738p+4f,
    0x1.e798ecp+5f, 0x1.c8e75ap+5f, 0x1.40a202p+4f};
__constant__ float kL1pDen[6] = {
    0x1.e2035ap+3f, 0x1.4c30b6p+6f, 0x1.bb865ap+7f, 0x1.351946p+8f,
    0x1.b0db14p+7f, 0x1.e0f304p+5f};
constexpr float kL1pSmall = 0x1.a8279ap-2f;
constexpr float kExpLo = -0x1.5f3334p+6f;
constexpr float kExpHi = 0x1.633334p+6f;
constexpr float kLog2e = 0x1.715476p+0f;
constexpr float kExpC1 = 0x1.63p-1f;
constexpr float kExpC2 = -0x1.bd0106p-13f;
__constant__ float kExpP[6] = {
    0x1.a0d2cep-13f, 0x1.6e879cp-10f, 0x1.111210p-7f, 0x1.555382p-5f,
    0x1.555554p-3f, 0x1.0p-1f};
constexpr float kTanhClamp = 0x1.ffec88p+2f;
constexpr float kTanhSmall = 0x1.a36e2ep-12f;
__constant__ float kTanhNum[7] = {
    -0x1.3e4b80p-52f, 0x1.c266fcp-43f, -0x1.7a6ffep-34f, 0x1.b80082p-25f,
    0x1.f28694p-17f, 0x1.4e1bdap-11f, 0x1.40b3b8p-8f};
__constant__ float kTanhDen[4] = {
    0x1.41a7b0p-20f, 0x1.f12bacp-14f, 0x1.29540ap-9f, 0x1.40b3bap-8f};
constexpr float kBig = 1e30f;

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

// torch.clamp(v, lo, hi): NaN through
__device__ __forceinline__ float clamp_f(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ float xla_log(float v) {
  const float c = v < kMinNormal ? kMinNormal : v;
  const int bits = __float_as_int(c);
  float e = __fadd_rn(__int2float_rn((bits >> 23) - 127), 1.0f);
  const float m = __int_as_float((bits & 0x7fffff) | 0x3f000000);
  const bool small_m = m < kSqrtHf;
  const float z = __fadd_rn(__fadd_rn(m, -1.0f), small_m ? m : 0.0f);
  e = __fsub_rn(e, small_m ? 1.0f : 0.0f);
  const float z2 = __fmul_rn(z, z);
  const float z3 = __fmul_rn(z2, z);
  float y = __fmaf_rn(__fmaf_rn(z, kLogP[0], kLogP[1]), z, kLogP[2]);
  const float y1 = __fmaf_rn(__fmaf_rn(z, kLogP[3], kLogP[4]), z, kLogP[5]);
  const float y2 = __fmaf_rn(__fmaf_rn(z, kLogP[6], kLogP[7]), z, kLogP[8]);
  y = __fmaf_rn(__fmaf_rn(y, z3, y1), z3, y2);
  y = __fmaf_rn(y, z3, __fmul_rn(e, kLogQ1));
  float out = __fmaf_rn(e, kLogQ2, __fadd_rn(__fmaf_rn(z2, -0.5f, z), y));
  if (v == __int_as_float(0x7f800000)) out = v;
  if (v == 0.0f) out = __int_as_float(0xff800000);
  if (v < 0.0f) out = nan_f();
  return out;
}

__device__ float xla_log1p(float x) {
  const float big = xla_log(__fadd_rn(x, 1.0f));
  float num = kL1pNum[0];
#pragma unroll
  for (int i = 1; i < 7; ++i) num = __fmaf_rn(num, x, kL1pNum[i]);
  float den = 1.0f;
#pragma unroll
  for (int i = 0; i < 6; ++i) den = __fmaf_rn(den, x, kL1pDen[i]);
  const float x2 = __fmul_rn(x, x);
  const float small = __fadd_rn(
      x, __fmaf_rn(x2, -0.5f,
                   __fmul_rn(__fmul_rn(x, x2), __fdiv_rn(num, den))));
  return fabsf(x) < kL1pSmall ? small : big;
}

__device__ __forceinline__ float flush(float v) {
  return fabsf(v) < kMinNormal ? 0.0f : v;
}

__device__ float xla_exp(float x) {
  const float c = clamp_f(x, kExpLo, kExpHi);
  const float n = clamp_f(floorf(__fmaf_rn(c, kLog2e, 0.5f)), -127.0f,
                          127.0f);
  const float r = __fmaf_rn(n, -kExpC2, __fmaf_rn(n, -kExpC1, c));
  float z = __fmaf_rn(r, kExpP[0], kExpP[1]);
#pragma unroll
  for (int i = 2; i < 6; ++i) z = __fmaf_rn(z, r, kExpP[i]);
  z = __fadd_rn(__fmaf_rn(z, __fmul_rn(r, r), r), 1.0f);
  const float pow2 = __int_as_float((__float2int_rz(n) + 127) << 23);
  return flush(__fmul_rn(z, pow2));
}

__device__ float xla_tanh(float x) {
  const float xc = clamp_f(x, -kTanhClamp, kTanhClamp);
  const float x2 = __fmul_rn(xc, xc);
  float num = kTanhNum[0];
#pragma unroll
  for (int i = 1; i < 7; ++i) num = __fmaf_rn(x2, num, kTanhNum[i]);
  float den = kTanhDen[0];
#pragma unroll
  for (int i = 1; i < 4; ++i) den = __fmaf_rn(x2, den, kTanhDen[i]);
  return fabsf(x) < kTanhSmall ? x : __fdiv_rn(__fmul_rn(xc, num), den);
}

__device__ float xla_expm1(float x) {
  const float half = flush(__fmul_rn(x, 0.5f));
  const float e = xla_exp(x);
  const float small = __fmul_rn(xla_tanh(half), __fadd_rn(e, 1.0f));
  const float out = fabsf(x) > 0.5f ? __fsub_rn(e, 1.0f) : small;
  return half == 0.0f ? x : out;
}

// The reference's max and min reduce: NaN wins, +0 above -0 (min: -0).
__device__ __forceinline__ float max_ieee(float a, float b) {
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  if (a == b) return signbit(a) ? b : a;
  return a > b ? a : b;
}

__device__ __forceinline__ float min_ieee(float a, float b) {
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  if (a == b) return signbit(a) ? a : b;
  return a < b ? a : b;
}

// A row index as torch indexes with it: negative ids count from the end.
// One outside [-n, n), where torch's indexing raises, fails the launch
// with a device-side assertion, as torch's own CUDA indexing does.
__device__ __forceinline__ int table_row(int t, int n) {
  assert(t >= -n && t < n);
  return t < 0 ? t + n : t;
}

__global__ void stage0_features_kernel(
    const float* __restrict__ stats, const int* __restrict__ df_i,
    const float* __restrict__ df_f, const int* __restrict__ terms,
    const float* __restrict__ mask, float* __restrict__ out, int n_slots,
    int vocab) {
  const int q = blockIdx.x;
  const int c = threadIdx.x;
  if (c > kStats) return;
  const int* tq = terms + static_cast<size_t>(q) * n_slots;
  const float* mq = mask + static_cast<size_t>(q) * n_slots;
  float* oq = out + static_cast<size_t>(q) * kFeatures;
  float n_terms = mq[0];
  for (int l = 1; l < n_slots; ++l) n_terms = __fadd_rn(n_terms, mq[l]);
  n_terms = n_terms < 1.0f ? 1.0f : n_terms;     // torch.clamp(min=1)

  if (c < kStats) {
    float mx = 0.0f, mn = 0.0f, sum = 0.0f;
    for (int l = 0; l < n_slots; ++l) {
      const float m = mq[l];
      const float v = stats[static_cast<size_t>(table_row(tq[l], vocab)) *
                            kStats + c];
      const float hi = m > 0.0f ? v : -kBig;
      const float lo = m > 0.0f ? v : kBig;
      const float p = __fmul_rn(v, m);
      mx = l ? max_ieee(mx, hi) : hi;
      mn = l ? min_ieee(mn, lo) : lo;
      sum = l ? __fadd_rn(sum, p) : p;
    }
    const float mean = __fdiv_rn(sum, n_terms);
    float sq = 0.0f;
    for (int l = 0; l < n_slots; ++l) {
      const float v = stats[static_cast<size_t>(table_row(tq[l], vocab)) *
                            kStats + c];
      const float d = __fsub_rn(v, mean);
      const float p = __fmul_rn(__fmul_rn(d, d), mq[l]);
      sq = l ? __fadd_rn(sq, p) : p;
    }
    oq[c] = mx;
    oq[kStats + c] = mn;
    oq[2 * kStats + c] = mean;
    oq[3 * kStats + c] = __fdiv_rn(sq, n_terms);
    return;
  }
  // the three query-level features
  float sum_df = 0.0f, min_df = 0.0f;
  for (int l = 0; l < n_slots; ++l) {
    const int t = table_row(tq[l], vocab);
    const float d = df_f ? df_f[t] : __int2float_rn(df_i[t]);
    const float m = mq[l];
    const float p = __fmul_rn(d, m);
    const float lo = m > 0.0f ? d : kBig;
    sum_df = l ? __fadd_rn(sum_df, p) : p;
    min_df = l ? min_ieee(min_df, lo) : lo;
  }
  oq[4 * kStats] = n_terms;
  oq[4 * kStats + 1] = xla_log1p(sum_df);
  oq[4 * kStats + 2] = xla_log1p(min_df);
}

// Left to right: s = v[0], s = s + v[1], ...
__device__ float seq_sum(const float* v, int n) {
  float s = v[0];
  for (int i = 1; i < n; ++i) s = __fadd_rn(s, v[i]);
  return s;
}

// trees._vector_sum: a row of at most 32.
__device__ float vector_sum(const float* v, int t) {
  if (t < 16 && t % 8) return seq_sum(v, t);
  const int full = t / 8 * 8;
  float lanes[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) lanes[j] = v[j];
  for (int i = 8; i < full; i += 8) {
#pragma unroll
    for (int j = 0; j < 8; ++j) lanes[j] = __fadd_rn(lanes[j], v[i + j]);
  }
#pragma unroll
  for (int w = 4; w >= 1; w /= 2) {
#pragma unroll
    for (int j = 0; j < w; ++j) lanes[j] = __fadd_rn(lanes[j], lanes[j + w]);
  }
  float s = lanes[0];
  for (int i = full; i < t; ++i) s = __fadd_rn(s, v[i]);
  return s;
}

// trees._sum_trees over v[0..t), which it may overwrite: _vector_sum up to
// 32, else _window_sum — zero-padded windows of 32 (⌊pad/2⌋ zeros first),
// each summed left to right into v[w] (window w + 1 starts at or after
// index 32(w + 1) - 15 > w, so the writes never overtake the reads), then
// the window sums left to right, or windowed again past 32 of them.
__device__ float tree_sum(float* v, int t) {
  if (t <= 32) return vector_sum(v, t);
  for (;;) {
    const int n = (t + 31) / 32;
    const int lo = (n * 32 - t) / 2;
    for (int w = 0; w < n; ++w) {
      float s = 0.0f;
      for (int k = 0; k < 32; ++k) {
        const int i = w * 32 + k - lo;
        const float x = (i >= 0 && i < t) ? v[i] : 0.0f;
        s = k ? __fadd_rn(s, x) : x;
      }
      v[w] = s;
    }
    if (n <= 32) return seq_sum(v, n);
    t = n;
  }
}

__global__ void stage0_forest_kernel(
    const float* __restrict__ x, const float* __restrict__ edges,
    const int* __restrict__ feat, const int* __restrict__ thresh,
    const float* __restrict__ leaf, const float* __restrict__ base,
    float* __restrict__ out, int n_q, int n_feat, int n_edges,
    int edge_sets, int n_models, int n_trees, int depth, int levels,
    int width, int leaf_width, int expm1) {
  extern __shared__ float smem[];
  float* xs = smem;                                            // F
  int* bins = reinterpret_cast<int*>(smem + n_feat);           // sets x F
  float* leaves = smem + n_feat + edge_sets * n_feat;          // M x T
  const int q = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int f = tid; f < n_feat; f += blockDim.x)
    xs[f] = x[static_cast<size_t>(q) * n_feat + f];
  __syncthreads();

  // 1. a feature's bin: its count of edges below it, kBinRows rows a warp
  //    at a time (their loads in flight together)
  const int rows = edge_sets * n_feat;
  for (int r0 = warp * kBinRows; r0 < rows; r0 += n_warps * kBinRows) {
    int count[kBinRows] = {};
    for (int b = 0; b < n_edges; b += 32) {
      float e[kBinRows];
#pragma unroll
      for (int k = 0; k < kBinRows; ++k) {
        const int r = r0 + k;
        e[k] = r < rows && b + lane < n_edges
                   ? edges[static_cast<size_t>(r) * n_edges + b + lane]
                   : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < kBinRows; ++k) {
        const int r = r0 + k;
        const bool above =
            r < rows && b + lane < n_edges && xs[r % n_feat] > e[k];
        count[k] += __popc(__ballot_sync(kFull, above));
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < kBinRows; ++k)
        if (r0 + k < rows) bins[r0 + k] = count[k];
    }
  }
  __syncthreads();

  // 2. every (model, tree)'s leaf
  for (int j = tid; j < n_models * n_trees; j += blockDim.x) {
    const int m = j / n_trees;
    const int* b = bins + (edge_sets > 1 ? m : 0) * n_feat;
    const size_t tree = static_cast<size_t>(j) * levels * width;
    int node = 0;
    for (int d = 0; d < depth; ++d) {
      const size_t at = tree + static_cast<size_t>(d) * width + node;
      const int f = table_row(feat[at], n_feat);
      node = 2 * node + (b[f] > thresh[at] ? 1 : 0);
    }
    leaves[j] = leaf[static_cast<size_t>(j) * leaf_width + node];
  }
  __syncthreads();

  // 3. each model's sum, its base, its expm1
  for (int m = tid; m < n_models; m += blockDim.x) {
    float p = __fadd_rn(base[m], tree_sum(leaves + m * n_trees, n_trees));
    if (expm1) p = xla_expm1(p);
    out[static_cast<size_t>(m) * n_q + q] = p;
  }
}

}  // namespace

int stage0_features_launch(const float* stats, const int* df_i,
                           const float* df_f, const int* terms,
                           const float* mask, float* out, int n_q,
                           int n_slots, int vocab, cudaStream_t stream) {
  if (n_q == 0) return 0;
  stage0_features_kernel<<<n_q, kFeatureThreads, 0, stream>>>(
      stats, df_i, df_f, terms, mask, out, n_slots, vocab);
  return static_cast<int>(cudaGetLastError());
}

int stage0_forest_launch(const float* x, const float* edges, const int* feat,
                         const int* thresh, const float* leaf,
                         const float* base, float* out, int n_q, int n_feat,
                         int n_edges, int edge_sets, int n_models,
                         int n_trees, int depth, int levels, int width,
                         int leaf_width, int expm1, cudaStream_t stream) {
  if (n_q == 0 || n_models == 0) return 0;
  const size_t bytes =
      4ull * (n_feat + static_cast<size_t>(edge_sets) * n_feat +
              static_cast<size_t>(n_models) * n_trees);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        stage0_forest_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  stage0_forest_kernel<<<n_q, kForestThreads, bytes, stream>>>(
      x, edges, feat, thresh, leaf, base, out, n_q, n_feat, n_edges,
      edge_sets, n_models, n_trees, depth, levels, width, leaf_width, expm1);
  return static_cast<int>(cudaGetLastError());
}
