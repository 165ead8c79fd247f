// Python binding of the serving, Stage-0, fit and LM attention kernels.
//
// The only source of the extension that includes PyTorch's headers; the
// kernels live in plain CUDA files with C launch functions.  Each entry
// takes tensors the Python wrapper (ops.py) has already checked for
// device, dtype, shape and contiguity, plus the output tensors it
// allocated; it launches on the current stream and checks the launch.

#include <torch/extension.h>

#include <optional>

#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>

void impact_accumulate_launch(const int* tile_docs, const int* tile_terms,
                              const int* tile_imps, const int* qterms,
                              const int* lstar, int* out, int n_q, int n_tiles,
                              int cap, int n_terms, int tile_d,
                              cudaStream_t stream);
void blockmax_score_launch(const int* tile_docs, const int* tile_terms,
                           const float* tile_scores, const int* qterms,
                           const int* survive_b, const int* survive_t,
                           float* out, int n_q, int n_tiles, int cap,
                           int n_terms, int tile_d, int block_size,
                           cudaStream_t stream);
void qd_feature_gather_launch(const int* lane_docs, const float* lane_scores,
                              const int* cand, float* out, int n_q,
                              int n_lanes, int n_cand, cudaStream_t stream);
int dense_topk_launch(const float* q_emb, const float* doc_emb, int* keys,
                      float* out_scores, int64_t* out_ids, int n_q,
                      int n_docs, int d4, int k, int kp, cudaStream_t stream);
void impact_accumulate_bucketed_launch(const int* docs_b, const int* imps_b,
                                       const int* lstar, const int* lens,
                                       int* out, int n_tiles, int cap,
                                       int tile_d, cudaStream_t stream);
void blockmax_score_bucketed_launch(const int* docs_b, const float* scores_b,
                                    const int* survive_t, const int* run_docs,
                                    const float* run_scores,
                                    const int* run_start, float* out,
                                    int n_tiles, int cap, int tile_d,
                                    cudaStream_t stream);
int histogram_topk_launch(const int* scores, int* hist, int* values,
                          int* idx, int n, int n_bins, int k, int kp,
                          cudaStream_t stream);
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int b, int h, int hkv, int sq, int sk,
                           int d, int dv, long long qsb, long long qsh,
                           long long qss, long long ksb, long long ksh,
                           long long kss, long long vsb, long long vsh,
                           long long vss, float scale, int causal,
                           float* lse, cudaStream_t stream);
int flash_attention_sm90_launch(const void* q, const void* k, const void* v,
                                void* out, int b, int h, int hkv, int sq,
                                int sk, int d, int dv, long long qsb,
                                long long qsh, long long qss, long long ksb,
                                long long ksh, long long kss, long long vsb,
                                long long vsh, long long vss, float scale,
                                int causal, float* lse, cudaStream_t stream);
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* o, const void* dout,
                               const float* lse, float* delta, void* dq,
                               void* dk, void* dv_out, float* dq_part,
                               int bf16_in, int b, int h, int hkv, int sq,
                               int sk, int d, int dv, long long qsb,
                               long long qsh, long long qss, long long ksb,
                               long long ksh, long long kss, long long vsb,
                               long long vsh, long long vss, float scale,
                               int causal, cudaStream_t stream);
int level_histogram_launch(const uint8_t* xbt, const int* node,
                           const float* gw, const float* w, float* hist_g,
                           float* hist_w, int n, int n_feat, int n_nodes,
                           int n_bins, cudaStream_t stream);
int level_split_launch(const uint8_t* xbt, const int* node, const float* g,
                       const float* w, const uint8_t* fmask, float* gain,
                       int* bin, int n_trees, int n, int n_feat, int n_nodes,
                       int n_bins, float lam, float mcw, cudaStream_t stream);
int level_route_launch(const uint8_t* xbt, int* node, const float* gain,
                       const int* bin, int* feat, int* thresh, int n_trees,
                       int n, int n_feat, int n_nodes, int n_bins, int level,
                       int depth, int width, cudaStream_t stream);
void boost_update_launch(const float* f, const float* raw, const int* leaf,
                         float lr, float* out, int n, cudaStream_t stream);
int flash_decode_launch(const void* q, const void* k, const void* v,
                        const int* kv_len, float* part, void* out, int bf16,
                        int b, int h, int hkv, int t_len, int d, float scale,
                        cudaStream_t stream);
int stage0_features_launch(const float* stats, const int* df_i,
                           const float* df_f, const int* terms,
                           const float* mask, float* out, int n_q,
                           int n_slots, int vocab, cudaStream_t stream);
int stage0_forest_launch(const float* x, const float* edges, const int* feat,
                         const int* thresh, const float* leaf,
                         const float* base, float* out, int n_q, int n_feat,
                         int n_edges, int edge_sets, int n_models,
                         int n_trees, int depth, int levels, int width,
                         int leaf_width, int expm1, cudaStream_t stream);

namespace {

void impact_accumulate(const torch::Tensor& tile_docs,
                       const torch::Tensor& tile_terms,
                       const torch::Tensor& tile_imps,
                       const torch::Tensor& qterms, const torch::Tensor& lstar,
                       torch::Tensor out) {
  const c10::cuda::CUDAGuard guard(tile_docs.device());
  impact_accumulate_launch(
      tile_docs.data_ptr<int>(), tile_terms.data_ptr<int>(),
      tile_imps.data_ptr<int>(), qterms.data_ptr<int>(),
      lstar.data_ptr<int>(), out.data_ptr<int>(),
      static_cast<int>(qterms.size(0)), static_cast<int>(tile_docs.size(0)),
      static_cast<int>(tile_docs.size(1)), static_cast<int>(qterms.size(1)),
      static_cast<int>(out.size(2)), c10::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void blockmax_score(const torch::Tensor& tile_docs,
                    const torch::Tensor& tile_terms,
                    const torch::Tensor& tile_scores,
                    const torch::Tensor& qterms,
                    const torch::Tensor& survive_b,
                    const torch::Tensor& survive_t, torch::Tensor out,
                    int64_t block_size) {
  const c10::cuda::CUDAGuard guard(tile_docs.device());
  blockmax_score_launch(
      tile_docs.data_ptr<int>(), tile_terms.data_ptr<int>(),
      tile_scores.data_ptr<float>(), qterms.data_ptr<int>(),
      survive_b.data_ptr<int>(), survive_t.data_ptr<int>(),
      out.data_ptr<float>(), static_cast<int>(qterms.size(0)),
      static_cast<int>(tile_docs.size(0)), static_cast<int>(tile_docs.size(1)),
      static_cast<int>(qterms.size(1)), static_cast<int>(out.size(2)),
      static_cast<int>(block_size), c10::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void qd_feature_gather(const torch::Tensor& lane_docs,
                       const torch::Tensor& lane_scores,
                       const torch::Tensor& cand, torch::Tensor out) {
  const c10::cuda::CUDAGuard guard(lane_docs.device());
  qd_feature_gather_launch(
      lane_docs.data_ptr<int>(), lane_scores.data_ptr<float>(),
      cand.data_ptr<int>(), out.data_ptr<float>(),
      static_cast<int>(lane_docs.size(0)), static_cast<int>(lane_docs.size(1)),
      static_cast<int>(cand.size(1)), c10::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void dense_topk(const torch::Tensor& q_emb, const torch::Tensor& doc_emb,
                torch::Tensor keys, torch::Tensor out_scores,
                torch::Tensor out_ids, int64_t kp) {
  const c10::cuda::CUDAGuard guard(q_emb.device());
  const int rc = dense_topk_launch(
      q_emb.data_ptr<float>(), doc_emb.data_ptr<float>(),
      keys.data_ptr<int>(), out_scores.data_ptr<float>(),
      out_ids.data_ptr<int64_t>(), static_cast<int>(q_emb.size(0)),
      static_cast<int>(doc_emb.size(0)), static_cast<int>(q_emb.size(1) / 4),
      static_cast<int>(out_scores.size(1)), static_cast<int>(kp),
      c10::cuda::getCurrentCUDAStream());
  TORCH_CHECK(rc == 0, "dense_topk: launch refused (", rc, ")");
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void impact_accumulate_bucketed(const torch::Tensor& docs_b,
                                const torch::Tensor& imps_b,
                                const torch::Tensor& lstar,
                                const std::optional<torch::Tensor>& lens,
                                torch::Tensor out) {
  const c10::cuda::CUDAGuard guard(docs_b.device());
  impact_accumulate_bucketed_launch(
      docs_b.data_ptr<int>(), imps_b.data_ptr<int>(), lstar.data_ptr<int>(),
      lens.has_value() ? lens->data_ptr<int>() : nullptr, out.data_ptr<int>(),
      static_cast<int>(docs_b.size(0)), static_cast<int>(docs_b.size(1)),
      static_cast<int>(out.size(1)), c10::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void blockmax_score_bucketed(const torch::Tensor& docs_b,
                             const torch::Tensor& scores_b,
                             const torch::Tensor& survive_t,
                             const torch::Tensor& run_docs,
                             const torch::Tensor& run_scores,
                             const torch::Tensor& run_start,
                             torch::Tensor out) {
  const c10::cuda::CUDAGuard guard(docs_b.device());
  blockmax_score_bucketed_launch(
      docs_b.data_ptr<int>(), scores_b.data_ptr<float>(),
      survive_t.data_ptr<int>(), run_docs.data_ptr<int>(),
      run_scores.data_ptr<float>(), run_start.data_ptr<int>(),
      out.data_ptr<float>(), static_cast<int>(docs_b.size(0)),
      static_cast<int>(docs_b.size(1)), static_cast<int>(out.size(1)),
      c10::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void score_histogram(const torch::Tensor& scores, torch::Tensor hist,
                     torch::Tensor values, torch::Tensor idx, int64_t kp) {
  const c10::cuda::CUDAGuard guard(scores.device());
  const int rc = histogram_topk_launch(
      scores.data_ptr<int>(), hist.data_ptr<int>(), values.data_ptr<int>(),
      idx.data_ptr<int>(), static_cast<int>(scores.size(0)),
      static_cast<int>(hist.size(0)), static_cast<int>(values.size(0)),
      static_cast<int>(kp), c10::cuda::getCurrentCUDAStream());
  TORCH_CHECK(rc == 0, "score_histogram: launch refused (", rc, ")");
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void level_histogram(const torch::Tensor& xbt, const torch::Tensor& node,
                     const torch::Tensor& gw, const torch::Tensor& w,
                     torch::Tensor hist_g, torch::Tensor hist_w) {
  const c10::cuda::CUDAGuard guard(xbt.device());
  const int rc = level_histogram_launch(
      xbt.data_ptr<uint8_t>(), node.data_ptr<int>(), gw.data_ptr<float>(),
      w.data_ptr<float>(), hist_g.data_ptr<float>(), hist_w.data_ptr<float>(),
      static_cast<int>(xbt.size(1)), static_cast<int>(xbt.size(0)),
      static_cast<int>(hist_g.size(0)), static_cast<int>(hist_g.size(2)),
      c10::cuda::getCurrentCUDAStream());
  TORCH_CHECK(rc == 0, "level_histogram: launch refused (", rc, ")");
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void level_split(const torch::Tensor& xbt, const torch::Tensor& node,
                 const torch::Tensor& g, const torch::Tensor& w,
                 const torch::Tensor& fmask, torch::Tensor gain,
                 torch::Tensor bin, int64_t n_bins, double lam, double mcw) {
  const c10::cuda::CUDAGuard guard(xbt.device());
  const int rc = level_split_launch(
      xbt.data_ptr<uint8_t>(), node.data_ptr<int>(), g.data_ptr<float>(),
      w.data_ptr<float>(),
      reinterpret_cast<const uint8_t*>(fmask.data_ptr<bool>()),
      gain.data_ptr<float>(), bin.data_ptr<int>(),
      static_cast<int>(node.size(0)), static_cast<int>(xbt.size(1)),
      static_cast<int>(xbt.size(0)), static_cast<int>(gain.size(1)),
      static_cast<int>(n_bins), static_cast<float>(lam),
      static_cast<float>(mcw), c10::cuda::getCurrentCUDAStream());
  TORCH_CHECK(rc == 0, "level_split: launch refused (", rc, ")");
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void level_route(const torch::Tensor& xbt, torch::Tensor node,
                 const torch::Tensor& gain, const torch::Tensor& bin,
                 torch::Tensor feat, torch::Tensor thresh, int64_t level,
                 int64_t n_bins) {
  const c10::cuda::CUDAGuard guard(xbt.device());
  const int rc = level_route_launch(
      xbt.data_ptr<uint8_t>(), node.data_ptr<int>(), gain.data_ptr<float>(),
      bin.data_ptr<int>(), feat.data_ptr<int>(), thresh.data_ptr<int>(),
      static_cast<int>(node.size(0)), static_cast<int>(node.size(1)),
      static_cast<int>(xbt.size(0)), static_cast<int>(gain.size(1)),
      static_cast<int>(n_bins), static_cast<int>(level),
      static_cast<int>(feat.size(1)), static_cast<int>(feat.size(2)),
      c10::cuda::getCurrentCUDAStream());
  TORCH_CHECK(rc == 0, "level_route: launch refused (", rc, ")");
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void stage0_features(const torch::Tensor& stats, const torch::Tensor& df,
                     const torch::Tensor& terms, const torch::Tensor& mask,
                     torch::Tensor out) {
  const c10::cuda::CUDAGuard guard(stats.device());
  const bool df_float = df.scalar_type() == torch::kFloat32;
  const int rc = stage0_features_launch(
      stats.data_ptr<float>(), df_float ? nullptr : df.data_ptr<int>(),
      df_float ? df.data_ptr<float>() : nullptr, terms.data_ptr<int>(),
      mask.data_ptr<float>(), out.data_ptr<float>(),
      static_cast<int>(terms.size(0)), static_cast<int>(terms.size(1)),
      static_cast<int>(stats.size(0)), c10::cuda::getCurrentCUDAStream());
  TORCH_CHECK(rc == 0, "stage0_features: launch refused (", rc, ")");
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void stage0_forest(const torch::Tensor& x, const torch::Tensor& edges,
                   const torch::Tensor& feat, const torch::Tensor& thresh,
                   const torch::Tensor& leaf, const torch::Tensor& base,
                   torch::Tensor out, int64_t depth, bool expm1) {
  const c10::cuda::CUDAGuard guard(x.device());
  const int rc = stage0_forest_launch(
      x.data_ptr<float>(), edges.data_ptr<float>(), feat.data_ptr<int>(),
      thresh.data_ptr<int>(), leaf.data_ptr<float>(), base.data_ptr<float>(),
      out.data_ptr<float>(), static_cast<int>(x.size(0)),
      static_cast<int>(x.size(1)), static_cast<int>(edges.size(-1)),
      edges.dim() == 3 ? static_cast<int>(edges.size(0)) : 1,
      static_cast<int>(feat.size(0)), static_cast<int>(feat.size(1)),
      static_cast<int>(depth), static_cast<int>(feat.size(2)),
      static_cast<int>(feat.size(3)), static_cast<int>(leaf.size(2)),
      expm1 ? 1 : 0, c10::cuda::getCurrentCUDAStream());
  TORCH_CHECK(rc == 0, "stage0_forest: launch refused (", rc, ")");
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void boost_update(const torch::Tensor& f, const torch::Tensor& raw,
                  const torch::Tensor& leaf, double lr, torch::Tensor out) {
  const c10::cuda::CUDAGuard guard(f.device());
  boost_update_launch(f.data_ptr<float>(), raw.data_ptr<float>(),
                      leaf.data_ptr<int>(), static_cast<float>(lr),
                      out.data_ptr<float>(), static_cast<int>(f.size(0)),
                      c10::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

using PrefillLaunch = int (*)(const void*, const void*, const void*, void*,
                             int, int, int, int, int, int, int, long long,
                             long long, long long, long long, long long,
                             long long, long long, long long, long long,
                             float, int, float*, cudaStream_t);

// q, k of width d and v of width dv: the launch function takes the pairs it
// was built for and refuses any other (rc -1).  With `lse` (B, H, Sq) fp32
// the kernel also writes each row's log-sum-exp, for the backward.
void prefill(PrefillLaunch launch, const char* name, const torch::Tensor& q,
             const torch::Tensor& k, const torch::Tensor& v,
             torch::Tensor out, double scale, bool causal,
             const std::optional<torch::Tensor>& lse) {
  const c10::cuda::CUDAGuard guard(q.device());
  TORCH_CHECK(k.size(3) == q.size(3) && out.size(3) == v.size(3), name,
              ": k's width must be q's and the output's v's");
  const int rc = launch(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
      static_cast<int>(q.size(0)), static_cast<int>(q.size(1)),
      static_cast<int>(k.size(1)), static_cast<int>(q.size(2)),
      static_cast<int>(k.size(2)), static_cast<int>(q.size(3)),
      static_cast<int>(v.size(3)), q.stride(0), q.stride(1), q.stride(2),
      k.stride(0), k.stride(1), k.stride(2), v.stride(0), v.stride(1),
      v.stride(2), static_cast<float>(scale), causal ? 1 : 0,
      lse.has_value() ? lse->data_ptr<float>() : nullptr,
      c10::cuda::getCurrentCUDAStream());
  TORCH_CHECK(rc != -1, name, ": widths (", q.size(3), ", ", v.size(3),
              ") are not a pair the kernel is built for");
  TORCH_CHECK(rc == 0, name, ": launch refused (", rc, ")");
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void flash_attention(const torch::Tensor& q, const torch::Tensor& k,
                     const torch::Tensor& v, torch::Tensor out, double scale,
                     bool causal, const std::optional<torch::Tensor>& lse) {
  prefill(flash_attention_launch, "flash_attention", q, k, v, out, scale,
          causal, lse);
}

void flash_attention_sm90(const torch::Tensor& q, const torch::Tensor& k,
                          const torch::Tensor& v, torch::Tensor out,
                          double scale, bool causal,
                          const std::optional<torch::Tensor>& lse) {
  prefill(flash_attention_sm90_launch, "flash_attention_sm90", q, k, v, out,
          scale, causal, lse);
}

// The backward of either prefill kernel (the inputs' type picks the
// tensor-core or the CUDA-core kernels); `delta` is fp32 scratch of B·H·Sq,
// `dq_part` the fp32 kernel's dQ partials where Sk exceeds its KV tile.
void flash_attention_backward(const torch::Tensor& q, const torch::Tensor& k,
                              const torch::Tensor& v, const torch::Tensor& o,
                              const torch::Tensor& dout,
                              const torch::Tensor& lse, torch::Tensor delta,
                              torch::Tensor dq, torch::Tensor dk,
                              torch::Tensor dv,
                              const std::optional<torch::Tensor>& dq_part,
                              double scale, bool causal) {
  const c10::cuda::CUDAGuard guard(q.device());
  const int rc = flash_attention_bwd_launch(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
      dout.data_ptr(), lse.data_ptr<float>(), delta.data_ptr<float>(),
      dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
      dq_part.has_value() ? dq_part->data_ptr<float>() : nullptr,
      q.scalar_type() == at::kBFloat16 ? 1 : 0, static_cast<int>(q.size(0)),
      static_cast<int>(q.size(1)), static_cast<int>(k.size(1)),
      static_cast<int>(q.size(2)), static_cast<int>(k.size(2)),
      static_cast<int>(q.size(3)), static_cast<int>(v.size(3)), q.stride(0),
      q.stride(1), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
      v.stride(0), v.stride(1), v.stride(2), static_cast<float>(scale),
      causal ? 1 : 0, c10::cuda::getCurrentCUDAStream());
  TORCH_CHECK(rc != -1, "flash_attention_backward: widths (", q.size(3),
              ", ", v.size(3), ") are not a pair the kernel is built for");
  TORCH_CHECK(rc == 0, "flash_attention_backward: launch refused (", rc,
              ")");
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void flash_decode(const torch::Tensor& q, const torch::Tensor& k,
                  const torch::Tensor& v, const torch::Tensor& kv_len,
                  torch::Tensor part, torch::Tensor out, double scale) {
  const c10::cuda::CUDAGuard guard(q.device());
  const int rc = flash_decode_launch(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr<int>(),
      part.data_ptr<float>(), out.data_ptr(),
      q.scalar_type() == at::kBFloat16 ? 1 : 0, static_cast<int>(q.size(0)),
      static_cast<int>(q.size(1)), static_cast<int>(k.size(1)),
      static_cast<int>(k.size(2)), static_cast<int>(q.size(2)),
      static_cast<float>(scale), c10::cuda::getCurrentCUDAStream());
  TORCH_CHECK(rc == 0, "flash_decode: launch refused (", rc, ")");
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("impact_accumulate", &impact_accumulate,
        "SAAT impact accumulation over the bucketed mirror");
  m.def("blockmax_score", &blockmax_score,
        "DAAT block-max masked scoring over the bucketed mirror");
  m.def("qd_feature_gather", &qd_feature_gather,
        "Stage-2 (sum, max, count) lane match-reduce");
  m.def("dense_topk", &dense_topk,
        "dense top-k of q_emb @ doc_emb^T, ties to the lower doc id");
  m.def("impact_accumulate_bucketed", &impact_accumulate_bucketed,
        "single-query SAAT accumulation over a bucketed layout, each row's "
        "live prefix (all of it without lengths)");
  m.def("blockmax_score_bucketed", &blockmax_score_bucketed,
        "single-query DAAT scoring over a bucketed layout, in lane order");
  m.def("score_histogram", &score_histogram,
        "histogram of int32 scores (negatives ignored, highs clipped) and, "
        "for k > 0, their exact top-k by histogram threshold");
  m.def("level_histogram", &level_histogram,
        "per (node, feature, bin) sums of g*w and w, each cell's rows added "
        "in row order (a stable counting sort a tile)");
  m.def("level_split", &level_split,
        "each (tree, node, feature)'s best split of one tree level: the "
        "histograms, the bins' windowed prefix sums, the gains, the first "
        "maximum over the bins");
  m.def("level_route", &level_route,
        "each (tree, node)'s split (first maximum over the features, dead "
        "rule) into row `level` of feat and thresh, and the rows' new nodes "
        "in place");
  m.def("boost_update", &boost_update,
        "f + raw[leaf] * lr as one fused multiply-add a row");
  m.def("stage0_features", &stage0_features,
        "the 147 Stage-0 features of a batch of queries, the reference's "
        "float32 steps bit for bit");
  m.def("stage0_forest", &stage0_forest,
        "M stacked GBRTs' predictions: bins, descent, tree sums in the "
        "reference's order, base, and xla_expm1 where asked");
  m.def("flash_attention", &flash_attention,
        "tiled online-softmax attention on fp32 inputs (GQA, causal or not), "
        "and each row's log-sum-exp when given a tensor for it");
  m.def("flash_attention_sm90", &flash_attention_sm90,
        "online-softmax attention on bf16 inputs, wgmma fed by TMA, and each "
        "row's log-sum-exp when given a tensor for it");
  m.def("flash_attention_backward", &flash_attention_backward,
        "dq, dk, dv of prefill attention from its saved log-sum-exp (no "
        "float atomics)");
  m.def("flash_decode", &flash_decode,
        "split-KV single-token attention and the merge of its splits");
}
