// Python binding of the three serving kernels.
//
// The only source of the extension that includes PyTorch's headers; the
// kernels live in plain CUDA files with C launch functions.  Each entry
// takes tensors the Python wrapper (ops.py) has already checked for
// device, dtype, shape and contiguity, plus the output tensors it
// allocated; it launches on the current stream and checks the launch.

#include <torch/extension.h>

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
                              const int* cand, float* bm25, float* mx,
                              int* cnt, int n_q, int n_lanes, int n_cand,
                              cudaStream_t stream);

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
                       const torch::Tensor& cand, torch::Tensor bm25,
                       torch::Tensor mx, torch::Tensor cnt) {
  const c10::cuda::CUDAGuard guard(lane_docs.device());
  qd_feature_gather_launch(
      lane_docs.data_ptr<int>(), lane_scores.data_ptr<float>(),
      cand.data_ptr<int>(), bm25.data_ptr<float>(), mx.data_ptr<float>(),
      cnt.data_ptr<int>(), static_cast<int>(lane_docs.size(0)),
      static_cast<int>(lane_docs.size(1)), static_cast<int>(cand.size(1)),
      c10::cuda::getCurrentCUDAStream());
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
}
