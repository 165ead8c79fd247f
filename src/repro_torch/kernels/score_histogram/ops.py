"""Quantized-score histogram and the exact histogram top-k.

``score_histogram`` launches ``score_histogram.cu`` for CUDA tensors and
runs ``score_histogram_ref`` for CPU tensors.  Both compute the function of
the Pallas kernel ``score_histogram``
(repro/kernels/score_histogram/kernel.py): counts of int32 scores per bin,
negatives ignored, scores past the last bin counted in it.  Integer counts,
so both agree exactly.  The reference pads N to a multiple of its tile and
falls back to its ref for other N (a TPU layout limit); the kernel here
takes any N.

``histogram_topk`` is the reference's ``ops.histogram_topk``: the exact
top-k of an int32 score vector, ties to the lower index (the order
``lax.top_k`` gives), thresholded by the histogram.
"""

from __future__ import annotations

import torch

from repro_torch import kernels

SMEM_LIMIT = 48 * 1024   # shared-memory limit of one block (one histogram)


def score_histogram_ref(scores: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Plain PyTorch version: (n_bins,) int32 counts of the scores >= 0,
    each clipped to n_bins - 1."""
    live = scores >= 0
    s = torch.clamp(torch.where(live, scores, 0), 0, n_bins - 1)
    hist = torch.zeros((n_bins,), dtype=torch.int32, device=scores.device)
    return hist.index_add_(0, s.long(), live.to(torch.int32))


def score_histogram(scores: torch.Tensor, *, n_bins: int = 2048
                    ) -> torch.Tensor:
    """(n_bins,) int32 histogram of the (N,) int32 ``scores``."""
    if scores.dim() != 1:
        raise ValueError(f"scores must be (N,), got {tuple(scores.shape)}")
    if n_bins < 1:
        raise ValueError(f"n_bins={n_bins} must be >= 1")
    if kernels.on_cpu(scores):
        return score_histogram_ref(scores, n_bins)
    kernels.check_cuda_args("score_histogram", dict(scores=scores),
                            dict(scores=torch.int32))
    if 4 * n_bins > SMEM_LIMIT:
        raise ValueError(f"n_bins={n_bins} exceeds one block's shared "
                         "memory")
    hist = torch.zeros((n_bins,), dtype=torch.int32, device=scores.device)
    kernels.extension().score_histogram(scores, hist)
    kernels.LAUNCHES["score_histogram"] += 1
    return hist


def topk_from_histogram(scores: torch.Tensor, hist: torch.Tensor, k: int,
                        n_bins: int):
    """The selection of ``histogram_topk`` given the scores' histogram.

    ``t`` is the largest bin with at least k scores at or above it (0 when
    fewer than k scores are >= 0).  Scores above ``t`` key as score +
    n_bins, scores equal to ``t`` as ``t``, the rest as 0; a stable
    descending sort of the keys takes the top k, ties to the lower index.
    When fewer than k scores are >= 0, zeros and negative (padding) scores
    tie at key 0 and are taken by index, as in the reference.
    """
    ge = torch.flip(torch.cumsum(torch.flip(hist, [0]), 0), [0])
    # ``ge`` is non-increasing, so its entries >= k are a prefix
    t = torch.clamp((ge >= k).sum() - 1, min=0)
    s = scores.long()
    key = torch.where(s > t, s + n_bins, 0)
    key = torch.where(s == t, s, key)
    idx = torch.sort(key, descending=True, stable=True).indices[:k]
    return scores[idx], idx.to(torch.int32)


def histogram_topk(scores: torch.Tensor, *, k: int, n_bins: int = 2048):
    """Exact top-k of an (N,) int32 score vector via histogram thresholding.

    Returns (values int32, indices int32), (k,) each, as ``lax.top_k``
    orders them for non-negative scores: score descending, ties to the
    lower index.
    """
    n = scores.shape[0]
    if not 1 <= k <= n:
        raise ValueError(f"k={k} must be in [1, {n}]")
    return topk_from_histogram(scores, score_histogram(scores, n_bins=n_bins),
                               k, n_bins)
