"""Quantized-score histogram and the exact histogram top-k.

``histogram_select`` launches ``score_histogram.cu`` for CUDA tensors and
runs ``histogram_select_plain`` for CPU tensors.  Both compute the
histogram of the Pallas kernel ``score_histogram``
(repro/kernels/score_histogram/kernel.py): counts of int32 scores per bin,
negatives ignored, scores past the last bin counted in it; and, for k > 0,
the selection of the reference's ``ops.histogram_topk``: the exact top-k
of the scores, ties to the lower index (the order ``lax.top_k`` gives),
thresholded by the histogram.  Integer outputs, so both agree exactly.
The reference pads N to a multiple of its tile and falls back to its ref
for other N (a TPU layout limit); the kernel here takes any N.

``score_histogram`` and ``histogram_topk`` are the reference's two entry
points, each one launch of the same kernel (the histogram alone with
k = 0).  ``histogram_topk_selected`` is the CUDA kernel's arithmetic in
PyTorch (per-block histograms, the threshold, the shared select of
``kernels.topk_select``), for the tests and ``chip_smoke.py``.
"""

from __future__ import annotations

import torch

from repro_torch import kernels
from repro_torch.kernels import topk_select

MAX_K = topk_select.MAX_K   # largest k the kernel takes
MAX_BINS = 32768            # the block's histogram lives in shared memory


def score_histogram_ref(scores: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Plain PyTorch version: (n_bins,) int32 counts of the scores >= 0,
    each clipped to n_bins - 1."""
    live = scores >= 0
    s = torch.clamp(torch.where(live, scores, 0), 0, n_bins - 1)
    hist = torch.zeros((n_bins,), dtype=torch.int32, device=scores.device)
    return hist.index_add_(0, s.long(), live.to(torch.int32))


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


def histogram_select_plain(scores: torch.Tensor, k: int, n_bins: int):
    """Plain PyTorch version of ``histogram_select``: (values, indices,
    histogram), the first two empty when k = 0."""
    hist = score_histogram_ref(scores, n_bins)
    if k == 0:
        none = torch.empty((0,), dtype=torch.int32, device=scores.device)
        return none, none, hist
    return (*topk_from_histogram(scores, hist, k, n_bins), hist)


def histogram_topk_selected(scores: torch.Tensor, k: int, n_bins: int):
    """The CUDA kernel's arithmetic in PyTorch (for the tests and
    ``chip_smoke.py``; nothing on the main path calls it).

    Each of the ``topk_select.CLUSTER`` blocks histograms its contiguous
    range of the scores; block b sums its share of the bins.  With k > 0:
    the threshold t from the shares' suffix sums and a scan of the share
    holding t; below the last bin, K = t and each block's counts of keys
    above and equal to K come from its histogram (at t = 0 every score <= 0
    keys 0), at the last bin the radix rounds find them; then the ordered
    compaction and the sort of ``topk_select``.  Returns (values int32,
    indices int32, histogram int32), equal to ``histogram_select_plain``.
    """
    n = scores.shape[0]
    dev = scores.device
    cl = topk_select.CLUSTER
    blk = topk_select.block_of(n, dev)
    live = scores >= 0
    cell = blk * n_bins + torch.clamp(scores, 0, n_bins - 1).long()
    hist_b = torch.zeros(cl * n_bins, dtype=torch.int64, device=dev)
    hist_b.index_add_(0, cell[live], torch.ones_like(cell[live]))
    hist_b = hist_b.view(cl, n_bins)
    hist = hist_b.sum(dim=0)
    none = torch.empty((0,), dtype=torch.int32, device=dev)
    if k == 0:
        return none, none, hist.to(torch.int32)
    share = -(-n_bins // cl)
    sums = torch.nn.functional.pad(hist, (0, cl * share - n_bins)).view(
        cl, share).sum(dim=1)
    g = sums.flip(0).cumsum(0).flip(0)               # scores in shares >= b
    ok = torch.nonzero(g >= k)
    t = 0
    if len(ok):
        bs = int(ok[-1])
        g_next = int(g[bs + 1]) if bs + 1 < cl else 0
        part = hist[bs * share:(bs + 1) * share]
        ge = part.flip(0).cumsum(0).flip(0) + g_next
        t = bs * share + int((ge >= k).sum()) - 1
    s = scores.long()
    keys = torch.where(s > t, s + n_bins, torch.where(s == t, t, 0))[None]
    if t < n_bins - 1:
        kth = torch.tensor([t], device=dev)
        above = hist_b[:, t + 1:].sum(dim=1)[None]
        if t > 0:
            eq = hist_b[:, t][None]
        else:
            size = torch.bincount(blk, minlength=cl)
            eq = (size - hist_b[:, 1:].sum(dim=1))[None]
    else:
        kth, above, eq = topk_select.radix_kth(keys, k)
    idx = topk_select.select(keys, k, kth, above, eq)[1][0]
    return scores[idx], idx.to(torch.int32), hist.to(torch.int32)


def histogram_select(scores: torch.Tensor, k: int, n_bins: int):
    """The (n_bins,) int32 histogram of the (N,) int32 ``scores`` and, for
    k > 0, their exact top-k via histogram thresholding: (values int32,
    indices int32, histogram), values and indices (k,) each (empty for
    k = 0), in ``lax.top_k``'s order for non-negative scores: score
    descending, ties to the lower index."""
    if scores.dim() != 1:
        raise ValueError(f"scores must be (N,), got {tuple(scores.shape)}")
    n = scores.shape[0]
    if n_bins < 1:
        raise ValueError(f"n_bins={n_bins} must be >= 1")
    if not 0 <= k <= n:
        raise ValueError(f"k={k} must be in [0, {n}]")
    if kernels.on_cpu(scores):
        return histogram_select_plain(scores, k, n_bins)
    kernels.check_cuda_args("score_histogram", dict(scores=scores),
                            dict(scores=torch.int32))
    if n_bins > MAX_BINS:
        raise ValueError(f"n_bins={n_bins} exceeds the kernel's limit of "
                         f"{MAX_BINS}")
    if k > MAX_K:
        raise ValueError(f"histogram_topk: k={k} exceeds the kernel's limit "
                         f"of {MAX_K}")
    if n >= 1 << 31:
        raise ValueError(f"N={n} exceeds the kernel's int32 indices")
    dev = scores.device
    hist = torch.empty((n_bins,), dtype=torch.int32, device=dev)
    values = torch.empty((k,), dtype=torch.int32, device=dev)
    idx = torch.empty((k,), dtype=torch.int32, device=dev)
    kernels.extension().score_histogram(
        scores, hist, values, idx, 1 << (k - 1).bit_length() if k else 0)
    kernels.LAUNCHES["score_histogram"] += 1
    return values, idx, hist


def score_histogram(scores: torch.Tensor, *, n_bins: int = 2048
                    ) -> torch.Tensor:
    """(n_bins,) int32 histogram of the (N,) int32 ``scores``."""
    return histogram_select(scores, 0, n_bins)[2]


def histogram_topk(scores: torch.Tensor, *, k: int, n_bins: int = 2048):
    """Exact top-k of an (N,) int32 score vector via histogram thresholding.

    Returns (values int32, indices int32), (k,) each, as ``lax.top_k``
    orders them for non-negative scores: score descending, ties to the
    lower index.
    """
    n = scores.shape[0]
    if not 1 <= k <= n:
        raise ValueError(f"k={k} must be in [1, {n}]")
    return histogram_select(scores, k, n_bins)[:2]
