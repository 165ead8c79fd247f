"""Array-based decision-tree ensembles — inference in PyTorch.

The reference (``repro.core.trees``) stores LightGBM-style complete binary
trees of fixed depth as dense arrays, so inference is a branch-free
O(depth) gather chain.  Feature values are quantile-binned to uint8
(``apply_bins``) and split thresholds are bin indices.  Training is not
ported yet: the port takes forests fitted by the reference
(``repro_torch.convert``).

Exactness: the per-row sum over trees follows the reference's compiled
reduction order (``_sum_trees``), so boosted predictions agree bit for bit
at every tree count, at the repo's depths — a route compares a prediction with a threshold that
is itself one of the reference's predictions.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Forest(NamedTuple):
    """A stacked ensemble of complete binary trees.

    feat:   (T, depth, 2**(depth-1)) int32 — split feature per node
    thresh: (T, depth, 2**(depth-1)) int32 — split bin; go right if bin > thresh
    leaf:   (T, 2**depth) float32 — leaf scores
    (each with a leading (M,) model axis when stacked)
    """
    feat: torch.Tensor
    thresh: torch.Tensor
    leaf: torch.Tensor


def apply_bins(x: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """(n, F) raw floats -> (n, F) uint8 bin ids (count of edges below)."""
    bins = (x[:, :, None] > edges[None, :, :]).sum(dim=-1)
    return bins.to(torch.uint8)


def _seq_sum(x: torch.Tensor) -> torch.Tensor:
    s = x[..., 0]
    for i in range(1, x.shape[-1]):
        s = s + x[..., i]
    return s


def _vector_sum(x: torch.Tensor) -> torch.Tensor:
    """A row of at most 32 summed as XLA's compiled CPU loop does: below 16
    elements, unless a multiple of 8, left to right; otherwise 8 lanes,
    lane j taking elements j, j + 8, ... of the first 8 * (t // 8) in
    order, the lanes folded by halving (lane j + 4 into j, then j + 2,
    then j + 1), and the remaining t % 8 elements added left to right."""
    t = x.shape[-1]
    if t < 16 and t % 8:
        return _seq_sum(x)
    v = t // 8 * 8
    lanes = x[..., 0:8]
    for i in range(8, v, 8):
        lanes = lanes + x[..., i:i + 8]
    w = 8
    while w > 1:
        w //= 2
        lanes = lanes[..., :w] + lanes[..., w:2 * w]
    s = lanes[..., 0]
    for i in range(v, t):
        s = s + x[..., i]
    return s


def _window_sum(x: torch.Tensor) -> torch.Tensor:
    """A row longer than 32 summed as XLA's tree-reduction rewrite does:
    zero-padded to n = ceil(t / 32) windows of 32, floor(pad / 2) zeros
    before and the rest after; each window summed left to right; the n
    window sums then added left to right (windowed again if n > 32)."""
    t = x.shape[-1]
    n = -(-t // 32)
    pad = n * 32 - t
    x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
    parts = torch.stack([_seq_sum(x[..., 32 * i:32 * i + 32])
                         for i in range(n)], dim=-1)
    return _seq_sum(parts) if n <= 32 else _window_sum(parts)


def _sum_trees(leaves: torch.Tensor) -> torch.Tensor:
    """Sum over the last (tree) axis in the reference's compiled order, so
    boosted predictions equal ``repro.core.trees.forest_predict_binned`` /
    ``forest_predict_stacked`` bit for bit at every tree count: up to 32
    trees the reduction fused with the leaf gather (``_vector_sum``), more
    the windowed rewrite (``_window_sum``).

    The 8 lanes and the cut at 16 are the choices XLA's CPU compiler makes
    for the loop that fuses the reduction with the leaf gather.  They were
    found and tested on an x86-64 AVX-512 host at depths 3 to 5, which
    cover the repo's GBRTs (Stage-0: depth 5; the LTR re-ranker: 4).  At
    other depths the loop body's length changes the compiler's choices for
    some counts of 4 to 32 trees (at depth 6, 20 to 23 trees end in a
    second, 4-lane vector), and another host's vectors may change them
    too."""
    if leaves.shape[-1] <= 32:
        return _vector_sum(leaves)
    return _window_sum(leaves)


def forest_leaves(forest: Forest, xb: torch.Tensor, depth: int
                  ) -> torch.Tensor:
    """(n, T) leaf value reached by every row in every tree."""
    n = xb.shape[0]
    n_trees = forest.feat.shape[0]
    tree = torch.arange(n_trees, device=xb.device)[None, :]
    row = torch.arange(n, device=xb.device)[:, None]
    xbl = xb.long()
    node = torch.zeros((n, n_trees), dtype=torch.int64, device=xb.device)
    for d in range(depth):
        f = forest.feat[tree, d, node].long()
        b = forest.thresh[tree, d, node].long()
        node = node * 2 + (xbl[row, f] > b).long()
    return forest.leaf[tree, node]


def forest_predict_binned(forest: Forest, xb: torch.Tensor, depth: int
                          ) -> torch.Tensor:
    """Boosted prediction (sum over trees) from pre-binned features."""
    return _sum_trees(forest_leaves(forest, xb, depth))


def forest_predict_stacked(forests: Forest, xb: torch.Tensor, depth: int
                           ) -> torch.Tensor:
    """Predict M stacked ensembles: ``forests`` arrays carry a leading (M,)
    model axis, ``xb`` is (M, n, F) with one binning per model.  Returns
    (M, n)."""
    return torch.stack([
        forest_predict_binned(Forest(forests.feat[i], forests.thresh[i],
                                     forests.leaf[i]), xb[i], depth)
        for i in range(xb.shape[0])])
