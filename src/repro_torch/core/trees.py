"""Array-based decision-tree ensembles — inference in PyTorch.

The reference (``repro.core.trees``) stores LightGBM-style complete binary
trees of fixed depth as dense arrays, so inference is a branch-free
O(depth) gather chain.  Feature values are quantile-binned to uint8
(``apply_bins``) and split thresholds are bin indices.  Training is not
ported yet: the port takes forests fitted by the reference
(``repro_torch.convert``).

Exactness: the per-row sum over trees follows the reference's compiled
reduction order (``_sum_trees``), so boosted predictions agree bit for bit
for the tree counts the presets use (48 and 64) — a route compares a
prediction with a threshold that is itself one of the reference's
predictions.
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


def _sum_trees(leaves: torch.Tensor) -> torch.Tensor:
    """Sum over the last (tree) axis in the reference's compiled order:
    up to 32 trees left to right; more are split into ceil(T/32) equal
    chunks (zero-padded), each summed left to right, then the chunk sums
    are added pairwise."""
    t = leaves.shape[-1]
    if t <= 32:
        return _seq_sum(leaves)
    n_chunks = -(-t // 32)
    size = -(-t // n_chunks)
    leaves = torch.nn.functional.pad(leaves, (0, n_chunks * size - t))
    parts = torch.stack([_seq_sum(leaves[..., i * size:(i + 1) * size])
                         for i in range(n_chunks)], dim=-1)
    while parts.shape[-1] > 1:
        if parts.shape[-1] % 2:
            parts = torch.nn.functional.pad(parts, (0, 1))
        parts = parts[..., 0::2] + parts[..., 1::2]
    return parts[..., 0]


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
