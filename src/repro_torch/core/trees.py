"""Array-based decision-tree ensembles in PyTorch: fit and inference.

The reference (``repro.core.trees``) stores LightGBM-style complete binary
trees of fixed depth as dense arrays, so inference is a branch-free
O(depth) gather chain.  Feature values are quantile-binned to uint8
(``fit_bins`` / ``apply_bins``) and split thresholds are bin indices.
Trees are built level by level (``build_trees``, T trees at once;
``build_tree`` one): a level is two kernel launches on the card,
``level_split`` (the split histograms, the bins' prefix sums, the gains,
each feature's best bin) and ``level_route`` (each node's split, the rows'
new nodes), and their plain versions, the same torch sequence, on the CPU.

Exactness: every sum a fit compares or stores follows the reference's
compiled order, so fitted trees are the reference's bit for bit — the
histograms add each cell's rows in row order (``_level_histograms``), the
cumulative sums over the bins run in XLA-CPU's windows of 16
(``_bin_cumsum``), and ties between splits go to the lowest flat index.
The per-row sum over trees follows the reference's compiled reduction
order (``_sum_trees``), so boosted predictions agree bit for bit at every
tree count, at the repo's depths — a route compares a prediction with a
threshold that is itself one of the reference's predictions.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels.level_histogram import ops as lh


class TreeParams(NamedTuple):
    depth: int = 6              # number of split levels; 2**depth leaves
    n_bins: int = 64
    min_child_weight: float = 10.0
    l2: float = 1.0             # ridge term on leaf scores


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


# ---------------------------------------------------------------------------
# Binning
# ---------------------------------------------------------------------------

def fit_bins(x: np.ndarray, n_bins: int) -> np.ndarray:
    """Quantile bin edges, shape (F, n_bins - 1). Host-side (NumPy)."""
    qs = np.linspace(0.0, 100.0, n_bins + 1)[1:-1]
    edges = np.percentile(np.asarray(x), qs, axis=0).T.astype(np.float32)
    # strictly increasing edges keep the bin count well-behaved on constant
    # columns
    edges = np.maximum.accumulate(edges + 1e-9 * np.arange(edges.shape[1]),
                                  axis=1)
    return edges


def fit_inputs(x, y, n_bins: int, device: torch.device
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A fit's inputs on ``device`` from (n, F) features and (n,) targets
    (arrays or tensors): the (F, n) uint8 bins, transposed, the float32
    targets and the (F, n_bins - 1) float32 bin edges (float32, as the
    reference's ``jnp.asarray`` makes them)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    if isinstance(y, torch.Tensor):
        y = y.detach().cpu().numpy()
    x = np.ascontiguousarray(x, np.float32)
    edges = torch.from_numpy(
        fit_bins(x, n_bins).astype(np.float32)).to(device)
    xb = apply_bins(torch.from_numpy(x).to(device), edges)
    yt = torch.from_numpy(np.ascontiguousarray(y, np.float32)).to(device)
    return xb.T.contiguous(), yt, edges


def apply_bins(x: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """(n, F) raw floats -> (n, F) uint8 bin ids (count of edges below)."""
    bins = (x[:, :, None] > edges[None, :, :]).sum(dim=-1)
    return bins.to(torch.uint8)


# ---------------------------------------------------------------------------
# Level-wise histogram tree builder
# ---------------------------------------------------------------------------

def _level_histograms(xbt: torch.Tensor, node: torch.Tensor,
                      grad: torch.Tensor, weight: torch.Tensor, n_nodes: int,
                      n_bins: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Weighted gradient / weight histograms per (node, feature, bin), each
    cell's rows added in row order; ``xbt`` is the (F, n) uint8 bins,
    transposed."""
    return lh.level_histogram(xbt, node, grad * weight, weight,
                              n_nodes=n_nodes, n_bins=n_bins)


_bin_cumsum = lh.bin_cumsum


def build_trees(xbt: torch.Tensor, target: torch.Tensor,
                weights: torch.Tensor, feat_masks: torch.Tensor,
                params: TreeParams):
    """Fit T regression trees to one ``target`` with variance-reduction
    splits, level by level, all trees in each level's two launches (the
    reference's ``vmap`` of ``build_tree`` over the trees).

    Args:
      xbt: (F, n) uint8 binned features, transposed.
      target: (n,) float32 regression target (the boosting pseudo-gradient),
        shared by the trees.
      weights: (T, n) float32 sample weights (0 excludes a row).
      feat_masks: (T, F) bool — features eligible for splitting.
    Returns:
      (feat, thresh) int32 arrays of shape (T, depth, 2**(depth-1)) and the
      final (T, n) int32 leaf assignment in [0, 2**depth).  A node no split
      can satisfy passes every row left (feature 0, the last bin); among
      equal gains the lowest (feature, bin) wins.
    """
    n_trees, n = weights.shape
    shape = (n_trees, params.depth, 2 ** (params.depth - 1))
    node = torch.zeros((n_trees, n), dtype=torch.int32, device=xbt.device)
    feat = torch.zeros(shape, dtype=torch.int32, device=xbt.device)
    thresh = torch.zeros(shape, dtype=torch.int32, device=xbt.device)
    for d in range(params.depth):
        gain, best = lh.level_split(
            xbt, node, target, weights, feat_masks, n_nodes=2 ** d,
            n_bins=params.n_bins, l2=params.l2,
            min_child_weight=params.min_child_weight)
        lh.level_route(xbt, node, gain, best, feat, thresh, level=d,
                       n_bins=params.n_bins)
    return feat, thresh, node


def build_tree(xbt: torch.Tensor, target: torch.Tensor, weight: torch.Tensor,
               feat_mask: torch.Tensor, params: TreeParams):
    """Fit one regression tree (``build_trees`` with T = 1).

    Args:
      xbt: (F, n) uint8 binned features, transposed.
      target: (n,) float32 regression target (the boosting pseudo-gradient).
      weight: (n,) float32 sample weights (0 excludes a row).
      feat_mask: (F,) bool — features eligible for splitting.
    Returns:
      (feat, thresh) int32 arrays of shape (depth, 2**(depth-1)) and the
      final (n,) int32 leaf assignment in [0, 2**depth).
    """
    feat, thresh, node = build_trees(xbt, target, weight[None],
                                     feat_mask[None], params)
    return feat[0], thresh[0], node[0]


def leaf_means(leaf_id: torch.Tensor, values: torch.Tensor,
               weight: torch.Tensor, n_leaves: int, l2: float = 1.0
               ) -> torch.Tensor:
    """(n_leaves,) Σ values·w / (Σ w + l2) per leaf, rows summed in order
    (one ``level_histogram`` call: one feature, the leaf as its bin).  With
    a leading tree axis on ``leaf_id`` and ``weight`` ((T, n); ``values``
    (n,) shared), (T, n_leaves) from the same one call: the tree as the
    node, each tree's rows in order."""
    batched = leaf_id.dim() == 2
    lid = leaf_id if batched else leaf_id[None]
    wt = weight if batched else weight[None]
    n_trees, n = lid.shape
    tree = torch.arange(n_trees, dtype=torch.int32,
                        device=lid.device).repeat_interleave(n)
    sv, sw = lh.level_histogram(lid.to(torch.uint8).reshape(1, -1), tree,
                                (values * wt).reshape(-1), wt.reshape(-1),
                                n_nodes=n_trees, n_bins=n_leaves)
    out = sv[:, 0] / (sw[:, 0] + l2)
    return out if batched else out[0]


def leaf_quantiles(leaf_id: torch.Tensor, values: torch.Tensor,
                   weight: torch.Tensor, n_leaves: int, tau: float
                   ) -> torch.Tensor:
    """Exact per-leaf τ-quantile of ``values`` (weight a 0/1 mask): the
    value at rank floor(τ · (count - 1)) of the leaf's sorted values, 0.0
    for an empty leaf.  The reference's lexsort by (leaf, value) is two
    stable sorts; exactly one row a leaf hits its rank."""
    n = values.shape[0]
    dev = values.device
    lid = torch.where(weight > 0, leaf_id, n_leaves).long()
    by_value = torch.sort(values, stable=True).indices
    order = by_value[torch.sort(lid[by_value], stable=True).indices]
    s_leaf = lid[order]
    s_val = values[order]
    counts = torch.bincount(lid, minlength=n_leaves + 1).float()
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(n, device=dev, dtype=torch.float32) - starts[s_leaf]
    # τ rounded to float32 first: its product with a float32 is then the
    # reference's float32 product whatever precision the multiply runs in
    target_rank = torch.floor(float(np.float32(tau))
                              * torch.clamp(counts - 1.0, min=0.0))
    hit = pos == target_rank[s_leaf]
    out = torch.zeros((n_leaves + 1,), dtype=torch.float32, device=dev)
    out[s_leaf[hit]] = s_val[hit] + 0.0
    return out[:n_leaves]


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
    parts = _seq_sum(x.reshape(*x.shape[:-1], n, 32))
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


def times_reciprocal(total: torch.Tensor, n: int) -> torch.Tensor:
    """``total / n`` as the reference's compiled ``jnp.mean`` divides: a
    multiply by the float32 reciprocal of n (the two differ unless n is a
    power of two)."""
    return total * (torch.ones((), dtype=torch.float32) / n).to(total.device)


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


def forest_predict_binned(forest: Forest, xb: torch.Tensor, depth: int,
                          reduce: str = "sum") -> torch.Tensor:
    """Predict from pre-binned features.  reduce: "sum" (boosting) or
    "mean" (bagging: the sum times the float32 reciprocal of the tree
    count, as the reference's compiled ``jnp.mean`` takes it)."""
    s = _sum_trees(forest_leaves(forest, xb, depth))
    if reduce == "sum":
        return s
    if reduce == "mean":
        return times_reciprocal(s, forest.leaf.shape[0])
    raise ValueError(f"reduce must be 'sum' or 'mean', got {reduce!r}")


def forest_predict_stacked(forests: Forest, xb: torch.Tensor, depth: int,
                           reduce: str = "sum") -> torch.Tensor:
    """Predict M stacked ensembles: ``forests`` arrays carry a leading (M,)
    model axis, ``xb`` is (M, n, F) with one binning per model.  Returns
    (M, n)."""
    return torch.stack([
        forest_predict_binned(Forest(forests.feat[i], forests.thresh[i],
                                     forests.leaf[i]), xb[i], depth, reduce)
        for i in range(xb.shape[0])])
