"""Gradient-boosted regression trees with L2 or quantile (pinball) loss.

The paper's preferred predictor ("QR") is a GBRT minimizing the pinball loss
ξ_τ(y - f) = (y - f)(τ - 1{y < f}); each boosting round fits a histogram tree
to the negative gradient and then refits every leaf to the exact in-leaf
τ-quantile of the residuals, which makes the ensemble estimate the
conditional τ-quantile rather than the mean.  The port of
``repro.core.gbrt``: ``fit`` runs on the card (each tree's levels through
``trees.build_tree``'s ``level_split`` and ``level_route`` kernels, the
leaf means through ``level_histogram``, ``boost_update``) unless the
caller names the CPU, and its forests
are the reference's bit for bit; ``repro_torch.convert`` also carries
fitted reference models across.  A ``GBRTModel`` holds the forest, the
base prediction and the bin edges as tensors on one device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core import trees as T
from repro_torch.isn.backend import resolve_device
from repro_torch.kernels.level_histogram import ops as lh
from repro_torch.kernels.stage0 import ops as s0


class GBRTParams(NamedTuple):
    n_trees: int = 64
    depth: int = 5
    n_bins: int = 64
    learning_rate: float = 0.15
    min_child_weight: float = 20.0
    l2: float = 1.0
    loss: str = "l2"          # "l2" | "quantile"
    tau: float = 0.5          # quantile target (used when loss == "quantile")
    colsample: float = 1.0    # feature fraction per tree
    subsample: float = 1.0    # row fraction per tree


class GBRTModel(NamedTuple):
    forest: T.Forest
    base: torch.Tensor          # () float32 initial prediction
    bin_edges: torch.Tensor     # (F, n_bins - 1) float32
    params: GBRTParams


def _pseudo_gradient(y, f, loss, tau):
    if loss == "l2":
        return y - f
    # pinball: -dξ/df = tau - 1{y < f}; both constants rounded to float32
    # from doubles, as jnp.where rounds its Python operands
    return torch.where(y >= f, float(np.float32(tau)),
                       float(np.float32(tau - 1.0)))


def _leaf_values(leaf_id, y, f, w, n_leaves, p: GBRTParams):
    if p.loss == "l2":
        return T.leaf_means(leaf_id, y - f, w, n_leaves, p.l2)
    return T.leaf_quantiles(leaf_id, y - f, w, n_leaves, p.tau)


def _quantile(y: torch.Tensor, tau: float) -> torch.Tensor:
    """``jnp.quantile(y, tau)`` ("linear") as the reference's jit computes
    it: the position τ·(n - 1) in float32, and the interpolation
    lo·(1 - w) + hi·w with the first product fused into the add (the
    contraction XLA makes).  Returns a () float32 tensor on y's device."""
    s = torch.sort(y).values
    n = np.float32(y.shape[0])
    q = np.float32(tau) * (n - np.float32(1.0))
    lo, hi = np.floor(q), np.ceil(q)
    hw = np.float32(q - lo)
    lw = np.float32(np.float32(1.0) - hw)
    lo = int(np.clip(lo, 0, n - 1))
    hi = int(np.clip(hi, 0, n - 1))
    vals = s[[lo, hi]].cpu()
    t = torch.tensor([lw, hw], dtype=torch.float32)
    base = lh.fma32(vals[0], t[0], vals[1] * t[1])
    return base.to(y.device)


def tree_draws(seed: int, n: int, n_feat: int, p: GBRTParams
               ) -> tuple[np.ndarray, np.ndarray]:
    """Each tree's (F,) feature mask and (n,) float32 0/1 row weights,
    drawn as the reference's ``_fit_binned`` draws them: the seed's key
    split into one key a tree, that key split into (k1, k2); the mask
    ``uniform(k1) < colsample``, the weights ``uniform(k2) < subsample``.
    Each draw is made only when its fraction is below 1 (all True / all
    1.0 otherwise).  Returns (T, F) and (T, n)."""
    fmask = np.ones((p.n_trees, n_feat), bool)
    w = np.ones((p.n_trees, n), np.float32)
    keys = prng.split(prng.split(prng.PRNGKey(seed), p.n_trees))
    if p.colsample < 1.0:
        fmask = prng.uniform(keys[:, 0], (n_feat,)) < np.float32(p.colsample)
    if p.subsample < 1.0:
        w = (prng.uniform(keys[:, 1], (n,)) < np.float32(p.subsample)
             ).astype(np.float32)
    return fmask, w


def _fit_binned(xbt: torch.Tensor, y: torch.Tensor, p: GBRTParams,
                seed: int = 0) -> tuple[T.Forest, torch.Tensor]:
    """The boosting loop on pre-binned, transposed (F, n) features, a
    Python loop over trees in place of the reference's ``lax.scan``."""
    n_feat, n = xbt.shape
    dev = xbt.device
    tp = T.TreeParams(p.depth, p.n_bins, p.min_child_weight, p.l2)
    n_leaves = 2 ** p.depth
    if p.loss == "l2":
        # jnp.mean as the reference's program compiles it: the rows summed
        # left to right (up to 32) or in the windowed rewrite, then
        # multiplied by the float32 reciprocal of n (the rewrite of the
        # division; the two differ unless n is a power of two)
        total = T._seq_sum(y) if n <= 32 else T._window_sum(y)
        base = T.times_reciprocal(total, n)
    else:
        base = _quantile(y, p.tau)
    fmasks, weights = (torch.from_numpy(a).to(dev)
                       for a in tree_draws(seed, n, n_feat, p))
    lr = float(np.float32(p.learning_rate))
    f = base.expand(n).contiguous()
    feats, threshs, leaves = [], [], []
    for fmask, w in zip(fmasks, weights):
        g = _pseudo_gradient(y, f, p.loss, p.tau)
        feat, thresh, leaf_id = T.build_tree(xbt, g, w, fmask, tp)
        raw = _leaf_values(leaf_id, y, f, w, n_leaves, p)
        # the stored leaves round raw·lr once; the running prediction takes
        # raw·lr + f as one fused multiply-add, as the reference's jit does
        f = lh.boost_update(f, raw, leaf_id, lr)
        feats.append(feat)
        threshs.append(thresh)
        leaves.append(raw * lr)
    forest = T.Forest(torch.stack(feats), torch.stack(threshs),
                      torch.stack(leaves))
    return forest, base


def fit(x, y, params: GBRTParams, seed: int = 0,
        device: str | torch.device | None = None) -> GBRTModel:
    """Fit a GBRT to (n, F) features ``x`` and (n,) targets ``y`` (arrays
    or tensors) on ``device`` (the card unless the caller names the CPU;
    raises when no CUDA device is present and none is named).  ``seed`` is
    the reference's: it draws each tree's feature mask (``colsample`` < 1)
    and row weights (``subsample`` < 1) as the reference does
    (``tree_draws``)."""
    xbt, yt, edges = T.fit_inputs(x, y, params.n_bins,
                                  resolve_device(device))
    forest, base = _fit_binned(xbt, yt, params, seed)
    return GBRTModel(forest, base, edges, params)


def predict(model: GBRTModel, x: torch.Tensor) -> torch.Tensor:
    """(n,) predictions for (n, F) raw features."""
    xb = T.apply_bins(x.float(), model.bin_edges)
    return model.base + T.forest_predict_binned(model.forest, xb,
                                                model.params.depth)


# ---------------------------------------------------------------------------
# fused multi-model inference (Stage-0 serves k, ρ and t together)
# ---------------------------------------------------------------------------

class StackedGBRT(NamedTuple):
    """M same-shaped GBRT ensembles stacked along a leading model axis, so
    the Stage-0 k/ρ/t predictions run as one kernel launch."""
    forest: T.Forest           # every field carries a leading (M,) axis
    base: torch.Tensor         # (M,)
    bin_edges: torch.Tensor    # (M, F, n_bins - 1)


def stack_models(models: list[GBRTModel]) -> tuple[StackedGBRT, int]:
    """Stack models sharing (n_trees, depth, n_bins); loss/τ may differ.

    Returns (stacked, depth); raises ValueError on shape mismatch so callers
    can fall back to per-model prediction.
    """
    shapes = {(m.params.n_trees, m.params.depth, m.params.n_bins)
              for m in models}
    if len(shapes) != 1:
        raise ValueError(f"cannot stack GBRTs with mixed shapes: {shapes}")
    feats = {tuple(m.bin_edges.shape) for m in models}
    if len(feats) != 1:
        raise ValueError(f"cannot stack GBRTs with mixed feature sets: {feats}")
    forest = T.Forest(*(torch.stack([getattr(m.forest, f) for m in models])
                        for f in T.Forest._fields))
    base = torch.stack([m.base.float().reshape(()) for m in models])
    edges = torch.stack([m.bin_edges for m in models])
    (_, depth, _), = shapes
    return StackedGBRT(forest, base, edges), depth


def predict_stacked(stacked: StackedGBRT, x: torch.Tensor,
                    depth: int) -> torch.Tensor:
    """(M, Q) predictions for all stacked models: on the card one launch
    of the ``stage0_forest`` kernel (bins, descent, tree sums, base), on
    the CPU its plain version."""
    f = stacked.forest
    return s0.stage0_forest(x.float(), stacked.bin_edges, f.feat, f.thresh,
                            f.leaf, stacked.base, depth=depth)
