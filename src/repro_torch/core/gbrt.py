"""Gradient-boosted regression trees — inference in PyTorch.

The reference (``repro.core.gbrt``) fits quantile (pinball-loss) and L2
GBRTs; the paper's Stage-0 predictors are the quantile ones.  The port
serves models fitted there (training is not ported yet): a ``GBRTModel``
holds the forest, the base prediction and the bin edges as tensors on one
device, built by ``repro_torch.convert``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import trees as T


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
    the Stage-0 k/ρ/t predictions run as one batch of tensor ops."""
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
    """(M, Q) predictions for all stacked models."""
    x = x.float()
    xb = torch.stack([T.apply_bins(x, e) for e in stacked.bin_edges])
    preds = T.forest_predict_stacked(stacked.forest, xb, depth)
    return stacked.base[:, None] + preds
