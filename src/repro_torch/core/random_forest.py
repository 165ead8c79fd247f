"""Random-forest regressor (the paper's "RF" baseline predictor).

The port of ``repro.core.random_forest``: bagged histogram trees, each
fitted to Poisson(1) bootstrap weights (the vectorized equivalent of
sampling with replacement) over a random subset of the features.  As the
reference builds its trees in one ``vmap``, ``trees.build_trees`` builds
all of them together, one ``level_split`` and one ``level_route`` launch a
level on the card, and ``trees.leaf_means`` takes every tree's leaves in
one ``level_histogram`` launch (their plain versions on the CPU).  The
weights and feature masks are the reference's own draws, made on the host
by ``core.prng`` and copied to the device once a fit, so the forests are
the reference's bit for bit; ``predict`` averages the trees as the
reference's compiled ``jnp.mean`` does.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core import trees as T
from repro_torch.isn.backend import resolve_device


class RFParams(NamedTuple):
    n_trees: int = 64
    depth: int = 6
    n_bins: int = 64
    min_child_weight: float = 10.0
    l2: float = 1.0
    max_features: float = 0.4   # fraction of features per tree


class RFModel(NamedTuple):
    forest: T.Forest
    bin_edges: torch.Tensor     # (F, n_bins - 1) float32
    params: RFParams


def tree_draws(seed: int, n: int, n_feat: int, p: RFParams
               ) -> tuple[np.ndarray, np.ndarray]:
    """Each tree's (n,) float32 bootstrap weights and (F,) feature mask,
    drawn as the reference's ``_fit_binned`` draws them: the seed's key
    split into one key a tree, that key split into (k1, k2); Poisson(1)
    weights from k1; the mask ``uniform(k2) < max_features`` with one
    feature from ``randint(k2)`` set on (the same k2 twice, as the
    reference does).  Returns (T, n) and (T, F)."""
    keys = prng.split(prng.split(prng.PRNGKey(seed), p.n_trees))
    weights = prng.poisson(keys[:, 0], 1.0, (n,)).astype(np.float32)
    fmask = prng.uniform(keys[:, 1], (n_feat,)) < np.float32(p.max_features)
    fmask[np.arange(p.n_trees), prng.randint(keys[:, 1], (), 0, n_feat)] = True
    return weights, fmask


def _fit_binned(xbt: torch.Tensor, y: torch.Tensor, weights: torch.Tensor,
                fmask: torch.Tensor, p: RFParams) -> T.Forest:
    """The trees on pre-binned, transposed (F, n) features, all at once
    (the reference's ``vmap`` over trees): (T, n) weights, (T, F) masks."""
    tp = T.TreeParams(p.depth, p.n_bins, p.min_child_weight, p.l2)
    feat, thresh, leaf_id = T.build_trees(xbt, y, weights, fmask, tp)
    leaves = T.leaf_means(leaf_id, y, weights, 2 ** p.depth, p.l2)
    return T.Forest(feat, thresh, leaves)


def fit(x, y, params: RFParams, seed: int = 0,
        device: str | torch.device | None = None) -> RFModel:
    """Fit a forest to (n, F) features ``x`` and (n,) targets ``y`` (arrays
    or tensors) on ``device`` (the card unless the caller names the CPU;
    raises when no CUDA device is present and none is named)."""
    dev = resolve_device(device)
    xbt, yt, edges = T.fit_inputs(x, y, params.n_bins, dev)
    n_feat, n = xbt.shape
    weights, fmask = tree_draws(seed, n, n_feat, params)
    forest = _fit_binned(xbt, yt, torch.from_numpy(weights).to(dev),
                         torch.from_numpy(fmask).to(dev), params)
    return RFModel(forest, edges, params)


def predict(model: RFModel, x: torch.Tensor) -> torch.Tensor:
    """(n,) predictions for (n, F) raw features: the mean over the trees."""
    xb = T.apply_bins(x.float(), model.bin_edges)
    return T.forest_predict_binned(model.forest, xb, model.params.depth,
                                   reduce="mean")
