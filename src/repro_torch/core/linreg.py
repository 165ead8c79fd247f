"""Ridge linear regression — the paper's "LR" baseline (Macdonald et al. 2012
used linear models for response-time prediction).

The port of ``repro.core.linreg``: features standardized by their mean and
population standard deviation (+ 1e-6), the ridge normal equations solved
with ``torch.linalg.solve`` on ``device``.  The reference works in float32;
the port fits and predicts in float64 and rounds once to float32 (the
model's tensors and the predictions).  On Stage-0 features the Gram
matrix is ill-conditioned, and a float32 solve's result then depends on
its sum order beyond 1e-5 of max(1, |prediction|): float32 fits of one
fold on an H100 and on its host's CPU differed by 2.2e-5.  In float64 the
result does not depend on the order (the card's equals the CPU's).  The
reference's own float32 rounding (LAPACK's and XLA's orders) is not
reproduced: the port is within 1e-5 of it on well-conditioned features,
not on Stage-0 features (ROADMAP §3).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.isn.backend import resolve_device


class LinRegModel(NamedTuple):
    w: torch.Tensor        # (F,)
    b: torch.Tensor        # ()
    mu: torch.Tensor       # (F,)
    sigma: torch.Tensor    # (F,)


def fit(x, y, l2: float = 1.0,
        device: str | torch.device | None = None) -> LinRegModel:
    """Fit to (n, F) features ``x`` and (n,) targets ``y`` (arrays or
    tensors, taken as float32) on ``device`` (the card unless the caller
    names the CPU; raises when no CUDA device is present and none is
    named)."""
    dev = resolve_device(device)
    x, y = ((a if torch.is_tensor(a) else torch.from_numpy(
                np.array(a, np.float32)))
            .to(device=dev, dtype=torch.float32).double() for a in (x, y))
    mu = x.mean(dim=0)
    sigma = x.std(dim=0, correction=0) + 1e-6
    xs = (x - mu) / sigma
    f = xs.shape[1]
    gram = xs.T @ xs + l2 * torch.eye(f, dtype=torch.float64, device=dev)
    b = y.mean()
    w = torch.linalg.solve(gram, xs.T @ (y - b))
    return LinRegModel(*(t.float() for t in (w, b, mu, sigma)))


def predict(model: LinRegModel, x: torch.Tensor) -> torch.Tensor:
    """(n,) float32 predictions for (n, F) raw features (computed in
    float64)."""
    w, b, mu, sigma = (t.double() for t in model)
    return (((x.double() - mu) / sigma) @ w + b).float()
