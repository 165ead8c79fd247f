"""The unified Stage-0 prediction framework (paper §4).

One feature pipeline, three regression targets — k, ρ, response time — and
three model families (quantile-GBRT "QR", random forest "RF", ridge "LR"),
trained with k-fold cross validation so every query's prediction comes from
a model that never saw it (the paper uses 10 folds).

Targets are learned in log space (the label distributions are heavy-tailed;
Fig. 2/5 in the paper) and predictions are exponentiated back.

The port of ``repro.core.predictors``: the folds, the log transforms of
the targets and the report run in NumPy on the host, exactly as in the
reference; every fit and prediction runs on ``device`` (the card unless
the caller names the CPU).  QR and RF predictions are the reference's bit
for bit; LR's within 1e-5 of max(1, |prediction|) (``core.linreg``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core import gbrt, linreg, random_forest
from repro_torch.isn.backend import resolve_device


@dataclass(frozen=True)
class PredictorConfig:
    method: str = "qr"                # qr | rf | lr
    n_folds: int = 10
    log_target: bool = True
    tau: float = 0.55                 # QR quantile (paper's best fit for k)
    n_trees: int = 64
    depth: int = 5
    learning_rate: float = 0.15
    seed: int = 0


@dataclass
class CVPrediction:
    pred: np.ndarray                  # (Q,) cross-validated predictions
    models: list = field(default_factory=list)
    config: PredictorConfig = PredictorConfig()


def _fit_predict(method, xtr, ytr, xte, cfg: PredictorConfig, seed, device):
    """Fit one fold's model on ``device``; returns it and its (n_te,)
    float32 predictions as a NumPy array."""
    x = torch.from_numpy(np.ascontiguousarray(xte, np.float32)).to(device)
    if method == "qr":
        p = gbrt.GBRTParams(n_trees=cfg.n_trees, depth=cfg.depth,
                            learning_rate=cfg.learning_rate,
                            loss="quantile", tau=cfg.tau)
        m = gbrt.fit(xtr, ytr, p, seed=seed, device=device)
        return m, gbrt.predict(m, x).cpu().numpy()
    if method == "rf":
        p = random_forest.RFParams(n_trees=cfg.n_trees, depth=cfg.depth + 1)
        m = random_forest.fit(xtr, ytr, p, seed=seed, device=device)
        return m, random_forest.predict(m, x).cpu().numpy()
    if method == "lr":
        m = linreg.fit(xtr, ytr, device=device)
        return m, linreg.predict(m, x).cpu().numpy()
    raise ValueError(method)


def cross_val_predict(x: np.ndarray, y: np.ndarray, cfg: PredictorConfig,
                      device: str | torch.device | None = None
                      ) -> CVPrediction:
    """K-fold CV predictions for one target; the fold of each query from
    ``np.random.RandomState(cfg.seed)``, fold f's model from seed
    ``cfg.seed * 100 + f``."""
    dev = resolve_device(device)
    q = x.shape[0]
    rng = np.random.RandomState(cfg.seed)
    fold = rng.randint(0, cfg.n_folds, size=q)
    t = np.log1p(np.maximum(y, 0)) if cfg.log_target else y.astype(np.float32)
    pred = np.zeros(q, np.float32)
    models = []
    for f in range(cfg.n_folds):
        te = fold == f
        tr = ~te
        m, p = _fit_predict(cfg.method, x[tr], t[tr], x[te], cfg,
                            seed=cfg.seed * 100 + f, device=dev)
        pred[te] = p
        models.append(m)
    if cfg.log_target:
        pred = np.expm1(pred)
    return CVPrediction(pred=np.maximum(pred, 0), models=models, config=cfg)


@dataclass
class StageZeroPredictions:
    """The full Stage-0 bundle the scheduler consumes."""
    k: np.ndarray
    rho: np.ndarray
    time_us: np.ndarray


def predict_all(x: np.ndarray, labels_k: np.ndarray, labels_rho: np.ndarray,
                labels_t: np.ndarray, method: str = "qr",
                tau_k: float = 0.55, tau_rho: float = 0.45,
                tau_t: float = 0.5, n_folds: int = 10,
                device: str | torch.device | None = None,
                **kw) -> StageZeroPredictions:
    """Train the three regressors and return CV predictions for every query.

    The per-target quantiles follow the paper: τ = 0.55 for k, τ = 0.45 for
    ρ (best-fit distributions, Figs. 2 and 5)."""
    base = dict(method=method, n_folds=n_folds, **kw)
    pk, pr, pt = (
        cross_val_predict(x, y, PredictorConfig(tau=tau, **base), device)
        for y, tau in ((labels_k, tau_k), (labels_rho, tau_rho),
                       (labels_t, tau_t)))
    return StageZeroPredictions(k=pk.pred, rho=pr.pred, time_us=pt.pred)


# ---------------------------------------------------------------------------
# evaluation helpers (paper Table 2)
# ---------------------------------------------------------------------------

def regression_report(y: np.ndarray, pred: np.ndarray,
                      tail_quantile: float = 0.95) -> dict:
    """RMSE in log space + binary tail-query classification metrics.

    Tail threshold is learned as the minimum value in the top (1-q) of the
    *training* distribution, per the paper's Table 2 protocol."""
    ly, lp = np.log1p(y), np.log1p(np.maximum(pred, 0))
    rmse = float(np.sqrt(np.mean((ly - lp) ** 2)))
    thr = np.quantile(y, tail_quantile)
    pos = y >= thr
    pred_pos = pred >= thr
    tp = int(np.sum(pos & pred_pos))
    fp = int(np.sum(~pos & pred_pos))
    fn = int(np.sum(pos & ~pred_pos))
    tn = int(np.sum(~pos & ~pred_pos))
    prec = tp / max(tp + fp, 1)
    rec = tp / max(tp + fn, 1)
    f1 = 2 * prec * rec / max(prec + rec, 1e-9)
    nprec = tn / max(tn + fn, 1)
    nrec = tn / max(tn + fp, 1)
    nf1 = 2 * nprec * nrec / max(nprec + nrec, 1e-9)
    # AUC via rank statistic
    order = np.argsort(pred)
    r = np.empty(len(pred)); r[order] = np.arange(1, len(pred) + 1)
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    auc = ((r[pos].sum() - n_pos * (n_pos + 1) / 2) / max(n_pos * n_neg, 1))
    return {
        "rmse": rmse, "precision": prec, "recall": rec, "f1": f1,
        "macro_precision": (prec + nprec) / 2, "macro_recall": (rec + nrec) / 2,
        "macro_f1": (f1 + nf1) / 2, "auc": float(auc),
    }
