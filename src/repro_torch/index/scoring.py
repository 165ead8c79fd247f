"""Similarity functions over postings arrays.

Six models — TF·IDF, BM25, query likelihood (Dirichlet), Bose–Einstein (Bo1),
DPH and PL2 (DFR) — matching the feature families the paper builds its 147
Stage-0 features from.  All functions are vectorized over flat postings
arrays at index-build time.  A copy of ``repro.index.scoring``.
"""

from __future__ import annotations

import numpy as np

LOG2E = np.log2(np.e)


def bm25(tf, df, dl, n_docs, avg_dl, k1=0.9, b=0.4):
    idf = np.log(1.0 + (n_docs - df + 0.5) / (df + 0.5))
    norm = tf + k1 * (1.0 - b + b * dl / avg_dl)
    return idf * tf * (k1 + 1.0) / norm


def tfidf(tf, df, dl, n_docs, avg_dl):
    return (1.0 + np.log(tf)) * np.log(1.0 + n_docs / df)


def ql_dirichlet(tf, cf, dl, total_tokens, mu=1500.0):
    p_c = cf / total_tokens
    return np.log1p(tf / (mu * p_c)) + np.log(mu / (dl + mu))


def bose_einstein(tf, cf, n_docs):
    lam = cf / n_docs
    return (tf * np.log2((1.0 + lam) / lam) + np.log2(1.0 + lam))


def dph(tf, cf, dl, n_docs, avg_dl):
    f = np.clip(tf / dl, 1e-9, 1.0 - 1e-9)
    norm = (1.0 - f) ** 2 / (tf + 1.0)
    return norm * (tf * np.log2(np.maximum(tf * (avg_dl / dl) * (n_docs / cf), 1e-9))
                   + 0.5 * np.log2(np.maximum(2.0 * np.pi * tf * (1.0 - f), 1e-9)))


def pl2(tf, cf, dl, n_docs, avg_dl, c=1.0):
    tfn = tf * np.log2(1.0 + c * avg_dl / dl)
    lam = np.maximum(cf / n_docs, 1e-9)
    tfn = np.maximum(tfn, 1e-6)
    return (1.0 / (tfn + 1.0)) * (
        tfn * np.log2(tfn / lam) + (lam - tfn) * LOG2E
        + 0.5 * np.log2(np.maximum(2.0 * np.pi * tfn, 1e-9)))


def all_similarity_scores(tf, df, cf, dl, n_docs, avg_dl, total_tokens):
    """(P, 6) score matrix for flat postings, column order matching
    repro_torch.core.features.SIM_NAMES."""
    cols = [
        tfidf(tf, df, dl, n_docs, avg_dl),
        bm25(tf, df, dl, n_docs, avg_dl),
        ql_dirichlet(tf, cf, dl, total_tokens),
        bose_einstein(tf, cf, n_docs),
        dph(tf, cf, dl, n_docs, avg_dl),
        pl2(tf, cf, dl, n_docs, avg_dl),
    ]
    return np.stack([c.astype(np.float32) for c in cols], axis=1)


def quantize_impacts(scores: np.ndarray, n_levels: int = 255
                     ) -> tuple[np.ndarray, float]:
    """ATIRE-style linear impact quantization to [1, n_levels] (uint8),
    scaled by the score maximum; returns (impacts, scale)."""
    smax = float(scores.max()) if len(scores) else 1.0
    q = np.ceil(scores / smax * n_levels).astype(np.int32)
    return np.clip(q, 1, n_levels).astype(np.uint8), smax
