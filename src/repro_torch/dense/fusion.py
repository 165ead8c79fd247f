"""Hybrid fusion: merging lexical and dense candidate lists.

A NumPy copy of ``repro.dense.fusion``.  Two deterministic host-side rules
over per-query ranked lists:

* **RRF** (reciprocal-rank fusion) — score(d) = Σ 1/(k0 + rank(d) + 1)
  over the lists containing d;
* **weighted** — per-query min-max normalize each list's scores to [0, 1],
  then ``w_dense·dense + (1 - w_dense)·lexical``.

Both break exact score ties toward the lower global doc id.  ``-1`` ids
(padding) are excluded; a fused list short of ``k`` is ``-1``-padded.

Modality codes (Stage-0 dispatch): ``M_LEX`` lexical only, ``M_DENSE``
dense only, ``M_BOTH`` both engines + fusion.
"""

from __future__ import annotations

import numpy as np

M_LEX, M_DENSE, M_BOTH = 0, 1, 2


def _merge_contrib(k: int, *lists):
    """Sum per-doc contributions over (ids, contrib) lists; return the
    (ids, scores) top-k, ties toward the lower doc id."""
    q = lists[0][0].shape[0]
    out_ids = np.full((q, k), -1, np.int64)
    out_sc = np.zeros((q, k), np.float32)
    for i in range(q):
        ids = np.concatenate([np.asarray(l[0][i], np.int64) for l in lists])
        sc = np.concatenate([np.asarray(l[1][i], np.float64) for l in lists])
        live = ids >= 0
        ids, sc = ids[live], sc[live]
        if not len(ids):
            continue
        uniq, inv = np.unique(ids, return_inverse=True)
        tot = np.zeros(len(uniq))
        np.add.at(tot, inv, sc)
        # lexsort: last key is primary -> score desc, then doc id asc
        order = np.lexsort((uniq, -tot))[:k]
        out_ids[i, :len(order)] = uniq[order]
        out_sc[i, :len(order)] = tot[order]
    return out_ids, out_sc


def rrf_fuse(lex_ids: np.ndarray, dense_ids: np.ndarray, k: int,
             k0: float = 60.0):
    """Reciprocal-rank fusion of two (Q, k_in) ranked id lists."""
    def contrib(ids):
        r = np.arange(ids.shape[1], dtype=np.float64)
        return np.broadcast_to(1.0 / (k0 + r + 1.0), ids.shape)
    return _merge_contrib(k, (lex_ids, contrib(lex_ids)),
                          (dense_ids, contrib(dense_ids)))


def _minmax(sc: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """Per-query min-max over live entries; constant lists map to 1."""
    sc = np.asarray(sc, np.float64)
    live = ids >= 0
    out = np.zeros_like(sc)
    for i in range(sc.shape[0]):
        row = sc[i][live[i]]
        if not len(row):
            continue
        lo, hi = row.min(), row.max()
        out[i][live[i]] = (row - lo) / (hi - lo) if hi > lo else 1.0
    return out


def weighted_fuse(lex_ids: np.ndarray, lex_sc: np.ndarray,
                  dense_ids: np.ndarray, dense_sc: np.ndarray, k: int,
                  w_dense: float = 0.5):
    """Min-max-normalized weighted score fusion of two ranked lists."""
    return _merge_contrib(
        k,
        (lex_ids, (1.0 - w_dense) * _minmax(lex_sc, lex_ids)),
        (dense_ids, w_dense * _minmax(dense_sc, dense_ids)))


def fuse(fusion_spec, lex_ids, lex_sc, dense_ids, dense_sc, k: int):
    """Apply a ``FusionSpec`` to one batch."""
    if fusion_spec.method == "rrf":
        return rrf_fuse(lex_ids, dense_ids, k, k0=fusion_spec.rrf_k0)
    return weighted_fuse(lex_ids, lex_sc, dense_ids, dense_sc, k,
                         w_dense=fusion_spec.w_dense)
