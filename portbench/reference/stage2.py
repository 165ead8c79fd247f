"""Stage-2 of the plain reference: the eight query-document features of a
candidate (NumPy, one CSR search a query term), the LTR forest's score,
and the final top t by a stable descending sort of the first ``k2``
candidates.

The features' float32 steps follow the definition's order (the matching
terms' scores added in query-term order from 0).  With
``dtype=torch.bfloat16`` the features and the tree sums are bfloat16: the
control.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.stage0 import forest_predict

N_FEATURES = 8


def qd_features(ref: dict, doc_topics, terms_row, mask_row, topic, docs):
    """(C, 8) float32: log1p(doc length), Σ BM25 of the matching terms, the
    largest of them, the share of query terms matched, Σ BM25 over the
    doc length, the doc's weight on the query topic, its largest topic
    weight, the query's term count."""
    t = terms_row[mask_row > 0]
    off, rdocs, rsc = ref["offsets"], ref["docs"], ref["score"]
    feats = np.zeros((len(docs), N_FEATURES), np.float32)
    dl = ref["doclen"][docs].astype(np.float32)
    feats[:, 0] = np.log1p(dl)
    s = np.zeros(len(docs), np.float32)
    n_match = np.zeros(len(docs), np.float32)
    mx = np.zeros(len(docs), np.float32)
    for tt in t:
        lo, hi = off[tt], off[tt + 1]
        if hi <= lo:
            continue
        seg = rdocs[lo:hi]
        pos = np.minimum(np.searchsorted(seg, docs), hi - lo - 1)
        hit = seg[pos] == docs
        sc = np.where(hit, rsc[lo:hi][pos], 0.0)
        s += sc
        mx = np.maximum(mx, sc)
        n_match += hit
    feats[:, 1] = s
    feats[:, 2] = mx
    feats[:, 3] = n_match / max(len(t), 1)
    feats[:, 4] = s / np.maximum(dl, 1.0)
    feats[:, 5] = doc_topics[docs, topic]
    feats[:, 6] = doc_topics[docs].max(axis=1)
    feats[:, 7] = len(t)
    return feats


def rerank(ref: dict, doc_topics, forest: dict, terms, mask, topics, cand,
           k2, stage1_lists, t_final: int, dtype=torch.float32):
    """The final lists ((Q, t_final) int64) and candidates used ((Q,)):
    query i re-ranks the first ``k2[i]`` of ``cand[i]`` (ids >= 0); a query
    with ``k2`` 0 serves the first ``t_final`` of its Stage-1 list; fewer
    than ``t_final`` candidates pad with -1."""
    q = len(cand)
    final = np.zeros((q, t_final), np.int64)
    used = np.zeros(q, np.int64)
    for i in range(q):
        c = cand[i, :int(k2[i])]
        c = c[c >= 0].astype(np.int64)
        used[i] = len(c)
        if k2[i] == 0:
            final[i] = stage1_lists[i, :t_final]
            continue
        if not len(c):
            continue
        f = qd_features(ref, doc_topics, terms[i], mask[i], topics[i], c)
        x = torch.from_numpy(f)
        if dtype != torch.float32:
            x = x.to(dtype).float()
        sc = forest_predict(forest, x, dtype).numpy()
        order = np.argsort(-sc, kind="stable")[:t_final]
        picks = c[order]
        final[i, :len(picks)] = picks
        final[i, len(picks):] = -1
    return final, used
