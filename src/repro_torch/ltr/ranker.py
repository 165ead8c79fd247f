"""Later-stage re-ranking features (Stage-2 of the cascade).

Query-document features (BM25 decomposition + topical affinity) for the
whole (Q, C) candidate grid in one pass, scored by a point-wise GBRT LTR
model.  The port serves the reference's kernel path
(``repro.ltr.ranker.qd_features_batched`` with a kernel backend): each
query's ragged per-term posting ranges are compacted into dense (Q, qcap)
lanes and reduced against the candidate grid by
``repro_torch.kernels.qd_feature_gather`` — the CUDA kernel on the card,
its plain version on the CPU.  The sums are taken lane by lane in term
order from 0.0, the order of the reference's term-by-term CSR search, so
every feature matches the reference bit for bit.

Training: ``qd_features`` is the reference's per-query NumPy loop (one CSR
``searchsorted`` per query term), which both training sets of
``SearchSystem.fit`` use (the pseudo-label one, and ``ltr_training_set``
from the oracle's reference lists), and ``train_ltr`` fits the point-wise
L2 GBRT (``gbrt.fit``, on the card unless the caller names the CPU).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import gbrt
from repro_torch.isn.backend import compact_lanes
from repro_torch.kernels.qd_feature_gather.ops import qd_feature_gather
from repro_torch.serving.telemetry.host import span

N_LTR_FEATURES = 8


def qd_features(index, corpus, terms_row, mask_row, topic, doc_ids):
    """Per-(query, doc) LTR features for a candidate list (NumPy, the
    reference's per-query loop)."""
    t = terms_row[mask_row > 0]
    feats = np.zeros((len(doc_ids), N_LTR_FEATURES), np.float32)
    dl = index.doclen[doc_ids].astype(np.float32)
    feats[:, 0] = np.log1p(dl)
    # per-term exact scores via CSR binary search
    bm25 = np.zeros(len(doc_ids), np.float32)
    n_match = np.zeros(len(doc_ids), np.float32)
    mx = np.zeros(len(doc_ids), np.float32)
    for tt in t:
        lo, hi = index.offsets[tt], index.offsets[tt + 1]
        if hi <= lo:
            continue                      # term absent from this shard
        seg = index.docs[lo:hi]
        pos = np.searchsorted(seg, doc_ids)
        pos = np.minimum(pos, hi - lo - 1)
        hit = seg[pos] == doc_ids
        sc = np.where(hit, index.bm25_score[lo:hi][pos], 0.0)
        bm25 += sc
        mx = np.maximum(mx, sc)
        n_match += hit
    feats[:, 1] = bm25
    feats[:, 2] = mx
    feats[:, 3] = n_match / max(len(t), 1)
    feats[:, 4] = bm25 / np.maximum(dl, 1.0)
    feats[:, 5] = corpus.doc_topics[doc_ids, topic]
    feats[:, 6] = corpus.doc_topics[doc_ids].max(axis=1)
    feats[:, 7] = len(t)
    return feats


class Stage2Arrays(NamedTuple):
    """Device-resident inputs of the batched Stage-2 featurizer."""
    offsets: torch.Tensor        # (V+1,) int32 — doc-ordered CSR
    docs: torch.Tensor           # (P,) int32, doc-sorted within each term
    score: torch.Tensor          # (P,) float32 exact BM25
    doclen: torch.Tensor         # (N,) float32
    log1p_doclen: torch.Tensor   # (N,) float32 — np.log1p table (exactness)
    doc_topics: torch.Tensor     # (N, K) float32
    doc_topics_max: torch.Tensor  # (N,) float32 — row max, precomputed


def stage2_arrays(index, corpus, device) -> Stage2Arrays:
    """Materialize the Stage-2 gather tables from the index + corpus on
    ``device`` (transcendentals precomputed host-side with NumPy, as the
    reference does)."""
    dl32 = index.doclen.astype(np.float32)

    def dev(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    return Stage2Arrays(
        offsets=dev(index.offsets, np.int32),
        docs=dev(index.docs, np.int32),
        score=dev(index.bm25_score, np.float32),
        doclen=dev(dl32, np.float32),
        log1p_doclen=dev(np.log1p(dl32), np.float32),
        doc_topics=dev(corpus.doc_topics, np.float32),
        doc_topics_max=dev(corpus.doc_topics.max(axis=1), np.float32),
    )


def csr_search_iters(max_df: int) -> int:
    """Bisection steps that exhaust a posting range of ``max_df`` entries
    (the reference's CSR-search depth; kept for interface parity)."""
    return max(1, int(np.ceil(np.log2(max(max_df, 2)))) + 1)


def _lane_term_stats(offsets, docs, score, terms, tmask, cand, qcap: int,
                     p_tile: int):
    """Kernel-backed aggregates: compact the batch's ragged per-term posting
    ranges into (Q, qcap) dense lanes, then one ``qd_feature_gather``
    launch over the candidate grid.  Returns (Σ score, max score, match
    count as float32)."""
    t = terms.long()
    base = offsets[t].long()                              # (Q, L)
    dfs = (offsets[t + 1].long() - base) * tmask.long()
    pos, live = compact_lanes(base, dfs, qcap)
    pos = torch.clamp(pos, max=docs.shape[0] - 1)
    lane_docs = torch.where(live, docs[pos], -1)
    lane_scores = torch.where(live, score[pos], 0.0)
    bm25, mx, cnt = qd_feature_gather(lane_docs, lane_scores, cand,
                                      p_tile=p_tile)
    return bm25, mx, cnt.to(torch.float32)


@span("stage2.features")
def qd_features_batched(arrs: Stage2Arrays, terms: torch.Tensor,
                        mask: torch.Tensor, topics: torch.Tensor,
                        cand: torch.Tensor, *, qcap: int,
                        p_tile: int = 512) -> torch.Tensor:
    """LTR features for the whole (Q, C) candidate grid (the reference's
    kernel-backend path).

    Args:
      arrs: ``stage2_arrays`` gather tables.
      terms/mask: (Q, L) padded query terms.
      topics: (Q,) query topic ids.
      cand: (Q, C) candidate doc ids, -1 padding (padded rows yield garbage
        features — mask downstream, as ``rerank_batched`` does); ids past
        the sealed collection (live delta docs) read the last sealed doc's
        per-doc features, as the reference's clamped gathers do.
      qcap: static lane budget; must bound the batch's per-query postings.
    Returns:
      (Q, C, 8) float32 feature grid.
    """
    tmask = mask > 0
    # the reference's gathers clamp out-of-range ids as JAX does (-1 padding
    # to doc 0; a live delta doc, whose global id is past the sealed
    # collection until a merge, to the last sealed doc), so its Stage-2
    # prices an unmerged delta doc with that doc's length and topics
    c_safe = torch.clamp(cand.long(), min=0, max=arrs.doclen.shape[0] - 1)
    bm25, mx, nm = _lane_term_stats(arrs.offsets, arrs.docs, arrs.score,
                                    terms, tmask, cand, qcap, p_tile)
    dl = arrs.doclen[c_safe]                             # (Q, C)
    n_terms = tmask.float().sum(dim=1)
    feats = torch.stack([
        arrs.log1p_doclen[c_safe],
        bm25,
        mx,
        nm / torch.clamp(n_terms, min=1.0)[:, None],
        bm25 / torch.clamp(dl, min=1.0),
        arrs.doc_topics[c_safe, topics.long()[:, None]],
        arrs.doc_topics_max[c_safe],
        n_terms[:, None].expand(c_safe.shape),
    ], dim=-1)
    return feats.float()


@dataclass
class LTRModel:
    model: gbrt.GBRTModel

    def score(self, feats: torch.Tensor) -> torch.Tensor:
        return gbrt.predict(self.model, feats)


def train_ltr(feats: np.ndarray, gains: np.ndarray, n_trees: int = 48,
              device: str | torch.device | None = None) -> LTRModel:
    """The point-wise LTR GBRT (L2 loss, depth 4, learning rate 0.2) fitted
    on ``device`` (the card unless the caller names the CPU)."""
    m = gbrt.fit(feats, gains.astype(np.float32),
                 gbrt.GBRTParams(n_trees=n_trees, depth=4, loss="l2",
                                 learning_rate=0.2), device=device)
    return LTRModel(m)


def ltr_training_set(index, corpus, ql, ref_lists, rows,
                     n_pos: int = 24, n_neg: int = 24, seed: int = 0):
    """(features, gains) pairs from reference lists: graded gains for the
    top reference docs, zero for random negatives (NumPy, the reference's
    loop and its ``RandomState(seed)`` draws)."""
    rng = np.random.RandomState(seed)
    feats, gains = [], []
    for q in rows:
        pos = ref_lists[q][:n_pos]
        neg = rng.randint(0, index.n_docs, n_neg)
        docs = np.concatenate([pos, neg]).astype(np.int64)
        g = np.concatenate([1.0 / np.log2(np.arange(len(pos)) + 2),
                            np.zeros(len(neg))])
        feats.append(qd_features(index, corpus, ql.terms[q], ql.mask[q],
                                 ql.topic[q], docs))
        gains.append(g)
    return np.concatenate(feats), np.concatenate(gains).astype(np.float32)
