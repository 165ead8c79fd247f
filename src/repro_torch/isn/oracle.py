"""Host-side (numpy) reference engines for the two index traversal families.

These are the *oracles*: batched, exact implementations of

  * exhaustive BM25 scoring (rank-safe DAAT ground truth),
  * BMW-style block-max pruned scoring with aggression θ (two-phase:
    threshold bootstrap from the best blocks, then block-level pruning) and
    its work model (postings scored in surviving blocks),
  * JASS-style impact-ordered anytime scoring with postings budget ρ,
  * the "ideal" final-stage ranker (BM25 + latent topical affinity) that
    provides the reference lists for MED training labels.

They process the full 31k-query trace in seconds via bincount accumulators.

A NumPy copy of ``repro.isn.oracle`` (the port imports nothing of the
reference package).  It stays on the host as the ground truth the engines
are held to, and the label oracle (``repro_torch.core.labels``) runs on it:
``argpartition`` and its stable re-sort, ``bincount`` and the float64 sums
are the reference's exactly, so the labels are too.
"""

from __future__ import annotations

import numpy as np

from repro_torch.index.builder import InvertedIndex


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _query_postings(index: InvertedIndex, terms_row, mask_row, impact_ordered,
                    prefix=None):
    """Concatenate postings slices for one query's terms (ragged, no pad).

    Returns (docs, weights, qterm_local_idx) arrays.
    """
    docs_src = index.docs_imp if impact_ordered else index.docs
    w_src = (index.imp_sorted if impact_ordered else index.bm25_score)
    segs_d, segs_w = [], []
    for j, t in enumerate(terms_row):
        if mask_row[j] <= 0:
            continue
        lo, hi = index.offsets[t], index.offsets[t + 1]
        if prefix is not None:
            hi = lo + min(prefix[j], hi - lo)
        segs_d.append(docs_src[lo:hi])
        segs_w.append(w_src[lo:hi])
    if not segs_d:
        return (np.zeros(0, np.int64), np.zeros(0, np.float32))
    return (np.concatenate(segs_d).astype(np.int64),
            np.concatenate(segs_w).astype(np.float32))


def _batch_accumulate(index, terms, mask, rows, impact_ordered=False,
                      prefixes=None):
    """Accumulate scores for a batch of queries into a (B, N) matrix."""
    n = index.n_docs
    b = len(rows)
    keys, vals = [], []
    for i, q in enumerate(rows):
        pref = None if prefixes is None else prefixes[i]
        d, w = _query_postings(index, terms[q], mask[q], impact_ordered, pref)
        keys.append(d + i * n)
        vals.append(w)
    keys = np.concatenate(keys)
    vals = np.concatenate(vals)
    acc = np.bincount(keys, weights=vals, minlength=b * n)
    return acc.reshape(b, n), int(keys.shape[0])


def _topk_ids(acc: np.ndarray, k: int):
    """Row-wise top-k (ids desc by score). acc: (B, N)."""
    k = min(k, acc.shape[1])
    part = np.argpartition(-acc, k - 1, axis=1)[:, :k]
    ps = np.take_along_axis(acc, part, axis=1)
    order = np.argsort(-ps, axis=1, kind="stable")
    return np.take_along_axis(part, order, axis=1), np.take_along_axis(ps, order, axis=1)


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

def exhaustive_scores(index, terms, mask, rows):
    acc, work = _batch_accumulate(index, terms, mask, rows)
    return acc, work


def jass_scores(index, terms, mask, rows, rho):
    """Impact-ordered anytime scoring: process whole impact segments, highest
    impact first, while the postings budget allows (JASS semantics).
    ``rho`` may be a scalar or a per-query array aligned with ``rows``."""
    rho_arr = np.broadcast_to(np.asarray(rho), (len(rows),))
    prefixes, work_per_q = [], []
    for i, q in enumerate(rows):
        t = terms[q][mask[q] > 0]
        lc = index.level_cum[t]                   # (L, 256), count with imp >= l
        total = lc.sum(axis=0)                    # (256,) descending in l... (increasing as l->0)
        # most inclusive level with total postings <= rho
        ok = total <= rho_arr[i]
        lstar = int(np.argmax(ok)) if ok.any() else 256   # levels are 0..255
        if lstar >= 256:
            pref = np.zeros(len(t), np.int64)
        else:
            pref = lc[:, lstar].astype(np.int64)
        prefixes.append(pref)
        work_per_q.append(int(pref.sum()))
    acc, _ = _batch_accumulate(index, terms, mask, rows, impact_ordered=True,
                               prefixes=prefixes)
    return acc, np.asarray(work_per_q)


def jass_work_only(index, terms, mask, rho) -> np.ndarray:
    """Vectorized postings-work for JASS at per-query budgets (no scoring).

    Used for the latency model: JASS cost is a pure function of the level
    cut, so the whole 31k-query trace resolves in one gather."""
    q = terms.shape[0]
    rho_arr = np.broadcast_to(np.asarray(rho), (q,))
    lc = index.level_cum[terms] * (mask > 0)[:, :, None]    # (Q, L, 256)
    total = lc.sum(axis=1)                                  # (Q, 256)
    ok = total <= rho_arr[:, None]
    lstar = np.argmax(ok, axis=1)
    any_ok = ok.any(axis=1)
    work = total[np.arange(q), lstar]
    return np.where(any_ok, work, 0).astype(np.int64)


def bmw_scores(index, terms, mask, rows, k, theta: float = 1.0):
    """Block-max pruned scoring (two-phase TPU-style formulation).

    Phase 1: score the blocks with the largest summed block upper bounds
    (enough blocks to cover k docs) -> valid lower-bound threshold τ.
    Phase 2: score every block whose upper bound exceeds θ·τ.
    θ = 1.0 is rank-safe; θ > 1.0 trades effectiveness for fewer blocks.
    Returns (scores (B,N), work postings, surviving blocks per query).
    """
    n, bs, nb = index.n_docs, index.block_size, index.n_blocks
    scale = index.quant_scale / 255.0
    k_arr = np.broadcast_to(np.asarray(k), (len(rows),))

    accs, works, blocks_touched = [], [], []
    for qi, q in enumerate(rows):
        k = int(k_arr[qi])
        t = terms[q][mask[q] > 0]
        ub = index.block_max[t].astype(np.float32).sum(axis=0) * scale  # (nb,)
        cnt = index.block_count[t].astype(np.int64)                     # (L, nb)
        # phase 1: walk blocks in descending upper-bound order until the
        # heap can plausibly be full (>= 2k candidate docs seen), so τ is a
        # genuine k-th-best lower bound rather than 0
        order = np.argsort(-ub, kind="stable")
        cand_docs = np.minimum(cnt.sum(axis=0), bs)[order]
        need = int(np.searchsorted(np.cumsum(cand_docs), 2 * k)) + 1
        phase1 = order[:min(max(need, 4), nb)]
        in_p1 = np.zeros(nb, bool)
        in_p1[phase1] = True

        d, w = _query_postings(index, terms[q], mask[q], False)
        blk = d // bs
        acc1 = np.bincount(d, weights=np.where(in_p1[blk], w, 0.0), minlength=n)
        kk = min(k, n)
        tau = np.partition(acc1, n - kk)[n - kk]

        survive = (ub > theta * tau) | in_p1
        acc = np.bincount(d, weights=np.where(survive[blk], w, 0.0), minlength=n)
        works.append(int(cnt[:, survive].sum()))
        blocks_touched.append(int(survive.sum()))
        accs.append(acc)
    return np.stack(accs), np.asarray(works), np.asarray(blocks_touched)


def ideal_rerank(index, corpus, terms, mask, topics, rows, acc, depth: int,
                 rerank_depth: int = 1024, gamma: float = 6.0):
    """The idealized last-stage run: re-rank BM25 top candidates by BM25 +
    latent topical affinity. Returns (B, depth) reference doc ids."""
    ids, sc = _topk_ids(acc, rerank_depth)
    out = np.zeros((len(rows), depth), np.int64)
    for i, q in enumerate(rows):
        aff = corpus.doc_topics[ids[i], topics[q]]
        final = sc[i] + gamma * aff * np.maximum(sc[i].max(), 1.0) / 10.0
        order = np.argsort(-final, kind="stable")[:depth]
        out[i] = ids[i][order]
    return out


def ranks_of(acc: np.ndarray, ref_ids: np.ndarray, max_rank: int):
    """Stage-1 rank of each reference doc (capped); (B, depth) int32."""
    b, n = acc.shape
    kk = min(max_rank, n)
    top_ids, top_sc = _topk_ids(acc, kk)
    out = np.full(ref_ids.shape, 1 << 30, np.int64)
    for i in range(b):
        pos = np.full(n, 1 << 30, np.int64)
        pos[top_ids[i]] = np.arange(kk)
        out[i] = pos[ref_ids[i]]
    return out
