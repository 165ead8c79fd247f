"""The plain reference's index: postings, BM25 scores, quantized impacts
and the Stage-0 term statistics, worked out again from the collection
(NumPy, host side).

The scoring, quantization and term-statistics arithmetic is a frozen copy
of the program's index build (``repro_torch.index.scoring``,
``builder.assemble_index`` / ``_per_term_stats``), so that the reference's
float32 values are the ones the definition gives.  Nothing here reads
what the program built.
"""

from __future__ import annotations

import numpy as np

LOG2E = np.log2(np.e)
N_LEVELS = 255


def bm25(tf, df, dl, n_docs, avg_dl, k1=0.9, b=0.4):
    idf = np.log(1.0 + (n_docs - df + 0.5) / (df + 0.5))
    norm = tf + k1 * (1.0 - b + b * dl / avg_dl)
    return idf * tf * (k1 + 1.0) / norm


def _tfidf(tf, df, n_docs):
    return (1.0 + np.log(tf)) * np.log(1.0 + n_docs / df)


def _ql_dirichlet(tf, cf, dl, total_tokens, mu=1500.0):
    p_c = cf / total_tokens
    return np.log1p(tf / (mu * p_c)) + np.log(mu / (dl + mu))


def _bose_einstein(tf, cf, n_docs):
    lam = cf / n_docs
    return tf * np.log2((1.0 + lam) / lam) + np.log2(1.0 + lam)


def _dph(tf, cf, dl, n_docs, avg_dl):
    f = np.clip(tf / dl, 1e-9, 1.0 - 1e-9)
    norm = (1.0 - f) ** 2 / (tf + 1.0)
    return norm * (tf * np.log2(np.maximum(
        tf * (avg_dl / dl) * (n_docs / cf), 1e-9))
        + 0.5 * np.log2(np.maximum(2.0 * np.pi * tf * (1.0 - f), 1e-9)))


def _pl2(tf, cf, dl, n_docs, avg_dl, c=1.0):
    tfn = tf * np.log2(1.0 + c * avg_dl / dl)
    lam = np.maximum(cf / n_docs, 1e-9)
    tfn = np.maximum(tfn, 1e-6)
    return (1.0 / (tfn + 1.0)) * (
        tfn * np.log2(tfn / lam) + (lam - tfn) * LOG2E
        + 0.5 * np.log2(np.maximum(2.0 * np.pi * tfn, 1e-9)))


def _term_stats(term, scores, offsets, df, vocab):
    """{max, amean, gmean, hmean, median, std} of one similarity column's
    postings, per term."""
    nz = np.maximum(df.astype(np.float64), 1.0)
    shifted = scores - scores.min() + 1e-3
    s1 = np.bincount(term, weights=shifted, minlength=vocab)
    s2 = np.bincount(term, weights=shifted ** 2, minlength=vocab)
    slog = np.bincount(term, weights=np.log(shifted), minlength=vocab)
    sinv = np.bincount(term, weights=1.0 / shifted, minlength=vocab)
    amean = s1 / nz
    gmean = np.exp(slog / nz)
    hmean = nz / np.maximum(sinv, 1e-12)
    std = np.sqrt(np.maximum(s2 / nz - amean ** 2, 0.0))
    has = df > 0
    present = np.flatnonzero(has)
    mx = np.zeros(vocab)
    med = np.zeros(vocab)
    if len(present):
        starts = offsets[present]
        mx[present] = np.maximum.reduceat(shifted, starts)
        for t, lo, hi, k in zip(present.tolist(), starts.tolist(),
                                offsets[present + 1].tolist(),
                                ((df[present] - 1) // 2).tolist()):
            med[t] = np.partition(shifted[lo:hi], k)[k]
    cols = np.stack([mx, amean, gmean, hmean, med, std], axis=1)
    return np.where(has[:, None], cols, 0.0).astype(np.float32)


def build(corpus: dict, *, stop_k: int, block_size: int) -> dict:
    """The reference index of a collection (``data.corpus`` arrays): the
    ``stop_k`` most frequent terms dropped, BM25 (k1 0.9, b 0.4) as
    float32, impacts quantized to 1..255 on the largest score (the
    postings at or above each level are counted where a query needs
    them, ``stage1.level_totals``), the (V, 36) term
    statistics of six similarity functions, and the postings' blocks of
    ``block_size`` docs."""
    term = corpus["postings_term"]
    doc = corpus["postings_doc"]
    tf = corpus["postings_tf"].astype(np.float64)
    doclen = corpus["doclen"]
    v = len(corpus["zipf_probs"])
    n = len(doclen)
    if stop_k > 0:
        cf_all = np.bincount(term, weights=tf, minlength=v)
        keep = ~np.isin(term, np.argsort(-cf_all)[:stop_k])
        term, doc, tf = term[keep], doc[keep], tf[keep]
    df = np.bincount(term, minlength=v).astype(np.int64)
    cf = np.bincount(term, weights=tf, minlength=v)
    offsets = np.zeros(v + 1, np.int64)
    np.cumsum(df, out=offsets[1:])
    dl = doclen.astype(np.float64)[doc]
    avg_dl = float(doclen.astype(np.float64).mean())
    total = float(doclen.astype(np.float64).sum())
    df_p, cf_p = df[term].astype(np.float64), cf[term]
    sims = [_tfidf(tf, df_p, n), bm25(tf, df_p, dl, n, avg_dl),
            _ql_dirichlet(tf, cf_p, dl, total), _bose_einstein(tf, cf_p, n),
            _dph(tf, cf_p, dl, n, avg_dl), _pl2(tf, cf_p, dl, n, avg_dl)]
    sims = [s.astype(np.float32) for s in sims]
    score = sims[1]
    smax = float(score.max())
    impact = np.clip(np.ceil(score / smax * N_LEVELS).astype(np.int32), 1,
                     N_LEVELS).astype(np.uint8)
    stats = np.concatenate([_term_stats(term, s.astype(np.float64), offsets,
                                        df, v) for s in sims], axis=1)
    # (term, block) pairs holding a posting: the block maxima BMW reads
    key = term.astype(np.int64) * (n // block_size + 1) + doc // block_size
    first = np.r_[True, key[1:] != key[:-1]] if len(key) else key > 0
    term_blocks = np.bincount(term[first], minlength=v)
    return dict(offsets=offsets, docs=doc.astype(np.int32), score=score,
                impact=impact, df=df.astype(np.int32), term_stats=stats,
                term_blocks=term_blocks,
                doclen=doclen.astype(np.int32),
                n_docs=np.int64(n), block_size=np.int64(block_size))
