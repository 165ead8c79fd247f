"""The benchmark's own copy of the synthetic collection and query trace.

A frozen copy of ``repro_torch.index.corpus.build_corpus`` and
``build_queries`` (NumPy, host side): the program may change, the
yardstick may not, so the benchmark makes its data with its own copy.
Same parameters and seed give the same arrays as the program's generator.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class CorpusParams:
    n_docs: int = 65536
    vocab: int = 32768
    avg_doclen: int = 150
    zipf_a: float = 1.15          # background term distribution skew
    n_topics: int = 32
    topical_fraction: float = 0.35
    seed: int = 1


# the arrays of a collection, as ``build_corpus`` returns them
CORPUS_FIELDS = ("doclen", "postings_term", "postings_doc", "postings_tf",
                 "doc_topics", "topic_perm", "zipf_probs")


def _zipf_probs(vocab: int, a: float) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** (-a)
    return (p / p.sum()).astype(np.float64)


GUMBEL_ROWS = 4096


def _gumbel_topics(rng, doc_topics, tok_doc):
    """Gumbel-max topic of each token over its doc's mixture, drawn
    ``GUMBEL_ROWS`` rows at a time from one stream."""
    m, k = len(tok_doc), doc_topics.shape[1]
    out = np.empty(m, np.int32)
    for lo in range(0, m, GUMBEL_ROWS):
        hi = min(lo + GUMBEL_ROWS, m)
        g = rng.random_sample((hi - lo, k))
        g += 1e-12
        np.log(g, out=g)
        np.negative(g, out=g)
        g += 1e-12
        np.log(g, out=g)
        np.subtract(np.log(doc_topics[tok_doc[lo:hi]]), g, out=g)
        out[lo:hi] = np.argmax(g, axis=1)
    return out


def build_corpus(params: CorpusParams) -> dict:
    """The collection's arrays (``CORPUS_FIELDS``): postings sorted by
    (term, doc), doc ids clustered by dominant topic."""
    rng = np.random.RandomState(params.seed)
    n, v, k = params.n_docs, params.vocab, params.n_topics

    doclen = np.maximum(
        rng.lognormal(mean=np.log(params.avg_doclen), sigma=0.6, size=n), 8
    ).astype(np.int64)
    total = int(doclen.sum())

    alpha = 0.08
    gam = rng.gamma(alpha, size=(n, k)).astype(np.float32) + 1e-8
    doc_topics = gam / gam.sum(axis=1, keepdims=True)

    zipf = _zipf_probs(v, params.zipf_a)
    cdf = np.cumsum(zipf)

    tok_doc = np.repeat(np.arange(n, dtype=np.int32), doclen)
    u = rng.random_sample(total)
    tok_term = np.searchsorted(cdf, u).astype(np.int32)
    tok_term = np.minimum(tok_term, v - 1)

    topical = rng.random_sample(total) < params.topical_fraction
    n_topical = int(topical.sum())
    tok_topic = _gumbel_topics(rng, doc_topics, tok_doc[topical])
    topic_perm = np.stack([rng.permutation(v).astype(np.int32)
                           for _ in range(k)])
    base_draw = np.minimum(
        np.searchsorted(cdf, rng.random_sample(n_topical)), v - 1)
    tok_term[topical] = topic_perm[tok_topic, base_draw]

    dominant = np.argmax(doc_topics, axis=1)
    order = np.argsort(dominant, kind="stable").astype(np.int32)
    inv = np.empty(n, np.int32)
    inv[order] = np.arange(n, dtype=np.int32)
    tok_doc = inv[tok_doc]
    doclen = doclen[order]
    doc_topics = doc_topics[order]

    key = tok_term.astype(np.int64) * n + tok_doc.astype(np.int64)
    uniq, counts = np.unique(key, return_counts=True)
    return dict(doclen=doclen.astype(np.int32),
                postings_term=(uniq // n).astype(np.int32),
                postings_doc=(uniq % n).astype(np.int32),
                postings_tf=counts.astype(np.int32),
                doc_topics=doc_topics, topic_perm=topic_perm,
                zipf_probs=zipf.astype(np.float32))


def build_queries(corpus: dict, n_queries: int, *, seed: int,
                  max_len: int = 8, min_terms: int = 2, max_terms: int = 5,
                  stop_k: int = 64, zipf_power: float = 0.65,
                  topical_share: float = 0.5):
    """MQ2009-like trace: lengths ``min_terms``..``max_terms``, terms drawn
    from the background Zipf raised to ``zipf_power`` (its top ``stop_k``
    ranks stopped) or, with probability ``topical_share``, from the query
    topic's permutation of it.  Returns (terms (Q, L) int32, mask (Q, L)
    float32, topic (Q,) int32).  At the defaults this is the program's
    ``build_queries`` draw for draw."""
    rng = np.random.RandomState(seed)
    zipf = corpus["zipf_probs"]
    perm = corpus["topic_perm"]
    v = len(zipf)
    k = perm.shape[0]
    lengths = rng.randint(min_terms, max_terms + 1, size=n_queries)
    topic = rng.randint(0, k, size=n_queries).astype(np.int32)

    probs = zipf ** zipf_power
    probs[:stop_k] = 0.0
    probs = probs / probs.sum()
    cdf = np.cumsum(probs)

    terms = np.zeros((n_queries, max_len), np.int32)
    mask = np.zeros((n_queries, max_len), np.float32)
    for q in range(n_queries):
        n_l = lengths[q]
        draws = np.minimum(np.searchsorted(cdf, rng.random_sample(n_l)),
                           v - 1)
        topical = rng.random_sample(n_l) < topical_share
        draws[topical] = perm[topic[q], draws[topical]]
        draws = np.unique(draws)[:n_l]
        terms[q, :len(draws)] = draws
        mask[q, :len(draws)] = 1.0
    return terms, mask, topic
