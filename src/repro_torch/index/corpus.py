"""Synthetic web-scale corpus + query workload generator.

ClueWeb09B and the MQ2009 query trace cannot ship in this repository, so we
generate a corpus with the statistical properties the paper's mechanisms
depend on:

* Zipfian term-frequency distribution (drives postings-list length skew →
  the heavy-tailed per-query work distribution behind tail latencies);
* log-normal document lengths (drives BM25 length normalization);
* latent topic structure shared between documents and queries, giving an
  "ideal" final-stage ranker (BM25 + topical affinity) that genuinely
  disagrees with first-stage BM25 on hard queries — which is what makes the
  oracle-k / oracle-ρ label distributions skewed, as in the paper (Fig. 2/5).

Everything here is host-side numpy (index build is offline in production).
A copy of ``repro.index.corpus`` (the port imports nothing of the reference
package), the live feed's helpers (``FeedDocs``, ``slice_feed``,
``synthesize_feed_docs``, ``extend_corpus``) included.
"""

from __future__ import annotations

import dataclasses
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


@dataclass
class Corpus:
    params: CorpusParams
    doclen: np.ndarray            # (N,) int32
    postings_term: np.ndarray     # (P,) int32, sorted by (term, doc)
    postings_doc: np.ndarray      # (P,) int32
    postings_tf: np.ndarray       # (P,) int32
    doc_topics: np.ndarray        # (N, K) float32 topic mixtures
    topic_perm: np.ndarray        # (K, V) int32 topic-specific term permutation
    zipf_probs: np.ndarray        # (V,) float32

    @property
    def n_docs(self) -> int:
        return self.params.n_docs

    @property
    def vocab(self) -> int:
        return self.params.vocab

    @property
    def n_postings(self) -> int:
        return self.postings_term.shape[0]


def _zipf_probs(vocab: int, a: float) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** (-a)
    return (p / p.sum()).astype(np.float64)


# rows of the topical tokens' uniform draw taken and reduced at a time
GUMBEL_ROWS = 4096


def _gumbel_topics(rng: np.random.RandomState, doc_topics: np.ndarray,
                   tok_doc: np.ndarray) -> np.ndarray:
    """Gumbel-max topic of each token over its doc's mixture:
    ``argmax(log(doc_topics[tok_doc]) - log(-log(u + 1e-12) + 1e-12))``
    with ``u`` one ``(len(tok_doc), k)`` uniform draw.  The draw is taken
    ``GUMBEL_ROWS`` rows at a time (the same stream) and reduced in place,
    so the full matrix never exists; every value is the one-shot
    formula's."""
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


def build_corpus(params: CorpusParams = CorpusParams()) -> Corpus:
    rng = np.random.RandomState(params.seed)
    n, v, k = params.n_docs, params.vocab, params.n_topics

    doclen = np.maximum(
        rng.lognormal(mean=np.log(params.avg_doclen), sigma=0.6, size=n), 8
    ).astype(np.int64)
    total = int(doclen.sum())

    # document topic mixtures (sparse dirichlet via gamma)
    alpha = 0.08
    gam = rng.gamma(alpha, size=(n, k)).astype(np.float32) + 1e-8
    doc_topics = gam / gam.sum(axis=1, keepdims=True)

    zipf = _zipf_probs(v, params.zipf_a)
    cdf = np.cumsum(zipf)

    # token -> doc assignment
    tok_doc = np.repeat(np.arange(n, dtype=np.int32), doclen)

    # background terms: inverse-CDF Zipf sampling
    u = rng.random_sample(total)
    tok_term = np.searchsorted(cdf, u).astype(np.int32)
    tok_term = np.minimum(tok_term, v - 1)

    # topical terms: topic id per token (gumbel-max over doc mixture), then a
    # topic-permuted Zipf draw so each topic concentrates on its own terms
    topical = rng.random_sample(total) < params.topical_fraction
    n_topical = int(topical.sum())
    tok_topic = _gumbel_topics(rng, doc_topics, tok_doc[topical])
    topic_perm = np.stack([rng.permutation(v).astype(np.int32) for _ in range(k)])
    base_draw = np.minimum(
        np.searchsorted(cdf, rng.random_sample(n_topical)), v - 1)
    tok_term[topical] = topic_perm[tok_topic, base_draw]

    # URL-style docid reordering (Silvestri 2007; the paper's §2 notes this
    # improves both compression and pruning): cluster docids by dominant
    # topic so postings of topical terms are block-local, which is what
    # gives BMW's per-block upper bounds their discriminative power.
    dominant = np.argmax(doc_topics, axis=1)
    order = np.argsort(dominant, kind="stable").astype(np.int32)
    inv = np.empty(n, np.int32)
    inv[order] = np.arange(n, dtype=np.int32)
    tok_doc = inv[tok_doc]
    doclen = doclen[order]
    doc_topics = doc_topics[order]

    # aggregate to postings: unique (term, doc) with counts
    key = tok_term.astype(np.int64) * n + tok_doc.astype(np.int64)
    uniq, counts = np.unique(key, return_counts=True)
    postings_term = (uniq // n).astype(np.int32)
    postings_doc = (uniq % n).astype(np.int32)
    postings_tf = counts.astype(np.int32)

    return Corpus(params, doclen.astype(np.int32), postings_term, postings_doc,
                  postings_tf, doc_topics, topic_perm, zipf.astype(np.float32))


@dataclass(frozen=True)
class FeedDocs:
    """A batch of freshly crawled documents awaiting ingest.

    Doc ids are *local* to the batch (0..n_docs); the delta store rebases
    them above the sealed collection when it appends. Postings are raw
    (pre-stoplist) and (term, doc)-sorted, exactly the corpus convention, so
    a merge can interleave them with the sealed corpus without re-deriving
    anything.
    """
    doclen: np.ndarray            # (M,) int32
    doc_topics: np.ndarray        # (M, K) float32
    postings_term: np.ndarray     # (P,) int32, sorted by (term, doc)
    postings_doc: np.ndarray      # (P,) int32 batch-local
    postings_tf: np.ndarray       # (P,) int32

    @property
    def n_docs(self) -> int:
        return int(self.doclen.shape[0])

    @property
    def n_postings(self) -> int:
        return int(self.postings_term.shape[0])


def slice_feed(feed: FeedDocs, lo: int, hi: int) -> FeedDocs:
    """Docs [lo, hi) of a feed as a standalone batch (ids rebased to 0)."""
    sel = (feed.postings_doc >= lo) & (feed.postings_doc < hi)
    return FeedDocs(
        doclen=feed.doclen[lo:hi],
        doc_topics=feed.doc_topics[lo:hi],
        postings_term=feed.postings_term[sel],
        postings_doc=feed.postings_doc[sel] - lo,
        postings_tf=feed.postings_tf[sel])


def synthesize_feed_docs(corpus: Corpus, n_docs: int,
                         seed: int = 99) -> FeedDocs:
    """Draw feed documents from the same generative family as the corpus.

    Reuses the corpus's Zipf background, topic permutations, and length
    distribution so fed documents are statistically indistinguishable from
    sealed ones — but applies *no* URL-style docid reordering: a live feed
    arrives in crawl order, which is exactly the regime that stresses the
    delta tile-set (block-max bounds are weaker on unclustered postings).
    """
    rng = np.random.RandomState(seed)
    p = corpus.params
    m, v, k = n_docs, corpus.vocab, p.n_topics

    doclen = np.maximum(
        rng.lognormal(mean=np.log(p.avg_doclen), sigma=0.6, size=m), 8
    ).astype(np.int64)
    total = int(doclen.sum())

    gam = rng.gamma(0.08, size=(m, k)).astype(np.float32) + 1e-8
    doc_topics = gam / gam.sum(axis=1, keepdims=True)

    zipf = corpus.zipf_probs.astype(np.float64)
    cdf = np.cumsum(zipf / zipf.sum())

    tok_doc = np.repeat(np.arange(m, dtype=np.int32), doclen)
    u = rng.random_sample(total)
    tok_term = np.minimum(np.searchsorted(cdf, u), v - 1).astype(np.int32)

    topical = rng.random_sample(total) < p.topical_fraction
    n_topical = int(topical.sum())
    tok_topic = _gumbel_topics(rng, doc_topics, tok_doc[topical])
    base_draw = np.minimum(
        np.searchsorted(cdf, rng.random_sample(n_topical)), v - 1)
    tok_term[topical] = corpus.topic_perm[tok_topic, base_draw]

    key = tok_term.astype(np.int64) * m + tok_doc.astype(np.int64)
    uniq, counts = np.unique(key, return_counts=True)
    return FeedDocs(
        doclen=doclen.astype(np.int32),
        doc_topics=doc_topics,
        postings_term=(uniq // m).astype(np.int32),
        postings_doc=(uniq % m).astype(np.int32),
        postings_tf=counts.astype(np.int32))


def extend_corpus(corpus: Corpus, feed: FeedDocs) -> Corpus:
    """The merged collection: feed docs appended at ids >= corpus.n_docs.

    This is the from-scratch oracle the background merge must reproduce
    bit-identically — an independent construction (global lexsort rather
    than the merge's per-term counted interleave).
    """
    n, m = corpus.n_docs, feed.n_docs
    term = np.concatenate([corpus.postings_term, feed.postings_term])
    doc = np.concatenate([corpus.postings_doc,
                          feed.postings_doc.astype(np.int32) + n])
    tf = np.concatenate([corpus.postings_tf, feed.postings_tf])
    order = np.lexsort((doc, term))
    params = dataclasses.replace(corpus.params, n_docs=n + m)
    return Corpus(
        params,
        np.concatenate([corpus.doclen, feed.doclen]).astype(np.int32),
        term[order].astype(np.int32), doc[order].astype(np.int32),
        tf[order].astype(np.int32),
        np.concatenate([corpus.doc_topics, feed.doc_topics]),
        corpus.topic_perm, corpus.zipf_probs)


@dataclass
class QueryLog:
    terms: np.ndarray        # (Q, L) int32, padded with 0
    mask: np.ndarray         # (Q, L) float32
    topic: np.ndarray        # (Q,) int32 latent topic of the query intent
    lengths: np.ndarray      # (Q,) int32


def build_queries(corpus: Corpus, n_queries: int, max_len: int = 8,
                  seed: int = 7, stop_k: int = 64) -> QueryLog:
    """MQ2009-like trace: lengths 2..5 (single-term queries filtered, as in
    the paper), terms drawn from a popularity-skewed mixture of background
    and topical vocabulary.  The top ``stop_k`` background terms are stopped
    (must match ``build_index``'s stoplist)."""
    rng = np.random.RandomState(seed)
    v = corpus.vocab
    k = corpus.params.n_topics
    lengths = rng.randint(2, 6, size=n_queries)
    topic = rng.randint(0, k, size=n_queries).astype(np.int32)

    # queries favour more common terms than the collection background, but
    # never contain stopped terms
    probs = corpus.zipf_probs ** 0.65
    probs[:stop_k] = 0.0
    probs = probs / probs.sum()
    cdf = np.cumsum(probs)

    terms = np.zeros((n_queries, max_len), np.int32)
    mask = np.zeros((n_queries, max_len), np.float32)
    for q in range(n_queries):
        l = lengths[q]
        draws = np.minimum(np.searchsorted(cdf, rng.random_sample(l)), v - 1)
        topical = rng.random_sample(l) < 0.5
        draws[topical] = corpus.topic_perm[topic[q], draws[topical]]
        draws = np.unique(draws)[:l]
        terms[q, :len(draws)] = draws
        mask[q, :len(draws)] = 1.0
    return QueryLog(terms, mask, topic, lengths.astype(np.int32))
