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
package); the live-feed helpers of the ingest path are not ported yet.
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
    logits = np.log(doc_topics[tok_doc[topical]])
    gumbel = -np.log(-np.log(rng.random_sample((n_topical, k)) + 1e-12) + 1e-12)
    tok_topic = np.argmax(logits + gumbel, axis=1).astype(np.int32)
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
