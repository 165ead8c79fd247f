"""Append-only delta tile-set: the mutable half of the index layer.

A sealed index never changes; documents fed while serving land in a
``DeltaStore`` — a capacity-bounded segment materialized as one extra
``IndexShard`` (the *delta pseudo-shard*) that both lexical engines and the
dense engine scan alongside the sealed shards.  Three disciplines make live
results converge bit-exactly to a from-scratch rebuild:

* **Frozen statistics** — delta postings are scored and quantized with the
  sealed index's collection stats (``CollectionStats``), so a posting's
  score is a pure function of (tf, dl, sealed stats) and does not drift as
  the delta fills.
* **Global ids above the sealed collection** — delta docs get ids
  ``>= sealed n_docs`` and the delta segment is appended *after* the sealed
  shards in the scatter-gather merge, so ``merge_shard_topk``'s
  lower-global-doc-id tie policy is preserved exactly.
* **Shape-static capacity padding** — the delta shard's arrays are padded to
  fixed capacities (``delta_docs`` / ``delta_postings``), so every fill
  level gives the kernels the same shapes: 2 tiles of 128 docs at a lane
  capacity of the postings capacity, nearly all of it -1 padding while the
  delta is young.

``merged()`` folds the retained *raw* feed (pre-stoplist, so the stoplist
can be recomputed over the combined collection) into the sealed corpus with
a per-term counted interleave and rebuilds — bit-identical to
``build_index(extend_corpus(corpus, feed))``, the independent oracle.

The port of ``repro.index.delta`` (NumPy on the host, as the reference's
is): every ``_rebuild`` lays the delta shard out on the host
(``postings.shard_layout`` with the capacity overrides) and copies it with
``shard_to_device`` to the store's device (the card unless the caller asks
for the CPU).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.index.builder import (CollectionStats, InvertedIndex,
                                       assemble_index, build_index,
                                       frozen_stats)
from repro_torch.index.corpus import Corpus, FeedDocs
from repro_torch.index.postings import (IndexShard, IndexShardSpec,
                                        shard_layout, shard_to_device)
from repro_torch.isn.backend import resolve_device


def _round_up(x: int, m: int) -> int:
    return -(-max(int(x), 1) // m) * m


def merge_feed_postings(corpus: Corpus, feed: FeedDocs) -> Corpus:
    """Interleave raw feed postings into the sealed corpus in O(P).

    Both inputs are (term, doc)-sorted and every feed doc id rebases above
    the sealed collection, so within each term the sealed slice precedes the
    feed slice — a counted interleave reproduces the combined (term, doc)
    sort order without a global lexsort over all postings.
    """
    v = corpus.vocab
    n, m = corpus.n_docs, feed.n_docs
    ct, cd, cf = corpus.postings_term, corpus.postings_doc, corpus.postings_tf
    dt = feed.postings_term
    dd = feed.postings_doc.astype(np.int32) + n
    df_tf = feed.postings_tf

    cnt_s = np.bincount(ct, minlength=v).astype(np.int64)
    cnt_d = np.bincount(dt, minlength=v).astype(np.int64)
    off = np.zeros(v + 1, np.int64)
    np.cumsum(cnt_s + cnt_d, out=off[1:])
    start_s = np.zeros(v + 1, np.int64)
    np.cumsum(cnt_s, out=start_s[1:])
    start_d = np.zeros(v + 1, np.int64)
    np.cumsum(cnt_d, out=start_d[1:])

    pos_s = off[ct] + (np.arange(len(ct), dtype=np.int64) - start_s[ct])
    pos_d = (off[dt] + cnt_s[dt]
             + (np.arange(len(dt), dtype=np.int64) - start_d[dt]))

    p = len(ct) + len(dt)
    term = np.empty(p, np.int32)
    doc = np.empty(p, np.int32)
    tf = np.empty(p, np.int32)
    term[pos_s], term[pos_d] = ct, dt
    doc[pos_s], doc[pos_d] = cd, dd
    tf[pos_s], tf[pos_d] = cf, df_tf

    params = dataclasses.replace(corpus.params, n_docs=n + m)
    return Corpus(
        params,
        np.concatenate([corpus.doclen, feed.doclen]).astype(np.int32),
        term, doc, tf,
        np.concatenate([corpus.doc_topics, feed.doc_topics]),
        corpus.topic_perm, corpus.zipf_probs)


class DeltaStore:
    """Capacity-bounded live segment over a sealed ``InvertedIndex``, its
    shard on ``device`` (the card unless the caller asks for the CPU)."""

    def __init__(self, index: InvertedIndex, *, capacity_docs: int,
                 capacity_postings: int, tile_d: int = 128,
                 n_levels: int = 255,
                 device: str | torch.device | None = None):
        if capacity_docs < 1 or capacity_postings < 1:
            raise ValueError("delta capacities must be >= 1")
        self.capacity_docs = int(capacity_docs)
        self.capacity_postings = int(capacity_postings)
        self.tile_d = int(tile_d)
        self.n_levels = int(n_levels)
        self.device = resolve_device(device)
        self.reset(index)

    # ------------------------------------------------------------------ state
    def reset(self, index: InvertedIndex) -> None:
        """(Re)anchor on a sealed index: freeze its stats, empty the feed."""
        self.frozen: CollectionStats = frozen_stats(index)
        self.stoplist = np.asarray(
            index.stoplist if index.stoplist is not None else [], np.int64)
        self.stop_k = int(len(self.stoplist))
        self.block_size = index.block_size
        self.vocab = index.vocab
        self.base_docs = index.n_docs       # global id of delta doc 0
        # raw retained feed (pre-stoplist; delta-local doc ids, unsorted)
        self._raw_term = np.zeros(0, np.int32)
        self._raw_doc = np.zeros(0, np.int32)
        self._raw_tf = np.zeros(0, np.int32)
        self._raw_doclen = np.zeros(0, np.int32)
        self._topics = None
        self.n_docs = 0
        self.n_postings_kept = 0
        self._rebuild()

    def admit_count(self, feed: FeedDocs) -> int:
        """How many leading docs of ``feed`` fit the remaining capacity."""
        room_docs = self.capacity_docs - self.n_docs
        if room_docs <= 0:
            return 0
        keep = ~np.isin(feed.postings_term, self.stoplist)
        per_doc = np.bincount(feed.postings_doc[keep],
                              minlength=feed.n_docs).astype(np.int64)
        cum = np.cumsum(per_doc)
        room_p = self.capacity_postings - self.n_postings_kept
        fit = int(np.searchsorted(cum, room_p, side="right"))
        return min(fit, room_docs, feed.n_docs)

    def add(self, feed: FeedDocs) -> int:
        """Append the longest admissible prefix of ``feed``; returns the doc
        count actually ingested (0 = full, caller should merge first)."""
        take = self.admit_count(feed)
        if take == 0:
            if self.n_docs == 0 and feed.n_docs > 0:
                raise ValueError(
                    "delta capacity too small for a single feed doc")
            return 0
        sel = feed.postings_doc < take
        self._raw_term = np.concatenate(
            [self._raw_term, feed.postings_term[sel]])
        self._raw_doc = np.concatenate(
            [self._raw_doc, feed.postings_doc[sel] + self.n_docs])
        self._raw_tf = np.concatenate([self._raw_tf, feed.postings_tf[sel]])
        self._raw_doclen = np.concatenate(
            [self._raw_doclen, feed.doclen[:take]])
        topics = feed.doc_topics[:take]
        self._topics = (topics if self._topics is None or not len(self._topics)
                        else np.concatenate([self._topics, topics]))
        self.n_docs += take
        self._rebuild()
        return take

    @property
    def doc_topics(self) -> np.ndarray:
        return (self._topics if self._topics is not None
                else np.zeros((0, 1), np.float32))

    def _rebuild(self) -> None:
        """Re-tile the (stoplist-filtered, frozen-scored) live postings into
        a capacity-padded shard on the store's device.  Every rebuild emits
        identical shapes.  The shard is a new object each time: a served
        batch that holds the previous one keeps it."""
        keep = ~np.isin(self._raw_term, self.stoplist)
        term = self._raw_term[keep].astype(np.int64)
        doc = self._raw_doc[keep].astype(np.int64)
        tf = self._raw_tf[keep].astype(np.float64)
        order = np.lexsort((doc, term))
        term, doc, tf = term[order], doc[order], tf[order]
        self.n_postings_kept = int(len(term))

        doclen = np.zeros(self.capacity_docs, np.int32)
        doclen[:self.n_docs] = self._raw_doclen
        mini = assemble_index(term, doc, tf, doclen, self.vocab,
                              block_size=self.block_size,
                              n_levels=self.n_levels,
                              stoplist=self.stoplist, frozen=self.frozen)
        self.index = mini
        self.shard, self.shard_spec = shard_to_device(shard_layout(
            mini, 0, self.capacity_docs, tile_d=self.tile_d,
            tile_cap=_round_up(self.capacity_postings, 128),
            pad_postings=self.capacity_postings,
            max_df=self.capacity_docs,
            max_blocks_per_term=mini.n_blocks), self.device)
        self.level_cum = np.asarray(mini.level_cum)

    # ------------------------------------------------------------------ merge
    def raw_feed(self) -> FeedDocs:
        """All retained feed docs as one (term, doc)-sorted raw batch."""
        order = np.lexsort((self._raw_doc, self._raw_term))
        return FeedDocs(
            doclen=self._raw_doclen,
            doc_topics=self.doc_topics if self.n_docs else
            np.zeros((0, 1), np.float32),
            postings_term=self._raw_term[order],
            postings_doc=self._raw_doc[order],
            postings_tf=self._raw_tf[order])

    def merged(self, corpus: Corpus) -> tuple[Corpus, InvertedIndex]:
        """Fold the delta into the sealed collection.

        The combined corpus is produced by the counted interleave and the
        index rebuilt from scratch over it — including a recomputed stoplist
        (the raw feed is retained pre-stoplist precisely so term drift can
        re-rank the stop set).  Bit-identical to
        ``build_index(extend_corpus(corpus, self.raw_feed()))``.
        """
        new_corpus = merge_feed_postings(corpus, self.raw_feed())
        new_index = build_index(new_corpus, block_size=self.block_size,
                                n_levels=self.n_levels, stop_k=self.stop_k)
        return new_corpus, new_index

    # ------------------------------------------------------------------ views
    def segment(self) -> tuple[IndexShard, IndexShardSpec]:
        return self.shard, self.shard_spec

    @property
    def fill(self) -> float:
        """Fraction of the *binding* capacity axis in use (docs or
        postings, whichever runs out first)."""
        return max(self.n_docs / self.capacity_docs,
                   self.n_postings_kept / self.capacity_postings)

    def stats(self) -> dict:
        return {
            "delta_docs": int(self.n_docs),
            "delta_postings": int(self.n_postings_kept),
            "capacity_docs": self.capacity_docs,
            "capacity_postings": self.capacity_postings,
            "fill": float(self.fill),
            "base_docs": int(self.base_docs),
        }

    def export_metrics(self, reg) -> None:
        """Mirror delta occupancy into a telemetry registry (the ingest
        backpressure surface: fill drives the feed/merge gates)."""
        for k, v in self.stats().items():
            reg.gauge("ingest", key=k).set(v)
