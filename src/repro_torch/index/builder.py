"""Index construction: document-ordered (block-max) and impact-ordered
(quantized, JASS-style) layouts plus the Stage-0 per-term statistics table.

Mirrors the paper's setup: one corpus, two physical index layouts serving as
"index mirrors" on different ISN replicas — a BMW-style block-max index for
rank-safe DAAT and an ATIRE/JASS-style impact-ordered index for anytime SAAT.

Host-side NumPy copy of ``repro.index.builder`` (the port imports nothing
of the reference package), the live delta segment's frozen statistics
(``CollectionStats``, ``assemble_index(..., frozen=)``) included.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.index import scoring
from repro_torch.index.corpus import Corpus
from repro_torch.serving.telemetry.host import phase


@dataclass
class InvertedIndex:
    # collection stats
    n_docs: int
    vocab: int
    avg_dl: float
    total_tokens: float
    doclen: np.ndarray             # (N,)
    df: np.ndarray                 # (V,)
    cf: np.ndarray                 # (V,)

    # document-ordered CSR (sorted by term, doc)
    offsets: np.ndarray            # (V+1,)
    docs: np.ndarray               # (P,)
    tf: np.ndarray                 # (P,)
    bm25_score: np.ndarray         # (P,) float32 exact scores
    impact: np.ndarray             # (P,) uint8 quantized bm25
    quant_scale: float             # impact -> score scale (score≈imp/255*scale)

    # block-max structure (document-ordered)
    block_size: int
    n_blocks: int
    block_max: np.ndarray          # (V, n_blocks) uint8, 0 = term absent
    block_count: np.ndarray        # (V, n_blocks) uint16 postings per block

    # impact-ordered layout (per-term descending impact)
    docs_imp: np.ndarray           # (P,)
    imp_sorted: np.ndarray         # (P,) uint8
    level_cum: np.ndarray          # (V, 256) int32: #postings with impact >= l

    # stage-0 features
    term_stats: np.ndarray         # (V, 36) float32

    # term ids dropped at build time (the stop_k most frequent); retained so
    # a live delta segment applies the same stoplist to incoming feed docs
    stoplist: np.ndarray = None    # (S,) int64

    @property
    def n_postings(self) -> int:
        return self.docs.shape[0]


@dataclass(frozen=True)
class CollectionStats:
    """Collection-level quantities that price a posting.

    A live delta segment scores its postings with the *sealed* index's stats
    (frozen at seal time) rather than its own — otherwise per-posting scores
    would drift as the delta grows and live results could never match the
    post-merge rebuild posting-for-posting.
    """
    n_docs: int
    avg_dl: float
    total_tokens: float
    df: np.ndarray                 # (V,) float64
    cf: np.ndarray                 # (V,) float64
    quant_scale: float             # frozen impact quantization scale


def frozen_stats(index: InvertedIndex) -> CollectionStats:
    """Snapshot the scoring statistics of a sealed index."""
    return CollectionStats(
        n_docs=index.n_docs, avg_dl=index.avg_dl,
        total_tokens=index.total_tokens,
        df=np.asarray(index.df, np.float64),
        cf=np.asarray(index.cf, np.float64),
        quant_scale=index.quant_scale)


def _per_term_stats(term_ids, scores, offsets, df, vocab):
    """{max, amean, gmean, hmean, median, std} per term for one sim column."""
    eps = 1e-3
    nz = np.maximum(df.astype(np.float64), 1.0)
    shifted = scores - scores.min() + eps

    s1 = np.bincount(term_ids, weights=shifted, minlength=vocab)
    s2 = np.bincount(term_ids, weights=shifted ** 2, minlength=vocab)
    slog = np.bincount(term_ids, weights=np.log(shifted), minlength=vocab)
    sinv = np.bincount(term_ids, weights=1.0 / shifted, minlength=vocab)

    amean = s1 / nz
    gmean = np.exp(slog / nz)
    hmean = nz / np.maximum(sinv, 1e-12)
    std = np.sqrt(np.maximum(s2 / nz - amean ** 2, 0.0))

    # max + median over each term's own slice: the postings are term-sorted,
    # so the max is one segmented reduction and the median the
    # ((df - 1) // 2)-th smallest value of the slice (a selection, not a
    # sort of all P values; tied values are interchangeable)
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


# bucket capacity is padded to a multiple of the reference's lane width, so
# both packages pack the same shapes
LANE_MULTIPLE = 128


def pack_tiles(docs: np.ndarray, terms: np.ndarray,
               values: list[tuple[np.ndarray, float, np.dtype]],
               n_docs: int, tile_d: int,
               tile_cap: int | None = None):
    """Pre-tile postings into ``(n_tiles, cap)`` doc-local buckets.

    This is the build-time half of the serving kernels' one-doc-tile-per-
    grid-step layout: every posting lands in the bucket of its ``tile_d``-doc
    tile, doc ids are rebased to be tile-local, and each bucket is padded to
    a common lane-aligned ``cap`` so the whole structure is a dense
    ``(n_tiles, cap)`` array the kernels can view with zero per-query copies.

    The one tiling helper shared by the sealed build, the append-only delta
    tile-set, and the merge re-tile.

    Args:
      docs: (P,) doc ids local to the shard.
      terms: (P,) term id of each posting.
      values: per-posting payload columns as (array, fill, dtype) tuples
        (e.g. exact scores, quantized impacts).
      n_docs: shard size (defines the tile count).
      tile_d: docs per tile; must match the kernels' accumulator tile.
      tile_cap: pin the lane capacity to this value instead of the
        data-derived one — the delta tile-set passes its postings capacity
        so every rebuild keeps the same shapes as documents stream in.

    Returns:
      (tile_docs, tile_terms, bucketed_values, cap) where ``tile_docs`` is
      (n_tiles, cap) int32 tile-local doc ids with -1 padding, ``tile_terms``
      is (n_tiles, cap) int32 with -1 padding, and ``bucketed_values`` is a
      list of (n_tiles, cap) arrays in ``values`` order.
    """
    n_tiles = max(1, -(-n_docs // tile_d))
    p = len(docs)
    tile = (docs // tile_d).astype(np.int64)
    counts = np.bincount(tile, minlength=n_tiles)
    cap = max(int(counts.max()) if p else 0, 1)
    cap = -(-cap // LANE_MULTIPLE) * LANE_MULTIPLE
    if tile_cap is not None:
        if tile_cap < cap:
            raise ValueError(f"tile_cap={tile_cap} below required cap={cap}")
        cap = tile_cap

    order = np.argsort(tile, kind="stable")   # keeps (term, doc) order in-tile
    tsort = tile[order]
    starts = np.zeros(n_tiles + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    slot = tsort * cap + (np.arange(p, dtype=np.int64) - starts[tsort])

    tile_docs = np.full(n_tiles * cap, -1, np.int32)
    tile_docs[slot] = (docs[order] - tsort * tile_d).astype(np.int32)
    tile_terms = np.full(n_tiles * cap, -1, np.int32)
    tile_terms[slot] = terms[order].astype(np.int32)
    bucketed = []
    for arr, fill, dtype in values:
        b = np.full(n_tiles * cap, fill, dtype)
        b[slot] = arr[order].astype(dtype)
        bucketed.append(b.reshape(n_tiles, cap))
    return (tile_docs.reshape(n_tiles, cap), tile_terms.reshape(n_tiles, cap),
            bucketed, cap)


def impact_order_layout(term: np.ndarray, doc: np.ndarray,
                        impact: np.ndarray, vocab: int):
    """Impact-ordered mirror layout shared by the monolithic build and the
    per-shard slicer: the per-term impact-descending (doc-ascending within a
    level) permutation plus the (V, 256) cumulative level table
    ``level_cum[t, l] = # postings of t with impact >= l``."""
    # one int64 key (term, impact descending, doc) in place of the lexsort:
    # V * 256 * n_docs stays far below 2**63
    n = int(doc.max()) + 1 if len(doc) else 1
    key = ((term.astype(np.int64) * 256 + (255 - impact.astype(np.int64)))
           * n + doc.astype(np.int64))
    order = np.argsort(key, kind="stable")
    # the level table is counted over the terms present only (a delta
    # segment, rebuilt on every feed batch, holds a few thousand of them)
    df = np.bincount(term, minlength=vocab)
    present = np.flatnonzero(df)
    row = (np.cumsum(df > 0) - 1)[term]
    lvl = np.bincount(row * 256 + impact,
                      minlength=len(present) * 256).reshape(-1, 256)
    level_cum = np.zeros((vocab, 256), np.int32)
    level_cum[present] = np.flip(np.cumsum(np.flip(lvl, axis=1), axis=1),
                                 axis=1)
    return order, level_cum


def assemble_index(term: np.ndarray, doc: np.ndarray, tf: np.ndarray,
                   doclen: np.ndarray, vocab: int, *,
                   block_size: int = 64, n_levels: int = 255,
                   stoplist: np.ndarray | None = None,
                   frozen: CollectionStats | None = None) -> InvertedIndex:
    """Assemble every index mirror from prepared postings.

    ``term``/``doc``/``tf`` must already be stoplist-filtered and
    (term, doc)-sorted; ``tf`` float64.  With ``frozen`` set, per-posting
    scores and impact quantization use those sealed collection statistics
    instead of the combined ones — the live-delta discipline.  Structural
    quantities (df, offsets, layouts) always describe the postings given.
    """
    n, v = len(doclen), vocab
    p = len(term)

    df = np.bincount(term, minlength=v).astype(np.int64)
    cf = np.bincount(term, weights=tf, minlength=v)
    offsets = np.zeros(v + 1, np.int64)
    np.cumsum(df, out=offsets[1:])

    doclen_f = doclen.astype(np.float64)
    dl = doclen_f[doc]
    if frozen is None:
        score_n = n
        avg_dl = float(doclen_f.mean())
        total_tokens = float(doclen_f.sum())
        df_p = df[term].astype(np.float64)
        cf_p = cf[term]
        smax = None
    else:
        score_n = frozen.n_docs
        avg_dl = frozen.avg_dl
        total_tokens = frozen.total_tokens
        df_p = frozen.df[term]
        cf_p = frozen.cf[term]
        smax = frozen.quant_scale

    sims = scoring.all_similarity_scores(tf, df_p, cf_p, dl, score_n, avg_dl,
                                         total_tokens)  # (P, 6)
    bm25_sc = sims[:, 1].astype(np.float32)
    impact, qmax = scoring.quantize_impacts(bm25_sc, n_levels, smax=smax)

    # ---- block-max structure ----
    n_blocks = (n + block_size - 1) // block_size
    block_max = np.zeros((v, n_blocks), np.uint8)
    block_count = np.zeros((v, n_blocks), np.uint16)
    if p:
        blk = (doc // block_size).astype(np.int64)
        key = term.astype(np.int64) * n_blocks + blk
        # postings are (term, doc)-sorted => (term, block) groups contiguous
        group_start = np.flatnonzero(np.r_[True, key[1:] != key[:-1]])
        gmax = np.maximum.reduceat(impact.astype(np.int32), group_start)
        gcount = np.diff(np.r_[group_start, len(key)])
        gkey = key[group_start]
        block_max.reshape(-1)[gkey] = gmax.astype(np.uint8)
        block_count.reshape(-1)[gkey] = \
            np.minimum(gcount, 65535).astype(np.uint16)

    # ---- impact-ordered layout ----
    order, level_cum = impact_order_layout(term, doc, impact, v)
    docs_imp = doc[order]
    imp_sorted = impact[order]

    # ---- stage-0 term statistics table ----
    if p:
        stats = [
            _per_term_stats(term, sims[:, s].astype(np.float64), offsets,
                            df, v)
            for s in range(sims.shape[1])
        ]
        # layout: (V, 6 sims * 6 stats), sim-major to match feature_names()
        term_stats = np.concatenate(stats, axis=1)
    else:
        term_stats = np.zeros((v, 36), np.float32)

    if stoplist is None:
        stoplist = np.zeros(0, np.int64)

    return InvertedIndex(
        n_docs=n, vocab=v, avg_dl=avg_dl, total_tokens=total_tokens,
        doclen=doclen, df=df.astype(np.int32), cf=cf.astype(np.float32),
        offsets=offsets, docs=doc, tf=tf.astype(np.int32),
        bm25_score=bm25_sc, impact=impact, quant_scale=qmax,
        block_size=block_size, n_blocks=n_blocks,
        block_max=block_max, block_count=block_count,
        docs_imp=docs_imp, imp_sorted=imp_sorted, level_cum=level_cum,
        term_stats=term_stats,
        stoplist=np.asarray(stoplist, np.int64),
    )


@phase("setup.index")
def build_index(corpus: Corpus, block_size: int = 64,
                n_levels: int = 255, stop_k: int = 64) -> InvertedIndex:
    term = corpus.postings_term
    doc = corpus.postings_doc
    tf = corpus.postings_tf.astype(np.float64)

    stoplist = np.zeros(0, np.int64)
    if stop_k > 0:
        # stop the collection (paper: Indri stoplist): drop the stop_k most
        # frequent terms from the index entirely
        cf_all = np.bincount(term, weights=tf, minlength=corpus.vocab)
        stoplist = np.argsort(-cf_all)[:stop_k]
        keep = ~np.isin(term, stoplist)
        term, doc, tf = term[keep], doc[keep], tf[keep]

    return assemble_index(term, doc, tf, corpus.doclen, corpus.vocab,
                          block_size=block_size, n_levels=n_levels,
                          stoplist=stoplist)
