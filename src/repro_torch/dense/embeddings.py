"""Embedding sources for the dense Stage-1 modality.

Two sources behind one contract (the port of ``repro.dense.embeddings``):

* ``two_tower`` — the ``configs/two_tower_retrieval.REDUCED`` tower
  (``repro_torch.models.recsys.TwoTower``).  Doc embeddings come from the
  item tower over per-doc feature ids (dominant topic + doc identity, both
  mod the table size), a per-term embedding table from the user tower.
* ``synthetic`` — seeded Gaussian doc/term tables needing nothing but the
  collection shape.  The NumPy ``RandomState`` draw makes them equal to the
  reference's bit for bit.

Every embedding is snapped to the grid of integer multiples of ``1/GRID``
with magnitude <= 2, so every query·doc dot product is exact in float32
and does not depend on the order of its sum: the dense kernel, its plain
version, the reference and a multi-shard merge agree bit for bit.

The tables are host NumPy arrays, as the reference's are; the tower runs
on its own device.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.two_tower_retrieval import REDUCED
from repro_torch.models.recsys import TwoTower

GRID = 64          # embeddings are integer multiples of 1/GRID (2^-6)
_CLIP = 2.0        # |value| <= 2


def quantize(x: np.ndarray) -> np.ndarray:
    """Snap to the exact float32 grid: round(x·GRID)/GRID, clipped."""
    g = np.rint(np.asarray(x, np.float64) * GRID)
    return (np.clip(g, -_CLIP * GRID, _CLIP * GRID) / GRID).astype(np.float32)


def embed_queries(term_table: np.ndarray, terms: np.ndarray,
                  mask: np.ndarray) -> np.ndarray:
    """(Q, d) quantized query embeddings: mean of active term vectors,
    re-quantized.  Row-independent and deterministic."""
    terms = np.asarray(terms)
    w = (np.asarray(mask) > 0).astype(np.float32)
    v = term_table[terms] * w[:, :, None]                  # (Q, L, d)
    cnt = np.maximum(w.sum(axis=1, keepdims=True), 1.0)
    return quantize(v.sum(axis=1) / cnt)


def synthetic_embeddings(n_docs: int, vocab: int, d: int = 32,
                         seed: int = 0):
    """Seeded Gaussian (doc_emb (N, d), term_table (V, d)), quantized."""
    rng = np.random.RandomState(seed)
    scale = 1.0 / np.sqrt(d)
    return (quantize(rng.randn(n_docs, d) * scale),
            quantize(rng.randn(vocab, d) * scale))


def _tower_rows(tower: TwoTower, side: str, ids: np.ndarray,
                batch: int) -> np.ndarray:
    mask = torch.ones(ids.shape, dtype=torch.float32, device=tower.device)
    ids_t = torch.from_numpy(ids).to(tower.device)
    return np.concatenate([
        tower.tower_embed(side, ids_t[lo:lo + batch],
                          mask[lo:lo + batch]).cpu().numpy()
        for lo in range(0, len(ids), batch)])


def two_tower_embeddings(corpus, tower: TwoTower, batch: int = 4096):
    """(doc_emb (N, d), term_table (V, d)) from the REDUCED two-tower model.

    Docs go through the item tower with (dominant topic, doc id) feature
    ids; vocabulary terms go through the user tower as one-term bags.  Both
    outputs are L2-normalized by the tower and then grid-quantized.
    """
    c = REDUCED
    n, vocab = corpus.params.n_docs, corpus.params.vocab
    topic = np.argmax(np.asarray(corpus.doc_topics), axis=1)
    doc_ids = np.stack([topic % c.n_items,
                        np.arange(n, dtype=np.int64) % c.n_items], axis=1)
    term_ids = (np.arange(vocab, dtype=np.int64) % c.n_users)[:, None]
    return (quantize(_tower_rows(tower, "item", doc_ids, batch)),
            quantize(_tower_rows(tower, "user", term_ids, batch)))


def build_embeddings(dense_spec, corpus=None, *, n_docs: int, vocab: int,
                     tower: TwoTower | None = None, device=None):
    """Resolve a DenseSpec's embedding source to (doc_emb, term_table).

    ``source="auto"`` uses the two-tower path when a corpus is available
    and the synthetic tables otherwise; an explicit ``"two_tower"`` without
    a corpus is an error.  The two-tower path runs ``tower``; with none
    given it draws its own from ``dense_spec.seed`` on ``device``
    (``TwoTower.init``), whose tables then differ from the reference's
    (its tower comes from ``jax.random``; ``convert.two_tower_params``
    carries that one across).
    """
    source = dense_spec.source
    if source == "auto":
        source = "two_tower" if corpus is not None else "synthetic"
    if source == "two_tower":
        if corpus is None:
            raise ValueError("DenseSpec.source='two_tower' needs the corpus "
                             "(doc topic mixtures feed the item tower); "
                             "use source='synthetic' or 'auto' with a "
                             "pre-built index")
        if tower is None:
            tower = TwoTower.init(REDUCED, dense_spec.seed, device)
        return two_tower_embeddings(corpus, tower)
    return synthetic_embeddings(n_docs, vocab, d=dense_spec.embed_dim,
                                seed=dense_spec.seed)


def delta_doc_embeddings(dense_spec, *, n_sealed: int, n_new: int,
                         vocab: int, topics: np.ndarray | None = None,
                         corpus=None, tower: TwoTower | None = None,
                         device=None) -> np.ndarray:
    """(n_new, d) rows for docs appended at global ids >= ``n_sealed``.

    Both sources are per-row functions of the (global doc id, doc features)
    pair — the synthetic table because RandomState fills row-major (the
    first ``n`` rows of a grown draw equal the ``n``-doc draw bitwise), the
    two-tower path because the item tower sees only (dominant topic,
    doc id).  So embedding the delta through the same quantized source
    equals slicing a full rebuild at the grown size.

    The two-tower path runs ``tower``, the model the system's sealed
    embeddings came from (``build_embeddings``'s); with none given it
    draws its own from ``dense_spec.seed`` on ``device``, as
    ``build_embeddings`` does.  (The reference re-draws its tower from
    ``jax.random`` here; the port takes the one it was built with.)
    """
    source = dense_spec.source
    if source == "auto":
        source = "two_tower" if corpus is not None else "synthetic"
    if source == "two_tower":
        if topics is None:
            raise ValueError("two_tower delta embeddings need the feed "
                             "docs' topic mixtures")
        c = REDUCED
        if tower is None:
            tower = TwoTower.init(c, dense_spec.seed, device)
        topic = np.argmax(np.asarray(topics), axis=1)
        gids = np.arange(n_sealed, n_sealed + n_new, dtype=np.int64)
        doc_ids = np.stack([topic % c.n_items, gids % c.n_items], axis=1)
        return quantize(_tower_rows(tower, "item", doc_ids, 4096))
    full, _ = synthetic_embeddings(n_sealed + n_new, vocab,
                                   d=dense_spec.embed_dim,
                                   seed=dense_spec.seed)
    return full[n_sealed:]
