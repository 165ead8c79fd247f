"""Device-resident index shard structures for the PyTorch serving engines.

An ISN holds one *document shard* of the corpus in device memory, in three
mirrors (the layout of ``repro.index.postings``, as torch tensors):

* impact-ordered arrays for SAAT (JASS) — per-term postings sorted by
  descending quantized impact, plus per-term per-level cumulative counts so
  the ρ budget resolves to per-term prefixes in O(levels);
* document-ordered arrays for DAAT (BMW) — per-term postings sorted by
  docid with exact scores, plus a *sparse* per-term block-max structure
  (term-major CSR of (block_id, block_max, block_count));
* a **bucketed (doc-tile-major) mirror** feeding the serving kernels —
  every posting pre-tiled at build time into the ``(n_tiles, tile_cap)``
  bucket of its ``tile_d``-doc tile, carrying (tile-local doc id, term id,
  exact score, quantized impact).  One CUDA block scores one (query, tile)
  pair straight from this mirror, with no per-query copy.

Integer fields stay int32 as in the reference; callers cast to int64 where
torch indexes with them.

A shard is built in two steps: ``shard_layout`` lays it out on the host
with NumPy (the costly step: seconds per million postings), and
``shard_to_device`` copies that layout to a device.  ``shard_from_index``
is the two in one; a caller that builds several systems of one index
(one on the card, one on the CPU) lays it out once (``shard_layouts``) and
hands the layouts to each build.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.index.builder import (InvertedIndex, impact_order_layout,
                                       pack_tiles)
from repro_torch.isn.backend import resolve_device


class IndexShardSpec(NamedTuple):
    n_docs: int            # docs in this shard
    vocab: int
    n_postings: int        # padded postings count
    n_blocks: int          # doc blocks in this shard
    n_block_entries: int   # padded (term, block) entries
    n_levels: int
    block_size: int
    max_df: int            # static cap for per-term gathers
    max_blocks_per_term: int
    quant_scale: float
    tile_d: int            # docs per bucketed serving tile
    tile_cap: int          # lane-padded postings capacity per tile
    n_tiles: int


class IndexShard(NamedTuple):
    """One document shard of the index mirrors (tensors on one device)."""
    # --- shared / collection stats ---
    df: torch.Tensor            # (V,) int32
    offsets: torch.Tensor       # (V+1,) int32 into postings arrays

    # --- impact-ordered mirror (SAAT / JASS) ---
    docs_imp: torch.Tensor      # (P,) int32 local doc ids
    imp: torch.Tensor           # (P,) int32 quantized impacts (from uint8)
    level_cum: torch.Tensor     # (V, n_levels) int32: count with impact >= l

    # --- document-ordered mirror (DAAT / BMW) ---
    docs: torch.Tensor          # (P,) int32 local doc ids (term, doc sorted)
    score: torch.Tensor         # (P,) float32 exact BM25
    bm_offsets: torch.Tensor    # (V+1,) int32 into block arrays
    bm_block_id: torch.Tensor   # (PB,) int32 doc-block id
    bm_block_max: torch.Tensor  # (PB,) float32 block upper bound
    bm_block_cnt: torch.Tensor  # (PB,) int32 postings in this (term, block)

    # --- bucketed doc-tile-major mirror (serving kernels) ---
    tile_docs: torch.Tensor     # (n_tiles, tile_cap) int32 tile-local, -1 pad
    tile_terms: torch.Tensor    # (n_tiles, tile_cap) int32 term ids, -1 pad
    tile_scores: torch.Tensor   # (n_tiles, tile_cap) float32 exact BM25
    tile_imps: torch.Tensor     # (n_tiles, tile_cap) int32 quantized impacts


def shard_ranges(n_docs: int, n_shards: int) -> list[tuple[int, int]]:
    """Contiguous doc-range partition of [0, n_docs) into n_shards shards.

    Ranges are as even as possible (first ``n_docs % n_shards`` shards get
    one extra doc) and returned in ascending order — the order the
    scatter-gather merge relies on for its doc-id tie-break.
    """
    if not 1 <= n_shards <= n_docs:
        raise ValueError(f"n_shards must be in [1, {n_docs}], got {n_shards}")
    base, extra = divmod(n_docs, n_shards)
    bounds = [0]
    for s in range(n_shards):
        bounds.append(bounds[-1] + base + (1 if s < extra else 0))
    return list(zip(bounds[:-1], bounds[1:]))


class ShardLayout(NamedTuple):
    """One shard laid out on the host: ``arrays`` holds, field for field of
    :class:`IndexShard`, the NumPy array (int32 or float32, contiguous)
    that ``shard_to_device`` copies; the shard covers docs [doc_lo,
    doc_hi) of its index at ``spec.tile_d``."""
    arrays: IndexShard
    spec: IndexShardSpec
    doc_lo: int
    doc_hi: int


def shard_from_index(index: InvertedIndex, doc_lo: int = 0,
                     doc_hi: int | None = None,
                     tile_d: int = 128, *,
                     device: str | torch.device | None = None,
                     ) -> tuple[IndexShard, IndexShardSpec]:
    """Materialize the device structures for docs in [doc_lo, doc_hi).

    The layout is built on the host with NumPy (``shard_layout``) and
    copied once to ``device`` (the card unless the caller asks for the
    CPU).  Capacities (postings, lanes per tile, per-term gather caps) are
    the data's own.
    """
    dev = resolve_device(device)
    return shard_to_device(shard_layout(index, doc_lo, doc_hi, tile_d), dev)


def shard_layouts(index: InvertedIndex, n_shards: int,
                  tile_d: int = 128) -> list[ShardLayout]:
    """The host layouts of the ``n_shards`` doc-range shards of ``index``
    (``shard_ranges``), in ascending doc order."""
    return [shard_layout(index, lo, hi, tile_d)
            for lo, hi in shard_ranges(index.n_docs, n_shards)]


def shard_to_device(layout: ShardLayout, device: str | torch.device | None
                    = None) -> tuple[IndexShard, IndexShardSpec]:
    """Copy a host layout to ``device`` (the card unless the caller asks
    for the CPU, where the tensors share the layout's memory)."""
    dev = resolve_device(device)
    shard = IndexShard._make(torch.from_numpy(a).to(dev)
                             for a in layout.arrays)
    return shard, layout.spec


def shard_layout(index: InvertedIndex, doc_lo: int = 0,
                 doc_hi: int | None = None,
                 tile_d: int = 128) -> ShardLayout:
    """Lay out the shard of docs [doc_lo, doc_hi) on the host: every array
    of :class:`IndexShard` as NumPy, and the shard's spec."""
    doc_hi = index.n_docs if doc_hi is None else doc_hi
    n_local = doc_hi - doc_lo
    v = index.vocab
    bs = index.block_size
    if tile_d % bs:
        raise ValueError(f"tile_d={tile_d} must be a multiple of "
                         f"block_size={bs}")

    sel = (index.docs >= doc_lo) & (index.docs < doc_hi)
    term_of = np.repeat(np.arange(v), np.diff(index.offsets))
    t = term_of[sel]
    d = (index.docs[sel] - doc_lo).astype(np.int32)
    s = index.bm25_score[sel].astype(np.float32)
    im = index.impact[sel].astype(np.int32)

    df = np.bincount(t, minlength=v).astype(np.int32)
    offsets = np.zeros(v + 1, np.int64)
    np.cumsum(df, out=offsets[1:])

    # postings already (term, doc)-sorted; within-shard selection keeps order
    docs = d
    score = s

    # impact-ordered: per-term sort by impact desc
    order, level_cum = impact_order_layout(t, d, im, v)
    docs_imp = d[order]
    imp = im[order]

    # sparse block-max
    if len(d):
        blk = (d // bs).astype(np.int64)
        key = t.astype(np.int64) * (1 << 32) + blk
        start = np.flatnonzero(np.r_[True, key[1:] != key[:-1]])
        b_term = t[start]
        b_id = blk[start].astype(np.int32)
        b_max = np.maximum.reduceat(s, start).astype(np.float32)
        b_cnt = np.diff(np.r_[start, len(key)]).astype(np.int32)
    else:
        b_term = np.zeros(0, np.int64)
        b_id = np.zeros(0, np.int32)
        b_max = np.zeros(0, np.float32)
        b_cnt = np.zeros(0, np.int32)
    bm_df = np.bincount(b_term, minlength=v)
    bm_offsets = np.zeros(v + 1, np.int64)
    np.cumsum(bm_df, out=bm_offsets[1:])

    # bucketed doc-tile-major mirror for the serving kernels
    tile_docs, tile_terms, (tile_scores, tile_imps), tcap = pack_tiles(
        d, t, [(s, 0.0, np.float32), (im, 0, np.int32)], n_local, tile_d)

    n_blocks = (n_local + bs - 1) // bs
    n_tiles = max(1, (n_local + tile_d - 1) // tile_d)
    spec = IndexShardSpec(
        n_docs=n_local, vocab=v, n_postings=len(docs), n_blocks=n_blocks,
        n_block_entries=len(b_id), n_levels=256, block_size=bs,
        max_df=int(df.max()) if len(df) else 1,
        max_blocks_per_term=int(bm_df.max()) if len(bm_df) else 1,
        quant_scale=index.quant_scale,
        tile_d=tile_d, tile_cap=tcap, n_tiles=n_tiles)

    def i32(a):
        return np.ascontiguousarray(a, np.int32)

    def f32(a):
        return np.ascontiguousarray(a, np.float32)

    arrays = IndexShard(
        df=i32(df), offsets=i32(offsets),
        docs_imp=i32(docs_imp), imp=i32(imp), level_cum=i32(level_cum),
        docs=i32(docs), score=f32(score),
        bm_offsets=i32(bm_offsets), bm_block_id=i32(b_id),
        bm_block_max=f32(b_max), bm_block_cnt=i32(b_cnt),
        tile_docs=i32(tile_docs), tile_terms=i32(tile_terms),
        tile_scores=f32(tile_scores), tile_imps=i32(tile_imps),
    )
    return ShardLayout(arrays, spec, doc_lo, doc_hi)
