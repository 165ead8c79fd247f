"""DAAT (BMW-style) block-max engine — batched PyTorch serving path.

Block-Max WAND adapted to a batched device pipeline, as in the reference
(``repro.isn.daat``): per-block upper bounds are accumulated from the sparse
block-max structure, a phase-1 pass over the highest-bound blocks
bootstraps a rank-safe threshold τ, and the exact pass scores only blocks
with ``ub >= θ·τ``.  θ = 1.0 is rank-safe; θ > 1.0 is the paper's
aggression parameter.

Both scoring passes run through ``repro_torch.kernels.blockmax_score`` over
the shard's bucketed mirror: one CUDA block per (query, doc tile) on the
card, where a tile with no surviving block writes zeros without reading
the mirror; the plain version of the same function on the CPU.  Exactly
one exact-scoring pass runs per posting: the phase-1 accumulator is kept
and the second pass scores only the disjoint blocks ``survive \\ phase1``.

Determinism: the block bounds are summed query-term slot by slot (no float
atomics), and the kernel sums each doc's scores in slot order, so scores —
and hence ids, ``work`` and ``blocks`` — do not depend on scheduling, and
the card and the CPU agree bit for bit.

As in the reference's kernel backends, all postings of a matched term are
scored (the bucketed mirror has no per-term gather cap), and a repeated
query term scores once.

``daat_serve_laxmap`` is the reference's one-query-at-a-time pipeline (its
parity oracle and the batched engine's baseline), with a Python loop in
place of ``lax.map``: per query, block bounds, the phase-1 blocks, and two
full masked scoring passes over the query's gathered postings through the
flat wrapper ``kernels.blockmax_score.ops.blockmax_score`` (the bucketed
kernel on the card, which adds each doc's scores in the gathered lanes'
term-major order).  As in the reference, a repeated query term scores once
per occurrence there.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.index.postings import IndexShard
from repro_torch.isn.backend import (merge_shard_topk, stable_topk,
                                     topk_from_tiles)
from repro_torch.kernels.blockmax_score.ops import (blockmax_score,
                                                    blockmax_score_tiles)
from repro_torch.serving.telemetry.host import count, span


class DaatResult(NamedTuple):
    topk_docs: torch.Tensor     # (Q, k) int32
    topk_scores: torch.Tensor   # (Q, k) float32 exact BM25
    work: torch.Tensor          # (Q,) int64 postings in surviving blocks
    blocks: torch.Tensor        # (Q,) int64 surviving blocks


def _block_bounds_batched(shard: IndexShard, terms, mask, n_blocks: int,
                          bcap: int):
    """Per-block upper bounds (Q, n_blocks) f32 and candidate counts int32.

    A term has at most one entry per block, so within one query-term slot
    no two entries share a block: each slot's bounds are placed without
    collisions and the slots are added in slot order, from 0.0 — the order
    of the reference's scatter-add over its slot-major lanes."""
    q, n_terms = terms.shape
    dev = terms.device
    t = terms.long()
    base = shard.bm_offsets[t].long()                           # (Q, L)
    cnt = shard.bm_offsets[t + 1].long() - base
    lanes = torch.arange(bcap, device=dev)
    pos = base[..., None] + lanes
    live = (lanes < cnt[..., None]) & (mask[..., None] > 0)
    pos = torch.clamp(pos, max=shard.bm_block_id.shape[0] - 1)
    # dead lanes land in a dump block past the end, sliced off below
    bid = torch.where(live, shard.bm_block_id[pos].long(), n_blocks)
    bmax = torch.where(live, shard.bm_block_max[pos], 0.0)
    bcnt = torch.where(live, shard.bm_block_cnt[pos], 0)
    ub = torch.zeros((q, n_blocks), dtype=torch.float32, device=dev)
    ccnt = torch.zeros((q, n_blocks + 1), dtype=torch.int32, device=dev)
    for l in range(n_terms):
        cell = torch.zeros((q, n_blocks + 1), dtype=torch.float32,
                           device=dev)
        cell.scatter_(1, bid[:, l], bmax[:, l])
        ub = ub + cell[:, :n_blocks]
        ccnt.scatter_add_(1, bid[:, l], bcnt[:, l])
    return ub, ccnt[:, :n_blocks]


def _phase1_blocks(ub, ccnt, block_size: int, k: int, n_blocks: int):
    """Rank the blocks by upper bound (stable, ties to the lower block id)
    and keep the highest-bound prefix holding >= 2k candidate docs — the
    threshold-bootstrapping phase-1 set."""
    cand = torch.clamp(ccnt, max=block_size)
    order = torch.argsort(-ub, dim=1, stable=True)
    cum = torch.cumsum(torch.gather(cand, 1, order), dim=1)
    target = torch.full((ub.shape[0], 1), 2 * k, dtype=cum.dtype,
                        device=ub.device)
    need = torch.clamp(torch.searchsorted(cum, target)[:, 0] + 1,
                       max=n_blocks)
    rank = torch.empty_like(order)
    rank.scatter_(1, order, torch.arange(n_blocks, device=ub.device)
                  .expand_as(order).contiguous())
    return rank < need[:, None]


def _kth_score(topk_out, k: int):
    """The k-th top score of a (scores, ids) top-k result."""
    vals, _ = topk_out
    return vals[:, k - 1]


def _daat_batched(shard: IndexShard, terms, mask, theta, *, n_docs: int,
                  n_blocks: int, block_size: int, k: int, bcap: int,
                  tile_d: int):
    ub, ccnt = _block_bounds_batched(shard, terms, mask, n_blocks, bcap)
    in_p1 = _phase1_blocks(ub, ccnt, block_size, k, n_blocks)
    qterms = torch.where(mask > 0, terms, -1).to(torch.int32)

    def score(survive):
        return blockmax_score_tiles(
            shard.tile_docs, shard.tile_terms, shard.tile_scores, qterms,
            survive, tile_d=tile_d, block_size=block_size, n_blocks=n_blocks)

    acc1_t = score(in_p1)
    tau = _kth_score(topk_from_tiles(acc1_t, k, n_docs=n_docs), k)
    extra = (ub >= theta.to(torch.float32)[:, None] * tau[:, None]) & ~in_p1
    acc_t = acc1_t + score(extra)
    sc, ids = topk_from_tiles(acc_t, k, n_docs=n_docs)

    survive = in_p1 | extra
    work = torch.where(survive, ccnt, 0).sum(dim=1)
    blocks = survive.sum(dim=1)
    return ids, sc, work, blocks


def daat_serve(shard: IndexShard, terms: torch.Tensor, mask: torch.Tensor,
               theta: torch.Tensor, *, n_docs: int, n_blocks: int,
               block_size: int, k: int, bcap: int, tile_d: int = 128,
               q_block: int = 64) -> DaatResult:
    """Serve a batch of queries with block-max pruned DAAT.

    bcap: static per-term block-entry bound (``max_blocks_per_term``).
    tile_d: docs per accumulator tile (must match the shard's mirror).
    q_block: queries scored per launch; larger batches stream through in
      q_block-sized chunks so accumulator memory stays O(q_block · n_docs).

    The reference's ``cap``/``qcap`` size its gather paths; the kernel path
    scores every posting of a matched term and takes neither.
    """
    with span("stage1.daat"):
        outs = [_daat_batched(shard, terms[i:i + q_block],
                              mask[i:i + q_block], theta[i:i + q_block],
                              n_docs=n_docs, n_blocks=n_blocks,
                              block_size=block_size, k=k, bcap=bcap,
                              tile_d=tile_d)
                for i in range(0, max(terms.shape[0], 1), q_block)]
        r = DaatResult(*(torch.cat(parts) for parts in zip(*outs)))
        count("postings", r.work)
    return r


def daat_scan_segments(segments, terms, mask, theta, *, k: int):
    """Scan one batch over sealed + delta segments, unmerged.

    ``segments`` is a list of ``(shard, spec, doc_lo)`` in ascending
    global-doc order — sealed shards first, then (optionally) the live
    delta pseudo-shard, whose ``doc_lo`` is the sealed collection size.
    Each segment is scanned with its own static caps (a delta segment's
    capacity padding is inert: padded lanes hold term -1 and padded block
    entries sit past every term's range).  Returns ``(scores, ids, works,
    blocks)``, one entry per segment, ids global.  The one segment loop
    the serve path (``SearchSystem._stage1_full``) and
    ``daat_serve_segments`` share.
    """
    sc_list, id_list, works, blocks = [], [], [], []
    for shard, spec, doc_lo in segments:
        r = daat_serve(shard, terms, mask, theta, n_docs=spec.n_docs,
                       n_blocks=spec.n_blocks, block_size=spec.block_size,
                       k=k, bcap=spec.max_blocks_per_term,
                       tile_d=spec.tile_d)
        sc_list.append(r.topk_scores)
        id_list.append(r.topk_docs + doc_lo)
        works.append(r.work)
        blocks.append(r.blocks)
    return sc_list, id_list, works, blocks


def daat_serve_segments(segments, terms, mask, theta, *, k: int, drop=None):
    """Serve one batch over sealed + delta segments and merge the top-k.

    ``segments`` as for :func:`daat_scan_segments`; the candidates merge
    through ``merge_shard_topk``'s lower-global-doc-id tie policy.
    ``drop[i]`` (optional) masks segment ``i`` out of a query's merge;
    ``drop`` rows follow segment order.  Returns ``(ids, scores, works,
    blocks)``: the merged (Q, k) global result plus per-segment work/block
    counters.  The reference's per-segment ``qcaps`` size its gather paths;
    the kernel path takes none.
    """
    sc_list, id_list, works, blocks = daat_scan_segments(
        segments, terms, mask, theta, k=k)
    if len(segments) == 1 and drop is None:
        return id_list[0], sc_list[0], works, blocks
    ids, sc = merge_shard_topk(sc_list, id_list, k, drop=drop)
    return ids, sc, works, blocks


# ---------------------------------------------------------------------------
# one query at a time
# ---------------------------------------------------------------------------

def _block_bounds(shard: IndexShard, terms, mask, n_blocks: int, bcap: int):
    """One query's ((L,) terms/mask) block upper bounds (n_blocks,) f32 and
    candidate counts int32: the batched bounds at Q = 1, summed slot by slot
    as the reference's scatter over its term-major lanes adds them."""
    ub, ccnt = _block_bounds_batched(shard, terms[None], mask[None],
                                     n_blocks, bcap)
    return ub[0], ccnt[0]


def _masked_score(shard: IndexShard, terms, mask, survive, n_docs: int,
                  block_size: int, cap: int):
    """Exact (n_docs,) f32 scores of one query's postings whose doc block
    survives: the first ``cap`` postings of each query term gathered into
    flat term-major lanes (dead lanes -1) and scored by the flat kernel
    wrapper.  With at most 8 terms and unique (term, doc) postings a
    128-doc tile holds at most 1,024 lanes, the bucket width."""
    lanes = torch.arange(cap, device=terms.device)
    t = terms.long()
    base = shard.offsets[t].long()
    df = shard.offsets[t + 1].long() - base
    live = (lanes < df[:, None]) & (mask[:, None] > 0)
    pos = torch.clamp(base[:, None] + lanes, max=shard.docs.shape[0] - 1)
    docs = torch.where(live, shard.docs[pos], -1).reshape(-1)
    scores = torch.where(live, shard.score[pos], 0.0).reshape(-1)
    return blockmax_score(docs, scores, survive, n_docs=n_docs,
                          block_size=block_size, tile_d=128, cap=1024)


def daat_serve_laxmap(shard: IndexShard, terms: torch.Tensor,
                      mask: torch.Tensor, theta: torch.Tensor, *,
                      n_docs: int, n_blocks: int, block_size: int, k: int,
                      cap: int, bcap: int) -> DaatResult:
    """One-query-at-a-time pipeline: phase-1 blocks, τ, then a full rescan
    of the surviving blocks (every surviving posting is scored twice) — the
    reference's parity oracle and benchmark baseline.

    cap: static per-term postings bound (``max_df``).
    bcap: static per-term block-entry bound (``max_blocks_per_term``).
    """
    outs = []
    for i in range(terms.shape[0]):
        ub, ccnt = _block_bounds(shard, terms[i], mask[i], n_blocks, bcap)
        in_p1 = _phase1_blocks(ub[None], ccnt[None], block_size, k,
                               n_blocks)[0]
        acc1 = _masked_score(shard, terms[i], mask[i], in_p1, n_docs,
                             block_size, cap)
        tau = stable_topk(acc1, k)[0][k - 1]
        survive = (ub >= theta[i].to(torch.float32) * tau) | in_p1
        acc = _masked_score(shard, terms[i], mask[i], survive, n_docs,
                            block_size, cap)
        sc, ids = stable_topk(acc, k)
        outs.append((ids.to(torch.int32), sc,
                     torch.where(survive, ccnt, 0).sum(), survive.sum()))
    return DaatResult(*(torch.stack(parts) for parts in zip(*outs)))
