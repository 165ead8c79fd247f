"""SAAT (JASS-style) anytime engine — batched PyTorch serving path.

Score-at-a-time traversal over the impact-ordered mirror.  The ρ budget is
resolved to a per-query impact-level cut ``lstar`` (JASS processes whole
impact segments, highest impact first, while the budget allows); every
posting whose impact reaches the cut contributes to the accumulator.

The accumulation runs through ``repro_torch.kernels.impact_accumulate``
over the shard's build-time bucketed mirror (``IndexShard.tile_*``): one
CUDA block per (query, doc tile) on the card, the plain version of the
same function on the CPU.  Top-k is the tiled hierarchical merge from
``repro_torch.isn.backend``.  Accumulation is integer, so the result is
bit-identical to the reference's ``repro.isn.saat.saat_serve`` on every
backend.

``saat_serve_laxmap`` is the reference's one-query-at-a-time pipeline (its
parity oracle and the batched engine's baseline), with a Python loop in
place of ``lax.map``: per query, the impact-ordered prefixes are gathered
into flat lanes and accumulated by the flat wrapper
``kernels.impact_accumulate.ops.impact_accumulate`` (the bucketed kernel on
the card), and the top-k is ``histogram_topk`` (the histogram kernel on the
card).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.index.postings import IndexShard
from repro_torch.isn.backend import merge_shard_topk, topk_from_tiles
from repro_torch.kernels.impact_accumulate.ops import (impact_accumulate,
                                                       impact_accumulate_tiles)
from repro_torch.kernels.score_histogram.ops import histogram_topk
from repro_torch.serving.telemetry.host import count, span


class SaatResult(NamedTuple):
    topk_docs: torch.Tensor     # (Q, k) int32 local doc ids
    topk_scores: torch.Tensor   # (Q, k) float32 quantized-impact scores
    work: torch.Tensor          # (Q,) int32 postings actually scored


def _level_cut(shard: IndexShard, terms, mask, rho):
    """Most inclusive impact level whose total postings fit the budget, for
    one query ((L,) terms/mask, scalar rho).

    Returns (per-term prefix lengths, total postings, the level cut itself).
    The cut is ``n_levels`` (excluding everything) when even the sparsest
    level blows the budget."""
    prefix, work, lstar = _level_cut_batched(
        shard, terms[None], mask[None],
        torch.as_tensor(rho, device=terms.device).reshape(1))
    return prefix[0], work[0], lstar[0]


def _level_cut_batched(shard: IndexShard, terms, mask, rho):
    """Batched level cut: (Q, L) prefixes, (Q,) work and (Q,) cuts."""
    n_levels = shard.level_cum.shape[1]
    live = (mask > 0).to(torch.int32)
    lc = shard.level_cum[terms.long()] * live[:, :, None]        # (Q, L, 256)
    total = lc.sum(dim=1)                                         # (Q, 256)
    # the budget compares in float64: exact for every int32 total and for
    # the integer-valued per-shard budgets (-1 marks "nothing fits")
    ok = total.double() <= rho.double()[:, None]
    # ``total`` is non-increasing in level; the first ok level is the cut
    lstar = torch.argmax(ok.to(torch.int8), dim=1)
    any_ok = ok.any(dim=1)
    prefix = torch.where(any_ok[:, None],
                         torch.gather(lc, 2, lstar.view(-1, 1, 1).expand(
                             -1, lc.shape[1], 1))[..., 0], 0)
    work = torch.where(any_ok, torch.gather(total, 1, lstar[:, None])[:, 0], 0)
    lstar = torch.where(any_ok, lstar, n_levels).to(torch.int32)
    return prefix, work.to(torch.int32), lstar


def _saat_batched(shard: IndexShard, terms, mask, rho, *, n_docs: int,
                  k: int, tile_d: int):
    _, work, lstar = _level_cut_batched(shard, terms, mask, rho)
    qterms = torch.where(mask > 0, terms, -1).to(torch.int32)
    acc_t = impact_accumulate_tiles(shard.tile_docs, shard.tile_terms,
                                    shard.tile_imps, qterms, lstar,
                                    tile_d=tile_d)
    sc, ids = topk_from_tiles(acc_t, k, n_docs=n_docs)
    return ids, sc.to(torch.float32), work


def saat_serve(shard: IndexShard, terms: torch.Tensor, mask: torch.Tensor,
               rho: torch.Tensor, *, n_docs: int, k: int,
               tile_d: int = 128, q_block: int = 64) -> SaatResult:
    """Serve a batch of queries on one ISN shard.

    Args:
      terms: (Q, L) padded query term ids.
      mask: (Q, L) query term mask.
      rho: (Q,) per-query postings budgets (already capped at ρ_max by the
        Stage-0 scheduler).
      n_docs / k: shard size and retrieval depth.
      tile_d: docs per accumulator tile (must match the shard's mirror).
      q_block: queries scored per kernel launch; larger batches stream
        through in q_block-sized chunks, bounding the (Q, n_docs)
        accumulator.

    The reference's static ``cap`` (the ρ_max bound that sizes its gather
    paths) has no role on the kernel path and is not taken.
    """
    with span("stage1.saat"):
        outs = [_saat_batched(shard, terms[i:i + q_block],
                              mask[i:i + q_block], rho[i:i + q_block],
                              n_docs=n_docs, k=k, tile_d=tile_d)
                for i in range(0, max(terms.shape[0], 1), q_block)]
        r = SaatResult(*(torch.cat(parts) for parts in zip(*outs)))
        count("postings", r.work)
    return r


def saat_scan_segments(segments, terms, mask, rhos, *, k: int):
    """Scan one batch over sealed + delta segments, unmerged.

    ``segments`` is a list of ``(shard, spec, doc_lo)`` in ascending
    global-doc order (delta pseudo-shard last); ``rhos[i]`` is segment
    ``i``'s per-query postings budget.  Returns ``(scores, ids, works)``,
    one entry per segment, ids global.  The one segment loop the serve
    path (``SearchSystem._stage1_full``) and ``saat_serve_segments`` share.
    """
    sc_list, id_list, works = [], [], []
    for i, (shard, spec, doc_lo) in enumerate(segments):
        r = saat_serve(shard, terms, mask, rhos[i], n_docs=spec.n_docs,
                       k=k, tile_d=spec.tile_d)
        sc_list.append(r.topk_scores)
        id_list.append(r.topk_docs + doc_lo)
        works.append(r.work)
    return sc_list, id_list, works


def saat_serve_segments(segments, terms, mask, rhos, *, k: int, drop=None):
    """Serve one batch over sealed + delta segments and merge the top-k.

    ``segments`` and ``rhos`` as for :func:`saat_scan_segments` — the
    caller resolves the global ρ → level-cut split across *all* segments
    (delta included) so the combined scanned prefix is exactly the
    budgeted work.  Integer impact accumulation keeps the merge bit-exact
    on both paths; a delta segment's capacity padding contributes zero
    impact and is outranked by the sealed segments' real candidates.
    ``drop`` ((n_segments, Q) bool, optional) masks segments out of a
    query's merge.

    Returns ``(ids, scores, works)`` with per-segment work counters.
    """
    sc_list, id_list, works = saat_scan_segments(segments, terms, mask,
                                                 rhos, k=k)
    if len(segments) == 1 and drop is None:
        return id_list[0], sc_list[0], works
    ids, sc = merge_shard_topk(sc_list, id_list, k, drop=drop)
    return ids, sc, works


# ---------------------------------------------------------------------------
# one query at a time
# ---------------------------------------------------------------------------

def _accumulate(shard: IndexShard, terms, prefix, n_docs: int, cap: int):
    """Gather one query's per-term impact-ordered prefixes ((L,) lengths,
    each at most ``cap``) into flat lanes, dead lanes -1, and accumulate
    them into a dense (n_docs,) int32 accumulator through the flat kernel
    wrapper.  The prefixes are the budget, so the cut passed is 0."""
    lanes = torch.arange(cap, device=terms.device)
    pos = shard.offsets[terms.long()].long()[:, None] + lanes
    live = lanes < prefix[:, None]
    pos = torch.clamp(pos, max=shard.docs_imp.shape[0] - 1)
    docs = torch.where(live, shard.docs_imp[pos], -1).reshape(-1)
    imps = torch.where(live, shard.imp[pos], 0).reshape(-1)
    return impact_accumulate(docs, imps, 0, n_docs=n_docs, tile_d=128)


def saat_serve_laxmap(shard: IndexShard, terms: torch.Tensor,
                      mask: torch.Tensor, rho: torch.Tensor, *, n_docs: int,
                      k: int, cap: int) -> SaatResult:
    """One-query-at-a-time pipeline (level cut, flat accumulation, histogram
    top-k) — the reference's parity oracle and benchmark baseline.

    Args as ``saat_serve``; ``cap`` is the static per-term prefix bound (the
    gather width, ρ_max).  The top-k of the non-negative integer
    accumulator is ``lax.top_k``'s: score descending, then the lower id.
    """
    outs = []
    for i in range(terms.shape[0]):
        prefix, work, _ = _level_cut(shard, terms[i], mask[i], rho[i])
        acc = _accumulate(shard, terms[i], torch.clamp(prefix, max=cap),
                          n_docs, cap)
        sc, ids = histogram_topk(acc, k=k)
        outs.append((ids, sc.to(torch.float32), work))
    return SaatResult(*(torch.stack(parts) for parts in zip(*outs)))
