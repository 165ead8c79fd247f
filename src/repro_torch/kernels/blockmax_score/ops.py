"""DAAT block-max scoring: the kernel wrappers, their plain versions, and
the entry points the DAAT engine imports.

Two kernels live in ``blockmax_score.cu``, each with a wrapper that
launches it for CUDA tensors and runs its plain version for CPU tensors:

* ``blockmax_score_batched`` (plain: ``blockmax_score_plain``), the Pallas
  kernel ``blockmax_score_batched`` (repro/kernels/blockmax_score/kernel.py):
  per (query, doc tile) of the shard's mirror, the sum of the f32 BM25
  scores of the tile's postings whose term is one of the query's terms
  (membership) and whose pruning block survives; tiles with
  ``survive_t == 0`` are all zeros.  Both paths give each live lane its own
  (first matching query-term slot, doc) cell and sum each doc's cells in
  slot order from 0.0, so they agree bit for bit.
  ``blockmax_score_grouped`` is the CUDA kernel's arithmetic in PyTorch
  (one term table per group of 32 queries, ``term_table``), for the tests
  and ``chip_smoke.py``.  ``blockmax_score_tiles`` derives the per-tile
  flags from per-block survival, as the reference's
  ``ops.blockmax_score_tiles`` does.
* ``blockmax_score_bucketed`` (plain: ``blockmax_score_bucketed_plain``),
  the Pallas kernel ``blockmax_score_bucketed``: one query's postings
  bucketed by doc tile, per tile the f32 sum of each local doc's scores,
  then the tile's overflow residue.  ``blockmax_score`` (the flat wrapper)
  buckets flat lanes for it; the per-query DAAT path
  (``isn.daat.daat_serve_laxmap``) calls it.  Both paths add each doc's
  lanes in lane order from 0.0 (the bucket in order, then the residue in
  order), with no float atomics, so they agree bit for bit, and with a
  sequential scatter of the flat lanes in their own order
  (``blockmax_score_ref`` on the CPU).
"""

from __future__ import annotations

import torch

from repro_torch import kernels
from repro_torch.kernels import term_table
from repro_torch.kernels.buckets import bucket_by_tile

MAX_TERMS = 16           # query slots the batched kernel's 4-bit codes hold
MAX_TILE_D = 1024        # the bucketed kernel's running sums of 4 tiles a
                         # block stay in 16 KB of shared memory


def blockmax_score_plain(tile_docs: torch.Tensor, tile_terms: torch.Tensor,
                         tile_scores: torch.Tensor, qterms: torch.Tensor,
                         survive_b: torch.Tensor, survive_t: torch.Tensor, *,
                         tile_d: int, block_size: int) -> torch.Tensor:
    """Plain PyTorch version over the same tile layout, one query at a
    time over that query's surviving tiles (the others are zeros)."""
    n_tiles, cap = tile_docs.shape
    q, n_terms = qterms.shape
    dev = tile_docs.device
    width = tile_d + 1                # a dump column per slot for dead lanes
    out = torch.zeros((q, n_tiles, tile_d), dtype=torch.float32, device=dev)
    for i in range(q):
        tiles = torch.nonzero(survive_t[i] > 0)[:, 0]
        n = tiles.numel()
        if n == 0:
            continue
        docs = tile_docs[tiles].long()                        # (n, cap)
        qt = qterms[i]
        eq = (tile_terms[tiles].unsqueeze(-1) == qt) & (qt >= 0)
        slot = torch.argmax(eq.to(torch.int8), dim=-1)       # first match
        blk = torch.where(docs >= 0, docs, 0) // block_size
        live = ((docs >= 0) & eq.any(dim=-1)
                & (torch.gather(survive_b[i, tiles].long(), 1, blk) > 0))
        cell = torch.where(live, slot * width + docs, n_terms * width)
        cells = torch.zeros((n, n_terms * width + 1), dtype=torch.float32,
                            device=dev)
        cells.scatter_(1, cell, torch.where(live, tile_scores[tiles], 0.0))
        cells = cells[:, :-1].reshape(n, n_terms, width)
        acc = torch.zeros((n, tile_d), dtype=torch.float32, device=dev)
        for l in range(n_terms):
            acc = acc + cells[:, l, :tile_d]
        out[i, tiles] = acc
    return out


def blockmax_score_grouped(tile_docs: torch.Tensor, tile_terms: torch.Tensor,
                           tile_scores: torch.Tensor, qterms: torch.Tensor,
                           survive_b: torch.Tensor, survive_t: torch.Tensor,
                           *, tile_d: int, block_size: int) -> torch.Tensor:
    """The CUDA kernel's arithmetic in PyTorch (for the tests and
    ``chip_smoke.py``): per group of ``term_table.GROUP`` queries, the
    group's term table (query mask and first slot), one lookup per lane,
    each matching lane's score written to the (first slot, doc) cell of
    every query that keeps its tile and block, and each (query, doc) summed
    over its cells in slot order from 0.0.  Equal to
    ``blockmax_score_plain`` bit for bit."""
    n_tiles = tile_docs.shape[0]
    q, n_terms = qterms.shape
    dev = tile_docs.device
    out = torch.zeros((q, n_tiles * tile_d), dtype=torch.float32, device=dev)
    for g0 in range(0, q, term_table.GROUP):
        qt = qterms[g0:g0 + term_table.GROUP]
        g = qt.shape[0]
        keys, mask, first = term_table.group_table(qt)
        tile, j, entry = term_table.matched_lanes(keys, tile_docs, tile_terms,
                                                  tile_d)
        d = tile_docs[tile, j].long()
        sb = survive_b[g0:g0 + g].permute(1, 2, 0)[tile, d // block_size]
        kept = survive_t[g0:g0 + g].T[tile]                     # (lanes, g)
        writes = term_table.mask_bits(mask[entry], g) & (kept > 0) & (sb > 0)
        lane, qi = torch.nonzero(writes, as_tuple=True)
        cells = torch.zeros((g, n_terms, n_tiles * tile_d),
                            dtype=torch.float32, device=dev)
        cells[qi, first[entry[lane], qi], tile[lane] * tile_d + d[lane]] = \
            tile_scores[tile[lane], j[lane]]
        acc = torch.zeros((g, n_tiles * tile_d), dtype=torch.float32,
                          device=dev)
        for l in range(n_terms):
            acc = acc + cells[:, l]
        out[g0:g0 + g] = acc
    return out.view(q, n_tiles, tile_d)


def score_smem_bytes(q: int, n_terms: int, tile_d: int, block_size: int
                     ) -> int:
    """Shared memory of one block of the CUDA kernel: the keep mask, the
    group's term table (keys, masks and 4-bit slot codes of 32 queries)
    and filter, its block flags and its (query, slot, doc) f32 cells."""
    gq = min(q, term_table.GROUP)
    size = 1 << term_table.table_bits(gq * n_terms)
    return 4 * (1 + size * (2 + term_table.GROUP // 8)
                + term_table.FILTER_WORDS + gq * (tile_d // block_size)
                + gq * n_terms * tile_d)


def blockmax_score_batched(tile_docs: torch.Tensor, tile_terms: torch.Tensor,
                           tile_scores: torch.Tensor, qterms: torch.Tensor,
                           survive_b: torch.Tensor, survive_t: torch.Tensor,
                           *, tile_d: int, block_size: int) -> torch.Tensor:
    """Batched exact scoring over the shard's bucketed mirror.

    Args:
      tile_docs/tile_terms/tile_scores: (n_tiles, CAP) bucketed mirror
        (int32, int32, float32), tile-local doc ids with -1 padding.
      qterms: (Q, L) int32 query term ids, -1 in masked-out slots.
      survive_b: (Q, n_tiles, tile_d // block_size) int32 block flags.
      survive_t: (Q, n_tiles) int32 tile flags.
    Returns:
      (Q, n_tiles, tile_d) float32 accumulator tiles.
    """
    n_tiles, cap = tile_docs.shape
    q, n_terms = qterms.shape
    bpt = tile_d // block_size
    if tile_terms.shape != tile_docs.shape or \
            tile_scores.shape != tile_docs.shape:
        raise ValueError("tile_docs/tile_terms/tile_scores shapes differ")
    if tuple(survive_b.shape) != (q, n_tiles, bpt):
        raise ValueError(f"survive_b must be {(q, n_tiles, bpt)}, "
                         f"got {tuple(survive_b.shape)}")
    if tuple(survive_t.shape) != (q, n_tiles):
        raise ValueError(f"survive_t must be {(q, n_tiles)}, "
                         f"got {tuple(survive_t.shape)}")
    kernels.on_cpu(tile_docs, tile_terms, tile_scores, qterms, survive_b,
                   survive_t)
    return kernels.call("blockmax_score", tile_docs, tile_terms, tile_scores,
                        qterms, survive_b, survive_t, tile_d, block_size)


def _batched_plain(tile_docs, tile_terms, tile_scores, qterms, survive_b,
                   survive_t, tile_d, block_size):
    return blockmax_score_plain(tile_docs, tile_terms, tile_scores, qterms,
                                survive_b, survive_t, tile_d=tile_d,
                                block_size=block_size)


def _batched_fake(tile_docs, tile_terms, tile_scores, qterms, survive_b,
                  survive_t, tile_d, block_size):
    """The card call's (Q, n_tiles, tile_d) float32 output, after its input
    checks but the device's."""
    _batched_checks(tile_docs, tile_terms, tile_scores, qterms, survive_b,
                    survive_t, tile_d, block_size, False)
    return torch.empty((qterms.shape[0], tile_docs.shape[0], tile_d),
                       dtype=torch.float32, device=tile_docs.device)


def _batched_checks(tile_docs, tile_terms, tile_scores, qterms, survive_b,
                    survive_t, tile_d, block_size, real=True):
    q, n_terms = qterms.shape
    bpt = tile_d // block_size
    i32 = torch.int32
    kernels.check_cuda_args(
        "blockmax_score_batched",
        dict(tile_docs=tile_docs, tile_terms=tile_terms,
             tile_scores=tile_scores, qterms=qterms, survive_b=survive_b,
             survive_t=survive_t),
        dict(tile_docs=i32, tile_terms=i32, tile_scores=torch.float32,
             qterms=i32, survive_b=i32, survive_t=i32), real)
    if -(-q // term_table.GROUP) > 65535:
        raise ValueError(f"{q} queries exceed the grid's y limit")
    if n_terms > MAX_TERMS:
        raise ValueError(f"{n_terms} query terms exceed the kernel's "
                         f"{MAX_TERMS} slot codes")
    if bpt < 1 or bpt * block_size != tile_d:
        raise ValueError(f"tile_d={tile_d} must be a multiple of "
                         f"block_size={block_size}")
    if score_smem_bytes(q, n_terms, tile_d, block_size) > \
            term_table.SMEM_OPTIN:
        raise ValueError(f"{n_terms} query terms x tile_d={tile_d} exceed "
                         "one block's shared memory")


def _batched_launch(tile_docs: torch.Tensor, tile_terms: torch.Tensor,
                    tile_scores: torch.Tensor, qterms: torch.Tensor,
                    survive_b: torch.Tensor, survive_t: torch.Tensor,
                    tile_d: int, block_size: int) -> torch.Tensor:
    """Kernel 2's launch on CUDA tensors."""
    _batched_checks(tile_docs, tile_terms, tile_scores, qterms, survive_b,
                    survive_t, tile_d, block_size)
    out = torch.empty((qterms.shape[0], tile_docs.shape[0], tile_d),
                      dtype=torch.float32, device=tile_docs.device)
    kernels.extension().blockmax_score(tile_docs, tile_terms, tile_scores,
                                       qterms, survive_b, survive_t, out,
                                       block_size)
    kernels.LAUNCHES["blockmax_score_batched"] += 1
    return out


def _batched_flops(tile_docs, tile_terms, tile_scores, qterms, survive_b,
                   survive_t, tile_d, block_size, *args, **kwargs):
    """One term lookup a lane read, each group of ``term_table.GROUP``
    queries reading every tile's lanes (the tiles no query keeps and the
    adds depend on the data, which a fake tensor does not hold)."""
    return -(-qterms[0] // term_table.GROUP) * tile_docs[0] * tile_docs[1]


def _batched_shardings(*args):
    return kernels.split_strategies(6, 1, (), extra_in=2)


kernels.card_op("blockmax_score", _batched_launch, _batched_plain,
                _batched_fake,
                _batched_flops, _batched_shardings)


def blockmax_score_tiles(tile_docs: torch.Tensor, tile_terms: torch.Tensor,
                         tile_scores: torch.Tensor, qterms: torch.Tensor,
                         survive: torch.Tensor, *, tile_d: int,
                         block_size: int, n_blocks: int) -> torch.Tensor:
    """Batched masked scoring over the shard's bucketed mirror — the entry
    point the engine imports.

    ``survive`` is (Q, n_blocks) bool/int per-query block survival; the
    per-(tile, block) and per-tile flags are derived from it.  Returns
    (Q, n_tiles, tile_d) float32 tiles.
    """
    n_tiles = tile_docs.shape[0]
    q = qterms.shape[0]
    bpt = tile_d // block_size
    pad = n_tiles * bpt - n_blocks
    sb = torch.nn.functional.pad(survive.to(torch.int32), (0, pad))
    sb = sb.reshape(q, n_tiles, bpt).contiguous()
    st = (sb.sum(dim=2) > 0).to(torch.int32)
    return blockmax_score_batched(
        tile_docs, tile_terms, tile_scores,
        qterms.to(torch.int32).contiguous(), sb, st, tile_d=tile_d,
        block_size=block_size)


# ---------------------------------------------------------------------------
# single query: flat lanes, bucketed by doc tile
# ---------------------------------------------------------------------------

def blockmax_score_ref(docs: torch.Tensor, scores: torch.Tensor,
                       survive: torch.Tensor, n_docs: int, block_size: int
                       ) -> torch.Tensor:
    """Direct-scatter oracle: the (n_docs,) f32 sum of the scores of the
    lanes with doc >= 0 whose block survives.  On the CPU ``index_add_``
    adds in lane order; on the card it uses float atomics, whose order
    varies, so the port never calls it there."""
    live = docs >= 0
    blk = torch.where(live, docs.long() // block_size, 0)
    keep = live & (survive[blk] != 0)
    acc = torch.zeros((n_docs,), dtype=torch.float32, device=docs.device)
    return acc.index_add_(0, torch.where(keep, docs, 0).long(),
                          torch.where(keep, scores, 0.0))


def _residue_lanes(run_start: torch.Tensor, cap: int, n_lanes: int):
    """(lane positions, tiles) of the overflow residue: the sorted-run lanes
    [run_start[t] + cap, run_start[t + 1]) of every tile t, in run order."""
    j = torch.arange(n_lanes, device=run_start.device)
    tile = torch.searchsorted(run_start.long(), j, right=True) - 1
    n_tiles = run_start.shape[0] - 1
    res = (tile < n_tiles) & (j - run_start.long()[tile] >= cap)
    return j[res], tile[res]


def blockmax_score_bucketed_plain(docs_b: torch.Tensor, scores_b: torch.Tensor,
                                  survive_t: torch.Tensor,
                                  run_docs: torch.Tensor,
                                  run_scores: torch.Tensor,
                                  run_start: torch.Tensor, *, tile_d: int
                                  ) -> torch.Tensor:
    """Plain PyTorch version of the bucketed kernel, in the kernel's order.

    Each lane (the surviving tiles' bucket lanes, tile by tile, then the
    residue lanes in run order) gets its occurrence rank among the lanes of
    its (tile, doc) cell; the lanes are placed in (rank, cell) slots with no
    collisions and each cell is summed rank by rank from 0.0 — each doc's
    lanes in lane order, as the kernel's warp adds them step by step."""
    n_tiles, cap = docs_b.shape
    dev = docs_b.device
    tiles = torch.arange(n_tiles, device=dev)[:, None].expand(n_tiles, cap)
    live = (docs_b >= 0) & (docs_b < tile_d) & (survive_t[:, None] != 0)
    j, tile_r = _residue_lanes(run_start, cap, run_docs.shape[0])
    docs_r = run_docs[j].long()
    ok = (docs_r >= 0) & (docs_r < tile_d)
    cell = torch.cat([tiles[live] * tile_d + docs_b[live].long(),
                      (tile_r * tile_d + docs_r)[ok]])
    vals = torch.cat([scores_b[live], run_scores[j][ok]])
    srt, order = torch.sort(cell, stable=True)
    rank = torch.empty_like(order)
    rank[order] = (torch.arange(cell.shape[0], device=dev)
                   - torch.searchsorted(srt, srt))
    n_rank = int(rank.max()) + 1 if cell.numel() else 0
    slots = torch.zeros((max(n_rank, 1), n_tiles * tile_d),
                        dtype=torch.float32, device=dev)
    slots[rank, cell] = vals
    acc = torch.zeros((n_tiles * tile_d,), dtype=torch.float32, device=dev)
    for r in range(n_rank):
        acc = acc + slots[r]
    return acc.reshape(n_tiles, tile_d)


def blockmax_score_bucketed(docs_b: torch.Tensor, scores_b: torch.Tensor,
                            survive_t: torch.Tensor, run_docs: torch.Tensor,
                            run_scores: torch.Tensor, run_start: torch.Tensor,
                            *, tile_d: int) -> torch.Tensor:
    """One query's masked scoring over a bucketed layout.

    Args:
      docs_b/scores_b: (n_tiles, CAP) bucket (int32 tile-local doc ids with
        -1 padding, float32 scores).
      survive_t: (n_tiles,) int32; a tile with 0 adds no bucket lane.
      run_docs/run_scores: (P,) the lanes sorted by tile (tile-local ids),
        of which row t of the bucket holds the first CAP of tile t.
      run_start: (n_tiles + 1,) int32 first run position of each tile; the
        run lanes [run_start[t] + CAP, run_start[t + 1]) are tile t's
        overflow residue, added after its bucket in run order.
    Returns:
      (n_tiles, tile_d) float32 accumulator tiles.
    """
    n_tiles, cap = docs_b.shape
    if scores_b.shape != docs_b.shape:
        raise ValueError("docs_b/scores_b shapes differ")
    if tuple(survive_t.shape) != (n_tiles,) or \
            tuple(run_start.shape) != (n_tiles + 1,):
        raise ValueError("survive_t must be (n_tiles,) and run_start "
                         "(n_tiles + 1,)")
    if run_scores.shape != run_docs.shape:
        raise ValueError("run_docs/run_scores shapes differ")
    if kernels.on_cpu(docs_b, scores_b, survive_t, run_docs, run_scores,
                      run_start):
        return blockmax_score_bucketed_plain(
            docs_b, scores_b, survive_t, run_docs, run_scores, run_start,
            tile_d=tile_d)
    i32 = torch.int32
    kernels.check_cuda_args(
        "blockmax_score_bucketed",
        dict(docs_b=docs_b, scores_b=scores_b, survive_t=survive_t,
             run_docs=run_docs, run_scores=run_scores, run_start=run_start),
        dict(docs_b=i32, scores_b=torch.float32, survive_t=i32,
             run_docs=i32, run_scores=torch.float32, run_start=i32))
    if not 1 <= tile_d <= MAX_TILE_D:
        raise ValueError(f"tile_d={tile_d} must be in [1, {MAX_TILE_D}]")
    out = torch.empty((n_tiles, tile_d), dtype=torch.float32,
                      device=docs_b.device)
    kernels.extension().blockmax_score_bucketed(
        docs_b, scores_b, survive_t, run_docs, run_scores, run_start, out)
    kernels.LAUNCHES["blockmax_score_bucketed"] += 1
    return out


def blockmax_score(docs: torch.Tensor, scores: torch.Tensor,
                   survive: torch.Tensor, *, n_docs: int, block_size: int,
                   tile_d: int = 128, cap: int = 1024) -> torch.Tensor:
    """Exact scoring of flat lanes restricted to surviving blocks: (n_docs,)
    float32.

    ``tile_d`` must be a multiple of ``block_size`` (a tile covers whole
    pruning blocks).  Lanes in dead blocks are masked before bucketing; a
    tile survives if any lane reached it.  A tile's lanes past ``cap`` are
    its overflow residue, which the kernel adds after the bucket, in order.
    """
    if tile_d % block_size:
        raise ValueError(f"tile_d={tile_d} must be a multiple of "
                         f"block_size={block_size}")
    live = docs >= 0
    blk = torch.where(live, docs.long() // block_size, 0)
    keep = live & (survive[blk] != 0)
    docs_m = torch.where(keep, docs, -1)
    b = bucket_by_tile(docs_m, scores.to(torch.float32), 0.0,
                       n_docs=n_docs, tile_d=tile_d, cap=cap)
    survive_t = (b.start[1:] > b.start[:-1]).to(torch.int32)
    n_tiles = survive_t.shape[0]
    run_docs = torch.where(b.tile_s < n_tiles,
                           docs_m[b.order] - b.tile_s * tile_d, -1)
    acc = blockmax_score_bucketed(
        b.docs_b, b.vals_b, survive_t,
        run_docs.to(torch.int32).contiguous(),
        scores[b.order].to(torch.float32).contiguous(),
        b.start.to(torch.int32).contiguous(), tile_d=tile_d)
    return acc.reshape(-1)[:n_docs]
