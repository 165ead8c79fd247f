"""DAAT block-max scoring: the kernel wrapper, its plain version, and the
shard-mirror entry point the DAAT engine imports.

``blockmax_score_batched`` launches ``blockmax_score.cu`` for CUDA tensors
and runs ``blockmax_score_plain`` for CPU tensors. Both compute the
function of the Pallas kernel ``blockmax_score_batched``
(repro/kernels/blockmax_score/kernel.py): per (query, doc tile), the sum of
the f32 BM25 scores of the tile's postings whose term is one of the query's
terms (membership) and whose pruning block survives; tiles with
``survive_t == 0`` are all zeros.

Both paths give each live lane its own (first matching query-term slot,
doc) cell and sum each doc's cells in slot order from 0.0, so they agree
bit for bit.  ``blockmax_score_tiles`` derives the per-tile flags from
per-block survival, as the reference's ``ops.blockmax_score_tiles`` does.
"""

from __future__ import annotations

import torch

from repro_torch import kernels

SMEM_LIMIT = 48 * 1024   # static shared-memory limit of one block


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
    if kernels.on_cpu(tile_docs, tile_terms, tile_scores, qterms, survive_b,
                      survive_t):
        return blockmax_score_plain(tile_docs, tile_terms, tile_scores,
                                    qterms, survive_b, survive_t,
                                    tile_d=tile_d, block_size=block_size)
    i32 = torch.int32
    kernels.check_cuda_args(
        "blockmax_score_batched",
        dict(tile_docs=tile_docs, tile_terms=tile_terms,
             tile_scores=tile_scores, qterms=qterms, survive_b=survive_b,
             survive_t=survive_t),
        dict(tile_docs=i32, tile_terms=i32, tile_scores=torch.float32,
             qterms=i32, survive_b=i32, survive_t=i32))
    if n_tiles > 65535:
        raise ValueError(f"n_tiles={n_tiles} exceeds the grid's y limit")
    if 4 * (n_terms * tile_d + n_terms + bpt) > SMEM_LIMIT:
        raise ValueError(f"{n_terms} query terms x tile_d={tile_d} exceed "
                         "one block's shared memory")
    out = torch.empty((q, n_tiles, tile_d), dtype=torch.float32,
                      device=tile_docs.device)
    kernels.extension().blockmax_score(tile_docs, tile_terms, tile_scores,
                                       qterms, survive_b, survive_t, out,
                                       block_size)
    kernels.LAUNCHES["blockmax_score_batched"] += 1
    return out


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
