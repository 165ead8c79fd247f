"""SAAT impact accumulation: the kernel wrappers, their plain versions, and
the entry points the SAAT engine imports.

Two kernels live in ``impact_accumulate.cu``, each with a wrapper that
launches it for CUDA tensors and runs its plain version for CPU tensors:

* ``impact_accumulate_batched`` (plain: ``impact_accumulate_plain``), the
  Pallas kernel ``impact_accumulate_batched``
  (repro/kernels/impact_accumulate/kernel.py): per (query, doc tile) of the
  shard's mirror, the sum of the quantized impacts of the tile's postings
  whose term is one of the query's terms (membership: a repeated query term
  counts once) and whose impact reaches the query's level cut.  The batched
  SAAT engine's hot loop.  ``impact_accumulate_grouped`` is the CUDA
  kernel's arithmetic in PyTorch (one term table per group of 32 queries,
  ``term_table``), for the tests and ``chip_smoke.py``.
* ``impact_accumulate_bucketed`` (plain:
  ``impact_accumulate_bucketed_plain``), the Pallas kernel
  ``impact_accumulate_bucketed``: one query's postings bucketed by doc tile,
  per tile the sum of the impacts of lanes with doc >= 0 and impact >= a
  scalar cut.  ``impact_accumulate`` (the flat wrapper) buckets flat lanes
  for it, passes each row's live length so the kernel reads only the
  row's prefix, and adds the overflow residue after it; the per-query SAAT
  path (``isn.saat.saat_serve_laxmap``) calls it.

Integer sums, so every path agrees with the others and with the TPU
kernels exactly.  ``impact_accumulate_ref`` is the direct-scatter oracle.
"""

from __future__ import annotations

import torch

from repro_torch import kernels
from repro_torch.kernels import term_table
from repro_torch.kernels.buckets import bucket_by_tile

# elements of one (queries, n_tiles, cap) working set of the plain version
PLAIN_CHUNK_ELEMS = 1 << 24
MAX_TILE_D = 1536        # the bucketed kernel's int32 sums of 8 tiles a
                         # block stay in 48 KB of shared memory


def impact_accumulate_plain(tile_docs: torch.Tensor, tile_terms: torch.Tensor,
                            tile_imps: torch.Tensor, qterms: torch.Tensor,
                            lstar: torch.Tensor, *, tile_d: int
                            ) -> torch.Tensor:
    """Plain PyTorch version over the same tile layout, chunked over queries
    so the (queries, n_tiles, cap) match never outgrows memory."""
    n_tiles, cap = tile_docs.shape
    q, n_terms = qterms.shape
    dev = tile_docs.device
    out = torch.empty((q, n_tiles, tile_d), dtype=torch.int32, device=dev)
    docs = tile_docs.long()
    # dead lanes scatter into a dump column past the tile, sliced off below
    dump = torch.where(docs >= 0, docs, tile_d)
    chunk = max(1, PLAIN_CHUNK_ELEMS // max(n_tiles * cap, 1))
    for q0 in range(0, q, chunk):
        qt = qterms[q0:q0 + chunk]
        c = qt.shape[0]
        match = torch.zeros((c, n_tiles, cap), dtype=torch.bool, device=dev)
        for l in range(n_terms):
            t_l = qt[:, l].view(c, 1, 1)
            match |= (tile_terms.unsqueeze(0) == t_l) & (t_l >= 0)
        live = (match & (docs >= 0).unsqueeze(0)
                & (tile_imps.unsqueeze(0)
                   >= lstar[q0:q0 + c].view(c, 1, 1)))
        idx = torch.where(live, dump.unsqueeze(0), tile_d)
        val = torch.where(live, tile_imps.unsqueeze(0), 0)
        acc = torch.zeros((c, n_tiles, tile_d + 1), dtype=torch.int32,
                          device=dev)
        acc.scatter_add_(2, idx, val)
        out[q0:q0 + c] = acc[..., :tile_d]
    return out


def impact_accumulate_grouped(tile_docs: torch.Tensor,
                              tile_terms: torch.Tensor,
                              tile_imps: torch.Tensor, qterms: torch.Tensor,
                              lstar: torch.Tensor, *, tile_d: int
                              ) -> torch.Tensor:
    """The CUDA kernel's arithmetic in PyTorch (for the tests and
    ``chip_smoke.py``): per group of ``term_table.GROUP`` queries, the
    group's term table, one lookup per lane, and for each matching lane
    with a doc in [0, tile_d) its impact added to the row of every query
    bit whose cut it reaches.  Equal to ``impact_accumulate_plain``."""
    n_tiles = tile_docs.shape[0]
    q = qterms.shape[0]
    out = torch.zeros((q, n_tiles * tile_d), dtype=torch.int32,
                      device=tile_docs.device)
    for g0 in range(0, q, term_table.GROUP):
        qt = qterms[g0:g0 + term_table.GROUP]
        g = qt.shape[0]
        keys, mask, _ = term_table.group_table(qt)
        tile, j, entry = term_table.matched_lanes(keys, tile_docs, tile_terms,
                                                  tile_d)
        imp = tile_imps[tile, j]
        adds = (term_table.mask_bits(mask[entry], g)
                & (imp.unsqueeze(1) >= lstar[g0:g0 + g].unsqueeze(0)))
        lane, qi = torch.nonzero(adds, as_tuple=True)
        cell = tile[lane] * tile_d + tile_docs[tile[lane], j[lane]]
        out[g0:g0 + g].index_put_((qi, cell), imp[lane], accumulate=True)
    return out.view(q, n_tiles, tile_d)


def impact_smem_bytes(q: int, n_terms: int, tile_d: int) -> int:
    """Shared memory of one block of the CUDA kernel: the group's term
    table (keys and masks) and filter, its cuts and its int32 accumulator
    rows."""
    gq = min(q, term_table.GROUP)
    return 4 * (2 * (1 << term_table.table_bits(gq * n_terms))
                + term_table.FILTER_WORDS + term_table.GROUP + gq * tile_d)


def impact_accumulate_batched(tile_docs: torch.Tensor,
                              tile_terms: torch.Tensor,
                              tile_imps: torch.Tensor, qterms: torch.Tensor,
                              lstar: torch.Tensor, *, tile_d: int
                              ) -> torch.Tensor:
    """Batched impact accumulation over the shard's bucketed mirror.

    Args:
      tile_docs/tile_terms/tile_imps: (n_tiles, CAP) int32 bucketed mirror.
      qterms: (Q, L) int32 query term ids, -1 in masked-out slots.
      lstar: (Q,) int32 per-query impact-level cuts.
    Returns:
      (Q, n_tiles, tile_d) int32 accumulator tiles.
    """
    n_tiles, cap = tile_docs.shape
    q, n_terms = qterms.shape
    if tile_terms.shape != tile_docs.shape or \
            tile_imps.shape != tile_docs.shape:
        raise ValueError("tile_docs/tile_terms/tile_imps shapes differ")
    if lstar.shape != (q,):
        raise ValueError(f"lstar must be ({q},), got {tuple(lstar.shape)}")
    kernels.on_cpu(tile_docs, tile_terms, tile_imps, qterms, lstar)
    return kernels.call("impact_accumulate", tile_docs, tile_terms, tile_imps,
                        qterms, lstar, tile_d)


def _batched_plain(tile_docs, tile_terms, tile_imps, qterms, lstar, tile_d):
    return impact_accumulate_plain(tile_docs, tile_terms, tile_imps, qterms,
                                   lstar, tile_d=tile_d)


def _batched_fake(tile_docs, tile_terms, tile_imps, qterms, lstar, tile_d):
    """The card call's (Q, n_tiles, tile_d) int32 output, after its input
    checks but the device's."""
    _batched_checks(tile_docs, tile_terms, tile_imps, qterms, lstar, tile_d,
                    False)
    return torch.empty((qterms.shape[0], tile_docs.shape[0], tile_d),
                       dtype=torch.int32, device=tile_docs.device)


def _batched_checks(tile_docs, tile_terms, tile_imps, qterms, lstar, tile_d,
                    real=True):
    i32 = torch.int32
    q, n_terms = qterms.shape
    kernels.check_cuda_args(
        "impact_accumulate_batched",
        dict(tile_docs=tile_docs, tile_terms=tile_terms, tile_imps=tile_imps,
             qterms=qterms, lstar=lstar),
        dict(tile_docs=i32, tile_terms=i32, tile_imps=i32, qterms=i32,
             lstar=i32), real)
    if -(-q // term_table.GROUP) > 65535:
        raise ValueError(f"{q} queries exceed the grid's y limit")
    if impact_smem_bytes(q, n_terms, tile_d) > term_table.SMEM_OPTIN:
        raise ValueError(f"{n_terms} query terms x tile_d={tile_d} exceed "
                         "one block's shared memory")


def _batched_launch(tile_docs: torch.Tensor, tile_terms: torch.Tensor,
                    tile_imps: torch.Tensor, qterms: torch.Tensor,
                    lstar: torch.Tensor, tile_d: int) -> torch.Tensor:
    """Kernel 1's launch on CUDA tensors."""
    _batched_checks(tile_docs, tile_terms, tile_imps, qterms, lstar, tile_d)
    out = torch.empty((qterms.shape[0], tile_docs.shape[0], tile_d),
                      dtype=torch.int32, device=tile_docs.device)
    kernels.extension().impact_accumulate(tile_docs, tile_terms, tile_imps,
                                          qterms, lstar, out)
    kernels.LAUNCHES["impact_accumulate_batched"] += 1
    return out


def _batched_flops(tile_docs, tile_terms, tile_imps, qterms, lstar, tile_d,
                   *args, **kwargs):
    """One term lookup a lane read, each group of ``term_table.GROUP``
    queries reading every lane of every tile (chip_smoke.batched_work's
    lookups; its adds depend on the data, which a fake tensor does not
    hold)."""
    return -(-qterms[0] // term_table.GROUP) * tile_docs[0] * tile_docs[1]


def _batched_shardings(*args):
    return kernels.split_strategies(5, 1, (), extra_in=1)


kernels.card_op("impact_accumulate", _batched_launch, _batched_plain,
                _batched_fake,
                _batched_flops, _batched_shardings)


def impact_accumulate_tiles(tile_docs: torch.Tensor, tile_terms: torch.Tensor,
                            tile_imps: torch.Tensor, qterms: torch.Tensor,
                            lstar: torch.Tensor, *, tile_d: int
                            ) -> torch.Tensor:
    """Batched SAAT accumulation over the shard's bucketed mirror — the
    entry point the engine imports.  Returns (Q, n_tiles, tile_d) int32."""
    return impact_accumulate_batched(
        tile_docs, tile_terms, tile_imps, qterms.to(torch.int32).contiguous(),
        lstar.to(torch.int32).contiguous(), tile_d=tile_d)


# ---------------------------------------------------------------------------
# single query: flat lanes, bucketed by doc tile
# ---------------------------------------------------------------------------

def impact_accumulate_ref(docs: torch.Tensor, imps: torch.Tensor, lstar,
                          n_docs: int) -> torch.Tensor:
    """Direct-scatter oracle: the (n_docs,) int32 sum of the impacts of the
    lanes with doc >= 0 and impact >= ``lstar``."""
    live = (docs >= 0) & (imps >= lstar)
    acc = torch.zeros((n_docs,), dtype=torch.int32, device=docs.device)
    return acc.index_add_(0, torch.where(live, docs, 0).long(),
                          torch.where(live, imps, 0).to(torch.int32))


def impact_accumulate_bucketed_plain(docs_b: torch.Tensor,
                                     imps_b: torch.Tensor,
                                     lstar: torch.Tensor,
                                     lens: torch.Tensor | None = None, *,
                                     tile_d: int) -> torch.Tensor:
    """Plain PyTorch version of the bucketed kernel: (n_tiles, tile_d)
    int32, per tile the impacts of its lanes with 0 <= doc < tile_d and
    impact >= lstar, summed by doc; with ``lens``, only each row's first
    ``lens[t]`` slots count."""
    n_tiles, cap = docs_b.shape
    live = (docs_b >= 0) & (docs_b < tile_d) & (imps_b >= lstar)
    if lens is not None:
        live &= (torch.arange(cap, device=docs_b.device)[None, :]
                 < lens.view(n_tiles, 1))
    # dead lanes scatter into a dump column past the tile, sliced off below
    acc = torch.zeros((n_tiles, tile_d + 1), dtype=torch.int32,
                      device=docs_b.device)
    acc.scatter_add_(1, torch.where(live, docs_b, tile_d).long(),
                     torch.where(live, imps_b, 0))
    return acc[:, :tile_d]


def impact_accumulate_bucketed(docs_b: torch.Tensor, imps_b: torch.Tensor,
                               lstar: torch.Tensor,
                               lens: torch.Tensor | None = None, *,
                               tile_d: int) -> torch.Tensor:
    """One query's impact accumulation over a bucketed layout.

    Args:
      docs_b: (n_tiles, CAP) int32 doc ids local to each tile, -1 padding.
      imps_b: (n_tiles, CAP) int32 quantized impacts.
      lstar: (1,) int32 impact-level cut.
      lens: optional (n_tiles,) int32 live length of each row: the kernel
        reads only the first ``min(lens[t], CAP)`` slots of row t (the
        bucket rows are prefix-packed, ``kernels.buckets``).  Without it,
        whole rows.
    Returns:
      (n_tiles, tile_d) int32 accumulator tiles.
    """
    n_tiles, cap = docs_b.shape
    if imps_b.shape != docs_b.shape:
        raise ValueError("docs_b/imps_b shapes differ")
    if lstar.numel() != 1:
        raise ValueError(f"lstar must hold one cut, got {lstar.numel()}")
    if lens is not None and lens.shape != (n_tiles,):
        raise ValueError(f"lens must be ({n_tiles},), got "
                         f"{tuple(lens.shape)}")
    extra = () if lens is None else (lens,)
    if kernels.on_cpu(docs_b, imps_b, lstar, *extra):
        return impact_accumulate_bucketed_plain(docs_b, imps_b, lstar, lens,
                                                tile_d=tile_d)
    i32 = torch.int32
    kernels.check_cuda_args(
        "impact_accumulate_bucketed",
        dict(docs_b=docs_b, imps_b=imps_b, lstar=lstar,
             **({} if lens is None else dict(lens=lens))),
        dict(docs_b=i32, imps_b=i32, lstar=i32, lens=i32))
    if not 1 <= tile_d <= MAX_TILE_D:
        raise ValueError(f"tile_d={tile_d} must be in [1, {MAX_TILE_D}]")
    out = torch.empty((n_tiles, tile_d), dtype=i32, device=docs_b.device)
    kernels.extension().impact_accumulate_bucketed(docs_b, imps_b, lstar,
                                                   lens, out)
    kernels.LAUNCHES["impact_accumulate_bucketed"] += 1
    return out


def impact_accumulate(docs: torch.Tensor, imps: torch.Tensor, lstar, *,
                      n_docs: int, tile_d: int = 128, cap: int | None = None
                      ) -> torch.Tensor:
    """Accumulate flat lanes (docs, imps) with impact >= ``lstar`` into a
    (n_docs,) int32 accumulator through the bucketed kernel.

    The lanes are bucketed by doc tile (``kernels.buckets``); ``cap``
    (default ``tile_d * 8``, the bound for unique (term, doc) postings of an
    8-term query) is the bucket width, and the lanes of a tile past it are
    the overflow residue, added after the kernel with an integer
    ``index_add_`` (exact on the card too).
    """
    cap = tile_d * 8 if cap is None else cap
    dev = docs.device
    lstar = torch.as_tensor(lstar, dtype=torch.int32, device=dev).reshape(1)
    b = bucket_by_tile(docs, imps.to(torch.int32), 0, n_docs=n_docs,
                       tile_d=tile_d, cap=cap)
    # each row's live prefix: its tile's lanes, at most cap
    lens = torch.clamp(torch.diff(b.start), max=cap).to(torch.int32)
    acc = impact_accumulate_bucketed(b.docs_b, b.vals_b, lstar, lens,
                                     tile_d=tile_d).reshape(-1)[:n_docs]
    # the overflow residue: lanes past their tile's cap, in sorted order
    imps_s = imps[b.order]
    sel = torch.nonzero(b.overflow(cap) & (imps_s >= lstar))[:, 0]
    return acc.index_add_(0, docs[b.order[sel]].long(),
                          imps_s[sel].to(torch.int32))
