"""SAAT impact accumulation: the kernel wrapper, its plain version, and the
shard-mirror entry point the SAAT engine imports.

``impact_accumulate_batched`` launches ``impact_accumulate.cu`` for CUDA
tensors and runs ``impact_accumulate_plain`` for CPU tensors. Both compute
the function of the Pallas kernel ``impact_accumulate_batched``
(repro/kernels/impact_accumulate/kernel.py): per (query, doc tile), the sum
of the quantized impacts of the tile's postings whose term is one of the
query's terms (membership: a repeated query term counts once) and whose
impact reaches the query's level cut. Integer sums, so both paths agree
with each other and with the TPU kernel exactly. """

from __future__ import annotations

import torch

from repro_torch import kernels

# elements of one (queries, n_tiles, cap) working set of the plain version
PLAIN_CHUNK_ELEMS = 1 << 24


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
    if kernels.on_cpu(tile_docs, tile_terms, tile_imps, qterms, lstar):
        return impact_accumulate_plain(tile_docs, tile_terms, tile_imps,
                                       qterms, lstar, tile_d=tile_d)
    i32 = torch.int32
    kernels.check_cuda_args(
        "impact_accumulate_batched",
        dict(tile_docs=tile_docs, tile_terms=tile_terms, tile_imps=tile_imps,
             qterms=qterms, lstar=lstar),
        dict(tile_docs=i32, tile_terms=i32, tile_imps=i32, qterms=i32,
             lstar=i32))
    if n_tiles > 65535:
        raise ValueError(f"n_tiles={n_tiles} exceeds the grid's y limit")
    out = torch.empty((q, n_tiles, tile_d), dtype=i32, device=tile_docs.device)
    kernels.extension().impact_accumulate(tile_docs, tile_terms, tile_imps,
                                          qterms, lstar, out)
    kernels.LAUNCHES["impact_accumulate_batched"] += 1
    return out


def impact_accumulate_tiles(tile_docs: torch.Tensor, tile_terms: torch.Tensor,
                            tile_imps: torch.Tensor, qterms: torch.Tensor,
                            lstar: torch.Tensor, *, tile_d: int
                            ) -> torch.Tensor:
    """Batched SAAT accumulation over the shard's bucketed mirror — the
    entry point the engine imports.  Returns (Q, n_tiles, tile_d) int32."""
    return impact_accumulate_batched(
        tile_docs, tile_terms, tile_imps, qterms.to(torch.int32).contiguous(),
        lstar.to(torch.int32).contiguous(), tile_d=tile_d)
