"""Flat postings lanes -> the per-query bucketed doc-tile layout.

The single-query kernel wrappers (``ops.impact_accumulate``,
``ops.blockmax_score``) take flat (doc, value) lanes and bucket them the way
the reference's wrappers do (repro/kernels/impact_accumulate/ops.py and
repro/kernels/blockmax_score/ops.py):

* a lane with doc < 0 goes to a ghost tile ``n_tiles`` past the last one;
* a **stable** sort of the tile ids keeps the lanes' own order inside each
  tile (``jnp.argsort`` is stable);
* the first ``cap`` lanes of tile t fill row t of the (n_tiles, cap)
  bucket, as tile-local doc ids with -1 padding; the rest of the tile's
  lanes are its **overflow residue**, which the wrappers add after the
  kernel.

The reference scatters the fitting lanes into the bucket through a dump
slot.  Here each bucket slot gathers its lane from the sorted run instead
(same result): on the card a scatter of every non-fitting lane into one
dump slot would serialize on that address.  Nothing here waits on the
device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Buckets(NamedTuple):
    docs_b: torch.Tensor    # (n_tiles, cap) int32 tile-local doc ids, -1 pad
    vals_b: torch.Tensor    # (n_tiles, cap) lane values, ``pad`` padding
    order: torch.Tensor     # (P,) int64 the stable sort of the lanes by tile
    tile_s: torch.Tensor    # (P,) int64 sorted tile ids (n_tiles = ghost)
    start: torch.Tensor     # (n_tiles + 1,) int64 first sorted lane per tile

    def overflow(self, cap: int) -> torch.Tensor:
        """(P,) bool over the sorted lanes: the residue that did not fit
        its tile's ``cap`` bucket slots (ghost lanes excluded)."""
        n_tiles = self.start.shape[0] - 1
        pos = (torch.arange(self.tile_s.shape[0], device=self.tile_s.device)
               - self.start[self.tile_s])
        return (pos >= cap) & (self.tile_s < n_tiles)


def bucket_by_tile(docs: torch.Tensor, vals: torch.Tensor, pad, *,
                   n_docs: int, tile_d: int, cap: int) -> Buckets:
    """Bucket flat lanes by doc tile.

    Args:
      docs: (P,) int32 doc ids, < 0 for dead lanes.
      vals: (P,) lane values bucketed alongside, ``pad`` in empty slots.
      n_docs / tile_d / cap: accumulator size, docs per tile, lanes per
        bucket row.
    """
    dev = docs.device
    p = docs.shape[0]
    n_tiles = -(-n_docs // tile_d)
    tile = torch.where(docs >= 0, docs.long() // tile_d, n_tiles)
    order = torch.argsort(tile, stable=True)
    tile_s = tile[order]
    start = torch.searchsorted(tile_s, torch.arange(n_tiles + 1, device=dev))
    lane = start[:n_tiles, None] + torch.arange(cap, device=dev)
    # slot (t, j) takes sorted lane start[t] + j, or the pad lane at p
    src = torch.where(lane < start[1:, None], lane, p)

    def gather(v, fill):
        return torch.cat([v[order], v.new_full((1,), fill)])[src]

    offset = (torch.arange(n_tiles, device=dev) * tile_d)[:, None]
    docs_b = torch.where(src < p, gather(docs, -1) - offset, -1)
    return Buckets(docs_b.to(torch.int32).contiguous(),
                   gather(vals, pad).contiguous(), order, tile_s, start)
