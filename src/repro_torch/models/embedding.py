"""Embedding tables and EmbeddingBag for the recsys family.

A port of the reference's ``models/embedding.py``: ``lookup`` (row gather),
``embedding_bag`` over rectangular padded bags (``sum``, ``mean`` and
``max``: masked slots take -inf before the max, so an empty bag is -inf)
and ``ragged_embedding_bag`` over a flat id list with a bag id per entry
(the reference's ``jax.ops.segment_sum``: ``index_add_``, whose float adds
run in no fixed order on the card).  Ids may come as int32; they index as
int64.

Not ported (ROADMAP §1 item 11, the launch stack): ``sharded_lookup_manual``
(a ``psum`` inside ``shard_map``), which raises ``NotImplementedError``.
"""

from __future__ import annotations

import torch


def lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(R, D) x (...,) ids -> (..., D)."""
    return table[ids.long()]


def embedding_bag(table: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor,
                  mode: str = "sum") -> torch.Tensor:
    """Padded-bag EmbeddingBag: ids (B, L), mask (B, L) -> (B, D)."""
    e = table[ids.long()] * mask[..., None]
    if mode == "sum":
        return e.sum(dim=-2)
    if mode == "mean":
        return e.sum(dim=-2) / torch.clamp(mask.sum(dim=-1, keepdim=True),
                                           min=1.0)
    if mode == "max":
        return torch.where(mask[..., None] > 0, e, -torch.inf).amax(dim=-2)
    raise ValueError(mode)


def ragged_embedding_bag(table: torch.Tensor, flat_ids: torch.Tensor,
                         bag_ids: torch.Tensor, n_bags: int,
                         weights: torch.Tensor | None = None) -> torch.Tensor:
    """Ragged bags as a segment sum: flat_ids (P,), bag_ids (P,) -> (n_bags,
    D)."""
    rows = table[flat_ids.long()]
    if weights is not None:
        rows = rows * weights[:, None]
    out = torch.zeros((n_bags, table.shape[1]), dtype=rows.dtype,
                      device=rows.device)
    return out.index_add(0, bag_ids.long(), rows)


def sharded_lookup_manual(table_local, ids, axis_name, shard_rows):
    """The table-parallel lookup inside ``shard_map``: not ported."""
    raise NotImplementedError(
        "sharded_lookup_manual (a psum inside shard_map) is not ported yet "
        "(ROADMAP §1 item 11, the launch stack)")
