"""Embedding tables and EmbeddingBag for the recsys family.

A port of the reference's ``models/embedding.py``: ``lookup`` (row gather),
``embedding_bag`` over rectangular padded bags (``sum``, ``mean`` and
``max``: masked slots take -inf before the max, so an empty bag is -inf)
and ``ragged_embedding_bag`` over a flat id list with a bag id per entry
(the reference's ``jax.ops.segment_sum``: ``common.segment_sum``, each bag
summed in entry order, the same bits on every run).  Ids may come as
int32; they index as int64.

``sharded_lookup_manual`` is the reference's table-parallel lookup inside
``shard_map`` on one rank of the mesh in scope: the rows of its own shard,
zeros for the others, summed over the named axis's group.
"""

from __future__ import annotations

import torch

from repro_torch.models import common


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
    return common.segment_sum(rows, bag_ids, n_bags)


def sharded_lookup_manual(table_local: torch.Tensor, ids: torch.Tensor,
                          axis_name: str, shard_rows: int) -> torch.Tensor:
    """Explicit table-parallel lookup on this rank of the mesh in scope.

    The rank at index i of ``axis_name`` holds rows [i·shard_rows,
    (i+1)·shard_rows) as ``table_local``; ids outside them contribute
    zeros and the sum over the axis's group recovers the full rows."""
    mesh = common.get_abstract_mesh_or_none()
    if mesh is None:
        raise ValueError("sharded_lookup_manual needs a mesh in scope "
                         "(launch/mesh.mesh_context)")
    local = ids.long() - common.mesh_coords(mesh)[axis_name] * shard_rows
    valid = (local >= 0) & (local < shard_rows)
    rows = table_local[local.clamp(0, shard_rows - 1)]
    rows = torch.where(valid[..., None], rows, 0)
    return common.psum(rows, mesh, axis_name)
