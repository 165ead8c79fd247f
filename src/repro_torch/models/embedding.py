"""EmbeddingBag over padded bags (the subset the two-tower forward needs)."""

from __future__ import annotations

import torch


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """Mean of the masked rows of each padded bag (the reference's
    ``mode="mean"``): ids (B, L), mask (B, L) -> (B, D)."""
    e = table[ids] * mask[..., None]
    return e.sum(dim=-2) / torch.clamp(mask.sum(dim=-1, keepdim=True),
                                       min=1.0)
