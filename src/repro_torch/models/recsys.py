"""The two-tower retrieval model's inference path (Yi et al., RecSys'19).

The port of the ``two_tower`` branch of ``repro.models.recsys``: per-side
embedding tables, a mean EmbeddingBag, a ReLU MLP tower and an L2
normalization (``tower_embed``).  Parameters keep the reference's layout
(tables (rows, 256), MLP weights (fan_in, fan_out), ``x @ w + b``), so
``repro_torch.convert.two_tower_params`` can carry a reference init across
array for array.  Only inference is ported; the loss and training stay in
the reference (ROADMAP.md, section 1, item 11).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from repro_torch.isn.backend import resolve_device
from repro_torch.models.embedding import embedding_bag

TABLE_DIM = 256     # width of both embedding tables (fixed by the reference)
SIDES = ("user", "item")


@dataclass(frozen=True)
class TwoTowerConfig:
    """The fields of the reference's ``RecsysConfig`` that shape a two-tower
    model's parameters."""
    tower_mlp: tuple
    n_users: int
    n_items: int


def mlp(params, x: torch.Tensor) -> torch.Tensor:
    """``x @ w_i + b_i`` for each layer, ReLU between layers (none after
    the last, as ``tower_embed`` calls the reference's ``_mlp``)."""
    n = len([k for k in params if k.startswith("w")])
    for i in range(n):
        x = x @ params[f"w{i}"] + params[f"b{i}"]
        if i < n - 1:
            x = torch.relu(x)
    return x


class TwoTower(nn.Module):
    """The tower pair on an explicit device.

    ``params`` is the reference's parameter tree as arrays:
    ``{"user_table", "item_table": (rows, 256), "user_mlp", "item_mlp":
    {"w0", "b0", ...}}``.  The parameters take no gradient.
    """

    def __init__(self, params: dict, device=None):
        super().__init__()
        dev = resolve_device(device)

        def param(a):
            return nn.Parameter(torch.from_numpy(np.array(a, np.float32))
                                .to(dev), requires_grad=False)

        self.tables = nn.ParameterDict(
            {side: param(params[f"{side}_table"]) for side in SIDES})
        self.mlps = nn.ModuleDict(
            {side: nn.ParameterDict({k: param(v) for k, v in
                                     params[f"{side}_mlp"].items()})
             for side in SIDES})

    @property
    def device(self) -> torch.device:
        return self.tables["user"].device

    @classmethod
    def init(cls, c: TwoTowerConfig, seed: int = 0,
             device=None) -> "TwoTower":
        """A fresh tower drawn as the reference's ``recsys.init`` draws it:
        tables N(0, 0.01²), MLP weights N(0, 1/fan_in), zero biases.  The
        draws come from a CPU ``torch.Generator`` seeded with ``seed``, so
        they do not depend on the device, but they are not the reference's
        ``jax.random`` draws."""
        g = torch.Generator().manual_seed(seed)
        dims = (TABLE_DIM,) + tuple(c.tower_mlp)

        def normal(shape, scale):
            return torch.randn(shape, generator=g) * scale

        params = {"user_table": normal((c.n_users, TABLE_DIM), 0.01),
                  "item_table": normal((c.n_items, TABLE_DIM), 0.01)}
        for side in SIDES:
            layers = {}
            for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
                layers[f"w{i}"] = normal((a, b), 1.0 / math.sqrt(a))
                layers[f"b{i}"] = torch.zeros(b)
            params[f"{side}_mlp"] = layers
        return cls(params, device)

    @torch.no_grad()
    def tower_embed(self, side: str, ids: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
        """(B, d) L2-normalized tower outputs for padded id bags (B, L)."""
        e = embedding_bag(self.tables[side], ids, mask)
        z = mlp(self.mlps[side], e)
        return z / torch.clamp(torch.linalg.norm(z, dim=-1, keepdim=True),
                               min=1e-6)
