"""AdamW with its schedule and gradient clipping, on trees of tensors.

A port of the reference's ``train/optimizer.py``: the moments are fp32
whatever the parameter's type, the update is computed in fp32 and cast back
to the parameter's type, and ``global_norm`` sums the leaves in the
reference's leaf order (dict keys sorted).  The state mirrors the parameter
tree.  The update of a leaf is computed in place in its parameter, its
moments and its gradient (a multiply-add may round once where the
reference rounds twice), so it allocates one full-size buffer at a time.
``apply`` first copies them, and leaves its inputs as they were, as the
reference's pure function does; ``apply(..., donate=True)`` does not (the
caller gives them up, as a jitted step donates its buffers), which a model
of embedding tables needs (the two-tower model's 8 M x 256 user table is
8.2 GB a copy).

``abstract_init`` gives the state's shapes for the dry run, on ``meta``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.train.tree import leaves, map_tree, part


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000


class OptState(NamedTuple):
    m: dict
    v: dict
    step: torch.Tensor      # int32 scalar


def init(params) -> OptState:
    """Zero fp32 moments beside each leaf, on its device; step 0."""
    zeros = map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    dev = leaves(params)[0].device
    return OptState(m=zeros, v=map_tree(torch.clone, zeros),
                    step=torch.zeros((), dtype=torch.int32, device=dev))


def abstract_init(params) -> OptState:
    """The state's shapes and types without storage: fp32 moments of each
    leaf's shape and an int32 scalar step, all ``meta`` tensors (the
    reference's ``ShapeDtypeStruct`` state)."""
    def moment(p):
        return torch.empty(p.shape, dtype=torch.float32, device="meta")
    return OptState(m=map_tree(moment, params), v=map_tree(moment, params),
                    step=torch.empty((), dtype=torch.int32, device="meta"))


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up, then a cosine from lr down to 0.1 lr, fp32."""
    s = step.float()
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((s - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cosine = 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * (0.1 + 0.9 * cosine)


def global_norm(tree) -> torch.Tensor:
    """√(Σ of each leaf's Σ x²) in fp32, the leaves in the reference's
    order."""
    total = 0
    for x in leaves(tree):
        total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(total)


def _layout(x, like):
    """``x`` in ``like``'s DTensor layout; a plain tensor as it is."""
    if isinstance(like, DTensor):
        return x.redistribute(like.device_mesh, like.placements)
    return x


@torch.no_grad()
def apply(params, grads, opt: OptState, cfg: AdamWConfig,
          donate: bool = False):
    """One AdamW update. Returns (new_params, new_opt, metrics).  With
    ``donate`` the update is written into ``params``, ``opt``'s moments and
    ``grads`` in place and the returned trees are the given ones; without
    it they are copied first (the same arithmetic either way)."""
    gn = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gn, min=1e-9), max=1.0)
    step = opt.step + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.float()
    c1, c2 = 1 - b1 ** stepf, 1 - b2 ** stepf

    def upd(p, g, m, v):
        # the reference's expressions, computed in the given buffers: g
        # holds g · scale, then √(v / c2) + eps.  On DTensor leaves the
        # gradient enters the moments' layout (a reduce-scatter into
        # ZeRO's shards) and the step the parameter's (an all-gather
        # back), as the reference's shardings make XLA do
        if not donate:
            p, m, v = p.clone(), m.clone(), v.clone()
        g = _layout(g, m).to(torch.float32, copy=not donate).mul_(scale)
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        delta = _layout(torch.div(m, c1).div_(
            torch.div(v, c2, out=g).sqrt_().add_(cfg.eps)), p)
        pf = p.float()
        delta.add_(pf, alpha=cfg.weight_decay)
        if p.dtype == torch.float32:
            p.sub_(delta.mul_(lr))
        else:
            p.copy_((pf - delta.mul_(lr)).to(p.dtype))
        return p, m, v

    out = map_tree(upd, params, grads, opt.m, opt.v)
    return (part(out, 0), OptState(part(out, 1), part(out, 2), step),
            {"grad_norm": gn, "lr": lr})
