"""Numerics shared by the model families: RMS norm, rotary embedding,
SwiGLU, the GELU MLP and the masked cross-entropy; and the parameter
helpers of the recsys and GNN families (``Leaf`` shapes, their draw, the
plain MLP).

Copies of ``rms_norm``, ``rope``, ``swiglu``, ``gelu_mlp`` and
``cross_entropy`` of the reference's ``models/common.py``, with its
promotion order: ``rms_norm`` normalises in fp32 and casts back to x's type
before multiplying by γ; ``rope`` rotates in fp32 and casts back.
``jax.nn.gelu`` is the tanh approximation by default, and so is
``gelu_mlp``'s.  ``dense``, ``mlp_shapes``, ``draw`` and ``mlp`` take
the place of the reference's ``ParamFactory`` and ``_mlp``: a dense leaf
is N(0, 1/first dimension), as ``ParamFactory`` draws it.  The
reference's logical-sharding helpers (``constrain``, ``ParamFactory``'s
axis names) do nothing on one device and are not ported.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * gamma


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding. x: (..., S, D even); positions: (..., S)."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(half, dtype=torch.float32,
                                     device=x.device) / half)
    ang = positions[..., None].float() * freqs          # (..., S, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    return (torch.nn.functional.silu(x @ w_gate) * (x @ w_up)) @ w_down


def gelu_mlp(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
             w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    h = torch.nn.functional.gelu(x @ w1 + b1, approximate="tanh")
    return h @ w2 + b2


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  vocab: int) -> torch.Tensor:
    """Mean cross-entropy in fp32 over the labels >= 0 (the others are
    ignored).  Logit slots at or past ``vocab`` (padding of the last axis)
    are masked to -1e30 out of the partition function."""
    logits = logits.float()
    if logits.shape[-1] > vocab:
        live = torch.arange(logits.shape[-1], device=logits.device) < vocab
        logits = torch.where(live, logits, -1e30)
    lse = torch.logsumexp(logits, dim=-1)
    labels = labels.long()
    gold = torch.gather(logits, -1,
                        torch.clamp(labels, min=0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    return ((lse - gold) * mask).sum() / torch.clamp(mask.sum(), min=1.0)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

class Leaf(NamedTuple):
    """A parameter's shape and fill: ``"normal"`` × ``scale``, ``"zeros"``
    or ``"ones"``."""
    shape: tuple
    fill: str = "normal"
    scale: float = 0.0


def dense(shape: tuple, scale: float | None = None) -> Leaf:
    """A normal leaf at ``scale``, by default 1/√(its first dimension): for
    a stacked leaf that is the stack's extent, as the reference's
    ``ParamFactory`` draws it."""
    return Leaf(tuple(shape), "normal",
                scale if scale is not None else 1.0 / math.sqrt(
                    max(shape[0], 1)))


def shape_leaves(tree) -> list:
    if isinstance(tree, Leaf):
        return [tree]
    return [leaf for v in tree.values() for leaf in shape_leaves(v)]


def mlp_shapes(dims, stack=()) -> dict:
    """``w{i}`` (a, b) normal, ``b{i}`` (b,) zeros over consecutive
    ``dims``, each with the leading ``stack`` axes."""
    stack = tuple(stack)
    ps = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        ps[f"w{i}"] = dense(stack + (a, b))
        ps[f"b{i}"] = Leaf(stack + (b,), "zeros")
    return ps


def draw(tree, gen: torch.Generator, dtype, device) -> dict:
    """Tensors of a ``Leaf`` tree, the normal leaves drawn from ``gen`` in
    the tree's order."""
    if isinstance(tree, dict):
        return {k: draw(v, gen, dtype, device) for k, v in tree.items()}
    if tree.fill == "zeros":
        return torch.zeros(tree.shape, dtype=dtype, device=device)
    if tree.fill == "ones":
        return torch.ones(tree.shape, dtype=dtype, device=device)
    w = torch.randn(tree.shape, generator=gen, dtype=dtype, device=device)
    return w.mul_(tree.scale)


def mlp(params, x: torch.Tensor, act=torch.relu,
        last_act: bool = False) -> torch.Tensor:
    """``x @ w_i + b_i`` for each layer, ``act`` between layers (and after
    the last with ``last_act``), as the reference's ``_mlp``."""
    n = len([k for k in params if k.startswith("w")])
    for i in range(n):
        x = x @ params[f"w{i}"] + params[f"b{i}"]
        if i < n - 1 or last_act:
            x = act(x)
    return x
