"""Mixture-of-experts FFN with sort-based dispatch (granite-MoE, Moonlight).

A port of the reference's ``models/moe.py`` for one device: ``moe_forward``
is its branch for no mesh (``mesh is None``, ``moe.py:121-137``), which
routes every local token, buckets the routed (token, expert) pairs into
(E, capacity, d), runs the experts as batched products and combines the
weighted outputs.  Tokens beyond an expert's capacity are dropped exactly as
the reference drops them (Switch/GShard semantics).  Shared (always-on)
experts are an ordinary SwiGLU beside the routed ones.

The numerics follow the reference line by line:

* the router logits are ``x @ router`` in x's type, then fp32; the gates
  their softmax; the top-k keeps the lower expert id among equal gates, as
  ``lax.top_k`` does (ROADMAP rule a): a stable sort of the gates,
  descending (in bf16 serving the logits round before the cast, so exact
  ties are common, and ``torch.topk`` promises no order among them);
* the (token, expert) pairs are ordered by a stable sort on the expert, as
  the reference's ``jnp.argsort``; each pair's position in its expert's
  bucket, and so which pairs fit the capacity, follows from that order;
* the combine adds each token's k weighted expert outputs from zero in
  that order (expert ascending), rounding to x's type after each add, as
  the reference's ``.at[t_s].add`` does on the host: a gather and a
  sequential sum of k terms, with no float atomics (ROADMAP rule d);
* the expert products are plain batched matrix products (``torch.bmm``),
  which the reference leaves to XLA outside any kernel;
* the router's auxiliary loss is computed in fp32.

Training differentiates this branch as the reference's autodiff does: the
gradient reaches x, the experts and the router through the products, the
normalised top-k gates and the auxiliary loss's mean gate; the routes,
the capacity drops and the dispatch order are integers and carry none
(the scatter into the expert buckets and the gathers back are index
operations whose backward routes each row's gradient to its source).

Not ported (ROADMAP §1 item 11): the expert-parallel ``shard_map`` branch
(``moe.py:139-179``) waits for the launch stack's ``mesh_context``; called
with a mesh, ``moe_forward`` raises ``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

_EP = ("the expert-parallel MoE branch (a mesh) is not ported yet (ROADMAP "
       "§1 item 11)")


class MoEConfig(NamedTuple):
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


def moe_params(gen, d_model: int, cfg: MoEConfig, dtype=torch.float32,
               device="cpu", stack=()) -> dict:
    """The reference's ``moe_params`` tree drawn from ``gen``: each leaf
    normal × 1/√(its first dimension) — with a leading ``stack`` of (L,),
    as the reference stacks layer leaves, that is L — the router × 0.02."""
    e, f, fs = cfg.n_experts, cfg.d_ff_expert, cfg.d_ff_expert * cfg.n_shared
    shapes = {"router": (d_model, e), "w_gate": (e, d_model, f),
              "w_up": (e, d_model, f), "w_down": (e, f, d_model)}
    if cfg.n_shared:
        shapes.update(shared_gate=(d_model, fs), shared_up=(d_model, fs),
                      shared_down=(fs, d_model))
    params = {}
    for name, shape in shapes.items():
        full = tuple(stack) + shape
        w = torch.randn(full, generator=gen, dtype=dtype, device=device)
        params[name] = w.mul_(0.02 if name == "router"
                              else 1.0 / math.sqrt(max(full[0], 1)))
    return params


def capacity(t: int, cfg: MoEConfig) -> int:
    """An expert's capacity for ``t`` local tokens, in the reference's
    Python float order."""
    return max(int(t * cfg.top_k / cfg.n_experts * cfg.capacity_factor), 4)


def route(router, x, cfg: MoEConfig):
    """(gates (T, E) fp32, top-k gates (T, k) fp32 before their
    normalisation, top-k experts (T, k) int64): the gates in descending
    order, the lower expert id first among equal gates."""
    gates = torch.softmax((x @ router).float(), dim=-1)
    topv, tope = torch.sort(gates, dim=-1, descending=True, stable=True)
    return gates, topv[:, :cfg.top_k], tope[:, :cfg.top_k]


def dispatch(tope, n_experts: int, cap: int):
    """The bucketing of the (token, expert) pairs: (order, the pairs in
    expert order (stable); pos, each sorted pair's place in its expert's
    bucket; fits, pos < cap; slot, its row of the (E·cap + 1) buffer, the
    last row the ghost row of the dropped pairs)."""
    n = tope.numel()
    local = tope.reshape(-1)
    order = torch.argsort(local, stable=True)
    l_s = local[order]
    # integer adds (no host sync, unlike ``bincount`` on the card)
    counts = torch.zeros(n_experts, dtype=l_s.dtype,
                         device=l_s.device).scatter_add_(
                             0, l_s, torch.ones_like(l_s))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(n, device=tope.device) - starts[l_s]
    fits = pos < cap
    slot = torch.where(fits, l_s * cap + pos,
                       torch.full_like(pos, n_experts * cap))
    return order, pos, fits, slot


def kept(tope, n_experts: int, cap: int):
    """(T, k) bool: which of each token's routed experts took it (False:
    dropped past the expert's capacity)."""
    order, _, fits, _ = dispatch(tope, n_experts, cap)
    out = torch.empty_like(fits)
    out[order] = fits
    return out.reshape(tope.shape)


def _dispatch_compute(router, w_gate, w_up, w_down, x, cfg: MoEConfig,
                      cap: int):
    """Route the tokens, bucket them into (E, cap, d), compute, combine.
    Returns (y (T, d) in x's type, aux fp32 scalar)."""
    t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    gates, topv, tope = route(router, x, cfg)
    topv = topv / torch.clamp(topv.sum(dim=-1, keepdim=True), min=1e-9)

    me = gates.mean(dim=0)
    ce = torch.nn.functional.one_hot(tope, e).float().sum(dim=1).mean(
        dim=0) / k
    aux = cfg.router_aux_weight * e * (me * ce).sum()

    order, _, fits, slot = dispatch(tope, e, cap)
    t_s = torch.arange(t, device=x.device).repeat_interleave(k)[order]
    xe = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=x.device)
    # only the ghost row takes several writes, and it is dropped
    xe[slot] = x[t_s]
    xe = xe[:-1].reshape(e, cap, d)

    h = torch.nn.functional.silu(torch.bmm(xe, w_gate)) \
        * torch.bmm(xe, w_up)
    ye = torch.bmm(h, w_down)

    y_flat = torch.cat([ye.reshape(e * cap, d),
                        torch.zeros((1, d), dtype=x.dtype, device=x.device)])
    w_s = topv.reshape(-1).to(x.dtype)[order]
    contrib = torch.where(fits[:, None], y_flat[slot] * w_s[:, None], 0)
    # each token's k contributions in the sorted order (its experts
    # ascending), summed from zero one add at a time in x's type
    per_tok = torch.empty_like(contrib)
    per_tok[order] = contrib
    per_tok = per_tok.reshape(t, k, d)
    rank = torch.argsort(tope, dim=-1)
    per_tok = torch.gather(per_tok, 1, rank[..., None].expand(t, k, d))
    y = per_tok[:, 0]
    for j in range(1, k):
        y = y + per_tok[:, j]
    return y, aux


def moe_forward(p, x, cfg: MoEConfig, mesh=None):
    """x: (T, d_model) -> ((T, d_model) in x's type, router aux loss fp32),
    the reference's branch for no mesh."""
    if mesh is not None:
        raise NotImplementedError(_EP)
    t = x.shape[0]
    y, aux = _dispatch_compute(p["router"], p["w_gate"], p["w_up"],
                               p["w_down"], x, cfg, capacity(t, cfg))
    if cfg.n_shared:
        y = y + (torch.nn.functional.silu(x @ p["shared_gate"])
                 * (x @ p["shared_up"])) @ p["shared_down"]
    return y, aux
