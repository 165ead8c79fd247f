"""Mixture-of-experts FFN with sort-based dispatch (granite-MoE, Moonlight).

A port of the reference's ``models/moe.py``: ``moe_forward`` with no mesh
in scope is its branch for no mesh (``moe.py:121-137``), which routes
every local token, buckets the routed (token, expert) pairs into
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

Under a mesh (``launch/mesh.mesh_context``), ``moe_forward`` takes the
reference's expert-parallel branch (``moe.py:139-179``) on each rank with
its choices (``mesh_plan``): the experts split over "model" when it is
larger than 1 and divides them, else the tokens over every axis; trailing
token axes dropped until T divides; the capacity from the local token
count, so a split mesh drops other tokens than no mesh, as the reference
does.  The reference's ``shard_map`` collectives are ``torch.distributed``
calls on the mesh's groups: the sum of y over "model", the mean of the
router loss over the token axes, and an all-gather of the token blocks
that gives every rank the whole (T, d) back.  At a (1, 1) mesh the branch
computes exactly what no mesh computes, forward and backward.  The
backward is JAX's transpose of the ``shard_map`` (``_MeshBranch``): each
rank differentiates its own token block, each expert's gradient is summed
over the ranks that used it in a fixed rank order, the router loss is
counted once, and the gather of the blocks passes back each rank's own
block.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.models import common

class MoEConfig(NamedTuple):
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


def moe_shapes(d_model: int, cfg: MoEConfig, stack=()) -> dict:
    """The reference's ``moe_params`` tree as ``Leaf`` shapes, fills and
    logical names: each leaf normal × 1/√(its first dimension) — with a
    leading ``stack`` of (L,), as the reference stacks layer leaves, that
    is L — the router × 0.02 and unsharded, the experts on "experts"."""
    e, f, fs = cfg.n_experts, cfg.d_ff_expert, cfg.d_ff_expert * cfg.n_shared
    tree = {
        "router": common.dense((d_model, e), (None, None), 0.02, stack),
        "w_gate": common.dense((e, d_model, f), ("experts", "embed", "ffn"),
                               stack=stack),
        "w_up": common.dense((e, d_model, f), ("experts", "embed", "ffn"),
                             stack=stack),
        "w_down": common.dense((e, f, d_model), ("experts", "ffn", "embed"),
                               stack=stack),
    }
    if cfg.n_shared:
        tree.update(
            shared_gate=common.dense((d_model, fs), ("embed", "ffn"),
                                     stack=stack),
            shared_up=common.dense((d_model, fs), ("embed", "ffn"),
                                   stack=stack),
            shared_down=common.dense((fs, d_model), ("ffn", "embed"),
                                     stack=stack))
    return tree


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


def dispatch(tope, n_experts: int, cap: int, e_off: int = 0,
             e_local: int | None = None):
    """The bucketing of the (token, expert) pairs onto the experts
    [e_off, e_off + e_local) (by default all ``n_experts``): (order, the
    pairs in local-expert order (stable), the other experts' pairs last, in
    a ghost bucket; pos, each sorted pair's place in its bucket; fits, a
    pair of a local expert at pos < cap; slot, its row of the (e_local·cap
    + 1) buffer, the last row the ghost row of the pairs that do not
    fit)."""
    e_local = n_experts if e_local is None else e_local
    n = tope.numel()
    local = tope.reshape(-1) - e_off
    local = torch.where((local >= 0) & (local < e_local), local,
                        torch.full_like(local, e_local))
    order = torch.argsort(local, stable=True)
    l_s = local[order]
    # integer adds (no host sync, unlike ``bincount`` on the card)
    counts = torch.zeros(e_local + 1, dtype=l_s.dtype,
                         device=l_s.device).scatter_add_(
                             0, l_s, torch.ones_like(l_s))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(n, device=tope.device) - starts[l_s]
    fits = (pos < cap) & (l_s < e_local)
    slot = torch.where(fits, l_s * cap + pos,
                       torch.full_like(pos, e_local * cap))
    return order, pos, fits, slot


def kept(tope, n_experts: int, cap: int):
    """(T, k) bool: which of each token's routed experts took it (False:
    dropped past the expert's capacity)."""
    order, _, fits, _ = dispatch(tope, n_experts, cap)
    out = torch.empty_like(fits)
    out[order] = fits
    return out.reshape(tope.shape)


def _dispatch_compute(router, w_gate, w_up, w_down, x, cfg: MoEConfig,
                      cap: int, e_off: int = 0):
    """Route the tokens, bucket the pairs of the experts [e_off, e_off +
    E_local) (``w_gate``'s first extent) into (E_local, cap, d), compute,
    combine.  Returns (y (T, d) in x's type, zero where the token's experts
    are elsewhere; aux fp32 scalar)."""
    t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    e_local = w_gate.shape[0]
    gates, topv, tope = route(router, x, cfg)
    topv = topv / torch.clamp(topv.sum(dim=-1, keepdim=True), min=1e-9)

    me = gates.mean(dim=0)
    ce = torch.nn.functional.one_hot(tope, e).float().sum(dim=1).mean(
        dim=0) / k
    aux = cfg.router_aux_weight * e * (me * ce).sum()

    order, _, fits, slot = dispatch(tope, e, cap, e_off, e_local)
    t_s = torch.arange(t, device=x.device).repeat_interleave(k)[order]
    xe = torch.zeros((e_local * cap + 1, d), dtype=x.dtype, device=x.device)
    # only the ghost row takes several writes, and it is dropped
    xe[slot] = x[t_s]
    xe = xe[:-1].reshape(e_local, cap, d)

    h = torch.nn.functional.silu(torch.bmm(xe, w_gate)) \
        * torch.bmm(xe, w_up)
    ye = torch.bmm(h, w_down)

    y_flat = torch.cat([ye.reshape(e_local * cap, d),
                        torch.zeros((1, d), dtype=x.dtype, device=x.device)])
    w_s = topv.reshape(-1).to(x.dtype)[order]
    contrib = torch.where(fits[:, None], y_flat[slot] * w_s[:, None], 0)
    # each token's k contributions in its experts' ascending order (another
    # rank's expert adds a zero), summed from zero one add at a time in x's
    # type
    per_tok = torch.empty_like(contrib)
    per_tok[order] = contrib
    per_tok = per_tok.reshape(t, k, d)
    rank = torch.argsort(tope, dim=-1)
    per_tok = torch.gather(per_tok, 1, rank[..., None].expand(t, k, d))
    y = per_tok[:, 0]
    for j in range(1, k):
        y = y + per_tok[:, j]
    return y, aux


class MeshPlan(NamedTuple):
    """How the mesh branch splits the work (the reference's
    ``moe.py:139-151``): expert-parallel over "model" or not, the token
    axes, the local token count, the experts a rank serves, the
    capacity from the local count."""
    ep: bool
    tok_axes: tuple
    t_local: int
    e_local: int
    cap: int


def mesh_plan(t: int, cfg: MoEConfig, sizes: dict) -> MeshPlan:
    """The split of ``t`` tokens on a mesh of ``sizes`` ({axis: size}):
    experts over "model" when it is larger than 1 and divides the experts,
    else tokens over every axis; trailing token axes dropped until T
    divides evenly."""
    e = cfg.n_experts
    model_ways = sizes.get("model", 1)
    ep = e % model_ways == 0 and model_ways > 1
    tok_axes = tuple(a for a in ("pod", "data") if a in sizes)
    if not ep and "model" in sizes:
        tok_axes = tok_axes + ("model",)
    while tok_axes and t % math.prod(sizes[a] for a in tok_axes) != 0:
        tok_axes = tok_axes[:-1]
    t_local = t // math.prod(sizes[a] for a in tok_axes)
    return MeshPlan(ep, tok_axes, t_local, e // model_ways if ep else e,
                    capacity(t_local, cfg))


def _replicated(w, mesh, spec):
    """A leaf as this rank uses it: a DTensor redistributed to ``spec`` (the
    region's in-spec) and its local shard; a plain tensor as it is."""
    if isinstance(w, DTensor):
        return w.redistribute(mesh, common.placements(spec, mesh)).to_local()
    return w


def _with_shared(y, p, x, cfg: MoEConfig):
    """y plus the shared (always-on) experts' SwiGLU of x, if any."""
    if not cfg.n_shared:
        return y
    return y + (torch.nn.functional.silu(x @ p["shared_gate"])
                * (x @ p["shared_up"])) @ p["shared_down"]


_SHARED = ("shared_gate", "shared_up", "shared_down")


class _MeshBranch(torch.autograd.Function):
    """One rank's part of the expert-parallel region (the reference's
    ``shard_map`` body, ``moe.py:160-169``, and the shared experts after
    it) on local tensors: x_local (its token block), the router and the
    shared leaves whole, the expert leaves of its experts.  The forward
    sums y over "model" when the experts are split and averages the router
    loss over the token axes.

    The backward recomputes the rank's block with autograd and returns the
    gradients of the region's inputs as JAX's transpose of the
    ``shard_map`` gives them: y's cotangent is the block's own (every rank
    holds the whole loss); each expert's gradient is summed over the token
    ranks that used it, the router's and the shared leaves' over every
    rank of the region, x's over "model" — all in a fixed rank order
    (``common.sum_axes_ordered``), no float atomics.  Terms that every
    "model" rank computes alike under expert parallelism (the router loss,
    the shared experts) take their cotangent on model rank 0 only, so the
    sums count them once; ranks of a token axis the plan dropped compute
    the same block and are summed over nowhere."""

    @staticmethod
    def forward(ctx, mesh, plan, cfg, e_off, x, router, wg, wu, wd,
                *shared):
        ctx.mesh, ctx.plan, ctx.cfg, ctx.e_off = mesh, plan, cfg, e_off
        ctx.save_for_backward(x, router, wg, wu, wd, *shared)
        # no graph inside (a checkpoint's recomputation of the forward must
        # save what the first pass saved: these inputs alone)
        with torch.no_grad():
            y, aux = _dispatch_compute(router, wg, wu, wd, x, cfg, plan.cap,
                                       e_off)
            if plan.ep:
                y = common.all_reduce_axes(y, mesh, "model")
            if plan.tok_axes:
                tok_ways = math.prod(common.mesh_sizes(mesh)[a]
                                     for a in plan.tok_axes)
                aux = common.all_reduce_axes(aux, mesh,
                                             plan.tok_axes) / tok_ways
            y = _with_shared(y, dict(zip(_SHARED, shared)), x, cfg)
        return y, aux

    @staticmethod
    def backward(ctx, ct_y, ct_aux):
        mesh, plan, cfg = ctx.mesh, ctx.plan, ctx.cfg
        saved = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        x, router, wg, wu, wd, *shared = saved
        sp = dict(zip(_SHARED, shared))
        sizes = common.mesh_sizes(mesh)
        if plan.tok_axes:
            ct_aux = ct_aux / math.prod(sizes[a] for a in plan.tok_axes)
        with torch.enable_grad():
            y, aux = _dispatch_compute(router, wg, wu, wd, x, cfg, plan.cap,
                                       ctx.e_off)
            if not plan.ep:
                outs = [_with_shared(y, sp, x, cfg), aux]
                cts = [ct_y, ct_aux]
            else:
                first = common.mesh_coords(mesh)["model"] == 0
                outs, cts = [y, aux], [ct_y, ct_aux if first
                                       else torch.zeros_like(ct_aux)]
                if cfg.n_shared:
                    outs.append(_with_shared(torch.zeros_like(y), sp, x,
                                             cfg))
                    cts.append(ct_y if first else torch.zeros_like(ct_y))
            grads = torch.autograd.grad(outs, saved, cts, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g
                 for t, g in zip(saved, grads)]
        gx, g_router, gwg, gwu, gwd, *g_shared = grads
        region = plan.tok_axes + (("model",) if plan.ep else ())
        if plan.ep:
            gx = common.sum_axes_ordered(gx, mesh, "model")
        g_router = common.sum_axes_ordered(g_router, mesh, region)
        g_shared = [common.sum_axes_ordered(g, mesh, region)
                    for g in g_shared]
        g_experts = [common.sum_axes_ordered(g, mesh, plan.tok_axes)
                     for g in (gwg, gwu, gwd)]
        return (None, None, None, None, gx, g_router, *g_experts,
                *g_shared)


def moe_forward(p, x, cfg: MoEConfig):
    """x: (T, d_model) -> ((T, d_model) in x's type, router aux loss fp32).

    With no mesh in scope, the reference's branch for no mesh.  Under a
    mesh (``launch/mesh.mesh_context``), its expert-parallel branch on each
    rank: this rank's token block (``mesh_plan``) through its experts —
    the stacked leaves' slice at ``e_off``, or a DTensor leaf's local shard
    — the outputs summed over "model" when the experts are split, the
    router loss averaged over the token axes, and the blocks gathered back.
    A whole x (a plain tensor, held by every rank) is cut into its block
    and the blocks gathered back, so every rank takes and returns the
    whole (T, d); a DTensor x is redistributed to the region's token
    layout and y (and the router loss, replicated) returned as DTensors in
    that layout, as the reference's ``with_sharding_constraint`` and
    ``shard_map`` out-specs place them.
    The branch is differentiable (``_MeshBranch``): each cut's backward
    gathers the blocks' gradients, each gather's passes back the rank's
    own block."""
    mesh = common.get_abstract_mesh_or_none()
    if mesh is None:
        y, aux = _dispatch_compute(p["router"], p["w_gate"], p["w_up"],
                                   p["w_down"], x, cfg,
                                   capacity(x.shape[0], cfg))
        return _with_shared(y, p, x, cfg), aux

    sizes = common.mesh_sizes(mesh)
    plan = mesh_plan(x.shape[0], cfg, sizes)
    coords = common.mesh_coords(mesh)
    xspec = common.P(plan.tok_axes or None, None)
    if isinstance(x, DTensor):
        x_local = x.redistribute(mesh, common.placements(xspec, mesh)
                                 ).to_local()
    else:
        x_local = common.block_of(x, mesh, plan.tok_axes)
    e_off = coords["model"] * plan.e_local if plan.ep else 0
    wspec = common.P("model", None, None) if plan.ep else common.P()
    w = []
    for key in ("w_gate", "w_up", "w_down"):
        leaf = p[key]
        if isinstance(leaf, DTensor):
            w.append(_replicated(leaf, mesh, wspec))
        elif plan.ep:
            w.append(common.block_of(leaf, mesh, "model"))
        else:
            w.append(leaf)
    router = _replicated(p["router"], mesh, common.P())
    shared = [_replicated(p[k], mesh, common.P())
              for k in _SHARED[:3 if cfg.n_shared else 0]]
    y, aux = _MeshBranch.apply(mesh, plan, cfg, e_off, x_local, router, *w,
                               *shared)
    if isinstance(x, DTensor):
        return (common.from_region(y, mesh, xspec),
                common.from_region(aux, mesh, common.P()))
    return common.gather_blocks(y, mesh, plan.tok_axes), aux
