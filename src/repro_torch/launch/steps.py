"""Step builders: one step function per (arch × shape) dry-run cell.

A port of the reference's ``launch/steps.py``.  For each cell this module
constructs

  * the step function (train step / prefill / decode step / serve /
    retrieval) over the port's model code,
  * ``meta`` tensors standing in for every argument (no allocation), and
  * ``common.NamedSharding``s resolved from the family × shape logical
    rules, with every rule adjustment the reference makes,

so ``launch/dryrun.py`` can run each cell's step as one rank of the
production mesh and read off its FLOPs, bytes, collectives and memory.

Where the reference differentiates with ``jax.value_and_grad``, a train
step takes ``train_loop.value_and_grad`` (``torch.autograd.grad`` of the
loss); where it donates the parameters and the optimizer state
(``donate_argnums`` (0, 1)), the step updates them in place
(``optimizer.apply(..., donate=True)``).  Gradient accumulation adds the
microbatches' gradients in microbatch order into zeros of each parameter's
type, as the reference's ``lax.scan`` carries them.  The serve and
retrieval functions are the port's, over kernels 6, 8 and 9; a CTR
retrieval cell takes the stable top-k (``isn.backend.stable_topk``) where
the reference takes ``lax.top_k``.

A step takes its arguments as DTensors of the cell's in-shardings (the dry
run) or as plain tensors that every rank holds whole (one device, the
tests); the model code runs under the mesh that the caller puts in scope
(``launch/mesh.mesh_context``), as the reference's cells run under its
``mesh_context``.  The GNN's partitioned loss and the ISN step bind the
cell's mesh themselves, as the reference's ``shard_map``s do.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Any, Callable

import torch

from repro_torch.configs import registry
from repro_torch.configs.shapes import (FAMILY_SHAPES, LM_TRAIN_TPSP,
                                        ShapeCell, extras_dict, rules_for)
from repro_torch.isn import shard as isn_shard
from repro_torch.isn.backend import stable_topk
from repro_torch.models import common, gnn, recsys
from repro_torch.models import transformer as tr
from repro_torch.train import optimizer, train_loop
from repro_torch.train.tree import leaves, map_tree


@dataclass
class Cell:
    arch_id: str
    shape_name: str
    family: str
    kind: str
    fn: Callable
    args: tuple
    in_shardings: Any
    out_shardings: Any
    donate_argnums: tuple
    meta: dict = field(default_factory=dict)


def _ns(mesh, spec):
    return common.NamedSharding(mesh, spec)


def _sds(shape, dtype):
    """An argument's stand-in: a ``meta`` tensor (the reference's
    ``ShapeDtypeStruct``)."""
    return torch.empty(shape, dtype=dtype, device="meta")


def _zero_rules(rules: dict) -> dict:
    """ZeRO-1: optimizer moments additionally shard over the data axis on
    dims the model rules leave unsharded (stack / embed are the big ones)."""
    z = dict(rules)
    z["stack"] = ("data",) if z.get("stack") is None else z["stack"]
    z["embed"] = ("data",) if z.get("embed") is None else z["embed"]
    return z


def _shard_tree(mesh, names_tree, rules, shapes=None):
    """names -> NamedShardings; with ``shapes`` (a congruent tree of
    tensors), specs are fitted per leaf so non-divisible dims fall back to
    replication."""
    if isinstance(names_tree, dict):
        return {k: _shard_tree(mesh, v, rules,
                               None if shapes is None else shapes[k])
                for k, v in names_tree.items()}
    spec = common.resolve_pspec(names_tree, rules, mesh)
    if shapes is not None:
        spec = common.fit_spec_to_shape(spec, tuple(shapes.shape), mesh)
    return _ns(mesh, spec)


def _batch_spec(mesh, rules, extra_dims=0):
    return _ns(mesh, common.resolve_pspec(("batch",) + (None,) * extra_dims,
                                          rules, mesh))


def _round_up(x, m):
    return ((x + m - 1) // m) * m


def _n_devices(mesh) -> int:
    return math.prod(common.mesh_sizes(mesh).values())


def _opt_shardings(mesh, names_tree, rules, params):
    zr = _zero_rules(rules)
    return optimizer.OptState(m=_shard_tree(mesh, names_tree, zr, params),
                              v=_shard_tree(mesh, names_tree, zr, params),
                              step=_ns(mesh, common.P()))


def _train_step(loss, ocfg, mb: int = 1):
    """The reference's train step over ``loss(params, *batch)``: the loss
    and its gradients (``mb`` microbatches accumulated in order along each
    batch array's first axis), then AdamW with the parameters and moments
    donated."""
    def train_step(params, opt, *batch):
        if mb == 1:
            value, grads = train_loop.value_and_grad(
                lambda p, b: loss(p, *b), params, batch)
        else:
            grads = map_tree(torch.zeros_like, params)
            value = 0.0
            for i in range(mb):
                part = tuple(x.narrow(0, i * (x.shape[0] // mb),
                                      x.shape[0] // mb) for x in batch)
                v, g = train_loop.value_and_grad(lambda p, b: loss(p, *b),
                                                 params, part)
                value = value + v
                grads = map_tree(torch.add, grads, g)
            value = value / mb
            grads = map_tree(lambda g: g / mb, grads)
        new_p, new_opt, metrics = optimizer.apply(params, grads, opt, ocfg,
                                                  donate=True)
        return new_p, new_opt, value, metrics
    return train_step


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------

def _lm_cell(arch_id, config, cell: ShapeCell, mesh, rules) -> Cell:
    # divisibility fallbacks: if a raw count doesn't divide the TP degree,
    # drop that logical axis from sharding
    sizes = common.mesh_sizes(mesh)
    model_ways = sizes.get("model", 1)
    if config.moe is not None and config.moe.n_experts % model_ways != 0:
        rules["experts"] = None
    if cell.kind in ("decode", "prefill"):
        rules["kv_heads"] = None       # cache kv-head counts (4/8) < TP=16
    params, names = tr.init(config, abstract=True)
    names_tree = common.names_tree_of(params, names)
    p_shard = _shard_tree(mesh, names_tree, rules, params)
    b, s = cell.global_batch, cell.seq_len
    repl = _ns(mesh, common.P())
    tok_shard = _ns(mesh, common.resolve_pspec(("batch", None), rules, mesh))
    meta = {
        "params": config.param_count(),
        "active_params": config.active_param_count(),
        "tokens_per_step": b * s if cell.kind == "train" else b,
    }

    if cell.kind == "train":
        # per-arch layout pick (FSDP default; tpsp where FSDP's vocab/EP
        # buffers exceed HBM)
        if getattr(config, "train_layout", "fsdp") == "tpsp":
            rules = dict(LM_TRAIN_TPSP)
        # FSDP batch axes: greedily take mesh axes while the global batch
        # stays divisible (multi-pod: 256 % 512 != 0 → ("pod", "data"))
        if rules.get("batch") == ("pod", "data", "model"):
            taken, ways = [], 1
            for ax in ("pod", "data", "model"):
                if ax not in sizes:
                    continue
                if b % (ways * sizes[ax]) != 0:
                    break
                taken.append(ax)
                ways *= sizes[ax]
            rules["batch"] = tuple(taken) or None
            if ("model" not in taken and "model" in sizes
                    and s % sizes["model"] == 0):
                # hybrid FSDP+SP: the sequence over "model"
                rules["seq"] = "model"
        tok_shard = _ns(mesh, common.resolve_pspec(("batch", None), rules,
                                                   mesh))
        opt = optimizer.abstract_init(params)
        opt_shard = _opt_shardings(mesh, names_tree, rules, params)
        step_rules = rules

        def loss(p, tokens, labels):
            return tr.loss_fn(p, config, tokens, labels, step_rules)

        train_step = _train_step(loss, optimizer.AdamWConfig(),
                                 getattr(config, "train_microbatches", 1))
        args = (params, opt, _sds((b, s), torch.int32),
                _sds((b, s), torch.int32))
        in_sh = (p_shard, opt_shard, tok_shard, tok_shard)
        out_sh = (p_shard, opt_shard, repl, {"grad_norm": repl, "lr": repl})
        return Cell(arch_id, cell.name, "lm", cell.kind, train_step, args,
                    in_sh, out_sh, donate_argnums=(0, 1), meta=meta)

    if cell.kind == "prefill":
        # cache is the big output: shard its sequence over model
        cache_rules = dict(rules, kv_seq="model")
        _, cache_names = tr.init_cache(config, b, s, abstract=True)
        cache_shard = {k: _ns(mesh, common.resolve_pspec(n, cache_rules,
                                                         mesh))
                       for k, n in cache_names.items()}
        pre_rules = rules

        def prefill_step(params, tokens):
            return tr.prefill(params, config, tokens, pre_rules)

        args = (params, _sds((b, s), torch.int32))
        out_sh = (_ns(mesh, common.resolve_pspec(("batch", "vocab"), rules,
                                                 mesh)), cache_shard)
        return Cell(arch_id, cell.name, "lm", cell.kind, prefill_step, args,
                    (p_shard, tok_shard), out_sh, donate_argnums=(),
                    meta=meta)

    # decode
    cache, cache_names = tr.init_cache(config, b, s, abstract=True)
    batch_shardable = b % _mesh_batch_ways(mesh, rules) == 0 and b > 1
    dec_rules = dict(rules)
    if not batch_shardable:
        dec_rules["batch"] = None
        # batch=1 leaves the data axis idle: shard the KV sequence over
        # both axes
        dec_rules["kv_seq"] = ("data", "model")
    if (config.attention != "mla"
            and config.n_kv_heads % model_ways == 0 and model_ways > 1):
        # kv-head sharding also engages the model axis for the cache
        dec_rules["kv_heads"] = "model"
        dec_rules["kv_seq"] = ("data",) if not batch_shardable else None
    cache_shard = {k: _ns(mesh, common.resolve_pspec(n, dec_rules, mesh))
                   for k, n in cache_names.items()}
    tok1 = _ns(mesh, common.resolve_pspec(("batch",), dec_rules, mesh))

    def decode(params, token, cache, kv_len):
        return tr.decode_step(params, config, token, cache, kv_len,
                              dec_rules)

    args = (params, _sds((b,), torch.int32), cache,
            _sds((b,), torch.int32))
    in_sh = (p_shard, tok1, cache_shard, tok1)
    out_sh = (_ns(mesh, common.resolve_pspec(("batch", "vocab"), dec_rules,
                                             mesh)), cache_shard)
    return Cell(arch_id, cell.name, "lm", cell.kind, decode, args, in_sh,
                out_sh, donate_argnums=(2,), meta=meta)


def _mesh_batch_ways(mesh, rules):
    ways = 1
    r = rules.get("batch")
    r = (r,) if isinstance(r, str) else (r or ())
    sizes = common.mesh_sizes(mesh)
    for ax in r:
        if ax in sizes:
            ways *= sizes[ax]
    return ways


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------

def _gnn_shapes(cell: ShapeCell, n_dev: int):
    ex = extras_dict(cell)
    if cell.name == "minibatch_lg":
        seeds = ex["batch_nodes"]
        f1, f2 = ex["fanouts"]
        e = seeds * f1 + seeds * f1 * f2
        n = seeds + seeds * f1 + seeds * f1 * f2
    elif cell.name == "molecule":
        n = ex["n_nodes"] * ex["batch"]
        e = ex["n_edges"] * ex["batch"]
    else:
        n, e = ex["n_nodes"], ex["n_edges"]
    t = e * ex["trip_factor"]
    pad = max(n_dev, 512)
    return (_round_up(n, pad), _round_up(e, pad), _round_up(t, pad),
            ex["d_feat"])


GNN_EDGE_KEYS = ("edge_src", "edge_dst", "trip_kj", "trip_ji", "edge_mask",
                 "trip_mask")


def partitioned_loss(mesh, config, flat_axes):
    """The reference's ``loss_sharded`` (``steps.py:303-311``): the
    partitioned DimeNet loss in a region over ``mesh`` with the parameters
    replicated in, the edge and triplet arrays split over ``flat_axes`` and
    the node arrays whole."""
    def loss(params, batch):
        p = map_tree(lambda x: common.to_region(x, mesh, common.P()), params)
        b = {k: common.to_region(v, mesh, common.P(flat_axes)
                                 if k in GNN_EDGE_KEYS else common.P())
             for k, v in batch.items()}
        with common.use_mesh(mesh):
            return gnn.loss_fn_partitioned(p, config, b, flat_axes)
    return loss


def _gnn_cell(arch_id, config, cell: ShapeCell, mesh, rules) -> Cell:
    n_dev = _n_devices(mesh)
    n, e, t, d_feat = _gnn_shapes(cell, n_dev)
    kw = {"d_feat": d_feat}
    if cell.name == "ogb_products":
        kw["dtype"] = "bfloat16"   # halves the 61.8M-edge message tensors
    config = dataclasses.replace(config, **kw)
    params, names = gnn.init(config, abstract=True)
    names_tree = common.names_tree_of(params, names)
    p_shard = _shard_tree(mesh, names_tree, rules, params)
    repl = _ns(mesh, common.P())
    flat = _ns(mesh, common.resolve_pspec(("edges",), rules, mesh))
    nshard = _ns(mesh, common.resolve_pspec(("nodes",), rules, mesh))
    nshard2 = _ns(mesh, common.resolve_pspec(("nodes", None), rules, mesh))

    f32, i32 = torch.float32, torch.int32
    batch = {
        "feat": _sds((n, d_feat), f32), "pos": _sds((n, 3), f32),
        "edge_src": _sds((e,), i32), "edge_dst": _sds((e,), i32),
        "trip_kj": _sds((t,), i32), "trip_ji": _sds((t,), i32),
        "edge_mask": _sds((e,), f32), "trip_mask": _sds((t,), f32),
        "node_mask": _sds((n,), f32), "target": _sds((n,), f32),
    }
    b_shard = {
        "feat": nshard2, "pos": nshard2, "edge_src": flat, "edge_dst": flat,
        "trip_kj": flat, "trip_ji": flat, "edge_mask": flat,
        "trip_mask": flat, "node_mask": nshard, "target": nshard,
    }
    opt = optimizer.abstract_init(params)
    opt_shard = _opt_shardings(mesh, names_tree, rules, params)
    ocfg = optimizer.AdamWConfig()

    if rules.get("partition_gnn"):
        # partitioned-graph layout: the edge and triplet arrays are
        # per-rank local slices; one sum over the ranks per pass
        flat_axes = tuple(a for a in ("pod", "data", "model")
                          if a in common.mesh_sizes(mesh))
        train_step = _train_step(partitioned_loss(mesh, config, flat_axes),
                                 ocfg)
    else:
        train_step = _train_step(lambda p, b: gnn.loss_fn(p, config, b),
                                 ocfg)

    meta = {"n_nodes": n, "n_edges": e, "n_triplets": t,
            "params": sum(int(math.prod(leaf.shape))
                          for leaf in leaves(params))}
    return Cell(arch_id, cell.name, "gnn", "train", train_step,
                (params, opt, batch), (p_shard, opt_shard, b_shard),
                (p_shard, opt_shard, repl, {"grad_norm": repl, "lr": repl}),
                donate_argnums=(0, 1), meta=meta)


# ---------------------------------------------------------------------------
# RecSys cells
# ---------------------------------------------------------------------------

def _recsys_batch(config, cell: ShapeCell, mesh, rules):
    b = cell.global_batch
    c = config
    f32, i32 = torch.float32, torch.int32
    if c.kind in ("deepfm", "xdeepfm"):
        batch = {"ids": _sds((b, c.n_sparse), i32), "label": _sds((b,), i32)}
    elif c.kind == "two_tower":
        batch = {"user_ids": _sds((b, c.n_user_feats), i32),
                 "user_mask": _sds((b, c.n_user_feats), f32),
                 "item_ids": _sds((b, c.n_item_feats), i32),
                 "item_mask": _sds((b, c.n_item_feats), f32),
                 "log_q": _sds((b,), f32)}
    else:  # bert4rec
        m, cands = 8, 2048
        batch = {"items": _sds((b, c.seq_len), i32),
                 "positions": _sds((b, m), i32),
                 "label_idx": _sds((b, m), i32),
                 "candidates": _sds((cands,), i32)}
    shard = {}
    for k, v in batch.items():
        if k == "candidates":
            shard[k] = _ns(mesh, common.P())
        else:
            shard[k] = _ns(mesh, common.resolve_pspec(
                ("batch",) + (None,) * (v.dim() - 1), rules, mesh))
    return batch, shard


def _recsys_cell(arch_id, config, cell: ShapeCell, mesh, rules) -> Cell:
    c = config
    params, names = recsys.init(c, abstract=True)
    names_tree = common.names_tree_of(params, names)
    p_shard = _shard_tree(mesh, names_tree, rules, params)
    repl = _ns(mesh, common.P())
    meta = {"params": sum(int(math.prod(leaf.shape))
                          for leaf in leaves(params)),
            "rows": c.total_rows}

    if cell.kind == "train":
        batch, b_shard = _recsys_batch(c, cell, mesh, rules)
        opt = optimizer.abstract_init(params)
        opt_shard = _opt_shardings(mesh, names_tree, rules, params)
        loss_fns = {"deepfm": recsys.ctr_loss, "xdeepfm": recsys.ctr_loss,
                    "two_tower": recsys.two_tower_loss,
                    "bert4rec": recsys.bert4rec_loss}
        lf = loss_fns[c.kind]
        train_step = _train_step(lambda p, b: lf(p, c, b),
                                 optimizer.AdamWConfig())
        return Cell(arch_id, cell.name, "recsys", "train", train_step,
                    (params, opt, batch), (p_shard, opt_shard, b_shard),
                    (p_shard, opt_shard, repl,
                     {"grad_norm": repl, "lr": repl}),
                    donate_argnums=(0, 1), meta=meta)

    f32, i32 = torch.float32, torch.int32
    if cell.kind == "serve":
        b = cell.global_batch
        bsh = _ns(mesh, common.resolve_pspec(("batch", None), rules, mesh))
        b1 = _ns(mesh, common.resolve_pspec(("batch",), rules, mesh))
        if c.kind in ("deepfm", "xdeepfm"):
            logits = (recsys.deepfm_logits if c.kind == "deepfm"
                      else recsys.xdeepfm_logits)

            def fn(p, ids):
                return logits(p, c, ids)

            args = (params, _sds((b, c.n_sparse), i32))
            return Cell(arch_id, cell.name, "recsys", "serve", fn, args,
                        (p_shard, bsh), b1, (), meta)
        if c.kind == "two_tower":
            cand = _sds((c.n_items, c.tower_mlp[-1]), f32)
            cand_sh = _ns(mesh, common.resolve_pspec(("candidates", None),
                                                     rules, mesh))

            def serve(params, user_ids, user_mask, cand_emb):
                u = recsys.tower_embed(params, c, "user_table", "user_mlp",
                                       user_ids, user_mask)
                return recsys.sharded_streaming_topk(u, cand_emb, 100)

            args = (params, _sds((b, c.n_user_feats), i32),
                    _sds((b, c.n_user_feats), f32), cand)
            return Cell(arch_id, cell.name, "recsys", "serve", serve, args,
                        (p_shard, bsh, bsh, cand_sh), (bsh, bsh), (), meta)

        # bert4rec serve: next-item scores against the full item corpus
        def serve_b4r(params, items):
            h = recsys.bert4rec_hidden(params, c, items)[:, -1]   # (B, D)
            return recsys.sharded_streaming_topk(h, params["item_embed"],
                                                 100)

        args = (params, _sds((b, c.seq_len), i32))
        return Cell(arch_id, cell.name, "recsys", "serve", serve_b4r, args,
                    (p_shard, bsh), (bsh, bsh), (), meta)

    # retrieval_cand
    n_cand = _round_up(extras_dict(cell)["n_candidates"],
                       max(_n_devices(mesh), 512))
    if c.kind == "two_tower":
        cand_sh = _ns(mesh, common.resolve_pspec(("candidates", None), rules,
                                                 mesh))

        def retrieve(params, user_ids, user_mask, cand_emb, budget):
            u = recsys.tower_embed(params, c, "user_table", "user_mlp",
                                   user_ids, user_mask)
            return recsys.anytime_retrieval(u, cand_emb, budget, 1000)

        args = (params, _sds((1, c.n_user_feats), i32),
                _sds((1, c.n_user_feats), f32),
                _sds((n_cand, c.tower_mlp[-1]), f32), _sds((), i32))
        return Cell(arch_id, cell.name, "recsys", "retrieval", retrieve, args,
                    (p_shard, repl, repl, cand_sh, repl), (repl, repl), (),
                    meta)
    if c.kind in ("deepfm", "xdeepfm"):
        fn0 = (recsys.deepfm_logits if c.kind == "deepfm"
               else recsys.xdeepfm_logits)
        csh = _ns(mesh, common.resolve_pspec(("candidates", None), rules,
                                             mesh))

        def retrieve_ctr(params, ids):
            return stable_topk(fn0(params, c, ids), 1000)

        args = (params, _sds((n_cand, c.n_sparse), i32))
        return Cell(arch_id, cell.name, "recsys", "retrieval", retrieve_ctr,
                    args, (p_shard, csh), (repl, repl), (), meta)

    # bert4rec retrieval: one user history scored against all items
    def retrieve_b4r(params, items):
        h = recsys.bert4rec_hidden(params, c, items)[:, -1]
        v, i = recsys.sharded_streaming_topk(h, params["item_embed"], 1000)
        return v[0], i[0]

    args = (params, _sds((1, c.seq_len), i32))
    return Cell(arch_id, cell.name, "recsys", "retrieval", retrieve_b4r, args,
                (p_shard, repl), (repl, repl), (), meta)


# ---------------------------------------------------------------------------
# ISN (the paper's architecture)
# ---------------------------------------------------------------------------

def _isn_cell(arch_id, config, cell: ShapeCell, mesh, rules) -> Cell:
    return isn_shard.build_serve_cell(arch_id, config, cell, mesh, rules,
                                      Cell)


# ---------------------------------------------------------------------------
# entry
# ---------------------------------------------------------------------------

def build_cell(arch_id: str, shape_name: str, mesh,
               rules_override: dict | None = None,
               config_override=None) -> Cell:
    """The cell of (``arch_id``, ``shape_name``) on ``mesh`` (a
    ``DeviceMesh``, or a ``common.AbstractMesh`` for the shapes and
    shardings alone)."""
    config, family = registry.get_arch(arch_id)
    if config_override is not None:
        config = config_override
    cell = FAMILY_SHAPES[family][shape_name]
    rules = rules_for(family, cell)
    if rules_override:
        rules.update(rules_override)
    if family == "lm":
        return _lm_cell(arch_id, config, cell, mesh, rules)
    if family == "gnn":
        return _gnn_cell(arch_id, config, cell, mesh, rules)
    if family == "recsys":
        return _recsys_cell(arch_id, config, cell, mesh, rules)
    if family == "isn":
        return _isn_cell(arch_id, config, cell, mesh, rules)
    raise ValueError(family)
