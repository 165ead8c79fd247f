"""Assigned input-shape registry (one set per architecture family) and the
per-(family, shape) logical-sharding rules.

A copy of the reference's ``configs/shapes.py``: the same cells, tables and
rules, so that a names tree resolves to the same specs in both packages.

Every (arch × shape) cell the dry-run compiles is defined here; the rules
are the primary §Perf hillclimbing lever (changing a rule re-lowers the
same model under a different collective schedule).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str          # train | prefill | decode | serve | retrieval
    seq_len: int = 0
    global_batch: int = 0
    extras: tuple = ()


LM_SHAPES = {
    "train_4k": ShapeCell("train_4k", "train", seq_len=4096, global_batch=256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", seq_len=32768,
                             global_batch=32),
    "decode_32k": ShapeCell("decode_32k", "decode", seq_len=32768,
                            global_batch=128),
    # decode against a 524k KV cache is linear per token (sub-quadratic);
    # run via the split-KV decode path with sequence-sharded cache
    "long_500k": ShapeCell("long_500k", "decode", seq_len=524288,
                           global_batch=1),
}

GNN_SHAPES = {
    "full_graph_sm": ShapeCell("full_graph_sm", "train",
                               extras=(("n_nodes", 2708), ("n_edges", 10556),
                                       ("d_feat", 1433), ("trip_factor", 4))),
    "minibatch_lg": ShapeCell("minibatch_lg", "train",
                              extras=(("n_nodes", 232965),
                                      ("n_edges", 114615892),
                                      ("batch_nodes", 1024),
                                      ("fanouts", (15, 10)),
                                      ("d_feat", 602), ("trip_factor", 2))),
    "ogb_products": ShapeCell("ogb_products", "train",
                              extras=(("n_nodes", 2449029),
                                      ("n_edges", 61859140),
                                      ("d_feat", 100), ("trip_factor", 1))),
    "molecule": ShapeCell("molecule", "train",
                          extras=(("n_nodes", 30), ("n_edges", 64),
                                  ("batch", 128), ("d_feat", 16),
                                  ("trip_factor", 4))),
}

RECSYS_SHAPES = {
    "train_batch": ShapeCell("train_batch", "train", global_batch=65536),
    "serve_p99": ShapeCell("serve_p99", "serve", global_batch=512),
    "serve_bulk": ShapeCell("serve_bulk", "serve", global_batch=262144),
    "retrieval_cand": ShapeCell("retrieval_cand", "retrieval", global_batch=1,
                                extras=(("n_candidates", 1_000_000),)),
}

# the paper's own architecture (first-stage ISN); additive to the 40 cells
ISN_SHAPES = {
    "serve_trace": ShapeCell("serve_trace", "serve", global_batch=4096),
}

FAMILY_SHAPES = {
    "lm": LM_SHAPES,
    "gnn": GNN_SHAPES,
    "recsys": RECSYS_SHAPES,
    "isn": ISN_SHAPES,
}


def extras_dict(cell: ShapeCell) -> dict:
    return dict(cell.extras)


# ---------------------------------------------------------------------------
# sharding rules per (family, shape-kind)
# ---------------------------------------------------------------------------

# Default LM-train layout: FSDP — batch over as many mesh axes as divide
# it (resolved per cell), weights/optimizer fully sharded and gathered per
# layer. §Perf iteration: TP+SP at this batch is 6.7× more collective-bound
# (344 GB vs 52 GB per device per step on yi-6b); FSDP leaves the cell
# compute-dominant. TP+SP remains available as a rules_override.
_LM_TRAIN = {
    "batch": ("pod", "data", "model"), "embed": None,
    "heads": ("data", "model"), "kv_heads": ("data", "model"), "qk": None,
    "ffn": ("data", "model"), "vocab": ("data", "model"),
    "experts": "model", "seq": None, "kv_seq": None, "stack": None,
}

# the paper-faithful-era TP+SP layout (kept for §Perf comparisons)
LM_TRAIN_TPSP = {
    "batch": ("pod", "data"), "embed": None, "heads": "model",
    "kv_heads": "model", "qk": None, "ffn": "model", "vocab": "model",
    "experts": "model", "seq": "model", "kv_seq": None, "stack": None,
}

# decode/prefill: weights stay resident (TP) — per-layer FSDP gathers would
# swamp a single-token step; the KV cache sequence shards over "model"
_LM_DECODE = dict(LM_TRAIN_TPSP, kv_seq="model", seq=None)

_GNN = {
    # nodes replicated (feature tables are ~1 GB at most: cheap vs the
    # all-gather storm of cross-shard edge gathers); edges + triplets shard
    # over the whole mesh; partitioned layout (triplets shard-local, one
    # node-aggregation psum per pass) is the §Perf default — 304× less
    # collective than the pjit baseline on ogb_products
    "batch": ("pod", "data"), "nodes": None,
    "edges": ("pod", "data", "model"), "stack": None, "embed": None,
    "ffn": None, "partition_gnn": True,
}

_RECSYS = {
    "batch": ("pod", "data"), "rows": "model", "ffn": "model",
    "heads": "model", "candidates": ("pod", "data", "model"), "stack": None,
    "embed": None,
    "vocab": "model", "seq": None, "kv_seq": None, "qk": None,
    "experts": "model",
}

_ISN = {
    "batch": ("pod", "data"), "docs": "model", "postings": "model",
    "blocks": "model", "vocab": None, "stack": None, "embed": None,
    "ffn": None,
}


def rules_for(family: str, shape: ShapeCell) -> dict:
    if family == "lm":
        if shape.kind == "decode":
            return dict(_LM_DECODE)
        if shape.kind == "prefill":
            return dict(LM_TRAIN_TPSP)
        return dict(_LM_TRAIN)
    if family == "gnn":
        return dict(_GNN)
    if family == "recsys":
        return dict(_RECSYS)
    if family == "isn":
        return dict(_ISN)
    raise ValueError(family)
