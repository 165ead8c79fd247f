"""DimeNet (directional message passing, arXiv:2003.03123) and the neighbor
sampler of the ``minibatch_lg`` shape.

A port of the reference's ``models/gnn.py`` with the same configuration
(``DimeNetConfig``), parameter tree (``blocks`` leaves keep their leading
(n_blocks,) axis) and numerics.  Message passing scatters over explicit
edge and triplet index arrays: the reference's ``jax.ops.segment_sum`` is
``common.segment_sum`` (a stable sort of the segment ids, then each
segment summed in row order: the reference's order, the same bits on every
run, no float atomics; the reference computes it outside any Pallas
kernel, and so does the port).  The einsum ``th,tb,hbo->to`` of the
interaction block may contract in another order than XLA's.

The samplers draw from ``repro_torch.core.prng`` (JAX's ``threefry2x32``
bit for bit, on the host), so ``neighbor_sample`` and ``build_triplets``
given the same ``PRNGKey`` sample the reference's edges and triplets
exactly; the index arithmetic runs on the device of the graph's arrays.
Edge and triplet ids come back as int64, masks as float32.

``loss_fn_partitioned`` is the partitioned-graph loss on one rank of the
mesh in scope: edge-local arrays, one differentiable sum of the node
aggregation over the named axes, and the gradients of the reference's
``shard_map``ped loss.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import prng
from repro_torch.isn.backend import resolve_device
from repro_torch.models import common
from repro_torch.models.common import (dense, draw, leaf_names, matmul,
                                      mlp, mlp_shapes, promoted,
                                      segment_sum)


@dataclass(frozen=True)
class DimeNetConfig:
    name: str = "dimenet"
    n_blocks: int = 6
    d_hidden: int = 128
    n_bilinear: int = 8
    n_spherical: int = 7
    n_radial: int = 6
    d_feat: int = 16            # input node-feature dim
    cutoff: float = 5.0
    d_out: int = 1
    dtype: str = "float32"
    cost_exact: bool = False

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


# ---------------------------------------------------------------------------
# basis functions
# ---------------------------------------------------------------------------

def bessel_rbf(d, n_radial: int, cutoff: float):
    """sin(nπ d/c) / d radial Bessel basis. d: (E,) -> (E, n_radial)."""
    d = torch.clamp(d, min=1e-6)
    n = torch.arange(1, n_radial + 1, dtype=torch.float32, device=d.device)
    x = d[:, None] / cutoff
    # the reference's float32 sqrt of the float32 2/c
    coef = float(np.sqrt(np.float32(2.0 / cutoff)))
    return coef * torch.sin(n * math.pi * x) / d[:, None]


def angular_sbf(d_kj, angle, n_spherical: int, n_radial: int, cutoff: float):
    """Simplified spherical basis: radial Bessel ⊗ cos(l·α).
    -> (T, n_spherical * n_radial)."""
    rad = bessel_rbf(d_kj, n_radial, cutoff)                  # (T, R)
    l = torch.arange(n_spherical, dtype=torch.float32, device=d_kj.device)
    ang = torch.cos(l[None, :] * angle[:, None])              # (T, L)
    return (rad[:, None, :] * ang[:, :, None]).reshape(
        d_kj.shape[0], n_spherical * n_radial)


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def param_shapes(c: DimeNetConfig) -> dict:
    """The tree of ``init(c)`` as ``Leaf`` shapes, fills and logical names,
    in the reference's layout (every name unsharded; the ``blocks`` leaves
    stacked)."""
    h, sb, n = c.d_hidden, c.n_spherical * c.n_radial, (c.n_blocks,)
    return {
        "feat_proj": dense((c.d_feat, h), (None, None)),
        "rbf_proj": dense((c.n_radial, h), (None, None)),
        "embed_mlp": mlp_shapes((3 * h, h, h)),
        "blocks": {
            "w_msg": dense((h, h), (None, None), stack=n),
            "rbf_gate": dense((c.n_radial, h), (None, None), stack=n),
            "sbf_proj": dense((sb, c.n_bilinear), (None, None), stack=n),
            "bilinear": dense((h, c.n_bilinear, h), (None, None, None),
                              1.0 / math.sqrt(h * c.n_bilinear), stack=n),
            "update": mlp_shapes((h, h, h), stack=n),
        },
        "out_mlp": mlp_shapes((h, h, c.d_out)),
    }


def param_names(c: DimeNetConfig) -> dict:
    """The logical names of ``init(c)``'s leaves, congruent with its tree
    (the reference's ``names_tree_of(*init(c, abstract=True))``)."""
    return leaf_names(param_shapes(c))


def init(c: DimeNetConfig, seed: int = 0, device=None,
         abstract: bool = False):
    """Parameters of ``c`` drawn from ``torch.Generator(seed)`` on
    ``device`` (the card unless the caller names the CPU), at the
    reference's scales: each dense leaf 1/√(its first dimension) — n_blocks
    for the stacked ``blocks`` leaves — the bilinear tensor 1/√(h ·
    n_bilinear), biases zeros.  The draws differ from JAX's.  With
    ``abstract``, (the tree as ``meta`` tensors, {"a/b": logical names}),
    as the reference's ``init(c, abstract=True)``: nothing is drawn."""
    if abstract:
        shapes = param_shapes(c)
        return (common.abstract(shapes, c.torch_dtype),
                common.flat_names(shapes))
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return draw(param_shapes(c), gen, c.torch_dtype, dev)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _node_acc(params, c: DimeNetConfig, feat, pos, edge_src, edge_dst,
              trip_kj, trip_ji, edge_mask, trip_mask):
    """The message passing up to the node aggregation: (N, H) sums of the
    final edge messages by destination node."""
    n, e = feat.shape[0], edge_src.shape[0]
    edge_src, edge_dst = edge_src.long(), edge_dst.long()
    trip_kj, trip_ji = trip_kj.long(), trip_ji.long()

    vec = pos[edge_src] - pos[edge_dst]                     # (E, 3)
    dist = torch.sqrt((vec * vec).sum(dim=-1) + 1e-12)
    rbf = bessel_rbf(dist, c.n_radial, c.cutoff) * edge_mask[:, None]

    # triplet geometry: angle between edge kj and ji at node j
    v1 = vec[trip_kj]
    v2 = vec[trip_ji]
    cosang = (v1 * v2).sum(dim=-1) / (
        torch.linalg.norm(v1, dim=-1) * torch.linalg.norm(v2, dim=-1) + 1e-9)
    angle = torch.arccos(torch.clamp(cosang, -1.0, 1.0))
    sbf = angular_sbf(dist[trip_kj], angle, c.n_spherical, c.n_radial,
                      c.cutoff) * trip_mask[:, None]

    # every product in the promoted type of its operands, as JAX's: bf16
    # parameters on an fp32 batch compute in fp32
    x = matmul(feat, params["feat_proj"])                   # (N, H)
    m = mlp(params["embed_mlp"],
            torch.cat([x[edge_src], x[edge_dst],
                       matmul(rbf, params["rbf_proj"])], dim=-1), F.silu)
    m = m * edge_mask[:, None]

    blocks = params["blocks"]
    for i in range(c.n_blocks):
        bp = {k: (w[i] if isinstance(w, torch.Tensor)
                  else {kk: ww[i] for kk, ww in w.items()})
              for k, w in blocks.items()}
        t = matmul(m, bp["w_msg"])[trip_kj]                 # (T, H)
        sp = matmul(sbf, bp["sbf_proj"])                    # (T, B)
        t2 = torch.einsum("th,tb,hbo->to",
                          *promoted(t, sp, bp["bilinear"]))
        agg = segment_sum(t2 * trip_mask[:, None], trip_ji, e)
        gate = matmul(rbf, bp["rbf_gate"])
        m_new = m + mlp(bp["update"], (m + agg) * gate, F.silu)
        m = m_new * edge_mask[:, None]

    return segment_sum(m, edge_dst, n)


_EDGE_KEYS = ("feat", "pos", "edge_src", "edge_dst", "trip_kj", "trip_ji",
              "edge_mask", "trip_mask")


def forward(params, c: DimeNetConfig, feat, pos, edge_src, edge_dst,
            trip_kj, trip_ji, edge_mask, trip_mask, node_mask):
    """DimeNet forward.

    feat: (N, F) node features; pos: (N, 3); edge_src/dst: (E,) ids;
    trip_kj/ji: (T,) indices into edges forming (k→j, j→i) pairs;
    masks: 1.0 valid / 0.0 padding. Returns per-node outputs (N, d_out).
    """
    node_acc = _node_acc(params, c, feat, pos, edge_src, edge_dst, trip_kj,
                         trip_ji, edge_mask, trip_mask)
    out = mlp(params["out_mlp"], node_acc, F.silu)
    return out * node_mask[:, None]


def _mse(out, batch):
    err = (out[:, 0] - batch["target"]) * batch["node_mask"]
    return (err * err).sum() / torch.clamp(batch["node_mask"].sum(), min=1.0)


def loss_fn(params, c: DimeNetConfig, batch):
    out = forward(params, c, *(batch[k] for k in _EDGE_KEYS),
                  batch["node_mask"])
    return _mse(out, batch)


def loss_fn_partitioned(params, c: DimeNetConfig, batch, psum_axes):
    """The partitioned-graph loss of one rank: the reference's
    ``shard_map`` of its ``loss_fn_partitioned`` over the mesh in scope,
    with ``params`` replicated in and the loss replicated out (as
    ``launch/steps.py:298-313`` builds it).

    ``batch``: feat / pos / node_mask / target whole (N, ...) on every
    rank; the edge and triplet arrays this rank's slice, with *global*
    node ids and *local* edge indices (triplets sampled inside the
    partition).  The one collective of the forward is the sum of the node
    aggregation over ``psum_axes``.

    Its gradients are JAX's ``value_and_grad`` of the ``shard_map``ped
    loss on every rank: the loss's cotangent enters each rank divided by
    the ranks of ``psum_axes`` (the transpose of a replicated out-spec),
    the node aggregation's sum transposes to a sum, and each parameter's
    gradient is summed over the ranks (the transpose of a replicated
    in-spec), so a replicated parameter's gradient is the one-device
    gradient, not that times the rank count."""
    mesh = common.get_abstract_mesh_or_none()
    params = common.replicate_in(params, mesh, psum_axes)
    node_acc = _node_acc(params, c, *(batch[k] for k in _EDGE_KEYS))
    node_acc = common.psum(node_acc, mesh, psum_axes)       # the collective
    out = mlp(params["out_mlp"], node_acc, F.silu)
    return common.replicate_out(_mse(out, batch), mesh, psum_axes)


# ---------------------------------------------------------------------------
# neighbor sampler (minibatch_lg)
# ---------------------------------------------------------------------------

def _draw(key, shape, minval: int, maxval: int, device) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` on the host, as an
    int64 tensor on ``device``."""
    bits = prng.randint(key, shape, minval, maxval)
    return torch.from_numpy(bits.astype(np.int64)).to(device)


def neighbor_sample(neighbors: torch.Tensor, degrees: torch.Tensor,
                    seeds: torch.Tensor, fanouts: tuple, rng) -> dict:
    """Uniform fanout sampling over a padded adjacency (GraphSAGE-style),
    with replacement.

    neighbors: (N, max_deg) padded neighbor ids; degrees: (N,); seeds:
    (S,); rng: a ``prng.PRNGKey``.  Returns flat edge lists (dst, src) per
    hop, concatenated, with masks.
    """
    frontier = seeds.long()
    dev = frontier.device
    f_mask = torch.ones(frontier.shape, dtype=torch.float32, device=dev)
    edges_src, edges_dst, masks = [], [], []
    for fanout in fanouts:
        rng, sub = prng.split(rng)
        deg_f = degrees[frontier].long()
        draw_ = _draw(sub, (frontier.shape[0], fanout), 0, 1 << 30, dev)
        idx = draw_ % torch.clamp(deg_f, min=1)[:, None]
        src = neighbors[frontier[:, None], idx].long()
        dst = frontier[:, None].expand(src.shape)
        m = (f_mask * (deg_f > 0))[:, None].expand(src.shape).float()
        edges_src.append(src.reshape(-1))
        edges_dst.append(dst.reshape(-1))
        masks.append(m.reshape(-1))
        frontier = src.reshape(-1)
        f_mask = m.reshape(-1)
    return {"edge_src": torch.cat(edges_src),
            "edge_dst": torch.cat(edges_dst),
            "edge_mask": torch.cat(masks)}


def build_triplets(edge_src, edge_dst, budget: int, rng):
    """Sample up to ``budget`` triplets (k→j, j→i): pairs of edges sharing
    j, uniformly over ji edges, kj by binary search into the edges sorted
    (stably) by destination.  Returns (trip_kj, trip_ji, trip_mask)."""
    edge_src, edge_dst = edge_src.long(), edge_dst.long()
    dev = edge_src.device
    e = edge_src.shape[0]
    sorted_dst, order = torch.sort(edge_dst, stable=True)
    rng, s1 = prng.split(rng)
    ji = _draw(s1, (budget,), 0, e, dev)
    j = edge_src[ji]
    lo = torch.searchsorted(sorted_dst, j, side="left")
    hi = torch.searchsorted(sorted_dst, j, side="right")
    rng, s2 = prng.split(rng)
    off = _draw(s2, (budget,), 0, 1 << 30, dev)
    span = torch.clamp(hi - lo, min=1)
    kj = order[torch.clamp(lo + off % span, max=e - 1)]
    valid = (hi > lo) & (kj != ji)
    return kj, ji, valid.float()
