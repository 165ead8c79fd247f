"""RecSys architectures: DeepFM, xDeepFM (CIN), two-tower retrieval,
BERT4Rec.

A port of the reference's ``models/recsys.py`` with the same configuration
(``RecsysConfig``), the same parameter trees (``init``; ``blocks`` leaves
keep their leading (n_blocks,) axis) and the same numerics:

* the CTR heads ``deepfm_logits``, ``xdeepfm_logits`` and ``ctr_loss``
  over ``embedding.lookup`` of per-field offset ids;
* the two-tower family: ``tower_embed`` (a mean EmbeddingBag, a ReLU MLP,
  an L2 normalisation), ``two_tower_loss`` (in-batch sampled softmax with
  logQ correction), ``retrieval_scores``, ``streaming_topk`` and
  ``anytime_retrieval``.  The reference's ``streaming_topk`` scans
  candidate tiles with a running top-k merge; kernel 6
  (``kernels.dense_topk.ops.dense_topk_tiles``) is that merge moved into a
  kernel, so both top-k functions launch it for CUDA tensors and run its
  plain version for CPU tensors: score descending, ties to the lower id;
* BERT4Rec: ``bert4rec_hidden`` attends through
  ``models.attention.chunked_attention`` (non-causal: kernel 8 on the
  card, and its backward kernel when a gradient is needed),
  ``bert4rec_logits`` and ``bert4rec_loss`` (sampled softmax).

``TwoTower`` holds a two-tower model's tables and towers as a module on an
explicit device; the dense Stage-1 modality embeds through it
(``repro_torch.dense.embeddings``).

``sharded_streaming_topk`` is the reference's distributed top-k on one
rank of the mesh in scope (``launch/mesh.mesh_context``): a local top-k
through kernel 6, then a k-sized all-gather over "model" and a stable
merge.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch import kernels
from repro_torch.isn.backend import resolve_device
from repro_torch.kernels.dense_topk import ops as dense_ops
from repro_torch.models import common, embedding
from repro_torch.models.attention import chunked_attention
from repro_torch.models.common import dense, draw, mlp, mlp_shapes, ones, zeros

TABLE_DIM = 256     # width of both two-tower tables (fixed by the reference)
SIDES = ("user", "item")


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RecsysConfig:
    name: str
    kind: str                      # deepfm | xdeepfm | two_tower | bert4rec
    n_sparse: int = 39
    embed_dim: int = 10
    rows_per_field: int = 1_000_000
    mlp: tuple = (400, 400, 400)
    cin_layers: tuple = ()
    # two-tower
    tower_mlp: tuple = (1024, 512, 256)
    n_users: int = 8_000_000
    n_items: int = 2_000_000
    n_user_feats: int = 16
    n_item_feats: int = 8
    # bert4rec
    seq_len: int = 200
    n_blocks: int = 2
    n_heads: int = 2
    dtype: str = "float32"
    cost_exact: bool = False

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    @property
    def total_rows(self) -> int:
        if self.kind == "two_tower":
            return self.n_users + self.n_items
        if self.kind == "bert4rec":
            return self.n_items
        return self.n_sparse * self.rows_per_field

    @property
    def padded_items(self) -> int:
        """BERT4Rec's item rows: the items, the mask token and one spare,
        rounded up to a multiple of 256."""
        return ((self.n_items + 2 + 255) // 256) * 256

    def param_count(self) -> int:
        """Parameters of ``init(self)``, counted from the shapes alone."""
        return sum(math.prod(leaf.shape)
                   for leaf in common.shape_leaves(param_shapes(self)))


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def param_shapes(c: RecsysConfig) -> dict:
    """The tree of ``init(c)`` as ``Leaf`` shapes, fills and logical names,
    in the reference's layout: table rows on "rows", BERT4Rec's attention
    and FFN widths on "heads" and "ffn", the rest unsharded."""
    d = c.embed_dim
    if c.kind in ("deepfm", "xdeepfm"):
        rows = c.n_sparse * c.rows_per_field
        tree = {"table": dense((rows, d), ("rows", None), 0.01),
                "linear": dense((rows, 1), ("rows", None), 0.01),
                "mlp": mlp_shapes((c.n_sparse * d,) + tuple(c.mlp) + (1,))}
        if c.kind == "xdeepfm":
            cin, hk = {}, c.n_sparse
            for i, h_next in enumerate(c.cin_layers):
                cin[f"w{i}"] = dense((hk * c.n_sparse, h_next), (None, None),
                                     0.05)
                hk = h_next
            tree["cin"] = cin
            tree["cin_out"] = dense((sum(c.cin_layers), 1), (None, None))
        return tree
    if c.kind == "two_tower":
        return {"user_table": dense((c.n_users, TABLE_DIM), ("rows", None),
                                    0.01),
                "item_table": dense((c.n_items, TABLE_DIM), ("rows", None),
                                    0.01),
                "user_mlp": mlp_shapes((TABLE_DIM,) + tuple(c.tower_mlp)),
                "item_mlp": mlp_shapes((TABLE_DIM,) + tuple(c.tower_mlp))}
    if c.kind == "bert4rec":
        n = (c.n_blocks,)
        blocks = {k: dense((d, d), (None, "heads"), stack=n)
                  for k in ("wq", "wk", "wv")}
        blocks.update(
            wo=dense((d, d), ("heads", None), stack=n),
            w1=dense((d, 4 * d), (None, "ffn"), stack=n),
            b1=zeros((4 * d,), ("ffn",), stack=n),
            w2=dense((4 * d, d), ("ffn", None), stack=n),
            b2=zeros((d,), (None,), stack=n),
            ln1=ones((d,), (None,), stack=n), ln2=ones((d,), (None,), stack=n))
        return {"item_embed": dense((c.padded_items, d), ("rows", None), 0.02),
                "pos_embed": dense((c.seq_len, d), (None, None), 0.02),
                "blocks": blocks,
                "final_ln": ones((d,), (None,))}
    raise ValueError(c.kind)


def param_names(c: RecsysConfig) -> dict:
    """The logical names of ``init(c)``'s leaves, congruent with its tree
    (the reference's ``names_tree_of(*init(c, abstract=True))``)."""
    return common.leaf_names(param_shapes(c))


def init(c: RecsysConfig, seed: int = 0, device=None,
         abstract: bool = False):
    """Parameters of ``c`` drawn from ``torch.Generator(seed)`` on
    ``device`` (the card unless the caller names the CPU).  Shapes, scales
    and layout are the reference's: tables N(0, 0.01²), the CIN 0.05,
    ``item_embed`` and ``pos_embed`` 0.02, every other dense leaf 1/√(its
    first dimension) (for the stacked ``blocks`` leaves that is n_blocks),
    biases zeros, norms ones.  The draws differ from JAX's.  With
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
# CTR heads
# ---------------------------------------------------------------------------

def _field_embed(params, c: RecsysConfig, ids):
    """ids (B, n_sparse) with per-field offsets already applied -> (B, F,
    D)."""
    return embedding.lookup(params["table"], ids)


def deepfm_logits(params, c: RecsysConfig, ids):
    e = _field_embed(params, c, ids)                        # (B, F, D)
    lin = embedding.lookup(params["linear"], ids)[..., 0].sum(dim=1)
    s = e.sum(dim=1)
    fm = 0.5 * (s * s - (e * e).sum(dim=1)).sum(dim=-1)
    deep = mlp(params["mlp"], e.reshape(e.shape[0], -1))[:, 0]
    return lin + fm + deep


def xdeepfm_logits(params, c: RecsysConfig, ids):
    e = _field_embed(params, c, ids)                        # (B, m, D)
    x0, xk = e, e
    pools = []
    for i in range(len(c.cin_layers)):
        z = torch.einsum("bhd,bmd->bhmd", xk, x0)
        b, hk, m, d = z.shape
        xk = torch.einsum("bnd,nh->bhd", z.reshape(b, hk * m, d),
                          params["cin"][f"w{i}"])
        pools.append(xk.sum(dim=-1))                        # (B, h)
    cin_term = (torch.cat(pools, dim=-1) @ params["cin_out"])[:, 0]
    lin = embedding.lookup(params["linear"], ids)[..., 0].sum(dim=1)
    deep = mlp(params["mlp"], e.reshape(e.shape[0], -1))[:, 0]
    return lin + cin_term + deep


def ctr_loss(params, c: RecsysConfig, batch):
    """Mean logistic loss of the head's logits against ``batch["label"]``."""
    logit_fn = deepfm_logits if c.kind == "deepfm" else xdeepfm_logits
    logits = logit_fn(params, c, batch["ids"])
    y = batch["label"].float()
    return (torch.clamp(logits, min=0) - logits * y
            + torch.log1p(torch.exp(-logits.abs()))).mean()


# ---------------------------------------------------------------------------
# two-tower retrieval
# ---------------------------------------------------------------------------

def _tower(table, mlp_params, ids, mask):
    e = embedding.embedding_bag(table, ids, mask, mode="mean")
    z = mlp(mlp_params, e)
    return z / torch.clamp(torch.linalg.norm(z, dim=-1, keepdim=True),
                           min=1e-6)


def tower_embed(params, c: RecsysConfig, table_key: str, mlp_key: str, ids,
                mask):
    """(B, d) L2-normalised tower outputs of padded id bags (B, L)."""
    return _tower(params[table_key], params[mlp_key], ids, mask)


def two_tower_loss(params, c: RecsysConfig, batch, temp: float = 20.0):
    """In-batch sampled softmax with logQ correction (Yi et al. RecSys'19)."""
    u = tower_embed(params, c, "user_table", "user_mlp",
                    batch["user_ids"], batch["user_mask"])
    i = tower_embed(params, c, "item_table", "item_mlp",
                    batch["item_ids"], batch["item_mask"])
    logits = (u @ i.T) * temp - batch["log_q"][None, :]
    labels = torch.arange(u.shape[0], device=u.device)
    return common.cross_entropy(logits[:, None, :], labels[:, None],
                                u.shape[0])


def retrieval_scores(params, c: RecsysConfig, query_emb, cand_emb):
    """Scores of one query against the candidate corpus (cand_emb: the
    item tower's outputs, (n_cand, d))."""
    return cand_emb @ query_emb[0]


def _fill(vals, ids, k: int, fill_ids):
    """(vals, ids) of width k: the given columns, then -inf scores with the
    ids of ``fill_ids`` (a (k - width,) tensor)."""
    short = k - vals.shape[1]
    if short <= 0:
        return vals, ids
    q = vals.shape[0]
    pad_v = torch.full((q, short), -torch.inf, dtype=vals.dtype,
                       device=vals.device)
    return (torch.cat([vals, pad_v], dim=1),
            torch.cat([ids, fill_ids.expand(q, short)], dim=1))


def streaming_topk(q_emb, cand_emb, k: int, tile: int = 16384):
    """Top-k of ``q_emb @ cand_embᵀ``: (vals (B, k), ids (B, k) int64),
    score descending, ties to the lower id — kernel 6 for CUDA tensors,
    its plain version for CPU tensors.  The reference scans ``tile``-row
    tiles with a running merge; the result does not depend on ``tile``,
    which is kept for the signature's sake.  For k > n the n real entries
    come first, then (-inf, id 0) fills, as the reference's initial running
    list leaves them.  On the card k is at most the kernel's
    ``dense_ops.MAX_K``."""
    n = cand_emb.shape[0]
    vals, ids = dense_ops.dense_topk_tiles(q_emb.contiguous(),
                                           cand_emb.contiguous(), min(k, n))
    return _fill(vals, ids, k, torch.zeros((), dtype=ids.dtype,
                                           device=ids.device))


def sharded_streaming_topk(q_emb, cand_emb, k: int, tile: int = 8192):
    """Distributed retrieval top-k on this rank of the mesh in scope: each
    "model" rank streams its candidate rows through ``streaming_topk``
    (kernel 6 on the card), offsets its ids by its first row, all-gathers
    the k (score, id) pairs of every "model" rank and merges them with a
    stable top-k (the lower rank, so the lower id, first among equal
    scores).  Queries split over "pod" and "data" as the reference's
    ``shard_map`` splits them, and the blocks are gathered back: every rank
    takes the whole (B, d) and (N, d) and returns the whole (B, k).

    With no mesh, one "model" rank, N not a multiple of the "model" ranks
    or B not of the query ranks, this is ``streaming_topk`` on the whole
    input, as the reference's own branch is."""
    mesh = common.get_abstract_mesh_or_none()
    sizes = common.mesh_sizes(mesh) if mesh is not None else {}
    mw = sizes.get("model", 1)
    b, n = q_emb.shape[0], cand_emb.shape[0]
    batch_axes = tuple(a for a in ("pod", "data") if a in sizes)
    bw = math.prod(sizes[a] for a in batch_axes)
    if mesh is None or mw <= 1 or n % mw or (b % bw if bw else 0):
        return streaming_topk(q_emb, cand_emb, k, tile)
    n_local = n // mw
    qspec = common.P(batch_axes or None, None)
    dtensor = isinstance(q_emb, DTensor) or isinstance(cand_emb, DTensor)
    if dtensor:
        # the region's in-specs: the queries' batch block, the rank's rows
        q = common.to_region(q_emb, mesh, qspec)
        cand = common.to_region(cand_emb, mesh, common.P("model", None))
    else:
        q = common.block_of(q_emb, mesh, batch_axes)
        cand = common.block_of(cand_emb, mesh, "model")
    m = common.mesh_coords(mesh)["model"]
    v, i = streaming_topk(q, cand, k, tile)
    av = common.all_gather_axes(v, mesh, "model", dim=1)
    ai = common.all_gather_axes(i + m * n_local, mesh, "model", dim=1)
    v2, p = torch.sort(av, dim=1, descending=True, stable=True)
    v2, i2 = v2[:, :k], torch.gather(ai, 1, p[:, :k])
    if dtensor:
        return (common.from_region(v2, mesh, qspec),
                common.from_region(i2, mesh, qspec))
    if batch_axes:
        v2 = common.all_gather_axes(v2, mesh, batch_axes)
        i2 = common.all_gather_axes(i2, mesh, batch_axes)
    return v2, i2


def anytime_retrieval(query_emb, cand_emb, prior_order_len, k: int):
    """The paper's anytime budget on dense retrieval: the top-k of one
    query (``query_emb`` (1, d)) over the first ``prior_order_len``
    candidates of ``cand_emb`` (stored in popularity order); (vals (k,),
    ids (k,) int64).  Kernel 6 scores ``cand_emb[:budget]`` at
    min(k, budget); below k the rest are -inf with ids budget, budget +
    1, …, as the reference's ``top_k`` over its -inf-masked scores fills
    them.  The budget is read on the host: a number as it is, a tensor by
    one synchronisation.  Where ``kernels.direct`` does not hold (fake
    tensors, DTensors, a dispatch mode) the call takes the operator
    ``repro_torch::anytime_topk``, inside which that read lies, so a dry
    run under fake tensors reads no budget."""
    n = cand_emb.shape[0]
    if not 1 <= k <= n:
        raise ValueError(f"k={k} must be in [1, n_candidates={n}]")
    q = query_emb[:1].contiguous()
    kernels.on_cpu(q, cand_emb)
    if kernels.direct(q, cand_emb):
        return _anytime(q, cand_emb, prior_order_len, k)
    return kernels.call("anytime_topk", q, cand_emb, torch.as_tensor(
        prior_order_len, device=cand_emb.device).reshape(()), k)


def _anytime(q, cand_emb, prior_order_len, k: int):
    """``anytime_retrieval`` of one query row: the budget read on the host,
    kernel 6 (or its plain version) over the first ``budget`` rows."""
    n = cand_emb.shape[0]
    budget = min(max(int(prior_order_len), 0), n)
    kk = min(k, budget)
    if kk:
        vals, ids = dense_ops.dense_topk_tiles(q, cand_emb[:budget]
                                               .contiguous(), kk)
    else:
        vals = torch.empty((1, 0), dtype=q.dtype, device=q.device)
        ids = torch.empty((1, 0), dtype=torch.int64, device=q.device)
    fill = torch.arange(budget, budget + k - kk, device=q.device)
    vals, ids = _fill(vals, ids, k, fill)
    return vals[0], ids[0]


def _anytime_launch(q: torch.Tensor, cand_emb: torch.Tensor,
                    budget: torch.Tensor, k: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    vals, ids = _anytime(q, cand_emb, budget, k)
    return vals.contiguous(), ids.contiguous()


def _anytime_fake(q, cand_emb, budget, k):
    # kernel 6's checks at the whole budget (the launch makes its rows
    # contiguous)
    dense_ops.check_inputs(q, cand_emb.contiguous(), k, False)
    return (torch.empty((k,), dtype=q.dtype, device=q.device),
            torch.empty((k,), dtype=torch.int64, device=q.device))


def _anytime_flops(q, cand_emb, budget, k, *args, **kwargs):
    """Kernel 6's FMA a (candidate, dimension), every candidate counted:
    under fake tensors the budget cannot be read."""
    return 2 * cand_emb[0] * cand_emb[1]


def _anytime_shardings(q, cand_emb, budget, k):
    return kernels.split_strategies(3, 2, (), extra_in=1)


kernels.card_op("anytime_topk", _anytime_launch, _anytime_launch,
                _anytime_fake,
                _anytime_flops, _anytime_shardings)


# ---------------------------------------------------------------------------
# BERT4Rec
# ---------------------------------------------------------------------------

def bert4rec_hidden(params, c: RecsysConfig, items):
    """items: (B, S) -> final hidden states (B, S, D)."""
    b, s = items.shape
    d = c.embed_dim
    x = embedding.lookup(params["item_embed"], items) \
        + params["pos_embed"][None]
    blocks = params["blocks"]

    def heads(t):
        # (B, S, d) -> a (B, H, S, d / H) view, unit stride along the width
        return common.split_last(t, c.n_heads, d // c.n_heads).transpose(
            1, 2)

    for i in range(c.n_blocks):
        bp = {k: w[i] for k, w in blocks.items()}
        h = common.rms_norm(x, bp["ln1"])
        o = chunked_attention(heads(h @ bp["wq"]), heads(h @ bp["wk"]),
                              heads(h @ bp["wv"]), causal=False)
        x = x + common.merge_last(o.transpose(1, 2)) @ bp["wo"]
        h = common.rms_norm(x, bp["ln2"])
        x = x + common.gelu_mlp(h, bp["w1"], bp["b1"], bp["w2"], bp["b2"])
    return common.rms_norm(x, params["final_ln"])


def bert4rec_logits(params, c: RecsysConfig, items):
    """items: (B, S) -> (B, S, padded item rows) full-vocabulary logits."""
    return bert4rec_hidden(params, c, items) @ params["item_embed"].T


def bert4rec_loss(params, c: RecsysConfig, batch):
    """Masked-item training with a sampled softmax.  batch: items (B, S);
    positions (B, M) masked slots; candidates (C,) shared pool (with the
    true items); label_idx (B, M) the true item's index in candidates."""
    h = bert4rec_hidden(params, c, batch["items"])           # (B, S, D)
    pos = batch["positions"].long()
    hm = torch.gather(h, 1, pos[..., None].expand(-1, -1, h.shape[-1]))
    cand = embedding.lookup(params["item_embed"], batch["candidates"])
    logits = torch.einsum("bmd,cd->bmc", hm, cand)
    return common.cross_entropy(logits, batch["label_idx"],
                                batch["candidates"].shape[0])


# ---------------------------------------------------------------------------
# the two-tower module of the dense modality
# ---------------------------------------------------------------------------

class TwoTower(nn.Module):
    """The tower pair of a ``two_tower`` ``RecsysConfig`` on an explicit
    device, for inference.

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
    def init(cls, c: RecsysConfig, seed: int = 0,
             device=None) -> "TwoTower":
        """A fresh tower of ``c``'s shapes at ``init``'s scales.  The draws
        come from a CPU ``torch.Generator`` seeded with ``seed`` (tables,
        then each side's layers), so they do not depend on the device; they
        are not the reference's ``jax.random`` draws, nor ``init``'s."""
        g = torch.Generator().manual_seed(seed)
        shapes = param_shapes(c)

        def normal(leaf):
            return torch.randn(leaf.shape, generator=g) * leaf.scale

        params = {f"{side}_table": normal(shapes[f"{side}_table"])
                  for side in SIDES}
        for side in SIDES:
            params[f"{side}_mlp"] = {
                k: normal(leaf) if leaf.fill == "normal"
                else torch.zeros(leaf.shape)
                for k, leaf in shapes[f"{side}_mlp"].items()}
        return cls(params, device)

    @torch.no_grad()
    def tower_embed(self, side: str, ids: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
        """(B, d) L2-normalized tower outputs for padded id bags (B, L)."""
        return _tower(self.tables[side], self.mlps[side], ids, mask)
