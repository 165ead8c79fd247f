"""Decoder-only transformer of the LM family: dense GQA (Yi-6B,
Minitron-8B), MLA (MiniCPM3-4B) and MoE (granite-MoE, Moonlight):
``init``, ``forward``, the training entry points ``forward_hidden`` and
``loss_fn``, and the serving entry points ``prefill`` and ``decode_step``
over a KV cache (GQA) or a latent cache (MLA).

A port of the reference's ``models/transformer.py`` with the same
parameter tree (``embed``, ``unembed``, ``final_ln`` and ``layers`` whose
leaves carry a leading (L,) axis) and the same numerics; its
``lax.scan`` over layers is a Python loop.  Attention goes through
``models.attention``: on the card the prefill and decode kernels, on the
CPU their plain versions; MLA's decode is the reference's absorbed form in
torch products.  The FFN is a SwiGLU, or ``models.moe.moe_forward``
whose router losses ``forward`` sums.

Kept from the reference on purpose: ``decode_step`` rotates q and k with
RoPE's default θ = 10,000 whatever ``rope_theta`` says, while ``forward``
and ``prefill`` use ``rope_theta`` (ROADMAP §3).  The port reproduces the
reference and does not fix it.  (MLA rotates with the default θ
everywhere, as the reference's ``mla_*`` do.)

One change of form: ``decode_step`` writes the new token's cache rows
(k and v, or MLA's latent and rope key) into ``cache`` in place (one
indexed store a layer) and returns the same dict, where the reference
rebuilds the whole cache.  The values are the same: a GQA write past the
cache is dropped, as the reference's select drops it; an MLA write at or
past the cache's end lands on its last row, as ``dynamic_update_slice``
clamps it.

Training: ``forward_hidden`` runs the layers under the configuration's
``remat`` — ``"full"`` checkpoints each layer
(``torch.utils.checkpoint``, non-reentrant: its activations are
recomputed in the backward, so the attention kernel runs twice a layer and
step), ``"dots"`` saves only the outputs of the plain (unbatched) matrix
products, as the reference's ``dots_with_no_batch_dims_saveable`` policy
does, ``"none"`` saves everything.  ``loss_fn`` is the reference's
sequence-chunked cross-entropy: each ``ce_chunk`` of the sequence is
unembedded and reduced under a checkpoint of its own, so the full (B, S,
V) logits never exist.  Gradients reach the stacked layer leaves through
one ``unbind`` a leaf.

Logical sharding: ``forward``, ``forward_hidden``, ``loss_fn``,
``prefill`` and ``decode_step`` take the reference's ``rules`` and call
``common.constrain`` where it does (``transformer.py:166-330``); under a
mesh that redistributes DTensor activations and leaves each rank's whole
plain tensors as they are, and MoE takes its mesh branch.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import torch
from torch.distributed.tensor import DTensor, Replicate
from torch.utils import checkpoint as ckpt

from repro_torch.isn.backend import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import common
from repro_torch.models.attention import NEG_INF, MLAConfig
from repro_torch.models.moe import MoEConfig, moe_forward, moe_shapes


@dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    attention: str = "gqa"                # "gqa" | "mla"
    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    remat: str = "full"                   # training fields, kept so that
    cost_exact: bool = False              # configurations copy field for
    train_layout: str = "fsdp"            # field; serving reads none
    train_microbatches: int = 1

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256, as the reference pads it."""
        return ((self.vocab + 255) // 256) * 256

    def param_count(self) -> int:
        """Total parameters, counted as the reference counts them."""
        c = self
        embed = c.vocab * c.d_model * 2
        if c.attention == "mla":
            m = c.mla
            a = (c.d_model * m.q_lora_rank
                 + m.q_lora_rank * c.n_heads * (m.qk_nope_dim + m.qk_rope_dim)
                 + c.d_model * (m.kv_lora_rank + m.qk_rope_dim)
                 + m.kv_lora_rank * c.n_heads * (m.qk_nope_dim + m.v_head_dim)
                 + c.n_heads * m.v_head_dim * c.d_model)
        else:
            a = c.d_model * c.head_dim * (c.n_heads + 2 * c.n_kv_heads) \
                + c.n_heads * c.head_dim * c.d_model
        if c.moe is not None:
            f = 3 * c.d_model * c.moe.d_ff_expert
            ff = c.moe.n_experts * f + c.moe.n_shared * f \
                + c.d_model * c.moe.n_experts
        else:
            ff = 3 * c.d_model * c.d_ff
        return embed + c.n_layers * (a + ff + 2 * c.d_model)

    def active_param_count(self) -> int:
        """Active parameters a token (MoE: only the routed experts count),
        counted as the reference counts them."""
        if self.moe is None:
            return self.param_count()
        c, m = self, self.moe
        f = 3 * c.d_model * m.d_ff_expert
        dense_ff = (m.top_k + m.n_shared) * f + c.d_model * m.n_experts
        full = self.param_count()
        all_ff = m.n_experts * f + m.n_shared * f + c.d_model * m.n_experts
        return full - c.n_layers * (all_ff - dense_ff)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

# the per-layer leaves by group: attention by kind, FFN dense or MoE (and
# its shared experts)
ATTN_KEYS = {"gqa": ("wq", "wk", "wv", "wo"),
             "mla": ("wdq", "q_norm", "wuq", "wdkv", "kv_norm", "wuk", "wuv",
                     "wo")}
FFN_KEYS = {"dense": ("w_gate", "w_up", "w_down"),
            "moe": ("router", "w_gate", "w_up", "w_down"),
            "shared": ("shared_gate", "shared_up", "shared_down")}
LAYER_KEYS = {"attn": ATTN_KEYS["gqa"], "ffn": FFN_KEYS["dense"]}


def param_shapes(c: LMConfig) -> dict:
    """The tree of ``init(c)`` as ``Leaf`` shapes, fills and logical names,
    in the reference's layout: the layer leaves stacked on a leading (L,)
    axis named "stack"."""
    dm, hd, n = c.d_model, c.head_dim, (c.n_layers,)
    if c.attention == "mla":
        attn_s = attn.mla_shapes(dm, c.n_heads, c.mla, stack=n)
    else:
        attn_s = {
            "wq": common.dense((dm, c.n_heads * hd), ("embed", "heads"),
                               stack=n),
            "wk": common.dense((dm, c.n_kv_heads * hd), ("embed", "kv_heads"),
                               stack=n),
            "wv": common.dense((dm, c.n_kv_heads * hd), ("embed", "kv_heads"),
                               stack=n),
            "wo": common.dense((c.n_heads * hd, dm), ("heads", "embed"),
                               stack=n)}
    if c.moe is not None:
        ffn_s = moe_shapes(dm, c.moe, stack=n)
    else:
        ffn_s = {
            "w_gate": common.dense((dm, c.d_ff), ("embed", "ffn"), stack=n),
            "w_up": common.dense((dm, c.d_ff), ("embed", "ffn"), stack=n),
            "w_down": common.dense((c.d_ff, dm), ("ffn", "embed"), stack=n)}
    return {
        "embed": common.dense((c.padded_vocab, dm), ("vocab", "embed"),
                              0.02),
        "unembed": common.dense((dm, c.padded_vocab), ("embed", "vocab")),
        "final_ln": common.ones((dm,), ("embed",)),
        "layers": {"attn": attn_s, "ffn": ffn_s,
                   "ln1": common.ones((dm,), ("embed",), stack=n),
                   "ln2": common.ones((dm,), ("embed",), stack=n)},
    }


def param_names(c: LMConfig) -> dict:
    """The logical names of ``init(c)``'s leaves, congruent with its tree
    (the reference's ``names_tree_of(*init(c, abstract=True))``)."""
    return common.leaf_names(param_shapes(c))


def init(c: LMConfig, seed: int = 0, device=None, abstract: bool = False):
    """Parameters of ``c`` drawn from ``torch.Generator(seed)`` on
    ``device`` (the card unless the caller names the CPU).  With
    ``abstract``, (the tree as ``meta`` tensors of each leaf's shape and
    type, {"a/b": logical names}), as the reference's ``init(c,
    abstract=True)``: nothing is drawn.

    Shapes, scales and layout are the reference's (``ParamFactory``): a
    dense leaf is normal × 1/√(its first dimension) — for the stacked
    layer leaves that is the layer count, as in the reference — the
    embedding and the MoE router normal × 0.02, the norms ones.  The layer
    leaves are drawn first, then the embedding and the unembedding.  The
    draws differ from JAX's."""
    shapes = param_shapes(c)
    if abstract:
        return (common.abstract(shapes, c.torch_dtype),
                common.flat_names(shapes))
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    layers = common.draw(shapes.pop("layers"), gen, c.torch_dtype, dev)
    params = common.draw(shapes, gen, c.torch_dtype, dev)
    params["layers"] = layers
    return params


def layer(params: dict, i: int) -> dict:
    """Layer ``i``'s leaves (views of the stacked tensors)."""
    lay = params["layers"]
    return {"attn": {k: w[i] for k, w in lay["attn"].items()},
            "ffn": {k: w[i] for k, w in lay["ffn"].items()},
            "ln1": lay["ln1"][i], "ln2": lay["ln2"][i]}


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _qkv(p, h, positions, c: LMConfig):
    """Projected and rotated q (B, H, S, hd), k and v (B, Hkv, S, hd)."""
    b, s, _ = h.shape
    hd = c.head_dim
    q = common.split_last(h @ p["wq"], c.n_heads, hd).transpose(1, 2)
    k = common.split_last(h @ p["wk"], c.n_kv_heads, hd).transpose(1, 2)
    v = common.split_last(h @ p["wv"], c.n_kv_heads, hd).transpose(1, 2)
    q = common.rope(q, positions[:, None, :], c.rope_theta)
    k = common.rope(k, positions[:, None, :], c.rope_theta)
    return q, k, v


def _attn_out(p, o, c: LMConfig):
    return common.merge_last(o.transpose(1, 2)) @ p["wo"]


def _attn_block(p, x, positions, c: LMConfig, causal=True):
    if c.attention == "mla":
        return attn.mla_forward(p, x, positions, c.n_heads, c.mla,
                                causal=causal)
    q, k, v = _qkv(p, x, positions, c)
    o = attn.chunked_attention(q, k, v, causal=causal)
    return _attn_out(p, o, c)


def _ffn(lp, x, c: LMConfig):
    """x + the FFN of its norm, and the layer's router loss (None for a
    dense FFN); x is (..., d_model), the MoE's tokens all of its rows."""
    h = common.rms_norm(x, lp["ln2"], c.norm_eps)
    f = lp["ffn"]
    if c.moe is None:
        return x + common.swiglu(h, f["w_gate"], f["w_up"], f["w_down"]), None
    if isinstance(h, DTensor) and h.dim() == 3:
        # a DTensor's tokens flattened batch-major from whole sequences
        # (a split sequence would flatten to a strided layout), and y back
        # in that layout
        h = h.redistribute(h.device_mesh, [
            Replicate() if pl.is_shard(1) else pl for pl in h.placements])
        tokens = h.reshape(-1, h.shape[-1])
        y, aux = moe_forward(f, tokens, c.moe)
        y = y.redistribute(tokens.device_mesh, tokens.placements)
    else:
        y, aux = moe_forward(f, h.reshape(-1, h.shape[-1]), c.moe)
    return x + y.reshape(h.shape), aux


_BSE = ("batch", "seq", "embed")


def _layer_fwd(lp, x, positions, c: LMConfig, rules, causal=True):
    h = common.rms_norm(x, lp["ln1"], c.norm_eps)
    x = x + _attn_block(lp["attn"], h, positions, c, causal)
    x, aux = _ffn(lp, common.constrain(x, _BSE, rules), c)
    return common.constrain(x, _BSE, rules), aux


def _embed(params, tokens, c: LMConfig):
    return params["embed"][tokens.long()].to(c.torch_dtype)


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device)[None, :].expand(b, s)


def forward(params, c: LMConfig, tokens, rules=None, causal=True):
    """tokens (B, S) -> (logits (B, S, V_pad), the layers' summed router
    loss: an fp32 scalar, 0.0 without MoE)."""
    b, s = tokens.shape
    positions = _positions(b, s, tokens.device)
    rules = rules or common.DEFAULT_RULES
    x = common.constrain(_embed(params, tokens, c), _BSE, rules)
    aux = torch.zeros((), device=x.device)
    for i in range(c.n_layers):
        x, a = _layer_fwd(layer(params, i), x, positions, c, rules, causal)
        if a is not None:
            aux = aux + a
    x = common.rms_norm(x, params["final_ln"], c.norm_eps)
    logits = common.constrain(x @ params["unembed"], ("batch", "seq", "vocab"),
                              rules)
    return logits, aux


def _layers(params) -> list:
    """Every layer's leaves, from one ``unbind`` of each stacked leaf (its
    backward stacks the layers' gradients once)."""
    lay = params["layers"]
    groups = {g: {k: w.unbind(0) for k, w in lay[g].items()}
              for g in ("attn", "ffn")}
    ln1, ln2 = lay["ln1"].unbind(0), lay["ln2"].unbind(0)
    return [{"attn": {k: w[i] for k, w in groups["attn"].items()},
             "ffn": {k: w[i] for k, w in groups["ffn"].items()},
             "ln1": ln1[i], "ln2": ln2[i]} for i in range(len(ln1))]


_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """Save the outputs of plain matrix products (no batch dimension),
    recompute the rest: the reference's ``dots_with_no_batch_dims_saveable``."""
    if op in _MATMULS:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, remat: str):
    """``fn`` under the configuration's rematerialisation policy."""
    if remat == "full":
        return functools.partial(ckpt.checkpoint, fn, use_reentrant=False)
    if remat == "dots":
        return functools.partial(
            ckpt.checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(
                ckpt.create_selective_checkpoint_contexts, _dots_policy))
    if remat == "none":
        return fn
    raise ValueError(f"remat must be 'none', 'full' or 'dots', got {remat!r}")


def forward_hidden(params, c: LMConfig, tokens, rules=None, causal=True):
    """Like ``forward`` but stops at the final hidden states: (x (B, S,
    d_model) after the final norm, the layers' summed router loss, fp32),
    each layer under ``c.remat``."""
    b, s = tokens.shape
    positions = _positions(b, s, tokens.device)
    rules = rules or common.DEFAULT_RULES
    x = common.constrain(_embed(params, tokens, c), _BSE, rules)
    aux = torch.zeros((), device=x.device)
    body = _remat(functools.partial(_layer_fwd, c=c, rules=rules,
                                    causal=causal), c.remat)
    for lp in _layers(params):
        x, a = body(lp, x, positions)
        if a is not None:
            aux = aux + a
    return common.rms_norm(x, params["final_ln"], c.norm_eps), aux


def _ce_sum(logits, labels, vocab: int):
    """(Σ over unmasked positions of logsumexp - gold logit, their count),
    fp32: padded-vocabulary columns at -1e30, labels < 0 masked."""
    logits = logits.float()
    if logits.shape[-1] > vocab:
        pad = torch.arange(logits.shape[-1], device=logits.device) < vocab
        logits = torch.where(pad, logits, NEG_INF)
    lse = torch.logsumexp(logits, dim=-1)
    idx = labels.clamp(min=0).long()[..., None]
    if isinstance(logits, DTensor):
        # a DTensor split over the vocabulary: each rank selects its own
        # columns (the one gold entry plus zeros: the same value)
        cols = torch.arange(logits.shape[-1], device=logits.device)
        gold = torch.where(cols == idx, logits, 0.0).sum(dim=-1,
                                                         keepdim=True)
    else:
        gold = torch.gather(logits, -1, idx)
    mask = (labels >= 0).float()
    return ((lse - gold[..., 0]) * mask).sum(), mask.sum()


def _ce_chunk(x, unembed, labels, vocab: int, rules):
    logits = common.constrain(x @ unembed, ("batch", "seq", "vocab"), rules)
    return _ce_sum(logits, labels, vocab)


def loss_fn(params, c: LMConfig, tokens, labels, rules=None,
            ce_chunk: int = 512):
    """Mean next-token cross-entropy plus the summed router loss, fp32.

    The sequence is cut into chunks of ``ce_chunk`` (at most S); each
    chunk's (B, chunk, V) logits are computed and reduced under a
    checkpoint, so the backward recomputes them and the full logits never
    exist.  Raises, as the reference's reshape does, when S is not a
    multiple of the chunk.  The chunks' logits are constrained under the
    rules with "vocab" on "model" and the batch on ("pod", "data"), as the
    reference's."""
    x, aux = forward_hidden(params, c, tokens, rules)
    # the reference's CE tiles: vocab-sharded over "model"
    ce_rules = dict(rules or common.DEFAULT_RULES)
    ce_rules.update(batch=("pod", "data"), seq=None, vocab="model")
    s = x.shape[1]
    ce_chunk = min(ce_chunk, s)
    n_chunks = s // ce_chunk
    if n_chunks * ce_chunk != s:
        raise TypeError(f"cannot reshape a sequence of {s} into {n_chunks} "
                        f"chunks of {ce_chunk}")
    loss_sum = torch.zeros((), device=x.device)
    count = torch.zeros((), device=x.device)
    for i in range(n_chunks):
        sl = slice(i * ce_chunk, (i + 1) * ce_chunk)
        part, n = ckpt.checkpoint(_ce_chunk, x[:, sl], params["unembed"],
                                  labels[:, sl], c.vocab, ce_rules,
                                  use_reentrant=False)
        loss_sum = loss_sum + part
        count = count + n
    return loss_sum / torch.clamp(count, min=1.0) + aux


def prefill(params, c: LMConfig, tokens, rules=None):
    """Run the prompt through the model, building the decode cache.

    Returns (last-token logits (B, V_pad), cache) — the layout of
    ``init_cache`` (GQA: {"k", "v"} of (L, B, Hkv, S, hd); MLA: {"c",
    "rope"} of (L, B, S, kv_lora_rank) and (L, B, S, qk_rope_dim)), so
    ``decode_step`` can continue from it (once padded to the decode
    length).
    """
    rules = rules or common.DEFAULT_RULES
    b, s = tokens.shape
    positions = _positions(b, s, tokens.device)
    x = common.constrain(_embed(params, tokens, c), _BSE, rules)
    if isinstance(x, DTensor):
        # DTensor layers: the cache is the stack of the layers' entries
        cache = {key: [None] * c.n_layers for key in _cache_shapes(c, b, s)}
    else:
        cache = {key: torch.empty((c.n_layers,) + shape, dtype=x.dtype,
                                  device=x.device)
                 for key, shape in _cache_shapes(c, b, s).items()}
    for i in range(c.n_layers):
        lp = layer(params, i)
        h = common.rms_norm(x, lp["ln1"], c.norm_eps)
        if c.attention == "mla":
            lat = attn.mla_latents(lp["attn"], h, positions, c.mla)
            o = attn.mla_forward(lp["attn"], h, positions, c.n_heads, c.mla,
                                 latents=lat)
            cache["c"][i] = common.constrain(lat[0],
                                             ("batch", "kv_seq", "qk"), rules)
            cache["rope"][i] = lat[1]
        else:
            q, k, v = _qkv(lp["attn"], h, positions, c)
            o = _attn_out(lp["attn"], attn.chunked_attention(q, k, v,
                                                             causal=True), c)
            kv_names = ("batch", "kv_heads", "kv_seq", None)
            cache["k"][i] = common.constrain(k, kv_names, rules)
            cache["v"][i] = common.constrain(v, kv_names, rules)
        x, _ = _ffn(lp, x + o, c)
        x = common.constrain(x, _BSE, rules)
    x = common.rms_norm(x[:, -1], params["final_ln"], c.norm_eps)
    if isinstance(x, DTensor):
        cache = {key: torch.stack(v) for key, v in cache.items()}
    return x @ params["unembed"], cache


# ---------------------------------------------------------------------------
# decode (KV / latent cache)
# ---------------------------------------------------------------------------

def _cache_shapes(c: LMConfig, batch: int, length: int) -> dict:
    """One layer's cache shapes: GQA k and v (B, Hkv, S, hd); MLA the latent
    c (B, S, kv_lora_rank) and the rope key (B, S, qk_rope_dim)."""
    if c.attention == "mla":
        return {"c": (batch, length, c.mla.kv_lora_rank),
                "rope": (batch, length, c.mla.qk_rope_dim)}
    kv = (batch, c.n_kv_heads, length, c.head_dim)
    return {"k": kv, "v": kv}


# the caches' logical names (the reference's ``init_cache``, :346-356)
CACHE_NAMES = {"mla": ("stack", "batch", "kv_seq", "qk"),
               "gqa": ("stack", "batch", "kv_heads", "kv_seq", None)}


def init_cache(c: LMConfig, batch: int, max_len: int, device=None,
               abstract: bool = False):
    """Zero caches of ``max_len`` positions on ``device``: GQA k/v (L, B,
    Hkv, max_len, hd); MLA c (L, B, max_len, kv_lora_rank) and rope (L, B,
    max_len, qk_rope_dim).  With ``abstract``, (the caches as ``meta``
    tensors, {key: logical names}), as the reference's ``init_cache(...,
    abstract=True)``."""
    if abstract:
        names = CACHE_NAMES["mla" if c.attention == "mla" else "gqa"]
        return ({key: torch.empty((c.n_layers,) + shape, dtype=c.torch_dtype,
                                  device="meta")
                 for key, shape in _cache_shapes(c, batch, max_len).items()},
                {key: names for key in _cache_shapes(c, batch, max_len)})
    dev = resolve_device(device)
    return {key: torch.zeros((c.n_layers,) + shape, dtype=c.torch_dtype,
                             device=dev)
            for key, shape in _cache_shapes(c, batch, max_len).items()}


def _select_insert(cache, new, at):
    """The reference's select form of an insert: every position of the
    cache (B, S, ...) or (B, H, S, D) at ``at`` (B,) takes ``new`` — purely
    local where the sequence axis is sharded — written back in place.  A
    DTensor cache takes this form; a position past S matches none."""
    s_dim = 2 if cache.dim() == 4 else 1
    shape = [1] * cache.dim()
    shape[s_dim] = cache.shape[s_dim]
    pos = torch.arange(cache.shape[s_dim], device=cache.device).view(shape)
    hit = pos == at.long().view([-1] + [1] * (cache.dim() - 1))
    new = new.to(cache.dtype).unsqueeze(s_dim)
    return cache.copy_(torch.where(hit, new, cache))


def _cache_insert(cache, new, kv_len):
    """Write new (B, H, D) into cache (B, H, S, D) at position kv_len (B,),
    in place; positions past S are dropped, as the reference's select
    drops them."""
    if isinstance(cache, DTensor):
        return _select_insert(cache, new, kv_len)
    b, _, s, _ = cache.shape
    rows = torch.arange(b, device=cache.device)
    pos = kv_len.long()
    # a row whose position is past S rewrites its last slot unchanged (no
    # boolean indexing, so no host sync on the card)
    at = pos.clamp(max=s - 1)
    keep = (pos < s)[:, None, None]
    cache[rows, :, at] = torch.where(keep, new.to(cache.dtype),
                                     cache[rows, :, at])
    return cache


def _cache_insert_2d(cache, new, kv_len):
    """Write new (B, R) into cache (B, S, R) at position kv_len (B,), in
    place, clamped to [0, S - 1] as the reference's
    ``dynamic_update_slice`` clamps it: at kv_len >= S the last row is
    overwritten."""
    b, s, _ = cache.shape
    if isinstance(cache, DTensor):
        return _select_insert(cache, new, kv_len.long().clamp(0, s - 1))
    rows = torch.arange(b, device=cache.device)
    cache[rows, kv_len.long().clamp(0, s - 1)] = new.to(cache.dtype)
    return cache


def decode_step(params, c: LMConfig, token, cache, kv_len, rules=None):
    """One autoregressive step.

    token: (B,) int; kv_len: (B,) current cache fill.  Writes the token's
    cache rows at ``kv_len`` into ``cache`` in place and returns (logits
    (B, V_pad), cache).  RoPE rotates with the default θ (the reference's
    behaviour, see the module docstring).  ``rules`` is taken as the
    reference takes it, which constrains nothing in a step.
    """
    b = token.shape[0]
    hd = c.head_dim
    x = _embed(params, token, c)                         # (B, d)
    pos = kv_len.float()
    for i in range(c.n_layers):
        lp = layer(params, i)
        p = lp["attn"]
        h = common.rms_norm(x, lp["ln1"], c.norm_eps)
        if c.attention == "mla":
            r = c.mla.kv_lora_rank
            dkv = h @ p["wdkv"]
            c_new = common.rms_norm(dkv[..., :r], p["kv_norm"])
            rope_new = common.rope(dkv[..., r:][:, None, :],
                                   pos[:, None])[:, 0]
            c_cache = _cache_insert_2d(cache["c"][i], c_new, kv_len)
            rope_cache = _cache_insert_2d(cache["rope"][i], rope_new, kv_len)
            x = x + attn.mla_decode(p, h, c_cache, rope_cache, kv_len + 1,
                                    c.n_heads, c.mla)
        else:
            q = common.split_last(h @ p["wq"], c.n_heads, hd)
            kk = common.split_last(h @ p["wk"], c.n_kv_heads, hd)
            vv = common.split_last(h @ p["wv"], c.n_kv_heads, hd)
            q = common.rope(q[:, :, None, :], pos[:, None, None])[:, :, 0]
            kk = common.rope(kk[:, :, None, :], pos[:, None, None])[:, :, 0]
            k_cache = _cache_insert(cache["k"][i], kk, kv_len)
            v_cache = _cache_insert(cache["v"][i], vv, kv_len)
            o = attn.gqa_decode(q, k_cache, v_cache, kv_len + 1)
            x = x + common.merge_last(o) @ p["wo"]
        x, _ = _ffn(lp, x, c)
    x = common.rms_norm(x, params["final_ln"], c.norm_eps)
    return x @ params["unembed"], cache
