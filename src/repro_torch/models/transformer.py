"""Decoder-only transformer of the LM family, dense GQA (Yi-6B, Minitron-8B):
``init``, ``forward``, and the serving entry points ``prefill`` and
``decode_step`` over a KV cache.

A port of the reference's ``models/transformer.py`` with the same
parameter tree (``embed``, ``unembed``, ``final_ln`` and ``layers`` whose
leaves carry a leading (L,) axis) and the same numerics; its
``lax.scan`` over layers is a Python loop.  Attention goes through
``models.attention``: on the card the prefill and decode kernels, on the
CPU their plain versions.

Kept from the reference on purpose: ``decode_step`` rotates q and k with
RoPE's default θ = 10,000 whatever ``rope_theta`` says, while ``forward``
and ``prefill`` use ``rope_theta`` (ROADMAP §3).  The port reproduces the
reference and does not fix it.

One change of form: ``decode_step`` writes the new token's k and v into
``cache`` in place (one indexed store a layer) and returns the same dict,
where the reference rebuilds the whole cache with a select.  The values
are the same.

Not ported (ROADMAP §1 item 11): MoE and MLA configurations raise
``NotImplementedError``; ``forward_hidden``, ``loss_fn`` and training.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional

import torch

from repro_torch.isn.backend import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import common
from repro_torch.models.attention import MLAConfig

_UNPORTED = "is not ported yet (ROADMAP §1 item 11)"


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
    moe: Optional[Any] = None             # the reference's MoEConfig
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


def _require_dense_gqa(c: LMConfig) -> None:
    if c.moe is not None:
        raise NotImplementedError(f"MoE ({c.name}) {_UNPORTED}")
    if c.attention != "gqa":
        raise NotImplementedError(f"{c.attention} attention ({c.name}) "
                                  f"{_UNPORTED}")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

LAYER_KEYS = {"attn": ("wq", "wk", "wv", "wo"),
              "ffn": ("w_gate", "w_up", "w_down")}


def _layer_shapes(c: LMConfig) -> dict:
    """Shapes of the per-layer matrices, without the leading (L,) axis."""
    dm, hd = c.d_model, c.head_dim
    return {"wq": (dm, c.n_heads * hd), "wk": (dm, c.n_kv_heads * hd),
            "wv": (dm, c.n_kv_heads * hd), "wo": (c.n_heads * hd, dm),
            "w_gate": (dm, c.d_ff), "w_up": (dm, c.d_ff),
            "w_down": (c.d_ff, dm)}


def init(c: LMConfig, seed: int = 0, device=None) -> dict:
    """Parameters of ``c`` drawn from ``torch.Generator(seed)`` on
    ``device`` (the card unless the caller names the CPU).

    Shapes, scales and layout are the reference's (``ParamFactory``): a
    dense leaf is normal × 1/√(its first dimension) — for the stacked
    layer leaves that is the layer count, as in the reference — the
    embedding normal × 0.02, the norms ones.  The draws differ from JAX's."""
    _require_dense_gqa(c)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    dt = c.torch_dtype

    def dense(shape, scale=None):
        scale = scale if scale is not None else 1.0 / math.sqrt(
            max(shape[0], 1))
        w = torch.randn(shape, generator=gen, dtype=dt, device=dev)
        return w.mul_(scale)

    def ones(shape):
        return torch.ones(shape, dtype=dt, device=dev)

    n = c.n_layers
    shapes = _layer_shapes(c)
    layers = {group: {k: dense((n,) + shapes[k]) for k in keys}
              for group, keys in LAYER_KEYS.items()}
    layers["ln1"] = ones((n, c.d_model))
    layers["ln2"] = ones((n, c.d_model))
    return {
        "embed": dense((c.padded_vocab, c.d_model), scale=0.02),
        "unembed": dense((c.d_model, c.padded_vocab)),
        "final_ln": ones((c.d_model,)),
        "layers": layers,
    }


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
    q = (h @ p["wq"]).reshape(b, s, c.n_heads, hd).transpose(1, 2)
    k = (h @ p["wk"]).reshape(b, s, c.n_kv_heads, hd).transpose(1, 2)
    v = (h @ p["wv"]).reshape(b, s, c.n_kv_heads, hd).transpose(1, 2)
    q = common.rope(q, positions[:, None, :], c.rope_theta)
    k = common.rope(k, positions[:, None, :], c.rope_theta)
    return q, k, v


def _attn_out(p, o, c: LMConfig):
    b, _, s, _ = o.shape
    return o.transpose(1, 2).reshape(b, s, c.n_heads * c.head_dim) @ p["wo"]


def _attn_block(p, x, positions, c: LMConfig, causal=True):
    q, k, v = _qkv(p, x, positions, c)
    o = attn.chunked_attention(q, k, v, causal=causal)
    return _attn_out(p, o, c)


def _ffn(lp, x, c: LMConfig):
    h = common.rms_norm(x, lp["ln2"], c.norm_eps)
    f = lp["ffn"]
    return x + common.swiglu(h, f["w_gate"], f["w_up"], f["w_down"])


def _layer_fwd(lp, x, positions, c: LMConfig, causal=True):
    h = common.rms_norm(x, lp["ln1"], c.norm_eps)
    x = x + _attn_block(lp["attn"], h, positions, c, causal)
    return _ffn(lp, x, c)


def _embed(params, tokens, c: LMConfig):
    return params["embed"][tokens.long()].to(c.torch_dtype)


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device)[None, :].expand(b, s)


def forward(params, c: LMConfig, tokens, causal=True):
    """tokens (B, S) -> (logits (B, S, V_pad), aux 0.0)."""
    _require_dense_gqa(c)
    b, s = tokens.shape
    positions = _positions(b, s, tokens.device)
    x = _embed(params, tokens, c)
    for i in range(c.n_layers):
        x = _layer_fwd(layer(params, i), x, positions, c, causal)
    x = common.rms_norm(x, params["final_ln"], c.norm_eps)
    return x @ params["unembed"], torch.zeros((), device=x.device)


def prefill(params, c: LMConfig, tokens):
    """Run the prompt through the model, building the decode cache.

    Returns (last-token logits (B, V_pad), cache) — cache {"k", "v"} of
    (L, B, Hkv, S, hd), the layout of ``init_cache``, so ``decode_step``
    can continue from it (once padded to the decode length).
    """
    _require_dense_gqa(c)
    b, s = tokens.shape
    positions = _positions(b, s, tokens.device)
    x = _embed(params, tokens, c)
    shape = (c.n_layers, b, c.n_kv_heads, s, c.head_dim)
    cache = {key: torch.empty(shape, dtype=x.dtype, device=x.device)
             for key in ("k", "v")}
    for i in range(c.n_layers):
        lp = layer(params, i)
        h = common.rms_norm(x, lp["ln1"], c.norm_eps)
        q, k, v = _qkv(lp["attn"], h, positions, c)
        o = attn.chunked_attention(q, k, v, causal=True)
        cache["k"][i] = k
        cache["v"][i] = v
        x = _ffn(lp, x + _attn_out(lp["attn"], o, c), c)
    x = common.rms_norm(x[:, -1], params["final_ln"], c.norm_eps)
    return x @ params["unembed"], cache


# ---------------------------------------------------------------------------
# decode (KV cache)
# ---------------------------------------------------------------------------

def init_cache(c: LMConfig, batch: int, max_len: int, device=None) -> dict:
    """Zero k/v caches (L, B, Hkv, max_len, hd) on ``device``."""
    _require_dense_gqa(c)
    dev = resolve_device(device)
    shape = (c.n_layers, batch, c.n_kv_heads, max_len, c.head_dim)
    return {key: torch.zeros(shape, dtype=c.torch_dtype, device=dev)
            for key in ("k", "v")}


def _cache_insert(cache, new, kv_len):
    """Write new (B, H, D) into cache (B, H, S, D) at position kv_len (B,),
    in place; positions past S are dropped, as the reference's select
    drops them."""
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


def decode_step(params, c: LMConfig, token, cache, kv_len):
    """One autoregressive step.

    token: (B,) int; kv_len: (B,) current cache fill.  Writes the token's
    k and v at ``kv_len`` into ``cache`` in place and returns (logits (B,
    V_pad), cache).  RoPE rotates with the default θ (the reference's
    behaviour, see the module docstring).
    """
    _require_dense_gqa(c)
    b = token.shape[0]
    hd = c.head_dim
    x = _embed(params, token, c)                         # (B, d)
    pos = kv_len.float()[:, None, None]
    for i in range(c.n_layers):
        lp = layer(params, i)
        p = lp["attn"]
        h = common.rms_norm(x, lp["ln1"], c.norm_eps)
        q = (h @ p["wq"]).reshape(b, c.n_heads, hd)
        kk = (h @ p["wk"]).reshape(b, c.n_kv_heads, hd)
        vv = (h @ p["wv"]).reshape(b, c.n_kv_heads, hd)
        q = common.rope(q[:, :, None, :], pos)[:, :, 0]
        kk = common.rope(kk[:, :, None, :], pos)[:, :, 0]
        k_cache = _cache_insert(cache["k"][i], kk, kv_len)
        v_cache = _cache_insert(cache["v"][i], vv, kv_len)
        o = attn.gqa_decode(q, k_cache, v_cache, kv_len + 1)
        x = x + o.reshape(b, c.n_heads * hd) @ p["wo"]
        x = _ffn(lp, x, c)
    x = common.rms_norm(x, params["final_ln"], c.norm_eps)
    return x @ params["unembed"], cache
