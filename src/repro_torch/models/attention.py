"""Attention of the LM family.

* ``chunked_attention`` — online softmax over 512-wide KV chunks, so peak
  logits memory is (B, H, Sq, chunk).  For CUDA tensors it runs the
  prefill kernel (``kernels.flash_attention.ops.flash_attention``), the
  device form the reference's docstring names for it; for CPU tensors a
  loop over the chunks in place of the reference's ``lax.scan``, with q
  scaled before the dot as the reference does it.  Where a gradient is
  needed it goes through ``ChunkedAttention``, a ``torch.autograd.Function``
  whose forward also keeps each row's log-sum-exp and whose backward is
  kernel 8's backward (``ops.flash_attention_backward``) on CUDA tensors
  and its plain version on CPU tensors; the reference differentiates its
  checkpointed scan instead, which computes the same gradients.  With no
  gradient needed the call is the serving path's: one prefill launch, no
  log-sum-exp written.
* ``gqa_decode`` — single-token attention over a KV cache masked by
  ``kv_len``: the split-KV decode kernel (``ops.flash_decode``) for CUDA
  tensors, the reference's masked softmax for CPU tensors.
* MLA (``mla_params`` / ``mla_forward`` / ``mla_decode``), the
  DeepSeek/MiniCPM3 multi-head latent attention: queries and KV are
  low-rank compressed.  ``mla_forward`` (prefill) decompresses K and V per
  head and attends through ``chunked_attention`` — on the card the prefill
  kernel at the width pair (q/k ``qk_nope_dim + qk_rope_dim``, v
  ``v_head_dim``), (96, 64) for MiniCPM3.  ``mla_decode`` is the absorbed
  form: the query is projected into the KV latent space and attends over
  the compressed cache in fp32 products, which the reference computes
  outside any kernel.  As in the reference, RoPE rotates with the default
  θ in both, whatever the configuration's ``rope_theta`` says, and the
  logits are scaled by (qk_nope_dim + qk_rope_dim)^-0.5.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch import kernels
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import common

NEG_INF = -1e30


def _repeat_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    group = n_heads // k.shape[1]
    if group == 1:
        return k
    return torch.repeat_interleave(k, group, dim=1)


def chunked_attention(q, k, v, *, causal: bool, chunk: int = 512,
                      scale: float | None = None):
    """q: (B, H, Sq, D); k/v: (B, Hkv, Sk, D). Online softmax over KV
    chunks.  Raises, as the reference's reshape does, when Sk exceeds the
    chunk and is not a multiple of it."""
    sk = k.shape[2]
    chunk = min(chunk, sk)
    n_chunks = sk // chunk
    if n_chunks * chunk != sk:
        raise TypeError(f"cannot reshape keys of length {sk} into "
                        f"{n_chunks} chunks of {chunk}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return ChunkedAttention.apply(q, k, v, causal, chunk, scale)
    return _attend(q, k, v, causal, chunk, scale, False)


def _attend(q, k, v, causal, chunk, scale, return_lse):
    """The prefill kernel for CUDA tensors, the plain loop for CPU ones;
    DTensors go to the kernel's operator, which runs on each rank's blocks
    (its plain version on CPU blocks)."""
    if isinstance(q, DTensor) or not kernels.on_cpu(q, k, v):
        return fa_ops.flash_attention(q, k, v, causal=causal, scale=scale,
                                      return_lse=return_lse)
    return chunked_attention_plain(q, k, v, causal=causal, chunk=chunk,
                                   scale=scale, return_lse=return_lse)


class ChunkedAttention(torch.autograd.Function):
    """``chunked_attention`` with a gradient: the forward keeps q, k, v,
    the output and each row's log-sum-exp; the backward is kernel 8's
    backward on CUDA tensors and ``flash_attention_backward_plain`` on CPU
    tensors (``ops.flash_attention_backward`` picks by device; there is no
    fallback between the two)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, chunk, scale):
        out, lse = _attend(q, k, v, causal, chunk, scale, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = fa_ops.flash_attention_backward(
            q, k, v, out, lse, do.contiguous(), causal=ctx.causal,
            scale=ctx.scale)
        return dq, dk, dv, None, None, None


def chunked_attention_plain(q, k, v, *, causal: bool, chunk: int = 512,
                            scale: float | None = None,
                            return_lse: bool = False):
    """The plain version of ``chunked_attention`` on any device: a loop
    over ``chunk``-wide KV chunks (Sk a multiple of it).  With
    ``return_lse`` also each row's log-sum-exp, max + log(max(sum,
    1e-30)), fp32 (B, H, Sq)."""
    b, h, sq, d = q.shape
    sk, dv = k.shape[2], v.shape[-1]
    chunk = min(chunk, sk)
    scale = scale if scale is not None else d ** -0.5
    k = _repeat_kv(k, h)
    v = _repeat_kv(v, h)
    qf = q.float() * scale
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, dv), dtype=torch.float32, device=q.device)
    rows = torch.arange(sq, device=q.device)[:, None]
    for base in range(0, sk, chunk):
        kc = k[:, :, base:base + chunk].float()
        vc = v[:, :, base:base + chunk].float()
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kc)
        if causal:
            cols = base + torch.arange(chunk, device=q.device)[None, :]
            s = torch.where(rows >= cols, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vc)
        m = m_new
    out = (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
    if return_lse:
        return out, m + torch.log(torch.clamp(l, min=1e-30))
    return out


def gqa_decode(q, k_cache, v_cache, kv_len, scale: float | None = None):
    """q: (B, H, D); caches (B, Hkv, T, D); kv_len (B,) -> (B, H, D): the
    decode kernel's operator for CUDA tensors and DTensors, the plain
    version for CPU tensors."""
    if isinstance(q, DTensor) or not kernels.on_cpu(q, k_cache, v_cache,
                                                    kv_len):
        return fa_ops.flash_decode(q, k_cache, v_cache, kv_len, scale=scale)
    return gqa_decode_plain(q, k_cache, v_cache, kv_len, scale=scale)


def gqa_decode_plain(q, k_cache, v_cache, kv_len, scale: float | None = None):
    """The plain version of ``gqa_decode`` on any device."""
    h, d = q.shape[1], q.shape[2]
    t = k_cache.shape[2]
    scale = scale if scale is not None else d ** -0.5
    k = _repeat_kv(k_cache, h).float()
    v = _repeat_kv(v_cache, h).float()
    logits = torch.einsum("bhd,bhkd->bhk", q.float(), k) * scale
    pos = torch.arange(t, device=q.device)
    logits = torch.where(pos[None, None, :] < kv_len[:, None, None], logits,
                         NEG_INF)
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhk,bhkd->bhd", w, v).to(q.dtype)


class MLAConfig(NamedTuple):
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_dim: int = 64
    qk_rope_dim: int = 32
    v_head_dim: int = 64


def mla_shapes(d_model: int, n_heads: int, cfg: MLAConfig,
               stack=()) -> dict:
    """The reference's ``mla_params`` tree as ``Leaf`` shapes, fills and
    logical names: dense leaves normal × 1/√(their first dimension) — with
    a leading ``stack`` of (L,), as the reference stacks layer leaves, that
    is L — the norms ones."""
    h, qn, qr, vd = n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    r, kv = cfg.q_lora_rank, cfg.kv_lora_rank
    return {
        "wdq": common.dense((d_model, r), ("embed", "qk"), stack=stack),
        "q_norm": common.ones((r,), ("qk",), stack=stack),
        "wuq": common.dense((r, h * (qn + qr)), ("qk", "heads"),
                            stack=stack),
        "wdkv": common.dense((d_model, kv + qr), ("embed", "qk"),
                             stack=stack),
        "kv_norm": common.ones((kv,), ("qk",), stack=stack),
        "wuk": common.dense((kv, h * qn), ("qk", "heads"), stack=stack),
        "wuv": common.dense((kv, h * vd), ("qk", "heads"), stack=stack),
        "wo": common.dense((h * vd, d_model), ("heads", "embed"),
                           stack=stack),
    }


def mla_params(gen, d_model: int, n_heads: int, cfg: MLAConfig,
               dtype=torch.float32, device="cpu", stack=()) -> dict:
    """``mla_shapes``' tree drawn from ``gen``."""
    return common.draw(mla_shapes(d_model, n_heads, cfg, stack), gen, dtype,
                       device)


def mla_latents(p, x, positions, cfg: MLAConfig):
    """What the MLA cache holds for x (B, S, d): the normed KV latent c_kv
    (B, S, kv_lora_rank) and the rotated shared rope key (B, S,
    qk_rope_dim), RoPE at the default θ."""
    dkv = x @ p["wdkv"]
    c_kv = common.rms_norm(dkv[..., :cfg.kv_lora_rank], p["kv_norm"])
    k_rope = common.rope(dkv[..., cfg.kv_lora_rank:], positions)
    return c_kv, k_rope


def mla_forward(p, x, positions, n_heads: int, cfg: MLAConfig,
                causal: bool = True, latents=None):
    """Prefill MLA of x (B, S, d_model) at ``positions`` (B, S): decompress
    K and V per head and attend (``chunked_attention``).  ``latents`` may
    pass ``mla_latents``' (c_kv, k_rope) when the caller has them."""
    b, s, _ = x.shape
    h, qn, qr, vd = n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    cq = common.rms_norm(x @ p["wdq"], p["q_norm"])
    q = common.split_last(cq @ p["wuq"], h, qn + qr)
    q_rope = common.rope(q[..., qn:].transpose(1, 2),
                         positions[:, None, :]).transpose(1, 2)
    c_kv, k_rope = latents if latents is not None else mla_latents(
        p, x, positions, cfg)
    k_nope = common.split_last(c_kv @ p["wuk"], h, qn)
    v = common.split_last(c_kv @ p["wuv"], h, vd)
    # q and k materialised as (B, S, H, qn + qr), as the reference's
    # concatenate does, and viewed as (B, H, S, .): strides the prefill
    # kernel's TMA takes; the shared rope key broadcast to every head
    qh = torch.cat([q[..., :qn], q_rope], dim=-1).transpose(1, 2)
    kh = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, qr)],
                   dim=-1).transpose(1, 2)
    out = chunked_attention(qh, kh, v.transpose(1, 2), causal=causal,
                            scale=(qn + qr) ** -0.5)
    return common.merge_last(out.transpose(1, 2)) @ p["wo"]


def mla_decode(p, x, c_cache, rope_cache, kv_len, n_heads: int,
               cfg: MLAConfig, q_pos=None):
    """Absorbed-matmul decode: the query is projected into the KV latent
    space, so attention runs against the compressed cache directly.

    x: (B, d_model) current token; c_cache: (B, S, kv_lora_rank);
    rope_cache: (B, S, qk_rope_dim); kv_len: (B,) valid cache entries
    (including the current token); q_pos: (B,) RoPE position of the query
    (default kv_len - 1, the current token's position).
    """
    b, _ = x.shape
    h, qn, qr, vd = n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    r = cfg.kv_lora_rank
    s = c_cache.shape[1]
    pos = (q_pos if q_pos is not None else kv_len - 1).float()

    cq = common.rms_norm(x @ p["wdq"], p["q_norm"])
    q = common.split_last(cq @ p["wuq"], h, qn + qr)
    q_rope = common.rope(q[..., qn:][:, :, None, :],
                         pos[:, None, None])[:, :, 0]
    # W_uk absorbed into the query: q_lat (B, H, r)
    q_lat = torch.einsum("bhn,rhn->bhr", q[..., :qn],
                         common.split_last(p["wuk"], h, qn))
    c32 = c_cache.float()
    logits = (torch.einsum("bhr,bsr->bhs", q_lat.float(), c32)
              + torch.einsum("bhr,bsr->bhs", q_rope.float(),
                             rope_cache.float()))
    logits = logits * ((qn + qr) ** -0.5)
    mask = torch.arange(s, device=x.device)[None, None, :] \
        < kv_len[:, None, None]
    w = torch.softmax(torch.where(mask, logits, NEG_INF), dim=-1)
    ctx = torch.einsum("bhs,bsr->bhr", w, c32)
    # W_uv absorbed on the way out
    out = torch.einsum("bhr,rhv->bhv", ctx.to(x.dtype),
                       common.split_last(p["wuv"], h, vd))
    return common.merge_last(out) @ p["wo"]
