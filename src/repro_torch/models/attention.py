"""Attention of the LM family.

* ``chunked_attention`` — online softmax over 512-wide KV chunks, so peak
  logits memory is (B, H, Sq, chunk).  For CUDA tensors it runs the
  prefill kernel (``kernels.flash_attention.ops.flash_attention``), the
  device form the reference's docstring names for it; for CPU tensors a
  loop over the chunks in place of the reference's ``lax.scan``, with q
  scaled before the dot as the reference does it.
* ``gqa_decode`` — single-token attention over a KV cache masked by
  ``kv_len``: the split-KV decode kernel (``ops.flash_decode``) for CUDA
  tensors, the reference's masked softmax for CPU tensors.
* MLA (``mla_params`` / ``mla_forward`` / ``mla_decode``) is not ported
  (ROADMAP §1 item 11); ``MLAConfig`` is copied so that configurations
  carrying it load.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import kernels
from repro_torch.kernels.flash_attention import ops as fa_ops

NEG_INF = -1e30
_MLA = "MLA attention is not ported yet (ROADMAP §1 item 11)"


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
    if not kernels.on_cpu(q, k, v):
        return fa_ops.flash_attention(q, k, v, causal=causal, scale=scale)
    return chunked_attention_plain(q, k, v, causal=causal, chunk=chunk,
                                   scale=scale)


def chunked_attention_plain(q, k, v, *, causal: bool, chunk: int = 512,
                            scale: float | None = None):
    """The plain version of ``chunked_attention`` on any device: a loop
    over ``chunk``-wide KV chunks (Sk a multiple of it)."""
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
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype)


def gqa_decode(q, k_cache, v_cache, kv_len, scale: float | None = None):
    """q: (B, H, D); caches (B, Hkv, T, D); kv_len (B,) -> (B, H, D)."""
    if not kernels.on_cpu(q, k_cache, v_cache, kv_len):
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


def mla_params(*args, **kwargs):
    raise NotImplementedError(_MLA)


def mla_forward(*args, **kwargs):
    raise NotImplementedError(_MLA)


def mla_decode(*args, **kwargs):
    raise NotImplementedError(_MLA)
