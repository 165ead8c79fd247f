"""Gradient compression for the data-parallel all-reduce.

A port of the reference's ``train/compression.py``: per-tensor symmetric
int8 quantization with error feedback (the residual carried to the next
step), and top-k sparsification.  ``torch.round`` rounds half to even, as
``jnp.round`` does; the top-k is the port's stable one (ties to the lower
index, as ``lax.top_k``; ROADMAP rule a).
"""

from __future__ import annotations

import torch

from repro_torch.isn.backend import stable_topk
from repro_torch.train.tree import map_tree, part


def quantize_int8(g: torch.Tensor):
    """Per-tensor symmetric int8. Returns (q, scale)."""
    scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_grads(grads, error):
    """Quantize grads + carry the quantization error (error feedback).

    Returns (the tree of (q, scale) pairs, the new error tree)."""
    def one(g, e):
        g = g.float() + e
        q, s = quantize_int8(g)
        return (q, s), g - dequantize_int8(q, s)
    pairs = map_tree(one, grads, error)
    return part(pairs, 0), part(pairs, 1)


def decompress_grads(qtree):
    if isinstance(qtree, dict):
        return {k: decompress_grads(v) for k, v in qtree.items()}
    return dequantize_int8(*qtree)


def init_error(grads):
    return map_tree(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


def topk_sparsify(g: torch.Tensor, frac: float = 0.01):
    """Keep the top ``frac`` entries by magnitude (flattened), ties to the
    lower index.  Returns (values, indices, original shape) for a sparse
    all-gather."""
    flat = g.reshape(-1)
    k = max(int(flat.shape[0] * frac), 1)
    _, idx = stable_topk(flat.abs(), k)
    return flat[idx], idx, g.shape
