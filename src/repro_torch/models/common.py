"""Numerics shared by the LM family: RMS norm, rotary embedding, SwiGLU.

Copies of ``rms_norm``, ``rope`` and ``swiglu`` of the reference's
``models/common.py``, with its promotion order: ``rms_norm`` normalises in
fp32 and casts back to x's type before multiplying by γ; ``rope`` rotates
in fp32 and casts back.  The reference's logical-sharding helpers
(``constrain``, ``ParamFactory``'s axis names) do nothing on one device and
are not ported.
"""

from __future__ import annotations

import math

import torch


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * gamma


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding. x: (..., S, D even); positions: (..., S)."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(half, dtype=torch.float32,
                                     device=x.device) / half)
    ang = positions[..., None].float() * freqs          # (..., S, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    return (torch.nn.functional.silu(x @ w_gate) * (x @ w_up)) @ w_down
