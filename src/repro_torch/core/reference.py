"""Reference-list comparison metrics: RBP, RBO, MED-RBP.

The paper trains its per-query predictors *without relevance judgments* by
measuring Maximized Effectiveness Difference (MED, Tan & Clarke 2015) between a
candidate first-stage list and an idealized reference ("last stage") run.

The port of ``repro.core.reference``: plain functions on tensors, batched
by broadcasting over any leading axes (the reference's ``vmap``).  Ranked
lists are integer document-id tensors; ``-1`` entries are padding and never
match a real doc.

``rbp_weights`` is bit-equal to the reference's: the label oracle compares
cumulative sums of these weights with ε = 0.001, so one ulp can flip a
label.  The reference's compiled program evaluates ``p ** rank`` as the C
library's float32 ``powf``, multiplies once by ``float32(1 - p)`` and
flushes subnormal results to zero; NumPy's and torch's float32 ``pow``
differ from ``powf`` in the last bit on some ranks.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools

import numpy as np
import torch

PAD = -1

_TINY = np.finfo(np.float32).tiny


@functools.cache
def _powf():
    """The C library's float32 ``powf``."""
    lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    fn = lib.powf
    fn.argtypes = (ctypes.c_float, ctypes.c_float)
    fn.restype = ctypes.c_float
    return fn


def _flush(x: np.ndarray) -> np.ndarray:
    """Subnormal float32 values to zero, as the reference's program does."""
    return np.where(np.abs(x) < _TINY, np.float32(0.0), x)


def _pow32(p: float, exponents) -> np.ndarray:
    """float32 ``p ** e`` for each exponent, through ``powf``."""
    powf, base = _powf(), float(np.float32(p))
    return _flush(np.array([powf(base, float(e)) for e in exponents],
                           np.float32))


def rbp_weights(depth: int, p: float) -> torch.Tensor:
    """Per-rank RBP user-model weights ``(1 - p) * p**rank`` for rank
    0..depth-1 (float32, on the CPU)."""
    w = _flush(np.float32(1.0 - p) * _pow32(p, range(depth)))
    return torch.from_numpy(w)


def rbp(gains: torch.Tensor, p: float) -> torch.Tensor:
    """Rank-biased precision of a gain vector (gains in [0, 1], rank major)."""
    w = rbp_weights(gains.shape[-1], p).to(gains.device)
    return torch.sum(gains * w, dim=-1)


def _membership_matrix(list_a: torch.Tensor,
                       list_b: torch.Tensor) -> torch.Tensor:
    """(..., len_a, len_b) bool: a[i] == b[j] and a[i] is not padding."""
    eq = list_a[..., :, None] == list_b[..., None, :]
    return eq & (list_a[..., :, None] != PAD)


def med_rbp(ref: torch.Tensor, run: torch.Tensor, p: float) -> torch.Tensor:
    """Maximized effectiveness difference MED-RBP(ref, run).

    For each document the adversary picks a binary relevance maximizing
    ``RBP(ref) - RBP(run)``.  A document at rank i contributes weight
    ``(1-p) p**i`` to whichever list contains it (0 if absent), so the max
    difference is ``sum_d max(0, w_ref(d) - w_run(d))``.  This is the
    effectiveness *loss* of ``run`` relative to the reference.
    """
    wa = rbp_weights(ref.shape[-1], p).to(ref.device)
    wb = rbp_weights(run.shape[-1], p).to(ref.device)
    m = _membership_matrix(ref, run).float()
    # weight each ref doc receives inside `run` (0 when absent)
    w_in_run = m @ wb
    valid = (ref != PAD).float()
    return torch.sum(torch.clamp(wa * valid - w_in_run, min=0.0), dim=-1)


def med_rbp_at_cutoffs(ref: torch.Tensor, stage1_rank_of_ref: torch.Tensor,
                       cutoffs: torch.Tensor, p: float) -> torch.Tensor:
    """MED-RBP of the *re-ranked candidate set* at several first-stage
    cutoffs: the RBP mass of the reference docs whose stage-1 rank is at
    least the cutoff.

    Args:
      ref: (..., depth) reference doc ids (PAD allowed).
      stage1_rank_of_ref: (..., depth) 0-based rank of each ref doc in the
        stage-1 full ranking (a large sentinel, e.g. 2**30, when absent).
      cutoffs: (c,) candidate-set sizes k.
    Returns:
      (..., c) MED-RBP loss per cutoff.
    """
    wa = rbp_weights(ref.shape[-1], p).to(ref.device) * (ref != PAD)
    lost = stage1_rank_of_ref[..., None, :] >= cutoffs[:, None]
    return torch.sum(wa[..., None, :] * lost, dim=-1)


def oracle_cutoff(ref: torch.Tensor, stage1_rank_of_ref: torch.Tensor,
                  cutoffs: torch.Tensor, p: float, eps: float
                  ) -> torch.Tensor:
    """Smallest cutoff in ``cutoffs`` (ascending) with MED-RBP <= eps,
    else the largest cutoff."""
    med = med_rbp_at_cutoffs(ref, stage1_rank_of_ref, cutoffs, p)
    ok = med <= eps
    first = torch.argmax(ok.to(torch.uint8), dim=-1)   # first True, or 0
    idx = torch.where(ok.any(dim=-1), first, cutoffs.shape[0] - 1)
    return cutoffs[idx]


def overlap(list_a: torch.Tensor, list_b: torch.Tensor) -> torch.Tensor:
    """Set overlap |A ∩ B| / |A| (padding-aware)."""
    m = _membership_matrix(list_a, list_b)
    inter = torch.sum(m.any(dim=-1).float(), dim=-1)
    size_a = torch.clamp(torch.sum((list_a != PAD).float(), dim=-1), min=1.0)
    return inter / size_a


def rbo(list_a: torch.Tensor, list_b: torch.Tensor, p: float) -> torch.Tensor:
    """Rank-biased overlap (extrapolated to the evaluated depth).

    RBO = (1-p) * sum_{d=1..D} p^{d-1} * |A_d ∩ B_d| / d   (prefix agreement)
    plus the final-depth extrapolation term  p^D * |A_D ∩ B_D| / D.
    """
    depth = list_a.shape[-1]
    m = _membership_matrix(list_a, list_b).float()
    # inter_at[d] = |A_{1..d} ∩ B_{1..d}|: 2-D prefix sum of the match matrix
    pref = torch.cumsum(torch.cumsum(m, dim=-1), dim=-2)
    inter_at = torch.diagonal(pref, dim1=-2, dim2=-1)
    d = torch.arange(1, depth + 1, dtype=torch.float32, device=m.device)
    agreement = inter_at / d
    w = torch.from_numpy(_pow32(p, range(depth))).to(m.device)
    base = float(np.float32(1.0 - p)) * torch.sum(w * agreement, dim=-1)
    extrap = float(_pow32(p, [depth])[0]) * agreement[..., -1]
    return base + extrap


def batched_med_rbp(ref: torch.Tensor, run: torch.Tensor,
                    p: float = 0.95) -> torch.Tensor:
    """``med_rbp`` of each row of (B, depth) lists."""
    return med_rbp(ref, run, p)


def batched_rbo(ref: torch.Tensor, run: torch.Tensor,
                p: float = 0.95) -> torch.Tensor:
    """``rbo`` of each row of (B, depth) lists."""
    return rbo(ref, run, p)
