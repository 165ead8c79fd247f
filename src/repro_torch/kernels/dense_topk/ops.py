"""Dense similarity top-k: the kernel wrapper, its plain version, the plain
twin of the kernel's arithmetic, and the entry point the dense engine
imports.

``dense_topk_tiles`` launches ``dense_topk.cu`` for CUDA tensors and runs
``dense_topk_plain`` for CPU tensors.  Both compute the function of the
Pallas kernel ``dense_topk_tiles`` (repro/kernels/dense_topk/kernel.py):
per query, the k best docs of ``q_emb @ doc_embᵀ``, score descending, ties
to the lower doc id.  On grid-quantized embeddings
(``repro_torch.dense.embeddings``) every dot product is exact in fp32 in
any order, so the two paths and the reference agree bit for bit.
``dense_topk_selected`` is the CUDA kernel's arithmetic in PyTorch (tile
keys, then the shared select of ``kernels.topk_select``), for the tests and
``chip_smoke.py``.
"""

from __future__ import annotations

import torch

from repro_torch import kernels
from repro_torch.kernels import topk_select

TILE_DOCS = 256   # docs a block of the kernel's first pass scores
MAX_K = topk_select.MAX_K   # largest k the kernel takes (its selection
                            # lives in one block's shared memory)


def dense_topk_plain(q_emb: torch.Tensor, doc_emb: torch.Tensor, k: int):
    """Plain PyTorch version: the full score matrix, a stable sort of the
    negated scores (ties keep the lower doc id), sliced to k."""
    scores = q_emb @ doc_emb.T
    order = torch.sort(-scores, dim=1, stable=True).indices[:, :k]
    return torch.gather(scores, 1, order), order


def score_key(scores: torch.Tensor) -> torch.Tensor:
    """The kernel's order-preserving uint32 key of f32 scores, as int64:
    unsigned order is the scores' order, -0.0 keys as +0.0."""
    u = torch.where(scores == 0, 0.0, scores).contiguous().view(
        torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(u >= 1 << 31, 0xFFFFFFFF - u, u | (1 << 31))


def key_score(key: torch.Tensor) -> torch.Tensor:
    """The f32 score of an int64-held key (``score_key``'s inverse, +0.0 for
    a zero)."""
    u = torch.where(key >= 1 << 31, key & 0x7FFFFFFF, 0xFFFFFFFF - key)
    return torch.where(u >= 1 << 31, u - (1 << 32), u).to(torch.int32).view(
        torch.float32)


def dense_topk_selected(q_emb: torch.Tensor, doc_emb: torch.Tensor, k: int):
    """The CUDA kernel's arithmetic in PyTorch (for the tests and
    ``chip_smoke.py``; nothing on the main path calls it).

    Pass 1: each tile of ``TILE_DOCS`` docs is scored against every query
    and keyed (``score_key``).  Pass 2: per query, the shared select of
    ``topk_select`` (radix rounds for the k-th key over the blocks' index
    ranges, the ordered compaction, the sort), decoded back to scores.
    Equal to ``dense_topk_plain`` bit for bit on grid-quantized embeddings.
    """
    n = doc_emb.shape[0]
    keys = torch.empty((q_emb.shape[0], n), dtype=torch.int64,
                       device=q_emb.device)
    for d0 in range(0, n, TILE_DOCS):
        keys[:, d0:d0 + TILE_DOCS] = score_key(
            q_emb @ doc_emb[d0:d0 + TILE_DOCS].T)
    sel_key, sel_idx = topk_select.topk(keys, k)
    return key_score(sel_key), sel_idx


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a contiguous tensor whose rows the kernel can read as
    float4: the width zero-padded to a multiple of 4 (zero products are
    exact) and the data 16-byte aligned."""
    pad = (-t.shape[1]) % 4
    if pad:
        t = torch.nn.functional.pad(t, (0, pad))
    if t.data_ptr() % 16:
        t = t.clone()
    return t


def dense_topk_tiles(q_emb: torch.Tensor, doc_emb: torch.Tensor, k: int):
    """Top-k of ``q_emb @ doc_embᵀ``: (scores (Q, k) f32, ids (Q, k) int64
    local to ``doc_emb``'s rows), score descending, ties to the lower id.

    Args:
      q_emb: (Q, d) float32 query embeddings.
      doc_emb: (N, d) float32 doc embeddings, ``1 <= k <= N``.
    """
    n, d = doc_emb.shape
    if q_emb.dim() != 2 or q_emb.shape[1] != d:
        raise ValueError(f"q_emb must be (Q, {d}), got {tuple(q_emb.shape)}")
    if not 1 <= k <= n:
        raise ValueError(f"k={k} must be in [1, n_docs={n}]")
    kernels.on_cpu(q_emb, doc_emb)
    return kernels.call("dense_topk", q_emb, doc_emb, k)


def check_inputs(q_emb, doc_emb, k: int, real: bool = True) -> None:
    """What the kernel refuses.  Without ``real`` (a fake's checks) not the
    device, nor the grid's Q: DTensor runs a fake at the global Q of the
    queries its strategy splits."""
    f32 = torch.float32
    kernels.check_cuda_args("dense_topk_tiles",
                            dict(q_emb=q_emb, doc_emb=doc_emb),
                            dict(q_emb=f32, doc_emb=f32), real)
    if k > MAX_K:
        raise ValueError(f"dense_topk_tiles: k={k} exceeds the kernel's "
                         f"limit of {MAX_K}")
    if real and q_emb.shape[0] > 65535:
        raise ValueError(f"Q={q_emb.shape[0]} exceeds the grid's y limit")


def _outputs(q_emb, k: int):
    q, dev = q_emb.shape[0], q_emb.device
    return (torch.empty((q, k), dtype=torch.float32, device=dev),
            torch.empty((q, k), dtype=torch.int64, device=dev))


def _launch(q_emb: torch.Tensor, doc_emb: torch.Tensor, k: int
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel 6's launch on CUDA tensors."""
    check_inputs(q_emb, doc_emb, k)
    scores, ids = _outputs(q_emb, k)
    keys = torch.empty((q_emb.shape[0], doc_emb.shape[0]), dtype=torch.int32,
                       device=q_emb.device)
    kernels.extension().dense_topk(_aligned(q_emb), _aligned(doc_emb), keys,
                                   scores, ids, 1 << (k - 1).bit_length())
    kernels.LAUNCHES["dense_topk_tiles"] += 1
    return scores, ids


def _plain(q_emb, doc_emb, k):
    return dense_topk_plain(q_emb, doc_emb, k)


def _fake(q_emb, doc_emb, k):
    check_inputs(q_emb, doc_emb, k, False)
    return _outputs(q_emb, k)


def _flops(q_emb, doc_emb, k, *args, **kwargs):
    """One FMA a (query, doc, dimension) (chip_smoke.work_of)."""
    return 2 * q_emb[0] * doc_emb[0] * q_emb[1]


def _shardings(q_emb, doc_emb, k):
    """The queries may split; the docs stay whole (a split would need a
    merge of the ranks' lists)."""
    from torch.distributed.tensor import Replicate, Shard
    return [([Replicate()] * 2, [Replicate(), Replicate(), None]),
            ([Shard(0)] * 2, [Shard(0), Replicate(), None])]


kernels.card_op("dense_topk", _launch, _plain, _fake, _flops, _shardings)


def dense_topk(q_emb, doc_emb: torch.Tensor, k: int):
    """Dense top-k over one shard's embeddings — the entry point the engine
    imports.  ``q_emb`` may be host NumPy; it is moved to ``doc_emb``'s
    device as float32.  Returns (scores, ids), each (Q, k), ids int64."""
    q_emb = torch.as_tensor(q_emb, dtype=torch.float32,
                            device=doc_emb.device).contiguous()
    return dense_topk_tiles(q_emb, doc_emb, k)
