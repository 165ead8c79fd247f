"""Dense similarity top-k: the kernel wrapper, its plain version, and the
entry point the dense engine imports.

``dense_topk_tiles`` launches ``dense_topk.cu`` for CUDA tensors and runs
``dense_topk_plain`` for CPU tensors.  Both compute the function of the
Pallas kernel ``dense_topk_tiles`` (repro/kernels/dense_topk/kernel.py):
per query, the k best docs of ``q_emb @ doc_embᵀ``, score descending, ties
to the lower doc id.  On grid-quantized embeddings
(``repro_torch.dense.embeddings``) every dot product is exact in fp32 in
any order, so the two paths and the reference agree bit for bit.
"""

from __future__ import annotations

import torch

from repro_torch import kernels

CHUNK = 1024      # docs a block of the kernel's first pass scores and sorts
MAX_K = 2048      # largest k the kernel takes (its sort lists live in
                  # shared memory)


def dense_topk_plain(q_emb: torch.Tensor, doc_emb: torch.Tensor, k: int):
    """Plain PyTorch version: the full score matrix, a stable sort of the
    negated scores (ties keep the lower doc id), sliced to k."""
    scores = q_emb @ doc_emb.T
    order = torch.sort(-scores, dim=1, stable=True).indices[:, :k]
    return torch.gather(scores, 1, order), order


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
    if kernels.on_cpu(q_emb, doc_emb):
        return dense_topk_plain(q_emb, doc_emb, k)
    f32 = torch.float32
    kernels.check_cuda_args("dense_topk_tiles",
                            dict(q_emb=q_emb, doc_emb=doc_emb),
                            dict(q_emb=f32, doc_emb=f32))
    if k > MAX_K:
        raise ValueError(f"dense_topk_tiles: k={k} exceeds the kernel's "
                         f"limit of {MAX_K}")
    kp = 1 << (k - 1).bit_length()
    chunk = max(CHUNK, kp)
    n_chunks = -(-n // chunk)
    if n_chunks > 65535:
        raise ValueError(f"n_docs={n} exceeds the grid's y limit")
    q = q_emb.shape[0]
    dev = q_emb.device
    part = torch.empty((q, n_chunks, kp), dtype=torch.int64, device=dev)
    scores = torch.empty((q, k), dtype=f32, device=dev)
    ids = torch.empty((q, k), dtype=torch.int64, device=dev)
    kernels.extension().dense_topk(_aligned(q_emb), _aligned(doc_emb), part,
                                   scores, ids, chunk)
    kernels.LAUNCHES["dense_topk_tiles"] += 1
    return scores, ids


def dense_topk(q_emb, doc_emb: torch.Tensor, k: int):
    """Dense top-k over one shard's embeddings — the entry point the engine
    imports.  ``q_emb`` may be host NumPy; it is moved to ``doc_emb``'s
    device as float32.  Returns (scores, ids), each (Q, k), ids int64."""
    q_emb = torch.as_tensor(q_emb, dtype=torch.float32,
                            device=doc_emb.device).contiguous()
    return dense_topk_tiles(q_emb, doc_emb, k)
