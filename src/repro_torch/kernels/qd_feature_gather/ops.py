"""Stage-2 query-document feature gather: the kernel wrapper, its plain
version, and the padding entry point the re-ranker imports.

``qd_feature_gather_lanes`` launches ``qd_feature_gather.cu`` for CUDA
tensors and runs ``qd_feature_gather_plain`` for CPU tensors. Both compute
the function of the Pallas kernel ``qd_feature_gather_lanes``
(repro/kernels/qd_feature_gather/kernel.py): per (query, candidate), the
sum of scores, the max score (from 0.0) and the count of the query's
posting lanes whose doc equals the candidate; -1 lanes and -1 candidates
never match. Both paths add a candidate's matching scores in lane order
starting from 0.0, so they agree bit for bit. """

from __future__ import annotations

import torch

from repro_torch import kernels

LANE_MULTIPLE = 128   # candidate padding of the reference's ops layer


def qd_feature_gather_plain(lane_docs: torch.Tensor,
                            lane_scores: torch.Tensor, cand: torch.Tensor):
    """Plain PyTorch version over the same lane layout.

    A stable sort of each query's lanes by doc keeps a doc's lanes in lane
    order; a candidate's matches are then one contiguous run, summed
    position by position (adding an exact 0.0 past a short run).
    """
    q, p = lane_docs.shape
    dev = lane_docs.device
    docs = lane_docs.long()
    big = torch.iinfo(torch.int64).max
    key = torch.where(docs >= 0, docs, big)
    sd, order = torch.sort(key, dim=1, stable=True)
    ss = torch.gather(lane_scores, 1, order)
    c = cand.long().contiguous()
    lo = torch.searchsorted(sd, c, right=False)
    hi = torch.searchsorted(sd, c, right=True)
    n = torch.where(c >= 0, hi - lo, 0)
    bm25 = torch.zeros(c.shape, dtype=torch.float32, device=dev)
    mx = torch.zeros(c.shape, dtype=torch.float32, device=dev)
    for j in range(int(n.max()) if n.numel() else 0):
        pos = torch.clamp(lo + j, max=max(p - 1, 0))
        v = torch.where(j < n, torch.gather(ss, 1, pos), 0.0)
        bm25 = bm25 + v
        mx = torch.maximum(mx, v)
    return bm25, mx, n.to(torch.int32)


def qd_feature_gather_lanes(lane_docs: torch.Tensor,
                            lane_scores: torch.Tensor, cand: torch.Tensor):
    """Per-(query, candidate) term-score aggregates over compacted lanes.

    Args:
      lane_docs: (Q, P) int32 doc ids of the query's postings, -1 dead.
      lane_scores: (Q, P) float32 exact scores, 0 in dead lanes.
      cand: (Q, C) int32 candidate doc ids, -1 padding.
    Returns:
      (bm25, mx, cnt): (Q, C) float32/float32/int32.
    """
    q, p = lane_docs.shape
    if lane_scores.shape != lane_docs.shape or cand.shape[0] != q:
        raise ValueError("lane_docs/lane_scores/cand shapes disagree")
    if kernels.on_cpu(lane_docs, lane_scores, cand):
        return qd_feature_gather_plain(lane_docs, lane_scores, cand)
    kernels.check_cuda_args(
        "qd_feature_gather_lanes",
        dict(lane_docs=lane_docs, lane_scores=lane_scores, cand=cand),
        dict(lane_docs=torch.int32, lane_scores=torch.float32,
             cand=torch.int32))
    if q > 65535:
        raise ValueError(f"{q} queries exceed the grid's y limit")
    dev = lane_docs.device
    bm25 = torch.empty(cand.shape, dtype=torch.float32, device=dev)
    mx = torch.empty(cand.shape, dtype=torch.float32, device=dev)
    cnt = torch.empty(cand.shape, dtype=torch.int32, device=dev)
    kernels.extension().qd_feature_gather(lane_docs, lane_scores, cand, bm25,
                                          mx, cnt)
    kernels.LAUNCHES["qd_feature_gather_lanes"] += 1
    return bm25, mx, cnt


def qd_feature_gather(lane_docs: torch.Tensor, lane_scores: torch.Tensor,
                      cand: torch.Tensor, *, p_tile: int = 512):
    """Pad lanes/candidates as the reference's ops layer does and dispatch.

    The lane axis is padded to a multiple of ``p_tile`` with dead lanes and
    the candidate axis to a multiple of 128 with -1 (never matched); both
    paddings are sliced back off.
    """
    q, p = lane_docs.shape
    c = cand.shape[1]
    p_pad = (-p) % p_tile if p else p_tile
    c_pad = (-c) % LANE_MULTIPLE if c else LANE_MULTIPLE
    lane_docs = lane_docs.to(torch.int32)
    lane_scores = lane_scores.to(torch.float32)
    cand = cand.to(torch.int32)
    if p_pad:
        lane_docs = torch.nn.functional.pad(lane_docs, (0, p_pad), value=-1)
        lane_scores = torch.nn.functional.pad(lane_scores, (0, p_pad))
    if c_pad:
        cand = torch.nn.functional.pad(cand, (0, c_pad), value=-1)
    bm25, mx, cnt = qd_feature_gather_lanes(
        lane_docs.contiguous(), lane_scores.contiguous(), cand.contiguous())
    return bm25[:, :c], mx[:, :c], cnt[:, :c]
