"""Stage-2 query-document feature gather: the kernel wrapper, its plain
version, the plain twin of the kernel's arithmetic, and the padding entry
point the re-ranker imports.

``qd_feature_gather_lanes`` launches ``qd_feature_gather.cu`` for CUDA
tensors and runs ``qd_feature_gather_plain`` for CPU tensors. Both compute
the function of the Pallas kernel ``qd_feature_gather_lanes``
(repro/kernels/qd_feature_gather/kernel.py): per (query, candidate), the
sum of scores, the max score (from 0.0) and the count of the query's
posting lanes whose doc equals the candidate; -1 lanes and -1 candidates
never match. Both paths add a candidate's matching scores in lane order
starting from 0.0, so they agree bit for bit. ``qd_feature_gather_recorded``
is the CUDA kernel's arithmetic in PyTorch (candidate table, per-block
match records, the overflow rescan), for the tests and ``chip_smoke.py``.
"""

from __future__ import annotations

import torch

from repro_torch import kernels

LANE_MULTIPLE = 128   # candidate padding of the reference's ops layer
# the CUDA kernel's layout (qd_feature_gather.cu): a cluster of CLUSTER
# blocks per (query, group of CAND_GROUP columns), lane chunk k (CHUNK
# lanes) walked by block k % CLUSTER; RECORDS match records per (block, owner column); a
# warp sums up to WARP_RECORDS records, more matches take the rescan
CLUSTER, CAND_GROUP, CHUNK, RECORDS, WARP_RECORDS = 8, 128, 1024, 16, 32


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


def _lane_order_sums(q_idx, key, vals, n_keys: int, n_q: int, dev):
    """Per (query, key): the sum from 0.0 (added in the given order, which
    is lane order), the max from 0.0 and the count of ``vals``."""
    total = n_q * n_keys
    flat = q_idx * n_keys + key
    n = torch.zeros(total, dtype=torch.int64, device=dev)
    n.index_add_(0, flat, torch.ones_like(flat))
    order = torch.argsort(flat, stable=True)      # lane order within a key
    flat_s, vals_s = flat[order], vals[order]
    first = torch.cumsum(n, 0) - n
    rank = torch.arange(flat_s.shape[0], device=dev) - first[flat_s]
    acc = torch.zeros(total, dtype=torch.float32, device=dev)
    best = torch.zeros(total, dtype=torch.float32, device=dev)
    for r in range(int(n.max()) if total else 0):
        sel = rank == r
        v = torch.zeros(total, dtype=torch.float32, device=dev)
        v[flat_s[sel]] = vals_s[sel]
        acc = acc + v     # adds an exact 0.0 to a key without an r-th value
        best = torch.maximum(best, v)
    return (acc.view(n_q, n_keys), best.view(n_q, n_keys),
            n.view(n_q, n_keys))


def qd_feature_gather_recorded(lane_docs: torch.Tensor,
                               lane_scores: torch.Tensor,
                               cand: torch.Tensor):
    """The CUDA kernel's arithmetic in PyTorch (for the tests and
    ``chip_smoke.py``; nothing on the main path calls it).

    Per group of ``CAND_GROUP`` columns: the candidate table maps a doc to
    its owner, the lowest column holding it (-1 columns hold nothing); the
    lanes are cut into chunks of ``CHUNK``, chunk k walked by block
    k % ``CLUSTER``, and each match of a live lane is a record (lane
    position, score) of its owner in its block.  An owner whose records
    fit (at most ``RECORDS`` in every block, at most ``WARP_RECORDS`` in
    all) sums them ranked by lane position from 0.0; any other owner
    rescans all the query's lanes and adds its matches in lane order.  Every column takes its owner's sums.  Equal to
    ``qd_feature_gather_plain`` bit for bit.
    """
    q, p = lane_docs.shape
    dev = lane_docs.device
    bm25 = torch.zeros(cand.shape, dtype=torch.float32, device=dev)
    mx = torch.zeros(cand.shape, dtype=torch.float32, device=dev)
    cnt = torch.zeros(cand.shape, dtype=torch.int32, device=dev)
    docs = lane_docs.long()
    for c0 in range(0, cand.shape[1], CAND_GROUP):
        cg = cand[:, c0:c0 + CAND_GROUP].long()
        nc = cg.shape[1]
        col = torch.arange(nc, device=dev)
        # the table: each held doc's owner, the lowest column holding it
        same = (cg[:, :, None] == cg[:, None, :]) & (cg[:, :, None] >= 0)
        owner = torch.where(cg >= 0, same.to(torch.int8).argmax(dim=2), -1)
        keys = torch.where(owner == col, cg, -2)           # owners only
        ks, kcol = torch.sort(keys, dim=1)
        # one probe a live lane: the owner of its doc, if any
        at = torch.clamp(torch.searchsorted(ks, docs), max=nc - 1)
        hit = (torch.gather(ks, 1, at) == docs) & (docs >= 0)
        qi, j = torch.nonzero(hit, as_tuple=True)
        own = torch.gather(kcol, 1, at)[qi, j]
        score = lane_scores[qi, j]
        # the records of each (owner, block), and which owners fit
        per_blk = torch.zeros((q, nc, CLUSTER), dtype=torch.int64,
                              device=dev)
        per_blk.index_put_((qi, own, (j // CHUNK) % CLUSTER),
                           torch.ones_like(j), accumulate=True)
        fits = ((per_blk <= RECORDS).all(dim=2)
                & (per_blk.sum(dim=2) <= WARP_RECORDS))
        fast = fits[qi, own]
        # records ranked by lane position (nonzero lists them in lane
        # order), summed from 0.0
        acc, best, n = _lane_order_sums(qi[fast], own[fast], score[fast], nc,
                                        q, dev)
        # the rescan: every matching lane of an owner that did not fit, in
        # lane order
        r_acc, r_best, r_n = _lane_order_sums(qi[~fast], own[~fast],
                                              score[~fast], nc, q, dev)
        acc = torch.where(fits, acc, r_acc)
        best = torch.where(fits, best, r_best)
        n = torch.where(fits, n, r_n)
        src = torch.clamp(owner, min=0)
        live = owner >= 0
        bm25[:, c0:c0 + nc] = torch.where(live, torch.gather(acc, 1, src), 0.0)
        mx[:, c0:c0 + nc] = torch.where(live, torch.gather(best, 1, src), 0.0)
        cnt[:, c0:c0 + nc] = torch.where(
            live, torch.gather(n, 1, src), 0).to(torch.int32)
    return bm25, mx, cnt


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
    if q > 65535 or -(-cand.shape[1] // CAND_GROUP) > 65535:
        raise ValueError(f"{q} queries or {cand.shape[1]} candidates exceed "
                         "the grid's limits")
    # one allocation: the sum, max and count planes (the count as int32)
    out = torch.empty((3,) + tuple(cand.shape), dtype=torch.float32,
                      device=lane_docs.device)
    kernels.extension().qd_feature_gather(lane_docs, lane_scores, cand, out)
    kernels.LAUNCHES["qd_feature_gather_lanes"] += 1
    return out[0], out[1], out[2].view(torch.int32)


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
