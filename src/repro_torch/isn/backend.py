"""Shared plumbing for the batched first-stage serving pipeline.

Device and backend
------------------
The port runs on the card.  ``resolve_device(None)`` is ``cuda`` and raises
when no CUDA device is present; the plain-PyTorch path runs only when the
caller asks for the CPU by name (the tests do).  Each kernel wrapper picks
its path from the device of the tensors it is given: the hand-written CUDA
kernel for CUDA tensors, the plain version for CPU tensors.  So the
backend of a system is a function of its device alone: ``"cuda"`` (the
hand-written kernels) on the card, ``"torch"`` (the plain versions) on the
CPU.  A spec's backend field selects nothing; it may hold one of the
reference's backend names (``"pallas" | "interpret" | "jnp"``, which all
compute the same results), so that a spec shipped from the reference loads.

Tiled top-k
-----------
``topk_from_tiles`` is the hierarchical merge of the reference: per-tile
top-k over (Q, n_tiles, tile_d) accumulator tiles, then a top-k over the
per-tile candidates.  The cascade's tie rule is "lower doc id first"; it
rests on ``lax.top_k`` keeping the earliest index among equal scores.
``torch.topk`` promises no order among ties, so every top-k here is a
stable descending sort, sliced.
"""

from __future__ import annotations

import numpy as np
import torch

REFERENCE_BACKENDS = ("pallas", "interpret", "jnp")


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device a port entry point runs on: the card unless the caller
    names another device.  Never falls back to the CPU by itself."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port serves on the card; pass "
                "device='cpu' to run the plain PyTorch versions")
        return torch.device("cuda")
    return torch.device(device)


def resolve_backend(backend: str | None,
                    device: str | torch.device) -> str:
    """The serving path for ``device``: ``"cuda"`` on the card, ``"torch"``
    on the CPU.  ``backend`` is a spec's field: None or a reference backend
    name (see module docstring)."""
    if backend is not None and backend not in REFERENCE_BACKENDS:
        raise ValueError(f"backend must be None or one of "
                         f"{REFERENCE_BACKENDS}, got {backend!r}")
    return "cuda" if torch.device(device).type == "cuda" else "torch"


def query_lane_budget(df, terms, mask, round_to: int = 1024,
                      floor: int = 256) -> int:
    """Static per-query posting-lane budget for a batch (host-side helper):
    the batch's largest per-query postings total, rounded up."""
    eff = np.asarray(df)[np.asarray(terms)] * (np.asarray(mask) > 0)
    need = int(eff.sum(axis=1).max()) if eff.size else 0
    return max(-(-max(need, 1) // round_to) * round_to, floor)


def compact_lanes(base: torch.Tensor, dfs: torch.Tensor, qcap: int):
    """Compact ragged per-term posting ranges into (Q, qcap) dense lanes.

    ``base``/``dfs`` are (Q, L): the start offset and live lane count of
    each query term's postings slice.  Lane ``j`` of query ``q`` maps to the
    ``j``-th posting of the concatenated per-term prefixes (a searchsorted
    over the prefix cumsum); lanes past the query's total are dead.

    Returns (pos, live): (Q, qcap) int64 posting positions + live mask.
    """
    base = base.long()
    dfs = dfs.long()
    cum = torch.cumsum(dfs, dim=1)                           # (Q, L)
    start = cum - dfs
    j = torch.arange(qcap, dtype=torch.int64, device=base.device)
    jq = j.unsqueeze(0).expand(base.shape[0], qcap).contiguous()
    term = torch.searchsorted(cum, jq, right=True)
    term = torch.clamp(term, max=dfs.shape[1] - 1)
    within = jq - torch.gather(start, 1, term)
    pos = torch.gather(base, 1, term) + within
    live = jq < cum[:, -1:]
    return pos, live


def _lowest(dtype: torch.dtype):
    if dtype.is_floating_point:
        return torch.finfo(dtype).min
    return torch.iinfo(dtype).min


def stable_topk(x: torch.Tensor, k: int):
    """Top-k along the last axis, ties to the lower index (the order
    ``lax.top_k`` gives): a stable descending sort, sliced."""
    sc, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return sc[..., :k], idx[..., :k]


def topk_from_tiles(acc_tiles: torch.Tensor, k: int,
                    n_docs: int | None = None):
    """Hierarchical top-k over (Q, n_tiles, tile_d) accumulator tiles.

    Returns (scores, doc_ids) of shape (Q, k), ids int32 and global to the
    shard.  Matches a top-k over the flattened (Q, n_docs) accumulator
    exactly, ties to the lower doc id.  Pass ``n_docs`` when the last tile
    overhangs the shard so ghost lanes can never be selected.
    """
    q, n_tiles, tile_d = acc_tiles.shape
    dev = acc_tiles.device
    if n_docs is not None and n_tiles * tile_d > n_docs:
        gid = (torch.arange(tile_d, device=dev)[None, :]
               + (torch.arange(n_tiles, device=dev) * tile_d)[:, None])
        acc_tiles = torch.where(gid[None] < n_docs, acc_tiles,
                                torch.full((), _lowest(acc_tiles.dtype),
                                           dtype=acc_tiles.dtype,
                                           device=dev))
    kt = min(k, tile_d)
    sc_t, idx_t = stable_topk(acc_tiles, kt)                 # (Q, T, kt)
    gidx = idx_t + (torch.arange(n_tiles, device=dev) * tile_d)[None, :, None]
    sc, pos = stable_topk(sc_t.reshape(q, n_tiles * kt), k)
    ids = torch.gather(gidx.reshape(q, n_tiles * kt), 1, pos)
    return sc, ids.to(torch.int32)


def merge_shard_topk(scores: list, ids: list, k: int, drop=None):
    """Scatter-gather merge of per-shard top-k candidate lists.

    ``scores[s]`` / ``ids[s]`` are the (Q, k_s) ranked candidates of shard
    ``s`` with ids global to the collection, shards in ascending doc-range
    order.  Within a shard candidates are (score desc, doc id asc), so a
    stable merge breaks score ties toward the lower global doc id.  Returns
    (ids, scores) of shape (Q, min(k, Σ k_s)).

    ``drop`` (optional, (n_shards, Q) bool) masks out shards whose response
    was lost for a query: their candidates score dtype-min and surface with
    id ``-1``.
    """
    sc = torch.cat([torch.as_tensor(s) for s in scores], dim=1)
    di = torch.cat([torch.as_tensor(i) for i in ids], dim=1)
    if drop is not None:
        dead = torch.cat(
            [torch.as_tensor(np.asarray(drop[s]), device=sc.device)[:, None]
             .expand(scores[s].shape) for s in range(len(scores))], dim=1)
        sc = torch.where(dead, torch.full((), _lowest(sc.dtype),
                                          dtype=sc.dtype, device=sc.device),
                         sc)
        di = torch.where(dead, torch.full((), -1, dtype=di.dtype,
                                          device=di.device), di)
    top_sc, pos = stable_topk(sc, min(k, sc.shape[1]))
    return torch.gather(di, 1, pos), top_sc


def tiled_topk(acc: torch.Tensor, k: int, tile_d: int = 128):
    """Tiled top-k over a dense (Q, n_docs) accumulator; the ragged tail
    tile is padded with the dtype minimum so padding never enters the
    top-k."""
    q, n = acc.shape
    n_tiles = -(-n // tile_d)
    pad = n_tiles * tile_d - n
    if pad:
        acc = torch.nn.functional.pad(acc, (0, pad), value=_lowest(acc.dtype))
    return topk_from_tiles(acc.reshape(q, n_tiles, tile_d), k)
