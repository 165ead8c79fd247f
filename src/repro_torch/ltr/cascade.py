"""Batched Stage-2 of the cascade: featurize the (Q, C) candidate grid,
score every (query, candidate) row with the LTR GBRT, and select the final
top-t per query.

The selection breaks score ties toward the lower candidate rank (a stable
descending sort), the order ``lax.top_k`` gives in the reference's
``repro.ltr.cascade.rerank_batched``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import gbrt
from repro_torch.isn.backend import stable_topk
from repro_torch.ltr.ranker import LTRModel, Stage2Arrays, qd_features_batched


@dataclass
class CascadeResult:
    final: np.ndarray           # (Q, t) doc ids
    candidates_used: np.ndarray  # (Q,) candidate count entering stage 2


def rerank_batched(arrs: Stage2Arrays, ltr: LTRModel, terms, mask, topics,
                   cand, k_per_query, *, t_final: int = 10, qcap: int,
                   lane_need: int | None = None,
                   p_tile: int = 512) -> CascadeResult:
    """Batched Stage-2: re-rank every query's candidate grid.

    Args:
      arrs: ``stage2_arrays`` gather tables (on the serving device).
      terms/mask/topics: the (Q, L)/(Q,) query batch (arrays or tensors).
      cand: (Q, C) candidate doc ids (-1 padding), e.g. the Stage-1 top-k.
      k_per_query: (Q,) per-query candidate budgets; only the first k
        columns of each row enter the re-ranker.
      qcap: static lane budget (``query_lane_budget``).
      lane_need: the batch's max per-query posting total, if the caller
        already knows it; otherwise derived from ``arrs.offsets``.
    """
    dev = arrs.offsets.device
    q, c = np.shape(cand)
    if lane_need is None:
        off = arrs.offsets.cpu().numpy().astype(np.int64)
        t_np = np.asarray(terms)
        df = off[t_np + 1] - off[t_np]
        lane_need = int((df * (np.asarray(mask) > 0)).sum(axis=1).max())
    if qcap < lane_need:
        # compact_lanes silently drops lanes past qcap — refuse rather than
        # return wrong features (size qcap with query_lane_budget)
        raise ValueError(
            f"qcap={qcap} does not cover the batch's per-query posting "
            f"total ({lane_need}); size it with "
            f"repro_torch.isn.backend.query_lane_budget")
    terms_t = torch.as_tensor(np.asarray(terms), device=dev)
    mask_t = torch.as_tensor(np.asarray(mask), device=dev)
    topics_t = torch.as_tensor(np.asarray(topics), device=dev)
    cand_t = torch.as_tensor(np.asarray(cand, np.int32), device=dev)
    feats = qd_features_batched(arrs, terms_t, mask_t, topics_t, cand_t,
                                qcap=qcap, p_tile=p_tile)
    sc = gbrt.predict(ltr.model, feats.reshape(q * c, -1)).reshape(q, c)
    k_t = torch.as_tensor(np.asarray(k_per_query, np.int64), device=dev)
    valid = (cand_t >= 0) & (torch.arange(c, device=dev)[None, :]
                             < k_t[:, None])
    sc = torch.where(valid, sc, float("-inf"))
    kk = min(t_final, c)
    top_sc, order = stable_topk(sc, kk)
    picks = torch.gather(cand_t, 1, order)
    picks = torch.where(torch.isfinite(top_sc), picks, -1)
    used = valid.sum(dim=1)
    final = torch.where(used[:, None] > 0, picks, 0)
    if kk < t_final:
        final = torch.nn.functional.pad(final, (0, t_final - kk), value=-1)
        final = torch.where(used[:, None] > 0, final, 0)
    return CascadeResult(final=final.cpu().numpy().astype(np.int64),
                         candidates_used=used.cpu().numpy().astype(np.int64))
