"""Oracle label generation via reference lists (the paper's §3 methodology).

For every query we compute, from exhaustive runs on the synthetic collection:

* the reference list — the idealized last-stage ranking (BM25 + latent
  topical affinity over the whole collection, the stand-in for
  uogTRMQdph40);
* ``oracle_k``  — the smallest first-stage cutoff k with
  MED-RBP₀.₉₅ ≤ ε (ε = 0.001 by default, as in the paper);
* ``oracle_rho`` — the smallest JASS postings budget (from a geometric
  grid) whose top-``oracle_k`` list keeps MED-RBP ≤ ε at the fixed
  optimal k (the paper fixes k at its oracle value when labelling ρ);
* first-stage response-time labels for DAAT/BMW from the cost model —
  the prediction target for R_t.

Also applies the paper's query filtering: queries whose MED at the maximum
cutoff exceeds ``mismatch_med`` (0.5 in the paper) are dropped as
early/late-stage mismatches.

The port of ``repro.core.labels``, line for line on the host: NumPy over the
port's ``InvertedIndex``, ``Corpus``, ``QueryLog`` and ``CostModel`` and the
NumPy oracle (``repro_torch.isn.oracle``), with the reference's
``rbp_weights`` bit for bit (``repro_torch.core.reference``), so every field
of the ``LabelSet`` equals the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.reference import rbp_weights
from repro_torch.index.builder import InvertedIndex
from repro_torch.index.corpus import Corpus, QueryLog
from repro_torch.isn import oracle
from repro_torch.serving.latency import CostModel


@dataclass
class LabelConfig:
    ref_depth: int = 100
    rbp_p: float = 0.95
    eps: float = 0.001
    max_k: int = 16384
    rho_grid: tuple = (1024, 2048, 4096, 8192, 16384, 32768, 65536,
                       131072, 262144, 524288, 1048576)
    gamma: float = 6.0
    mismatch_med: float = 0.5
    time_k: int = 1000          # fixed k for the response-time labels
    batch: int = 256


@dataclass
class LabelSet:
    keep: np.ndarray            # (Q,) bool — survived mismatch filtering
    ref_lists: np.ndarray       # (Q, depth)
    oracle_k: np.ndarray        # (Q,)
    oracle_rho: np.ndarray      # (Q,)
    med_at_max: np.ndarray      # (Q,)
    work_exhaustive: np.ndarray # (Q,)
    work_bmw: np.ndarray        # (Q,) at time_k, theta=1
    blocks_bmw: np.ndarray
    t_bmw: np.ndarray           # (Q,) modeled µs
    t_exh: np.ndarray           # (Q,) modeled µs (exhaustive SAAT)
    stage1_ranks: np.ndarray | None = None  # (Q, depth) ranks of ref docs in
                                            # the exact stage-1 ranking


def _ideal_reference(index, corpus, ql, rows, acc, cfg: LabelConfig):
    """Idealized last stage over the *whole* collection: exact BM25 plus a
    latent topical affinity only the (expensive, later-stage) ranker sees."""
    aff = corpus.doc_topics[:, ql.topic[rows]].T          # (B, N)
    scale = np.maximum(acc.max(axis=1, keepdims=True), 1.0)
    ideal = acc + cfg.gamma * aff * (acc > 0) * scale / 10.0
    ids, _ = oracle._topk_ids(ideal, cfg.ref_depth)
    return ids


def _oracle_k_row(ranks, w, eps, max_k):
    """Greedy exclusion: drop ref docs from deepest stage-1 rank upward while
    the excluded RBP mass stays <= eps; k* = deepest remaining rank + 1."""
    order = np.argsort(-ranks)
    excl = np.cumsum(w[order])
    drop = excl <= eps
    kept_ranks = ranks[order][~drop]
    if len(kept_ranks) == 0:
        return 1
    k = int(kept_ranks[0]) + 1
    return min(k, max_k)


def generate_labels(index: InvertedIndex, corpus: Corpus, ql: QueryLog,
                    cfg: LabelConfig = LabelConfig(),
                    cost: CostModel | None = None,
                    verbose: bool = False) -> LabelSet:
    cost = cost or CostModel.paper_scale()
    q = ql.terms.shape[0]
    w = rbp_weights(cfg.ref_depth, cfg.rbp_p).numpy()

    ref_lists = np.zeros((q, cfg.ref_depth), np.int64)
    stage1_ranks = np.zeros((q, cfg.ref_depth), np.int64)
    oracle_k = np.zeros(q, np.int64)
    oracle_rho = np.zeros(q, np.int64)
    med_at_max = np.zeros(q, np.float64)
    work_exh = np.zeros(q, np.int64)
    work_bmw = np.zeros(q, np.int64)
    blocks_bmw = np.zeros(q, np.int64)

    for lo in range(0, q, cfg.batch):
        rows = np.arange(lo, min(lo + cfg.batch, q))
        acc, _ = oracle.exhaustive_scores(index, ql.terms, ql.mask, rows)
        ref = _ideal_reference(index, corpus, ql, rows, acc, cfg)
        ref_lists[rows] = ref
        ranks = oracle.ranks_of(acc, ref, cfg.max_k)
        stage1_ranks[rows] = ranks

        # per-query exhaustive work (for R_t features/labels)
        for i, r in enumerate(rows):
            m = ql.mask[r] > 0
            work_exh[r] = int(index.df[ql.terms[r][m]].sum())

        # oracle k + mismatch filter
        capped = np.minimum(ranks, cfg.max_k)
        for i, r in enumerate(rows):
            oracle_k[r] = _oracle_k_row(capped[i], w, cfg.eps, cfg.max_k)
            med_at_max[r] = float(np.sum(w[ranks[i] >= cfg.max_k]))

        # oracle rho at fixed k = oracle_k: smallest budget whose list shows
        # "no measurable difference" vs the *exhaustive* JASS traversal
        # (paper §5 "Predicting ρ" — the ρ reference is exhaustive JASS, so
        # quantization effects cancel)
        ref_depth_rho = min(256, index.n_docs)   # RBP mass beyond ~150 < 1e-3
        acc_exh_j, _ = oracle.jass_scores(index, ql.terms, ql.mask, rows,
                                          rho=1 << 62)
        ref_j, _ = oracle._topk_ids(acc_exh_j, ref_depth_rho)
        w_rho = rbp_weights(ref_depth_rho, cfg.rbp_p).numpy()
        pending = np.ones(len(rows), bool)
        rho_val = np.full(len(rows), cfg.rho_grid[-1], np.int64)
        for rho in cfg.rho_grid:
            if not pending.any():
                break
            accj, _ = oracle.jass_scores(index, ql.terms, ql.mask,
                                         rows[pending], rho)
            sub = np.flatnonzero(pending)
            kk = int(min(max(oracle_k[rows[sub]].max(), 1), index.n_docs))
            ids_j, _ = oracle._topk_ids(accj, kk)
            for j, si in enumerate(sub):
                r = rows[si]
                kq = int(oracle_k[r])
                depth = min(kq, ref_depth_rho)
                in_topk = np.isin(ref_j[si][:depth], ids_j[j][:kq])
                med = float(np.sum(w_rho[:depth][~in_topk]))
                if med <= cfg.eps:
                    rho_val[si] = rho
                    pending[si] = False
        oracle_rho[rows] = rho_val

        # BMW work/time labels at the paper's fixed LtR depth
        _, wb, bb = oracle.bmw_scores(index, ql.terms, ql.mask, rows,
                                      k=cfg.time_k, theta=1.0)
        work_bmw[rows] = wb
        blocks_bmw[rows] = bb
        if verbose:
            print(f"labels {rows[-1] + 1}/{q}", flush=True)

    keep = med_at_max <= cfg.mismatch_med
    return LabelSet(
        keep=keep, ref_lists=ref_lists, oracle_k=oracle_k,
        oracle_rho=oracle_rho, med_at_max=med_at_max,
        work_exhaustive=work_exh, work_bmw=work_bmw, blocks_bmw=blocks_bmw,
        t_bmw=cost.daat_time(work_bmw, blocks_bmw),
        t_exh=cost.saat_time(work_exh),
        stage1_ranks=stage1_ranks,
    )
