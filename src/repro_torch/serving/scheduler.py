"""Stage-0 scheduler: the online side of the paper's hybrid architecture.

Receives query batches, runs the Stage-0 predictions (features + GBRT),
routes each query to the JASS or BMW replica pool (Algorithms 1/2), enforces
the ρ_max budget cap, and applies straggler mitigation:

* **hedging** — a query routed to BMW whose *predicted* time lies inside the
  uncertainty band ``[T(1-b), T(1+b)]`` around the routing threshold is
  duplicated onto the JASS mirror; the first responder wins (the JASS copy
  has a hard deadline by construction).  Queries predicted *far* above the
  band are not hedged — Algorithm 2 already routed the confidently-slow ones
  to JASS, and duplicating every slow-predicted straggler would waste a full
  JASS execution per query.
* **deadline re-route (late hedge)** — an execution that exceeds the
  detection deadline ``budget · hedge_deadline`` is re-issued to JASS with
  the dedicated small ``late_rho`` cap.  This is the mechanism that turns
  the paper's 99.99 % into a *hard* guarantee.

Guarantee accounting
--------------------
With ``B`` the scheduler budget, ``d = hedge_deadline``, ``ρ_late`` the
late-hedge cap and ``c_s``/``f_s`` the JASS per-posting/fixed costs, every
query's resolved first-stage time obeys

    t  ≤  max(B,  d·B + f_s + ρ_late·c_s)  + predict_us

term by term: a query either finishes under ``B`` on its own, or it is
detected at ``d·B`` and re-issued with at most ``ρ_late`` postings of
anytime JASS work (``f_s + ρ_late·c_s``); Stage-0 prediction cost is paid
unconditionally.  Choosing ``ρ_late`` so that
``f_s + ρ_late·c_s ≤ (1-d)·B`` collapses the bound to ``B`` exactly — that
is what :meth:`SchedulerConfig.max_late_rho` computes (per-shard under
scatter-gather: the re-issue waits for its slowest shard and pays the
fan-out/merge overhead, so the admissible ρ_late shrinks with shards) and
what
``benchmarks/bench_tail.py`` certifies (0 violations on a full trace).
With ``enforce_budget`` the same deadline re-route also covers JASS-routed
queries whose ρ cap alone does not bound them under ``B`` (large
``rho_max`` operating points), so the bound is cascade-wide, not
BMW-only.

A copy of ``repro.serving.scheduler`` (the port imports nothing of the reference
package).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core import hybrid
from repro_torch.serving.latency import CostModel


@dataclass
class SchedulerConfig:
    algorithm: int = 2                  # paper Algorithm 1 or 2
    t_k: float = 1000.0
    t_time: float = 150.0               # same units as the cost model
    rho_max: int = 1 << 20
    rho_min: int = 4096
    budget: float = 200.0
    hedge_band: float = 0.25            # hedge if pred_t in [T(1-b), T(1+b)]
    enable_hedging: bool = True
    hedge_deadline: float = 0.5         # detect stragglers at budget * this
    late_rho: int = 0                   # late-hedge re-issue ρ cap
                                        # (0 = auto: rho_min)
    enforce_budget: bool = True         # deadline re-route JASS rows too
    failover_timeout: float = 0.0       # scatter-gather shard timeout
                                        # (0 = no failover)
    max_retries: int = 0                # bounded re-issues per (query, shard)

    def resolved_late_rho(self) -> int:
        """The effective late-hedge ρ cap (``late_rho`` or ``rho_min``)."""
        return int(self.late_rho) if self.late_rho > 0 else int(self.rho_min)

    def retry_us(self) -> float:
        """Worst-case failover wait charged into the bound: each of the
        ``max_retries`` re-issues is detected after ``failover_timeout``
        (the original request's timeout is the first detection and is also
        how a lost partition is declared, so ``max_retries`` timeouts cover
        the retry cascade on top of whichever attempt finally serves)."""
        return self.max_retries * self.failover_timeout

    def max_late_rho(self, cost: CostModel, n_shards: int = 1) -> int:
        """Largest ρ_late for which the worst-case bound collapses to the
        budget itself: f_s + ρ·c_s + gather ≤ (1 - hedge_deadline)·budget.

        Under scatter-gather the late re-issue is itself sharded — its
        global level cut can land entirely on one slow shard, and the query
        still pays the per-extra-shard fan-out/merge overhead
        (``CostModel.gather_per_shard_us``) on top of that shard's
        traversal.  Budgeting the re-issue globally (``n_shards=1``) would
        let that overhead silently eat the hedge headroom, so the gather
        term is subtracted from the slack here, exactly mirroring
        :meth:`worst_case_us`.  With failover enabled the re-issue can
        additionally wait out ``max_retries`` shard timeouts before its
        serving attempt runs (:meth:`retry_us`), so that term shrinks the
        admissible ρ_late the same way."""
        slack = ((1.0 - self.hedge_deadline) * self.budget
                 - cost.saat_fixed_us
                 - cost.gather_per_shard_us * (n_shards - 1)
                 - self.retry_us())
        if cost.saat_per_posting_us <= 0:
            return self.rho_max if slack >= 0 else 0
        return max(int(slack / cost.saat_per_posting_us), 0)

    def worst_case_us(self, cost: CostModel, n_shards: int = 1) -> float:
        """The documented hard bound on any resolved first-stage latency
        (see module docstring *Guarantee accounting*)."""
        gather = cost.gather_per_shard_us * (n_shards - 1)
        late = float(cost.saat_time(np.float64(self.resolved_late_rho())))
        # with failover, any attempt (including the late re-issue) can wait
        # out max_retries shard timeouts before the serving attempt runs
        reissue = (self.budget * self.hedge_deadline + late + gather
                   + self.retry_us())
        bound = max(self.budget, reissue)
        if not self.enforce_budget:
            # JASS rows are bounded only by their ρ_max-capped traversal
            bound = max(bound,
                        float(cost.saat_time(np.float64(self.rho_max)))
                        + gather + self.retry_us())
        return bound + cost.predict_us


@dataclass
class RoutedBatch:
    jass_rows: np.ndarray
    bmw_rows: np.ndarray
    hedged_rows: np.ndarray
    k: np.ndarray
    rho: np.ndarray


class StageZeroScheduler:
    """Routes queries given Stage-0 predictions; tracks outcome stats."""

    def __init__(self, cfg: SchedulerConfig, cost: CostModel | None = None):
        self.cfg = cfg
        self.cost = cost or CostModel.paper_scale()
        self.stats = {"jass": 0, "bmw": 0, "hedged": 0, "late_hedged": 0,
                      "late_hedged_jass": 0}

    def route(self, pred_k: np.ndarray, pred_rho: np.ndarray,
              pred_t: np.ndarray) -> RoutedBatch:
        cfg = self.cfg
        hc = hybrid.HybridConfig(t_k=cfg.t_k, t_time_us=cfg.t_time,
                                 rho_max=cfg.rho_max, rho_min=cfg.rho_min)
        if cfg.algorithm == 1:
            routes = hybrid.route_algorithm1(pred_k, hc)
        else:
            routes = hybrid.route_algorithm2(pred_k, pred_t, hc)
        k, rho = hybrid.clamp_parameters(pred_k, pred_rho, hc)

        bmw = routes == hybrid.ROUTE_BMW
        jass = ~bmw
        hedged = np.zeros_like(bmw)
        if cfg.enable_hedging:
            # the documented band is two-sided: only *uncertain* predictions
            # near the threshold hedge; far-above-band queries rely on the
            # deadline re-route instead of a duplicated JASS execution
            band = ((pred_t > cfg.t_time * (1 - cfg.hedge_band))
                    & (pred_t <= cfg.t_time * (1 + cfg.hedge_band)) & bmw)
            hedged = band
        self.stats["jass"] += int(jass.sum())
        self.stats["bmw"] += int(bmw.sum())
        self.stats["hedged"] += int(hedged.sum())
        return RoutedBatch(
            jass_rows=np.flatnonzero(jass), bmw_rows=np.flatnonzero(bmw),
            hedged_rows=np.flatnonzero(hedged), k=k, rho=rho)

    def _late_hedge(self, routed: RoutedBatch, rows: np.ndarray,
                    t: np.ndarray, work_jass_fn) -> np.ndarray:
        """Deadline re-route: detect at ``budget·hedge_deadline``, re-issue
        with ``min(ρ, late_rho)`` postings of JASS work; the query finishes
        at whichever execution responds first."""
        cfg = self.cfg
        late_cap = np.minimum(routed.rho[rows], cfg.resolved_late_rho())
        tj = work_jass_fn(rows, late_cap)
        return np.minimum(t, cfg.budget * cfg.hedge_deadline + tj)

    def resolve_times(self, routed: RoutedBatch, t_bmw: np.ndarray,
                      work_jass_fn, late_jass_fn=None) -> np.ndarray:
        """Final per-query latency under hedging semantics.

        t_bmw: modeled/measured BMW time for every query (used for rows
        routed to BMW); work_jass_fn(rows, rho) -> JASS times for rows.
        Hedged BMW queries finish at min(bmw, jass); any execution that
        blows the detection deadline is late-hedged — re-issued with the
        dedicated small ``late_rho`` cap, so the worst case is bounded by
        ``budget·hedge_deadline + ρ_late·c_s`` (*Guarantee accounting* in
        the module docstring).

        ``late_jass_fn`` (defaults to ``work_jass_fn``) prices the late-
        hedge re-issue separately: under fault injection the primary
        executions run on (possibly faulted) routed replicas while the
        deadline re-issue goes to a *fresh healthy* replica, so it pays
        nominal JASS cost, not the faulted one."""
        n = len(routed.k)
        t = np.zeros(n)
        cfg = self.cfg
        if late_jass_fn is None:
            late_jass_fn = work_jass_fn
        if len(routed.jass_rows):
            rows = routed.jass_rows
            tj = work_jass_fn(rows, routed.rho[rows])
            if cfg.enforce_budget:
                late = tj > cfg.budget
                if late.any():
                    tj = tj.copy()
                    tj[late] = self._late_hedge(routed, rows[late], tj[late],
                                                late_jass_fn)
                    self.stats["late_hedged_jass"] += int(late.sum())
            t[rows] = tj
        if len(routed.bmw_rows):
            tb = t_bmw[routed.bmw_rows].copy()
            hedge_mask = np.isin(routed.bmw_rows, routed.hedged_rows)
            if hedge_mask.any():
                rows = routed.bmw_rows[hedge_mask]
                tj = work_jass_fn(rows, routed.rho[rows])
                tb[hedge_mask] = np.minimum(tb[hedge_mask],
                                            tj + self.cost.predict_us)
            # late hedge: detect at the deadline, re-issue with the SMALL
            # dedicated cap (rho_max would be a no-op after clamp_parameters)
            late = tb > cfg.budget
            if late.any():
                rows = routed.bmw_rows[late]
                tb[late] = self._late_hedge(routed, rows, tb[late],
                                            late_jass_fn)
                self.stats["late_hedged"] += int(late.sum())
            t[routed.bmw_rows] = tb
        return t + self.cost.predict_us
