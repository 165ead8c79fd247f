"""SLA-aware admission control and load shedding.

The offline guarantee (``SchedulerConfig.worst_case_us`` + the Stage-2
reservation) bounds *service* time; under load the response budget also has
to pay queueing delay, and no scheduler knob can un-spend time a query
already burned in the queue.  The only correct moves are made *before*
dispatch — degrade or shed while there is still slack, never breach:

ladder (per query, at batch dispatch, from its actual wait)
-----------------------------------------------------------
With ``slack = response_budget - wait - dispatch_us`` and ``S1`` the hard
Stage-0+1 service bound (``worst_case_us`` minus the Stage-2 reserve):

1. **full**    — ``slack >= S1 + ltr_time(k_serve)``: nothing to do;
2. **trim**    — Stage-2 still fits for some smaller candidate grid:
   cap candidates at ``stage2_afford(cost, slack - S1, k_serve)``;
3. **stage1**  — ``slack >= S1`` only: serve the rank-safe Stage-1 list,
   skip Stage-2 outright (cap 0);
4. **partial** — the full scatter-gather does not fit, but a *narrower*
   one does: query only the first ``m`` partitions (``m`` the largest
   shard count whose Stage-1 bound fits the slack — each extra shard
   costs ``CostModel.gather_per_shard_us`` of merge fan-out), serving the
   rank-safe order over partial coverage.  Only reachable on multi-shard
   deployments with a nonzero gather overhead (otherwise shard count does
   not buy back any bound) — see the fault-tolerance section of the
   README;
5. **shed**    — even one partition cannot finish inside the budget:
   reject.  A rejection at arrival time (predicted wait from queue depth
   and the observed batch-occupancy EWMA) is cheaper than one at dispatch
   — the query never occupies the queue.

Every *served* query therefore satisfies
``wait + dispatch + service <= response_budget`` by construction, which is
exactly what ``benchmarks/bench_online.py`` certifies (0 violations,
queueing included) where the no-admission baseline leaks.

Cache-aware admission
---------------------
With a serving cache attached (``cache_bound`` = the hard service bound of
a guaranteed L1 hit, ``predict_us + cache_hit_us``), the ladder gains a
rung *above* full service: a query the dispatch-time peek proves is an L1
hit is admitted at FULL whenever ``slack >= cache_bound`` — a hit bypasses
the cascade, so it needs none of the Stage-1/Stage-2 reserves and consumes
(almost) no server occupancy.  The controller also learns the live hit
ratio ``h`` via EWMA (:meth:`observe_hits`) and folds it into the
*arrival-time* floor:

    floor_eff = h * cache_bound + (1 - h) * floor

i.e. the expected service bound of the mix actually being served — the
hit-ratio-adjusted capacity.  Observed capacity adapts on its own: hits
shrink real batch occupancies, and :meth:`observe_batch` folds those into
the wait estimator.  Both folds only move *predictions* (who gets
admitted); the dispatch-time guarantee still prices every non-hit row at
its full analytic bound, so 0 violations is preserved at any hit ratio —
including a sudden drop to 0 (the EWMA re-learns, dispatch never lies).

A copy of ``repro.serving.online.admission`` (the port imports nothing of
the reference package), float64 NumPy in the reference's order of
operations and with its ``1e-9`` slacks: a mode flips on one ulp.
"""

from __future__ import annotations

import numpy as np

from repro_torch.serving.latency import CostModel, stage2_afford
from repro_torch.serving.spec import OnlineSpec

# per-query service modes, in degradation order
FULL, TRIM, STAGE1, PARTIAL, SHED = 0, 1, 2, 3, 4
MODE_NAMES = {FULL: "full", TRIM: "trim", STAGE1: "stage1",
              PARTIAL: "partial", SHED: "shed"}


class AdmissionController:
    """Admission decisions from queue state + the analytic service bounds.

    ``stage1_bound`` is the hard bound on Stage-0+1 service
    (``SearchSystem.worst_case_us() - stage2 reserve``); ``k_serve`` the
    full candidate width (``None`` disables the Stage-2 rungs — a
    stage1-only deployment ladder is admit/partial/shed).

    ``partial_bounds`` (optional, ascending, length ``n_shards``) are the
    hard Stage-0+1 bounds when only ``m`` partitions are queried
    (``partial_bounds[m-1] = SchedulerConfig.worst_case_us(cost, m)``);
    they enable the partial-coverage rung.  ``None`` — or bounds that do
    not actually shrink with shard count (``gather_per_shard_us == 0``) —
    leave the rung unreachable and the ladder exactly as before.
    """

    def __init__(self, cfg: OnlineSpec, cost: CostModel,
                 stage1_bound: float, k_serve: int | None,
                 response_budget: float,
                 partial_bounds=None, cache_bound: float | None = None,
                 hit_alpha: float = 0.2):
        cfg.validate()
        if response_budget <= 0:
            raise ValueError("response_budget must be positive")
        self.cfg = cfg
        self.cost = cost
        self.stage1_bound = float(stage1_bound)
        self.k_serve = k_serve
        self.response_budget = float(response_budget)
        self._partial_bounds = None
        if partial_bounds is not None and len(partial_bounds) > 1:
            pb = np.asarray(partial_bounds, np.float64)
            if np.any(np.diff(pb) < 0):
                raise ValueError("partial_bounds must be ascending in "
                                 "shard count")
            if pb[-1] > self.stage1_bound + 1e-6:
                raise ValueError("partial_bounds[-1] (the full fan-out "
                                 "bound) must not exceed stage1_bound")
            if pb[0] < pb[-1]:         # narrowing actually buys back time
                self._partial_bounds = pb
        # the full-service bound (stage1 + worst-case Stage-2) is a run
        # constant — hoisted out of the per-arrival hot path
        self._full_bound = self.stage1_bound + (
            float(cost.ltr_time(np.asarray(k_serve)))
            if k_serve is not None else 0.0)
        # the most degraded service still offered: one-partition coverage
        # when the partial rung is live, stage1-only otherwise
        self._degrade_floor = (float(self._partial_bounds[0])
                               if self._partial_bounds is not None
                               else self.stage1_bound)
        # observed batch-occupancy EWMA for the arrival-time wait estimate;
        # starts at the conservative worst case so a cold start over-sheds
        # rather than over-admits
        self.occupancy_ewma = cfg.dispatch_us + self._full_bound
        # cache-aware rung: hard service bound of a guaranteed L1 hit
        # (None = no cache attached), and the live hit-ratio EWMA —
        # pessimistic 0 at cold start, so an empty cache changes nothing
        self.cache_bound = (float(cache_bound) if cache_bound is not None
                            else None)
        self.hit_alpha = float(hit_alpha)
        self.hit_ewma = 0.0
        self.stats = {"shed_arrival": 0, "shed_queue_cap": 0,
                      "shed_dispatch": 0, "degraded": 0, "partial": 0,
                      "admitted": 0, "cache_admitted": 0,
                      "feed_applied": 0, "feed_throttled": 0,
                      "merges_applied": 0, "merges_forced": 0,
                      "merge_deferred": 0}

    def export_metrics(self, reg) -> None:
        """Mirror the ladder's decision counters + live estimators into a
        telemetry registry."""
        for k, v in self.stats.items():
            reg.counter("admission", key=k).set_total(v)
        reg.gauge("admission_occupancy_ewma_us").set(self.occupancy_ewma)
        reg.gauge("admission_hit_ewma").set(self.hit_ewma)
        reg.gauge("response_budget_us").set(self.response_budget)
        reg.gauge("admission_stage1_bound_us").set(self.stage1_bound)

    # ------------------------------------------------------------------
    def observe_batch(self, occupancy: float, alpha: float = 0.2) -> None:
        """Fold an observed batch occupancy into the wait estimator."""
        self.occupancy_ewma = ((1 - alpha) * self.occupancy_ewma
                               + alpha * float(occupancy))

    def observe_hits(self, n_hits: int, n_lookups: int) -> None:
        """Fold one batch's L1 hit count into the hit-ratio EWMA (no-op on
        an empty batch, so padding rows never dilute the estimate)."""
        if n_lookups <= 0:
            return
        self.hit_ewma = ((1 - self.hit_alpha) * self.hit_ewma
                         + self.hit_alpha * (n_hits / n_lookups))

    def feed_gate(self, arrival: float, server_free: float,
                  queue_depth: int, pause_us: float = 0.0) -> bool:
        """Feed-vs-query backpressure: admit an ingest batch only while a
        query arriving *after* the ingest pause would still be served at
        FULL service.  The gate prices the pause into the wait estimate
        and demands the full-service bound — strictly more slack than the
        degrade floor the query shed rung needs — so the feed is throttled
        before any query degrades, and long before one sheds.  Queries
        always win the contest for server time."""
        batches_ahead = queue_depth // self.cfg.max_batch
        wait_est = (max(server_free + pause_us - arrival, 0.0)
                    + batches_ahead * self.occupancy_ewma)
        if (wait_est + self.cfg.dispatch_us + self._full_bound
                > self.response_budget):
            self.stats["feed_throttled"] += 1
            return False
        self.stats["feed_applied"] += 1
        return True

    def merge_gate(self, now: float, server_free: float,
                   queue_depth: int, *, full: bool) -> bool:
        """Background-merge backpressure: a merge reseals the index (jit
        retrace + cache flush) and occupies the server, so it only runs in
        an idle gap — empty queue, server free.  ``full=True`` (the delta
        cannot take the next due feed batch) forces it through regardless:
        deferring then would stall the feed forever, and the forced merge
        still lands *before* the queries queued behind it are priced, so
        their dispatch-time slack accounts for the pause."""
        if full:
            self.stats["merges_forced"] += 1
            self.stats["merges_applied"] += 1
            return True
        if queue_depth > 0 or server_free > now:
            self.stats["merge_deferred"] += 1
            return False
        self.stats["merges_applied"] += 1
        return True

    def at_arrival(self, arrival: float, server_free: float,
                   queue_depth: int) -> bool:
        """Admit-to-queue decision: predicted wait = residual busy time +
        the full batches already queued ahead, each costing the occupancy
        EWMA.  Shed when even stage1-only service cannot fit — the query
        would only burn queue space it cannot convert into an answer."""
        if self.cfg.queue_cap and queue_depth >= self.cfg.queue_cap:
            self.stats["shed_queue_cap"] += 1
            return False
        batches_ahead = queue_depth // self.cfg.max_batch
        wait_est = (max(server_free - arrival, 0.0)
                    + batches_ahead * self.occupancy_ewma)
        floor = (self._degrade_floor if self.cfg.degrade
                 else self._full_bound)
        if self.cache_bound is not None:
            # hit-ratio-adjusted floor: the expected service bound of the
            # mix actually served (h·hit + (1-h)·miss) — see module
            # docstring.  Prediction only; dispatch still prices every
            # non-hit at the full bound.
            floor = (self.hit_ewma * self.cache_bound
                     + (1.0 - self.hit_ewma) * floor)
        if wait_est + self.cfg.dispatch_us + floor > self.response_budget:
            self.stats["shed_arrival"] += 1
            return False
        self.stats["admitted"] += 1
        return True

    def _partial_rung(self, mode: np.ndarray, slack: np.ndarray,
                      fits_s1: np.ndarray) -> np.ndarray | None:
        """Apply the partial-coverage rung to rows the full fan-out cannot
        serve; returns the per-query shard cap (or ``None`` when the rung
        is unreachable)."""
        if self._partial_bounds is None or not self.cfg.degrade:
            return None
        ns = len(self._partial_bounds)
        # largest shard count whose Stage-1 bound fits the slack
        m = np.searchsorted(self._partial_bounds, slack + 1e-9,
                            side="right")
        part = ~fits_s1 & (m >= 1)
        mode[part] = PARTIAL
        shard_cap = np.full(len(slack), ns, np.int64)
        shard_cap[part] = np.minimum(m[part], ns - 1)
        self.stats["partial"] += int(part.sum())
        return shard_cap

    def _hit_override(self, mode: np.ndarray, slack: np.ndarray,
                      hits) -> np.ndarray | None:
        """Rows the dispatch-time cache peek *proves* are L1 hits are
        admitted at FULL whenever their slack covers the hit bound — a hit
        bypasses the cascade, so none of the Stage-1/Stage-2 reserves
        apply.  Returns the override mask (``None`` when no cache/peek).
        Un-does any rung counters the override supersedes."""
        if hits is None or self.cache_bound is None:
            return None
        hit_ok = (np.asarray(hits, bool)
                  & (slack >= self.cache_bound - 1e-9))
        if not hit_ok.any():
            return hit_ok
        self.stats["cache_admitted"] += int(np.sum(hit_ok
                                                   & (mode != FULL)))
        self.stats["partial"] -= int(np.sum(hit_ok & (mode == PARTIAL)))
        mode[hit_ok] = FULL
        return hit_ok

    def at_dispatch(self, waits: np.ndarray, hits=None
                    ) -> tuple[np.ndarray, np.ndarray | None,
                               np.ndarray | None]:
        """(mode, stage2_cap, shard_cap) per query from its *actual* wait
        at batch close.  ``stage2_cap`` is ``None`` for stage1-only
        deployments; shed rows get cap 0 (they are never served).
        ``shard_cap`` is ``None`` unless the partial-coverage rung is live
        (``partial_bounds``); partial rows serve the rank-safe Stage-1
        order over their first ``shard_cap`` partitions (stage2_cap 0).
        ``hits`` is an optional per-query bool mask of guaranteed L1 cache
        hits (``SearchSystem.cache_peek`` at the dispatch clock): those
        rows take the cache rung (see module docstring)."""
        waits = np.asarray(waits, np.float64)
        slack = self.response_budget - waits - self.cfg.dispatch_us
        mode = np.full(len(waits), SHED, np.int64)
        fits_s1 = slack >= self.stage1_bound - 1e-9
        if self.k_serve is None:
            mode[fits_s1] = FULL
            shard_cap = self._partial_rung(mode, slack, fits_s1)
            hit_ok = self._hit_override(mode, slack, hits)
            if hit_ok is not None and shard_cap is not None:
                shard_cap[hit_ok] = len(self._partial_bounds)
            self.stats["shed_dispatch"] += int(np.sum(mode == SHED))
            return mode, None, shard_cap
        afford = stage2_afford(self.cost, slack - self.stage1_bound,
                               self.k_serve)
        if not self.cfg.degrade:
            # admit/shed only: full service or nothing
            full = fits_s1 & (afford >= self.k_serve)
            mode[full] = FULL
            self._hit_override(mode, slack, hits)
            full = mode == FULL
            self.stats["shed_dispatch"] += int(np.sum(~full))
            return (mode, np.where(full, self.k_serve, 0).astype(np.int64),
                    None)
        mode[fits_s1 & (afford == 0)] = STAGE1
        mode[fits_s1 & (0 < afford) & (afford < self.k_serve)] = TRIM
        mode[fits_s1 & (afford >= self.k_serve)] = FULL
        shard_cap = self._partial_rung(mode, slack, fits_s1)
        hit_ok = self._hit_override(mode, slack, hits)
        cap = np.where(fits_s1, afford, 0).astype(np.int64)
        if hit_ok is not None:
            cap[hit_ok] = self.k_serve
            if shard_cap is not None:
                shard_cap[hit_ok] = len(self._partial_bounds)
        else:
            hit_ok = np.zeros(len(waits), bool)
        self.stats["shed_dispatch"] += int(np.sum(mode == SHED))
        self.stats["degraded"] += int(np.sum(fits_s1 & ~hit_ok
                                             & (afford < self.k_serve)))
        cap = np.minimum(np.maximum(cap, 0), self.k_serve)
        return mode, cap, shard_cap
