"""``SearchSystem``: one declarative spec → a multi-shard serving cascade,
served on the card.

The port of ``repro.serving.system`` for the paper's three-stage cascade:

    spec = get_preset("paper_200ms")
    system = build_system(spec, index, corpus=corpus)   # device="cuda"
    system.set_models(models, ltr)      # converted with repro_torch.convert
    res = system.serve(ql.terms, ql.mask, ql.topic)

Stage-0 features and the stacked quantile GBRTs run on the device; the
NumPy scheduler routes each query (Algorithm 2 plus hedging); Stage-1 fans
each routed sub-batch out across every shard's SAAT or DAAT engine (the
``impact_accumulate`` and ``blockmax_score`` kernels) and merges the
per-shard top-k; Stage-2 re-ranks the merged candidates with the LTR GBRT
over the ``qd_feature_gather`` kernel.  Latency is the reference's modeled
cost (``CostModel`` on the engines' work counters), so equal counters give
equal latencies, bit for bit.

Scope: the inert-node path.  A spec that turns on a node the port does
not have yet (cache, fault schedule, dense modality, ingest, telemetry)
raises ``NotImplementedError`` naming its ROADMAP item, as do ``fit`` and
``serve_online``.  Models are fitted by the reference and converted.

Multi-shard exactness is the reference's: DAAT is rank-safe per shard, and
for SAAT the ρ budget resolves to a global impact-level cut that each shard
applies to its own slice, so the merged top-k equals the single-shard one.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from repro_torch.core import features as F
from repro_torch.core import gbrt
from repro_torch.index.builder import InvertedIndex, build_index
from repro_torch.index.corpus import Corpus
from repro_torch.index.postings import shard_from_index, shard_ranges
from repro_torch.isn.backend import (merge_shard_topk, query_lane_budget,
                                     resolve_backend, resolve_device)
from repro_torch.isn.daat import daat_serve
from repro_torch.isn.saat import saat_serve
from repro_torch.ltr.cascade import CascadeResult, rerank_batched
from repro_torch.ltr.ranker import LTRModel, stage2_arrays
from repro_torch.serving.latency import (CostModel, budget_attribution,
                                         over_budget, percentiles,
                                         resolve_level_cut, stage2_afford)
from repro_torch.serving.replicas import BMW, JASS, PoolConfig, ReplicaPool
from repro_torch.serving.scheduler import SchedulerConfig, StageZeroScheduler
from repro_torch.serving.spec import CascadeSpec, RoutingSpec

SCORE_FILL = float(np.finfo(np.float32).min)


def _unported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet "
        f"(ROADMAP.md, section 1: {item})")


@dataclass
class PipelineResult:
    """One served batch, end to end."""
    topk: np.ndarray                 # (Q, k_serve) Stage-1 candidates
    final: np.ndarray | None         # (Q, t_final) re-ranked (None: no LTR)
    candidates_used: np.ndarray | None   # (Q,) candidates entering Stage-2
    latency: np.ndarray              # (Q,) full-cascade latency
    stage_latency: dict              # {"stage0"|"stage1"|"stage2": (Q,)}
    stats: dict


def scheduler_config(routing: RoutingSpec) -> SchedulerConfig:
    """The runtime scheduler configuration a RoutingSpec describes."""
    return SchedulerConfig(
        algorithm=routing.algorithm, t_k=routing.t_k, t_time=routing.t_time,
        rho_max=routing.rho_max, rho_min=routing.rho_min,
        budget=routing.budget, hedge_band=routing.hedge_band,
        enable_hedging=routing.enable_hedging,
        hedge_deadline=routing.hedge_deadline, late_rho=routing.late_rho,
        enforce_budget=routing.enforce_budget,
        failover_timeout=routing.failover_timeout,
        max_retries=routing.max_retries)


def routing_spec(cfg: SchedulerConfig) -> RoutingSpec:
    """The RoutingSpec describing a runtime SchedulerConfig."""
    return RoutingSpec(
        algorithm=cfg.algorithm, t_k=cfg.t_k, t_time=cfg.t_time,
        rho_max=cfg.rho_max, rho_min=cfg.rho_min, budget=cfg.budget,
        hedge_band=cfg.hedge_band, enable_hedging=cfg.enable_hedging,
        hedge_deadline=cfg.hedge_deadline, late_rho=cfg.late_rho,
        enforce_budget=cfg.enforce_budget,
        failover_timeout=cfg.failover_timeout, max_retries=cfg.max_retries)


def build_system(spec: CascadeSpec, corpus_or_index, *, corpus=None,
                 models: dict | None = None, ltr: LTRModel | None = None,
                 cost: CostModel | None = None,
                 device: str | torch.device | None = None
                 ) -> "SearchSystem":
    """Instantiate the deployment a spec describes on ``device`` (the card
    unless the caller asks for the CPU; raises when no CUDA device is
    present and none is named).

    ``corpus_or_index`` is either a :class:`Corpus` (the index is built
    with the spec's ``IndexSpec``) or a pre-built :class:`InvertedIndex`
    (pass ``corpus=`` separately if Stage-2 needs doc topics).  ``models``
    (Stage-0 ``GBRTModel``s keyed "k"/"rho"/"t") and ``ltr`` come from
    ``repro_torch.convert``.
    """
    if isinstance(corpus_or_index, InvertedIndex):
        index = corpus_or_index
    elif isinstance(corpus_or_index, Corpus):
        corpus = corpus_or_index if corpus is None else corpus
        index = build_index(corpus_or_index,
                            block_size=spec.index.block_size,
                            stop_k=spec.index.stop_k)
    else:
        raise TypeError("build_system needs a Corpus or an InvertedIndex, "
                        f"got {type(corpus_or_index).__name__}")
    return SearchSystem(spec, index, corpus=corpus, models=models, ltr=ltr,
                        cost=cost, device=device)


class SearchSystem:
    """A spec-built multi-shard cascade served on one device."""

    def __init__(self, spec: CascadeSpec, index: InvertedIndex, *,
                 corpus=None, models: dict | None = None,
                 ltr: LTRModel | None = None, cost: CostModel | None = None,
                 device: str | torch.device | None = None):
        if index.block_size != spec.index.block_size:
            # the built index is ground truth for its own layout; fold it
            # back so spec.to_json() describes the deployed system
            spec = replace(spec, index=replace(spec.index,
                                               block_size=index.block_size))
        spec.validate()
        for active, what, item in (
                (spec.cache.active, "the result cache (CacheSpec)",
                 "Result cache"),
                (spec.fault.active, "fault schedules (FaultSpec)",
                 "Fault injection and failover"),
                (spec.dense.enabled, "the dense modality (DenseSpec)",
                 "Dense modality"),
                (spec.ingest.active, "live ingest (IngestSpec)",
                 "Live ingest"),
                (spec.telemetry.active, "telemetry (TelemetrySpec)",
                 "Telemetry")):
            if active:
                raise _unported(what, item)
        self.device = resolve_device(device)
        self.backend = resolve_backend(spec.backend.backend, self.device)
        self.cascade_spec = spec
        self.index = index
        self.corpus = corpus
        self.cost = cost or getattr(CostModel, spec.backend.cost)()
        self.k_serve = spec.stage2.k_serve
        self.t_final = spec.stage2.t_final
        self.budget = spec.routing.budget
        self._base_cfg = scheduler_config(spec.routing)

        # ---- shard the index into doc-range partitions ----
        self._attach_index(index)

        self.pool = ReplicaPool(
            PoolConfig(n_partitions=spec.deploy.n_shards,
                       replicas_per_partition=spec.deploy.replicas,
                       jass_fraction=spec.deploy.jass_fraction),
            seed=spec.deploy.seed)
        # the serving clock: serve() advances it by each batch's occupancy
        self._clock = 0.0
        self._batches = 0
        self._last_stats: dict = {}
        self._budget_reserve = budget_attribution(self.budget, self.cost,
                                                  None)
        self._adapt_last = {"late_hedged": 0, "bmw": 0}
        # rolling pinball loss of the t-predictor against observed BMW
        # engine times — drives the hedge_deadline adaptation
        self._pinball_ewma: float | None = None

        self.models: dict | None = None
        self.ltr: LTRModel | None = None
        self._stacked = None
        self.sched = StageZeroScheduler(self._base_cfg, self.cost)
        if models is not None:
            self.set_models(models, ltr)
        elif ltr is not None:
            raise ValueError("ltr without Stage-0 models — pass both")

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    def _attach_index(self, index: InvertedIndex) -> None:
        """Build every index-derived serving structure: doc-range shards on
        the device and the host-side df/level tables."""
        spec = self.cascade_spec
        self.index = index
        ranges = shard_ranges(index.n_docs, spec.deploy.n_shards)
        self.doc_lo = [lo for lo, _ in ranges]
        built = [shard_from_index(index, lo, hi, tile_d=spec.index.tile_d,
                                  device=self.device)
                 for lo, hi in ranges]
        self.shards = [s for s, _ in built]
        self.shard_specs = [sp for _, sp in built]
        min_docs = min(sp.n_docs for sp in self.shard_specs)
        if min_docs < self.k_serve:
            raise ValueError(
                f"k_serve={self.k_serve} exceeds the smallest shard "
                f"({min_docs} docs at n_shards={spec.deploy.n_shards}); "
                f"use fewer shards or a smaller k_serve")
        # host-side impact-level tables: the global SAAT level cut (and the
        # deterministic JASS cost) are resolved against the full collection,
        # then split per shard
        self._level_cum_host = ([index.level_cum] if len(self.shards) == 1
                                else [s.level_cum.cpu().numpy()
                                      for s in self.shards])
        self.term_stats = torch.from_numpy(
            np.ascontiguousarray(index.term_stats, np.float32)).to(self.device)
        self.df = torch.from_numpy(
            np.ascontiguousarray(index.df, np.int32)).to(self.device)

    # ------------------------------------------------------------------
    # lifecycle: attach models
    # ------------------------------------------------------------------

    def set_models(self, models: dict, ltr: LTRModel | None = None):
        """Attach Stage-0 predictors (and optionally the Stage-2 LTR model);
        rebuilds the scheduler so the cascade budget reservation matches
        the attached stages."""
        self.models = models
        try:
            self._stacked, self._stack_depth = gbrt.stack_models(
                [models[n] for n in ("k", "rho", "t")])
        except ValueError:
            self._stacked = None
        self.ltr = ltr
        cfg = self._base_cfg
        if ltr is not None:
            if self.corpus is None:
                raise ValueError("Stage-2 re-ranking needs the corpus "
                                 "(doc topic mixtures)")
            self.s2 = stage2_arrays(self.index, self.corpus, self.device)
        self._budget_reserve = budget_attribution(
            cfg.budget, self.cost, self.k_serve if ltr is not None else None)
        cfg = replace(cfg, budget=self._budget_reserve["stage1"])
        self.sched = StageZeroScheduler(cfg, self.cost)
        return self

    def fit(self, ql, labels=None, *, seed: int = 0):
        raise _unported("SearchSystem.fit (training)", "Training")

    def serve_online(self, *args, **kwargs):
        raise _unported("SearchSystem.serve_online (the online simulator)",
                        "Online serving")

    # ------------------------------------------------------------------
    # stages
    # ------------------------------------------------------------------

    def _to_device(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device)

    def stage0(self, terms: np.ndarray, mask: np.ndarray):
        """All three predictions for the batch: (pk, pr, pt) NumPy arrays."""
        if self.models is None:
            raise RuntimeError("no Stage-0 models: call set_models() first")
        x = F.extract(self.term_stats, self.df, self._to_device(terms),
                      self._to_device(mask))
        if self._stacked is not None:
            p = np.expm1(gbrt.predict_stacked(
                self._stacked, x, self._stack_depth).cpu().numpy())
            return p[0], p[1], p[2]
        return tuple(np.expm1(gbrt.predict(self.models[n], x).cpu().numpy())
                     for n in ("k", "rho", "t"))

    def _jass_split(self, terms, mask, rows, rho, cache: dict | None = None):
        """Resolve the ρ budget to the global impact-level cut and split the
        cut's work per shard.  Returns (per-shard work list, any_ok).

        ``cache`` memoizes on (rows, rho) for the duration of one served
        batch — stage-1 budgeting, hedging resolution, and pool feedback
        all ask for the same splits."""
        key = None
        if cache is not None:
            key = (np.asarray(rows).tobytes(),
                   np.asarray(rho, np.float64).tobytes())
            if key in cache:
                return cache[key]
        m = (mask[rows] > 0)[:, :, None]
        totals = [(lc[terms[rows]] * m).sum(axis=1)       # (R, n_levels)
                  for lc in self._level_cum_host]
        total_g = totals[0] if len(totals) == 1 else np.sum(totals, axis=0)
        lstar, any_ok = resolve_level_cut(total_g, rho)
        rr = np.arange(len(rows))
        work_s = [np.where(any_ok, t[rr, lstar], 0) for t in totals]
        if key is not None:
            cache[key] = (work_s, any_ok)
        return work_s, any_ok

    def _jass_time(self, terms, mask, cache: dict | None = None):
        """Deterministic JASS time under scatter-gather: each shard's slice
        of the global cut costs its own work, and the query waits for the
        slowest shard."""
        def fn(rows, rho):
            work_s, _ = self._jass_split(terms, mask, rows, rho, cache)
            t = np.stack([self.cost.saat_time(w.astype(np.float64))
                          for w in work_s])
            return self.cost.gather_time(t)
        return fn

    def _merge(self, sc_list, id_list):
        if len(sc_list) == 1:
            return id_list[0], sc_list[0]
        return merge_shard_topk(sc_list, id_list, self.k_serve)

    def _stage1_full(self, terms: np.ndarray, mask: np.ndarray, routed,
                     cache: dict | None = None):
        """Fan the routed sub-batches out across every shard's engine and
        merge the per-shard top-k.

        Returns (topk, topk_sc, t_bmw, t_shards): merged global candidates
        and their scores, the scatter-gather BMW time per query, and the
        (n_shards, Q) per-shard engine-time matrix that feeds the replica
        pool's EWMA estimates.
        """
        q = terms.shape[0]
        ns = self.n_shards
        topk = np.zeros((q, self.k_serve), np.int64)
        topk_sc = np.full((q, self.k_serve), SCORE_FILL, np.float32)
        t_bmw = np.zeros(q)
        t_shards = np.zeros((ns, q))

        if len(routed.jass_rows):
            rows = routed.jass_rows
            rho_rows = routed.rho[rows]
            if ns > 1:
                # one global level cut → per-shard budgets that reproduce
                # exactly the single-shard posting set
                work_s, any_ok = self._jass_split(terms, mask, rows,
                                                  rho_rows, cache)
                rho_per_shard = [np.where(any_ok, w, -1.0).astype(np.float64)
                                 for w in work_s]
            else:
                rho_per_shard = [rho_rows]
            t_rows = self._to_device(terms[rows])
            m_rows = self._to_device(mask[rows])
            sc_list, id_list = [], []
            for s in range(ns):
                res = saat_serve(self.shards[s], t_rows, m_rows,
                                 self._to_device(rho_per_shard[s]),
                                 n_docs=self.shard_specs[s].n_docs,
                                 k=self.k_serve,
                                 tile_d=self.shard_specs[s].tile_d)
                sc_list.append(res.topk_scores)
                id_list.append(res.topk_docs + self.doc_lo[s])
                t_shards[s, rows] = self.cost.saat_time(
                    res.work.cpu().numpy().astype(np.float64))
            ids, sc = self._merge(sc_list, id_list)
            topk[rows] = ids.cpu().numpy()
            topk_sc[rows] = sc.cpu().numpy().astype(np.float32)

        if len(routed.bmw_rows):
            rows = routed.bmw_rows
            t_rows = self._to_device(terms[rows])
            m_rows = self._to_device(mask[rows])
            theta = torch.ones(len(rows), dtype=torch.float32,
                               device=self.device)
            sc_list, id_list = [], []
            for s in range(ns):
                spec_s = self.shard_specs[s]
                res = daat_serve(self.shards[s], t_rows, m_rows, theta,
                                 n_docs=spec_s.n_docs,
                                 n_blocks=spec_s.n_blocks,
                                 block_size=spec_s.block_size,
                                 k=self.k_serve,
                                 bcap=spec_s.max_blocks_per_term,
                                 tile_d=spec_s.tile_d)
                sc_list.append(res.topk_scores)
                id_list.append(res.topk_docs + self.doc_lo[s])
                t_shards[s, rows] = self.cost.daat_time(
                    res.work.cpu().numpy(), res.blocks.cpu().numpy())
            ids, sc = self._merge(sc_list, id_list)
            topk[rows] = ids.cpu().numpy()
            topk_sc[rows] = sc.cpu().numpy().astype(np.float32)
            t_bmw[rows] = self.cost.gather_time(t_shards[:, rows])
        return topk, topk_sc, t_bmw, t_shards

    def stage2(self, terms, mask, topics, cand, k_per_query) -> CascadeResult:
        """Batched LTR re-rank of the merged Stage-1 candidate grid (the
        re-ranker sees global doc ids, so it is shard-agnostic)."""
        qcap = query_lane_budget(self.index.df, terms, mask)
        return rerank_batched(self.s2, self.ltr, terms, mask, topics,
                              cand, k_per_query, t_final=self.t_final,
                              qcap=qcap, lane_need=qcap)

    # ------------------------------------------------------------------
    # replica-pool bookkeeping
    # ------------------------------------------------------------------

    def _pool_route(self, routed, n_queries: int):
        """Pick one replica of every partition for each query (its routed
        mirror; hedged queries also occupy the JASS mirror)."""
        is_jass = np.zeros(n_queries, bool)
        is_jass[routed.jass_rows] = True
        picks = [self.pool.route_query_partial(JASS if is_jass[i] else BMW)
                 for i in range(n_queries)]
        hedge_picks = {int(i): self.pool.route_query(JASS)
                       for i in routed.hedged_rows}
        return picks, hedge_picks

    def _pool_complete(self, terms, mask, routed, picks, hedge_picks,
                       t_shards, cache: dict | None = None):
        """Feed observed per-(query, shard) latencies back into the pool."""
        for i, reps in enumerate(picks):
            if reps is None:
                continue
            for s, r in enumerate(reps):
                if r is None:
                    continue
                self.pool.complete(r, latency=float(t_shards[s, i]))
        if hedge_picks:
            rows = np.fromiter(hedge_picks, dtype=np.int64)
            work_s, _ = self._jass_split(terms, mask, rows,
                                         routed.rho[rows], cache)
            t_h = np.stack([self.cost.saat_time(w.astype(np.float64))
                            for w in work_s])
            for j, i in enumerate(rows):
                reps = hedge_picks[int(i)]
                if reps is None:
                    continue
                for s, r in enumerate(reps):
                    self.pool.complete(r, latency=float(t_h[s, j]))
        self._batches += 1
        every = self.cascade_spec.deploy.rebalance_every
        if every and self._batches % every == 0:
            n_j = len(routed.jass_rows)
            n_b = len(routed.bmw_rows)
            if n_j + n_b:
                self.pool.rebalance(n_j / (n_j + n_b))

    # ------------------------------------------------------------------
    # end to end
    # ------------------------------------------------------------------

    def serve(self, terms: np.ndarray, mask: np.ndarray,
              topics: np.ndarray | None = None, *,
              stage2_cap: np.ndarray | None = None,
              shard_cap: np.ndarray | None = None,
              now: float | None = None) -> PipelineResult:
        """Serve one batch through the full cascade.

        ``stage2_cap`` is an optional per-query hard cap on the Stage-2
        candidate grid (``0`` serves the rank-safe Stage-1 order directly).
        ``now`` pins the serving clock (default: the system's own clock,
        advanced by each batch's occupancy).  ``shard_cap`` (admission's
        partial coverage) belongs to the online path, not ported yet.
        """
        if shard_cap is not None:
            raise _unported("partial-coverage serving (shard_cap)",
                            "Online serving")
        return self._serve_direct(terms, mask, topics,
                                  stage2_cap=stage2_cap, now=now)

    def _serve_direct(self, terms: np.ndarray, mask: np.ndarray,
                      topics: np.ndarray | None = None, *,
                      stage2_cap: np.ndarray | None = None,
                      now: float | None = None) -> PipelineResult:
        """The uncached, fault-free cascade (see :meth:`serve`)."""
        terms = np.asarray(terms)
        mask = np.asarray(mask)
        q = terms.shape[0]
        now = float(self._clock if now is None else now)
        pk, pr, pt = self.stage0(terms, mask)
        routed = self.sched.route(pk, pr, pt)
        # route replicas before the engines run so the pool sees the whole
        # batch in flight (power-of-two-choices balances against inflight)
        picks, hedge_picks = self._pool_route(routed, q)

        split_cache: dict = {}
        topk, _, t_bmw, t_shards = self._stage1_full(terms, mask, routed,
                                                     split_cache)
        lat01 = self.sched.resolve_times(
            routed, t_bmw, self._jass_time(terms, mask, split_cache))
        t0 = np.full(q, self.cost.predict_us)
        stage_latency = {"stage0": t0, "stage1": lat01 - t0}

        if len(routed.bmw_rows):
            # online quantile-error signal for the t predictor: pinball
            # loss of pred_t against the observed BMW engine time — feeds
            # _adapt_routing's hedge_deadline loop
            tau = self.cascade_spec.stage0.tau_t
            e = t_bmw[routed.bmw_rows] - pt[routed.bmw_rows]
            pin = float(np.mean(np.maximum(tau * e, (tau - 1.0) * e)))
            self._pinball_ewma = (pin if self._pinball_ewma is None
                                  else 0.8 * self._pinball_ewma + 0.2 * pin)

        final = None
        used = None
        enforce = self.sched.cfg.enforce_budget
        trimmed = skipped = 0
        if self.ltr is not None:
            if topics is None:
                raise ValueError("Stage-2 re-ranking needs per-query topics")
            k2 = np.minimum(routed.k, self.k_serve)
            if stage2_cap is not None:
                k2 = np.minimum(k2, np.asarray(stage2_cap, np.int64))
            if enforce:
                # a query whose Stage-1 time already ate the budget gets
                # its candidate grid trimmed — or skipped — so ltr_time
                # cannot push it over
                afford = stage2_afford(self.cost, self.budget - lat01,
                                       self.k_serve)
                trimmed = int(np.sum((0 < afford) & (afford < k2)))
                skipped = int(np.sum((afford == 0) & (k2 > 0)))
                k2 = np.minimum(k2, afford)
            res2 = self.stage2(terms, mask, topics, topk.astype(np.int32), k2)
            final, used = res2.final, res2.candidates_used
            skip_rows = np.flatnonzero(k2 == 0)
            if len(skip_rows):
                # zero-grid queries serve their Stage-1 order directly
                final[skip_rows] = topk[skip_rows, :self.t_final]
            stage_latency["stage2"] = np.where(
                used > 0, self.cost.ltr_time(used), 0.0)
        else:
            stage_latency["stage2"] = np.zeros(q)

        self._pool_complete(terms, mask, routed, picks, hedge_picks,
                            t_shards, split_cache)
        every = self.cascade_spec.routing.adapt_every
        if every and self._batches % every == 0:
            self._adapt_routing()

        lat = lat01 + stage_latency["stage2"]
        self._clock = now + (float(lat.max()) if q else 0.0)
        stats = self._build_stats(lat, stage_latency, trimmed, skipped)
        return PipelineResult(topk=topk, final=final, candidates_used=used,
                              latency=lat, stage_latency=stage_latency,
                              stats=stats)

    def _build_stats(self, lat, stage_latency, trimmed, skipped) -> dict:
        """The per-batch stats dict (the reference's, minus the sections of
        unported nodes)."""
        stats = dict(self.sched.stats)
        stats.update(percentiles(lat))
        n_over, pct = over_budget(lat, self.budget)
        stats["over_budget"] = n_over
        stats["over_budget_pct"] = pct
        stats["stages"] = {}
        for name, t in stage_latency.items():
            if not np.any(t > 0):
                continue
            entry = percentiles(t)
            b = self._budget_reserve[name]
            entry["budget"] = b
            entry["over_budget"] = over_budget(t, b)[0]
            stats["stages"][name] = entry
        stats["budget"] = {
            "total": self.budget,
            "reserve": dict(self._budget_reserve),
            "enforce": self.sched.cfg.enforce_budget,
            "worst_case_bound": self.worst_case_us(),
            "stage2_trimmed": trimmed,
            "stage2_skipped": skipped,
        }
        stats["n_shards"] = self.n_shards
        stats["pool"] = self.pool.stats()
        self._last_stats = stats
        return stats

    def worst_case_us(self) -> float:
        """The hard analytic bound on any served query's cascade latency:
        the scheduler's Stage-1 bound (which already pays ``predict_us``)
        plus the reserved worst-case Stage-2 cost."""
        cfg = self.sched.cfg
        return (cfg.worst_case_us(self.cost, self.n_shards)
                + self._budget_reserve["stage2"])

    def _adapt_routing(self):
        """Close the routing feedback loop from pool EWMAs + scheduler
        counters (``RoutingSpec.adapt_every``): ``t_time`` tracks the
        observed mirror balance, ``hedge_band`` widens after windows that
        needed late hedges, and ``hedge_deadline`` follows the
        t-predictor's online quantile error, never past the feasibility
        ceiling.  The adapted values are folded back into
        ``cascade_spec``."""
        cfg = self.sched.cfg
        changed: dict = {}
        ewma = self.pool.mirror_ewma()
        e_j, e_b = ewma[JASS], ewma[BMW]
        if e_j is not None and e_b is not None and e_j + e_b > 0:
            alpha, b1 = 0.2, cfg.budget
            target = b1 * float(np.clip(e_j / (e_j + e_b), 0.1, 0.9))
            changed["t_time"] = float(np.clip(
                (1 - alpha) * cfg.t_time + alpha * target,
                0.05 * b1, 0.95 * b1))
        d_late = self.sched.stats["late_hedged"] \
            - self._adapt_last["late_hedged"]
        d_bmw = self.sched.stats["bmw"] - self._adapt_last["bmw"]
        self._adapt_last = {"late_hedged": self.sched.stats["late_hedged"],
                            "bmw": self.sched.stats["bmw"]}
        if d_bmw > 0:
            band = cfg.hedge_band * (1.25 if d_late > 0 else 0.98)
            changed["hedge_band"] = float(np.clip(band, 0.05, 0.5))
        if self._pinball_ewma is not None:
            late = float(self.cost.saat_time(
                np.float64(cfg.resolved_late_rho())))
            gather = self.cost.gather_per_shard_us * (self.n_shards - 1)
            d_max = (cfg.budget - late - gather) / cfg.budget
            if d_max > 0.05:
                err = self._pinball_ewma / cfg.budget
                d_target = float(np.clip(
                    d_max * (1.0 - min(2.0 * err, 0.8)), 0.05, d_max))
                changed["hedge_deadline"] = float(np.clip(
                    0.8 * cfg.hedge_deadline + 0.2 * d_target,
                    0.05, min(d_max, 1.0)))
        if changed:
            self.sched.cfg = replace(cfg, **changed)
            self._base_cfg = replace(self._base_cfg, **changed)
            self.cascade_spec = replace(
                self.cascade_spec,
                routing=replace(self.cascade_spec.routing, **changed))

    def stats(self) -> dict:
        """Deployment-level health: spec identity, shard layout, scheduler
        counters, replica-pool health, and the last batch's tail."""
        s = {
            "spec": self.cascade_spec.name,
            "device": str(self.device),
            "n_shards": self.n_shards,
            "shard_docs": [sp.n_docs for sp in self.shard_specs],
            "replicas": self.cascade_spec.deploy.replicas,
            "batches": self._batches,
            "scheduler": dict(self.sched.stats),
            "budget": {"total": self.budget,
                       "reserve": dict(self._budget_reserve),
                       "enforce": self.sched.cfg.enforce_budget,
                       "worst_case_bound": self.worst_case_us()},
            "pool": self.pool.stats(),
        }
        if self._last_stats:
            s["last_batch"] = {k: self._last_stats[k]
                               for k in ("p50", "p99", "p99.99", "max",
                                         "over_budget", "over_budget_pct")
                               if k in self._last_stats}
        return s
