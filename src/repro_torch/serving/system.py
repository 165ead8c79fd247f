"""``SearchSystem``: one declarative spec → a multi-shard serving cascade,
served on the card.

The port of ``repro.serving.system`` for the paper's three-stage cascade:

    spec = get_preset("paper_200ms")
    system = build_system(spec, index, corpus=corpus)   # device="cuda"
    labels = generate_labels(system.index, corpus, ql, cost=system.cost)
    system.fit(ql, labels, seed=0)      # labels=None: pseudo-labels; or
                                        # set_models(models, ltr) from
                                        # repro_torch.convert
    res = system.serve(ql.terms, ql.mask, ql.topic)

Stage-0 features and the stacked quantile GBRTs run on the device; the
NumPy scheduler routes each query (Algorithm 2 plus hedging); Stage-1 fans
each routed sub-batch out across every shard's SAAT or DAAT engine (the
``impact_accumulate`` and ``blockmax_score`` kernels) and merges the
per-shard top-k; Stage-2 re-ranks the merged candidates with the LTR GBRT
over the ``qd_feature_gather`` kernel.  With ``spec.dense`` on, Stage-0
also picks each query's modality: lexical, dense only (the ``dense_topk``
kernel over the embedding shards) or both, fused.  Latency is the
reference's modeled cost (``CostModel`` on the engines' work counters), so
equal counters give equal latencies, bit for bit.

Scope: the inert-node path plus the dense modality, ``fit`` from the
label oracle's labels or the reference's pseudo-labels (Stage-0 quantile
GBRTs, the LTR GBRT, the cost-model regression and the routing
calibration, fitted on the system's device bit-equal to the reference's),
online serving (``serve_online``: ``repro_torch.serving.online``'s event
loop around ``serve``, whose ``shard_cap`` serves admission's
partial-coverage rung), the two-level result cache (``spec.cache``:
``repro_torch.serving.cache`` in front of the cascade, ``cache_peek``) and
fault injection with scatter-gather failover (``spec.fault``:
``repro_torch.serving.faults``, the retry chain of ``_fault_plan``, the
health probes).  A spec that turns on a node the port does not have yet
(ingest, telemetry) raises ``NotImplementedError`` naming its ROADMAP
item.
Models fitted by the reference can also be converted
(``repro_torch.convert``); so can the two-tower model of the dense
modality (``convert.two_tower_params``), or the port draws its own.

Multi-shard exactness is the reference's: DAAT is rank-safe per shard, and
for SAAT the ρ budget resolves to a global impact-level cut that each shard
applies to its own slice, so the merged top-k equals the single-shard one.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, replace

import numpy as np
import torch

from repro_torch.core import features as F
from repro_torch.core import gbrt
from repro_torch.dense import (M_BOTH, M_DENSE, M_LEX, DenseEngine,
                               build_embeddings, fuse)
from repro_torch.index.builder import InvertedIndex, build_index
from repro_torch.index.corpus import Corpus
from repro_torch.index.postings import (ShardLayout, shard_layouts,
                                        shard_ranges, shard_to_device)
from repro_torch.isn.backend import (merge_shard_topk, query_lane_budget,
                                     resolve_backend, resolve_device)
from repro_torch.isn.daat import daat_serve
from repro_torch.isn.saat import saat_serve
from repro_torch.ltr.cascade import CascadeResult, rerank_batched
from repro_torch.ltr.ranker import (LTRModel, ltr_training_set, qd_features,
                                   stage2_arrays, train_ltr)
from repro_torch.models.recsys import TwoTower
from repro_torch.serving.cache import (HEALTHY_EPOCH, ServingCache, l1_key,
                                       l2_key, normalize_query, route_sig)
from repro_torch.serving.faults import FaultInjector
from repro_torch.serving.latency import (CostModel, budget_attribution,
                                         over_budget, percentiles,
                                         resolve_level_cut, stage2_afford)
from repro_torch.serving.replicas import BMW, JASS, PoolConfig, ReplicaPool
from repro_torch.serving.scheduler import (RoutedBatch, SchedulerConfig,
                                           StageZeroScheduler)
from repro_torch.serving.spec import CascadeSpec, RoutingSpec

SCORE_FILL = float(np.finfo(np.float32).min)


def _unported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet "
        f"(ROADMAP.md, section 1: {item})")


def refuse_unported_nodes(spec: CascadeSpec) -> None:
    """Raise ``NotImplementedError`` naming its ROADMAP item for the first
    node of ``spec`` the port does not have yet."""
    for active, what, item in (
            (spec.ingest.active, "live ingest (IngestSpec)", "Live ingest"),
            (spec.telemetry.active, "telemetry (TelemetrySpec)",
             "Telemetry")):
        if active:
            raise _unported(what, item)


@dataclass
class PipelineResult:
    """One served batch, end to end."""
    topk: np.ndarray                 # (Q, k_serve) Stage-1 candidates
    final: np.ndarray | None         # (Q, t_final) re-ranked (None: no LTR)
    candidates_used: np.ndarray | None   # (Q,) candidates entering Stage-2
    latency: np.ndarray              # (Q,) full-cascade latency
    stage_latency: dict              # {"stage0"|"stage1"|"stage2": (Q,)}
    stats: dict
    coverage: np.ndarray | None = None   # (Q,) fraction of partitions that
                                         # answered (None: full coverage,
                                         # no fault/partial path engaged)
    dense: dict | None = None        # {"modality", "theta_skip",
                                     #  "fallback"} (Q,) vectors (None:
                                     #  dense modality disabled)


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
                 tower: TwoTower | None = None,
                 device: str | torch.device | None = None,
                 layouts: list[ShardLayout] | None = None
                 ) -> "SearchSystem":
    """Instantiate the deployment a spec describes on ``device`` (the card
    unless the caller asks for the CPU; raises when no CUDA device is
    present and none is named).

    ``corpus_or_index`` is either a :class:`Corpus` (the index is built
    with the spec's ``IndexSpec``) or a pre-built :class:`InvertedIndex`
    (pass ``corpus=`` separately if Stage-2 needs doc topics).  ``models``
    (Stage-0 ``GBRTModel``s keyed "k"/"rho"/"t") and ``ltr`` come from
    another system's ``fit`` or from ``repro_torch.convert``; without them,
    call ``fit``.  ``tower`` is the dense modality's two-tower
    model (``convert.two_tower_params`` carries the reference's across);
    with none given and a two-tower embedding source, the port draws its
    own from ``DenseSpec.seed``, and its embeddings then differ from the
    reference's.  ``layouts`` are the index's shards already laid out on
    the host (``postings.shard_layouts(index, n_shards, tile_d)``), for
    callers that build several systems of one index: each build then only
    copies them to its device.
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
                        cost=cost, tower=tower, device=device,
                        layouts=layouts)


class SearchSystem:
    """A spec-built multi-shard cascade served on one device."""

    def __init__(self, spec: CascadeSpec, index: InvertedIndex, *,
                 corpus=None, models: dict | None = None,
                 ltr: LTRModel | None = None, cost: CostModel | None = None,
                 tower: TwoTower | None = None,
                 device: str | torch.device | None = None,
                 layouts: list[ShardLayout] | None = None):
        if index.block_size != spec.index.block_size:
            # the built index is ground truth for its own layout; fold it
            # back so spec.to_json() describes the deployed system
            spec = replace(spec, index=replace(spec.index,
                                               block_size=index.block_size))
        spec.validate()
        refuse_unported_nodes(spec)
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
        self._tower = tower

        # ---- shard the index (and the dense embeddings) by doc range ----
        self._attach_index(index, layouts)

        self._init_serving_state()
        self.models: dict | None = None
        self.ltr: LTRModel | None = None
        self._stacked = None
        self._init_routing()
        if models is not None:
            self.set_models(models, ltr)
        elif ltr is not None:
            raise ValueError("ltr without Stage-0 models — pass both")

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    def _init_serving_state(self) -> None:
        """The state serving moves: the replica pool, the fault injector
        (its transient-draw stream) and the serving clock, the result
        cache, the fault counters and the routing feedback."""
        spec = self.cascade_spec
        deploy = spec.deploy
        self.pool = ReplicaPool(
            PoolConfig(n_partitions=deploy.n_shards,
                       replicas_per_partition=deploy.replicas,
                       jass_fraction=deploy.jass_fraction),
            seed=deploy.seed)
        # deterministic fault injection (spec.fault; inert by default) and
        # the serving clock fault windows are evaluated against: serve()
        # advances it by each batch's occupancy; the online simulator
        # drives it explicitly (now=dispatch time)
        self.faults = FaultInjector(spec.fault, deploy.n_shards)
        self._clock = 0.0
        # the two-level result/candidate cache (spec.cache; inert by
        # default): None keeps every serve path bit-identical to the
        # uncached system
        self.cache = ServingCache(spec.cache) if spec.cache.active else None
        self._debug_shard_lists = None   # tests: set to [] to capture the
                                         # per-shard candidate lists
        self._fault_counters = {
            "retries": 0,        # failover re-issues after a shard timeout
            "transient": 0,      # attempts killed by the timeout storm
            "down_requests": 0,  # attempts sent to a crashed/outaged replica
            "lost_partitions": 0,   # (query, shard) slots lost after retries
            "no_route": 0,       # partitions with no healthy replica at all
            "degraded_queries": 0,  # queries served with partial coverage
            "probes": 0,         # health probes sent to unhealthy replicas
            "recovered": 0,      # probes that re-admitted a replica
        }
        self._batches = 0
        self._last_stats: dict = {}
        self._adapt_last = {"late_hedged": 0, "bmw": 0}
        # rolling pinball loss of the t-predictor against observed BMW
        # engine times — drives the hedge_deadline adaptation
        self._pinball_ewma: float | None = None

    def _init_routing(self) -> None:
        """The budget reservation and the scheduler for the attached
        stages: with Stage-0 models the scheduler routes on the stage-1
        share of the budget (Stage-2's reserve carved out when the LTR
        model is attached)."""
        cfg = self._base_cfg
        self._budget_reserve = self._attribute_budget(
            cfg.budget, self.k_serve if self.ltr is not None else None)
        if self.models is not None:
            cfg = replace(cfg, budget=self._budget_reserve["stage1"])
        self.sched = StageZeroScheduler(cfg, self.cost)

    def _fresh_copy(self) -> "SearchSystem":
        """The system ``build_system(self.cascade_spec, self.index,
        corpus=..., models=..., ltr=..., cost=..., tower=..., device=...)``
        builds, without building it: the serving state (pool, fault
        injector and its draws, clock, an empty cache, counters, routing
        feedback) starts anew at the live spec, and the
        structures derived from the index and the models (shards, dense
        engine, Stage-2 arrays, stacked forests), which serving only
        reads, are shared."""
        new = copy.copy(self)
        new._base_cfg = scheduler_config(self.cascade_spec.routing)
        new._init_serving_state()
        new._init_routing()
        return new

    def _attach_index(self, index: InvertedIndex,
                      layouts: list[ShardLayout] | None = None) -> None:
        """Build every index-derived serving structure: doc-range shards on
        the device (from ``layouts``, the host layouts of this index's
        shards, where given), the host-side df/level tables and the dense
        engine."""
        spec = self.cascade_spec
        self.index = index
        ranges = shard_ranges(index.n_docs, spec.deploy.n_shards)
        self.doc_lo = [lo for lo, _ in ranges]
        if layouts is None:
            layouts = shard_layouts(index, spec.deploy.n_shards,
                                    tile_d=spec.index.tile_d)
        elif ([(lay.doc_lo, lay.doc_hi, lay.spec.tile_d) for lay in layouts]
              != [(lo, hi, spec.index.tile_d) for lo, hi in ranges]):
            raise ValueError("layouts do not match the spec's shards "
                             f"{ranges} at tile_d={spec.index.tile_d}")
        built = [shard_to_device(lay, self.device) for lay in layouts]
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
                                else [lay.arrays.level_cum
                                      for lay in layouts])
        self.term_stats = torch.from_numpy(
            np.ascontiguousarray(index.term_stats, np.float32)).to(self.device)
        self.df = torch.from_numpy(
            np.ascontiguousarray(index.df, np.int32)).to(self.device)

        # ---- dense Stage-1 modality (spec.dense; None when off) ----
        # the embedding matrix is built once and partitioned by the SAME
        # doc ranges as the inverted index, so merge_shard_topk applies to
        # dense traffic unchanged
        self.dense = None
        if spec.dense.enabled:
            doc_emb, term_table = build_embeddings(
                spec.dense, corpus=self.corpus, n_docs=index.n_docs,
                vocab=int(np.asarray(index.df).shape[0]), tower=self._tower,
                device=self.device)
            self.dense = DenseEngine(doc_emb, term_table, ranges,
                                     tile_d=spec.dense.tile_d,
                                     device=self.device)

    def _attribute_budget(self, budget: float, k_serve: int | None) -> dict:
        """``budget_attribution`` plus the dense modality's fusion reserve:
        with dense enabled, ``fusion_us`` is carved out of the scheduler's
        stage-1 share, so a both-routed query — max(lexical, dense) plus
        the host-side merge — still lands inside the cascade budget."""
        reserve = budget_attribution(budget, self.cost, k_serve)
        if self.cascade_spec.dense.enabled:
            reserve["fusion"] = self.cost.fusion_us
            reserve["stage1"] = max(reserve["stage1"] - self.cost.fusion_us,
                                    0.0)
        return reserve

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
        if ltr is not None:
            if self.corpus is None:
                raise ValueError("Stage-2 re-ranking needs the corpus "
                                 "(doc topic mixtures)")
            self.s2 = stage2_arrays(self.index, self.corpus, self.device)
        self._init_routing()
        return self

    def fit(self, ql, labels=None, *, seed: int = 0) -> "SearchSystem":
        """Train the spec's Stage-0 predictors (and the Stage-2 LTR model
        when enabled) from a query log, on the system's device, in the
        reference's order of work, so the fitted forests are the
        reference's bit for bit.

        ``labels`` is a ``repro_torch.core.labels.generate_labels`` result:
        the oracle k/ρ/t targets, and the reference lists of the kept
        queries for the LTR set (``ltr_training_set``).  With
        ``spec.backend.calibrate_cost`` the labels' (work, latency) pairs
        are then regressed into the ``CostModel`` (``CostModel.regressed``;
        a rejected fit keeps the prior), and the scheduler's budget
        reservation is rebuilt on the result.  ``labels=None`` falls back
        to the reference's cheap pseudo-labels, derived from posting-list
        mass with noise from ``np.random.RandomState(seed)``, drawn in the
        reference's order.
        """
        s0 = self.cascade_spec.stage0
        x = F.extract(self.term_stats, self.df, self._to_device(ql.terms),
                      self._to_device(ql.mask))
        rng = np.random.RandomState(seed)
        if labels is not None:
            targets = {"k": labels.oracle_k, "rho": labels.oracle_rho,
                       "t": labels.t_bmw}
        else:
            eff = ((self.index.df[ql.terms] * (ql.mask > 0))
                   .sum(axis=1).astype(np.float64))
            targets = {n: eff * sc * np.exp(rng.randn(len(eff)) * 0.3)
                       for n, sc in (("k", 0.05), ("rho", 0.5),
                                     ("t", 0.002))}
        taus = {"k": s0.tau_k, "rho": s0.tau_rho, "t": s0.tau_t}
        models = {
            name: gbrt.fit(
                x, np.log1p(y.astype(np.float32)),
                gbrt.GBRTParams(n_trees=s0.n_trees, depth=s0.depth,
                                loss="quantile", tau=taus[name]),
                device=self.device)
            for name, y in targets.items()}

        ltr = None
        if self.cascade_spec.stage2.enabled:
            if self.corpus is None:
                raise ValueError("Stage-2 training needs the corpus")
            s2 = self.cascade_spec.stage2
            if labels is not None:
                rows = np.flatnonzero(labels.keep)[:s2.n_train_queries]
                lf, lg = ltr_training_set(self.index, self.corpus, ql,
                                          labels.ref_lists, rows)
            else:
                feats = []
                for q in range(min(len(ql.terms), 32)):
                    docs = rng.randint(0, self.index.n_docs, 64)
                    feats.append(qd_features(self.index, self.corpus,
                                             ql.terms[q], ql.mask[q],
                                             ql.topic[q],
                                             docs.astype(np.int64)))
                lf = np.concatenate(feats)
                lg = (lf[:, 5] + 0.2 * lf[:, 1]).astype(np.float32)
            ltr = train_ltr(lf, lg, n_trees=s2.ltr_trees, device=self.device)

        if labels is not None and self.cascade_spec.backend.calibrate_cost:
            # close the cost-model loop: regress the engine rates from the
            # label oracle's per-query (work, latency) pairs (set_models
            # below rebuilds the budget reservation on them)
            keep = labels.keep
            self.cost = self.cost.regressed(
                work_saat=labels.work_exhaustive[keep],
                t_saat=labels.t_exh[keep],
                work_daat=labels.work_bmw[keep],
                blocks_daat=labels.blocks_bmw[keep],
                t_daat=labels.t_bmw[keep])

        if self.cascade_spec.routing.calibrate:
            # route on the trained predictors' own distribution, and fold
            # the thresholds back into the spec so to_json() names the
            # operating point
            pk = np.expm1(gbrt.predict(models["k"], x).cpu().numpy())
            pt = np.expm1(gbrt.predict(models["t"], x).cpu().numpy())
            t_k = float(np.percentile(pk, 60))
            t_time = float(min(self.budget * 0.75, np.percentile(pt, 75)))
            self._base_cfg = replace(self._base_cfg, t_k=t_k, t_time=t_time)
            self.cascade_spec = replace(
                self.cascade_spec,
                routing=replace(self.cascade_spec.routing, t_k=t_k,
                                t_time=t_time))
        return self.set_models(models, ltr)

    def serve_online(self, terms: np.ndarray, mask: np.ndarray,
                     topics: np.ndarray | None = None, *,
                     traffic, online=None):
        """Serve the query log under load: event-driven arrivals
        (:class:`~repro_torch.serving.spec.TrafficSpec`), dynamic
        micro-batching, and admission control, reporting end-to-end
        **response-time** percentiles (queueing included) up to p99.99.
        Every dispatched batch is a :meth:`serve` on the system's device.

        ``online`` overrides the spec's :class:`~repro_torch.serving.spec.
        OnlineSpec`.  Returns an :class:`~repro_torch.serving.online.
        simulator.OnlineResult`."""
        from repro_torch.serving.online import simulate
        return simulate(self, terms, mask, topics, traffic, online)

    # ------------------------------------------------------------------
    # stages
    # ------------------------------------------------------------------

    def _to_device(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device)

    def stage0(self, terms: np.ndarray, mask: np.ndarray):
        """All three predictions for the batch: (pk, pr, pt) NumPy arrays."""
        if self.models is None:
            raise RuntimeError("no Stage-0 models: call fit() or "
                               "set_models() first")
        x = F.extract(self.term_stats, self.df, self._to_device(terms),
                      self._to_device(mask))
        if self._stacked is not None:
            p = np.expm1(gbrt.predict_stacked(
                self._stacked, x, self._stack_depth).cpu().numpy())
            return p[0], p[1], p[2]
        return tuple(np.expm1(gbrt.predict(self.models[n], x).cpu().numpy())
                     for n in ("k", "rho", "t"))

    def _modality(self, pt: np.ndarray) -> np.ndarray:
        """Stage-0 modality dispatch from the predicted lexical time:
        cheap queries stay lexical, predicted-expensive ones go dense only
        (the dense cost is shape-static), and the uncertainty band in
        between runs both engines and fuses."""
        ds = self.cascade_spec.dense
        td = ds.t_dense if ds.t_dense > 0 else self.sched.cfg.t_time
        m = np.full(len(pt), M_BOTH, np.int64)
        m[pt <= td * (1.0 - ds.fuse_band)] = M_LEX
        m[pt > td * (1.0 + ds.fuse_band)] = M_DENSE
        return m

    def _restrict_lexical(self, routed: RoutedBatch,
                          modality: np.ndarray) -> RoutedBatch:
        """Strip dense-only rows from a routed batch: those queries never
        touch the lexical engines, and the scheduler's mirror counters
        (which drive pool rebalance and ``_adapt_routing``) must not claim
        they did."""
        lex = modality != M_DENSE

        def keep(rows, stat):
            kept = rows[lex[rows]]
            self.sched.stats[stat] -= int(len(rows) - len(kept))
            return kept

        return replace(routed,
                       jass_rows=keep(routed.jass_rows, "jass"),
                       bmw_rows=keep(routed.bmw_rows, "bmw"),
                       hedged_rows=keep(routed.hedged_rows, "hedged"))

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

    def _merge(self, rows, sc_list, id_list, topk, topk_sc, drop):
        """Merge one route's per-shard lists into ``topk``/``topk_sc`` at
        ``rows``, the ``drop`` slots excluded."""
        if self._debug_shard_lists is not None:
            self._debug_shard_lists.append(
                (rows, [a.cpu().numpy() for a in sc_list],
                 [a.cpu().numpy() for a in id_list]))
        if len(sc_list) == 1:
            ids, sc = id_list[0], sc_list[0]
        else:
            ids, sc = merge_shard_topk(
                sc_list, id_list, self.k_serve,
                drop=None if drop is None else drop[:, rows])
        topk[rows] = ids.cpu().numpy()
        topk_sc[rows] = sc.cpu().numpy().astype(np.float32)
        if len(sc_list) == 1 and drop is not None and drop[0, rows].any():
            dead = rows[drop[0, rows]]
            topk[dead] = -1
            topk_sc[dead] = SCORE_FILL

    def _stage1_full(self, terms: np.ndarray, mask: np.ndarray, routed,
                     cache: dict | None = None, drop=None):
        """Fan the routed sub-batches out across every shard's engine and
        merge the per-shard top-k.

        Returns (topk, topk_sc, t_bmw, t_shards): merged global candidates
        and their scores (``SCORE_FILL`` marks dropped slots), the
        scatter-gather BMW time per query, and the (n_shards, Q) per-shard
        engine-time matrix that feeds the replica pool's EWMA estimates.

        ``drop`` ((n_shards, Q) bool, optional) marks (shard, query) slots
        whose response was lost (fault injection) or never requested
        (partial-coverage admission): their candidates are left out of the
        merge (``-1`` ids where fewer than ``k_serve`` survive), so a
        degraded query's list is exactly the merge over its surviving
        partitions.
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
            self._merge(rows, sc_list, id_list, topk, topk_sc, drop)

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
            self._merge(rows, sc_list, id_list, topk, topk_sc, drop)
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

    def _fault_plan(self, picks, routed, now: float):
        """Run the scatter-gather failure protocol for one batch against
        the fault schedule at clock ``now``.

        For every (query, shard) request: an attempt to a crashed/outaged
        replica — or one killed by a transient-timeout draw — is detected
        after ``failover_timeout``, reported ``ok=False`` to the pool (so
        ``fail_after`` can trip), and re-issued to a different healthy
        replica of the same partition, at most ``max_retries`` times.  When
        the chain is exhausted the slot is declared lost and the query
        degrades to partial coverage.  A slot whose pick is ``None`` (no
        healthy replica, or dropped by admission) is lost at once.

        Mutates ``picks`` in place (final serving replica, or ``None`` for
        a lost slot) and returns ``(delay, mult, lost)``: per-(shard,
        query) accumulated timeout wait, straggler slowdown of the serving
        replica, and the lost mask.  Transient draws are taken per (query,
        shard, attempt) in this loop's order, the reference's."""
        cfg = self.sched.cfg
        timeout, max_retries = cfg.failover_timeout, cfg.max_retries
        ns, q = self.n_shards, len(picks)
        delay = np.zeros((ns, q))
        mult = np.ones((ns, q))
        lost = np.zeros((ns, q), bool)
        ctr = self._fault_counters
        is_jass = np.zeros(q, bool)
        is_jass[routed.jass_rows] = True
        for i, reps in enumerate(picks):
            mirror = JASS if is_jass[i] else BMW
            for s in range(ns):
                r = reps[s]
                if r is None:            # no healthy replica to even try
                    lost[s, i] = True
                    ctr["no_route"] += 1
                    continue
                tried = {id(r)}
                failures = 0
                while True:
                    if not self.faults.is_up(s, r.replica_id, now):
                        ctr["down_requests"] += 1
                    elif self.faults.transient(now):
                        ctr["transient"] += 1
                    else:                # attempt serves
                        mult[s, i] = self.faults.slowdown(s, r.replica_id,
                                                          now)
                        reps[s] = r
                        break
                    # attempt dead: detected at the timeout, charged to the
                    # query's wait and to the replica's health record
                    self.pool.complete(r, latency=timeout, ok=False)
                    delay[s, i] += timeout
                    failures += 1
                    nxt = (self.pool.pick_retry(s, mirror, tried)
                           if failures <= max_retries else None)
                    if nxt is None:      # retry budget / pool exhausted
                        lost[s, i] = True
                        reps[s] = None
                        ctr["lost_partitions"] += 1
                        break
                    ctr["retries"] += 1
                    nxt.inflight += 1
                    tried.add(id(nxt))
                    r = nxt
        return delay, mult, lost

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
        ``shard_cap`` is an optional per-query cap on the number of
        partitions queried (admission's partial-coverage rung: query ``i``
        asks only its first ``shard_cap[i]`` partitions, trading coverage
        for gather overhead).  ``now`` pins the serving clock the fault
        schedule is evaluated against (default: the system's own clock,
        advanced by each batch's occupancy; the online simulator passes its
        dispatch time).  With an active fault schedule or a ``shard_cap``
        the result carries ``coverage`` and its stats the ``faults`` and
        ``coverage`` sections; with an inert schedule and no ``shard_cap``
        the path is bit-identical to fault-free serving.

        With an active ``CacheSpec`` every query is first looked up in the
        two-level serving cache (L1 exact results bypass the cascade, L2
        candidates skip retrieval and re-run Stage-2) and full-coverage
        results are filled back; with the cache off (the default) this
        method IS the direct cascade.
        """
        if self.cache is None:
            return self._serve_direct(terms, mask, topics,
                                      stage2_cap=stage2_cap,
                                      shard_cap=shard_cap, now=now)
        return self._serve_cached(terms, mask, topics, stage2_cap=stage2_cap,
                                  shard_cap=shard_cap, now=now)

    def _serve_direct(self, terms: np.ndarray, mask: np.ndarray,
                      topics: np.ndarray | None = None, *,
                      stage2_cap: np.ndarray | None = None,
                      shard_cap: np.ndarray | None = None,
                      now: float | None = None) -> PipelineResult:
        """The uncached cascade (see :meth:`serve` for the contract)."""
        terms = np.asarray(terms)
        mask = np.asarray(mask)
        q = terms.shape[0]
        ns = self.n_shards
        now = float(self._clock if now is None else now)
        faulted = self.faults.active or shard_cap is not None
        if self.faults.active:
            # drive recovery from the serve loop: probe unhealthy replicas
            # against the schedule (a cleared window re-admits the replica)
            probes, rec = self.pool.probe_unhealthy(
                lambda r: self.faults.is_up(r.partition, r.replica_id, now))
            self._fault_counters["probes"] += probes
            self._fault_counters["recovered"] += rec
        pk, pr, pt = self.stage0(terms, mask)
        routed = self.sched.route(pk, pr, pt)
        modality = None
        if self.dense is not None:
            # modality dispatch: dense-only rows leave the lexical
            # sub-batches entirely (their replica picks below still pin the
            # co-located partition replicas the dense engine runs on)
            modality = self._modality(pt)
            routed = self._restrict_lexical(routed, modality)
        # route replicas before the engines run so the pool sees the whole
        # batch in flight (power-of-two-choices balances against inflight)
        picks, hedge_picks = self._pool_route(routed, q)

        drop = None
        coverage = None
        if faulted:
            # admission-chosen partial coverage: the trailing partitions
            # are never requested -- release their routed picks
            dropped = np.zeros((ns, q), bool)
            if shard_cap is not None:
                cap = np.clip(np.asarray(shard_cap, np.int64), 1, ns)
                for i in range(q):
                    for s in range(int(cap[i]), ns):
                        r = picks[i][s]
                        if r is not None:
                            r.inflight = max(r.inflight - 1, 0)
                            picks[i][s] = None
                        dropped[s, i] = True
            # injected faults: timeout detection, bounded failover, loss
            delay, mult, lost = self._fault_plan(picks, routed, now)
            lost &= ~dropped
            drop = lost | dropped
            coverage = 1.0 - drop.sum(axis=0) / ns
            self._fault_counters["degraded_queries"] += int(
                (coverage < 1.0).sum())

        split_cache: dict = {}
        topk, topk_sc, t_bmw, t_shards = self._stage1_full(
            terms, mask, routed, split_cache, drop=drop)
        theta_skip, fallback, fb_extra, t_dense_mat = self._stage1_dense(
            terms, mask, routed, modality, topk, topk_sc, split_cache, drop)
        d_rows = (np.flatnonzero(modality != M_LEX)
                  if t_dense_mat is not None else None)
        if faulted:
            # per-shard completion time under the plan: a served slot pays
            # its retry wait plus its (straggler-slowed) engine time, a lost
            # slot the full detection chain, a dropped slot was never
            # requested; the query waits for its slowest slot and pays
            # merge fan-out only over the partitions that answered
            t_fault = np.where(dropped, 0.0,
                               delay + np.where(lost, 0.0, t_shards * mult))
            n_live = ns - drop.sum(axis=0)
            gather_ov = (self.cost.gather_per_shard_us
                         * np.maximum(n_live - 1, 0))

            def _gather_fault(tmat, rows):
                return tmat.max(axis=0) + gather_ov[rows]

            t_bmw = np.zeros(q)
            if len(routed.bmw_rows):
                rows = routed.bmw_rows
                t_bmw[rows] = _gather_fault(t_fault[:, rows], rows)

            def jass_fault_fn(rows, rho):
                work_s, _ = self._jass_split(terms, mask, rows, rho,
                                             split_cache)
                t = np.stack([self.cost.saat_time(w.astype(np.float64))
                              for w in work_s[:ns]])
                tf = np.where(dropped[:, rows], 0.0,
                              delay[:, rows]
                              + np.where(lost[:, rows], 0.0,
                                         t * mult[:, rows]))
                return _gather_fault(tf, rows)

            # the deadline re-issue goes to a fresh healthy replica, so it
            # pays nominal JASS cost (the retry wait it could still incur
            # is charged analytically via SchedulerConfig.retry_us())
            lat01 = self.sched.resolve_times(
                routed, t_bmw, jass_fault_fn,
                late_jass_fn=self._jass_time(terms, mask, split_cache))
            t_pool = t_fault
            if t_dense_mat is not None:
                # dense requests ride the same plan as the lexical ones
                t_dense_eff = np.where(dropped, 0.0,
                                       delay + np.where(lost, 0.0,
                                                        t_dense_mat * mult))
                t_pool = np.maximum(t_pool, t_dense_eff)
                tdr = np.zeros(q)
                tdr[d_rows] = (t_dense_eff[:, d_rows].max(axis=0)
                               + gather_ov[d_rows])
        else:
            lat01 = self.sched.resolve_times(
                routed, t_bmw, self._jass_time(terms, mask, split_cache))
            t_pool = t_shards
            if t_dense_mat is not None:
                # a partition replica hosting both engines is busy for the
                # max of its co-located work
                t_pool = np.maximum(t_pool, t_dense_mat)
                tdr = np.zeros(q)
                tdr[d_rows] = self.cost.gather_time(t_dense_mat[:, d_rows])
        if t_dense_mat is not None:
            # dense-only: predict + dense scatter-gather (+ any theta_low
            # fallback); both: the two engines run in parallel, the query
            # waits for the slower and pays the host-side fusion merge
            pd = self.cost.predict_us
            lat01 = np.where(modality == M_DENSE, pd + tdr + fb_extra, lat01)
            lat01 = np.where(modality == M_BOTH,
                             pd + np.maximum(lat01 - pd, tdr)
                             + self.cost.fusion_us, lat01)
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
            if drop is not None:
                # degraded queries may hold fewer than k_serve real
                # candidates (-1 padding from the masked merge): never ask
                # Stage-2 to rank the padding
                k2 = np.minimum(k2, (topk >= 0).sum(axis=1))
            if theta_skip.any():
                # dense confidence shortcut: the Stage-1 order is served
                # directly (rank-safe), zeroed BEFORE enforcement so these
                # rows never count as budget-driven skips
                k2 = np.where(theta_skip, 0, k2)
            if enforce:
                # a query whose Stage-1 time already ate the budget gets
                # its candidate grid trimmed — or skipped — so ltr_time
                # cannot push it over
                afford = stage2_afford(self.cost, self.budget - lat01,
                                       self.k_serve)
                trimmed = int(np.sum((0 < afford) & (afford < k2)))
                skipped = int(np.sum((afford == 0) & (k2 > 0)))
                k2 = np.minimum(k2, afford)
            cand = topk if drop is None else np.where(topk >= 0, topk, 0)
            res2 = self.stage2(terms, mask, topics, cand.astype(np.int32), k2)
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
                            t_pool, split_cache)
        every = self.cascade_spec.routing.adapt_every
        if every and self._batches % every == 0:
            self._adapt_routing()

        lat = lat01 + stage_latency["stage2"]
        self._clock = now + (float(lat.max()) if q else 0.0)
        dense_info = None
        if self.dense is not None:
            dense_info = {"modality": modality, "theta_skip": theta_skip,
                          "fallback": fallback}
        stats = self._build_stats(lat, stage_latency, trimmed, skipped,
                                  faulted, coverage, now,
                                  dense_info=dense_info)
        return PipelineResult(topk=topk, final=final, candidates_used=used,
                              latency=lat, stage_latency=stage_latency,
                              stats=stats, coverage=coverage,
                              dense=dense_info)

    def _stage1_dense(self, terms, mask, routed, modality, topk, topk_sc,
                      split_cache, drop=None):
        """The dense part of Stage-1, in place on the lexical ``topk`` and
        ``topk_sc``: dense-only rows take the dense list (over the
        partitions ``drop`` leaves), both-routed rows the fused list, and
        low-confidence dense-only rows a ρ_late-capped lexical re-issue
        (``theta_low``).

        Returns (theta_skip, fallback, fb_extra, t_dense_mat): the rows
        whose top dense score clears ``theta_high`` (Stage-2 skipped), the
        fallback rows and their extra latency, and the (n_shards, Q)
        per-shard dense time (None when no row went dense)."""
        q = terms.shape[0]
        theta_skip = np.zeros(q, bool)
        fallback = np.zeros(q, bool)
        fb_extra = np.zeros(q)
        d_rows = (np.flatnonzero(modality != M_LEX) if self.dense is not None
                  else np.zeros(0, np.int64))
        if not len(d_rows):
            return theta_skip, fallback, fb_extra, None
        ds = self.cascade_spec.dense
        q_emb = self.dense.embed(terms[d_rows], mask[d_rows])
        d_ids, d_sc = self.dense.serve(
            q_emb, self.k_serve,
            drop=None if drop is None else drop[:, d_rows])
        # shape-static per-shard dense time: every query scores every tile
        # of every shard, so the matrix is query-independent
        t_dense_mat = np.zeros((self.n_shards, q))
        for s in range(self.n_shards):
            t_dense_mat[s, d_rows] = float(
                self.cost.dense_time(self.dense.n_tiles(s)))
        dmod = modality[d_rows]
        only_rows = d_rows[dmod == M_DENSE]
        both_rows = d_rows[dmod == M_BOTH]
        topk[only_rows] = d_ids[dmod == M_DENSE]
        topk_sc[only_rows] = d_sc[dmod == M_DENSE]
        if len(both_rows):
            f_ids, f_sc = fuse(self.cascade_spec.fusion,
                               topk[both_rows], topk_sc[both_rows],
                               d_ids[dmod == M_BOTH], d_sc[dmod == M_BOTH],
                               self.k_serve)
            topk[both_rows] = f_ids
            topk_sc[both_rows] = f_sc
        top_dense = d_sc[:, 0].astype(np.float64)
        if np.isfinite(ds.theta_high):
            # high-confidence shortcut: Stage-2 is skipped rank-safely
            theta_skip[d_rows] = top_dense >= ds.theta_high
        if np.isfinite(ds.theta_low) and len(only_rows):
            fb_rows = only_rows[top_dense[dmod == M_DENSE] < ds.theta_low]
            if len(fb_rows):
                # low-confidence dense-only rows re-issue a ρ-capped lexical
                # traversal, priced like the scheduler's late hedge, so the
                # route stays inside worst_case_us
                fb_routed = RoutedBatch(
                    jass_rows=fb_rows, bmw_rows=np.zeros(0, np.int64),
                    hedged_rows=np.zeros(0, np.int64), k=routed.k,
                    rho=np.minimum(routed.rho,
                                   float(self.sched.cfg.resolved_late_rho())))
                fb_topk, fb_sc, _, fb_tsh = self._stage1_full(
                    terms, mask, fb_routed, split_cache)
                topk[fb_rows] = fb_topk[fb_rows]
                topk_sc[fb_rows] = fb_sc[fb_rows]
                fb_extra[fb_rows] = self.cost.gather_time(fb_tsh[:, fb_rows])
                fallback[fb_rows] = True
        return theta_skip, fallback, fb_extra, t_dense_mat

    # ------------------------------------------------------------------
    # result/candidate caching
    # ------------------------------------------------------------------

    def _cache_epoch(self, now: float):
        """The coverage/fault epoch cache entries are tagged with at clock
        ``now``: the per-partition reachability vector plus the transient-
        storm window flag.  Entries only hit inside the epoch they were
        filled in, so serving across a fault transition re-derives from
        the live cascade.  With an inert fault spec this is one constant,
        and no transient draw is ever consumed here.  (The reference folds
        the live-ingest counter in too; that waits for the ingest item.)"""
        if not self.faults.active:
            return HEALTHY_EPOCH
        reps = self.cascade_spec.deploy.replicas
        up = tuple(self.faults.partition_up(p, reps, now)
                   for p in range(self.n_shards))
        sp = self.faults.spec
        storm = bool(sp.timeout_p > 0
                     and sp.timeout_start <= now < sp.timeout_end)
        return up + (storm,)

    def _pure_route(self, pk, pr, pt):
        """Route a batch WITHOUT counting it: ``StageZeroScheduler.route``
        accumulates routing stats, but cache-key derivation must not double
        count rows the miss sub-batch re-routes for real."""
        saved = dict(self.sched.stats)
        routed = self.sched.route(pk, pr, pt)
        self.sched.stats.clear()
        self.sched.stats.update(saved)
        return routed

    def _route_sigs(self, terms, mask, topics):
        """Stage-0 and the uncounted route of a batch, and each row's
        normalized query and route signature: (routed, modality, qkeys,
        route sigs).  The keys are built from the host arrays."""
        q = terms.shape[0]
        pk, pr, pt = self.stage0(terms, mask)
        routed = self._pure_route(pk, pr, pt)
        # the resolved modality is part of the route: lexical, dense and
        # fused entries for the same query must never collide (with dense
        # off the suffix is b"" and keys are byte-identical)
        modality = self._modality(pt) if self.dense is not None else None
        is_jass = np.zeros(q, bool)
        is_jass[routed.jass_rows] = True
        qkeys, sigs = [], []
        for i in range(q):
            qkeys.append(normalize_query(
                terms[i], mask[i], None if topics is None else topics[i]))
            sigs.append(route_sig(bool(is_jass[i]), float(routed.rho[i]),
                                  float(routed.k[i]),
                                  b"" if modality is None
                                  else b"|M%d" % modality[i]))
        return routed, modality, qkeys, sigs

    def cache_peek(self, terms: np.ndarray, mask: np.ndarray,
                   topics: np.ndarray | None = None, *,
                   now: float | None = None) -> np.ndarray:
        """Per-query bool mask of *guaranteed* L1 hits at clock ``now`` —
        rows for which :meth:`serve` (called at the same clock, before any
        other serve) will bypass the cascade at full service.  Probes only
        the FULL-mode key (``cap = k_serve``) and mutates nothing (no
        recency moves, no stats, no RNG), so admission can peek at dispatch
        time without perturbing replay determinism."""
        terms = np.asarray(terms)
        mask = np.asarray(mask)
        out = np.zeros(terms.shape[0], bool)
        if self.cache is None or self.cache.l1 is None:
            return out
        now = float(self._clock if now is None else now)
        epoch = self._cache_epoch(now)
        _, _, qkeys, sigs = self._route_sigs(terms, mask, topics)
        for i, (qk, rs) in enumerate(zip(qkeys, sigs)):
            out[i] = self.cache.l1_contains(
                l1_key(qk, rs, self.k_serve, self.t_final, self.k_serve),
                epoch)
        return out

    def _serve_cached(self, terms: np.ndarray, mask: np.ndarray,
                      topics: np.ndarray | None = None, *,
                      stage2_cap: np.ndarray | None = None,
                      shard_cap: np.ndarray | None = None,
                      now: float | None = None) -> PipelineResult:
        """serve() with the two-level cache in front of the cascade.

        Per query: L1 hit → the cached (topk, final, used) row at
        ``predict_us + cache_hit_us``; L2 hit → cached Stage-1 candidates,
        fresh Stage-2 re-rank; miss → the full cascade via
        :meth:`_serve_direct` on the miss sub-batch (the kernels' rows do
        not depend on their neighbours, so sub-batch results equal the
        full-batch ones bit for bit).  Every query pays the
        ``cache_hit_us`` lookup — the term :meth:`worst_case_us` charges.

        Rows admitted at partial coverage (``shard_cap < n_shards``) bypass
        the cache, results with ``coverage < 1`` are never filled, and
        every entry carries the fill-time fault epoch
        (:meth:`_cache_epoch`).  Cached values are host NumPy copies."""
        terms = np.asarray(terms)
        mask = np.asarray(mask)
        q = terms.shape[0]
        ns = self.n_shards
        now = float(self._clock if now is None else now)
        cache = self.cache
        epoch = self._cache_epoch(now)
        routed, modality, qkeys, sigs = self._route_sigs(terms, mask, topics)

        cap = np.full(q, self.k_serve, np.int64)
        if stage2_cap is not None:
            cap = np.minimum(np.asarray(stage2_cap, np.int64), self.k_serve)
        # the partial-coverage rung deliberately queries fewer partitions:
        # those rows neither look up nor fill (a full-coverage cached
        # result would silently upgrade the admission decision)
        eligible = (np.ones(q, bool) if shard_cap is None
                    else np.asarray(shard_cap, np.int64) >= ns)

        keys1 = [None] * q
        keys2 = [None] * q
        l1_hit = np.zeros(q, bool)
        l2_hit = np.zeros(q, bool)
        l1_vals: dict = {}
        l2_vals: dict = {}
        for i in range(q):
            if not eligible[i]:
                cache.counters["skipped_partial"] += 1
                continue
            cache.counters["lookups"] += 1
            keys1[i] = l1_key(qkeys[i], sigs[i], self.k_serve, self.t_final,
                              int(cap[i]))
            v = cache.l1_get(keys1[i], epoch)
            if v is not None:
                l1_hit[i] = True
                l1_vals[i] = v
                cache.counters["l1_hits"] += 1
                continue
            keys2[i] = l2_key(qkeys[i], sigs[i])
            if self.ltr is not None:
                v2 = cache.l2_get(keys2[i], epoch)
                if v2 is not None:
                    l2_hit[i] = True
                    l2_vals[i] = v2
                    cache.counters["l2_hits"] += 1
                    continue
            cache.counters["full_misses"] += 1

        hit_us = self.cost.cache_hit_us
        topk = np.zeros((q, self.k_serve), np.int64)
        final_rows: list = [None] * q
        used = np.zeros(q, np.int64) if self.ltr is not None else None
        t0 = np.full(q, self.cost.predict_us)
        t1 = np.zeros(q)
        t2 = np.zeros(q)
        faulted = self.faults.active or shard_cap is not None
        coverage = np.ones(q) if faulted else None
        trimmed = skipped = 0

        rows1 = np.flatnonzero(l1_hit)
        for i in rows1:
            tk, f, u = l1_vals[i]
            topk[i] = tk
            if self.ltr is not None:
                final_rows[i] = f
                used[i] = u
        t1[rows1] = hit_us

        rows2 = np.flatnonzero(l2_hit)
        skip_flags = None
        if len(rows2):
            vals = [l2_vals[i] for i in rows2]
            if self.dense is not None:
                # dense-mode L2 entries carry the fill-time theta-skip
                # decision, so a hit replays the cold serve's shortcut
                cand = np.stack([v[0] for v in vals])
                skip_flags = np.array([bool(v[1]) for v in vals])
            else:
                cand = np.stack(vals)
            topk[rows2] = cand
            t1[rows2] = hit_us
            k2 = np.minimum(np.minimum(routed.k[rows2], self.k_serve),
                            cap[rows2]).astype(np.int64)
            if skip_flags is not None:
                k2[skip_flags] = 0
            if self.sched.cfg.enforce_budget:
                # the cold path's enforcement, priced at the hit's actual
                # stage-1 cost
                afford = stage2_afford(
                    self.cost,
                    self.budget - (self.cost.predict_us + hit_us),
                    self.k_serve)
                trimmed += int(np.sum((0 < afford) & (afford < k2)))
                skipped += int(np.sum((afford == 0) & (k2 > 0)))
                k2 = np.minimum(k2, afford)
            # (the reference indexes topics here unguarded too: an LTR
            # system served without topics fails on an L2 hit)
            res2 = self.stage2(terms[rows2], mask[rows2], topics[rows2],
                               cand.astype(np.int32), k2)
            f2, u2 = res2.final, res2.candidates_used
            skip = np.flatnonzero(k2 == 0)
            if len(skip):
                f2[skip] = cand[skip, :self.t_final]
            for j, i in enumerate(rows2):
                final_rows[i] = f2[j]
                used[i] = u2[j]
            t2[rows2] = np.where(u2 > 0, self.cost.ltr_time(u2), 0.0)
            # promote: the fresh full-coverage re-rank is exactly an L1
            # entry for this (query, route, stage-2 params) point
            for j, i in enumerate(rows2):
                cache.l1_put(keys1[i],
                             (topk[i].copy(), f2[j].copy(), int(u2[j])),
                             epoch)

        miss_rows = np.flatnonzero(~(l1_hit | l2_hit))
        sub = None
        if len(miss_rows):
            sub = self._serve_direct(
                terms[miss_rows], mask[miss_rows],
                None if topics is None else topics[miss_rows],
                stage2_cap=(None if stage2_cap is None
                            else np.asarray(stage2_cap)[miss_rows]),
                shard_cap=(None if shard_cap is None
                           else np.asarray(shard_cap)[miss_rows]),
                now=now)
            topk[miss_rows] = sub.topk
            if self.ltr is not None:
                for j, i in enumerate(miss_rows):
                    final_rows[i] = sub.final[j]
                used[miss_rows] = sub.candidates_used
            t0[miss_rows] = sub.stage_latency["stage0"]
            # misses pay the failed lookup on top of the cascade
            t1[miss_rows] = sub.stage_latency["stage1"] + hit_us
            t2[miss_rows] = sub.stage_latency["stage2"]
            if coverage is not None and sub.coverage is not None:
                coverage[miss_rows] = sub.coverage
            sb = sub.stats["budget"]
            trimmed += sb["stage2_trimmed"]
            skipped += sb["stage2_skipped"]
            for j, i in enumerate(miss_rows):
                if not eligible[i]:
                    continue
                if sub.coverage is not None and sub.coverage[j] < 1.0:
                    cache.counters["skipped_partial"] += 1
                    continue   # partial coverage is never cached
                if self.ltr is not None:
                    v2 = sub.topk[j].copy()
                    if self.dense is not None:
                        v2 = (v2, bool(sub.dense["theta_skip"][j]))
                    cache.l2_put(keys2[i], v2, epoch)
                    cache.l1_put(keys1[i],
                                 (sub.topk[j].copy(), sub.final[j].copy(),
                                  int(sub.candidates_used[j])), epoch)
                else:
                    cache.l1_put(keys1[i],
                                 (sub.topk[j].copy(), None, None), epoch)

        final = np.stack(final_rows) if self.ltr is not None else None
        lat = t0 + t1 + t2
        stage_latency = {"stage0": t0, "stage1": t1, "stage2": t2}
        # the batch advances the serving clock like the direct path (the
        # miss sub-serve's advance is overridden: the batch's occupancy is
        # the max over ALL its rows)
        self._clock = now + (float(lat.max()) if q else 0.0)

        dense_info = None
        if self.dense is not None:
            theta_all = np.zeros(q, bool)
            fb_all = np.zeros(q, bool)
            if sub is not None:
                theta_all[miss_rows] = sub.dense["theta_skip"]
                fb_all[miss_rows] = sub.dense["fallback"]
            if skip_flags is not None:
                theta_all[rows2] = skip_flags
            # L1 rows keep False flags: their final list already baked in
            # whatever shortcut the fill-time serve took
            dense_info = {"modality": modality, "theta_skip": theta_all,
                          "fallback": fb_all}
        stats = self._build_stats(
            lat, stage_latency, trimmed, skipped, faulted, coverage, now,
            dense_info=dense_info, cache_stats=cache.stats())
        return PipelineResult(topk=topk, final=final, candidates_used=used,
                              latency=lat, stage_latency=stage_latency,
                              stats=stats, coverage=coverage,
                              dense=dense_info)

    # ------------------------------------------------------------------
    # batch stats
    # ------------------------------------------------------------------

    def _build_stats(self, lat, stage_latency, trimmed, skipped, faulted,
                     coverage, now, *, dense_info=None,
                     cache_stats=None) -> dict:
        """The per-batch stats dict both serve paths report (the
        reference's, minus the telemetry feed)."""
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
            # fused routes spend the fusion reserve inside stage 1
            b = (self._budget_reserve[name]
                 + (self._budget_reserve.get("fusion", 0.0)
                    if name == "stage1" else 0.0))
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
        if faulted:
            q = len(lat)
            stats["faults"] = dict(self._fault_counters)
            stats["faults"]["clock"] = now
            stats["coverage"] = {
                "min": float(coverage.min()) if q else 1.0,
                "mean": float(coverage.mean()) if q else 1.0,
                "degraded": int((coverage < 1.0).sum()),
            }
        if cache_stats is not None:
            stats["cache"] = cache_stats
        if dense_info is not None:
            modality = dense_info["modality"]
            stats["dense"] = {
                "lexical": int(np.sum(modality == M_LEX)),
                "dense_only": int(np.sum(modality == M_DENSE)),
                "fused": int(np.sum(modality == M_BOTH)),
                "theta_skips": int(dense_info["theta_skip"].sum()),
                "fallbacks": int(dense_info["fallback"].sum()),
            }
        self._last_stats = stats
        return stats

    def worst_case_us(self) -> float:
        """The hard analytic bound on any served query's cascade latency:
        the scheduler's Stage-1 bound (which already pays ``predict_us``)
        plus the reserved worst-case Stage-2 cost.

        With the dense modality enabled the bound is the max over the three
        routes: lexical (the scheduler bound, whose stage-1 share already
        had ``fusion_us`` carved out); dense only (``predict +
        dense_time(max_tiles) + gather + retry``, plus the ρ_late-capped
        fallback traversal when ``theta_low`` is armed); both + fused (the
        slower engine plus the reserved ``fusion_us``).  With a serving
        cache attached every query also pays the lookup
        (``cache_hit_us``)."""
        cfg = self.sched.cfg
        base = cfg.worst_case_us(self.cost, self.n_shards)
        if self.dense is not None:
            ds = self.cascade_spec.dense
            pd = self.cost.predict_us
            gather = self.cost.gather_per_shard_us * (self.n_shards - 1)
            td = (float(self.cost.dense_time(self.dense.max_tiles()))
                  + gather + cfg.retry_us())
            fb = (float(self.cost.saat_time(
                      np.float64(cfg.resolved_late_rho()))) + gather
                  if np.isfinite(ds.theta_low) else 0.0)
            dense_bound = pd + td + fb
            both_bound = pd + max(base - pd, td) + self.cost.fusion_us
            base = max(base, dense_bound, both_bound)
        return (base + self._budget_reserve["stage2"]
                + (self.cost.cache_hit_us if self.cache is not None
                   else 0.0))

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
        if self.faults.active or any(self._fault_counters.values()):
            s["faults"] = dict(self._fault_counters, clock=self._clock)
        if self._last_stats:
            s["last_batch"] = {k: self._last_stats[k]
                               for k in ("p50", "p99", "p99.99", "max",
                                         "over_budget", "over_budget_pct")
                               if k in self._last_stats}
        return s
