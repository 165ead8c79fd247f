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

Scope: the inert-node path plus the dense modality, and ``fit`` from the
label oracle's labels or the reference's pseudo-labels (Stage-0 quantile
GBRTs, the LTR GBRT, the cost-model regression and the routing
calibration, fitted on the system's device bit-equal to the reference's).
A spec that turns on a node the port does not have yet (cache, fault
schedule, ingest, telemetry) raises ``NotImplementedError`` naming its
ROADMAP item, as does ``serve_online``.
Models fitted by the reference can also be converted
(``repro_torch.convert``); so can the two-tower model of the dense
modality (``convert.two_tower_params``), or the port draws its own.

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
from repro_torch.dense import (M_BOTH, M_DENSE, M_LEX, DenseEngine,
                               build_embeddings, fuse)
from repro_torch.index.builder import InvertedIndex, build_index
from repro_torch.index.corpus import Corpus
from repro_torch.index.postings import shard_from_index, shard_ranges
from repro_torch.isn.backend import (merge_shard_topk, query_lane_budget,
                                     resolve_backend, resolve_device)
from repro_torch.isn.daat import daat_serve
from repro_torch.isn.saat import saat_serve
from repro_torch.ltr.cascade import CascadeResult, rerank_batched
from repro_torch.ltr.ranker import (LTRModel, ltr_training_set, qd_features,
                                   stage2_arrays, train_ltr)
from repro_torch.models.recsys import TwoTower
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


@dataclass
class PipelineResult:
    """One served batch, end to end."""
    topk: np.ndarray                 # (Q, k_serve) Stage-1 candidates
    final: np.ndarray | None         # (Q, t_final) re-ranked (None: no LTR)
    candidates_used: np.ndarray | None   # (Q,) candidates entering Stage-2
    latency: np.ndarray              # (Q,) full-cascade latency
    stage_latency: dict              # {"stage0"|"stage1"|"stage2": (Q,)}
    stats: dict
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
                 device: str | torch.device | None = None
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
    reference's.
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
                        cost=cost, tower=tower, device=device)


class SearchSystem:
    """A spec-built multi-shard cascade served on one device."""

    def __init__(self, spec: CascadeSpec, index: InvertedIndex, *,
                 corpus=None, models: dict | None = None,
                 ltr: LTRModel | None = None, cost: CostModel | None = None,
                 tower: TwoTower | None = None,
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
        self._tower = tower

        # ---- shard the index (and the dense embeddings) by doc range ----
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
        self._budget_reserve = self._attribute_budget(self.budget, None)
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
        the device, the host-side df/level tables and the dense engine."""
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
        cfg = self._base_cfg
        if ltr is not None:
            if self.corpus is None:
                raise ValueError("Stage-2 re-ranking needs the corpus "
                                 "(doc topic mixtures)")
            self.s2 = stage2_arrays(self.index, self.corpus, self.device)
        self._budget_reserve = self._attribute_budget(
            cfg.budget, self.k_serve if ltr is not None else None)
        cfg = replace(cfg, budget=self._budget_reserve["stage1"])
        self.sched = StageZeroScheduler(cfg, self.cost)
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

        split_cache: dict = {}
        topk, topk_sc, t_bmw, t_shards = self._stage1_full(
            terms, mask, routed, split_cache)
        theta_skip, fallback, fb_extra, t_dense_mat = self._stage1_dense(
            terms, mask, routed, modality, topk, topk_sc, split_cache)
        lat01 = self.sched.resolve_times(
            routed, t_bmw, self._jass_time(terms, mask, split_cache))
        t_pool = t_shards
        if t_dense_mat is not None:
            # a partition replica hosting both engines is busy for the max
            # of its co-located work
            t_pool = np.maximum(t_pool, t_dense_mat)
            d_rows = np.flatnonzero(modality != M_LEX)
            tdr = np.zeros(q)
            tdr[d_rows] = self.cost.gather_time(t_dense_mat[:, d_rows])
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
                                  dense_info)
        return PipelineResult(topk=topk, final=final, candidates_used=used,
                              latency=lat, stage_latency=stage_latency,
                              stats=stats, dense=dense_info)

    def _stage1_dense(self, terms, mask, routed, modality, topk, topk_sc,
                      split_cache):
        """The dense part of Stage-1, in place on the lexical ``topk`` and
        ``topk_sc``: dense-only rows take the dense list, both-routed rows
        the fused list, and low-confidence dense-only rows a ρ_late-capped
        lexical re-issue (``theta_low``).

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
        d_ids, d_sc = self.dense.serve(q_emb, self.k_serve)
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

    def _build_stats(self, lat, stage_latency, trimmed, skipped,
                     dense_info=None) -> dict:
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
        slower engine plus the reserved ``fusion_us``)."""
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
        return base + self._budget_reserve["stage2"]

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
