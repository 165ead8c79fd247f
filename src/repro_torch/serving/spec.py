"""Declarative serving configuration: one typed, serializable spec tree
describes an entire deployment of the paper's multi-stage system.

The paper pitches a *unified framework* that can be "easily applied in
large-scale IR systems" across all stages; the spec is the API form of
that claim: a single :class:`CascadeSpec` names an operating point — index
layout, Stage-0 predictors, routing thresholds, Stage-2 re-ranker, kernel
backend, and the deployment shape (shards x replicas) — and
``repro.serving.system.build_system`` instantiates it.  Named operating
points live in ``repro.configs.cascade_presets``.

Every node is a frozen dataclass of JSON-plain scalars, so
``spec.to_json()`` / ``CascadeSpec.from_json()`` round-trip exactly and a
spec can be checked into a config repo, diffed, and shipped to a serving
fleet.  ``replace``-style evolution works through ``dataclasses.replace``.

A copy of ``repro.serving.spec`` (the port imports nothing of the reference
package), so a spec written by either package reads back in the other:
``CascadeSpec.from_json(ref_spec.to_json())`` round-trips.  The port's
``SearchSystem`` serves every node of the tree.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field

SPEC_VERSION = 1


@dataclass(frozen=True)
class IndexSpec:
    """Index build + device-mirror layout parameters."""
    block_size: int = 64        # DAAT block-max block width (docs)
    stop_k: int = 16            # drop the stop_k most frequent terms
    tile_d: int = 128           # docs per bucketed serving tile (kernels)

    def validate(self) -> None:
        if self.tile_d % self.block_size:
            raise ValueError(f"tile_d={self.tile_d} must be a multiple of "
                             f"block_size={self.block_size}")


@dataclass(frozen=True)
class Stage0Spec:
    """Quantile-GBRT predictor training configuration (k, rho, t)."""
    n_trees: int = 48
    depth: int = 5
    tau_k: float = 0.55
    tau_rho: float = 0.45
    tau_t: float = 0.5

    def validate(self) -> None:
        if self.n_trees < 1 or self.depth < 1:
            raise ValueError("Stage0Spec needs n_trees >= 1 and depth >= 1")


@dataclass(frozen=True)
class RoutingSpec:
    """Stage-0 scheduler thresholds (paper Algorithms 1/2 + hedging)."""
    algorithm: int = 2
    budget: float = 200.0
    t_k: float = 1000.0
    t_time: float = 150.0
    rho_max: int = 1 << 20
    rho_min: int = 4096
    hedge_band: float = 0.25
    enable_hedging: bool = True
    hedge_deadline: float = 0.5  # straggler detection fraction of the budget
    late_rho: int = 0            # late-hedge re-issue ρ cap (0 = auto:
                                 # rho_min) — keep SMALL: the hard bound is
                                 # budget·hedge_deadline + ρ_late·c_s
    enforce_budget: bool = True  # cascade-wide enforcement: deadline
                                 # re-route JASS rows, trim Stage-2 grids
    adapt_every: int = 0         # batches between online threshold
                                 # adaptations from pool EWMAs (0 = off)
    calibrate: bool = False     # fit(): set t_k/t_time from the trained
                                # predictors' distribution
    failover_timeout: float = 0.0  # scatter-gather timeout (time units):
                                   # a shard request with no response by
                                   # this is declared dead and re-issued to
                                   # another healthy replica (0 = no
                                   # failover; required when faults are on)
    max_retries: int = 0         # bounded re-issues per (query, shard);
                                 # the retry budget max_retries *
                                 # failover_timeout is charged into the
                                 # worst_case_us bound

    def validate(self) -> None:
        if self.algorithm not in (1, 2):
            raise ValueError(f"algorithm must be 1 or 2, got {self.algorithm}")
        if self.budget <= 0:
            raise ValueError("budget must be positive")
        if self.rho_min > self.rho_max:
            raise ValueError("rho_min must not exceed rho_max")
        if not 0.0 < self.hedge_deadline <= 1.0:
            raise ValueError("hedge_deadline must be in (0, 1]")
        if self.late_rho < 0:
            raise ValueError("late_rho must be >= 0 (0 = auto)")
        if self.late_rho > self.rho_max:
            raise ValueError("late_rho must not exceed rho_max")
        if self.adapt_every < 0:
            raise ValueError("adapt_every must be >= 0 (0 = off)")
        if self.failover_timeout < 0:
            raise ValueError("failover_timeout must be >= 0 (0 = off)")
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.max_retries > 0 and self.failover_timeout <= 0:
            raise ValueError("max_retries > 0 needs failover_timeout > 0 "
                             "(retries are issued at the timeout)")
        if (self.failover_timeout > 0
                and (1 + self.max_retries) * self.failover_timeout
                > self.budget):
            raise ValueError(
                "(1 + max_retries) * failover_timeout must fit the budget: "
                "a fully-dead partition is declared lost only after the "
                "whole retry chain times out, and that wait must stay "
                "inside the response bound")


@dataclass(frozen=True)
class Stage2Spec:
    """Candidate depth and LTR re-ranker configuration."""
    enabled: bool = True
    k_serve: int = 128          # Stage-1 retrieval depth (candidate grid C)
    t_final: int = 10           # final result-list depth
    ltr_trees: int = 48
    n_train_queries: int = 256  # queries used to fit the LTR model

    def validate(self) -> None:
        if self.k_serve < 1:
            raise ValueError("k_serve must be >= 1")
        if self.enabled and self.t_final < 1:
            raise ValueError("t_final must be >= 1 when Stage-2 is enabled")


@dataclass(frozen=True)
class BackendSpec:
    """Kernel backend + cost-model selection."""
    backend: str | None = None  # selects nothing: the device picks the
                                # path; the reference's "pallas" |
                                # "interpret" | "jnp" load (same results)
    cost: str = "paper_scale"   # CostModel constructor name
    calibrate_cost: bool = True  # fit(): regress measured work→latency
                                 # pairs into the CostModel constants

    def validate(self) -> None:
        if self.backend not in (None, "pallas", "interpret", "jnp"):
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.cost not in ("paper_scale", "v5e_shard"):
            raise ValueError(f"unknown cost model {self.cost!r}")


@dataclass(frozen=True)
class OnlineSpec:
    """Online traffic policy: dynamic micro-batching + admission control.

    The offline ``serve()`` path certifies the *service-time* tail of one
    pre-formed batch; this node configures the layer that converts that
    into a **response-time** guarantee under load (queueing included):
    ``repro.serving.online`` wraps the system in a simulated clock, forms
    Stage-1 micro-batches under a ``batch_deadline_us`` / ``max_batch``
    policy, and sheds or degrades queries whose queueing delay has already
    eaten the response budget (see ``repro.serving.online.admission``).

    Time units follow the spec's ``CostModel`` (ms at ``paper_scale``).
    """
    max_batch: int = 32          # micro-batch width cap (Q axis)
    batch_deadline_us: float = 5.0   # close a batch when its oldest query
                                     # has waited this long
    bucket_q: bool = True        # pad batches to power-of-two Q buckets so
                                 # batched engine calls stay jit-cache-
                                 # friendly (pads replicate a real query
                                 # and are dropped from results)
    dispatch_us: float = 1.0     # per-batch dispatch/queue-handoff overhead
    admission: bool = True       # SLA-aware admission control + shedding
    degrade: bool = True         # allow trimmed-Stage-2 / stage1-only
                                 # service before rejecting outright
    queue_cap: int = 0           # hard queue-depth cap (0 = unbounded;
                                 # admission bounds it softly regardless)
    response_budget_us: float = 0.0  # end-to-end response-time budget,
                                     # queueing included (0 = auto: 2x the
                                     # routing budget)

    def validate(self) -> None:
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if self.batch_deadline_us < 0:
            raise ValueError("batch_deadline_us must be >= 0")
        if self.dispatch_us < 0:
            raise ValueError("dispatch_us must be >= 0")
        if self.queue_cap < 0:
            raise ValueError("queue_cap must be >= 0 (0 = unbounded)")
        if self.response_budget_us < 0:
            raise ValueError("response_budget_us must be >= 0 (0 = auto)")


@dataclass(frozen=True)
class FaultSpec:
    """A deterministic, seeded fault-injection schedule.

    The 99.99 % regime is exactly where machine failures, not query
    difficulty, dominate the tail — this node makes failures part of the
    *named* operating point so a guarantee can be certified under them
    (``benchmarks/bench_faults.py``).  All times are on the serving clock
    in cost-model units: the offline ``serve()`` path advances a virtual
    clock by each batch's occupancy, the online simulator drives it from
    the event loop, so one schedule means the same thing on both paths.

    ``partition=-1`` / ``replica=-1`` are wildcards (every partition /
    every replica of the partition).  Windows are half-open ``[t0, t1)``;
    use ``float("inf")`` (JSON ``Infinity``) for an open end.

    An empty schedule (the default) is **inert**: the fault layer is
    skipped entirely — no RNG draws, no pool interactions — so serving is
    bit-identical to a fault-free build.
    """
    # replica crash/recover windows: (partition, replica, t_start, t_end) —
    # requests to the replica inside the window never respond (detected at
    # the failover timeout); outside it, health probes re-admit it
    crashes: tuple = ()
    # straggler windows: (partition, replica, t_start, t_end, slowdown) —
    # the replica responds, slowdown x slower than nominal
    stragglers: tuple = ()
    # whole-partition outages: (partition, t_start, t_end) — every replica
    # of the partition is down; queries degrade to partial coverage
    outages: tuple = ()
    # transient per-request timeout probability inside [t_start, t_end)
    timeout_p: float = 0.0
    timeout_start: float = 0.0
    timeout_end: float = float("inf")
    seed: int = 0                # transient-draw RNG seed

    def __post_init__(self):
        # JSON round-trips tuples as lists; coerce back so a round-tripped
        # spec compares (and hashes) equal to the original
        for name in ("crashes", "stragglers", "outages"):
            object.__setattr__(
                self, name,
                tuple(tuple(w) for w in getattr(self, name)))

    @property
    def active(self) -> bool:
        """Whether the schedule injects anything at all."""
        return bool(self.crashes or self.stragglers or self.outages
                    or self.timeout_p > 0)

    @property
    def needs_failover(self) -> bool:
        """Whether the schedule can kill requests (and therefore needs a
        ``RoutingSpec.failover_timeout`` to detect them)."""
        return bool(self.crashes or self.outages or self.timeout_p > 0)

    def validate(self) -> None:
        def _window(p, t0, t1, r=None):
            if p < -1:
                raise ValueError(f"partition must be >= -1, got {p}")
            if r is not None and r < -1:
                raise ValueError(f"replica must be >= -1, got {r}")
            if t1 < t0:
                raise ValueError(f"fault window [{t0}, {t1}) is inverted")
        for w in self.crashes:
            if len(w) != 4:
                raise ValueError(f"crash window needs (partition, replica, "
                                 f"t_start, t_end), got {w}")
            _window(w[0], w[2], w[3], r=w[1])
        for w in self.stragglers:
            if len(w) != 5:
                raise ValueError(f"straggler window needs (partition, "
                                 f"replica, t_start, t_end, slowdown), "
                                 f"got {w}")
            _window(w[0], w[2], w[3], r=w[1])
            if w[4] < 1.0:
                raise ValueError(f"straggler slowdown must be >= 1, "
                                 f"got {w[4]}")
        for w in self.outages:
            if len(w) != 3:
                raise ValueError(f"outage window needs (partition, t_start, "
                                 f"t_end), got {w}")
            _window(w[0], w[1], w[2])
        if not 0.0 <= self.timeout_p < 1.0:
            raise ValueError("timeout_p must be in [0, 1)")
        if self.timeout_end < self.timeout_start:
            raise ValueError("timeout window is inverted")


@dataclass(frozen=True)
class CacheSpec:
    """Two-level serving cache: the skew half of a production workload.

    Production query streams are heavily skewed — a small head of queries
    repeats constantly — and a repeat should not pay the Stage-0→1→2
    cascade again.  This node names the cache half of the operating point:

    * **L1** — exact result cache keyed on the normalized query (sorted
      active term ids + weights + topic + the resolved route/ρ/k and the
      Stage-2 depth): a hit bypasses the whole cascade and costs
      ``CostModel.cache_hit_us``;
    * **L2** — Stage-1 candidate cache keyed on (normalized query, route,
      ρ) only: a hit skips retrieval but re-runs Stage-2, so trimmed /
      degraded rungs and differing re-rank depths still get a partial win.

    Both levels are deterministic capacity-bounded LRUs (entry- **and**
    byte-limits, O(1) dict+linked-list, no wall-clock reads, no RNG) in
    ``repro.serving.cache``, evaluated on the same serving clock as the
    fault schedule: partial-coverage results are never admitted, and every
    entry is tagged with the coverage/fault epoch at fill time so a result
    cached while a partition was down can never be served after it heals
    (and vice versa).

    The default (``enabled=False``) is **inert**: ``SearchSystem`` takes
    the historical serve path untouched — zero lookups, zero RNG draws,
    bit-identical serving — the same discipline as an empty ``FaultSpec``.
    """
    enabled: bool = False
    l1_entries: int = 4096       # exact-result entries (0 disables L1)
    l2_entries: int = 4096       # Stage-1 candidate entries (0 disables L2)
    l1_bytes: int = 1 << 26      # per-level byte cap (0 = entries-only)
    l2_bytes: int = 1 << 26
    hit_alpha: float = 0.2       # admission hit-ratio EWMA step (the live
                                 # hit ratio folds into the shed floor and
                                 # the observed-capacity estimate)

    @property
    def active(self) -> bool:
        """Whether any level can hold an entry at all."""
        return self.enabled and (self.l1_entries > 0 or self.l2_entries > 0)

    def validate(self) -> None:
        for name in ("l1_entries", "l2_entries", "l1_bytes", "l2_bytes"):
            if getattr(self, name) < 0:
                raise ValueError(f"{name} must be >= 0")
        if not 0.0 < self.hit_alpha <= 1.0:
            raise ValueError("hit_alpha must be in (0, 1]")


@dataclass(frozen=True)
class DenseSpec:
    """The dense Stage-1 modality: embedding retrieval + modality routing.

    When enabled, ``SearchSystem`` builds a :class:`~repro.dense.engine.
    DenseEngine` over the SAME doc-range partitioning as the lexical
    shards and Stage-0 dispatches every query to one of three routes from
    its predicted lexical time ``pred_t``:

    * ``pred_t <= t_dense·(1 - fuse_band)`` — **lexical** (cheap queries
      stay on the impact-ordered engines);
    * inside the band — **both + fused** (uncertain queries run both
      engines in parallel and merge by :class:`FusionSpec`);
    * ``pred_t > t_dense·(1 + fuse_band)`` — **dense only** (the
      shape-static dense cost undercuts a predicted-expensive traversal).

    Confidence-band shortcuts: a dense-involved query whose top dense
    score clears ``theta_high`` serves its Stage-1 order directly
    (rank-safe Stage-2 skip, the existing zero-grid path); a dense-only
    query below ``theta_low`` re-issues a bounded ρ-capped lexical
    fallback (priced like the late hedge, so the route stays inside
    ``worst_case_us``).  The ``inf``/``-inf`` defaults disarm both bands.

    The default (``enabled=False``) is **inert**: no engine is built, no
    embedding tables materialize, every serve path and cache key is
    bit-identical to the lexical-only system — the same discipline as
    ``FaultSpec``/``CacheSpec``.
    """
    enabled: bool = False
    embed_dim: int = 32          # synthetic-source embedding width (the
                                 # two-tower source uses the tower's output)
    tile_d: int = 512            # docs per dense-kernel grid tile
    source: str = "auto"         # auto | two_tower | synthetic
    seed: int = 0                # embedding init / synthetic-table seed
    t_dense: float = 0.0         # pred_t threshold routing toward dense
                                 # (0 = auto: track routing.t_time)
    fuse_band: float = 0.25      # both+fused band half-width around t_dense
    theta_high: float = float("inf")   # top dense score >= this: skip
                                       # Stage-2 rank-safely (inf = never)
    theta_low: float = float("-inf")   # dense-only top score < this:
                                       # bounded lexical fallback
                                       # (-inf = never)

    @property
    def active(self) -> bool:
        return self.enabled

    def validate(self) -> None:
        if self.embed_dim < 1:
            raise ValueError("embed_dim must be >= 1")
        if self.tile_d < 128 or self.tile_d % 128:
            raise ValueError("tile_d must be a positive multiple of the "
                             "128-lane width")
        if self.source not in ("auto", "two_tower", "synthetic"):
            raise ValueError(f"unknown dense source {self.source!r}")
        if self.t_dense < 0:
            raise ValueError("t_dense must be >= 0 (0 = auto)")
        if not 0.0 <= self.fuse_band <= 1.0:
            raise ValueError("fuse_band must be in [0, 1]")
        if self.theta_low > self.theta_high:
            raise ValueError("theta_low must not exceed theta_high")


@dataclass(frozen=True)
class FusionSpec:
    """How a both-routed query's lexical and dense lists merge.

    ``rrf`` is reciprocal-rank fusion (rank-only — no cross-modality score
    calibration needed); ``weighted`` min-max normalizes each list per
    query and blends by ``w_dense``.  Only consulted when
    ``DenseSpec.enabled``; both rules break score ties toward the lower
    global doc id (see ``repro.dense.fusion``).
    """
    method: str = "rrf"          # rrf | weighted
    rrf_k0: float = 60.0         # RRF rank damping constant
    w_dense: float = 0.5         # dense weight under 'weighted'

    def validate(self) -> None:
        if self.method not in ("rrf", "weighted"):
            raise ValueError(f"unknown fusion method {self.method!r}")
        if self.rrf_k0 <= 0:
            raise ValueError("rrf_k0 must be positive")
        if not 0.0 <= self.w_dense <= 1.0:
            raise ValueError("w_dense must be in [0, 1]")


@dataclass(frozen=True)
class IngestSpec:
    """Live index mutation: the feed half of a production operating point.

    When enabled, ``SearchSystem`` attaches a capacity-bounded
    :class:`~repro.index.delta.DeltaStore` — an append-only delta tile-set
    scanned by every Stage-1 engine alongside the sealed shards —
    and exposes ``add_documents()`` / ``merge()``.  The online simulator
    drives a seeded feed-arrival process on the same virtual clock as
    queries, applies ingest batches between dispatches, and triggers a
    background merge when the delta fill crosses ``merge_threshold``
    (deferred under load by the admission ladder: merge defers, then feed
    throttles, and only then do queries degrade/shed).

    The worst-case lexical delta scan (``CostModel.delta_time`` at the
    postings *capacity*) plus the dense delta-tile term is charged into
    every served query's Stage-1 latency and into ``worst_case_us``, so
    admission and the late hedge stay sound at any fill level.

    The default (``enabled=False``) is **inert**: no delta store is built,
    every serve path, cache key, and event log is bit-identical to a
    sealed-index system — the same discipline as ``FaultSpec`` /
    ``CacheSpec`` / ``DenseSpec``.
    """
    enabled: bool = False
    delta_docs: int = 512        # delta segment doc capacity
    delta_postings: int = 8192   # delta segment postings capacity (padded
                                 # array shapes; also the worst-case scan
                                 # charge — size it to the budget's slack)
    feed_qps: float = 10.0       # feed BATCH arrivals per 1000 time units
    feed_batch: int = 16         # docs per feed batch
    ingest_us: float = 2.0       # server occupancy per applied feed batch
    merge_us: float = 50.0       # server occupancy of a background merge
    merge_threshold: float = 0.75  # delta doc-fill fraction that requests
                                   # a merge (1.0 = only when full)
    seed: int = 0                # feed arrival-process seed

    @property
    def active(self) -> bool:
        return self.enabled

    def validate(self) -> None:
        if self.delta_docs < 1:
            raise ValueError("delta_docs must be >= 1")
        if self.delta_postings < 1:
            raise ValueError("delta_postings must be >= 1")
        if self.feed_qps <= 0:
            raise ValueError("feed_qps must be positive")
        if self.feed_batch < 1:
            raise ValueError("feed_batch must be >= 1")
        if self.ingest_us < 0 or self.merge_us < 0:
            raise ValueError("ingest_us/merge_us must be >= 0")
        if not 0.0 < self.merge_threshold <= 1.0:
            raise ValueError("merge_threshold must be in (0, 1]")


ARRIVALS = ("poisson", "bursty", "diurnal", "trace")


@dataclass(frozen=True)
class TrafficSpec:
    """A seeded arrival process: the workload half of an online experiment.

    Kept separate from :class:`CascadeSpec` — traffic describes the world,
    the cascade spec describes the deployment — but serialized the same way
    (JSON-plain frozen dataclass) so a load test is fully named by the
    (CascadeSpec, TrafficSpec) pair.

    ``qps`` is queries per 1000 cost-model time units, i.e. literally
    queries/second when the cost model is in milliseconds
    (``CostModel.paper_scale``).
    """
    arrival: str = "poisson"     # poisson | bursty | diurnal | trace
    qps: float = 100.0
    seed: int = 0
    # query-identity skew: each arrival's query is drawn Zipf(s=skew) over
    # the log (rank r with probability ∝ 1/r^skew), so a head of queries
    # repeats — the workload half of the serving cache.  0 = uniform replay
    # of the log in order (the historical behavior, bit-identical).  The
    # identity stream is seeded independently of the arrival-time stream,
    # so toggling skew never moves a timestamp.
    skew: float = 0.0
    # bursty (2-state MMPP): high-state rate = qps * burst_factor, dwell
    # times exponential with the given means; the low-state rate is solved
    # so the long-run mean rate stays qps
    burst_factor: float = 4.0
    burst_fraction: float = 0.1  # long-run fraction of time in the burst
    burst_dwell_us: float = 50.0  # mean burst dwell (time units)
    # diurnal: rate(t) = qps * (1 + amplitude * sin(2*pi*t/period))
    diurnal_amplitude: float = 0.5
    diurnal_period_us: float = 1000.0
    trace_path: str = ""         # "trace": replay timestamps from a JSON
                                 # list or .npy array (time units)

    def validate(self) -> None:
        if self.arrival not in ARRIVALS:
            raise ValueError(f"arrival must be one of {ARRIVALS}, "
                             f"got {self.arrival!r}")
        if self.arrival != "trace" and self.qps <= 0:
            raise ValueError("qps must be positive")
        if self.skew < 0:
            raise ValueError("skew must be >= 0 (0 = no repetition)")
        if self.arrival == "trace" and not self.trace_path:
            raise ValueError("arrival='trace' needs trace_path")
        if self.arrival == "bursty":
            if self.burst_factor < 1.0:
                raise ValueError("burst_factor must be >= 1")
            if not 0.0 < self.burst_fraction < 1.0:
                raise ValueError("burst_fraction must be in (0, 1)")
            if self.burst_factor * self.burst_fraction >= 1.0:
                raise ValueError(
                    "burst_factor * burst_fraction must be < 1 so the "
                    "off-burst rate stays positive")
            if self.burst_dwell_us <= 0:
                raise ValueError("burst_dwell_us must be positive")
        if self.arrival == "diurnal":
            if not 0.0 <= self.diurnal_amplitude < 1.0:
                raise ValueError("diurnal_amplitude must be in [0, 1)")
            if self.diurnal_period_us <= 0:
                raise ValueError("diurnal_period_us must be positive")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self, indent: int | None = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict) -> "TrafficSpec":
        spec = cls(**d)
        spec.validate()
        return spec

    @classmethod
    def from_json(cls, s: str) -> "TrafficSpec":
        return cls.from_dict(json.loads(s))


@dataclass(frozen=True)
class DeploySpec:
    """Deployment shape: document shards x replicas per shard.

    ``n_shards`` doc-range partitions serve Stage-1 scatter-gather;
    ``replicas`` ISN replicas back each partition (split across the
    BMW/JASS mirrors by ``jass_fraction``, re-split online every
    ``rebalance_every`` batches from the observed routing mix).
    """
    n_shards: int = 1
    replicas: int = 2
    jass_fraction: float = 0.5
    rebalance_every: int = 1    # batches between pool rebalances (0 = off)
    seed: int = 0

    def validate(self) -> None:
        if self.n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        if self.replicas < 1:
            raise ValueError("replicas must be >= 1")
        if not 0.0 <= self.jass_fraction <= 1.0:
            raise ValueError("jass_fraction must be in [0, 1]")


@dataclass(frozen=True)
class TelemetrySpec:
    """Deterministic observability layer (metrics + traces + snapshots).

    Disabled by default and provably inert when disabled: the system
    allocates no registry, every instrumentation hook is guarded, and
    serving plus the online event log stay bit-identical.  All telemetry
    runs on the virtual serving clock — no wall time, no RNG — so
    same-seed replays export byte-identical snapshots.
    """
    enabled: bool = False
    bins_per_decade: int = 64   # histogram resolution; rel err ~1.8%
    exact_n: int = 256          # exact quantiles while N <= exact_n
    hist_lo: float = 1e-3       # bucketed range lower edge (us)
    hist_hi: float = 1e7        # bucketed range upper edge (us)
    trace_reservoir: int = 32   # slowest/violating traces retained
    snapshot_every_us: float = 0.0   # online snapshot cadence (0 = off)
    max_snapshots: int = 64

    @property
    def active(self) -> bool:
        return self.enabled

    def validate(self) -> None:
        if self.bins_per_decade < 1:
            raise ValueError("bins_per_decade must be >= 1")
        if self.exact_n < 0:
            raise ValueError("exact_n must be >= 0")
        if not 0 < self.hist_lo < self.hist_hi:
            raise ValueError("need 0 < hist_lo < hist_hi")
        if self.trace_reservoir < 0:
            raise ValueError("trace_reservoir must be >= 0")
        if self.snapshot_every_us < 0:
            raise ValueError("snapshot_every_us must be >= 0")
        if self.max_snapshots < 1:
            raise ValueError("max_snapshots must be >= 1")


_NODES = {"index": IndexSpec, "stage0": Stage0Spec, "routing": RoutingSpec,
          "stage2": Stage2Spec, "backend": BackendSpec, "deploy": DeploySpec,
          "online": OnlineSpec, "fault": FaultSpec, "cache": CacheSpec,
          "dense": DenseSpec, "fusion": FusionSpec, "ingest": IngestSpec,
          "telemetry": TelemetrySpec}


@dataclass(frozen=True)
class CascadeSpec:
    """The whole deployment, as one declarative value."""
    index: IndexSpec = field(default_factory=IndexSpec)
    stage0: Stage0Spec = field(default_factory=Stage0Spec)
    routing: RoutingSpec = field(default_factory=RoutingSpec)
    stage2: Stage2Spec = field(default_factory=Stage2Spec)
    backend: BackendSpec = field(default_factory=BackendSpec)
    deploy: DeploySpec = field(default_factory=DeploySpec)
    online: OnlineSpec = field(default_factory=OnlineSpec)
    fault: FaultSpec = field(default_factory=FaultSpec)
    cache: CacheSpec = field(default_factory=CacheSpec)
    dense: DenseSpec = field(default_factory=DenseSpec)
    fusion: FusionSpec = field(default_factory=FusionSpec)
    ingest: IngestSpec = field(default_factory=IngestSpec)
    telemetry: TelemetrySpec = field(default_factory=TelemetrySpec)
    name: str = "custom"

    def validate(self) -> "CascadeSpec":
        for node in _NODES:
            getattr(self, node).validate()
        if self.fault.needs_failover and self.routing.failover_timeout <= 0:
            raise ValueError(
                "the fault schedule can kill requests (crashes / outages / "
                "transient timeouts) but routing.failover_timeout is 0 — "
                "dead shard requests would hang forever; set a timeout "
                "(and max_retries) so failover is possible")
        return self

    # -- serialization ------------------------------------------------------
    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["version"] = SPEC_VERSION
        return d

    def to_json(self, indent: int | None = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict) -> "CascadeSpec":
        d = dict(d)
        version = d.pop("version", SPEC_VERSION)
        if version != SPEC_VERSION:
            raise ValueError(f"unsupported spec version {version}")
        kwargs = {}
        for node, node_cls in _NODES.items():
            if node in d:
                kwargs[node] = node_cls(**d.pop(node))
        kwargs.update(d)                 # remaining scalars (name)
        return cls(**kwargs).validate()

    @classmethod
    def from_json(cls, s: str) -> "CascadeSpec":
        return cls.from_dict(json.loads(s))
