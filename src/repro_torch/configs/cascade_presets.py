"""Named cascade operating points.

The judgment-free trade-off framing (Clarke et al., arXiv:1506.00717) and
the dynamic trade-off predictors (Culpepper/Clarke/Lin, arXiv:1610.02502)
both assume an operator can *name* a deployment operating point and
instantiate it; this registry is that name → :class:`CascadeSpec` mapping.

    from repro_torch.configs.cascade_presets import get_preset
    system = build_system(get_preset("paper_200ms"), corpus)

Presets (serving-time units follow ``CostModel.paper_scale``, i.e. ms on
the synthetic experiment collection):

=============  ==========================================================
paper_200ms    The paper's headline point: 200 ms budget, Algorithm 2
               routing with hedging, full Stage-2 re-rank.
throughput     Capacity-first: tighter budget, shallower candidate grid,
               hedging off (duplicated work costs capacity).
quality        Effectiveness-first: deep candidate grid, generous budget
               and ρ cap, deeper final lists.
stage1_only    First stage as the product: no Stage-2 re-rank, latency is
               the Stage-0+1 tail alone.
fault_tolerant The paper point hardened for lossy clusters: 4 shards x 3
               replicas, scatter-gather failover (25 ms shard timeout, 2
               bounded retries charged into the worst-case bound), so the
               200 ms guarantee survives replica crashes and stragglers;
               pair with a ``FaultSpec`` (``fault=...`` override or
               ``--fault-scenario``) to actually inject them.
cached         The paper point with the two-level result cache in front
               (L1 exact results + L2 Stage-1 candidates): repeated
               queries are answered at the front door in
               ``predict + cache_hit_us``, buying certified capacity on
               skewed traffic.  Threshold adaptation is frozen
               (``adapt_every=0``) so cache keys — which embed the route
               signature — stay stable across the trace.
live_ingest    The paper point serving while the collection mutates: a
               capacity-bounded delta tile-set absorbs a seeded document
               feed (its worst-case scan charged into every query's bound
               and into admission), background merges reseal the index in
               idle gaps — deferred under load, forced only when the delta
               is full — and the feed throttles strictly before queries
               degrade.  Adaptation frozen like ``cached``: ingest bumps
               the cache epoch, stable routes keep replay deterministic.
hybrid_fusion  The paper point with the dense Stage-1 modality enabled:
               Stage-0 dispatches each query lexical / dense / both+fused
               from its predicted traversal time, both-routed lists merge
               by RRF inside a reserved ``fusion_us`` slice of the stage-1
               budget, and the confidence bands (θ_high skips Stage-2
               rank-safely, θ_low re-issues a ρ_late-capped lexical
               fallback) stay inside the 200 ms bound.  Adaptation frozen
               like ``cached``: the modality is part of the route.
=============  ==========================================================

Every preset trains with ``RoutingSpec.calibrate=True``, so the routing
thresholds (t_k, t_time) are re-anchored to the trained predictors'
distribution at ``fit`` time — the spec names the trade-off, the data
names the thresholds.

Every preset also ships the hard-guarantee knobs explicitly:
``hedge_deadline`` (straggler detection fraction) and ``late_rho`` (the
SMALL re-issue cap — the worst case is
``budget·hedge_deadline + ρ_late·c_s``, see ``repro.serving.scheduler``),
with ``enforce_budget=True`` so the deadline re-route covers JASS routes
and Stage-2 grids are trimmed when a query's budget is already spent.

Each preset also names its **online traffic policy** (``OnlineSpec``:
micro-batch width/deadline + admission ladder) for
``SearchSystem.serve_online`` — ``throughput`` batches wide,
``quality`` refuses to degrade its candidate grid (shed instead).

A copy of ``repro.configs.cascade_presets`` (the port imports nothing of the reference
package).
"""

from __future__ import annotations

import dataclasses

from repro_torch.serving.spec import (CacheSpec, CascadeSpec, DenseSpec,
                                DeploySpec, FusionSpec, IngestSpec,
                                OnlineSpec, RoutingSpec, Stage2Spec)


def _paper_200ms() -> CascadeSpec:
    return CascadeSpec(
        name="paper_200ms",
        routing=RoutingSpec(algorithm=2, budget=200.0, rho_max=1 << 18,
                            hedge_deadline=0.5, late_rho=4096,
                            adapt_every=1, calibrate=True),
        stage2=Stage2Spec(enabled=True, k_serve=128, t_final=10),
        deploy=DeploySpec(n_shards=1, replicas=2),
        online=OnlineSpec(max_batch=32, batch_deadline_us=5.0,
                          admission=True, degrade=True),
    )


def _throughput() -> CascadeSpec:
    return CascadeSpec(
        name="throughput",
        routing=RoutingSpec(algorithm=2, budget=120.0, rho_max=1 << 16,
                            enable_hedging=False, hedge_deadline=0.5,
                            late_rho=2048, calibrate=True),
        stage2=Stage2Spec(enabled=True, k_serve=64, t_final=10),
        deploy=DeploySpec(n_shards=1, replicas=2),
        # capacity-first: wider batches, a longer forming window
        online=OnlineSpec(max_batch=64, batch_deadline_us=10.0,
                          admission=True, degrade=True),
    )


def _quality() -> CascadeSpec:
    return CascadeSpec(
        name="quality",
        routing=RoutingSpec(algorithm=2, budget=400.0, rho_max=1 << 18,
                            hedge_deadline=0.6, late_rho=8192,
                            calibrate=True),
        stage2=Stage2Spec(enabled=True, k_serve=256, t_final=20,
                          ltr_trees=64),
        deploy=DeploySpec(n_shards=1, replicas=2),
        # effectiveness-first: never degrade the grid — shed instead
        online=OnlineSpec(max_batch=16, batch_deadline_us=2.0,
                          admission=True, degrade=False),
    )


def _stage1_only() -> CascadeSpec:
    return CascadeSpec(
        name="stage1_only",
        routing=RoutingSpec(algorithm=2, budget=200.0, rho_max=1 << 18,
                            hedge_deadline=0.5, late_rho=4096,
                            calibrate=True),
        stage2=Stage2Spec(enabled=False, k_serve=128, t_final=10),
        deploy=DeploySpec(n_shards=1, replicas=2),
    )


def _fault_tolerant() -> CascadeSpec:
    # bound check (paper_scale, ms): reissue = 0.45*B1 + (3 + 4096*0.0064)
    # + retry(2*25) = 90 + 29.2 + 50 = 169.2 < B1 after the Stage-2
    # reservation — the hard guarantee still collapses to the budget with
    # the whole retry cascade charged in (see SchedulerConfig.retry_us)
    return CascadeSpec(
        name="fault_tolerant",
        routing=RoutingSpec(algorithm=2, budget=200.0, rho_max=1 << 18,
                            hedge_deadline=0.45, late_rho=4096,
                            adapt_every=1, calibrate=True,
                            failover_timeout=25.0, max_retries=2),
        stage2=Stage2Spec(enabled=True, k_serve=128, t_final=10),
        deploy=DeploySpec(n_shards=4, replicas=3),
        online=OnlineSpec(max_batch=32, batch_deadline_us=5.0,
                          admission=True, degrade=True),
    )


def _cached() -> CascadeSpec:
    return CascadeSpec(
        name="cached",
        # adapt_every=0: online threshold adaptation would rewrite the
        # route signature embedded in every cache key (stale hits are
        # impossible either way, but churning keys wastes the cache)
        routing=RoutingSpec(algorithm=2, budget=200.0, rho_max=1 << 18,
                            hedge_deadline=0.5, late_rho=4096,
                            adapt_every=0, calibrate=True),
        stage2=Stage2Spec(enabled=True, k_serve=128, t_final=10),
        deploy=DeploySpec(n_shards=1, replicas=2),
        online=OnlineSpec(max_batch=32, batch_deadline_us=5.0,
                          admission=True, degrade=True),
        cache=CacheSpec(enabled=True),
    )


def _live_ingest() -> CascadeSpec:
    # the delta capacities are budget-sized, not storage-sized: the
    # worst-case delta scan (delta_time(8192 postings) + the dense tiles
    # over 256 capacity docs when dense is on) is charged into EVERY
    # query's bound, so an oversized delta would push the full-service
    # floor past the 200 ms budget and shed everything.  delta_docs must
    # also stay >= k_serve so the delta pseudo-shard can fill a top-k.
    # adapt_every=0 for the same reason as `cached`: ingest bumps the
    # cache epoch on every applied batch, and stable route signatures
    # keep the event log replayable bit-for-bit.
    return CascadeSpec(
        name="live_ingest",
        routing=RoutingSpec(algorithm=2, budget=200.0, rho_max=1 << 18,
                            hedge_deadline=0.5, late_rho=4096,
                            adapt_every=0, calibrate=True),
        stage2=Stage2Spec(enabled=True, k_serve=128, t_final=10),
        deploy=DeploySpec(n_shards=1, replicas=2),
        online=OnlineSpec(max_batch=32, batch_deadline_us=5.0,
                          admission=True, degrade=True),
        ingest=IngestSpec(enabled=True, delta_docs=256, delta_postings=8192,
                          feed_qps=8.0, feed_batch=16,
                          merge_threshold=0.6),
    )


def _hybrid_fusion() -> CascadeSpec:
    # theta bands sit inside the observed top-1 dense score range of both
    # embedding sources (~0.23–0.58 on the experiment collection), so all
    # five routes — lexical, dense, fused, theta-skip, theta-fallback —
    # actually carry traffic.  adapt_every=0 for the same reason as
    # `cached`: the resolved modality is part of the route signature.
    return CascadeSpec(
        name="hybrid_fusion",
        routing=RoutingSpec(algorithm=2, budget=200.0, rho_max=1 << 18,
                            hedge_deadline=0.5, late_rho=4096,
                            adapt_every=0, calibrate=True),
        stage2=Stage2Spec(enabled=True, k_serve=128, t_final=10),
        deploy=DeploySpec(n_shards=1, replicas=2),
        online=OnlineSpec(max_batch=32, batch_deadline_us=5.0,
                          admission=True, degrade=True),
        dense=DenseSpec(enabled=True, source="auto", fuse_band=0.25,
                        theta_high=0.45, theta_low=0.25),
        fusion=FusionSpec(method="rrf"),
    )


PRESETS = {
    "paper_200ms": _paper_200ms,
    "throughput": _throughput,
    "quality": _quality,
    "stage1_only": _stage1_only,
    "fault_tolerant": _fault_tolerant,
    "cached": _cached,
    "live_ingest": _live_ingest,
    "hybrid_fusion": _hybrid_fusion,
}


def get_preset(name: str, **overrides) -> CascadeSpec:
    """A fresh validated spec for a named operating point.

    ``overrides`` replace top-level ``CascadeSpec`` fields (already-built
    node values, e.g. ``deploy=DeploySpec(n_shards=4)``).
    """
    try:
        spec = PRESETS[name]()
    except KeyError:
        raise ValueError(f"unknown preset {name!r}; "
                         f"available: {sorted(PRESETS)}") from None
    if overrides:
        spec = dataclasses.replace(spec, **overrides)
    return spec.validate()
