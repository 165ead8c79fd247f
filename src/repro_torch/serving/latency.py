"""First-stage latency model + percentile accounting.

The tail-latency study uses a *calibrated cost model* driven by the
per-query work counters the engines report (postings scored, blocks
touched).  The constants are the reference's, derived from the roofline
terms of its Pallas kernels on a TPU v5e:

impact_accumulate (SAAT):
  * HBM traffic/posting: 4 B docid + 4 B impact (int32 lanes)      = 8 B
  * MXU work/posting: one column of a (P_tile × 512) one-hot matmul
    = 512 MAC = 1024 flop
  * time/posting = max(8 B / 819 GB/s, 1024 / 197e12) ≈ max(9.8, 5.2) ps
    → memory-bound: c_s ≈ 9.8 ps/posting (we use 10 ps)

blockmax_score (DAAT):
  * HBM traffic/posting: 4 B docid + 4 B score + bound metadata     ≈ 10 B
    → c_d ≈ 12.2 ps/posting; per surviving block: tile setup + bound
    refinement ≈ 0.2 µs (grid-step overhead at ~1 GHz scalar core)
  * fixed per-query: bound accumulation + two top-k passes ≈ 20 µs

The paper's 200 ms budget on a 50 M-doc Xeon ISN maps to ≈ 200 µs on a v5e
shard at these rates (same ×10⁶ scale as postings/ISN); all experiments
report budget-relative numbers so the scale factor is transparent.

Guarantee accounting
--------------------
The cascade's hard tail bound decomposes over this model, term by term.
With ``B`` the *cascade* budget, ``d`` the detection fraction
(``hedge_deadline``), ``ρ_late`` the late-hedge cap and ``C`` the Stage-2
candidate width (``k_serve``):

    stage 0:   predict_us                              (unconditional)
    stage 1:   max(B₁,  d·B₁ + saat_fixed + ρ_late·saat_per_posting)
               where B₁ = B - predict_us - ltr_time(C)  is the scheduler's
               reserved first-stage budget
    stage 2:   ltr_fixed + C·ltr_per_candidate  =  ltr_time(C)

so total ≤ B whenever ``saat_fixed + ρ_late·saat_per_posting ≤ (1-d)·B₁``
(``SchedulerConfig.max_late_rho`` computes the largest such ρ_late).  The
roofline constants above are the *static* prior; ``CostModel.regressed``
replaces them with rates fit to measured (work, latency) pairs so the
bound is enforced against observed hardware, not the datasheet.

A copy of ``repro.serving.latency``.  The constants are the reference's
modeled rates (a virtual clock), kept unchanged so the port's modeled
latencies equal the reference's for equal work counters; they are not
measurements of the port on any device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

PS = 1e-6  # picoseconds -> microseconds


@dataclass(frozen=True)
class CostModel:
    """Cascade cost model — Stage-0 prediction, Stage-1 engines and the
    Stage-2 LTR re-ranker.  Units are abstract "time units" fixed by the
    constructor used; the tail-latency study uses ``paper_scale`` (ms).

    Stage-0 is the fused three-predictor call (``predict_us`` covers all of
    k/ρ/t — the paper's < 0.75 ms budget).  Stage-2 is a fixed dispatch
    cost plus a per-candidate term: featurization is O(|q| · log df) gathers
    and GBRT inference O(trees · depth) per candidate, both linear in the
    candidate count the Stage-0 P_k prediction admits."""
    saat_fixed_us: float = 10.0
    saat_per_posting_us: float = 10.0 * PS
    daat_fixed_us: float = 20.0
    daat_per_posting_us: float = 12.2 * PS
    daat_per_block_us: float = 0.2
    predict_us: float = 0.75  # paper §5: <0.75 ms per prediction, scaled
    ltr_fixed_us: float = 5.0
    ltr_per_candidate_us: float = 0.04
    # scatter-gather: per-extra-shard fan-out/merge overhead.  A sharded
    # Stage-1 finishes at max-over-shards + this term — the tail is a max,
    # which is the paper's tail story at deployment scale.  0 keeps the
    # single-shard pipeline's accounting bit-identical.
    gather_per_shard_us: float = 0.0
    # result-cache lookup: key normalization + one dict probe, charged to
    # EVERY query when a ServingCache is attached (hits serve at
    # predict + this; misses pay it on top of the cascade), and added to
    # worst_case_us so the guarantee stays analytic with caching on.
    cache_hit_us: float = 0.5
    # dense Stage-1 modality: per-shard time is fixed dispatch + a term per
    # kernel grid tile — SHAPE-STATIC (every query scores every tile), so
    # the dense route's worst case is exact from the spec alone.  fusion_us
    # is the host-side list merge for both-routed queries; set_models
    # reserves it out of the scheduler's stage-1 budget so fused routes
    # stay inside the cascade bound.
    dense_fixed_us: float = 5.0
    dense_tile_us: float = 0.5
    fusion_us: float = 1.0

    @classmethod
    def v5e_shard(cls) -> "CostModel":
        """Roofline-derived per-chip constants (µs) for a production
        196k-doc / ~59M-posting shard — see module docstring."""
        return cls()

    @classmethod
    def paper_scale(cls) -> "CostModel":
        """Milliseconds on the experiment corpus. The synthetic collection is
        ~763× smaller than ClueWeb09B (65,536 vs 50M docs), so one synthetic
        posting stands in for ~763 real ones; constants are the v5e rates ×
        763 × 1e3(µs→ns floor), tuned so the *exhaustive* DAAT median lands
        near the paper's ~30–40 ms and tails cross 200 ms — making the
        paper's 200 ms budget directly meaningful."""
        return cls(saat_fixed_us=3.0, saat_per_posting_us=6.4e-3,
                   daat_fixed_us=4.0, daat_per_posting_us=7.6e-3,
                   daat_per_block_us=25e-3, predict_us=0.75,
                   ltr_fixed_us=1.0, ltr_per_candidate_us=15e-3,
                   cache_hit_us=0.05, dense_fixed_us=2.0,
                   dense_tile_us=0.05, fusion_us=0.5)

    def saat_time(self, work: np.ndarray) -> np.ndarray:
        return self.saat_fixed_us + work * self.saat_per_posting_us

    def daat_time(self, work: np.ndarray, blocks: np.ndarray) -> np.ndarray:
        return (self.daat_fixed_us + work * self.daat_per_posting_us
                + blocks * self.daat_per_block_us)

    def ltr_time(self, n_candidates: np.ndarray) -> np.ndarray:
        """Stage-2 re-ranking time from the per-query candidate count."""
        return (self.ltr_fixed_us
                + np.asarray(n_candidates, np.float64)
                * self.ltr_per_candidate_us)

    def dense_time(self, n_tiles) -> np.ndarray:
        """Per-shard dense Stage-1 time from the kernel grid tile count.
        Shape-static: a dense query's cost depends only on the shard's doc
        count and ``tile_d``, never on the query — which is what lets
        ``worst_case_us`` and the spec dry-run price dense routes exactly
        with no corpus statistics."""
        return (self.dense_fixed_us
                + np.asarray(n_tiles, np.float64) * self.dense_tile_us)

    def delta_time(self, n_postings: int) -> float:
        """Worst-case lexical delta-scan time for a capacity-``n_postings``
        live segment.  Shape-static: the charge is the segment's *capacity*,
        not its fill, so the bound never moves as documents stream in.  The
        delta pseudo-shard is scanned by whichever engine routes the query,
        so the charge takes the costlier per-posting rate plus the DAAT
        fixed cost (the larger of the two dispatch terms)."""
        return (self.daat_fixed_us
                + max(self.saat_per_posting_us, self.daat_per_posting_us)
                * float(n_postings))

    def gather_time(self, t_shards: np.ndarray) -> np.ndarray:
        """Scatter-gather Stage-1 time over an (n_shards, Q) per-shard time
        matrix: the query finishes when its *slowest* shard responds, plus
        the per-extra-shard fan-out/merge overhead."""
        t = np.asarray(t_shards, np.float64)
        return t.max(axis=0) + self.gather_per_shard_us * (t.shape[0] - 1)

    def regressed(self, *, work_saat=None, t_saat=None, work_daat=None,
                  blocks_daat=None, t_daat=None,
                  max_rel_err: float = 0.1) -> "CostModel":
        """Fold measured (work, latency) pairs back into the model.

        Least-squares fits ``t_saat ≈ f_s + w·c_s`` and
        ``t_daat ≈ f_d + w·c_d + b·c_b`` and returns a model whose
        constants are the *measured* rates, replacing the static roofline
        prior — the online half of the tail guarantee (see module
        docstring).  A fit is rejected (that term keeps its prior) when it
        produces non-positive rates or its median relative residual
        exceeds ``max_rel_err`` — a mis-instrumented trace must not relax
        the enforcement constants.
        """
        import dataclasses
        updates: dict = {}

        def _fit(a, y, names):
            sol, *_ = np.linalg.lstsq(a, y, rcond=None)
            pred = a @ sol
            rel = np.abs(pred - y) / np.maximum(np.abs(y), 1e-12)
            if np.any(sol <= 0) or float(np.median(rel)) > max_rel_err:
                return
            updates.update(zip(names, (float(s) for s in sol)))

        if t_saat is not None and work_saat is not None and len(t_saat) >= 2:
            w = np.asarray(work_saat, np.float64)
            _fit(np.stack([np.ones_like(w), w], axis=1),
                 np.asarray(t_saat, np.float64),
                 ("saat_fixed_us", "saat_per_posting_us"))
        if (t_daat is not None and work_daat is not None
                and blocks_daat is not None and len(t_daat) >= 3):
            w = np.asarray(work_daat, np.float64)
            b = np.asarray(blocks_daat, np.float64)
            _fit(np.stack([np.ones_like(w), w, b], axis=1),
                 np.asarray(t_daat, np.float64),
                 ("daat_fixed_us", "daat_per_posting_us",
                  "daat_per_block_us"))
        return dataclasses.replace(self, **updates) if updates else self


def budget_attribution(budget: float, cost: CostModel,
                       k_serve: int | None) -> dict:
    """Split a cascade budget into per-stage reserves (see *Guarantee
    accounting*): stage 0 gets the unconditional prediction cost, stage 2
    its deterministic worst case ``ltr_time(k_serve)`` (0 when Stage-2 is
    disabled — pass ``k_serve=None``), and stage 1 the remainder, which is
    the budget the scheduler's deadline re-route enforces.  The single
    source of truth for ``SearchSystem.set_models``, the spec dry-run, and
    ``bench_tail``."""
    reserve2 = (float(cost.ltr_time(np.asarray(k_serve)))
                if k_serve is not None else 0.0)
    return {"stage0": cost.predict_us,
            "stage1": max(budget - cost.predict_us - reserve2, 0.0),
            "stage2": reserve2}


def resolve_level_cut(totals: np.ndarray, rho) -> tuple[np.ndarray,
                                                        np.ndarray]:
    """(lstar, any_ok): the deepest global impact-level cut whose total
    work fits each row's ρ budget, over a (R, n_levels) cumulative-work
    table.  The single resolution policy shared by the serving system
    (``SearchSystem._jass_split``) and the spec dry-run
    (``launch.dryrun_cascade.WorkProxies``) — SAAT exactness across both
    depends on them agreeing."""
    ok = totals <= np.asarray(rho).reshape(-1, 1)
    return np.argmax(ok, axis=1), ok.any(axis=1)


def stage2_afford(cost: CostModel, remaining: np.ndarray,
                  k_serve: int) -> np.ndarray:
    """Largest per-query candidate count whose ``ltr_time`` fits in the
    remaining budget, in [0, k_serve].  0 means skip Stage-2 outright; the
    epsilon keeps an exactly-affordable ``k_serve`` from rounding down."""
    afford = np.floor((np.asarray(remaining, np.float64)
                       - cost.ltr_fixed_us)
                      / max(cost.ltr_per_candidate_us, 1e-12) + 1e-9)
    return np.clip(afford, 0, k_serve).astype(np.int64)


def percentiles(t: np.ndarray) -> dict:
    t = np.asarray(t)
    if t.size == 0:
        raise ValueError("percentiles() needs a non-empty latency array "
                         "(served batch was empty)")
    return {
        "mean": float(np.mean(t)),
        "p50": float(np.percentile(t, 50)),
        "p95": float(np.percentile(t, 95)),
        "p99": float(np.percentile(t, 99)),
        "p99.9": float(np.percentile(t, 99.9)),
        "p99.99": float(np.percentile(t, 99.99)),
        "max": float(np.max(t)),
    }


def over_budget(t: np.ndarray, budget_us: float) -> tuple[int, float]:
    """(count, percentage) of queries over budget; an empty batch has no
    violators."""
    t = np.asarray(t)
    if t.size == 0:
        return 0, 0.0
    n = int(np.sum(t > budget_us))
    return n, 100.0 * n / t.size
