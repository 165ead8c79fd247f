"""Spec-driven serving dry-run: cost a :class:`CascadeSpec` against a query
log *before* building the index.

The mesh dry-run of the reference (``repro.launch.dryrun``, not ported)
answers "does this model fit and what do the rooflines say" without
training; this is the serving-side counterpart: given an operating point (preset or spec JSON) and a corpus +
query trace, it predicts the cascade's latency distribution, budget
violations, and the hard worst-case bound from *collection statistics
alone* — document frequencies read straight off the corpus postings, no
inverted index, tile mirrors, or trained predictors required.  An operator
can therefore cost a ``DeploySpec`` (shards × replicas, ρ caps, budget,
late-hedge knobs) in seconds and only then pay for the build.

The costing is **hybrid**: pre- and post-build share one code path
(:class:`WorkProxies`), only the statistics powering the proxies differ.

Pre-build (corpus df only — deliberately conservative upper bounds):

* BMW/DAAT work per query = the full posting mass of its terms scaled by
  ``daat_prune`` (1.0 = exhaustive upper bound; the paper's dynamic
  pruning typically evaluates far less); blocks = mass / block_size;
* JASS/SAAT work = ``min(ρ, mass)`` — the anytime traversal can never do
  more than its budget nor more than the postings that exist;

Post-build (``index=`` given — strictly more accurate, same schema):

* df comes off the built index (stoplist already applied);
* JASS work resolves the ρ budget against the index's **real impact-level
  table** (``level_cum``) to the same global level cut the serving system
  uses — the exact posting count the traversal would touch, instead of
  the ``min(ρ, mass)`` ceiling;
* BMW blocks come from the real block-max structure (``block_count > 0``
  per term) instead of the perfectly-packed ``mass / block_size``
  estimate (a lower bound — the real spread is wider).

Either way, scatter-gather splits work uniformly across ``n_shards``
doc-range shards (the expectation under random doc placement) and charges
``CostModel.gather_time``.

The port of ``repro.launch.dryrun_cascade``: NumPy over the port's
``corpus``, ``latency``, ``scheduler``, ``spec`` and
``system.scheduler_config``, with no device involved, so its dict equals
the reference's, pre-build and post-build.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun_cascade --preset paper_200ms
  PYTHONPATH=src python -m repro_torch.launch.dryrun_cascade \
      --spec-json spec.json --n-docs 65536 --queries 31642 --out dry.json
  PYTHONPATH=src python -m repro_torch.launch.dryrun_cascade --build-index
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np

from repro_torch.index.corpus import Corpus, QueryLog, build_queries
from repro_torch.serving.latency import (CostModel, budget_attribution,
                                         over_budget, percentiles,
                                         resolve_level_cut, stage2_afford)
from repro_torch.serving.scheduler import StageZeroScheduler
from repro_torch.serving.spec import CascadeSpec
from repro_torch.serving.system import scheduler_config

# bytes per posting in the device mirrors: docid+impact int32 lanes (SAAT)
# + docid+score+block metadata (DAAT) — matches serving/latency.py
_MIRROR_BYTES_PER_POSTING = 8 + 10


def corpus_df(corpus: Corpus, stop_k: int = 0) -> np.ndarray:
    """Per-term document frequencies straight off the corpus postings —
    the only collection statistic the pre-build dry-run needs.
    ``stop_k`` zeroes the stoplisted most-frequent terms, matching what
    ``build_index`` would drop."""
    df = np.bincount(corpus.postings_term, minlength=corpus.vocab)
    df[:stop_k] = 0
    return df


class WorkProxies:
    """Per-query Stage-1 work estimates — the single code path behind the
    hybrid pre/post-build costing (see module docstring).

    Pre-build, only ``df`` is known; post-build, the real impact-level
    table sharpens JASS work to the exact global level cut (never above
    the ``min(ρ, mass)`` ceiling) and the real block-max structure
    replaces the perfectly-packed ``mass / block_size`` block estimate
    with the true per-term block spread — which can only be wider, so the
    pre-build path *under*-costs DAAT block overhead."""

    def __init__(self, df: np.ndarray, block_size: int,
                 level_cum: np.ndarray | None = None,
                 blocks_per_term: np.ndarray | None = None):
        self.df = np.asarray(df, np.float64)
        self.block_size = block_size
        self.level_cum = level_cum
        self.blocks_per_term = (None if blocks_per_term is None
                                else np.asarray(blocks_per_term, np.float64))

    @classmethod
    def from_corpus(cls, corpus: Corpus, spec: CascadeSpec) -> "WorkProxies":
        return cls(corpus_df(corpus, spec.index.stop_k),
                   spec.index.block_size)

    @classmethod
    def from_index(cls, index, spec: CascadeSpec) -> "WorkProxies":
        return cls(index.df, index.block_size,
                   level_cum=np.asarray(index.level_cum),
                   blocks_per_term=(np.asarray(index.block_count) > 0)
                   .sum(axis=1))

    @property
    def post_build(self) -> bool:
        return self.level_cum is not None

    def mass(self, terms, mask) -> np.ndarray:
        return (self.df[terms] * (mask > 0)).sum(axis=1)

    def bmw(self, terms, mask, daat_prune: float = 1.0):
        """(work, blocks) for a BMW/DAAT traversal."""
        work = self.mass(terms, mask) * daat_prune
        if self.blocks_per_term is None:
            blocks = work / self.block_size
        else:
            blocks = ((self.blocks_per_term[terms] * (mask > 0))
                      .sum(axis=1) * daat_prune)
        return work, blocks

    def jass(self, terms, mask, rows, rho) -> np.ndarray:
        """Postings a ρ-budgeted SAAT traversal touches for ``rows``."""
        rho = np.asarray(rho, np.float64)
        if self.level_cum is None:
            # row-local mass: don't re-reduce the whole query log just to
            # index a subset (jass_fn is called per enforcement mode and
            # per late-hedge re-issue)
            return np.minimum(rho, self.mass(terms[rows], mask[rows]))
        # the served system's own resolution (shared helper — see
        # SearchSystem._jass_split): the ρ budget picks the deepest
        # global impact-level cut that fits
        m = (mask[rows] > 0)[:, :, None]
        totals = (self.level_cum[terms[rows]] * m).sum(axis=1)  # (R, L)
        lstar, any_ok = resolve_level_cut(totals, rho)
        rr = np.arange(len(rows))
        return np.where(any_ok, totals[rr, lstar], 0).astype(np.float64)


def dryrun(spec: CascadeSpec, corpus: Corpus, ql: QueryLog | None = None,
           n_queries: int = 2000, seed: int = 7,
           daat_prune: float = 1.0, index=None) -> dict:
    """Modeled cascade latency for ``spec`` over a query log; returns the
    percentile table, violations with and without enforcement, the analytic
    worst-case bound, and a deployment size estimate.

    ``index``: an already-built :class:`~repro_torch.index.builder.InvertedIndex`
    switches the work proxies to its real block-max / impact-level
    distributions (strictly more accurate; same output schema)."""
    spec.validate()
    cost = getattr(CostModel, spec.backend.cost)()
    proxies = (WorkProxies.from_index(index, spec) if index is not None
               else WorkProxies.from_corpus(corpus, spec))
    if ql is None:
        ql = build_queries(corpus, n_queries, stop_k=spec.index.stop_k,
                           seed=seed)
    q = len(ql.terms)
    ns = spec.deploy.n_shards
    mass = proxies.mass(ql.terms, ql.mask)

    # Stage-0 proxy predictions: the same posting-mass recipe fit() uses
    # for pseudo-labels, so routing exercises both mirrors realistically
    rng = np.random.RandomState(seed)
    noise = [np.exp(rng.randn(q) * 0.3) for _ in range(3)]
    pred_k = mass * 0.05 * noise[0]
    pred_rho = mass * 0.5 * noise[1]
    work_bmw, blocks_bmw = proxies.bmw(ql.terms, ql.mask, daat_prune)
    pred_t = cost.daat_time(work_bmw, blocks_bmw) * noise[2]

    # the same budget attribution SearchSystem.set_models applies
    cfg = scheduler_config(spec.routing)
    reserve = budget_attribution(
        cfg.budget, cost,
        spec.stage2.k_serve if spec.stage2.enabled else None)
    reserve2, budget1 = reserve["stage2"], reserve["stage1"]
    if spec.dense.enabled:
        # mirror SearchSystem._attribute_budget: the fusion merge is carved
        # out of the stage-1 share so both-routed queries stay in bound
        budget1 = max(budget1 - cost.fusion_us, 0.0)

    # dense Stage-1 is shape-static: every query scores every doc tile of
    # its shard, so the per-shard time is exact from the spec alone —
    # ceil(shard_docs / tile_d) tiles through CostModel.dense_time
    dense_tiles = 0
    t_dense_r = None
    if spec.dense.enabled:
        shard_docs = -(-corpus.n_docs // ns)       # largest contiguous range
        dense_tiles = -(-shard_docs // spec.dense.tile_d)
        t_dense_r = cost.gather_time(np.broadcast_to(
            cost.dense_time(dense_tiles), (ns, q)))

    def shardwise(time_fn, work, *extra):
        per = [time_fn(work / ns, *(e / ns for e in extra))
               for _ in range(ns)]
        return cost.gather_time(np.stack(per))

    t_bmw = shardwise(cost.daat_time, work_bmw, blocks_bmw)

    def jass_fn(rows, rho):
        work = proxies.jass(ql.terms, ql.mask, rows, rho)
        return shardwise(cost.saat_time, work)

    out = {}
    for mode, mode_cfg in (
            ("enforced", dataclasses.replace(cfg, budget=budget1)),
            ("unenforced", dataclasses.replace(
                cfg, budget=budget1, enforce_budget=False,
                late_rho=cfg.rho_max))):
        sched = StageZeroScheduler(mode_cfg, cost)
        routed = sched.route(pred_k, pred_rho, pred_t)
        modality = None
        if spec.dense.enabled:
            # the same dispatch rule SearchSystem._modality applies, on the
            # same predicted traversal time the router saw
            ds = spec.dense
            td = ds.t_dense if ds.t_dense > 0 else sched.cfg.t_time
            modality = np.full(q, 2, np.int64)
            modality[pred_t <= td * (1.0 - ds.fuse_band)] = 0
            modality[pred_t > td * (1.0 + ds.fuse_band)] = 1
            lex = modality != 1

            def keep(rows, stat):
                kept = rows[lex[rows]]
                sched.stats[stat] -= int(len(rows) - len(kept))
                return kept

            routed = dataclasses.replace(
                routed, jass_rows=keep(routed.jass_rows, "jass"),
                bmw_rows=keep(routed.bmw_rows, "bmw"),
                hedged_rows=keep(routed.hedged_rows, "hedged"))
        lat01 = sched.resolve_times(routed, t_bmw, jass_fn)
        if modality is not None:
            pd = cost.predict_us
            lat01 = np.where(modality == 1, pd + t_dense_r, lat01)
            lat01 = np.where(modality == 2,
                             pd + np.maximum(lat01 - pd, t_dense_r)
                             + cost.fusion_us, lat01)
        lat = lat01
        trimmed = skipped = 0
        if spec.stage2.enabled:
            k2 = np.minimum(routed.k, spec.stage2.k_serve)
            if mode_cfg.enforce_budget:
                afford = stage2_afford(cost, cfg.budget - lat01,
                                       spec.stage2.k_serve)
                trimmed = int(np.sum((0 < afford) & (afford < k2)))
                skipped = int(np.sum((afford == 0) & (k2 > 0)))
                k2 = np.minimum(k2, afford)
            lat = lat01 + np.where(k2 > 0, cost.ltr_time(k2), 0.0)
        n_over, pct = over_budget(lat, cfg.budget)
        out[mode] = {"percentiles": percentiles(lat),
                     "over_budget": n_over, "over_budget_pct": pct,
                     "routed": {k: int(sched.stats[k]) for k in
                                ("jass", "bmw", "hedged", "late_hedged",
                                 "late_hedged_jass")},
                     "stage2_trimmed": trimmed, "stage2_skipped": skipped}
        if modality is not None:
            out[mode]["dense"] = {
                "lexical": int(np.sum(modality == 0)),
                "dense_only": int(np.sum(modality == 1)),
                "fused": int(np.sum(modality == 2))}

    n_postings = int(corpus.n_postings)
    enforced_cfg = dataclasses.replace(cfg, budget=budget1)
    bound = enforced_cfg.worst_case_us(cost, ns)
    if spec.dense.enabled:
        # the same dense/both/fallback route bounds SearchSystem.
        # worst_case_us charges — analytic, from the tile count alone
        pd = cost.predict_us
        gather = cost.gather_per_shard_us * (ns - 1)
        td_b = (float(cost.dense_time(dense_tiles)) + gather
                + enforced_cfg.retry_us())
        fb = (float(cost.saat_time(np.float64(
                  enforced_cfg.resolved_late_rho()))) + gather
              if np.isfinite(spec.dense.theta_low) else 0.0)
        bound = max(bound, pd + td_b + fb,
                    pd + max(bound - pd, td_b) + cost.fusion_us)
    out["config"] = {
        "spec": spec.name, "n_queries": q, "n_shards": ns,
        "replicas": spec.deploy.replicas, "budget": cfg.budget,
        "stage1_budget": budget1, "daat_prune": daat_prune,
        "costing": "index" if proxies.post_build else "corpus",
        "worst_case_bound": bound + reserve2,
        "dense_tiles": dense_tiles,
        "max_late_rho": enforced_cfg.max_late_rho(cost, ns),
        "late_rho": enforced_cfg.resolved_late_rho(),
    }
    out["deploy_estimate"] = {
        "n_postings": n_postings,
        "mirror_bytes_per_shard": (n_postings * _MIRROR_BYTES_PER_POSTING
                                   // ns),
        "total_replica_bytes": (n_postings * _MIRROR_BYTES_PER_POSTING
                                * spec.deploy.replicas),
    }
    return out


def render(res: dict) -> str:
    c = res["config"]
    lines = [f"dryrun spec={c['spec']} shards={c['n_shards']} "
             f"costing={c.get('costing', 'corpus')} "
             f"budget={c['budget']:.1f} (stage-1 {c['stage1_budget']:.1f}) "
             f"late_rho={c['late_rho']} (max admissible "
             f"{c['max_late_rho']}) bound={c['worst_case_bound']:.1f}",
             "mode,p50,p99,p99.99,max,over_budget,late_hedged"]
    for mode in ("enforced", "unenforced"):
        r = res[mode]
        p = r["percentiles"]
        late = r["routed"]["late_hedged"] + r["routed"]["late_hedged_jass"]
        lines.append(f"{mode},{p['p50']:.1f},{p['p99']:.1f},"
                     f"{p['p99.99']:.1f},{p['max']:.1f},"
                     f"{r['over_budget']},{late}")
        if "dense" in r:
            d = r["dense"]
            lines.append(f"  dense mix: lex={d['lexical']} "
                         f"dense={d['dense_only']} fused={d['fused']} "
                         f"({c['dense_tiles']} tiles/shard)")
    d = res["deploy_estimate"]
    lines.append(f"deploy: {d['n_postings']} postings, "
                 f"{d['mirror_bytes_per_shard'] / 1e6:.1f} MB mirror/shard, "
                 f"{d['total_replica_bytes'] / 1e6:.1f} MB total replicas")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="paper_200ms")
    ap.add_argument("--spec-json", default=None,
                    help="cost a serialized CascadeSpec instead of a preset")
    ap.add_argument("--n-docs", type=int, default=16384)
    ap.add_argument("--vocab", type=int, default=8192)
    ap.add_argument("--queries", type=int, default=2000)
    ap.add_argument("--shards", type=int, default=None)
    ap.add_argument("--daat-prune", type=float, default=1.0,
                    help="fraction of posting mass BMW evaluates "
                         "(1.0 = exhaustive upper bound)")
    ap.add_argument("--build-index", action="store_true",
                    help="build the index first and cost from its real "
                         "block-max/impact distributions (post-build "
                         "hybrid path)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from repro_torch.configs.cascade_presets import get_preset
    from repro_torch.index.corpus import CorpusParams, build_corpus

    if args.spec_json:
        with open(args.spec_json) as f:
            spec = CascadeSpec.from_json(f.read())
    else:
        spec = get_preset(args.preset)
    if args.shards is not None:
        spec = dataclasses.replace(
            spec, deploy=dataclasses.replace(spec.deploy,
                                             n_shards=args.shards))
    corpus = build_corpus(CorpusParams(n_docs=args.n_docs, vocab=args.vocab,
                                       avg_doclen=150, zipf_a=1.05))
    index = None
    if args.build_index:
        from repro_torch.index.builder import build_index
        index = build_index(corpus, block_size=spec.index.block_size,
                            stop_k=spec.index.stop_k)
    res = dryrun(spec, corpus, n_queries=args.queries,
                 daat_prune=args.daat_prune, index=index)
    print(render(res))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=2, default=float)
            f.write("\n")
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
