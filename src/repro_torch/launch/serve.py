"""Serving entry point: name an operating point, build the system it
describes, fit it, and serve a query trace through the multi-shard cascade
with end-to-end tail-latency accounting, on the card.

The port of ``repro.launch.serve``, with the reference's flags and its
``[serve]`` lines, word for word, plus ``--device`` (default: the card;
``--device cpu`` runs the kernels' plain versions):

    python -m repro_torch.launch.serve --preset paper_200ms --shards 3
    python -m repro_torch.launch.serve --device cpu --n-docs 2048 \\
        --vocab 1024 --queries 128

The default path is the reference's: corpus, ``build_system``, the label
oracle (``generate_labels`` with ``LabelConfig(max_k=4096, batch=256)`` and
the system's cost model, on the host), ``SearchSystem.fit`` on the labels
(``--pseudo-labels``: the cheap pseudo-labels), then one ``serve`` of the
whole trace.  ``--dryrun`` costs the spec from the corpus alone
(``repro_torch.launch.dryrun_cascade``) and ``--spec-json`` writes the
resolved spec, both before anything is built.  Flags that need a node the
port does not have yet (online serving, the result cache, fault scenarios,
live ingest, telemetry) raise ``NotImplementedError`` naming its ROADMAP
item, when set to anything but their defaults; ``--spec-json`` still
writes the spec they describe, as the reference does.

``run(argv)`` does the work and returns a :class:`Served`; ``main`` prints
its result.  Tests and ``chip_smoke.py`` call ``run`` in-process.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from dataclasses import dataclass

import torch

from repro_torch.configs.cascade_presets import get_preset
from repro_torch.core.labels import LabelConfig, LabelSet, generate_labels
from repro_torch.index.corpus import (Corpus, CorpusParams, QueryLog,
                                      build_corpus, build_queries)
from repro_torch.isn.backend import resolve_device
from repro_torch.launch.dryrun_cascade import dryrun, render
from repro_torch.serving.spec import CascadeSpec, FaultSpec
from repro_torch.serving.system import (PipelineResult, SearchSystem,
                                        _unported, build_system)

# flags whose nodes are not ported, by the ROADMAP item that ports them;
# each raises when set to anything but its default
UNPORTED = {
    "Online serving": ("online", "arrival", "qps", "load", "zipf_skew",
                       "trace_path", "traffic_seed"),
    "Result cache": ("cache", "cache_entries", "cache_bytes"),
    "Live ingest": ("ingest", "feed_qps", "delta_docs", "delta_postings"),
    "Telemetry": ("metrics_json", "metrics_prom", "trace_slowest"),
}


@dataclass
class Served:
    """What one CLI run built and served (``None`` where its path stopped
    first: ``--spec-json`` stops before the corpus, ``--dryrun`` after)."""
    spec: CascadeSpec                     # the resolved spec, before fit
    fitted: CascadeSpec | None = None     # the system's spec after fit
                                          # (calibrated thresholds), before
                                          # serving adapts them
    corpus: Corpus | None = None
    ql: QueryLog | None = None
    system: SearchSystem | None = None
    labels: LabelSet | None = None        # None: pseudo-labels
    result: PipelineResult | None = None
    dryrun: dict | None = None
    walls: dict = dataclasses.field(default_factory=dict)   # seconds


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="paper_200ms",
                    help="named operating point "
                         "(repro_torch.configs.cascade_presets)")
    ap.add_argument("--device", default=None,
                    help="cuda | cpu (default: the card; raises without "
                         "one)")
    ap.add_argument("--shards", type=int, default=1,
                    help="doc-range shards for scatter-gather Stage-1")
    ap.add_argument("--replicas", type=int, default=2,
                    help="ISN replicas per shard partition")
    ap.add_argument("--n-docs", type=int, default=16384)
    ap.add_argument("--vocab", type=int, default=8192)
    ap.add_argument("--queries", type=int, default=2000)
    ap.add_argument("--budget", type=float, default=None,
                    help="override the preset's latency budget")
    ap.add_argument("--backend", default=None,
                    help="pallas | interpret | jnp: a spec field that "
                         "selects nothing (the device picks the path)")
    ap.add_argument("--no-ltr", action="store_true",
                    help="serve the first stage only (no Stage-2 re-rank)")
    ap.add_argument("--pseudo-labels", action="store_true",
                    help="skip the label oracle; fit on cheap pseudo-labels "
                         "(CI smokes)")
    ap.add_argument("--spec-json", default=None,
                    help="write the resolved spec to this path and exit")
    ap.add_argument("--dryrun", action="store_true",
                    help="cost the resolved spec against the query log "
                         "WITHOUT building the index (repro_torch.launch."
                         "dryrun_cascade) and exit")
    ap.add_argument("--online", action="store_true",
                    help="online serving: not ported (raises)")
    ap.add_argument("--arrival", default="poisson",
                    help="online arrival process (not ported)")
    ap.add_argument("--qps", type=float, default=None,
                    help="online offered load (not ported)")
    ap.add_argument("--load", type=float, default=0.8,
                    help="online load fraction (not ported)")
    ap.add_argument("--max-batch", type=int, default=None,
                    help="override the preset's micro-batch width cap "
                         "(a spec field)")
    ap.add_argument("--no-admission", action="store_true",
                    help="disable admission control (a spec field)")
    ap.add_argument("--cache", action="store_true",
                    help="the result cache: not ported (raises)")
    ap.add_argument("--cache-entries", type=int, default=None,
                    help="cache entry cap (not ported)")
    ap.add_argument("--cache-bytes", type=int, default=None,
                    help="cache byte cap (not ported)")
    ap.add_argument("--dense", action="store_true",
                    help="enable the dense Stage-1 modality: Stage-0 "
                         "dispatches each query lexical / dense / "
                         "both+fused (repro_torch.dense)")
    ap.add_argument("--fusion", default=None, choices=["rrf", "weighted"],
                    help="hybrid fusion method for both-routed queries "
                         "(implies --dense)")
    ap.add_argument("--theta-high", type=float, default=None,
                    help="top dense score above which Stage-2 is skipped "
                         "rank-safely (implies --dense)")
    ap.add_argument("--theta-low", type=float, default=None,
                    help="top dense score below which a rho_late-capped "
                         "lexical fallback replaces the dense candidates "
                         "(implies --dense)")
    ap.add_argument("--ingest", action="store_true",
                    help="live ingest: not ported (raises)")
    ap.add_argument("--feed-qps", type=float, default=None,
                    help="live ingest feed rate (not ported)")
    ap.add_argument("--delta-docs", type=int, default=None,
                    help="delta tile-set doc capacity (not ported)")
    ap.add_argument("--delta-postings", type=int, default=None,
                    help="delta tile-set postings capacity (not ported)")
    ap.add_argument("--zipf-skew", type=float, default=0.0,
                    help="online query-repetition skew (not ported)")
    ap.add_argument("--trace-path", default="",
                    help="online trace replay timestamps (not ported)")
    ap.add_argument("--traffic-seed", type=int, default=0,
                    help="online traffic seed (not ported)")
    ap.add_argument("--fault-scenario", default=None,
                    help="named fault schedule: not ported (raises)")
    ap.add_argument("--fault-json", default=None,
                    help="a FaultSpec from a JSON file (overrides "
                         "--fault-scenario); the system raises on an "
                         "active schedule")
    ap.add_argument("--failover-timeout", type=float, default=None,
                    help="scatter-gather shard timeout (cost units)")
    ap.add_argument("--max-retries", type=int, default=None,
                    help="bounded failover re-issues per (query, shard)")
    ap.add_argument("--fault-horizon", type=float, default=10_000.0,
                    help="horizon of a named fault scenario (not ported)")
    ap.add_argument("--metrics-json", default=None,
                    help="telemetry snapshot: not ported (raises)")
    ap.add_argument("--metrics-prom", default=None,
                    help="telemetry in Prometheus format (not ported)")
    ap.add_argument("--trace-slowest", type=int, default=0,
                    help="slowest query traces (not ported)")
    return ap


def _resolve_spec(args) -> CascadeSpec:
    """The preset with the flags' overrides, validated (the reference's
    resolution, field for field)."""
    spec = get_preset(args.preset)
    online = spec.online
    if args.max_batch is not None:
        online = dataclasses.replace(online, max_batch=args.max_batch)
    if args.no_admission:
        online = dataclasses.replace(online, admission=False)
    routing = spec.routing
    if args.budget is not None:
        routing = dataclasses.replace(routing, budget=args.budget)
    if args.failover_timeout is not None:
        routing = dataclasses.replace(routing,
                                      failover_timeout=args.failover_timeout)
    if args.max_retries is not None:
        routing = dataclasses.replace(routing, max_retries=args.max_retries)
    fault = spec.fault
    if args.fault_json:
        with open(args.fault_json) as f:
            fault = FaultSpec(**json.load(f))
    elif args.fault_scenario:
        raise _unported("--fault-scenario (the named schedules of "
                        "serving.faults)", "Fault injection and failover")
    cache = spec.cache
    if (args.cache or args.cache_entries is not None
            or args.cache_bytes is not None):
        kw = {"enabled": True}
        if args.cache_entries is not None:
            kw["l1_entries"] = kw["l2_entries"] = args.cache_entries
        if args.cache_bytes is not None:
            kw["l1_bytes"] = kw["l2_bytes"] = args.cache_bytes
        cache = dataclasses.replace(cache, **kw)
    ingest = spec.ingest
    if (args.ingest or args.feed_qps is not None
            or args.delta_docs is not None
            or args.delta_postings is not None):
        kw = {"enabled": True}
        if args.feed_qps is not None:
            kw["feed_qps"] = args.feed_qps
        if args.delta_docs is not None:
            kw["delta_docs"] = args.delta_docs
        if args.delta_postings is not None:
            kw["delta_postings"] = args.delta_postings
        ingest = dataclasses.replace(ingest, **kw)
    dense, fusion = spec.dense, spec.fusion
    if (args.dense or args.fusion is not None
            or args.theta_high is not None or args.theta_low is not None):
        kw = {"enabled": True}
        if args.theta_high is not None:
            kw["theta_high"] = args.theta_high
        if args.theta_low is not None:
            kw["theta_low"] = args.theta_low
        dense = dataclasses.replace(dense, **kw)
    if args.fusion is not None:
        fusion = dataclasses.replace(fusion, method=args.fusion)
    telemetry = spec.telemetry
    if args.metrics_json or args.metrics_prom or args.trace_slowest:
        telemetry = dataclasses.replace(telemetry, enabled=True)
    return dataclasses.replace(
        spec,
        deploy=dataclasses.replace(spec.deploy, n_shards=args.shards,
                                   replicas=args.replicas),
        routing=routing,
        fault=fault,
        cache=cache,
        dense=dense,
        fusion=fusion,
        ingest=ingest,
        telemetry=telemetry,
        stage2=(spec.stage2 if not args.no_ltr else
                dataclasses.replace(spec.stage2, enabled=False)),
        backend=(spec.backend if args.backend is None else
                 dataclasses.replace(spec.backend, backend=args.backend)),
        online=online,
    ).validate()


def _check_ported(ap: argparse.ArgumentParser, args) -> None:
    for item, dests in UNPORTED.items():
        given = [d for d in dests if getattr(args, d) != ap.get_default(d)]
        if given:
            flags = ", ".join("--" + d.replace("_", "-") for d in given)
            raise _unported(flags, item)


def run(argv=None, say=print) -> Served:
    """Parse ``argv``, then build, fit and serve as the reference's CLI
    does; ``say`` gets each progress line.  Returns the run's
    :class:`Served` (``walls``: host seconds of the corpus, the build,
    the labels, the fit and the serve, each ending on a synchronized
    device)."""
    ap = _parser()
    args = ap.parse_args(argv)
    spec = _resolve_spec(args)
    if args.spec_json:
        with open(args.spec_json, "w") as f:
            f.write(spec.to_json() + "\n")
        say(f"[serve] wrote spec to {args.spec_json}")
        return Served(spec)
    if not args.dryrun:
        _check_ported(ap, args)
    device = resolve_device(args.device)
    out = Served(spec)

    def lap(name, t0):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        out.walls[name] = time.perf_counter() - t0

    say(f"[serve] preset={spec.name} shards={args.shards} "
        f"budget={spec.routing.budget:.0f}")
    say("[serve] building collection ...")
    t = time.perf_counter()
    out.corpus = build_corpus(CorpusParams(n_docs=args.n_docs,
                                           vocab=args.vocab, avg_doclen=150,
                                           zipf_a=1.05))
    lap("corpus", t)
    if args.dryrun:
        out.dryrun = dryrun(spec, out.corpus, n_queries=args.queries)
        return out
    t = time.perf_counter()
    out.system = system = build_system(spec, out.corpus, device=device)
    lap("build", t)
    out.ql = ql = build_queries(out.corpus, args.queries,
                                stop_k=spec.index.stop_k)

    if not args.pseudo_labels:
        say("[serve] generating oracle labels ...")
        # label the trace with the SYSTEM's cost model: fit() treats the
        # label times as measured and regresses them back into the rates
        t = time.perf_counter()
        out.labels = generate_labels(system.index, out.corpus, ql,
                                     LabelConfig(max_k=4096, batch=256),
                                     cost=system.cost)
        lap("labels", t)
    say("[serve] fitting Stage-0 predictors"
        + ("" if args.no_ltr or not spec.stage2.enabled
           else " + Stage-2 LTR model") + " ...")
    t = time.perf_counter()
    system.fit(ql, out.labels)
    lap("fit", t)
    out.fitted = system.cascade_spec

    say("[serve] serving trace through the cascade ...")
    t = time.perf_counter()
    out.result = system.serve(ql.terms, ql.mask,
                              ql.topic if system.ltr is not None else None)
    lap("serve", t)
    return out


def report(out: Served) -> list[str]:
    """The reference's ``[serve]`` summary lines of a served trace."""
    system, res = out.system, out.result
    s = res.stats
    lines = [f"[serve] routed: jass={s['jass']} bmw={s['bmw']} "
             f"hedged={s['hedged']} late={s['late_hedged']}"
             f"+{s['late_hedged_jass']}jass"]
    b = s["budget"]
    lines.append(f"[serve] guarantee: enforce={b['enforce']} "
                 f"worst-case bound={b['worst_case_bound']:.1f} "
                 f"(budget {b['total']:.0f}, stage-1 reserve "
                 f"{b['reserve']['stage1']:.1f}); "
                 f"stage-2 trimmed={b['stage2_trimmed']} "
                 f"skipped={b['stage2_skipped']}")
    if "dense" in s:
        d = s["dense"]
        lines.append(f"[serve] dense: lex={d['lexical']} "
                     f"dense={d['dense_only']} fused={d['fused']} "
                     f"theta_skips={d['theta_skips']} "
                     f"fallbacks={d['fallbacks']}")
    for name, p in s.get("stages", {}).items():
        lines.append(f"[serve] {name:7s} ms: p50={p['p50']:.2f} "
                     f"p99={p['p99']:.2f} max={p['max']:.2f}")
    lines.append(f"[serve] cascade ms: p50={s['p50']:.1f} "
                 f"p99={s['p99']:.1f} p99.99={s['p99.99']:.1f} "
                 f"max={s['max']:.1f}")
    lines.append(f"[serve] over budget ({system.budget:.0f}): "
                 f"{s['over_budget']} ({s['over_budget_pct']:.4f}%)")
    if res.final is not None:
        lines.append(f"[serve] stage-2: mean candidates="
                     f"{res.candidates_used.mean():.1f} "
                     f"final depth={res.final.shape[1]}")
    pool = system.stats()["pool"]
    lines.append(f"[serve] pool: {pool['healthy']}/{pool['replicas']} "
                 f"healthy, mirrors jass={pool['jass']} bmw={pool['bmw']} "
                 f"(fraction {pool['jass_fraction']:.2f}), "
                 f"served={pool['served']}")
    return lines


def main(argv=None) -> None:
    out = run(argv)
    if out.dryrun is not None:
        print(render(out.dryrun))
    elif out.result is not None:
        for line in report(out):
            print(line)


if __name__ == "__main__":
    main()
