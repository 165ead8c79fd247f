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
resolved spec, both before anything is built.  ``--online`` serves the
trace under load instead (``SearchSystem.serve_online``: seeded arrivals,
micro-batching, admission control), at ``--qps`` or at ``--load`` times
the capacity ``estimate_capacity`` measures on a ``fresh_probe`` of the
fitted system, and prints the reference's online lines.  ``--cache``
(``--cache-entries``, ``--cache-bytes``) puts the two-level result cache
in front of the cascade, and ``--fault-scenario`` / ``--fault-json`` serve
under a fault schedule; ``--ingest`` (``--feed-qps``, ``--delta-docs``,
``--delta-postings``) serves while a seeded document feed lands in the
live delta and background merges reseal the index (online mode); each
prints the reference's cache, fault or ingest line.  ``--metrics-json``,
``--metrics-prom`` and ``--trace-slowest N`` turn telemetry on and, after
the summary lines, write the snapshot (deterministic JSON, or Prometheus
text) and print the N slowest traces with their why-slow attribution, as
the reference does.

``run(argv)`` does the work and returns a :class:`Served`; ``main`` prints
its result and writes the telemetry exports.  Tests and ``chip_smoke.py``
call ``run`` in-process.
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
from repro_torch.serving.faults import fault_scenario
from repro_torch.serving.online import (OnlineResult, estimate_capacity,
                                        fresh_probe)
from repro_torch.serving.spec import CascadeSpec, FaultSpec, TrafficSpec
from repro_torch.serving.system import (PipelineResult, SearchSystem,
                                        build_system)
from repro_torch.serving.telemetry import why_slow


def _emit_telemetry(system, args):
    """Write/print the requested telemetry exports after a serve."""
    if system.telemetry is None:
        return
    if args.metrics_json:
        with open(args.metrics_json, "w") as f:
            f.write(system.render_snapshot("json"))
        print(f"[serve] wrote metrics snapshot to {args.metrics_json}")
    if args.metrics_prom:
        with open(args.metrics_prom, "w") as f:
            f.write(system.render_snapshot("prom"))
        print(f"[serve] wrote prometheus metrics to {args.metrics_prom}")
    if args.trace_slowest:
        traces = system.telemetry.traces.slowest(args.trace_slowest)
        print(f"[serve] {len(traces)} slowest traces "
              f"(of {system.telemetry.traces.offered} offered):")
        for tr in traces:
            w = why_slow(tr)
            mark = " VIOLATION" if tr.violation else ""
            print(f"[serve]   qid={tr.qid} latency={tr.latency_us:.1f} "
                  f"mode={tr.meta.get('mode', '?')}{mark}: {w['detail']}")


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
    result: PipelineResult | None = None  # the offline serve
    online: OnlineResult | None = None    # the --online serve
    dryrun: dict | None = None
    walls: dict = dataclasses.field(default_factory=dict)   # seconds
    args: argparse.Namespace | None = None    # the parsed flags


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
                    help="serve the trace under load through the online "
                         "subsystem (event-driven arrivals, micro-batching,"
                         " admission control) and report response-time "
                         "percentiles, queueing included")
    ap.add_argument("--arrival", default="poisson",
                    help="online arrival process: poisson | bursty | "
                         "diurnal | trace")
    ap.add_argument("--qps", type=float, default=None,
                    help="offered load (queries per 1000 cost units, i.e. "
                         "QPS at paper scale); default: --load x measured "
                         "capacity")
    ap.add_argument("--load", type=float, default=0.8,
                    help="offered load as a fraction of measured capacity "
                         "(used when --qps is not given)")
    ap.add_argument("--max-batch", type=int, default=None,
                    help="override the preset's micro-batch width cap "
                         "(a spec field)")
    ap.add_argument("--no-admission", action="store_true",
                    help="disable admission control (baseline mode)")
    ap.add_argument("--cache", action="store_true",
                    help="put the two-level result cache in front of the "
                         "cascade (L1 exact results + L2 Stage-1 "
                         "candidates; repro_torch.serving.cache)")
    ap.add_argument("--cache-entries", type=int, default=None,
                    help="entry cap for each cache level (implies --cache)")
    ap.add_argument("--cache-bytes", type=int, default=None,
                    help="byte cap for each cache level (implies --cache)")
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
                    help="serve while the collection mutates: a seeded "
                         "document feed lands in a capacity-bounded delta "
                         "tile-set, background merges reseal the index "
                         "(repro_torch.index.delta); online mode only")
    ap.add_argument("--feed-qps", type=float, default=None,
                    help="feed-batch arrivals per 1000 cost units "
                         "(implies --ingest)")
    ap.add_argument("--delta-docs", type=int, default=None,
                    help="delta tile-set doc capacity; must be >= k_serve "
                         "(implies --ingest)")
    ap.add_argument("--delta-postings", type=int, default=None,
                    help="delta tile-set postings capacity — sizes the "
                         "worst-case delta-scan term charged into every "
                         "query's bound (implies --ingest)")
    ap.add_argument("--zipf-skew", type=float, default=0.0,
                    help="Zipfian query-repetition skew for --online "
                         "traffic (0 = every query distinct, in order)")
    ap.add_argument("--trace-path", default="",
                    help="recorded arrival timestamps (.npy or JSON list) "
                         "for --arrival trace")
    ap.add_argument("--traffic-seed", type=int, default=0)
    ap.add_argument("--fault-scenario", default=None,
                    help="inject a named deterministic fault schedule: "
                         "none | crash_one | rolling_restart | stragglers |"
                         " timeout_storm | partition_outage "
                         "(repro_torch.serving.faults)")
    ap.add_argument("--fault-json", default=None,
                    help="inject a FaultSpec from a JSON file (overrides "
                         "--fault-scenario)")
    ap.add_argument("--failover-timeout", type=float, default=None,
                    help="scatter-gather shard timeout (cost units); "
                         "required (directly or via the preset) when the "
                         "fault schedule can kill requests")
    ap.add_argument("--max-retries", type=int, default=None,
                    help="bounded failover re-issues per (query, shard); "
                         "charged into the worst-case bound")
    ap.add_argument("--fault-horizon", type=float, default=10_000.0,
                    help="trace horizon (cost units) named scenarios are "
                         "sized against")
    ap.add_argument("--metrics-json", default=None,
                    help="write the telemetry snapshot (deterministic "
                         "JSON) to this path after serving (enables "
                         "telemetry)")
    ap.add_argument("--metrics-prom", default=None,
                    help="write the snapshot in Prometheus text format to "
                         "this path after serving (enables telemetry)")
    ap.add_argument("--trace-slowest", type=int, default=0,
                    help="print the N slowest/violating query traces with "
                         "a why-slow attribution (enables telemetry)")
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
        fault = fault_scenario(args.fault_scenario, n_partitions=args.shards,
                               replicas=args.replicas,
                               horizon=args.fault_horizon,
                               seed=args.traffic_seed)
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


def run(argv=None, say=print) -> Served:
    """Parse ``argv``, then build, fit and serve as the reference's CLI
    does; ``say`` gets each progress line.  Returns the run's
    :class:`Served` (``walls``: host seconds of the corpus, the build,
    the labels, the fit, the capacity probe (``--online``) and the serve,
    each ending on a synchronized device)."""
    args = _parser().parse_args(argv)
    spec = _resolve_spec(args)
    if args.spec_json:
        with open(args.spec_json, "w") as f:
            f.write(spec.to_json() + "\n")
        say(f"[serve] wrote spec to {args.spec_json}")
        return Served(spec, args=args)
    device = resolve_device(args.device)
    out = Served(spec, args=args)

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

    if args.online:
        topics = ql.topic if system.ltr is not None else None
        qps = args.qps
        if qps is None and args.arrival != "trace":
            say(f"[serve] measuring capacity (max_batch="
                f"{spec.online.max_batch}) ...")
            # a throwaway clone of the FITTED operating point, so the probe
            # batches leave the measured system's pool and thresholds alone
            t = time.perf_counter()
            qps = args.load * estimate_capacity(fresh_probe(system),
                                                ql.terms, ql.mask, topics)
            lap("capacity", t)
        qps = qps if qps is not None else 1.0  # unused by trace replay
        traffic = TrafficSpec(arrival=args.arrival, qps=qps,
                              seed=args.traffic_seed, skew=args.zipf_skew,
                              trace_path=args.trace_path)
        src = (f"trace {args.trace_path}" if args.arrival == "trace"
               else f"qps={qps:.1f}")
        say(f"[serve] online: {args.arrival} arrivals @ {src}, "
            f"max_batch={spec.online.max_batch} "
            f"deadline={spec.online.batch_deadline_us:.1f} "
            f"admission={spec.online.admission}")
        t = time.perf_counter()
        out.online = system.serve_online(ql.terms, ql.mask, topics,
                                         traffic=traffic)
        lap("serve", t)
        return out

    say("[serve] serving trace through the cascade ...")
    t = time.perf_counter()
    out.result = system.serve(ql.terms, ql.mask,
                              ql.topic if system.ltr is not None else None)
    lap("serve", t)
    return out


def report_online(s: dict) -> list[str]:
    """The reference's ``[serve]`` summary lines of an online run's
    stats."""
    line = (f"[serve] served {s['served']}/{s['n_queries']} "
            f"(shed {s['shed']}, {s['shed_pct']:.2f}%) in "
            f"{s['batches']} batches")
    if s.get("batch"):
        line += f" (mean size {s['batch']['mean_size']:.1f})"
    lines = [line, f"[serve] modes: {s['modes']}"]
    if "response" in s:
        p = s["response"]
        lines.append(f"[serve] response ms (queueing included): "
                     f"p50={p['p50']:.1f} p99={p['p99']:.1f} "
                     f"p99.99={p['p99.99']:.1f} max={p['max']:.1f}")
        for name, sp in s["stages"].items():
            lines.append(f"[serve] {name:7s} ms: p50={sp['p50']:.2f} "
                         f"p99={sp['p99']:.2f} max={sp['max']:.2f}")
    if "cache" in s:
        c = s["cache"]
        lines.append(f"[serve] cache: hit_ratio={c['hit_ratio']:.3f} "
                     f"(l1={c['l1_hits']} l2={c['l2_hits']} "
                     f"miss={c['full_misses']}), front-door "
                     f"hits={c['front_door_hits']}"
                     + (f", ewma={c['hit_ewma']:.3f}" if "hit_ewma" in c
                        else ""))
    if "dense" in s:
        d = s["dense"]
        lines.append(f"[serve] dense: lex={d['lexical']} "
                     f"dense={d['dense_only']} fused={d['fused']} "
                     f"theta_skips={d['theta_skips']} "
                     f"fallbacks={d['fallbacks']}")
    if "ingest" in s:
        i = s["ingest"]
        lines.append(f"[serve] ingest: docs={i['docs_ingested']} in "
                     f"{i['feed_batches']} batches "
                     f"(due {i.get('feed_batches_due', '?')}, throttled "
                     f"{i.get('feed_throttled', 0)}), merges={i['merges']} "
                     f"(deferred {i.get('merge_deferred', 0)}, forced "
                     f"{i.get('merges_forced', 0)}), delta "
                     f"{i['delta_docs']}/{i['capacity_docs']} docs "
                     f"fill={i['fill']:.2f}, "
                     f"delta_us={i['delta_us']:.1f}")
    if "coverage" in s:
        c = s["coverage"]
        lines.append(f"[serve] coverage: min={c['min']:.2f} "
                     f"mean={c['mean']:.3f} degraded={c['degraded']}")
    if "faults" in s:
        f = s["faults"]
        lines.append(f"[serve] faults: retries={f['retries']} "
                     f"lost={f['lost_partitions']} no_route={f['no_route']} "
                     f"transient={f['transient']} probes={f['probes']} "
                     f"recovered={f['recovered']}")
    lines.append(f"[serve] over response budget "
                 f"({s['response_budget']:.0f}): {s['over_budget']} "
                 f"({s['over_budget_pct']:.4f}%)")
    return lines


def report(out: Served) -> list[str]:
    """The reference's ``[serve]`` summary lines of a served trace."""
    if out.online is not None:
        return report_online(out.online.stats)
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
    if "cache" in s:
        c = s["cache"]
        lines.append(f"[serve] cache: hit_ratio={c['hit_ratio']:.3f} "
                     f"(l1={c['l1_hits']} l2={c['l2_hits']} "
                     f"miss={c['full_misses']})")
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
    if "coverage" in s:
        c = s["coverage"]
        f = s["faults"]
        lines.append(f"[serve] faults: coverage min={c['min']:.2f} "
                     f"mean={c['mean']:.3f} degraded={c['degraded']}; "
                     f"retries={f['retries']} lost={f['lost_partitions']} "
                     f"probes={f['probes']} recovered={f['recovered']}")
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
    elif out.system is not None:
        for line in report(out):
            print(line)
        _emit_telemetry(out.system, out.args)


if __name__ == "__main__":
    main()
