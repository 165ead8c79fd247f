"""Event-driven online serving simulator: queueing + dynamic micro-batching
+ admission control around ``SearchSystem``, under one virtual clock.

This is the layer that upgrades every guarantee from *service time of a
pre-formed batch* to **response time under load**:

    response = queueing delay + dispatch + service

The loop is a discrete-event simulation in cost-model time units (ms at
``CostModel.paper_scale``), on the host.  Arrivals come from a seeded
:class:`~repro_torch.serving.spec.TrafficSpec` process; the
:class:`~repro_torch.serving.online.batcher.MicroBatcher` closes batches
under the ``batch_deadline_us`` / ``max_batch`` policy; the
:class:`~repro_torch.serving.online.admission.AdmissionController` degrades
(trimmed Stage-2 → stage1-only → partial coverage) or sheds queries whose
wait already ate the response budget; each closed batch is padded to a
power-of-two Q bucket and served through ``SearchSystem.serve`` on the
system's device -- so queueing delay threads straight through the
per-query latency accounting (``CostModel``) and the ``ReplicaPool`` EWMA
feedback, which keeps adapting online exactly as in offline serving.

Occupancy model: the batched engines process a batch in lockstep, so the
device is occupied for ``dispatch_us + max(service)`` while per-query
completions land at ``start + dispatch_us + service_i``.  Everything is
deterministic in ``(TrafficSpec.seed, DeploySpec.seed)``: same spec pair →
bit-identical event log and percentiles, on the card and on the CPU.

With a result cache attached, each arrival is first peeked at the front
door: a guaranteed L1 hit is answered there at once (``batch_of`` -2) and
never takes a batch slot; each dispatch peeks again and admission admits
proven hits on the cache rung, its hit-ratio EWMA fed from every batch.

With live ingest attached, a seeded feed-arrival process runs on the same
clock: due feed batches are applied (``add_documents``) before each
arrival and each dispatch, background merges (``merge``) reseal the index
when the delta fills, and both occupy the server (``ingest_us`` /
``merge_us``), gated by the admission ladder's feed and merge gates.  The
event log records them under the ``INGEST_EVENT`` / ``MERGE_EVENT`` ids.

With telemetry attached, the loop feeds the system's registry (queue
depth and wait, response latency, batch occupancy, served modes, sheds and
front-door hits, each shed's trace) and takes the periodic snapshots of
``TelemetrySpec.snapshot_every_us`` on the virtual clock; with it off
(``system.telemetry is None``) every hook is skipped.

The port of ``repro.serving.online.simulator``: the loop, its event-log
tuples and its sums in the reference's order, so the event log equals the
reference's tuple for tuple.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.serving.latency import over_budget, percentiles
from repro_torch.serving.online.admission import (FULL, MODE_NAMES, SHED,
                                                  AdmissionController)
from repro_torch.serving.online.batcher import MicroBatcher, pad_batch
from repro_torch.serving.online.traffic import (arrival_times,
                                                feed_arrival_times,
                                                zipf_query_mix)
from repro_torch.serving.spec import OnlineSpec, TrafficSpec
from repro_torch.serving.telemetry import QueryTrace, Span

_NOT_SERVED = -1.0  # sentinel in per-query arrays / the event log (not NaN:
                    # the determinism contract is tuple equality)
INGEST_EVENT = -3   # event-log qid marker: an applied feed batch
MERGE_EVENT = -4    # event-log qid marker: a background merge (reseal)


@dataclass
class OnlineResult:
    """One simulated trace, end to end (arrays indexed by query id)."""
    arrival: np.ndarray          # (Q,) arrival timestamps
    wait: np.ndarray             # (Q,) queueing delay (-1 = shed at arrival)
    service: np.ndarray          # (Q,) service time (-1 = shed)
    completion: np.ndarray       # (Q,) completion timestamp (-1 = shed)
    response: np.ndarray         # (Q,) completion - arrival (-1 = shed)
    mode: np.ndarray             # (Q,) FULL|TRIM|STAGE1|PARTIAL|SHED
    batch_of: np.ndarray         # (Q,) batch id (-1 = shed, -2 = answered
                                 # at the front door by an L1 cache hit)
    topk: np.ndarray             # (Q, k_serve) Stage-1 candidates (-1 = shed)
    final: np.ndarray | None     # (Q, t_final) re-ranked (None: no LTR)
    event_log: list = field(default_factory=list)
    # event_log rows: (qid, batch_id, arrival, start, wait, service,
    #                  completion, mode) — plain floats/ints, bit-comparable
    stats: dict = field(default_factory=dict)
    coverage: np.ndarray | None = None   # (Q,) fraction of partitions that
                                         # answered (-1 = shed; None: the
                                         # fault/partial path never engaged)


def simulate(system, terms: np.ndarray, mask: np.ndarray,
             topics: np.ndarray | None, traffic: TrafficSpec,
             online: OnlineSpec | None = None) -> OnlineResult:
    """Serve the whole query log through the online event loop."""
    online = online if online is not None else system.cascade_spec.online
    online.validate()
    q = len(terms)
    arr = arrival_times(traffic, q)
    if traffic.skew > 0:
        # Zipfian repetition: arrival j serves log row mix[j] (identities
        # drawn from their own seeded stream, so the timestamps above are
        # untouched).  skew=0 keeps the in-order replay bit-identical.
        mix = zipf_query_mix(traffic, q)
        terms = terms[mix]
        mask = mask[mix]
        if topics is not None:
            topics = topics[mix]
    batcher = MicroBatcher(online)
    k_serve = system.k_serve if system.ltr is not None else None
    reserve2 = system._budget_reserve["stage2"]
    stage1_bound = system.worst_case_us() - reserve2
    budget_r = online.response_budget_us or 2.0 * system.budget
    ns = system.n_shards
    # partial-coverage rung: per-shard-count Stage-1 bounds.  Only offered
    # when narrowing the fan-out actually buys back bound time (multi-shard
    # + nonzero merge overhead); otherwise the ladder is exactly as before.
    partial_bounds = None
    if ns > 1 and system.cost.gather_per_shard_us > 0:
        partial_bounds = [system.sched.cfg.worst_case_us(system.cost, m)
                          for m in range(1, ns + 1)]
    cache_on = system.cache is not None
    dense_on = system.dense is not None
    # a guaranteed L1 hit bypasses the cascade: its hard service bound is
    # just prediction + lookup — the cache rung of the admission ladder
    hit_bound = (system.cost.predict_us + system.cost.cache_hit_us
                 if cache_on else None)
    adm = (AdmissionController(online, system.cost, stage1_bound, k_serve,
                               budget_r, partial_bounds=partial_bounds,
                               cache_bound=hit_bound,
                               hit_alpha=(system.cache.spec.hit_alpha
                                          if cache_on else 0.2))
           if online.admission else None)

    mode = np.full(q, SHED, np.int64)
    wait = np.full(q, _NOT_SERVED)
    service = np.full(q, _NOT_SERVED)
    completion = np.full(q, _NOT_SERVED)
    batch_of = np.full(q, -1, np.int64)
    topk = np.full((q, system.k_serve), -1, np.int64)
    final = (np.full((q, system.t_final), -1, np.int64)
             if system.ltr is not None else None)
    faulted = system.faults.active or partial_bounds is not None
    coverage = np.full(q, _NOT_SERVED) if faulted else None
    stage_acc: dict = {}
    events: list = []
    batch_meta: list = []
    dense_acc = {"lexical": 0, "dense_only": 0, "fused": 0,
                 "theta_skips": 0, "fallbacks": 0}

    def count_dense(info: dict | None, n: int) -> None:
        # only the real rows — batch padding duplicates a row's modality
        if not dense_on or info is None:
            return
        m = np.asarray(info["modality"][:n])
        dense_acc["lexical"] += int(np.sum(m == 0))
        dense_acc["dense_only"] += int(np.sum(m == 1))
        dense_acc["fused"] += int(np.sum(m == 2))
        dense_acc["theta_skips"] += int(np.sum(info["theta_skip"][:n]))
        dense_acc["fallbacks"] += int(np.sum(info["fallback"][:n]))

    pending: list[int] = []
    t_free = 0.0
    i = 0
    n_front = 0

    # ---- telemetry (inert when the spec leaves it disabled: tel is None
    # and every hook below is skipped, so the event log, per-query arrays
    # and stats keys are bit-identical to the uninstrumented loop)
    tel = system.telemetry
    if tel is not None:
        tel.attach_online(adm, batcher)
        tel.registry.gauge("response_budget_us").set(budget_r)

    def tel_shed(qid: int, where: str, w: float, now: float) -> None:
        """Shed counters + a minimal trace naming the admission rung.
        A shed is a failure to serve -- it ranks as a violation in the
        trace reservoir (else zero-latency shed rows could never compete
        with served queries for a slot)."""
        tel.registry.counter("shed_queries", where=where).inc()
        if tel.traces.would_keep(w, True):
            root = Span("query")
            root.child("admission", 0.0, 0.0, decision="shed", where=where)
            tel.traces.offer(QueryTrace(
                qid=int(qid), clock_us=float(now), latency_us=float(w),
                budget_us=budget_r, violation=True, root=root,
                meta={"mode": "shed", "where": where,
                      "wait_us": float(w), "service_us": 0.0}))

    # ---- live ingest: a seeded feed-arrival process on the same virtual
    # clock.  Feed batches and background merges charge the server's
    # t_free (they occupy the engine host), and both are gated by the
    # admission controller's backpressure ladder: merges defer to load,
    # the feed throttles before queries shed.  With ingest disabled this
    # whole block is inert — no arrivals, no events, no clock charges.
    ingest_on = system.delta is not None
    feed_times = np.zeros(0)
    full_feed = None
    fi = 0
    if ingest_on:
        from repro_torch.index.corpus import slice_feed, synthesize_feed_docs
        if system.corpus is None:
            raise ValueError("online ingest needs the corpus the sealed "
                             "index was built from")
        ing = system.cascade_spec.ingest
        fb = ing.feed_batch
        horizon = float(arr[-1])
        n_feed = max(1, int(horizon * ing.feed_qps / 1000.0 * 2.0) + 4)
        feed_times = feed_arrival_times(ing, n_feed)
        feed_times = feed_times[feed_times <= horizon]
        if len(feed_times):
            full_feed = synthesize_feed_docs(system.corpus,
                                             int(len(feed_times)) * fb,
                                             seed=ing.seed)

    def run_ingest(now: float) -> None:
        """Apply every due feed batch (and any merge it needs) at ``now``."""
        nonlocal fi, t_free
        if not ingest_on:
            return
        while fi < len(feed_times) and feed_times[fi] <= now:
            t_feed = float(feed_times[fi])
            batch = slice_feed(full_feed, fi * fb, (fi + 1) * fb)
            # merge first when the delta is past its threshold — or cannot
            # take this batch at all (then the merge is forced through)
            need = system.delta.admit_count(batch) < batch.n_docs
            if ((need or system.delta.fill >= ing.merge_threshold)
                    and system.delta.n_docs):
                ok = (adm.merge_gate(now, t_free, len(pending), full=need)
                      if adm is not None else True)
                if ok:
                    merged = system.merge()
                    t_start = max(t_free, now)
                    t_free = t_start + ing.merge_us
                    events.append((MERGE_EVENT, MERGE_EVENT, t_feed,
                                   t_start, 0.0, float(ing.merge_us),
                                   float(t_free), int(merged)))
                elif need:
                    return      # feed blocked until a merge is allowed
            if adm is not None and not adm.feed_gate(
                    t_feed, t_free, len(pending), pause_us=ing.ingest_us):
                return          # throttled: this batch retries later
            took = system.add_documents(batch)
            t_start = max(t_free, now)
            t_free = t_start + ing.ingest_us
            events.append((INGEST_EVENT, int(fi), t_feed, t_start,
                           float(t_start - t_feed), float(ing.ingest_us),
                           float(t_free), int(took)))
            fi += 1

    def admit(qid: int) -> None:
        nonlocal n_front
        run_ingest(float(arr[qid]))
        if cache_on:
            # front-door lookup at arrival: an exact-result L1 hit is
            # answered from the broker's memory (prediction + probe) and
            # never consumes an engine-batch slot.  The peek and the serve
            # share the clock ``arr[qid]`` (same fault epoch, no fills in
            # between), so the peek's verdict is binding.
            t_arr = float(arr[qid])
            tq = topics[qid:qid + 1] if system.ltr is not None else None
            hit = system.cache_peek(terms[qid:qid + 1], mask[qid:qid + 1],
                                    tq, now=t_arr)
            if bool(hit[0]):
                if tel is not None:
                    tel.batch_context = {"qid": np.array([qid]),
                                         "wait": np.zeros(1),
                                         "mode": np.array(["full"]),
                                         "budget": budget_r}
                res = system.serve(terms[qid:qid + 1], mask[qid:qid + 1],
                                   tq, now=t_arr)
                if tel is not None:
                    tel.batch_context = None
                    tel.registry.counter("front_door_hits").inc()
                    tel.registry.histogram("response_latency_us").observe(
                        res.latency[0])
                svc = float(res.latency[0])
                mode[qid] = FULL
                wait[qid] = 0.0
                service[qid] = svc
                completion[qid] = t_arr + svc
                batch_of[qid] = -2          # -2 = served at the front door
                topk[qid] = res.topk[0]
                if final is not None and res.final is not None:
                    final[qid] = res.final[0]
                if coverage is not None:
                    coverage[qid] = 1.0
                for name, t in res.stage_latency.items():
                    stage_acc.setdefault(name, []).append(
                        np.asarray(t, np.float64))
                count_dense(res.dense, 1)
                events.append((qid, -2, t_arr, t_arr, 0.0, svc,
                               float(completion[qid]), FULL))
                n_front += 1
                if adm is not None:
                    adm.observe_hits(1, 1)
                return
        ok = (adm.at_arrival(float(arr[qid]), t_free, len(pending))
              if adm is not None else True)
        if ok:
            pending.append(qid)
        else:
            events.append((qid, -1, float(arr[qid]), _NOT_SERVED,
                           _NOT_SERVED, _NOT_SERVED, _NOT_SERVED, SHED))
            if tel is not None:
                tel_shed(qid, "arrival", 0.0, float(arr[qid]))

    def dispatch(rows: np.ndarray, t_start: float) -> None:
        nonlocal t_free
        run_ingest(t_start)
        # an ingest/merge pause that ran past the close pushes the batch
        # start back: the extra wait is real and the admission ladder
        # prices it (feed work degrades queries honestly, never silently)
        t_start = max(t_start, t_free)
        waits = t_start - arr[rows]
        hits = None
        if cache_on:
            # dispatch-time peek at the clock serve() will run at — no
            # recency moves, no RNG, so replay stays deterministic
            hits = system.cache_peek(
                terms[rows], mask[rows],
                topics[rows] if system.ltr is not None else None,
                now=float(t_start))
        if adm is not None:
            m, cap, scap = adm.at_dispatch(waits, hits)
        else:
            m = np.full(len(rows), FULL, np.int64)
            cap = None
            scap = None
        mode[rows] = m
        wait[rows] = waits
        keep = m != SHED
        for r, w in zip(rows[~keep], waits[~keep]):
            events.append((int(r), -1, float(arr[r]), float(t_start),
                           float(w), _NOT_SERVED, _NOT_SERVED, SHED))
            if tel is not None:
                tel_shed(int(r), "dispatch", float(w), float(t_start))
        if not keep.any():
            return
        served = rows[keep]
        padded, n_real = pad_batch(served, online.max_batch, online.bucket_q)
        if tel is not None:
            # queue state at batch close: this batch + whatever is still
            # waiting behind it
            depth = len(rows) + len(pending)
            tel.registry.gauge("queue_depth").set(depth)
            tel.registry.histogram("queue_depth_at_close").observe(depth)
            n_pad = len(padded) - n_real
            w_k = waits[keep]
            m_k = m[keep]
            # pad rows replicate a real query: qid=-1 keeps them out of
            # the trace reservoir (their metrics rows are sliced off by
            # [:n_real] everywhere else)
            qids = padded.copy()
            qids[n_real:] = -1
            tel.batch_context = {
                "wait": np.concatenate([w_k, np.full(n_pad, w_k[0])]),
                "mode": np.array(
                    [MODE_NAMES[int(x)] for x in
                     np.concatenate([m_k,
                                     np.full(n_pad, m_k[0], np.int64)])]),
                "qid": qids,
                "budget": budget_r,
            }
        cap_p = None
        if cap is not None and k_serve is not None:
            cap_k = cap[keep]
            cap_p = np.concatenate(
                [cap_k, np.full(len(padded) - n_real, cap_k[0], np.int64)])
        shard_p = None
        if scap is not None and bool((scap[keep] < ns).any()):
            sc_k = scap[keep]
            shard_p = np.concatenate(
                [sc_k, np.full(len(padded) - n_real, sc_k[0], np.int64)])
        if cache_on:
            c_pre = (system.cache.counters["l1_hits"],
                     system.cache.counters["lookups"])
        res = system.serve(terms[padded], mask[padded],
                           topics[padded] if system.ltr is not None
                           else None, stage2_cap=cap_p, shard_cap=shard_p,
                           now=float(t_start))
        if cache_on and adm is not None:
            # feed the batch's realized hit ratio into the admission EWMA
            adm.observe_hits(
                system.cache.counters["l1_hits"] - c_pre[0],
                system.cache.counters["lookups"] - c_pre[1])
        bid = len(batch_meta)
        svc = np.asarray(res.latency[:n_real], np.float64)
        occupancy = online.dispatch_us + float(np.max(res.latency))
        service[served] = svc
        completion[served] = t_start + online.dispatch_us + svc
        batch_of[served] = bid
        topk[served] = res.topk[:n_real]
        if coverage is not None:
            coverage[served] = (res.coverage[:n_real]
                                if res.coverage is not None else 1.0)
        if final is not None and res.final is not None:
            final[served] = res.final[:n_real]
        for name, t in res.stage_latency.items():
            stage_acc.setdefault(name, []).append(
                np.asarray(t[:n_real], np.float64))
        count_dense(res.dense, n_real)
        for j, r in enumerate(served):
            events.append((int(r), bid, float(arr[r]), float(t_start),
                           float(t_start - arr[r]), float(svc[j]),
                           float(completion[r]), int(m[keep][j])))
        batch_meta.append({"size": int(n_real), "width": int(len(padded)),
                           "start": float(t_start),
                           "occupancy": float(occupancy)})
        t_free = t_start + occupancy
        if adm is not None:
            adm.observe_batch(occupancy)
        if tel is not None:
            tel.batch_context = None
            reg = tel.registry
            reg.histogram("queue_wait_us").observe(waits[keep])
            reg.histogram("response_latency_us").observe(
                waits[keep] + online.dispatch_us + svc)
            reg.histogram("batch_occupancy_us").observe(occupancy)
            for x in m[keep]:
                reg.counter("served_mode", mode=MODE_NAMES[int(x)]).inc()
            tel.maybe_snapshot(system, t_free)

    while i < q or pending:
        if not pending:
            admit(i)
            i += 1
            continue
        # pull in every arrival that lands before the batch would close —
        # the queue is NOT capped at max_batch, so a long occupancy builds
        # real backlog (that depth is what arrival-time admission and
        # queue_cap act on); each admission can re-shape the close (a
        # filling batch closes earlier, a shed leaves it open)
        while True:
            take, t_close = batcher.close(arr[pending], t_free)
            if i < q and arr[i] <= t_close:
                admit(i)
                i += 1
                continue
            break
        rows = np.asarray(pending[:take], np.int64)
        del pending[:take]
        dispatch(rows, t_close)

    served_rows = np.flatnonzero(mode != SHED)
    resp = np.full(q, _NOT_SERVED)
    resp[served_rows] = (completion[served_rows] - arr[served_rows])
    n_over, pct = over_budget(resp[served_rows], budget_r)
    stats = {
        "n_queries": q,
        "served": int(len(served_rows)),
        "shed": int(q - len(served_rows)),
        "shed_pct": 100.0 * (q - len(served_rows)) / q,
        "response_budget": float(budget_r),
        "over_budget": n_over,
        "over_budget_pct": pct,
        "modes": {MODE_NAMES[k]: int(np.sum(mode == k)) for k in MODE_NAMES},
        "batches": len(batch_meta),
        "traffic": traffic.to_dict(),
        "admission": dict(adm.stats) if adm is not None else None,
        "worst_case_bound": float(system.worst_case_us()),
    }
    if cache_on:
        stats["cache"] = system.cache.stats()
        stats["cache"]["front_door_hits"] = n_front
        if adm is not None:
            stats["cache"]["hit_ewma"] = float(adm.hit_ewma)
    if dense_on:
        stats["dense"] = dense_acc
    if ingest_on:
        stats["ingest"] = system.stats()["ingest"]
        stats["ingest"]["feed_batches_due"] = int(len(feed_times))
        stats["ingest"]["feed_batches_applied"] = int(fi)
        if adm is not None:
            for key in ("feed_applied", "feed_throttled", "merges_applied",
                        "merges_forced", "merge_deferred"):
                stats["ingest"][key] = int(adm.stats[key])
    if faulted:
        if system.faults.active:
            stats["faults"] = dict(system._fault_counters)
        cov = coverage[served_rows]
        stats["coverage"] = {
            "min": float(cov.min()) if len(cov) else 1.0,
            "mean": float(cov.mean()) if len(cov) else 1.0,
            "degraded": int(np.sum((cov >= 0) & (cov < 1.0))),
        }
    makespan = float(arr[-1] - arr[0]) if q > 1 else 0.0
    if makespan > 0:
        stats["offered_qps"] = 1000.0 * q / makespan
    if len(served_rows):
        stats["response"] = percentiles(resp[served_rows])
        stages = {"queue": percentiles(wait[served_rows])}
        for name, chunks in stage_acc.items():
            t = np.concatenate(chunks)
            if np.any(t > 0):
                stages[name] = percentiles(t)
        stats["stages"] = stages
        span = float(completion[served_rows].max())
        if span > 0:
            stats["achieved_qps"] = 1000.0 * len(served_rows) / span
    if batch_meta:
        sizes = np.asarray([b["size"] for b in batch_meta], np.float64)
        occ = np.asarray([b["occupancy"] for b in batch_meta], np.float64)
        stats["batch"] = {"count": len(batch_meta),
                          "mean_size": float(sizes.mean()),
                          "max_size": int(sizes.max()),
                          "mean_occupancy": float(occ.mean())}
    if tel is not None:
        stats["telemetry"] = {"snapshots": len(tel.snapshots),
                              "traces_kept": len(tel.traces),
                              "traces_offered": tel.traces.offered}
    return OnlineResult(arrival=arr, wait=wait, service=service,
                        completion=completion, response=resp, mode=mode,
                        batch_of=batch_of, topk=topk, final=final,
                        event_log=events, stats=stats, coverage=coverage)


def fresh_probe(system):
    """A throwaway clone of a fitted system — same index, models, LTR
    model, **calibrated** spec, (possibly label-regressed) cost model,
    device and two-tower model — for measurements like
    :func:`estimate_capacity` that must not perturb the production
    system's pool EWMAs or adaptive thresholds.  Cloning the live
    ``cascade_spec``/``cost`` (not the pre-fit template) is what makes the
    probe route and cost identically to the system it stands in for.

    The reference builds the probe with ``build_system``; the port's probe
    is that system without the build (``SearchSystem._fresh_copy``): fresh
    serving state over the shards, dense engine and Stage-2 arrays it
    shares with ``system``, which serving only reads, so a probe of a
    196,608-doc shard costs no host layout pass and no copy to the card.
    Like the reference's fresh build, the probe gets an empty cache, a
    fault injector of its own, whose transient draws start anew, an empty
    delta of its own (neither its feed nor its parent's merge reaches the
    other) and, with telemetry on, a registry and trace store of its own,
    so its batches never land in its parent's snapshot."""
    return system._fresh_copy()


def estimate_capacity(system, terms: np.ndarray, mask: np.ndarray,
                      topics: np.ndarray | None,
                      online: OnlineSpec | None = None,
                      n_batches: int = 4) -> float:
    """Saturated-throughput estimate (queries per 1000 time units): serve
    ``n_batches`` full ``max_batch``-wide batches back to back and return
    ``max_batch / mean(occupancy)``.

    This *serves real batches* (it perturbs the replica pool's EWMAs and
    the routing adaptation) — probe a throwaway clone (:func:`fresh_probe`)
    when the measurement must not touch production state."""
    online = online if online is not None else system.cascade_spec.online
    b = online.max_batch
    occ = []
    for k in range(n_batches):
        rows = (np.arange(b) + k * b) % len(terms)
        res = system.serve(terms[rows], mask[rows],
                           topics[rows] if system.ltr is not None else None)
        occ.append(online.dispatch_us + float(res.latency.max()))
    return 1000.0 * b / float(np.mean(occ))
