"""The port's telemetry against the reference, on the CPU.

``repro_torch.serving.telemetry`` (registry, histograms, trace store,
``why_slow``, the exports) and every telemetry hook of the port's serve
path are held to ``repro.serving.telemetry`` and the reference's
``SearchSystem`` at tolerance 0.0:

* every case of ``tests/test_telemetry.py`` but the two bench ones (the
  payload schema, and the ``obs_diff`` rules, which
  ``tests/test_torch_obs.py`` runs on ``chip_smoke``'s copy), on both
  packages with the same inputs (``small_collection``, the same ``_spec``):
  each unit case's values equal the reference's, and each served case's
  snapshot equals the reference's as a dict, ``render_json`` and
  ``render_prometheus`` byte for byte;
* disabled telemetry inert: results, latencies and event logs equal the
  reference's and the port's own telemetry-on run;
* telemetry on the cached (offline and online, front-door hits), faulted,
  degraded (Stage-2 trim/skip, partial coverage), ``hybrid_fusion`` and
  ``live_ingest`` paths;
* the six ``export_metrics`` (micro-batcher, admission, cache, fault
  injector, replica pool, delta store) on their own.

The reference serves on its ``"jnp"`` backend, the port on the CPU (each
kernel wrapper's plain version).  Each reference flow runs once per module.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from repro.configs.cascade_presets import get_preset as ref_get_preset
from repro.configs.two_tower_retrieval import REDUCED as REF_REDUCED
from repro.index.corpus import synthesize_feed_docs as ref_feed_docs
from repro.models import recsys as ref_recsys
from repro.serving import cache as ref_cache
from repro.serving import faults as ref_faults
from repro.serving import replicas as ref_replicas
from repro.serving import spec as ref_spec
from repro.serving import telemetry as ref_tel
from repro.serving.latency import CostModel as RefCostModel
from repro.serving.online import AdmissionController as RefAdmission
from repro.serving.online import MicroBatcher as RefBatcher
from repro.serving.system import build_system as ref_build_system
from repro.serving.telemetry import export as ref_export
from repro_torch import convert
from repro_torch.index.builder import build_index
from repro_torch.index.corpus import (CorpusParams, build_corpus,
                                      synthesize_feed_docs)
from repro_torch.serving import cache, faults, replicas
from repro_torch.serving import spec as port_spec
from repro_torch.serving import telemetry as tel
from repro_torch.serving.latency import CostModel
from repro_torch.serving.online import AdmissionController, MicroBatcher
from repro_torch.serving.system import build_system
from repro_torch.serving.telemetry import export

INF = float("inf")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# histogram, registry, trace store, why_slow, legacy view: unit cases
# ---------------------------------------------------------------------------

def _adversarial_streams():
    rng = np.random.RandomState(7)
    return {
        "constant": np.full(200, 42.5),
        "two_point": np.array([1.0] * 150 + [5000.0] * 50),
        "arange": np.arange(1, 201, dtype=np.float64),
        "heavy_tail": np.exp(rng.normal(3.0, 2.0, size=200)),
        "near_edges": np.array([1e-3, 1e-3 * 1.0001, 9.99e6, 1e7] * 50),
    }


QS = (0.0, 0.1, 0.5, 0.9, 0.95, 0.99, 0.9999, 1.0)


@pytest.mark.parametrize("name,vals",
                         sorted(_adversarial_streams().items()))
def test_histogram_exact_small_n_matches_numpy(name, vals):
    """While N <= exact_n the port's histogram answers quantiles exactly:
    numpy's inverted-CDF estimator, and the reference's answers."""
    h, r = tel.LogHistogram(exact_n=256), ref_tel.LogHistogram(exact_n=256)
    h.observe(vals)
    r.observe(vals)
    assert h.exact
    for q in QS:
        assert h.quantile(q) == float(
            np.quantile(vals, q, method="inverted_cdf")), (name, q)
        assert h.quantile(q) == r.quantile(q)
    assert h.snapshot() == r.snapshot()


@pytest.mark.parametrize("name,vals",
                         sorted(_adversarial_streams().items()))
def test_histogram_bucketed_within_documented_bound(name, vals):
    """Past exact_n the relative error is bounded by sqrt(gamma) - 1 inside
    [lo, hi], and every bucketed quantile (bucket index, geometric
    midpoint, clamp) is the reference's float for float."""
    big = np.tile(vals, 50)
    h, r = tel.LogHistogram(exact_n=64), ref_tel.LogHistogram(exact_n=64)
    h.observe(big)
    r.observe(big)
    assert not h.exact
    for q in (0.5, 0.95, 0.99, 0.9999):
        truth = float(np.quantile(big, q, method="inverted_cdf"))
        est = h.quantile(q)
        if h.lo <= truth <= h.hi:
            assert abs(est - truth) <= h.rel_err_bound * truth + 1e-12, (
                name, q, truth, est)
    for q in QS:
        assert h.quantile(q) == r.quantile(q), (name, q)
    assert h._buckets == r._buckets
    assert h.snapshot() == r.snapshot()


@pytest.mark.parametrize("bins,exact_n,lo,hi", [
    (64, 0, 1e-3, 1e7), (7, 3, 0.5, 300.0), (128, 16, 1e-6, 1e9)])
def test_histogram_buckets_match_reference_on_seeded_streams(bins, exact_n,
                                                             lo, hi):
    """Seeded log-uniform streams through other bucket geometries, fed in
    chunks across the exact-buffer flush: the same buckets, quantiles and
    snapshot as the reference."""
    rng = np.random.RandomState(bins)
    vals = np.exp(rng.uniform(np.log(lo / 10), np.log(hi * 10), 3000))
    vals[::97] = 0.0
    kw = dict(bins_per_decade=bins, exact_n=exact_n, lo=lo, hi=hi)
    h, r = tel.LogHistogram(**kw), ref_tel.LogHistogram(**kw)
    for chunk in np.array_split(vals, 7):
        h.observe(chunk)
        r.observe(chunk)
        assert h.snapshot() == r.snapshot()
    assert (h._under, h._over, h._buckets) == (r._under, r._over,
                                               r._buckets)
    assert h.rel_err_bound == r.rel_err_bound


def test_histogram_out_of_range_and_errors():
    h = tel.LogHistogram(exact_n=0, lo=1.0, hi=100.0)
    h.observe(np.zeros(10))
    assert h.quantile(0.5) == 0.0
    h2 = tel.LogHistogram(exact_n=0, lo=1.0, hi=100.0)
    h2.observe([1e9] * 5)
    assert h2.quantile(0.99) == 1e9
    with pytest.raises(ValueError, match=">= 0"):
        h2.observe([-1.0])
    assert np.isnan(tel.LogHistogram().quantile(0.5))
    with pytest.raises(ValueError):
        tel.LogHistogram().quantile(1.5)
    h3, r3 = tel.LogHistogram(exact_n=8), ref_tel.LogHistogram(exact_n=8)
    for a in (np.arange(1.0, 7.0), np.arange(7.0, 20.0)):
        h3.observe(a)
        r3.observe(a)
    assert not h3.exact and h3.count == 19
    assert h3.snapshot()["rel_err_bound"] == pytest.approx(
        10 ** (1 / 128) - 1, rel=1e-6)
    assert h3.snapshot() == r3.snapshot()
    for kw in ({"bins_per_decade": 0}, {"exact_n": -1}, {"lo": 0.0},
               {"lo": 5.0, "hi": 1.0}):
        with pytest.raises(ValueError):
            tel.LogHistogram(**kw)


def _fill_registry(mod):
    reg = mod.MetricsRegistry()
    reg.counter("served", mode="full").inc(3)
    reg.counter("served", mode="full").inc()
    reg.counter("served", mode="trim", where="x").inc(2)
    reg.counter("mirrored").set_total(10)
    reg.gauge("depth").set(7)
    reg.gauge("pool", key="jass_fraction").set(0.25)
    reg.histogram("lat", stage="stage1").observe([3.0, 1.5, 8.25])
    reg.histogram("empty")
    return reg


def test_registry_and_counter_semantics():
    reg = tel.MetricsRegistry()
    reg.counter("served", mode="full").inc(3)
    reg.counter("served", mode="full").inc()
    assert reg.counters['served{mode="full"}'].value == 4
    with pytest.raises(ValueError, match=">= 0"):
        reg.counter("served").inc(-1)
    c = reg.counter("mirrored")
    c.set_total(10)
    with pytest.raises(ValueError, match="backwards"):
        c.set_total(9)
    reg.gauge("depth").set(7)
    snap = reg.snapshot()
    assert snap["gauges"]["depth"] == 7.0
    assert list(snap["counters"]) == sorted(snap["counters"])
    # the same calls give the reference's snapshot and export bytes
    got, want = _fill_registry(tel).snapshot(), _fill_registry(
        ref_tel).snapshot()
    assert got == want
    assert export.render_json(got) == ref_export.render_json(want)
    assert export.render_prometheus(got) == ref_export.render_prometheus(
        want)


def _trace(mod, lat, viol, qid=0):
    return mod.QueryTrace(qid=qid, clock_us=0.0, latency_us=lat,
                          budget_us=100.0, violation=viol,
                          root=mod.Span("query"), meta={})


def test_trace_store_keeps_slowest_and_violations():
    st, rt = tel.TraceStore(capacity=3), ref_tel.TraceStore(capacity=3)
    for lat in (10.0, 20.0, 30.0, 40.0, 5.0):
        assert st.offer(_trace(tel, lat, False)) \
            == rt.offer(_trace(ref_tel, lat, False))
    assert [t.latency_us for t in st.slowest()] == [40.0, 30.0, 20.0]
    st.offer(_trace(tel, 1.0, True))
    rt.offer(_trace(ref_tel, 1.0, True))
    assert st.slowest()[0].violation and len(st) == 3
    assert st.offered == 6 and not st.would_keep(0.5, False)
    # a seeded stream with ties: the same decisions and retained order
    rng = np.random.RandomState(5)
    st, rt = tel.TraceStore(capacity=7), ref_tel.TraceStore(capacity=7)
    for i in range(200):
        lat, viol = float(rng.randint(0, 30)), bool(rng.rand() < 0.1)
        assert st.would_keep(lat, viol) == rt.would_keep(lat, viol)
        assert st.offer(_trace(tel, lat, viol, i)) \
            == rt.offer(_trace(ref_tel, lat, viol, i))
    assert [t.to_dict() for t in st.slowest()] \
        == [t.to_dict() for t in rt.slowest()]
    assert (st.kept, st.offered) == (rt.kept, rt.offered)
    assert tel.TraceStore(0).offer(_trace(tel, 1.0, True)) is False
    with pytest.raises(ValueError):
        tel.TraceStore(-1)


def _why_slow_trees(mod):
    root = mod.Span("query")
    root.child("stage0", 0.0, 5.0)
    s1 = root.child("stage1", 5.0, 80.0)
    s1.child("shard", 5.0, 70.0, shard=0, retry_wait_us=15.0)
    root.child("stage2", 85.0, 10.0, candidates=32)
    return [mod.QueryTrace(qid=3, clock_us=0.0, latency_us=120.0,
                           budget_us=100.0, violation=True, root=root,
                           meta={"wait_us": 25.0, "reserve_us": 12.5}),
            mod.QueryTrace(qid=4, clock_us=0.0, latency_us=120.0,
                           budget_us=200.0, violation=False, root=root,
                           meta={"wait_us": 90.0}),
            mod.QueryTrace(qid=5, clock_us=0.0, latency_us=0.0,
                           budget_us=200.0, violation=False,
                           root=mod.Span("query"), meta={})]


def test_why_slow_attribution():
    got, want = _why_slow_trees(tel), _why_slow_trees(ref_tel)
    w = tel.why_slow(got[0])
    assert w["stage"] == "stage1" and w["duration_us"] == 80.0
    assert "VIOLATED" in w["detail"]
    assert tel.why_slow(got[1])["stage"] == "queue"
    assert tel.why_slow(got[2])["stage"] == "none"
    for a, b in zip(got, want):
        assert tel.why_slow(a) == ref_tel.why_slow(b)
        assert a.to_dict() == b.to_dict()


def test_legacy_stats_view_unit():
    for mod, ex in ((tel, export), (ref_tel, ref_export)):
        reg = mod.MetricsRegistry()
        reg.counter("scheduler", key="served").set_total(12)
        reg.gauge("scheduler", key="fill").set(0.5)
        reg.counter("other", key="x").set_total(1)
        view = ex.legacy_stats_view(reg.snapshot(), "scheduler")
        assert view == {"served": 12, "fill": 0.5}
        assert isinstance(view["served"], int)


def test_telemetry_spec_round_trip_and_validation():
    spec = port_spec.CascadeSpec(telemetry=port_spec.TelemetrySpec(
        enabled=True, bins_per_decade=32, exact_n=128,
        trace_reservoir=16, snapshot_every_us=500.0, max_snapshots=8))
    again = port_spec.CascadeSpec.from_json(spec.to_json())
    assert again.telemetry == spec.telemetry and again.telemetry.active
    d = json.loads(spec.to_json())
    d.pop("telemetry")
    assert port_spec.CascadeSpec.from_dict(d).telemetry \
        == port_spec.TelemetrySpec()
    assert not port_spec.TelemetrySpec().active
    with pytest.raises(ValueError, match="bins_per_decade"):
        port_spec.TelemetrySpec(bins_per_decade=0).validate()
    with pytest.raises(ValueError, match="trace_reservoir"):
        port_spec.TelemetrySpec(trace_reservoir=-1).validate()
    with pytest.raises(ValueError, match="snapshot_every_us"):
        port_spec.TelemetrySpec(snapshot_every_us=-2.0).validate()
    assert ref_spec.CascadeSpec.from_json(spec.to_json()).to_json() \
        == spec.to_json()


# ---------------------------------------------------------------------------
# the six export_metrics on their own
# ---------------------------------------------------------------------------

def _same_registry(fill):
    """``fill(package)`` exports into a fresh registry of each package; the
    snapshots and both renders are equal."""
    got, want = tel.MetricsRegistry(), ref_tel.MetricsRegistry()
    fill("port", got)
    fill("ref", want)
    a, b = got.snapshot(), want.snapshot()
    assert a == b
    assert export.render_json(a) == ref_export.render_json(b)
    assert export.render_prometheus(a) == ref_export.render_prometheus(b)
    return a


def test_export_metrics_batcher_and_admission():
    online = dict(max_batch=8, batch_deadline_us=2.5, dispatch_us=1.0,
                  bucket_q=False, queue_cap=4)
    objs = {
        "port": (MicroBatcher(port_spec.OnlineSpec(**online)),
                 AdmissionController(port_spec.OnlineSpec(**online),
                                     CostModel.paper_scale(), 100.0, 64,
                                     200.0, cache_bound=21.0)),
        "ref": (RefBatcher(ref_spec.OnlineSpec(**online)),
                RefAdmission(ref_spec.OnlineSpec(**online),
                             RefCostModel.paper_scale(), 100.0, 64, 200.0,
                             cache_bound=21.0))}
    rng = np.random.RandomState(2)
    for _ in range(40):
        waits = rng.rand(int(rng.randint(1, 9))) * 150.0
        hits = rng.rand(len(waits)) < 0.3
        occ, arrival = float(rng.rand() * 90.0), float(rng.rand() * 500)
        depth = int(rng.randint(0, 9))
        for _, adm in objs.values():
            adm.at_arrival(arrival, arrival + occ, depth)
            adm.at_dispatch(waits, hits)
            adm.observe_batch(occ)
            adm.observe_hits(int(hits.sum()), len(hits))

    def fill(pkg, reg):
        for o in objs[pkg]:
            o.export_metrics(reg)

    snap = _same_registry(fill)
    assert snap["gauges"]['batcher{key="max_batch"}'] == 8.0
    assert snap["counters"]['admission{key="admitted"}'] > 0


def _lru_traffic(mod, spec_mod):
    c = mod.ServingCache(spec_mod.CacheSpec(enabled=True, l1_entries=5,
                                            l2_bytes=600))
    rng = np.random.RandomState(4)
    for _ in range(120):
        k = b"q%d" % rng.randint(0, 12)
        c.counters["lookups"] += 1
        if c.l1_get(k, 0) is not None:
            c.counters["l1_hits"] += 1
        else:
            c.counters["full_misses"] += 1
            c.l1_put(k, (np.arange(4), None, None), 0)
            c.l2_put(k, np.arange(int(rng.randint(1, 40))), 0)
    return c


def test_export_metrics_cache():
    objs = {"port": _lru_traffic(cache, port_spec),
            "ref": _lru_traffic(ref_cache, ref_spec)}
    snap = _same_registry(lambda pkg, reg: objs[pkg].export_metrics(reg))
    assert snap["gauges"]["cache_hit_ratio"] > 0
    assert snap["counters"]['cache_level{key="evicted_entries",level="l2"}'] > 0


def test_export_metrics_faults_and_pool():
    fault = dict(crashes=((0, 1, 0.0, 50.0),), stragglers=((1, 0, 0.0, 80.0,
                                                            3.0),),
                 outages=((2, 10.0, 20.0),), timeout_p=0.3,
                 timeout_start=0.0, timeout_end=100.0, seed=6)
    objs = {
        "port": (faults.FaultInjector(port_spec.FaultSpec(**fault), 3),
                 replicas.ReplicaPool(replicas.PoolConfig(
                     n_partitions=3, replicas_per_partition=2), seed=1)),
        "ref": (ref_faults.FaultInjector(ref_spec.FaultSpec(**fault), 3),
                ref_replicas.ReplicaPool(ref_replicas.PoolConfig(
                    n_partitions=3, replicas_per_partition=2), seed=1))}
    for pkg, (inj, pool) in objs.items():
        for t in range(30):
            inj.transient(float(t))
        mirror = replicas.JASS if pkg == "port" else ref_replicas.JASS
        for i in range(8):
            for rep in pool.route_query(mirror):
                pool.complete(rep, latency=float(3 + i), ok=i % 3 != 0)

    def fill(pkg, reg):
        for o in objs[pkg]:
            o.export_metrics(reg)

    snap = _same_registry(fill)
    assert snap["counters"]["fault_transient_draws"] == 30
    assert 'pool_ewma_latency_us{mirror="jass"}' in snap["gauges"]
    # an idle pool exports no EWMA gauge, as the reference's
    snap = _same_registry(lambda pkg, reg: (
        replicas.ReplicaPool(replicas.PoolConfig(1, 2)) if pkg == "port"
        else ref_replicas.ReplicaPool(ref_replicas.PoolConfig(1, 2))
    ).export_metrics(reg))
    assert not any(k.startswith("pool_ewma") for k in snap["gauges"])


def test_export_metrics_delta(small_collection, port_collection):
    from repro.index.delta import DeltaStore as RefDeltaStore
    from repro_torch.index.delta import DeltaStore
    corpus, index, _ = small_collection
    pcorpus, pindex = port_collection
    kw = dict(capacity_docs=64, capacity_postings=2048, tile_d=128)
    stores = {"port": DeltaStore(pindex, device="cpu", **kw),
              "ref": RefDeltaStore(index, **kw)}
    stores["port"].add(synthesize_feed_docs(pcorpus, 24, seed=2))
    stores["ref"].add(ref_feed_docs(corpus, 24, seed=2))
    snap = _same_registry(lambda pkg, reg: stores[pkg].export_metrics(reg))
    assert snap["gauges"]['ingest{key="delta_docs"}'] > 0


# ---------------------------------------------------------------------------
# served: a small fitted system, telemetry on vs off, both packages
# ---------------------------------------------------------------------------

def _spec(mod, telemetry=None, fault=None, cache=None, failover=0.0,
          retries=0, budget=100.0, **online_kw):
    """``tests/test_telemetry.py``'s ``_spec``, in either package."""
    online = {"max_batch": 8, "batch_deadline_us": 4.0}
    online.update(online_kw)
    return mod.CascadeSpec(
        routing=mod.RoutingSpec(budget=budget, rho_max=1 << 14, t_k=150.0,
                                t_time=18.0, adapt_every=0,
                                failover_timeout=failover,
                                max_retries=retries),
        stage2=mod.Stage2Spec(enabled=True, k_serve=32, t_final=5),
        backend=mod.BackendSpec(backend="jnp"),
        deploy=mod.DeploySpec(n_shards=2, replicas=2),
        online=mod.OnlineSpec(**online),
        telemetry=telemetry if telemetry is not None else mod.TelemetrySpec(),
        fault=fault if fault is not None else mod.FaultSpec(),
        cache=cache if cache is not None else mod.CacheSpec(),
        name="telemetry_test",
    )


TEL = dict(telemetry=ref_spec.TelemetrySpec(enabled=True))


@pytest.fixture(scope="module")
def port_collection():
    corpus = build_corpus(CorpusParams(n_docs=4096, vocab=2048,
                                       avg_doclen=80, zipf_a=1.05, seed=3))
    return corpus, build_index(corpus, stop_k=8)


@pytest.fixture(scope="module")
def fitted(small_collection):
    """``tests/test_telemetry.py``'s ``fitted``: the reference's fit
    (pseudo-labels, seed 5, calibrated thresholds) and its models
    converted for the port."""
    corpus, index, ql = small_collection
    spec = _spec(ref_spec)
    spec = dataclasses.replace(
        spec, routing=dataclasses.replace(spec.routing, t_k=None,
                                          t_time=None, calibrate=True))
    ref = ref_build_system(spec, index, corpus=corpus)
    ref.fit(ql, None, seed=5)
    return ref, convert.system_models(ref, "cpu")


@pytest.fixture(scope="module")
def pair(small_collection, port_collection, fitted):
    """``pair(spec=None, tower=None, **kw)``: the reference system of
    ``_spec(**kw)`` (or of ``spec``, a reference spec) with the fit's
    thresholds frozen, and the port's built from its JSON."""
    corpus, index, _ = small_collection
    pcorpus, pindex = port_collection
    ref, (models, ltr) = fitted

    def make(spec=None, tower=None, **kw):
        spec = _spec(ref_spec, **kw) if spec is None else spec
        spec = dataclasses.replace(spec, routing=dataclasses.replace(
            spec.routing, t_k=ref._base_cfg.t_k,
            t_time=ref._base_cfg.t_time, calibrate=False))
        a = ref_build_system(spec, index, corpus=corpus, models=ref.models,
                             ltr=ref.ltr)
        b = build_system(convert.cascade_spec(spec), pindex, corpus=pcorpus,
                         models=models, ltr=ltr, tower=tower, device="cpu")
        return a, b
    return make


def _same_results(ra, rb):
    for key in ("topk", "final", "candidates_used", "latency",
                "coverage"):
        u, v = getattr(ra, key), getattr(rb, key)
        if u is None:
            assert v is None, key
        else:
            np.testing.assert_array_equal(np.asarray(v), np.asarray(u),
                                          err_msg=key)
    for k in ("modality", "theta_skip", "fallback"):
        if ra.dense is not None:
            np.testing.assert_array_equal(rb.dense[k], ra.dense[k])


def _same_online(ra, rb):
    assert rb.event_log == ra.event_log
    for key in ("arrival", "wait", "service", "completion", "response",
                "mode", "batch_of", "topk", "final", "coverage"):
        u, v = getattr(ra, key), getattr(rb, key)
        if u is None:
            assert v is None, key
        else:
            np.testing.assert_array_equal(v, u, err_msg=key)
    assert rb.stats == ra.stats


def _same_stats(a, b):
    sa, sb = a.stats(), b.stats()
    assert sb.pop("device") == "cpu"
    assert sb == sa
    return sb


def _same_snapshot(a, b, now=None):
    """The port's snapshot equals the reference's as a dict, as JSON bytes
    and as Prometheus text; returns it."""
    sa, sb = a.snapshot(now=now), b.snapshot(now=now)
    assert sb == sa
    assert export.render_json(sb) == ref_export.render_json(sa)
    assert export.render_prometheus(sb) == ref_export.render_prometheus(sa)
    assert b.render_snapshot("json", now=now) \
        == a.render_snapshot("json", now=now)
    assert b.render_snapshot("prom", now=now) \
        == a.render_snapshot("prom", now=now)
    return sb


def _serve(a, b, ql, rows=slice(None), **kw):
    ra = a.serve(ql.terms[rows], ql.mask[rows], ql.topic[rows], **kw)
    rb = b.serve(ql.terms[rows], ql.mask[rows], ql.topic[rows], **kw)
    _same_results(ra, rb)
    assert rb.stats == ra.stats
    return ra, rb


def _online(a, b, ql, rows=slice(None), **traffic):
    ra = a.serve_online(ql.terms[rows], ql.mask[rows], ql.topic[rows],
                        traffic=ref_spec.TrafficSpec(**traffic))
    rb = b.serve_online(ql.terms[rows], ql.mask[rows], ql.topic[rows],
                        traffic=port_spec.TrafficSpec(**traffic))
    _same_online(ra, rb)
    return ra, rb


@pytest.fixture(scope="module")
def offline(small_collection, pair):
    """One batch of the 96 queries through a telemetry-off port system and
    a telemetry-on system of each package (the reference's own tests hold
    its off run to its on run)."""
    ql = small_collection[2]
    (a_off, b_off), (a_on, b_on) = pair(), pair(**TEL)
    rb_off = b_off.serve(ql.terms, ql.mask, ql.topic)
    res = {"off": (None, rb_off), "on": _serve(a_on, b_on, ql)}
    return {"off": (a_off, b_off), "on": (a_on, b_on)}, res


BURSTY = dict(arrival="bursty", qps=150.0, seed=3)


@pytest.fixture(scope="module")
def bursty(small_collection, pair):
    """The bursty trace through a telemetry-off port system and a
    telemetry-on system of each package."""
    ql = small_collection[2]
    _, b_off = pair()
    a_on, b_on = pair(**TEL)
    rb_off = b_off.serve_online(ql.terms, ql.mask, ql.topic,
                                traffic=port_spec.TrafficSpec(**BURSTY))
    return rb_off, (a_on, b_on), _online(a_on, b_on, ql, **BURSTY)


def test_disabled_telemetry_is_provably_inert(offline):
    """enabled=False allocates no registry, serving equals the
    reference's and the telemetry-on run's, and snapshot() refuses."""
    systems, res = offline
    (a_off, b_off), (a_on, b_on) = systems["off"], systems["on"]
    assert b_off.telemetry is None and b_on.telemetry is not None
    _same_results(res["on"][0], res["off"][1])
    _same_results(res["on"][1], res["off"][1])
    with pytest.raises(RuntimeError, match="telemetry is disabled"):
        b_off.snapshot()
    with pytest.raises(RuntimeError, match="telemetry is disabled"):
        b_off.render_snapshot()
    with pytest.raises(ValueError, match="unknown snapshot format"):
        b_on.render_snapshot("xml")


def test_disabled_telemetry_online_event_log_bit_identical(bursty):
    rb_off, (a_on, b_on), (ra_on, rb_on) = bursty
    assert rb_off.event_log == rb_on.event_log == ra_on.event_log
    for key in ("response", "topk", "final", "mode", "batch_of"):
        np.testing.assert_array_equal(getattr(rb_off, key),
                                      getattr(rb_on, key))
    assert "telemetry" not in rb_off.stats and "telemetry" in rb_on.stats
    assert {k: v for k, v in rb_on.stats.items() if k != "telemetry"} \
        == rb_off.stats
    _same_snapshot(a_on, b_on)


def test_stats_compat_view_matches_legacy(offline):
    systems, _ = offline
    (_, b_off), (a_on, b_on) = systems["off"], systems["on"]
    s_off, s_on = b_off.stats(), _same_stats(a_on, b_on)
    assert s_off.pop("device") == "cpu"
    assert set(s_on) == set(s_off)
    for section in ("scheduler", "faults", "ingest", "pool"):
        if section in s_off:
            assert s_on[section] == s_off[section], section
    assert all(type(v) is type(s_off["scheduler"][k])
               for k, v in s_on["scheduler"].items())
    assert s_on["scheduler"] and s_on["n_shards"] == s_off["n_shards"]


def test_offline_snapshot_contents_and_determinism(small_collection, pair,
                                                   offline):
    ql = small_collection[2]
    systems, _ = offline
    a, b = systems["on"]
    snap = _same_snapshot(a, b)
    h = snap["histograms"]
    assert h["service_latency_us"]["count"] == len(ql.terms)
    for st in ("stage0", "stage1", "stage2"):
        key = f'stage_latency_us{{stage="{st}"}}'
        assert key in h and "p99.99" in h[key]
        assert h[key]["p50"] <= h[key]["p99"] <= h[key]["p99.99"]
    assert snap["counters"]["queries_served"] == len(ql.terms)
    assert "worst_case_us" in snap and snap["budget_us"] == 100.0
    assert snap["traces"]
    tr = snap["traces"][0]
    names = [c["name"] for c in tr["spans"]["children"]]
    assert names[:2] == ["stage0", "route"] and "stage1" in names
    assert "why_slow" in tr
    _, b2 = pair(**TEL)
    b2.serve(ql.terms, ql.mask, ql.topic)
    assert b2.render_snapshot() == b.render_snapshot()
    prom = export.render_prometheus(snap)
    assert "# TYPE repro_service_latency_us summary" in prom
    assert 'quantile="0.9999"' in prom
    assert "repro_queries_served_total" in prom
    # a snapshot at a pinned clock, and one after more batches
    _same_snapshot(a, b, now=1234.5)
    _serve(a, b, ql, slice(0, 8))
    _same_snapshot(a, b)


def test_online_snapshot_counters_and_shed_traces(small_collection, pair):
    ql = small_collection[2]
    a, b = pair(queue_cap=8, **TEL)
    _, res = _online(a, b, ql, arrival="bursty", qps=3000.0, seed=3)
    snap = _same_snapshot(a, b)
    _same_stats(a, b)
    c = snap["counters"]
    shed = sum(v for k, v in c.items() if k.startswith("shed_queries"))
    assert shed == res.stats["shed"] and shed > 0
    served = sum(v for k, v in c.items() if k.startswith("served_mode"))
    assert served == res.stats["served"]
    assert "queue_wait_us" in snap["histograms"]
    assert "response_latency_us" in snap["histograms"]
    shed_traces = [t for t in snap["traces"]
                   if t["meta"].get("mode") == "shed"]
    assert shed_traces
    assert shed_traces[0]["spans"]["children"][0]["name"] == "admission"


def test_degraded_mode_counters_under_tight_budget(small_collection, pair):
    ql = small_collection[2]
    a, b = pair(budget=10.0, **TEL)
    _, res = _serve(a, b, ql)
    bs = res.stats["budget"]
    assert bs["stage2_trimmed"] + bs["stage2_skipped"] > 0
    snap = _same_snapshot(a, b)
    assert snap["counters"].get("stage2_trimmed", 0) == bs["stage2_trimmed"]
    assert snap["counters"].get("stage2_skipped", 0) == bs["stage2_skipped"]
    if bs["stage2_skipped"]:
        assert [t for t in snap["traces"] for s in t["spans"]["children"]
                if s["name"] == "stage2"
                and s.get("meta", {}).get("skipped")]


def test_partial_coverage_spans(small_collection, pair):
    """Admission's partial-coverage rung offline (``shard_cap``): the
    dropped shards' spans and the coverage metadata equal the
    reference's."""
    ql = small_collection[2]
    a, b = pair(**TEL)
    cap = np.where(np.arange(len(ql.terms)) % 3 == 0, 1, 2)
    _, res = _serve(a, b, ql, shard_cap=cap)
    assert res.coverage.min() < 1.0
    snap = _same_snapshot(a, b)
    assert [s for t in snap["traces"] for c in t["spans"]["children"]
            if c["name"] == "stage1" for s in c["children"]
            if s["meta"].get("dropped")]
    assert all("coverage" in t["meta"] for t in snap["traces"])


def test_cache_hit_traces_and_hit_ratio_gauge(small_collection, pair):
    ql = small_collection[2]
    a, b = pair(cache=ref_spec.CacheSpec(enabled=True, l1_entries=256,
                                         l2_entries=256), **TEL)
    n = 14
    _serve(a, b, ql, slice(0, n))
    _serve(a, b, ql, slice(0, n))
    # an L2 serve: a tighter Stage-2 cap misses L1 and hits L2
    _serve(a, b, ql, slice(0, n), stage2_cap=np.full(n, 16))
    snap = _same_snapshot(a, b)
    _same_stats(a, b)
    assert snap["gauges"]["cache_hit_ratio"] > 0
    assert snap["counters"]['cache_level{key="hits",level="l1"}'] > 0
    hits = [t for t in snap["traces"] if t["meta"].get("cache") == "l1"]
    assert hits and any(s["name"] == "cache_lookup"
                        and s.get("meta", {}).get("hit")
                        for t in hits for s in t["spans"]["children"])
    assert [t for t in snap["traces"] if t["meta"].get("cache") == "miss"]


def test_cached_online_front_door(small_collection, pair):
    """The loop's front door with telemetry: front-door hits, their
    response latencies and traces, equal to the reference's."""
    ql = small_collection[2]
    a, b = pair(cache=ref_spec.CacheSpec(enabled=True), **TEL)
    _, res = _online(a, b, ql, arrival="poisson", qps=150.0, seed=5,
                     skew=1.2)
    snap = _same_snapshot(a, b)
    assert snap["counters"]["front_door_hits"] \
        == res.stats["cache"]["front_door_hits"] > 0


def test_fault_retry_traces_and_counters(small_collection, pair):
    ql = small_collection[2]
    fault = ref_spec.FaultSpec(crashes=((0, 0, 0.0, INF),))
    a, b = pair(fault=fault, failover=15.0, retries=2, **TEL)
    _serve(a, b, ql)
    snap = _same_snapshot(a, b)
    _same_stats(a, b)
    assert snap["counters"]['faults{key="retries"}'] > 0
    retried = [s for t in snap["traces"]
               for c in t["spans"]["children"] if c["name"] == "stage1"
               for s in c["children"]
               if s["name"] == "shard" and "retry_wait_us" in s["meta"]]
    assert retried and all(s["meta"]["attempts_failed"] >= 1
                           for s in retried)
    assert all("coverage" in t["meta"] for t in snap["traces"])


def test_faulted_online_storm(small_collection, pair):
    """A transient-timeout storm and a straggler online: lost and slowed
    shard spans, the injector's draws and every counter equal."""
    ql = small_collection[2]
    fault = ref_spec.FaultSpec(stragglers=((1, 0, 0.0, INF, 2.5),),
                               timeout_p=0.4, timeout_start=0.0,
                               timeout_end=300.0, seed=3)
    a, b = pair(fault=fault, failover=10.0, retries=1, **TEL)
    _online(a, b, ql, slice(0, 64), arrival="poisson", qps=120.0, seed=2)
    snap = _same_snapshot(a, b)
    _same_stats(a, b)
    assert snap["counters"]["fault_transient_draws"] == b.faults.draws > 0
    assert snap["counters"]['faults{key="transient"}'] > 0


def test_periodic_snapshots_on_virtual_clock(small_collection, pair):
    ql = small_collection[2]
    a, b = pair(telemetry=ref_spec.TelemetrySpec(
        enabled=True, snapshot_every_us=50.0, max_snapshots=16))
    _, res = _online(a, b, ql, arrival="poisson", qps=150.0, seed=3)
    snaps = b.telemetry.snapshots
    assert 0 < len(snaps) <= 16
    assert res.stats["telemetry"]["snapshots"] == len(snaps)
    clocks = [s["clock_us"] for s in snaps]
    assert clocks == sorted(clocks)
    assert snaps == a.telemetry.snapshots
    assert [export.render_json(s) for s in snaps] \
        == [ref_export.render_json(s) for s in a.telemetry.snapshots]
    assert b.telemetry._next_snapshot_us == a.telemetry._next_snapshot_us


def test_fresh_probe_has_its_own_registry(small_collection, pair):
    """``fresh_probe`` (the port's ``_fresh_copy``) starts a registry and a
    trace store of its own, as the reference's fresh build does: a
    capacity probe leaves the parent's snapshot alone."""
    from repro_torch.serving.online import estimate_capacity, fresh_probe
    ql = small_collection[2]
    a, b = pair(**TEL)
    _serve(a, b, ql, slice(0, 8))
    before = b.render_snapshot()
    probe = fresh_probe(b)
    assert probe.telemetry is not b.telemetry
    assert probe.telemetry.registry is not b.telemetry.registry
    estimate_capacity(probe, ql.terms, ql.mask, ql.topic)
    assert b.render_snapshot() == before
    assert probe.snapshot()["counters"]["batches_served"] == 4


def test_hybrid_fusion_modality_counters(small_collection, pair):
    """``hybrid_fusion`` with the reference's tower: the modality, theta
    skip and fallback counters, the fusion and fallback spans."""
    params, _ = ref_recsys.init(REF_REDUCED, jax.random.PRNGKey(0))
    tower = convert.two_tower_params(jax.tree.map(np.asarray, params),
                                     "cpu")
    preset = ref_get_preset("hybrid_fusion")
    spec = dataclasses.replace(_spec(ref_spec, **TEL), name="hybrid_fusion",
                               dense=preset.dense, fusion=preset.fusion)
    a, b = pair(spec=spec, tower=tower)
    ql = small_collection[2]
    _, res = _serve(a, b, ql)
    snap = _same_snapshot(a, b)
    c = snap["counters"]
    d = res.stats["dense"]
    assert c['modality{route="lexical"}'] == d["lexical"] > 0
    assert c['modality{route="dense_only"}'] + c['modality{route="fused"}'] \
        == d["dense_only"] + d["fused"] > 0


def test_live_ingest_online(small_collection, pair):
    """``live_ingest``'s loop with telemetry: the delta scan span, the
    ingest counters and gauges, the feed/merge admission counters."""
    ql = small_collection[2]
    kw = dict(enabled=True, delta_docs=64, delta_postings=2048,
              feed_qps=40.0, feed_batch=8, merge_threshold=0.5, seed=4)
    spec = dataclasses.replace(_spec(ref_spec, **TEL),
                               ingest=ref_spec.IngestSpec(**kw))
    a, b = pair(spec=spec)
    _, res = _online(a, b, ql, slice(0, 40), arrival="poisson", qps=120.0,
                     seed=6)
    snap = _same_snapshot(a, b)
    _same_stats(a, b)
    assert res.stats["ingest"]["feed_batches_applied"] > 0
    assert snap["gauges"]['ingest{key="delta_us"}'] > 0
    assert [s for t in snap["traces"] for c in t["spans"]["children"]
            if c["name"] == "stage1" for s in c["children"]
            if s["name"] == "delta_scan"]
