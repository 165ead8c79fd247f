"""The port's online serving loop against the reference, on the CPU.

``repro_torch.serving.online`` (traffic, batcher, admission, simulator) and
``SearchSystem.serve_online`` / ``serve(shard_cap=...)`` are held to
``repro.serving.online`` and the reference's ``SearchSystem`` at tolerance
0.0:

* the arrival processes (poisson, bursty, diurnal over five seeds each,
  trace replay from ``.npy`` and JSON), ``zipf_query_mix`` and
  ``feed_arrival_times``, bit for bit;
* ``bucket_size`` / ``pad_batch`` over a grid and ``MicroBatcher.close``
  over seeded queues;
* ``AdmissionController`` through seeded sequences of every decision and
  observation, with and without the partial-coverage bounds and a cache
  bound: modes, caps, shard caps, gates, stats and both EWMAs;
* ``serve(shard_cap=...)`` on a 4-shard x 3-replica deployment with 5
  units of gather a shard: ``topk``, ``final``, latency, coverage, the
  batch stats and ``stats()``;
* ``serve_online``: the event log (tuple equality of Python floats), every
  per-query array and the stats, for ``tests/test_online.py``'s
  ``online_test`` spec under each arrival process, Zipf skew, a queue cap
  and the no-admission baseline; ``paper_200ms`` adapting its routing after
  every one of more than 100 batches; ``hybrid_fusion`` with the
  reference's two-tower model carried across; and the 4 x 3 deployment
  under bursty overload, where every rung of the ladder occurs (partial
  coverage included);
* the reference's own claims of ``tests/test_online.py`` on the port:
  determinism, micro-batch parity, response accounting, overload sheds but
  never violates; ``fresh_probe`` keeps the device and the tower;
* the loop's cache branches (front door, dispatch peek, hit EWMA) and its
  fault branch on both packages; its refusal of live ingest and
  telemetry;
* ``chip_smoke.online_flow("cpu")`` against the reference's
  ``benchmarks/bench_online.run_online`` (its artifact write stubbed), at
  a reduced size.

The reference serves on its ``"jnp"`` backend, the port on the CPU (each
kernel wrapper's plain version).
"""

import dataclasses
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from repro.configs.cascade_presets import get_preset as ref_get_preset
from repro.configs.two_tower_retrieval import REDUCED as REF_REDUCED
from repro.index.corpus import build_queries
from repro.models import recsys as ref_recsys
from repro.serving import online as ref_online
from repro.serving import spec as ref_spec
from repro.serving.latency import CostModel as RefCostModel
from repro.serving.system import build_system as ref_build_system
from repro_torch import convert
from repro_torch.index.builder import build_index
from repro_torch.index.corpus import CorpusParams, build_corpus
from repro_torch.serving import online
from repro_torch.serving import spec as port_spec
from repro_torch.serving.latency import CostModel
from repro_torch.serving.system import build_system

ROOT = pathlib.Path(__file__).resolve().parents[1]
SEEDS = (0, 1, 7, 23, 1009)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _traffic(**kw):
    """The same TrafficSpec in both packages."""
    return ref_spec.TrafficSpec(**kw), port_spec.TrafficSpec(**kw)


# ---------------------------------------------------------------------------
# traffic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("arrival,kw", [
    ("poisson", {}),
    ("bursty", {"burst_factor": 6.0, "burst_fraction": 0.1,
                "burst_dwell_us": 30.0}),
    ("diurnal", {"diurnal_amplitude": 0.8, "diurnal_period_us": 400.0})],
    ids=["poisson", "bursty", "diurnal"])
def test_arrival_times_match_reference(arrival, kw, seed):
    want_spec, got_spec = _traffic(arrival=arrival, qps=173.0, seed=seed,
                                   **kw)
    for n in (1, 50, 3000):
        want = ref_online.arrival_times(want_spec, n)
        got = online.arrival_times(got_spec, n)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("suffix", [".npy", ".json"])
def test_trace_replay_matches_reference(suffix, tmp_path):
    ts = np.random.RandomState(3).rand(40) * 1e3
    path = tmp_path / f"trace{suffix}"
    if suffix == ".npy":
        np.save(path, ts)
    else:
        path.write_text(json.dumps(ts.tolist()))
    np.testing.assert_array_equal(online.load_trace(str(path)),
                                  ref_online.load_trace(str(path)))
    want_spec, got_spec = _traffic(arrival="trace", trace_path=str(path))
    for n in (1, 17, 40):
        np.testing.assert_array_equal(online.arrival_times(got_spec, n),
                                      ref_online.arrival_times(want_spec, n))
    with pytest.raises(ValueError, match="timestamps"):
        online.arrival_times(got_spec, 41)


def test_zipf_mix_and_feed_arrivals_match_reference():
    for seed in SEEDS:
        for skew in (0.0, 0.7, 1.2, 2.5):
            want_spec, got_spec = _traffic(qps=50.0, seed=seed, skew=skew)
            for n, n_unique in ((1, None), (300, None), (300, 17)):
                np.testing.assert_array_equal(
                    online.zipf_query_mix(got_spec, n, n_unique),
                    ref_online.zipf_query_mix(want_spec, n, n_unique))
        ing = dict(enabled=True, seed=seed, feed_qps=3.5)
        np.testing.assert_array_equal(
            online.traffic.feed_arrival_times(port_spec.IngestSpec(**ing),
                                              64),
            ref_online.traffic.feed_arrival_times(
                ref_spec.IngestSpec(**ing), 64))


# ---------------------------------------------------------------------------
# batcher
# ---------------------------------------------------------------------------

def test_bucket_and_pad_match_reference():
    for max_batch in (1, 3, 8, 32):
        for bucket_q in (True, False):
            for n in range(1, 40):
                rows = np.arange(100, 100 + n)
                if n > max_batch:
                    with pytest.raises(ValueError, match="max_batch"):
                        online.bucket_size(n, max_batch, bucket_q)
                    continue
                assert online.bucket_size(n, max_batch, bucket_q) \
                    == ref_online.bucket_size(n, max_batch, bucket_q)
                got, n_got = online.pad_batch(rows, max_batch, bucket_q)
                want, n_want = ref_online.pad_batch(rows, max_batch,
                                                    bucket_q)
                assert n_got == n_want and got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
def test_batcher_close_matches_reference(seed):
    rng = np.random.RandomState(seed)
    for _ in range(60):
        kw = dict(max_batch=int(rng.choice([1, 4, 8, 32])),
                  batch_deadline_us=float(rng.choice([0.0, 2.5, 5.0])))
        a = ref_online.MicroBatcher(ref_spec.OnlineSpec(**kw))
        b = online.MicroBatcher(port_spec.OnlineSpec(**kw))
        pending = np.sort(rng.rand(rng.randint(1, 50)) * 40.0)
        free = float(rng.rand() * 60.0)
        assert b.close(pending, free) == a.close(pending, free)
        assert b.deadline(pending[0], free) == a.deadline(pending[0], free)


# ---------------------------------------------------------------------------
# admission
# ---------------------------------------------------------------------------

def _controllers(case):
    """The same AdmissionController in both packages for ``case``."""
    cfg = dict(max_batch=8, dispatch_us=1.0, queue_cap=case.get("cap", 0),
               degrade=case.get("degrade", True))
    kw = dict(stage1_bound=100.0, k_serve=case.get("k_serve", 64),
              response_budget=200.0, partial_bounds=case.get("partial"),
              cache_bound=case.get("cache"))
    cost = dict(gather_per_shard_us=5.0)
    return (ref_online.AdmissionController(
                ref_spec.OnlineSpec(**cfg),
                dataclasses.replace(RefCostModel.paper_scale(), **cost),
                **kw),
            online.AdmissionController(
                port_spec.OnlineSpec(**cfg),
                dataclasses.replace(CostModel.paper_scale(), **cost), **kw))


def _same(a, b):
    if a is None or isinstance(a, (bool, int, float)):
        assert b == a
    elif isinstance(a, tuple):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            _same(u, v)
    else:
        assert b.dtype == a.dtype
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("seed", SEEDS[:3])
@pytest.mark.parametrize("case", [
    {}, {"degrade": False}, {"k_serve": None}, {"cap": 5},
    {"partial": [85.0, 90.0, 95.0, 100.0]},
    {"partial": [85.0, 90.0, 95.0, 100.0], "k_serve": None},
    {"partial": [100.0, 100.0]},
    {"cache": 20.0}, {"cache": 20.0, "degrade": False},
    {"cache": 20.0, "partial": [70.0, 85.0, 100.0]}],
    ids=["ladder", "no_degrade", "stage1_only", "queue_cap", "partial",
         "partial_stage1_only", "flat_bounds", "cache", "cache_no_degrade",
         "cache_partial"])
def test_admission_sequences_match_reference(case, seed):
    a, b = _controllers(case)
    rng = np.random.RandomState(seed)
    for _ in range(150):
        op = rng.randint(6)
        if op == 0:
            args = (float(rng.rand() * 100), float(rng.rand() * 150),
                    int(rng.randint(0, 30)))
            _same(a.at_arrival(*args), b.at_arrival(*args))
        elif op == 1:
            waits = rng.rand(rng.randint(1, 20)) * 110.0
            hits = (rng.rand(len(waits)) < 0.4 if rng.rand() < 0.5
                    else None)
            _same(a.at_dispatch(waits, hits), b.at_dispatch(waits, hits))
        elif op == 2:
            occ = float(rng.rand() * 150)
            a.observe_batch(occ)
            b.observe_batch(occ)
        elif op == 3:
            n = int(rng.randint(0, 9))
            hits = int(rng.randint(0, n + 1))
            a.observe_hits(hits, n)
            b.observe_hits(hits, n)
        elif op == 4:
            args = (float(rng.rand() * 100), float(rng.rand() * 150),
                    int(rng.randint(0, 30)))
            pause = float(rng.rand() * 20)
            _same(a.feed_gate(*args, pause_us=pause),
                  b.feed_gate(*args, pause_us=pause))
        else:
            args = (float(rng.rand() * 100), float(rng.rand() * 150),
                    int(rng.randint(0, 3)))
            full = bool(rng.rand() < 0.3)
            _same(a.merge_gate(*args, full=full),
                  b.merge_gate(*args, full=full))
        assert b.stats == a.stats
        assert b.occupancy_ewma == a.occupancy_ewma
        assert b.hit_ewma == a.hit_ewma


# ---------------------------------------------------------------------------
# systems
# ---------------------------------------------------------------------------

def _online_spec(spec_mod, **online_kw):
    """``tests/test_online.py``'s ``_spec``, in either package."""
    kw = {"max_batch": 8, "batch_deadline_us": 4.0}
    kw.update(online_kw)
    return spec_mod.CascadeSpec(
        routing=spec_mod.RoutingSpec(budget=100.0, rho_max=1 << 14,
                                     t_k=150.0, t_time=18.0, adapt_every=0),
        stage2=spec_mod.Stage2Spec(enabled=True, k_serve=32, t_final=5),
        backend=spec_mod.BackendSpec(backend="jnp"),
        online=spec_mod.OnlineSpec(**kw), name="online_test")


@pytest.fixture(scope="module")
def port_collection():
    corpus = build_corpus(CorpusParams(n_docs=4096, vocab=2048,
                                       avg_doclen=80, zipf_a=1.05, seed=3))
    return corpus, build_index(corpus, stop_k=8)


@pytest.fixture(scope="module")
def fitted(small_collection, port_collection):
    """The ``online_test`` spec fitted by the reference (pseudo-labels,
    seed 5), its calibrated thresholds frozen into the spec, and its models
    converted for the port."""
    corpus, index, ql = small_collection
    spec = _online_spec(ref_spec)
    spec = dataclasses.replace(spec, routing=dataclasses.replace(
        spec.routing, calibrate=True))
    ref = ref_build_system(spec, index, corpus=corpus)
    ref.fit(ql, None, seed=5)
    return ref, convert.system_models(ref, "cpu")


def _pair(small_collection, port_collection, fitted, spec, *, cost=None,
          tower=None):
    """The reference system for ``spec`` (a reference spec, thresholds
    frozen from ``fitted``) and the port built from its JSON."""
    corpus, index, _ = small_collection
    pcorpus, pindex = port_collection
    ref, (models, ltr) = fitted
    spec = dataclasses.replace(spec, routing=dataclasses.replace(
        spec.routing, t_k=ref._base_cfg.t_k, t_time=ref._base_cfg.t_time,
        calibrate=False))
    with_ltr = spec.stage2.enabled
    a = ref_build_system(spec, index, corpus=corpus, models=ref.models,
                         ltr=ref.ltr if with_ltr else None, cost=cost)
    b = build_system(convert.cascade_spec(spec), pindex, corpus=pcorpus,
                     models=models, ltr=ltr if with_ltr else None,
                     cost=(None if cost is None else
                           CostModel(**dataclasses.asdict(cost))),
                     tower=tower, device="cpu")
    return a, b


def _assert_same_stats(a, b):
    sa, sb = a.stats(), b.stats()
    assert sb.pop("device") == "cpu"
    assert sb == sa


def _assert_same_online(ra, rb):
    assert rb.event_log == ra.event_log
    for key in ("arrival", "wait", "service", "completion", "response",
                "mode", "batch_of", "topk", "final", "coverage"):
        u, v = getattr(ra, key), getattr(rb, key)
        if u is None:
            assert v is None, key
        else:
            assert v.dtype == u.dtype, key
            np.testing.assert_array_equal(v, u, err_msg=key)
    assert rb.stats == ra.stats


def _serve_online_pair(a, b, ql, traffic_kw, rows=slice(None)):
    want_t, got_t = _traffic(**traffic_kw)
    ra = a.serve_online(ql.terms[rows], ql.mask[rows], ql.topic[rows],
                        traffic=want_t)
    rb = b.serve_online(ql.terms[rows], ql.mask[rows], ql.topic[rows],
                        traffic=got_t)
    _assert_same_online(ra, rb)
    _assert_same_stats(a, b)
    return ra, rb


@pytest.fixture(scope="module")
def trace_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("online") / "trace.npy"
    np.save(path, np.cumsum(np.random.RandomState(4).exponential(6.0, 96)))
    return str(path)


OVERLOAD = dict(arrival="bursty", qps=3000.0, seed=6)


@pytest.mark.parametrize("online_kw,traffic_kw", [
    ({}, dict(arrival="poisson", qps=200.0, seed=1)),
    ({}, dict(arrival="bursty", qps=150.0, seed=3)),
    ({}, dict(arrival="diurnal", qps=250.0, seed=4,
              diurnal_period_us=200.0)),
    ({}, dict(arrival="trace", trace_path=None)),
    ({}, dict(arrival="poisson", qps=300.0, seed=5, skew=1.2)),
    ({"response_budget_us": 130.0}, OVERLOAD),
    ({"response_budget_us": 130.0, "queue_cap": 4}, OVERLOAD),
    ({"response_budget_us": 130.0, "admission": False, "max_batch": 1,
      "batch_deadline_us": 0.0, "bucket_q": False}, OVERLOAD)],
    ids=["poisson", "bursty", "diurnal", "trace", "zipf_skew", "overload",
         "queue_cap", "baseline"])
def test_serve_online_matches_reference(small_collection, port_collection,
                                        fitted, trace_path, online_kw,
                                        traffic_kw):
    ql = small_collection[2]
    if traffic_kw.get("arrival") == "trace":
        traffic_kw = dict(traffic_kw, trace_path=trace_path)
    a, b = _pair(small_collection, port_collection, fitted,
                 _online_spec(ref_spec, **online_kw))
    ra, rb = _serve_online_pair(a, b, ql, traffic_kw)
    assert rb.stats["served"] > 0 and rb.coverage is None
    if online_kw.get("queue_cap"):
        assert rb.stats["admission"]["shed_queue_cap"] > 0
    if online_kw.get("admission") is False:
        assert rb.stats["over_budget"] >= 1 and rb.stats["shed"] == 0
    else:
        assert rb.stats["over_budget"] == 0


def test_paper_200ms_adapting_every_batch_matches_reference(
        small_collection, port_collection, fitted):
    """``paper_200ms`` ships ``adapt_every=1``: the pinball EWMA, the
    ``hedge_deadline`` update and the pool's EWMAs move after every batch
    and feed the next batch's routes, over more than 100 batches."""
    corpus, index, _ = small_collection
    ql = build_queries(corpus, 160, stop_k=8, seed=13)
    spec = dataclasses.replace(ref_get_preset("paper_200ms"),
                               backend=ref_spec.BackendSpec(backend="jnp"))
    assert spec.routing.adapt_every == 1
    a, b = _pair(small_collection, port_collection, fitted, spec)
    d0 = b.sched.cfg.hedge_deadline
    ra, rb = _serve_online_pair(a, b, ql, dict(arrival="poisson", qps=60.0,
                                               seed=2))
    assert rb.stats["batches"] >= 100
    assert b.sched.cfg.hedge_deadline != d0
    assert b.cascade_spec.to_json() == a.cascade_spec.to_json()


@pytest.fixture(scope="module")
def ref_tower():
    params, _ = ref_recsys.init(REF_REDUCED, jax.random.PRNGKey(0))
    return convert.two_tower_params(jax.tree.map(np.asarray, params), "cpu")


def test_hybrid_fusion_online_matches_reference(small_collection,
                                                port_collection, fitted,
                                                ref_tower):
    preset = ref_get_preset("hybrid_fusion")
    spec = dataclasses.replace(
        _online_spec(ref_spec), name="hybrid_fusion", dense=preset.dense,
        fusion=preset.fusion)
    a, b = _pair(small_collection, port_collection, fitted, spec,
                 tower=ref_tower)
    ra, rb = _serve_online_pair(a, b, small_collection[2],
                                dict(arrival="bursty", qps=400.0, seed=9))
    d = rb.stats["dense"]
    assert d["lexical"] > 0 and d["dense_only"] + d["fused"] > 0


def _partial_spec(spec_mod):
    """The 4-shard x 3-replica deployment whose shard bounds shrink with
    the shard count (5 units of gather a shard)."""
    return spec_mod.CascadeSpec(
        routing=spec_mod.RoutingSpec(budget=100.0, rho_max=1 << 14,
                                     late_rho=8192, hedge_deadline=0.6,
                                     calibrate=True),
        stage2=spec_mod.Stage2Spec(enabled=True, k_serve=64, t_final=10),
        backend=spec_mod.BackendSpec(backend="jnp"),
        deploy=spec_mod.DeploySpec(n_shards=4, replicas=3),
        online=spec_mod.OnlineSpec(max_batch=16, batch_deadline_us=5.0,
                                   admission=True, degrade=True,
                                   response_budget_us=150.0),
        name="partial")


@pytest.fixture(scope="module")
def fitted_partial(small_collection):
    corpus, index, ql = small_collection
    cost = dataclasses.replace(RefCostModel.paper_scale(),
                               gather_per_shard_us=5.0)
    ref = ref_build_system(_partial_spec(ref_spec), index, corpus=corpus,
                           cost=cost)
    ref.fit(ql, None, seed=5)
    return (ref, convert.system_models(ref, "cpu")), cost


def test_shard_cap_serve_matches_reference(small_collection,
                                           port_collection, fitted_partial):
    fitted, cost = fitted_partial
    ql = small_collection[2]
    a, b = _pair(small_collection, port_collection, fitted,
                 _partial_spec(ref_spec), cost=cost)
    for cap in ((np.arange(32) % 4) + 1, np.full(32, 4),
                np.r_[np.full(16, 1), np.full(16, 3)]):
        sl = slice(0, 32)
        ra = a.serve(ql.terms[sl], ql.mask[sl], ql.topic[sl], shard_cap=cap)
        rb = b.serve(ql.terms[sl], ql.mask[sl], ql.topic[sl], shard_cap=cap)
        for key in ("topk", "final", "latency", "candidates_used",
                    "coverage"):
            np.testing.assert_array_equal(getattr(rb, key), getattr(ra, key),
                                          err_msg=key)
        for key in ("coverage", "faults", "stages", "budget", "pool",
                    "jass", "bmw", "hedged", "late_hedged", "over_budget"):
            assert rb.stats[key] == ra.stats[key], key
        _assert_same_stats(a, b)
    assert b.stats()["faults"]["degraded_queries"] > 0
    # a query capped to m partitions holds only their documents
    ra = b.serve(ql.terms[:4], ql.mask[:4], ql.topic[:4],
                 shard_cap=np.full(4, 1))
    hi = b.doc_lo[1]
    assert ((ra.topk < hi) | (ra.topk == -1)).all()
    np.testing.assert_array_equal(ra.coverage, np.full(4, 0.25))


def test_partial_coverage_online_matches_reference(small_collection,
                                                   port_collection,
                                                   fitted_partial):
    """Every rung of the ladder in one trace: full, trim, stage1, partial
    and shed, with no served query over the response budget."""
    fitted, cost = fitted_partial
    a, b = _pair(small_collection, port_collection, fitted,
                 _partial_spec(ref_spec), cost=cost)
    bounds = [b.sched.cfg.worst_case_us(b.cost, m) for m in range(1, 5)]
    assert bounds == [a.sched.cfg.worst_case_us(a.cost, m)
                      for m in range(1, 5)]
    assert bounds[0] < bounds[-1] < b.worst_case_us() < 150.0
    ra, rb = _serve_online_pair(a, b, small_collection[2],
                                dict(arrival="bursty", qps=1000.0, seed=6))
    assert rb.stats["modes"] == ra.stats["modes"]
    assert all(n > 0 for n in rb.stats["modes"].values())
    assert rb.stats["over_budget"] == 0
    assert rb.stats["coverage"]["min"] < 1.0
    assert (rb.coverage[rb.mode == online.PARTIAL] < 1.0).all()


# ---------------------------------------------------------------------------
# the reference's own claims (tests/test_online.py), on the port
# ---------------------------------------------------------------------------

@pytest.fixture
def port_system(small_collection, port_collection, fitted):
    def make(**online_kw):
        return _pair(small_collection, port_collection, fitted,
                     _online_spec(ref_spec, **online_kw))[1]
    return make


def test_simulator_deterministic(small_collection, port_system):
    ql = small_collection[2]
    traffic = port_spec.TrafficSpec(arrival="bursty", qps=150.0, seed=3)
    a = port_system().serve_online(ql.terms, ql.mask, ql.topic,
                                   traffic=traffic)
    b = port_system().serve_online(ql.terms, ql.mask, ql.topic,
                                   traffic=traffic)
    _assert_same_online(a, b)


@pytest.fixture
def smoke(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke
    return chip_smoke


def test_microbatched_topk_bit_identical_to_unbatched(small_collection,
                                                      port_system, smoke):
    ql = small_collection[2]
    on = port_system().serve_online(
        ql.terms, ql.mask, ql.topic,
        traffic=port_spec.TrafficSpec(arrival="poisson", qps=300.0, seed=2))
    parity = smoke.microbatch_parity(on, port_system(), ql.terms,
                                          ql.mask, ql.topic, 24)
    assert parity == {"checked": 24, "identical_topk": True,
                      "identical_final": True}
    assert (on.batch_of >= 0).all() and len(set(on.batch_of)) < 24


def test_response_accounting_consistent(small_collection, port_system,
                                        smoke):
    ql = small_collection[2]
    system = port_system()
    on = system.serve_online(
        ql.terms, ql.mask, ql.topic,
        traffic=port_spec.TrafficSpec(arrival="poisson", qps=200.0, seed=1))
    err = smoke.check_response_accounting("poisson", on,
                                          system.cascade_spec.online)
    assert err <= 1e-12
    assert "queue" in on.stats["stages"]
    assert on.stats["stages"]["queue"]["max"] >= 0


def test_overload_sheds_but_never_violates(small_collection, port_system):
    ql = small_collection[2]
    traffic = port_spec.TrafficSpec(**OVERLOAD)
    on = port_system(response_budget_us=130.0).serve_online(
        ql.terms, ql.mask, ql.topic, traffic=traffic)
    assert on.stats["over_budget"] == 0 and on.stats["shed"] > 0
    assert on.stats["admission"]["shed_arrival"] > 0
    served = np.flatnonzero(on.mode != online.SHED)
    assert np.all(on.response[served] <= on.stats["response_budget"] + 1e-9)
    off = port_system(admission=False, max_batch=1, batch_deadline_us=0.0,
                      bucket_q=False, response_budget_us=130.0).serve_online(
        ql.terms, ql.mask, ql.topic, traffic=traffic)
    assert off.stats["over_budget"] >= 1 and off.stats["shed"] == 0


def test_fresh_probe_is_a_fresh_build(small_collection, port_collection,
                                      fitted, ref_tower):
    """``fresh_probe`` serves as ``build_system`` of the system's live spec,
    cost, models, tower and device would, sharing the index's structures
    and leaving the system's own state alone."""
    preset = ref_get_preset("hybrid_fusion")
    spec = dataclasses.replace(_online_spec(ref_spec), dense=preset.dense,
                               fusion=preset.fusion)
    spec = dataclasses.replace(spec, routing=dataclasses.replace(
        spec.routing, adapt_every=1))
    _, b = _pair(small_collection, port_collection, fitted, spec,
                 tower=ref_tower)
    ql = small_collection[2]
    spec0 = b.cascade_spec
    b.serve(ql.terms[:16], ql.mask[:16], ql.topic[:16])
    probe = online.fresh_probe(b)
    built = build_system(b.cascade_spec, b.index, corpus=b.corpus,
                         models=b.models, ltr=b.ltr, cost=b.cost,
                         tower=b._tower, device=b.device)
    assert probe.device == b.device and probe._tower is b._tower
    assert probe.shards is b.shards and probe.dense is b.dense
    assert probe.cascade_spec == b.cascade_spec != spec0
    assert probe.stats()["batches"] == 0
    traffic = port_spec.TrafficSpec(arrival="bursty", qps=400.0, seed=9)
    on = [s.serve_online(ql.terms, ql.mask, ql.topic, traffic=traffic)
          for s in (probe, built)]
    _assert_same_online(*on)
    assert probe.stats() == built.stats()
    assert b.stats()["batches"] == 1
    cap = online.estimate_capacity(online.fresh_probe(b), ql.terms, ql.mask,
                                   ql.topic)
    assert cap > 0 and b.stats()["batches"] == 1


def test_unported_nodes_raise_in_the_loop(small_collection, port_system):
    """The loop refuses a spec whose live-ingest or telemetry node is on
    (the cache and fault branches are served: ``test_cached_and_faulted
    _online_match_reference``)."""
    ql = small_collection[2]
    for node, item in (("ingest", "Live ingest"),
                       ("telemetry", "Telemetry")):
        system = port_system()
        spec = system.cascade_spec
        system.cascade_spec = dataclasses.replace(spec, **{
            node: dataclasses.replace(getattr(spec, node), enabled=True)})
        with pytest.raises(NotImplementedError,
                           match=rf"ROADMAP\.md, section 1: {item}\)"):
            system.serve_online(ql.terms, ql.mask, ql.topic,
                                traffic=port_spec.TrafficSpec())


@pytest.mark.parametrize("node", ["cache", "fault"])
def test_cached_and_faulted_online_match_reference(small_collection,
                                                   port_collection, fitted,
                                                   node):
    """The loop's cache branches (front door, dispatch peek, hit EWMA,
    ``stats["cache"]``) and its fault branch (``stats["faults"]``): the
    event log, arrays and stats equal the reference's."""
    kw = ({"cache": ref_spec.CacheSpec(enabled=True)} if node == "cache"
          else {"fault": ref_spec.FaultSpec(timeout_p=0.2, seed=3,
                                            crashes=((0, 1, 0.0, 60.0),)),
                "deploy": ref_spec.DeploySpec(n_shards=2, replicas=2)})
    spec = dataclasses.replace(_online_spec(ref_spec), **kw)
    if node == "fault":
        spec = dataclasses.replace(spec, routing=dataclasses.replace(
            spec.routing, failover_timeout=10.0, max_retries=2))
    a, b = _pair(small_collection, port_collection, fitted, spec)
    ra, rb = _serve_online_pair(a, b, small_collection[2],
                                dict(arrival="poisson", qps=300.0, seed=5,
                                     skew=1.2))
    assert rb.stats["over_budget"] == 0
    if node == "cache":
        assert rb.stats["cache"]["front_door_hits"] > 0
    else:
        assert rb.stats["faults"]["retries"] > 0
        assert b.faults.draws == a.faults.draws > 0


def test_online_flow_matches_reference_bench(monkeypatch, smoke):
    """``chip_smoke.online_flow`` on the CPU against the reference's own
    ``run_online`` (its artifact write stubbed out), figure for figure, at
    a reduced size (64 queries, one load: the defaults take about a minute
    in the reference)."""
    from benchmarks import bench_online
    monkeypatch.setattr(bench_online, "write_bench_artifact",
                        lambda name, payload: None)
    kw = dict(q_batch=64, n_docs=2048, loads=(0.8,))
    want = bench_online.run_online(**kw)
    got = smoke.online_flow("cpu", **kw)
    assert got == smoke.online_figures(want)
    assert got["guarantee_holds"] and got["regression_demonstrated"]
    assert got["parity"]["identical_topk"] and got["parity"]["checked"] == 64
