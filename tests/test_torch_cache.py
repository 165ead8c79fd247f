"""The port's result cache against the reference, on the CPU.

``repro_torch.serving.cache`` and the cached serve path of
``SearchSystem`` (``serve`` through ``_serve_cached``, ``cache_peek``, the
cache branches of ``serve_online``) are held to ``repro.serving.cache`` and
the reference's ``SearchSystem`` at tolerance 0.0:

* the LRU over seeded operation sequences (values, MRU order, bytes,
  stats after every operation), the key builders byte for byte, and the
  reference's own claims of ``tests/test_cache.py`` on the port's LRU,
  keys and ``CacheSpec``;
* every system case of ``tests/test_cache.py`` on both packages: hit and
  miss parity, L2 hits and promotion, ``cache_peek``, the inert spec,
  fault-epoch invalidation, the online front door and hit EWMA (``topk``,
  ``final``, latency, coverage, the batch stats, the cache counters and
  LRU contents, the event log as tuples of Python floats, every per-query
  array and the stats of ``serve_online``);
* ``tests/test_dense.py``'s cache cases (the modality route signature, L1
  replay of dense results), also with the reference's two-tower model
  carried across (``convert.two_tower_params``);
* ``fresh_probe`` of a cached system starts with an empty cache and leaves
  the original's alone;
* a shard built from a shared host layout (``postings.shard_layouts``)
  equals a fresh ``shard_from_index``, tensor for tensor;
* ``chip_smoke.cache_flow("cpu")`` against the reference's
  ``benchmarks/bench_cache.run_cache`` (its artifact write stubbed), at a
  reduced size.

The reference serves on its ``"jnp"`` backend, the port on the CPU (each
kernel wrapper's plain version).
"""

import dataclasses
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from repro.configs.two_tower_retrieval import REDUCED as REF_REDUCED
from repro.dense import M_BOTH, M_DENSE, M_LEX
from repro.models import recsys as ref_recsys
from repro.serving import cache as ref_cache
from repro.serving import spec as ref_spec
from repro.serving.system import build_system as ref_build_system
from repro_torch import convert
from repro_torch.index.builder import build_index
from repro_torch.index.corpus import CorpusParams, build_corpus
from repro_torch.index.postings import (shard_from_index, shard_layouts,
                                        shard_ranges)
from repro_torch.serving import cache
from repro_torch.serving import spec as port_spec
from repro_torch.serving.latency import CostModel
from repro_torch.serving.online import (FULL, AdmissionController,
                                        arrival_times, fresh_probe,
                                        zipf_query_mix)
from repro_torch.serving.system import build_system

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the LRU and the keys
# ---------------------------------------------------------------------------

def _lru_state(lru):
    return lru.keys_mru(), lru.nbytes, dict(lru.stats), len(lru)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_lru_sequences_match_reference(seed):
    """Seeded puts, gets and probes of array and tuple values under three
    epochs, entry and byte caps (values, MRU order, bytes, stats)."""
    rng = np.random.RandomState(seed)
    epochs = [ref_cache.HEALTHY_EPOCH, (True, False), (False, True, True)]
    for max_entries, max_bytes in ((5, 0), (8, 200), (0, 0), (3, 48)):
        a = ref_cache.LRUCache(max_entries, max_bytes)
        b = cache.LRUCache(max_entries, max_bytes)
        for _ in range(300):
            key = b"k%d" % rng.randint(12)
            epoch = epochs[rng.randint(3)]
            op = rng.randint(3)
            if op == 0:
                n = rng.randint(0, 12)
                value = (np.arange(n, dtype=np.int64), None, 7) \
                    if rng.rand() < 0.5 else np.zeros(n)
                a.put(key, value, epoch)
                b.put(key, value, epoch)
            elif op == 1:
                u, v = a.get(key, epoch), b.get(key, epoch)
                assert u is v or (u is None) == (v is None)
            else:
                assert b.contains(key, epoch) == a.contains(key, epoch)
            assert _lru_state(b) == _lru_state(a)


def test_keys_match_reference():
    rng = np.random.RandomState(4)
    for _ in range(50):
        n = rng.randint(1, 9)
        terms = rng.randint(0, 300, n)
        mask = rng.rand(n) * (rng.rand(n) < 0.8)
        topic = [None, float(rng.rand()), rng.rand(4)][rng.randint(3)]
        qk = cache.normalize_query(terms, mask, topic)
        assert qk == ref_cache.normalize_query(terms, mask, topic)
        args = (bool(rng.rand() < 0.5), float(rng.randint(1, 1 << 14)),
                float(rng.randint(1, 256)),
                [b"", b"|M0", b"|M2"][rng.randint(3)])
        rs = cache.route_sig(*args)
        assert rs == ref_cache.route_sig(*args)
        assert cache.l1_key(qk, rs, 32, 5, 16) \
            == ref_cache.l1_key(qk, rs, 32, 5, 16)
        assert cache.l2_key(qk, rs) == ref_cache.l2_key(qk, rs)
    for value in (np.zeros(3), (np.zeros(2), None, 5),
                  (np.arange(4), np.arange(2, dtype=np.int32), 1), 7):
        assert cache.entry_nbytes(value) == ref_cache.entry_nbytes(value)
    assert cache.HEALTHY_EPOCH == ref_cache.HEALTHY_EPOCH
    assert cache.ingest_epoch((True,), 3) == ref_cache.ingest_epoch(
        (True,), 3)


def test_lru_eviction_order():
    lru = cache.LRUCache(max_entries=3)
    for key in (b"a", b"b", b"c"):
        lru.put(key, key, cache.HEALTHY_EPOCH)
    assert lru.keys_mru() == [b"c", b"b", b"a"]
    assert lru.get(b"a", cache.HEALTHY_EPOCH) == b"a"
    lru.put(b"d", b"d", cache.HEALTHY_EPOCH)
    assert lru.keys_mru() == [b"d", b"a", b"c"]
    assert lru.get(b"b", cache.HEALTHY_EPOCH) is None
    assert lru.stats["evicted_entries"] == 1
    lru.put(b"d", b"D", cache.HEALTHY_EPOCH)
    assert len(lru) == 3 and lru.get(b"d", cache.HEALTHY_EPOCH) == b"D"


def test_lru_byte_cap():
    lru = cache.LRUCache(max_entries=10, max_bytes=64)
    lru.put(b"a", np.zeros(8), cache.HEALTHY_EPOCH)
    assert lru.nbytes == 64
    lru.put(b"b", np.zeros(4), cache.HEALTHY_EPOCH)
    assert lru.get(b"a", cache.HEALTHY_EPOCH) is None
    assert lru.nbytes == 32 and lru.stats["evicted_bytes"] == 64
    lru.put(b"huge", np.zeros(9), cache.HEALTHY_EPOCH)
    assert lru.get(b"huge", cache.HEALTHY_EPOCH) is None and lru.nbytes == 32
    assert cache.entry_nbytes((np.zeros(2), None, 5)) == 16 + 8


def test_lru_epoch_mismatch_drops_entry():
    lru = cache.LRUCache(max_entries=4)
    lru.put(b"k", 1, (True, True))
    assert lru.get(b"k", (False, True)) is None
    assert lru.stats["epoch_misses"] == 1 and len(lru) == 0
    lru.put(b"k", 2, (False, True))
    assert lru.get(b"k", (False, True)) == 2
    small = cache.LRUCache(max_entries=2)
    small.put(b"a", 1, cache.HEALTHY_EPOCH)
    small.put(b"b", 2, cache.HEALTHY_EPOCH)
    assert small.contains(b"a", cache.HEALTHY_EPOCH)
    assert not small.contains(b"a", (False,))
    assert small.keys_mru() == [b"b", b"a"]
    small.put(b"c", 3, cache.HEALTHY_EPOCH)
    assert small.get(b"a", cache.HEALTHY_EPOCH) is None


def test_key_normalization():
    t1, w1 = np.array([5, 2, 9, 0]), np.array([1.0, 2.0, 3.0, 0.0])
    t2, w2 = np.array([2, 9, 0, 5]), np.array([2.0, 3.0, 0.0, 1.0])
    assert cache.normalize_query(t1, w1, 0.5) \
        == cache.normalize_query(t2, w2, 0.5)
    assert cache.normalize_query(t1, w1, 0.5) \
        != cache.normalize_query(t1, w1, 0.6)
    w3 = np.array([1.0, 2.5, 3.0, 0.0])
    assert cache.normalize_query(t1, w1, None) \
        != cache.normalize_query(t1, w3, None)
    q = cache.normalize_query(t1, w1, None)
    rs = cache.route_sig(True, 4096.0, 64.0)
    assert cache.route_sig(False, 4096.0, 64.0) != rs
    assert cache.route_sig(True, 4096.0, 32.0) != rs
    assert cache.l1_key(q, rs, 32, 5, 32) != cache.l1_key(q, rs, 32, 5, 16)
    assert cache.l1_key(q, rs, 32, 5, 32) != cache.l2_key(q, rs)


def test_cache_spec_validation_and_round_trip():
    CacheSpec, CascadeSpec = port_spec.CacheSpec, port_spec.CascadeSpec
    assert not CacheSpec().active
    assert not CacheSpec(enabled=True, l1_entries=0, l2_entries=0).active
    assert CacheSpec(enabled=True).active
    spec = CascadeSpec(cache=CacheSpec(enabled=True, l1_entries=7,
                                       l2_bytes=123))
    assert CascadeSpec.from_json(spec.to_json()).cache == spec.cache
    import json
    d = json.loads(spec.to_json())
    d.pop("cache")
    assert CascadeSpec.from_dict(d).cache == CacheSpec()
    with pytest.raises(ValueError, match="l1_entries"):
        CacheSpec(l1_entries=-1).validate()
    with pytest.raises(ValueError, match="hit_alpha"):
        CacheSpec(hit_alpha=0.0).validate()
    with pytest.raises(ValueError, match="inactive"):
        cache.ServingCache(CacheSpec())
    sc = cache.ServingCache(CacheSpec(enabled=True, l2_entries=0))
    assert sc.l2 is None and sc.stats()["l2"] is None


def test_route_sig_modality_suffix():
    base = cache.route_sig(True, 4096.0, 64.0)
    assert cache.route_sig(True, 4096.0, 64.0, b"") == base
    tagged = {cache.route_sig(True, 4096.0, 64.0, b"|M%d" % m)
              for m in (M_LEX, M_DENSE, M_BOTH)}
    assert len(tagged) == 3 and base not in tagged


# ---------------------------------------------------------------------------
# system integration: tests/test_cache.py's spec on both packages
# ---------------------------------------------------------------------------

def _spec(mod, cache=None, deploy=None, fault=None, dense=None, **routing_kw):
    """``tests/test_cache.py``'s ``_spec``, in either package."""
    routing = {"budget": 100.0, "rho_max": 1 << 14, "t_k": 150.0,
               "t_time": 18.0, "adapt_every": 0}
    routing.update(routing_kw)
    return mod.CascadeSpec(
        routing=mod.RoutingSpec(**routing),
        stage2=mod.Stage2Spec(enabled=True, k_serve=32, t_final=5),
        backend=mod.BackendSpec(backend="jnp"),
        deploy=deploy if deploy is not None else mod.DeploySpec(),
        fault=fault if fault is not None else mod.FaultSpec(),
        cache=cache if cache is not None else mod.CacheSpec(),
        dense=dense if dense is not None else mod.DenseSpec(),
        online=mod.OnlineSpec(max_batch=8, batch_deadline_us=4.0),
        name="cache_test")


@pytest.fixture(scope="module")
def port_collection():
    corpus = build_corpus(CorpusParams(n_docs=4096, vocab=2048,
                                       avg_doclen=80, zipf_a=1.05, seed=3))
    return corpus, build_index(corpus, stop_k=8)


@pytest.fixture(scope="module")
def fitted(small_collection):
    """``tests/test_cache.py``'s fit (calibrated, pseudo-labels, seed 5)
    on the reference, its models converted for the port."""
    corpus, index, ql = small_collection
    spec = _spec(ref_spec)
    spec = dataclasses.replace(spec, routing=dataclasses.replace(
        spec.routing, t_k=None, t_time=None, calibrate=True))
    ref = ref_build_system(spec, index, corpus=corpus)
    ref.fit(ql, None, seed=5)
    return ref, convert.system_models(ref, "cpu")


@pytest.fixture(scope="module")
def ref_tower():
    params, _ = ref_recsys.init(REF_REDUCED, jax.random.PRNGKey(0))
    return convert.two_tower_params(jax.tree.map(np.asarray, params), "cpu")


@pytest.fixture
def pair(small_collection, port_collection, fitted):
    """``make(**kw)`` -> (reference system, port system) of ``_spec(**kw)``
    (reference spec nodes, converted for the port through the spec's JSON)
    with the fit's thresholds and models."""
    corpus, index, _ = small_collection
    pcorpus, pindex = port_collection
    ref, (models, ltr) = fitted

    def make(tower=None, **kw):
        spec = _spec(ref_spec, t_k=ref._base_cfg.t_k,
                     t_time=ref._base_cfg.t_time, **kw)
        a = ref_build_system(spec, index, corpus=corpus, models=ref.models,
                             ltr=ref.ltr)
        b = build_system(convert.cascade_spec(spec), pindex, corpus=pcorpus,
                         models=models, ltr=ltr, tower=tower, device="cpu")
        return a, b
    return make


def _same_result(ra, rb):
    for key in ("topk", "final", "candidates_used", "latency", "coverage"):
        u, v = getattr(ra, key), getattr(rb, key)
        if u is None:
            assert v is None, key
        else:
            assert v.dtype == u.dtype, key
            np.testing.assert_array_equal(v, u, err_msg=key)
    for key in ("stage0", "stage1", "stage2"):
        np.testing.assert_array_equal(rb.stage_latency[key],
                                      ra.stage_latency[key], err_msg=key)
    if ra.dense is not None:
        for key in ("modality", "theta_skip", "fallback"):
            np.testing.assert_array_equal(rb.dense[key], ra.dense[key])
    assert rb.stats == ra.stats


def _same_cache(a, b):
    """Counters, per-level contents (keys MRU-first, epochs, bytes, stats)
    and cached values."""
    ca, cb = a.cache, b.cache
    assert cb.stats() == ca.stats()
    for la, lb in ((ca.l1, cb.l1), (ca.l2, cb.l2)):
        if la is None:
            assert lb is None
            continue
        assert lb.keys_mru() == la.keys_mru()
        for key in la.keys_mru():
            na, nb = la._map[key], lb._map[key]
            assert nb.epoch == na.epoch and nb.nbytes == na.nbytes
            va = na.value if isinstance(na.value, tuple) else (na.value,)
            vb = nb.value if isinstance(nb.value, tuple) else (nb.value,)
            for u, v in zip(va, vb):
                assert type(v) is type(u)
                if isinstance(u, np.ndarray):
                    assert v.dtype == u.dtype
                    np.testing.assert_array_equal(v, u)
                else:
                    assert v == u


def _same_stats(a, b):
    sa, sb = a.stats(), b.stats()
    assert sb.pop("device") == "cpu"
    assert sb == sa


def _serve_pair(a, b, ql, rows=slice(None), **kw):
    ra = a.serve(ql.terms[rows], ql.mask[rows], ql.topic[rows], **kw)
    rb = b.serve(ql.terms[rows], ql.mask[rows], ql.topic[rows], **kw)
    _same_result(ra, rb)
    return ra, rb


def _same_online(ra, rb):
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


def test_hit_and_miss_bit_parity(small_collection, pair):
    """Cold cache-on == cache-off bit for bit (misses pay the probe in
    modeled time only); warm L1 hits are bit-identical at predict +
    probe; the probe is charged into the worst case."""
    ql = small_collection[2]
    off_a, off_b = pair()
    on_a, on_b = pair(cache=ref_spec.CacheSpec(enabled=True))
    r_off, r_off_b = _serve_pair(off_a, off_b, ql)
    cold, cold_b = _serve_pair(on_a, on_b, ql)
    _same_cache(on_a, on_b)
    np.testing.assert_array_equal(cold_b.topk, r_off_b.topk)
    np.testing.assert_array_equal(cold_b.final, r_off_b.final)
    # the probe lands inside the stage-1 term, so the sums round apart
    np.testing.assert_allclose(cold_b.latency,
                               r_off_b.latency + on_b.cost.cache_hit_us)
    np.testing.assert_array_equal(
        cold_b.stage_latency["stage1"],
        r_off_b.stage_latency["stage1"] + on_b.cost.cache_hit_us)
    assert on_b.cache.counters["l1_hits"] == 0
    warm, warm_b = _serve_pair(on_a, on_b, ql)
    _same_cache(on_a, on_b)
    np.testing.assert_array_equal(warm_b.topk, r_off_b.topk)
    np.testing.assert_array_equal(warm_b.final, r_off_b.final)
    assert on_b.cache.counters["l1_hits"] == len(ql.terms)
    np.testing.assert_array_equal(
        warm_b.latency, on_b.cost.predict_us + on_b.cost.cache_hit_us)
    assert on_b.worst_case_us() == on_a.worst_case_us() == pytest.approx(
        off_b.worst_case_us() + on_b.cost.cache_hit_us)
    _same_stats(on_a, on_b)


def test_l2_hit_skips_retrieval_and_promotes(small_collection, pair):
    ql = small_collection[2]
    q = len(ql.terms)
    a, b = pair(cache=ref_spec.CacheSpec(enabled=True))
    cold, _ = _serve_pair(a, b, ql)
    cap = np.full(q, 16, np.int64)
    _, r2 = _serve_pair(a, b, ql, stage2_cap=cap)
    assert b.cache.counters["l2_hits"] == q
    assert b.cache.counters["l1_hits"] == 0
    np.testing.assert_array_equal(r2.topk, cold.topk)
    _, r3 = _serve_pair(a, b, ql, stage2_cap=cap)
    assert b.cache.counters["l1_hits"] == q
    np.testing.assert_array_equal(r3.final, r2.final)
    # a mixed batch: L1 hits, L2 hits and misses side by side, some rows
    # trimmed further and some at stage1-only
    cap = np.where(np.arange(q) % 3 == 0, 16,
                   np.where(np.arange(q) % 3 == 1, 8, 0))
    _serve_pair(a, b, ql, rows=slice(0, 48), stage2_cap=cap[:48])
    _same_cache(a, b)
    _same_stats(a, b)


def test_cache_peek_is_side_effect_free(small_collection, pair):
    ql = small_collection[2]
    a, b = pair(cache=ref_spec.CacheSpec(enabled=True))
    assert not b.cache_peek(ql.terms, ql.mask, ql.topic).any()
    _serve_pair(a, b, ql, rows=slice(0, 64))
    before = dict(b.cache.counters)
    mru = b.cache.l1.keys_mru()
    sched = dict(b.sched.stats)
    want = a.cache_peek(ql.terms, ql.mask, ql.topic)
    got = b.cache_peek(ql.terms, ql.mask, ql.topic)
    np.testing.assert_array_equal(got, want)
    assert got[:64].all() and not got[64:].any()
    assert b.cache.counters == before
    assert b.cache.l1.keys_mru() == mru
    assert b.sched.stats == sched
    _same_cache(a, b)
    assert not pair()[1].cache_peek(ql.terms, ql.mask, ql.topic).any()


def test_inert_cache_spec_is_bit_identical(small_collection, pair):
    ql = small_collection[2]
    inert = ref_spec.CacheSpec(enabled=True, l1_entries=0, l2_entries=0)
    _, sys_a = pair()
    ref_b, sys_b = pair(cache=inert)
    assert sys_b.cache is None and ref_b.cache is None
    ra = sys_a.serve(ql.terms, ql.mask, ql.topic)
    _, rb = _serve_pair(ref_b, sys_b, ql)
    np.testing.assert_array_equal(ra.topk, rb.topk)
    np.testing.assert_array_equal(ra.final, rb.final)
    np.testing.assert_array_equal(ra.latency, rb.latency)
    assert sys_a.faults.draws == 0 and sys_b.faults.draws == 0
    assert sys_a.worst_case_us() == sys_b.worst_case_us()
    kw = dict(arrival="bursty", qps=150.0, skew=0.8, seed=3)
    oa = pair()[1].serve_online(ql.terms, ql.mask, ql.topic,
                                traffic=port_spec.TrafficSpec(**kw))
    a, b = pair(cache=inert)
    want = a.serve_online(ql.terms, ql.mask, ql.topic,
                          traffic=ref_spec.TrafficSpec(**kw))
    ob = b.serve_online(ql.terms, ql.mask, ql.topic,
                        traffic=port_spec.TrafficSpec(**kw))
    _same_online(want, ob)
    assert oa.event_log == ob.event_log


def test_fault_epoch_invalidation(small_collection, pair):
    """Entries filled in one fault epoch never serve in another, and
    partial-coverage results are never admitted."""
    ql = small_collection[2]
    q = 16
    rows = slice(0, q)
    a, b = pair(cache=ref_spec.CacheSpec(enabled=True),
                deploy=ref_spec.DeploySpec(n_shards=2, replicas=2),
                fault=ref_spec.FaultSpec(crashes=((0, -1, 0.0, 50.0),)),
                failover_timeout=15.0, max_retries=2)
    r_h, _ = _serve_pair(a, b, ql, rows, now=60.0)
    assert b.cache.l1.stats["fills"] == q
    _, r_f = _serve_pair(a, b, ql, rows, now=10.0)
    assert np.all(r_f.coverage < 1.0)
    assert b.cache.counters["l1_hits"] == 0
    assert b.cache.l1.stats["epoch_misses"] == q
    assert b.cache.counters["skipped_partial"] == q
    _serve_pair(a, b, ql, rows, now=10.0)
    assert b.cache.counters["l1_hits"] == 0
    assert b.cache.counters["skipped_partial"] == 2 * q
    _, r_h2 = _serve_pair(a, b, ql, rows, now=70.0)
    assert b.cache.counters["l1_hits"] == 0
    np.testing.assert_array_equal(r_h2.topk, r_h.topk)
    _, r_h3 = _serve_pair(a, b, ql, rows, now=80.0)
    assert b.cache.counters["l1_hits"] == q
    np.testing.assert_array_equal(r_h3.topk, r_h.topk)
    _same_cache(a, b)
    _same_stats(a, b)
    assert b.faults.draws == a.faults.draws


def test_online_front_door_and_hit_ewma(small_collection, pair):
    ql = small_collection[2]
    kw = dict(arrival="poisson", qps=200.0, skew=1.2, seed=3)
    a, b = pair(cache=ref_spec.CacheSpec(enabled=True))
    want = a.serve_online(ql.terms, ql.mask, ql.topic,
                          traffic=ref_spec.TrafficSpec(**kw))
    r = b.serve_online(ql.terms, ql.mask, ql.topic,
                       traffic=port_spec.TrafficSpec(**kw))
    _same_online(want, r)
    _same_cache(a, b)
    _same_stats(a, b)
    s = r.stats
    assert s["over_budget"] == 0 and s["shed"] == 0
    c = s["cache"]
    assert c["front_door_hits"] > 0 and c["hit_ewma"] > 0.0
    front = np.flatnonzero(r.batch_of == -2)
    assert len(front) == c["front_door_hits"]
    assert np.all(r.wait[front] == 0.0)
    assert np.all(r.mode[front] == FULL)
    np.testing.assert_array_equal(
        r.service[front], b.cost.predict_us + b.cost.cache_hit_us)
    r2 = pair(cache=ref_spec.CacheSpec(enabled=True))[1].serve_online(
        ql.terms, ql.mask, ql.topic, traffic=port_spec.TrafficSpec(**kw))
    assert r.event_log == r2.event_log


@pytest.mark.parametrize("cache_kw,traffic_kw", [
    (dict(l1_entries=6, l2_entries=40),
     dict(arrival="bursty", qps=400.0, skew=1.0, seed=5)),
    (dict(l1_bytes=1500, l2_bytes=2000),
     dict(arrival="poisson", qps=250.0, skew=0.8, seed=2)),
    (dict(l2_entries=0), dict(arrival="poisson", qps=900.0, skew=1.4,
                              seed=7))],
    ids=["small_entries", "byte_caps", "l1_only_overload"])
def test_bounded_cache_online_matches_reference(small_collection, pair,
                                                cache_kw, traffic_kw):
    """Eviction under entry and byte caps and an L1-only cache under
    overload: the event log, arrays, stats and cache contents equal."""
    ql = small_collection[2]
    a, b = pair(cache=ref_spec.CacheSpec(enabled=True, **cache_kw))
    want = a.serve_online(ql.terms, ql.mask, ql.topic,
                          traffic=ref_spec.TrafficSpec(**traffic_kw))
    got = b.serve_online(ql.terms, ql.mask, ql.topic,
                         traffic=port_spec.TrafficSpec(**traffic_kw))
    _same_online(want, got)
    _same_cache(a, b)
    c = got.stats["cache"]
    evicted = sum(c[level]["evicted_entries"] for level in ("l1", "l2")
                  if c[level] is not None)
    assert evicted > 0 or cache_kw.get("l2_entries") == 0


def test_admission_adapts_to_hit_ratio_step_change():
    cost = CostModel.paper_scale()
    cfg = port_spec.OnlineSpec(max_batch=4, dispatch_us=1.0)
    adm = AdmissionController(cfg, cost, stage1_bound=100.0, k_serve=None,
                              response_budget=150.0, cache_bound=2.0,
                              hit_alpha=0.2)
    assert not adm.at_arrival(arrival=0.0, server_free=60.0, queue_depth=0)
    for _ in range(20):
        adm.observe_hits(1, 1)
    assert adm.hit_ewma > 0.95
    assert adm.at_arrival(arrival=0.0, server_free=60.0, queue_depth=0)
    for _ in range(20):
        adm.observe_hits(0, 4)
    assert adm.hit_ewma < 0.05
    assert not adm.at_arrival(arrival=0.0, server_free=60.0, queue_depth=0)
    adm.observe_hits(0, 0)
    assert adm.hit_ewma < 0.05
    adm2 = AdmissionController(cfg, cost, stage1_bound=100.0, k_serve=64,
                               response_budget=200.0, cache_bound=2.0)
    mode, cap, _ = adm2.at_dispatch(np.array([150.0, 150.0]),
                                    hits=np.array([True, False]))
    assert mode[0] == FULL and mode[1] != FULL
    assert cap[0] == 64
    assert adm2.stats["cache_admitted"] == 1


def test_zipf_query_mix():
    spec = port_spec.TrafficSpec(qps=100.0, skew=1.2, seed=9)
    mix = zipf_query_mix(spec, 2000, n_unique=100)
    np.testing.assert_array_equal(mix,
                                  zipf_query_mix(spec, 2000, n_unique=100))
    assert mix.min() >= 0 and mix.max() < 100
    counts = np.bincount(mix, minlength=100)
    assert counts[0] > counts[99] and counts[0] > 2000 // 100
    flat = zipf_query_mix(port_spec.TrafficSpec(qps=100.0, skew=0.0), 7,
                          n_unique=3)
    np.testing.assert_array_equal(flat, [0, 1, 2, 0, 1, 2, 0])
    base = port_spec.TrafficSpec(arrival="poisson", qps=100.0, seed=4)
    np.testing.assert_array_equal(
        arrival_times(base, 500),
        arrival_times(dataclasses.replace(base, skew=1.2), 500))


# ---------------------------------------------------------------------------
# tests/test_dense.py's cache cases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("source", ["synthetic", "two_tower"])
def test_cache_replays_dense_results_bitwise(small_collection, pair,
                                             ref_tower, source):
    """L1 replay of dense, fused and θ-skipped rows, and an L2 hit that
    replays the fill-time θ-skip, equal to the reference's."""
    ql = small_collection[2]
    dense = ref_spec.DenseSpec(enabled=True, source=source, theta_high=0.55)
    a, b = pair(dense=dense, cache=ref_spec.CacheSpec(enabled=True),
                tower=ref_tower if source == "two_tower" else None)
    r1, _ = _serve_pair(a, b, ql)
    _, r2 = _serve_pair(a, b, ql)
    assert b.cache.counters["l1_hits"] == len(ql.terms)
    np.testing.assert_array_equal(r1.topk, r2.topk)
    np.testing.assert_array_equal(r1.final, r2.final)
    # the reference's own claim compares the dense flags of two of its
    # serves; the port's second serve equals the reference's
    _serve_pair(a, b, ql, stage2_cap=np.full(len(ql.terms), 16, np.int64))
    assert b.cache.counters["l2_hits"] == len(ql.terms)
    _same_cache(a, b)
    _same_stats(a, b)


# ---------------------------------------------------------------------------
# fresh_probe and the shared host layout
# ---------------------------------------------------------------------------

def test_fresh_probe_leaves_the_cache_alone(small_collection, pair):
    """A probe of a cached (and faulted) system gets an empty cache and a
    fresh injector; serving it changes nothing of the original's."""
    ql = small_collection[2]
    _, b = pair(cache=ref_spec.CacheSpec(enabled=True),
                deploy=ref_spec.DeploySpec(n_shards=2, replicas=2),
                fault=ref_spec.FaultSpec(timeout_p=0.3, seed=4),
                failover_timeout=15.0, max_retries=2)
    b.serve(ql.terms[:32], ql.mask[:32], ql.topic[:32], now=1.0)
    stats, mru = b.cache.stats(), b.cache.l1.keys_mru()
    draws, faults = b.faults.draws, dict(b._fault_counters)
    probe = fresh_probe(b)
    assert probe.cache is not b.cache and probe.faults is not b.faults
    assert len(probe.cache.l1) == 0 and probe.faults.draws == 0
    probe.serve(ql.terms, ql.mask, ql.topic, now=1.0)
    probe.serve(ql.terms, ql.mask, ql.topic, now=2.0)
    assert probe.cache.counters["l1_hits"] > 0 and probe.faults.draws > 0
    assert b.cache.stats() == stats and b.cache.l1.keys_mru() == mru
    assert b.faults.draws == draws and b._fault_counters == faults


@pytest.mark.parametrize("n_shards", [1, 3])
def test_shared_layout_equals_fresh_shards(port_collection, n_shards):
    """Shards copied from shared host layouts equal ``shard_from_index``'s,
    every tensor of every shard; a system built from them serves the
    same; layouts of other shards are refused."""
    _, pindex = port_collection
    layouts = shard_layouts(pindex, n_shards, tile_d=128)
    for lay, (lo, hi) in zip(layouts, shard_ranges(pindex.n_docs,
                                                   n_shards)):
        fresh, spec = shard_from_index(pindex, lo, hi, tile_d=128,
                                       device="cpu")
        assert lay.spec == spec
        for name in fresh._fields:
            u, v = getattr(fresh, name), torch.from_numpy(
                getattr(lay.arrays, name))
            assert v.dtype == u.dtype and torch.equal(v, u), name
    spec = port_spec.CascadeSpec(deploy=port_spec.DeploySpec(
        n_shards=n_shards))
    a = build_system(spec, pindex, device="cpu")
    b = build_system(spec, pindex, device="cpu", layouts=layouts)
    for sa, sb in zip(a.shards, b.shards):
        for name in sa._fields:
            assert torch.equal(getattr(sa, name), getattr(sb, name)), name
    assert a.shard_specs == b.shard_specs
    for u, v in zip(a._level_cum_host, b._level_cum_host):
        np.testing.assert_array_equal(u, v)
    other = shard_layouts(pindex, n_shards + 1, tile_d=128)
    with pytest.raises(ValueError, match="layouts"):
        build_system(spec, pindex, device="cpu", layouts=other)


# ---------------------------------------------------------------------------
# the BENCH_cache flow
# ---------------------------------------------------------------------------

@pytest.fixture
def smoke(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke
    return chip_smoke


def test_cache_flow_matches_reference_bench(monkeypatch, smoke):
    """``chip_smoke.cache_flow`` on the CPU against the reference's own
    ``run_cache`` (its artifact write stubbed out), figure for figure, at a
    reduced size."""
    from benchmarks import bench_cache
    monkeypatch.setattr(bench_cache, "write_bench_artifact",
                        lambda name, payload: None)
    kw = dict(q_batch=96, n_docs=2048, skews=(0.0, 1.2),
              loads_off=(0.8, 1.5), loads_on=(1.5, 3.0))
    want = bench_cache.run_cache(**kw)
    got = smoke.cache_flow("cpu", **kw)
    assert got == smoke.cache_figures(want)
    assert got["gates"]["hits_bit_identical"]
    assert got["gates"]["inert_bit_identical"]
    assert got["gates"]["guarantee_holds"]
