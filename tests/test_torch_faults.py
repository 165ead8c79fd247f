"""The port's fault injection and failover against the reference, on the
CPU.

``repro_torch.serving.faults`` and the faulted serve path of
``SearchSystem`` (``_fault_plan``'s retry chain, the health probes at the
top of ``_serve_direct``, ``stats()["faults"]``) are held to
``repro.serving.faults`` and the reference's ``SearchSystem`` at tolerance
0.0:

* ``FaultInjector`` (``is_up``, ``partition_up``, ``surviving``,
  ``slowdown`` over a grid of times, and the transient-draw stream with its
  ``draws`` counter) and every named ``fault_scenario``, against the
  reference's;
* the reference's own claims of ``tests/test_faults.py`` on the port
  (spec round trip and validation, windows and wildcards, the draw stream,
  the scenario registry, the retry budget in the bound, the partial rung);
* every system case of ``tests/test_faults.py`` on the fixture's
  4-partition x 3-replica deployment, on both packages: the empty
  schedule, a crash with failover, probe recovery, a partition outage
  (each query's list equal to the merge over the surviving shards), a
  transient storm, stragglers, and the online loop under an outage
  (``topk``, ``final``, latency, coverage, the batch stats, ``stats()``,
  ``faults.draws``, the event log as tuples of Python floats, every
  per-query array and the stats of ``serve_online``); each named scenario
  online on both;
* the dense modality under faults: at 2 shards equal to the reference;
  at 1 shard, where the reference's dense engine crashes on a lost
  partition (ROADMAP.md, section 3, open 3), held to the oracle;
* ``chip_smoke.fault_flow("cpu")`` against the reference's
  ``benchmarks/bench_faults.run_faults`` (its artifact write stubbed), at
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

from repro.serving import faults as ref_faults
from repro.serving import spec as ref_spec
from repro.serving.latency import CostModel as RefCostModel
from repro.serving.system import build_system as ref_build_system
from repro_torch import convert
from repro_torch.index.builder import build_index
from repro_torch.index.corpus import CorpusParams, build_corpus
from repro_torch.isn.backend import merge_shard_topk
from repro_torch.serving import faults
from repro_torch.serving import spec as port_spec
from repro_torch.serving.latency import CostModel
from repro_torch.serving.online import PARTIAL, SHED, AdmissionController
from repro_torch.serving.scheduler import SchedulerConfig
from repro_torch.serving.system import build_system

ROOT = pathlib.Path(__file__).resolve().parents[1]
INF = float("inf")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the injector and the scenarios
# ---------------------------------------------------------------------------

def _both(**kw):
    return ref_spec.FaultSpec(**kw), port_spec.FaultSpec(**kw)


def test_injector_matches_reference():
    want_spec, got_spec = _both(
        crashes=((0, 1, 10.0, 20.0), (1, -1, 0.0, 5.0), (2, 0, 30.0, INF)),
        stragglers=((0, -1, 0.0, 100.0, 2.0), (0, 0, 50.0, 100.0, 8.0),
                    (-1, 2, 40.0, 60.0, 3.0)),
        outages=((-1, 200.0, 210.0), (3, 80.0, 90.0)),
        timeout_p=0.3, timeout_start=15.0, timeout_end=95.0, seed=5)
    a = ref_faults.FaultInjector(want_spec, 4)
    b = faults.FaultInjector(got_spec, 4)
    assert b.active == a.active
    for now in np.r_[np.linspace(-1.0, 220.0, 443), 10.0, 20.0, 200.0]:
        now = float(now)
        assert b.surviving(3, now) == a.surviving(3, now)
        for p in range(4):
            assert b.partition_up(p, 3, now) == a.partition_up(p, 3, now)
            for r in range(3):
                assert b.is_up(p, r, now) == a.is_up(p, r, now)
                assert b.slowdown(p, r, now) == a.slowdown(p, r, now)
        for _ in range(3):
            assert b.transient(now) == a.transient(now)
    assert b.draws == a.draws > 0


@pytest.mark.parametrize("name", ref_faults.SCENARIOS)
def test_scenarios_match_reference(name):
    for kw in (dict(n_partitions=4, replicas=3, horizon=1000.0, seed=1),
               dict(n_partitions=1, replicas=2, horizon=37.5, seed=0),
               dict(n_partitions=3, replicas=1, horizon=1e4, seed=9)):
        want = ref_faults.fault_scenario(name, **kw)
        got = faults.fault_scenario(name, **kw)
        assert json.dumps(dataclasses.asdict(got)) \
            == json.dumps(dataclasses.asdict(want))
    assert faults.SCENARIOS == ref_faults.SCENARIOS


def test_fault_spec_json_round_trip():
    P = port_spec
    spec = P.CascadeSpec(
        routing=P.RoutingSpec(budget=100.0, rho_max=1 << 14,
                              failover_timeout=10.0, max_retries=2),
        deploy=P.DeploySpec(n_shards=2, replicas=2),
        fault=P.FaultSpec(crashes=((0, 1, 5.0, INF),),
                          stragglers=((1, -1, 0.0, 50.0, 4.0),),
                          outages=((1, 10.0, 20.0),),
                          timeout_p=0.05, timeout_start=1.0,
                          timeout_end=9.0, seed=3),
        name="faulty")
    again = P.CascadeSpec.from_json(spec.to_json())
    assert again == spec
    assert again.fault.crashes[0][3] == INF
    assert again.fault.active and again.fault.needs_failover
    assert not P.FaultSpec().active
    assert not P.FaultSpec(
        stragglers=((0, 0, 0.0, 1.0, 2.0),)).needs_failover


def test_fault_spec_validation():
    P = port_spec
    with pytest.raises(ValueError, match="inverted"):
        P.FaultSpec(crashes=((0, 0, 5.0, 1.0),)).validate()
    with pytest.raises(ValueError, match="slowdown"):
        P.FaultSpec(stragglers=((0, 0, 0.0, 1.0, 0.5),)).validate()
    with pytest.raises(ValueError, match="crash window needs"):
        P.FaultSpec(crashes=((0, 0.0, 1.0),)).validate()
    bad = P.CascadeSpec(routing=P.RoutingSpec(budget=100.0),
                        fault=P.FaultSpec(outages=((0, 0.0, 1.0),)))
    with pytest.raises(ValueError, match="failover"):
        bad.validate()
    with pytest.raises(ValueError):
        P.RoutingSpec(budget=100.0, failover_timeout=40.0,
                      max_retries=2).validate()
    with pytest.raises(ValueError):
        P.RoutingSpec(budget=100.0, max_retries=1).validate()


def test_injector_windows_and_wildcards():
    spec = port_spec.FaultSpec(
        crashes=((0, 1, 10.0, 20.0), (1, -1, 0.0, 5.0)),
        stragglers=((0, -1, 0.0, 100.0, 2.0), (0, 0, 50.0, 100.0, 8.0)),
        outages=((-1, 200.0, 210.0),))
    inj = faults.FaultInjector(spec, n_partitions=2)
    assert inj.is_up(0, 1, 9.9) and not inj.is_up(0, 1, 10.0)
    assert not inj.is_up(0, 1, 19.9) and inj.is_up(0, 1, 20.0)
    assert inj.is_up(0, 0, 15.0)
    assert not inj.is_up(1, 0, 2.0) and not inj.is_up(1, 1, 2.0)
    assert not inj.partition_up(1, 2, 2.0) and inj.partition_up(0, 2, 15.0)
    assert inj.surviving(2, 2.0) == 1 and inj.surviving(2, 30.0) == 2
    assert not inj.is_up(0, 0, 205.0)
    assert inj.surviving(2, 205.0) == 0
    assert inj.slowdown(0, 0, 60.0) == 8.0
    assert inj.slowdown(0, 1, 60.0) == 2.0
    assert inj.slowdown(0, 0, 150.0) == 1.0


def test_transient_draws_deterministic_and_windowed():
    spec = port_spec.FaultSpec(timeout_p=0.5, timeout_start=10.0,
                               timeout_end=20.0, seed=7)
    a, b = faults.FaultInjector(spec, 1), faults.FaultInjector(spec, 1)
    assert not a.transient(5.0) and a.draws == 0
    seq_a = [a.transient(15.0) for _ in range(64)]
    seq_b = [b.transient(15.0) for _ in range(64)]
    assert seq_a == seq_b and a.draws == 64
    assert any(seq_a) and not all(seq_a)


def test_scenario_builders_cover_registry():
    for name in faults.SCENARIOS:
        fs = faults.fault_scenario(name, n_partitions=4, replicas=3,
                                   horizon=1000.0, seed=1)
        fs.validate()
        assert fs.active == (name != "none")
    fs = faults.fault_scenario("partition_outage", n_partitions=4,
                               replicas=3, horizon=1000.0)
    inj = faults.FaultInjector(fs, 4)
    assert inj.surviving(3, 500.0) == 3 and inj.surviving(3, 100.0) == 4
    with pytest.raises(ValueError, match="unknown fault scenario"):
        faults.fault_scenario("meteor_strike", n_partitions=1, replicas=1,
                              horizon=1.0)


def test_retry_budget_charged_into_worst_case():
    cost = CostModel.paper_scale()
    base = SchedulerConfig(budget=100.0, rho_max=1 << 14, late_rho=8192,
                           hedge_deadline=0.6)
    hard = dataclasses.replace(base, failover_timeout=10.0, max_retries=2)
    assert hard.retry_us() == 20.0
    assert (hard.worst_case_us(cost, 1)
            == pytest.approx(base.worst_case_us(cost, 1) + 20.0))
    assert 0 < hard.max_late_rho(cost, 1) < base.max_late_rho(cost, 1)
    safe = dataclasses.replace(hard, late_rho=hard.max_late_rho(cost, 1))
    assert safe.worst_case_us(cost, 1) <= 100.0 + cost.predict_us + 1e-6


def test_partial_rung_trades_coverage_for_slack():
    cost = dataclasses.replace(CostModel.paper_scale(),
                               gather_per_shard_us=5.0)
    cfg = SchedulerConfig(budget=100.0, rho_max=1 << 14, late_rho=8192,
                          hedge_deadline=0.6)
    pb = [cfg.worst_case_us(cost, m) for m in range(1, 5)]
    assert pb[0] < pb[-1]
    online = port_spec.OnlineSpec(max_batch=8, admission=True, degrade=True)
    adm = AdmissionController(online, cost, pb[-1], None, 200.0,
                              partial_bounds=pb)
    waits = np.array([200.0 - online.dispatch_us - pb[3] - 1.0,
                      200.0 - online.dispatch_us - pb[1] - 1e-6,
                      200.0 - online.dispatch_us - pb[0] + 1.0])
    mode, cap, shard_cap = adm.at_dispatch(waits)
    assert mode.tolist() == [0, PARTIAL, SHED]
    assert shard_cap[0] == 4 and shard_cap[1] == 2
    assert adm.stats["partial"] == 1
    adm2 = AdmissionController(online, cost, pb[-1], None, 200.0,
                               partial_bounds=[pb[-1]] * 4)
    m2, _, sc2 = adm2.at_dispatch(waits[1:])
    assert sc2 is None and m2.tolist() == [SHED, SHED]


# ---------------------------------------------------------------------------
# end to end: tests/test_faults.py's 4-partition x 3-replica system
# ---------------------------------------------------------------------------

def _spec(fault=None, failover=15.0, retries=2, tk=150.0, tt=18.0,
          gather=0.0):
    """``tests/test_faults.py``'s ``_spec`` (reference spec nodes) and its
    cost model."""
    cost = dataclasses.replace(RefCostModel.paper_scale(),
                               gather_per_shard_us=gather)
    return ref_spec.CascadeSpec(
        routing=ref_spec.RoutingSpec(budget=100.0, rho_max=1 << 14, t_k=tk,
                                     t_time=tt, failover_timeout=failover,
                                     max_retries=retries),
        stage2=ref_spec.Stage2Spec(enabled=True, k_serve=64, t_final=10),
        backend=ref_spec.BackendSpec(backend="jnp"),
        deploy=ref_spec.DeploySpec(n_shards=4, replicas=3),
        online=ref_spec.OnlineSpec(max_batch=16, batch_deadline_us=5.0,
                                   admission=True, degrade=True),
        fault=fault if fault is not None else ref_spec.FaultSpec(),
        name="fault_test",
    ).validate(), cost


@pytest.fixture(scope="module")
def port_collection():
    corpus = build_corpus(CorpusParams(n_docs=4096, vocab=2048,
                                       avg_doclen=80, zipf_a=1.05, seed=3))
    return corpus, build_index(corpus, stop_k=8)


@pytest.fixture(scope="module")
def fitted4(small_collection):
    corpus, index, ql = small_collection
    spec, cost = _spec()
    spec = dataclasses.replace(spec, routing=dataclasses.replace(
        spec.routing, t_k=None, t_time=None, calibrate=True))
    ref = ref_build_system(spec, index, corpus=corpus, cost=cost)
    ref.fit(ql, None, seed=5)
    return ref, convert.system_models(ref, "cpu")


@pytest.fixture
def build4(small_collection, port_collection, fitted4):
    """``make(fault=..., **kw)`` -> (reference system, port system) of
    ``_spec`` with the fit's thresholds and models."""
    corpus, index, _ = small_collection
    pcorpus, pindex = port_collection
    ref, (models, ltr) = fitted4

    def make(fault=None, **kw):
        spec, cost = _spec(fault=fault, tk=ref._base_cfg.t_k,
                           tt=ref._base_cfg.t_time, **kw)
        a = ref_build_system(spec, index, corpus=corpus, models=ref.models,
                             ltr=ref.ltr, cost=cost)
        b = build_system(convert.cascade_spec(spec), pindex, corpus=pcorpus,
                         models=models, ltr=ltr,
                         cost=CostModel(**dataclasses.asdict(cost)),
                         device="cpu")
        return a, b
    return make


def _same_stats(a, b):
    sa, sb = a.stats(), b.stats()
    assert sb.pop("device") == "cpu"
    assert sb == sa
    assert b.faults.draws == a.faults.draws
    assert b._clock == a._clock


def _serve_pair(a, b, ql, **kw):
    ra = a.serve(ql.terms, ql.mask, ql.topic, **kw)
    rb = b.serve(ql.terms, ql.mask, ql.topic, **kw)
    for key in ("topk", "final", "candidates_used", "latency", "coverage"):
        u, v = getattr(ra, key), getattr(rb, key)
        if u is None:
            assert v is None, key
        else:
            assert v.dtype == u.dtype, key
            np.testing.assert_array_equal(v, u, err_msg=key)
    for key in ("stage0", "stage1", "stage2"):
        np.testing.assert_array_equal(rb.stage_latency[key],
                                      ra.stage_latency[key])
    assert rb.stats == ra.stats
    _same_stats(a, b)
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


def test_empty_fault_spec_is_bit_identical(small_collection, build4):
    ql = small_collection[2]
    armed_a, armed = build4()
    _, plain = build4(failover=0.0, retries=0)
    _, a = _serve_pair(armed_a, armed, ql)
    b = plain.serve(ql.terms, ql.mask, ql.topic)
    np.testing.assert_array_equal(a.topk, b.topk)
    np.testing.assert_array_equal(a.final, b.final)
    np.testing.assert_array_equal(a.latency, b.latency)
    assert a.coverage is None and armed.faults.draws == 0
    assert all(v == 0 for v in armed._fault_counters.values())
    assert "faults" not in a.stats and "faults" not in armed.stats()


def test_crash_failover_keeps_full_coverage(small_collection, build4):
    ql = small_collection[2]
    fa, sys_f = build4(fault=ref_spec.FaultSpec(crashes=((0, 2, 0.0, INF),)))
    _, res = _serve_pair(fa, sys_f, ql, now=1.0)
    ref = build4()[1].serve(ql.terms, ql.mask, ql.topic)
    assert res.coverage is not None and np.all(res.coverage == 1.0)
    np.testing.assert_array_equal(res.topk, ref.topk)
    c = res.stats["faults"]
    assert c["retries"] > 0 and c["lost_partitions"] == 0
    assert res.stats["over_budget"] == 0
    assert float(res.latency.max()) <= sys_f.worst_case_us() + 1e-6


def test_probe_recovery_after_crash_window(small_collection, build4):
    ql = small_collection[2]
    fa, sys_f = build4(
        fault=ref_spec.FaultSpec(crashes=((0, -1, 0.0, 50.0),)))
    _, mid = _serve_pair(fa, sys_f, ql, now=10.0)
    assert mid.coverage.min() < 1.0
    assert mid.stats["faults"]["lost_partitions"] > 0
    down = 12 - sys_f.pool.stats()["healthy"]
    assert down > 0
    _, after = _serve_pair(fa, sys_f, ql, now=60.0)
    assert sys_f.pool.stats()["healthy"] == 12
    assert after.stats["faults"]["recovered"] >= down
    assert np.all(after.coverage == 1.0)


def test_outage_partial_coverage_matches_surviving_oracle(small_collection,
                                                          build4):
    """Partition 3 fully out: every list equals the merge over ONLY the
    three surviving shards' lists (the port's own, captured in serving)."""
    ql = small_collection[2]
    fa, sys_f = build4(fault=ref_spec.FaultSpec(outages=((3, 0.0, INF),)))
    sys_f._debug_shard_lists = []
    _, res = _serve_pair(fa, sys_f, ql, now=1.0)
    assert np.all(res.coverage == 0.75)
    assert res.stats["coverage"]["degraded"] == len(ql.terms)
    assert res.stats["over_budget"] == 0
    checked = 0
    for rows, sc_list, id_list in sys_f._debug_shard_lists:
        oracle, _ = merge_shard_topk(
            [torch.from_numpy(a) for a in sc_list[:3]],
            [torch.from_numpy(a) for a in id_list[:3]], sys_f.k_serve)
        np.testing.assert_array_equal(res.topk[rows], oracle.numpy())
        checked += len(rows)
    assert checked == len(ql.terms)
    assert res.final is not None and np.all(res.final >= 0)


def test_transient_storm_bounded_and_deterministic(small_collection, build4):
    ql = small_collection[2]
    fault = ref_spec.FaultSpec(timeout_p=0.2, timeout_start=0.0, seed=11)
    fa, a = build4(fault=fault)
    _, ra = _serve_pair(fa, a, ql, now=1.0)
    assert ra.stats["faults"]["transient"] > 0
    assert float(ra.latency.max()) <= a.worst_case_us() + 1e-6
    assert ra.stats["over_budget"] == 0
    b = build4(fault=fault)[1]
    rb = b.serve(ql.terms, ql.mask, ql.topic, now=1.0)
    np.testing.assert_array_equal(ra.topk, rb.topk)
    np.testing.assert_array_equal(ra.latency, rb.latency)
    assert a.faults.draws == b.faults.draws > 0
    # a second batch inside the storm keeps drawing from the same stream,
    # with the pool's failure records carried over
    _serve_pair(fa, a, ql, now=30.0)


def test_straggler_slowdown_flows_into_latency(small_collection, build4):
    ql = small_collection[2]
    fa, sys_f = build4(
        fault=ref_spec.FaultSpec(stragglers=((-1, -1, 0.0, INF, 6.0),)))
    _, res = _serve_pair(fa, sys_f, ql, now=1.0)
    ref = build4()[1].serve(ql.terms, ql.mask, ql.topic)
    assert float(res.stage_latency["stage1"].mean()) > float(
        ref.stage_latency["stage1"].mean())
    assert np.all(res.coverage == 1.0)
    assert float(res.latency.max()) <= sys_f.worst_case_us() + 1e-6


def test_online_outage_zero_violations(small_collection, build4):
    ql = small_collection[2]
    kw = dict(arrival="poisson", qps=250.0, seed=3)
    fa, sys_f = build4(fault=ref_spec.FaultSpec(outages=((3, 40.0, 250.0),)),
                       gather=4.0)
    want = fa.serve_online(ql.terms, ql.mask, ql.topic,
                           traffic=ref_spec.TrafficSpec(**kw))
    res = sys_f.serve_online(ql.terms, ql.mask, ql.topic,
                             traffic=port_spec.TrafficSpec(**kw))
    _same_online(want, res)
    _same_stats(fa, sys_f)
    s = res.stats
    assert s["over_budget"] == 0
    assert s["coverage"]["degraded"] > 0
    served = res.mode != SHED
    assert np.all(res.coverage[served] >= 0.75 - 1e-9)
    a = build4(gather=4.0)[1].serve_online(
        ql.terms, ql.mask, ql.topic, traffic=port_spec.TrafficSpec(**kw))
    b = build4(gather=4.0)[1].serve_online(
        ql.terms, ql.mask, ql.topic, traffic=port_spec.TrafficSpec(**kw))
    assert a.event_log == b.event_log
    np.testing.assert_array_equal(a.topk, b.topk)


@pytest.mark.parametrize("name", [n for n in ref_faults.SCENARIOS
                                  if n != "none"])
def test_scenarios_online_match_reference(small_collection, build4, name):
    """Each named schedule over a bursty trace of the fixture's log:
    the event log, every array, the stats, the fault counters and the
    draws equal the reference's."""
    ql = small_collection[2]
    kw = dict(arrival="bursty", qps=300.0, seed=4)
    horizon = 1000.0 * len(ql.terms) / kw["qps"]
    fault = ref_faults.fault_scenario(name, n_partitions=4, replicas=3,
                                      horizon=horizon, seed=2)
    fa, fb = build4(fault=fault, gather=4.0)
    want = fa.serve_online(ql.terms, ql.mask, ql.topic,
                           traffic=ref_spec.TrafficSpec(**kw))
    got = fb.serve_online(ql.terms, ql.mask, ql.topic,
                          traffic=port_spec.TrafficSpec(**kw))
    _same_online(want, got)
    _same_stats(fa, fb)
    assert got.stats["over_budget"] == 0


def _hybrid_pair(small_collection, port_collection, fitted4, n_shards,
                 fault):
    """``_spec`` with the dense modality (synthetic embeddings) on
    ``n_shards`` x 2 replicas under ``fault``, on both packages."""
    corpus, index, _ = small_collection
    pcorpus, pindex = port_collection
    ref, (models, ltr) = fitted4
    spec, cost = _spec(fault=fault, tk=ref._base_cfg.t_k,
                       tt=ref._base_cfg.t_time)
    spec = dataclasses.replace(
        spec, deploy=ref_spec.DeploySpec(n_shards=n_shards, replicas=2),
        dense=ref_spec.DenseSpec(enabled=True, source="synthetic",
                                 theta_high=0.55)).validate()
    a = ref_build_system(spec, index, corpus=corpus, models=ref.models,
                         ltr=ref.ltr, cost=cost)
    b = build_system(convert.cascade_spec(spec), pindex, corpus=pcorpus,
                     models=models, ltr=ltr,
                     cost=CostModel(**dataclasses.asdict(cost)),
                     device="cpu")
    return a, b


def test_hybrid_fusion_faulted_matches_reference(small_collection,
                                                 port_collection, fitted4):
    """Dense and fused rows ride the failure protocol: a partition out and
    a transient storm at 2 shards, then healed, equal to the reference."""
    ql = small_collection[2]
    fault = ref_spec.FaultSpec(outages=((1, 0.0, 50.0),), timeout_p=0.2,
                               timeout_start=0.0, timeout_end=50.0, seed=4)
    a, b = _hybrid_pair(small_collection, port_collection, fitted4, 2,
                        fault)
    _, mid = _serve_pair(a, b, ql, now=10.0)
    assert (mid.coverage < 1.0).any() and mid.dense["modality"].max() > 0
    _, after = _serve_pair(a, b, ql, now=60.0)
    assert (after.coverage == 1.0).all()


def test_hybrid_fusion_one_shard_outage_holds_the_oracle(small_collection,
                                                         port_collection,
                                                         fitted4):
    """At 1 shard the reference's dense engine crashes on a lost partition
    (ROADMAP.md, section 3, open 3), so the port is held to the oracle:
    every query loses its one partition, keeps no candidate (ids -1) and
    serves an empty final list; once the outage ends it serves as a
    fault-free system does."""
    ql = small_collection[2]
    fault = ref_spec.FaultSpec(outages=((0, 0.0, 50.0),))
    a, b = _hybrid_pair(small_collection, port_collection, fitted4, 1,
                        fault)
    with pytest.raises(ValueError):
        a.serve(ql.terms, ql.mask, ql.topic, now=10.0)
    res = b.serve(ql.terms, ql.mask, ql.topic, now=10.0)
    assert (res.coverage == 0.0).all()
    assert (res.topk == -1).all() and (res.final == -1).all()
    assert (res.candidates_used == 0).all()
    assert res.stats["faults"]["lost_partitions"] == len(ql.terms)
    healed = b.serve(ql.terms, ql.mask, ql.topic, now=60.0)
    _, clean = _hybrid_pair(small_collection, port_collection, fitted4, 1,
                            ref_spec.FaultSpec())
    want = clean.serve(ql.terms, ql.mask, ql.topic)
    assert (healed.coverage == 1.0).all()
    np.testing.assert_array_equal(healed.topk, want.topk)
    np.testing.assert_array_equal(healed.final, want.final)


# ---------------------------------------------------------------------------
# the BENCH_faults flow
# ---------------------------------------------------------------------------

@pytest.fixture
def smoke(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke
    return chip_smoke


def test_fault_flow_matches_reference_bench(monkeypatch, smoke):
    """``chip_smoke.fault_flow`` on the CPU against the reference's own
    ``run_faults`` (its artifact write stubbed out), figure for figure, at
    a reduced size."""
    from benchmarks import bench_faults
    monkeypatch.setattr(bench_faults, "write_bench_artifact",
                        lambda name, payload: None)
    kw = dict(q_batch=64, n_docs=2048, loads=(0.8,))
    want = bench_faults.run_faults(**kw)
    got = smoke.fault_flow("cpu", **kw)
    assert got == smoke.fault_figures(want)
    for key in ("guarantee_holds", "coverage_certified",
                "inert_replay_identical", "inert_offline_identical",
                "faults_demonstrated"):
        assert got[key], key
