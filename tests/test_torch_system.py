"""The port's ``SearchSystem`` end to end against the reference.

One session-scoped reference fit on the fixture (pseudo-labels); its models
are converted with ``repro_torch.convert`` and the port is built from the
reference's spec JSON on ``device="cpu"`` (the kernels' plain versions).
The fixture's 96 queries are served in batches of 32 through both
packages, and ``topk``, ``final``, ``candidates_used`` and the modeled
``latency`` must be equal — for ``paper_200ms`` at 1 and 3 shards and for
``stage1_only``, ``throughput`` (no hedging, k_serve 64) and ``quality``
(k_serve 256, wider than a tile, t_final 20).  The reference serves on its ``"jnp"`` backend, which its
own tests hold to the Pallas kernels in interpret mode.

The dense modality: ``hybrid_fusion`` at 1 and 3 shards, with the same
fitted models and the reference's two-tower parameters carried across
(``convert.two_tower_params``), and the ``source="synthetic"`` system cases
of ``tests/test_dense.py`` (modality extremes, mixed dispatch under both
fusion rules, the θ_high Stage-2 skip, the θ_low lexical fallback, the
worst-case bound, one shard against three): ``topk``, ``final``,
``candidates_used``, ``latency``, the per-query dense vectors,
``stats["dense"]``, the stage budgets and ``worst_case_us`` must be equal.

The ``cached`` preset and ``fault_tolerant`` under two named fault
schedules serve equal to the reference, and so does a system with
telemetry on, whose snapshot equals the reference's.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from repro.configs.cascade_presets import PRESETS as REF_PRESETS
from repro.configs.cascade_presets import get_preset as ref_get_preset
from repro.configs.two_tower_retrieval import REDUCED as REF_REDUCED
from repro.dense import M_BOTH, M_DENSE, M_LEX
from repro.models import recsys as ref_recsys
from repro.serving.faults import fault_scenario as ref_fault_scenario
from repro.serving.spec import BackendSpec, DeploySpec, DenseSpec, FusionSpec
from repro.serving.system import build_system as ref_build_system
from repro_torch import convert
from repro_torch.configs.cascade_presets import PRESETS, get_preset
from repro_torch.index.builder import build_index
from repro_torch.index.corpus import CorpusParams, build_corpus
from repro_torch.serving.spec import CascadeSpec
from repro_torch.serving.system import build_system

BATCH = 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side, and
    torch's thread pool contending with them and with JAX's costs far more
    than it gains at these sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="session")
def fitted_reference(small_collection):
    corpus, index, ql = small_collection
    spec = dataclasses.replace(ref_get_preset("paper_200ms"),
                               backend=BackendSpec(backend="jnp"))
    ref = ref_build_system(spec, index, corpus=corpus)
    ref.fit(ql, None, seed=5)
    pcorpus = build_corpus(CorpusParams(n_docs=4096, vocab=2048,
                                        avg_doclen=80, zipf_a=1.05, seed=3))
    pindex = build_index(pcorpus, stop_k=8)
    models, ltr = convert.system_models(ref, "cpu")
    return corpus, index, ql, ref, pcorpus, pindex, models, ltr


def _pair(fitted, name, n_shards):
    """A reference system and the port built from the same spec: the preset
    ``name`` at the fitted routing thresholds, on ``n_shards`` shards."""
    corpus, index, ql, ref, pcorpus, pindex, models, ltr = fitted
    preset = ref_get_preset(name)
    spec = dataclasses.replace(
        ref.cascade_spec, name=name, stage2=preset.stage2,
        routing=dataclasses.replace(preset.routing,
                                    t_k=ref.cascade_spec.routing.t_k,
                                    t_time=ref.cascade_spec.routing.t_time),
        deploy=dataclasses.replace(ref.cascade_spec.deploy,
                                   n_shards=n_shards))
    with_ltr = spec.stage2.enabled
    a = ref_build_system(spec, index, corpus=corpus, models=ref.models,
                         ltr=ref.ltr if with_ltr else None)
    b = build_system(convert.cascade_spec(spec), pindex,
                     corpus=pcorpus, models=models,
                     ltr=ltr if with_ltr else None, device="cpu")
    return ql, a, b


@pytest.mark.parametrize("name,n_shards", [("paper_200ms", 1),
                                           ("stage1_only", 1),
                                           ("paper_200ms", 3),
                                           ("throughput", 1),
                                           ("quality", 1)])
def test_serve_matches_reference(fitted_reference, name, n_shards):
    ql, a, b = _pair(fitted_reference, name, n_shards)
    assert b.n_shards == n_shards and b.backend == "torch"
    for i in range(0, len(ql.terms), BATCH):
        sl = slice(i, i + BATCH)
        ra = a.serve(ql.terms[sl], ql.mask[sl], ql.topic[sl])
        rb = b.serve(ql.terms[sl], ql.mask[sl], ql.topic[sl])
        np.testing.assert_array_equal(rb.topk, ra.topk)
        np.testing.assert_array_equal(rb.latency, ra.latency)
        if name == "stage1_only":
            assert ra.final is None and rb.final is None
        else:
            np.testing.assert_array_equal(rb.final, ra.final)
            np.testing.assert_array_equal(rb.candidates_used,
                                          ra.candidates_used)
        for k in ("jass", "bmw", "hedged", "late_hedged", "over_budget",
                  "p50", "p99"):
            assert rb.stats[k] == ra.stats[k], k
    assert b.stats()["scheduler"] == a.stats()["scheduler"]
    assert b.stats()["scheduler"]["jass"] > 0
    assert b.stats()["scheduler"]["bmw"] > 0
    # online routing adaptation folds the same operating point back
    assert b.cascade_spec.to_json() == a.cascade_spec.to_json()


def test_spec_json_round_trips_between_packages():
    assert set(PRESETS) == set(REF_PRESETS)
    for name in REF_PRESETS:
        ref_json = ref_get_preset(name).to_json()
        spec = CascadeSpec.from_json(ref_json)
        assert spec == get_preset(name)
        assert spec.to_json() == ref_json
        assert json.loads(spec.to_json())["version"] == 1


def test_unported_nodes_raise(fitted_reference):
    """Telemetry is served: ``build_system`` with ``spec.telemetry`` on
    builds a registry, serves equal to the reference, and its snapshot
    equals the reference's as a dict and as JSON and Prometheus bytes."""
    from repro_torch.serving.telemetry.export import render_prometheus
    ql, a, b = _pair(fitted_reference, "paper_200ms", 1)
    spec = dataclasses.replace(a.cascade_spec, telemetry=dataclasses.replace(
        a.cascade_spec.telemetry, enabled=True))
    corpus, index, _, ref, pcorpus, pindex, models, ltr = fitted_reference
    a = ref_build_system(spec, index, corpus=corpus, models=ref.models,
                         ltr=ref.ltr)
    b = build_system(convert.cascade_spec(spec), pindex, corpus=pcorpus,
                     models=models, ltr=ltr, device="cpu")
    assert b.telemetry is not None
    rows = slice(0, 32)
    ra = a.serve(ql.terms[rows], ql.mask[rows], ql.topic[rows])
    rb = b.serve(ql.terms[rows], ql.mask[rows], ql.topic[rows])
    np.testing.assert_array_equal(rb.topk, ra.topk)
    np.testing.assert_array_equal(rb.final, ra.final)
    np.testing.assert_array_equal(rb.latency, ra.latency)
    sa, sb = a.snapshot(), b.snapshot()
    assert sb == sa and sb["counters"]["queries_served"] == 32
    assert b.render_snapshot("json") == a.render_snapshot("json")
    assert render_prometheus(sb) == a.render_snapshot("prom")


@pytest.mark.parametrize("name,scenario", [("cached", None),
                                           ("fault_tolerant",
                                            "timeout_storm"),
                                           ("fault_tolerant",
                                            "partition_outage")])
def test_cached_and_fault_tolerant_presets_match_reference(fitted_reference,
                                                           name, scenario):
    """The ``cached`` preset and ``fault_tolerant`` under a named schedule,
    at the fitted thresholds, served three times over the fixture's
    queries in batches of 32 on the serving clock: ``topk``, ``final``,
    latency, coverage, the batch stats, ``stats()`` and the injector's
    draws equal the reference's."""
    corpus, index, ql, ref, pcorpus, pindex, models, ltr = fitted_reference
    preset = ref_get_preset(name)
    spec = dataclasses.replace(
        preset, backend=BackendSpec(backend="jnp"),
        routing=dataclasses.replace(preset.routing,
                                    t_k=ref.cascade_spec.routing.t_k,
                                    t_time=ref.cascade_spec.routing.t_time))
    if scenario is not None:
        spec = dataclasses.replace(spec, fault=ref_fault_scenario(
            scenario, n_partitions=spec.deploy.n_shards,
            replicas=spec.deploy.replicas, horizon=40.0, seed=3))
    a = ref_build_system(spec, index, corpus=corpus, models=ref.models,
                         ltr=ref.ltr)
    b = build_system(convert.cascade_spec(spec), pindex, corpus=pcorpus,
                     models=models, ltr=ltr, device="cpu")
    assert (b.cache is not None) == (name == "cached")
    assert b.faults.active == (scenario is not None)
    for _ in range(3):
        for i in range(0, len(ql.terms), BATCH):
            sl = slice(i, i + BATCH)
            ra = a.serve(ql.terms[sl], ql.mask[sl], ql.topic[sl])
            rb = b.serve(ql.terms[sl], ql.mask[sl], ql.topic[sl])
            for key in ("topk", "final", "latency", "coverage"):
                u, v = getattr(ra, key), getattr(rb, key)
                assert (u is None) == (v is None), key
                if u is not None:
                    np.testing.assert_array_equal(v, u, err_msg=key)
            assert rb.stats == ra.stats
    sb = b.stats()
    assert sb.pop("device") == "cpu"
    assert sb == a.stats()
    assert b.faults.draws == a.faults.draws
    if name == "cached":
        assert b.cache.counters["l1_hits"] == 2 * len(ql.terms)
    else:
        assert sum(sb["faults"][k] for k in ("retries", "lost_partitions")) \
            > 0


def test_live_ingest_preset_matches_reference(fitted_reference):
    """The ``live_ingest`` preset at the fitted thresholds: batches of 32
    served between feed batches of 16 docs and one merge, ``topk``,
    ``final``, latency, the batch stats and ``stats()`` (its ingest
    section) equal the reference's; the worst case is the sealed bound plus
    the delta scan's capacity term, 266.2592."""
    from repro.index.corpus import slice_feed as ref_slice
    from repro.index.corpus import synthesize_feed_docs as ref_feed
    from repro_torch.index.corpus import slice_feed, synthesize_feed_docs
    corpus, index, ql, ref, pcorpus, pindex, models, ltr = fitted_reference
    preset = ref_get_preset("live_ingest")
    spec = dataclasses.replace(
        preset, backend=BackendSpec(backend="jnp"),
        routing=dataclasses.replace(preset.routing,
                                    t_k=ref.cascade_spec.routing.t_k,
                                    t_time=ref.cascade_spec.routing.t_time))
    a = ref_build_system(spec, index, corpus=corpus, models=ref.models,
                         ltr=ref.ltr)
    b = build_system(convert.cascade_spec(spec), pindex, corpus=pcorpus,
                     models=models, ltr=ltr, device="cpu")
    assert b.worst_case_us() == a.worst_case_us() == pytest.approx(
        266.2592, abs=1e-9)
    feed, pfeed = ref_feed(corpus, 64, seed=3), synthesize_feed_docs(
        pcorpus, 64, seed=3)
    for step, i in enumerate(range(0, len(ql.terms), BATCH)):
        if step == 2:
            assert b.merge() == a.merge() > 0
        lo = 16 * step
        took = b.add_documents(slice_feed(pfeed, lo, lo + 16))
        assert took == a.add_documents(ref_slice(feed, lo, lo + 16)) == 16
        sl = slice(i, i + BATCH)
        ra = a.serve(ql.terms[sl], ql.mask[sl], ql.topic[sl])
        rb = b.serve(ql.terms[sl], ql.mask[sl], ql.topic[sl])
        for key in ("topk", "final", "latency"):
            np.testing.assert_array_equal(getattr(rb, key), getattr(ra, key),
                                          err_msg=key)
        assert rb.stats == ra.stats
        assert (rb.topk >= b.delta.base_docs).any()
    sb = b.stats()
    assert sb.pop("device") == "cpu"
    assert sb == a.stats()
    assert sb["ingest"]["merges"] == 1 and sb["ingest"]["delta_docs"] == 16


def test_stats_and_worst_case_match_reference(fitted_reference):
    ql, a, b = _pair(fitted_reference, "paper_200ms", 1)
    assert b.worst_case_us() == a.worst_case_us()
    ra = a.serve(ql.terms[:BATCH], ql.mask[:BATCH], ql.topic[:BATCH])
    rb = b.serve(ql.terms[:BATCH], ql.mask[:BATCH], ql.topic[:BATCH])
    assert rb.stats["budget"] == ra.stats["budget"]
    assert rb.stats["stages"] == ra.stats["stages"]
    assert rb.stats["pool"] == ra.stats["pool"]
    sa, sb = a.stats(), b.stats()
    for k in ("spec", "n_shards", "shard_docs", "batches", "budget", "pool",
              "last_batch"):
        assert sb[k] == sa[k], k
    assert sb["device"] == "cpu"


# ---------------------------------------------------------------------------
# the dense modality
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_tower_params():
    """The reference's two-tower init (DenseSpec.seed 0) as NumPy arrays."""
    params, _ = ref_recsys.init(REF_REDUCED, jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


def _dense_pair(fitted, spec, ref_tower_params):
    """The reference system for ``spec`` (a reference spec) and the port
    built from its JSON, with the fitted models and the reference's tower
    carried across."""
    corpus, index, ql, ref, pcorpus, pindex, models, ltr = fitted
    a = ref_build_system(spec, index, corpus=corpus, models=ref.models,
                         ltr=ref.ltr)
    b = build_system(convert.cascade_spec(spec), pindex, corpus=pcorpus,
                     models=models, ltr=ltr,
                     tower=convert.two_tower_params(ref_tower_params, "cpu"),
                     device="cpu")
    return a, b


def _assert_same_batch(ra, rb):
    np.testing.assert_array_equal(rb.topk, ra.topk)
    np.testing.assert_array_equal(rb.final, ra.final)
    np.testing.assert_array_equal(rb.candidates_used, ra.candidates_used)
    np.testing.assert_array_equal(rb.latency, ra.latency)
    for key in ("modality", "theta_skip", "fallback"):
        np.testing.assert_array_equal(rb.dense[key], ra.dense[key])
    for key in ("dense", "stages", "budget", "pool", "jass", "bmw", "hedged",
                "late_hedged", "over_budget"):
        assert rb.stats[key] == ra.stats[key], key


def _hybrid_spec(fitted, n_shards):
    ref = fitted[3]
    preset = ref_get_preset("hybrid_fusion")
    return dataclasses.replace(
        ref.cascade_spec, name="hybrid_fusion", stage2=preset.stage2,
        routing=dataclasses.replace(preset.routing,
                                    t_k=ref.cascade_spec.routing.t_k,
                                    t_time=ref.cascade_spec.routing.t_time),
        deploy=dataclasses.replace(preset.deploy, n_shards=n_shards),
        dense=preset.dense, fusion=preset.fusion)


@pytest.mark.parametrize("n_shards", [1, 3])
def test_hybrid_fusion_matches_reference(fitted_reference, ref_tower_params,
                                         n_shards):
    ql = fitted_reference[2]
    a, b = _dense_pair(fitted_reference,
                       _hybrid_spec(fitted_reference, n_shards),
                       ref_tower_params)
    assert b.dense is not None and b.dense.n_shards == n_shards
    assert b.worst_case_us() == a.worst_case_us()
    assert b._budget_reserve == a._budget_reserve
    mix = np.zeros(3, np.int64)
    for i in range(0, len(ql.terms), BATCH):
        sl = slice(i, i + BATCH)
        ra = a.serve(ql.terms[sl], ql.mask[sl], ql.topic[sl])
        rb = b.serve(ql.terms[sl], ql.mask[sl], ql.topic[sl])
        _assert_same_batch(ra, rb)
        mix += np.bincount(rb.dense["modality"], minlength=3)
    # every modality carried traffic
    assert (mix > 0).all(), mix
    sa, sb = a.stats(), b.stats()
    for k in ("scheduler", "budget", "pool", "last_batch"):
        assert sb[k] == sa[k], k


def _dense_spec(fitted, dense, fusion=None, deploy=None):
    """The system spec of ``tests/test_dense.py`` (budget 100, k_serve 32,
    t_final 5) at the fitted routing thresholds."""
    from repro.serving.spec import (CascadeSpec, OnlineSpec, RoutingSpec,
                                    Stage2Spec)
    ref = fitted[3]
    return CascadeSpec(
        routing=RoutingSpec(budget=100.0, rho_max=1 << 14,
                            t_k=ref.cascade_spec.routing.t_k,
                            t_time=ref.cascade_spec.routing.t_time,
                            adapt_every=0),
        stage2=Stage2Spec(enabled=True, k_serve=32, t_final=5),
        backend=BackendSpec(backend="jnp"),
        deploy=deploy if deploy is not None else DeploySpec(),
        dense=dense, fusion=fusion if fusion is not None else FusionSpec(),
        online=OnlineSpec(max_batch=8, batch_deadline_us=4.0),
        name="dense_test")


def _serve_both(fitted, ref_tower_params, dense, **kw):
    ql = fitted[2]
    a, b = _dense_pair(fitted, _dense_spec(fitted, dense, **kw),
                       ref_tower_params)
    ra = a.serve(ql.terms, ql.mask, ql.topic)
    rb = b.serve(ql.terms, ql.mask, ql.topic)
    _assert_same_batch(ra, rb)
    assert b.worst_case_us() == a.worst_case_us()
    assert float(np.max(rb.latency)) <= b.worst_case_us() + 1e-9
    return b, rb


SYNTH = DenseSpec(enabled=True, source="synthetic")


def test_dense_modality_extremes_match_reference(fitted_reference,
                                                 ref_tower_params):
    q = len(fitted_reference[2].terms)
    _, r = _serve_both(fitted_reference, ref_tower_params,
                       dataclasses.replace(SYNTH, t_dense=1e9))
    assert r.stats["dense"]["lexical"] == q
    np.testing.assert_array_equal(r.dense["modality"], np.full(q, M_LEX))
    b, r = _serve_both(fitted_reference, ref_tower_params,
                       dataclasses.replace(SYNTH, t_dense=1e-6))
    assert r.stats["dense"]["dense_only"] == q
    ql = fitted_reference[2]
    ids, _ = b.dense.serve(b.dense.embed(ql.terms, ql.mask), b.k_serve)
    np.testing.assert_array_equal(r.topk, ids)


@pytest.mark.parametrize("method", ["rrf", "weighted"])
def test_dense_mixed_dispatch_matches_reference(fitted_reference,
                                                ref_tower_params, method):
    _, r = _serve_both(fitted_reference, ref_tower_params, SYNTH,
                       fusion=FusionSpec(method=method))
    d = r.stats["dense"]
    assert d["lexical"] + d["dense_only"] + d["fused"] == \
        len(fitted_reference[2].terms)
    assert d["fused"] > 0 and r.stats["over_budget"] == 0
    assert (r.dense["modality"] == M_BOTH).sum() == d["fused"]


def test_dense_theta_high_skip_matches_reference(fitted_reference,
                                                 ref_tower_params):
    _, r = _serve_both(fitted_reference, ref_tower_params,
                       dataclasses.replace(SYNTH, t_dense=1e-6,
                                           theta_high=-1.0))
    assert r.stats["dense"]["theta_skips"] == len(fitted_reference[2].terms)
    np.testing.assert_array_equal(r.final, r.topk[:, : r.final.shape[1]])


def test_dense_theta_low_fallback_matches_reference(fitted_reference,
                                                    ref_tower_params):
    b, r = _serve_both(fitted_reference, ref_tower_params,
                       dataclasses.replace(SYNTH, t_dense=1e-6,
                                           theta_low=10.0))
    ql = fitted_reference[2]
    assert r.stats["dense"]["fallbacks"] == len(ql.terms)
    assert (r.dense["modality"] == M_DENSE).all()
    d_ids, _ = b.dense.serve(b.dense.embed(ql.terms, ql.mask), b.k_serve)
    assert not np.array_equal(r.topk, d_ids)
    assert r.stats["over_budget"] == 0


def test_dense_worst_case_bound_matches_reference(fitted_reference,
                                                  ref_tower_params):
    fb_spec = dataclasses.replace(SYNTH, theta_low=0.1)
    pairs = [_dense_pair(fitted_reference,
                         _dense_spec(fitted_reference, d), ref_tower_params)
             for d in (DenseSpec(), SYNTH, fb_spec)]
    for a, b in pairs:
        assert b.worst_case_us() == a.worst_case_us()
        assert b._budget_reserve == a._budget_reserve
    (_, base), (_, dense), (_, with_fb) = pairs
    assert base.dense is None and "fusion" not in base._budget_reserve
    assert dense._budget_reserve["fusion"] == dense.cost.fusion_us
    assert with_fb.worst_case_us() == dense.worst_case_us()
    # once the dense route dominates, theta_low charges the fallback
    for a, b in pairs[1:]:
        a.dense.max_tiles = b.dense.max_tiles = lambda: 100_000
    for a, b in pairs[1:]:
        assert b.worst_case_us() == a.worst_case_us()
    assert with_fb.worst_case_us() > dense.worst_case_us()


def test_dense_multishard_matches_single_shard_and_reference(
        fitted_reference, ref_tower_params):
    _, r1 = _serve_both(fitted_reference, ref_tower_params, SYNTH)
    _, r3 = _serve_both(fitted_reference, ref_tower_params, SYNTH,
                        deploy=DeploySpec(n_shards=3, replicas=2))
    np.testing.assert_array_equal(r1.topk, r3.topk)
    np.testing.assert_array_equal(r1.final, r3.final)
