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
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.cascade_presets import PRESETS as REF_PRESETS
from repro.configs.cascade_presets import get_preset as ref_get_preset
from repro.serving.spec import BackendSpec
from repro.serving.system import build_system as ref_build_system
from repro_torch import convert
from repro_torch.configs.cascade_presets import PRESETS, get_preset
from repro_torch.index.builder import build_index
from repro_torch.index.corpus import CorpusParams, build_corpus
from repro_torch.serving.spec import CascadeSpec, FaultSpec
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
    corpus, index, ql, ref, pcorpus, pindex, models, ltr = fitted_reference
    spec = CascadeSpec.from_json(ref.cascade_spec.to_json())
    for preset in ("cached", "live_ingest", "hybrid_fusion"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            build_system(get_preset(preset), pindex, corpus=pcorpus,
                         device="cpu")
    faulty = dataclasses.replace(get_preset("fault_tolerant"),
                                 fault=FaultSpec(crashes=((0, 0, 0.0, 50.0),)))
    with pytest.raises(NotImplementedError, match="Fault"):
        build_system(faulty, pindex, corpus=pcorpus, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_system(dataclasses.replace(spec, telemetry=dataclasses.replace(
            spec.telemetry, enabled=True)), pindex, corpus=pcorpus,
            device="cpu")
    system = build_system(spec, pindex, corpus=pcorpus, models=models,
                          ltr=ltr, device="cpu")
    with pytest.raises(NotImplementedError, match="Training"):
        system.fit(ql)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        system.serve_online(ql.terms, ql.mask, ql.topic, traffic=None)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        system.serve(ql.terms[:4], ql.mask[:4], ql.topic[:4],
                     shard_cap=np.ones(4, np.int64))


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
