"""The port's compatibility shims and per-query Stage-2 loop against the
reference.

``serving.pipeline.CascadePipeline`` and ``serving.server.HybridServer``
(the historical keyword surface over a one-shard ``SearchSystem``) and
``ltr.cascade.rerank_loop`` (the one-query-at-a-time parity oracle of the
batched Stage-2) are held to the reference's on the ``small_collection``
fixture, the port taking the reference's fitted models through
``repro_torch.convert`` and running on the CPU (the kernels' plain
versions).  The cases are those of ``tests/test_cascade_pipeline.py``
(Stage-0 per model, the pipeline against ``HybridServer``, the full
cascade against the loop, the Stage-2 budget reservation),
``tests/test_search_system.py``'s compat-shim case and the budget
guarantee of ``tests/test_system.py``: ``topk``, ``final``,
``candidates_used``, the modeled ``latency`` and the routing stats must
equal the reference's.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core import features as ref_features
from repro.core import gbrt as ref_gbrt
from repro.core.labels import LabelConfig, generate_labels
from repro.ltr import cascade as ref_cascade
from repro.ltr import ranker as ref_ranker
from repro.serving.latency import CostModel as RefCostModel
from repro.serving.pipeline import CascadePipeline as RefCascadePipeline
from repro.serving.scheduler import SchedulerConfig as RefSchedulerConfig
from repro.serving.server import HybridServer as RefHybridServer
from repro.serving.spec import (BackendSpec, CascadeSpec, DeploySpec,
                                RoutingSpec, Stage2Spec)
from repro.serving.system import build_system as ref_build_system
from repro_torch import convert
from repro_torch.index.builder import build_index
from repro_torch.index.corpus import CorpusParams, build_corpus
from repro_torch.isn.backend import query_lane_budget
from repro_torch.ltr import cascade
from repro_torch.ltr.ranker import stage2_arrays
from repro_torch.serving.latency import CostModel
from repro_torch.serving.pipeline import CascadePipeline
from repro_torch.serving.scheduler import SchedulerConfig
from repro_torch.serving.server import HybridServer
from repro_torch.serving.system import SearchSystem, build_system

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port_collection():
    """The fixture's corpus and index built by the port's own index code."""
    corpus = build_corpus(CorpusParams(n_docs=4096, vocab=2048,
                                       avg_doclen=80, zipf_a=1.05, seed=3))
    return corpus, build_index(corpus, stop_k=8)


@pytest.fixture(scope="module")
def stage0_models(small_collection):
    """``tests/test_cascade_pipeline.py``'s pseudo-label Stage-0 GBRTs
    (reference fits) and the port's copies."""
    corpus, index, ql = small_collection
    x = np.asarray(ref_features.extract(
        jnp.asarray(index.term_stats), jnp.asarray(index.df),
        jnp.asarray(ql.terms), jnp.asarray(ql.mask)))
    rng = np.random.RandomState(5)
    base = (index.df[ql.terms] * (ql.mask > 0)).sum(axis=1).astype(
        np.float64)
    models = {}
    for name, scale, tau in (("k", 0.05, 0.55), ("rho", 0.5, 0.45),
                             ("t", 0.002, 0.5)):
        y = base * scale * np.exp(rng.randn(len(base)) * 0.3)
        models[name] = ref_gbrt.fit(x, np.log1p(y.astype(np.float32)),
                                    ref_gbrt.GBRTParams(n_trees=24, depth=4,
                                                        loss="quantile",
                                                        tau=tau))
    # routing thresholds at the predictions' 60th / 75th percentiles (the
    # calibration SearchSystem.fit makes), so both routes take queries
    pk, pt = (np.expm1(np.asarray(ref_gbrt.predict(models[n], x)))
              for n in ("k", "t"))
    routing = dict(t_k=float(np.percentile(pk, 60)),
                   t_time=float(np.percentile(pt, 75)))
    return x, models, convert.stage0_models(models, CPU), routing


@pytest.fixture(scope="module")
def stage2(small_collection):
    """``tests/test_cascade_pipeline.py``'s candidate grid (ragged rows, an
    empty row) and LTR model (reference fit), with the port's copy."""
    corpus, index, ql = small_collection
    rng = np.random.RandomState(7)
    cand = np.sort(rng.choice(index.n_docs, (96, 48)), axis=1).astype(
        np.int64)
    cand[0, 40:] = -1
    cand[3] = -1
    rng = np.random.RandomState(11)
    feats = np.concatenate([
        ref_ranker.qd_features(index, corpus, ql.terms[q], ql.mask[q],
                               ql.topic[q], cand[q][cand[q] >= 0])
        for q in range(24)])
    gains = (feats[:, 5] + 0.2 * feats[:, 1]
             + 0.05 * rng.randn(len(feats))).astype(np.float32)
    ltr = ref_ranker.train_ltr(feats, gains, n_trees=24)
    return cand, ltr, convert.ltr_model(ltr, CPU)


def _cfg(cls=SchedulerConfig, **kw):
    return cls(**dict(dict(budget=100.0, rho_max=1 << 14), **kw))


def _same(a, b, stats=("jass", "bmw", "hedged", "late_hedged", "p50",
                       "p99", "over_budget")):
    np.testing.assert_array_equal(a.topk, b.topk)
    np.testing.assert_array_equal(a.latency, b.latency)
    for key in stats:
        assert a.stats[key] == b.stats[key], key


def test_pipeline_stage0_matches_per_model(small_collection, port_collection,
                                           stage0_models):
    corpus, index, ql = small_collection
    _, pindex = port_collection
    x, ref_models, models, routing = stage0_models
    pipe = CascadePipeline(pindex, models, _cfg(rho_max=1 << 20),
                           device=CPU)
    assert isinstance(pipe, SearchSystem) and pipe._stacked is not None
    got = pipe.stage0(ql.terms, ql.mask)
    for name, g in zip(("k", "rho", "t"), got):
        want = np.expm1(np.asarray(ref_gbrt.predict(ref_models[name],
                                                    jnp.asarray(x))))
        np.testing.assert_array_equal(g, want)
    ref = RefCascadePipeline(index, ref_models,
                             _cfg(RefSchedulerConfig, rho_max=1 << 20))
    for g, w in zip(got, ref.stage0(ql.terms, ql.mask)):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="backend"):
        CascadePipeline(pindex, models, _cfg(), backend="cuda", device=CPU)


def test_pipeline_and_server_match_reference(small_collection,
                                             port_collection, stage0_models):
    """Stage-1-only pipeline == HybridServer == the reference's two: same
    top-k, same latency, same routing stats; and ``stage1`` (the
    historical signature) returns the reference's (topk, t_bmw)."""
    corpus, index, ql = small_collection
    _, pindex = port_collection
    x, ref_models, models, routing = stage0_models
    ref_cfg, cfg = _cfg(RefSchedulerConfig, **routing), _cfg(**routing)
    ref_pipe = RefCascadePipeline(index, ref_models, ref_cfg,
                                  cost=RefCostModel.paper_scale())
    ref_server = RefHybridServer(index, ref_models, ref_cfg,
                                 cost=RefCostModel.paper_scale())
    pipe = CascadePipeline(pindex, models, cfg,
                           cost=CostModel.paper_scale(), device=CPU)
    server = HybridServer(pindex, models, cfg, cost=CostModel.paper_scale(),
                          device=CPU)
    assert server.shard is server.pipeline.shard
    assert server.spec.n_docs == pindex.n_docs == index.n_docs
    want = ref_pipe.serve(ql.terms, ql.mask)
    a = pipe.serve(ql.terms, ql.mask)
    b = server.serve(ql.terms, ql.mask)
    assert a.final is None and a.stats["jass"] > 0 and a.stats["bmw"] > 0
    _same(a, want)
    _same(b, a)
    _same(b, ref_server.serve(ql.terms, ql.mask))

    routed = pipe.sched.route(*pipe.stage0(ql.terms, ql.mask))
    topk, t_bmw = pipe.stage1(ql.terms, ql.mask, routed)
    ref_topk, ref_t = ref_pipe.stage1(
        ql.terms, ql.mask, ref_pipe.sched.route(*ref_pipe.stage0(ql.terms,
                                                                 ql.mask)))
    np.testing.assert_array_equal(topk, ref_topk)
    np.testing.assert_array_equal(t_bmw, ref_t)


def test_pipeline_full_cascade_matches_reference_and_loop(
        small_collection, port_collection, stage0_models, stage2):
    """With the LTR model: the reference's served cascade, the per-query
    ``rerank_loop`` over the served Stage-1 candidates (the port's and the
    reference's), and the per-stage latency accounts."""
    corpus, index, ql = small_collection
    pcorpus, pindex = port_collection
    x, ref_models, models, routing = stage0_models
    _, ref_ltr, ltr = stage2
    ref = RefCascadePipeline(index, ref_models,
                             _cfg(RefSchedulerConfig, **routing),
                             corpus=corpus, ltr=ref_ltr, k_serve=64,
                             t_final=10)
    pipe = CascadePipeline(pindex, models, _cfg(**routing), corpus=pcorpus,
                           ltr=ltr, k_serve=64, t_final=10, device=CPU)
    want = ref.serve(ql.terms, ql.mask, ql.topic)
    res = pipe.serve(ql.terms, ql.mask, ql.topic)
    _same(res, want)
    assert res.final.shape == (96, 10)
    np.testing.assert_array_equal(res.final, want.final)
    np.testing.assert_array_equal(res.candidates_used, want.candidates_used)

    routed = pipe.sched.route(*pipe.stage0(ql.terms, ql.mask))
    k2 = np.minimum(routed.k, 64)
    rows = np.arange(96)
    loop = cascade.rerank_loop(pindex, pcorpus, ql, rows, res.topk, k2, ltr,
                               t_final=10)
    ref_loop = ref_cascade.rerank_loop(index, corpus, ql, rows, res.topk,
                                       k2, ref_ltr, t_final=10)
    for r in (loop, ref_loop):
        np.testing.assert_array_equal(r.final, res.final)
        np.testing.assert_array_equal(r.candidates_used, res.candidates_used)

    total = (res.stage_latency["stage0"] + res.stage_latency["stage1"]
             + res.stage_latency["stage2"])
    np.testing.assert_allclose(res.latency, total)
    assert set(res.stats["stages"]) == {"stage0", "stage1", "stage2"}
    np.testing.assert_array_equal(
        res.stage_latency["stage2"], pipe.cost.ltr_time(res.candidates_used))


def test_cascade_budget_reserves_stage2(small_collection, port_collection,
                                        stage0_models, stage2):
    corpus, index, ql = small_collection
    pcorpus, pindex = port_collection
    x, ref_models, models, routing = stage0_models
    _, ref_ltr, ltr = stage2
    for with_ltr in (True, False):
        ref = RefCascadePipeline(
            index, ref_models, _cfg(RefSchedulerConfig, budget=30.0),
            corpus=corpus, ltr=ref_ltr if with_ltr else None, k_serve=64)
        pipe = CascadePipeline(
            pindex, models, _cfg(budget=30.0), corpus=pcorpus,
            ltr=ltr if with_ltr else None, k_serve=64, device=CPU)
        reserve = (float(pipe.cost.ltr_time(np.asarray(64))) if with_ltr
                   else 0.0)
        assert pipe.sched.cfg.budget == pytest.approx(
            30.0 - pipe.cost.predict_us - reserve)
        assert pipe.sched.cfg.budget == ref.sched.cfg.budget
        assert pipe.budget == ref.budget == 30.0


@pytest.mark.parametrize("t_final", [10, 60])
def test_rerank_loop_matches_batched_and_reference(
        small_collection, port_collection, stage2, t_final):
    """The per-query loop against the batched Stage-2 (ragged rows, an
    empty row, per-query budgets; t_final past the grid's width pads with
    -1) and against the reference's loop."""
    corpus, index, ql = small_collection
    pcorpus, pindex = port_collection
    cand, ref_ltr, ltr = stage2
    k = np.random.RandomState(3).randint(0, 60, 96)
    rows = np.arange(96)
    loop = cascade.rerank_loop(pindex, pcorpus, ql, rows, cand, k, ltr,
                               t_final=t_final)
    ref = ref_cascade.rerank_loop(index, corpus, ql, rows, cand, k, ref_ltr,
                                  t_final=t_final)
    batched = cascade.rerank_batched(
        stage2_arrays(pindex, pcorpus, CPU), ltr, ql.terms, ql.mask,
        ql.topic, cand, k, t_final=t_final,
        qcap=query_lane_budget(pindex.df, ql.terms, ql.mask))
    for r in (ref, batched):
        np.testing.assert_array_equal(loop.final, r.final)
        np.testing.assert_array_equal(loop.candidates_used, r.candidates_used)
    assert (loop.candidates_used == 0).any() and (loop.final == -1).any()


def _spec(t_k, t_time):
    """``tests/test_search_system.py``'s one-shard spec."""
    return CascadeSpec(
        routing=RoutingSpec(budget=100.0, rho_max=1 << 14, t_k=t_k,
                            t_time=t_time),
        stage2=Stage2Spec(enabled=True, k_serve=64, t_final=10),
        backend=BackendSpec(backend="jnp"),
        deploy=DeploySpec(n_shards=1, replicas=2),
        name="test_1shard")


def test_compat_shims_match_spec_system(small_collection, port_collection):
    """The shims' old signatures == a one-shard spec system, in the port
    and against the reference's fitted system."""
    corpus, index, ql = small_collection
    pcorpus, pindex = port_collection
    spec = dataclasses.replace(
        _spec(150.0, 18.0),
        routing=RoutingSpec(budget=100.0, rho_max=1 << 14, calibrate=True))
    ref = ref_build_system(spec, index, corpus=corpus)
    ref.fit(ql, None, seed=5)
    tk, tt = ref._base_cfg.t_k, ref._base_cfg.t_time
    models, ltr = convert.system_models(ref, CPU)
    system = build_system(convert.cascade_spec(ref.cascade_spec), pindex,
                          corpus=pcorpus, models=models, ltr=ltr, device=CPU)
    cfg = _cfg(t_k=tk, t_time=tt)
    pipe = CascadePipeline(pindex, models, cfg, corpus=pcorpus, ltr=ltr,
                           k_serve=64, t_final=10, backend="jnp",
                           device=CPU)
    assert pipe.n_shards == 1 and pipe.spec.n_docs == pindex.n_docs
    a = system.serve(ql.terms, ql.mask, ql.topic)
    b = pipe.serve(ql.terms, ql.mask, ql.topic)
    want = ref.serve(ql.terms, ql.mask, ql.topic)
    for r in (a, b):
        _same(r, want, stats=("jass", "bmw", "over_budget"))
        np.testing.assert_array_equal(r.final, want.final)

    server = HybridServer(pindex, models, cfg, k_serve=64, device=CPU)
    stage1 = build_system(
        convert.cascade_spec(dataclasses.replace(
            _spec(tk, tt), stage2=Stage2Spec(enabled=False, k_serve=64))),
        pindex, models=models, device=CPU)
    ref_server = RefHybridServer(index, ref.models,
                                 _cfg(RefSchedulerConfig, t_k=tk, t_time=tt),
                                 k_serve=64)
    c = server.serve(ql.terms, ql.mask)
    _same(c, stage1.serve(ql.terms, ql.mask))
    _same(c, ref_server.serve(ql.terms, ql.mask))


def test_end_to_end_budget_guarantee_matches_reference(small_collection,
                                                       port_collection):
    """``tests/test_system.py``'s budget guarantee through the port's
    ``HybridServer``, with Stage-0 models fitted by the reference on the
    oracle labels: the reference's top-k and latencies, and the claim
    itself (the hybrid keeps ≤ 5 % over budget, fewer than a fixed BMW
    system, both pools used)."""
    corpus, index, ql = small_collection
    _, pindex = port_collection
    labels = generate_labels(index, corpus, ql,
                             LabelConfig(max_k=1024, batch=96,
                                         rho_grid=(256, 512, 1024, 2048,
                                                   4096, 8192, 16384)))
    x = np.asarray(ref_features.extract(
        jnp.asarray(index.term_stats), jnp.asarray(index.df),
        jnp.asarray(ql.terms), jnp.asarray(ql.mask)))
    keep = labels.keep
    ref_models = {
        name: ref_gbrt.fit(x[keep], np.log1p(y[keep].astype(np.float32)),
                           ref_gbrt.GBRTParams(n_trees=24, depth=4,
                                               loss="quantile", tau=tau))
        for name, y, tau in (("k", labels.oracle_k, 0.55),
                             ("rho", labels.oracle_rho, 0.45),
                             ("t", labels.t_bmw, 0.5))}
    budget = float(np.percentile(labels.t_bmw[keep], 85))
    kw = dict(algorithm=2, budget=budget, rho_max=1 << 14,
              t_time=budget * 0.6,
              t_k=float(np.median(labels.oracle_k[keep])))
    server = HybridServer(pindex, convert.stage0_models(ref_models, CPU),
                          SchedulerConfig(**kw), cost=CostModel.paper_scale(),
                          device=CPU)
    res = server.serve(ql.terms, ql.mask)
    ref = RefHybridServer(index, ref_models, RefSchedulerConfig(**kw),
                          cost=RefCostModel.paper_scale())
    _same(res, ref.serve(ql.terms, ql.mask))
    frac_over = np.mean(res.latency > budget)
    assert frac_over < np.mean(labels.t_bmw > budget)
    assert frac_over <= 0.05
    assert res.stats["jass"] > 0 and res.stats["bmw"] > 0
