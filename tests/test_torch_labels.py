"""The port's label oracle and labelled fit against the reference, on the CPU.

* ``core/reference``: ``rbp_weights`` bit for bit at depths 1 to 1,024 and
  p 0.8 to 0.99; ``rbp``, ``med_rbp``, ``med_rbp_at_cutoffs``, ``rbo``,
  ``overlap`` and their batched forms within 1e-6, ``oracle_cutoff`` equal;
* ``isn/oracle``: every function equal (``np.array_equal``);
* ``core/labels.generate_labels``: every field of the ``LabelSet`` equal,
  at ``tests/test_system.py``'s configuration;
* ``ltr/ranker.ltr_training_set`` equal;
* ``SearchSystem.fit(ql, labels, seed=5)``: the four forests bit for bit,
  the regressed ``CostModel`` and the budget reservation equal, with
  ``calibrate_cost`` on and off, and the serve that follows.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.configs.cascade_presets import get_preset as ref_get_preset
from repro.core import labels as ref_labels
from repro.core import reference as ref_reference
from repro.isn import oracle as ref_oracle
from repro.ltr import ranker as ref_ranker
from repro.serving.latency import CostModel as RefCostModel
from repro.serving.spec import (BackendSpec, CascadeSpec, RoutingSpec,
                                Stage0Spec, Stage2Spec)
from repro.serving.system import build_system as ref_build_system
from repro_torch import convert
from repro_torch.core import labels, reference
from repro_torch.index.builder import build_index
from repro_torch.index.corpus import CorpusParams, build_corpus
from repro_torch.isn import oracle
from repro_torch.ltr import ranker
from repro_torch.serving.latency import CostModel
from repro_torch.serving.system import build_system

BATCH = 32
LABEL_CFG = dict(max_k=1024, batch=96,
                 rho_grid=(256, 512, 1024, 2048, 4096, 8192, 16384))
LABEL_FIELDS = [f.name for f in dataclasses.fields(ref_labels.LabelSet)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port_collection():
    corpus = build_corpus(CorpusParams(n_docs=4096, vocab=2048,
                                       avg_doclen=80, zipf_a=1.05, seed=3))
    return corpus, build_index(corpus, stop_k=8)


@pytest.fixture(scope="module")
def label_pair(small_collection, port_collection):
    """The reference's and the port's labels of the fixture's queries."""
    corpus, index, ql = small_collection
    pcorpus, pindex = port_collection
    want = ref_labels.generate_labels(index, corpus, ql,
                                      ref_labels.LabelConfig(**LABEL_CFG))
    got = labels.generate_labels(pindex, pcorpus, ql,
                                 labels.LabelConfig(**LABEL_CFG))
    return want, got


# ---------------------------------------------------------------------------
# core/reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p", [0.8, 0.9, 0.95, 0.99])
@pytest.mark.parametrize("depth", [1, 100, 256, 1024])
def test_rbp_weights_are_bit_equal(depth, p):
    got = reference.rbp_weights(depth, p)
    want = np.asarray(ref_reference.rbp_weights(depth, p))
    assert got.dtype == torch.float32 and got.shape == (depth,)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))


def _lists(rng, b, depth, n_docs, pad_every=0):
    """(b, depth) ranked lists without repeats, some -1 padding."""
    out = np.stack([rng.permutation(n_docs)[:depth] for _ in range(b)])
    if pad_every:
        out[:, ::pad_every] = -1
    return out.astype(np.int32)


@pytest.mark.parametrize("p", [0.8, 0.95])
def test_list_metrics_match_reference(p):
    rng = np.random.RandomState(7)
    ref = _lists(rng, 16, 40, 60, pad_every=7)
    run = _lists(rng, 16, 50, 60)
    ranks = rng.randint(0, 300, size=ref.shape)
    ranks[:, ::5] = 1 << 30
    cutoffs = np.array([1, 8, 32, 100, 256], np.int32)
    t = torch.from_numpy
    close = dict(atol=1e-6, rtol=0)
    for i in range(4):
        np.testing.assert_allclose(
            reference.med_rbp(t(ref[i]), t(run[i]), p).numpy(),
            np.asarray(ref_reference.med_rbp(jnp.asarray(ref[i]),
                                             jnp.asarray(run[i]), p)),
            **close)
        np.testing.assert_allclose(
            reference.med_rbp_at_cutoffs(t(ref[i]), t(ranks[i]), t(cutoffs),
                                         p).numpy(),
            np.asarray(ref_reference.med_rbp_at_cutoffs(
                jnp.asarray(ref[i]), jnp.asarray(ranks[i]),
                jnp.asarray(cutoffs), p)), **close)
        for eps in (1e-3, 0.05, 0.5):
            assert int(reference.oracle_cutoff(
                t(ref[i]), t(ranks[i]), t(cutoffs), p, eps)) == int(
                ref_reference.oracle_cutoff(
                    jnp.asarray(ref[i]), jnp.asarray(ranks[i]),
                    jnp.asarray(cutoffs), p, eps))
        np.testing.assert_allclose(
            reference.overlap(t(ref[i]), t(run[i])).numpy(),
            np.asarray(ref_reference.overlap(jnp.asarray(ref[i]),
                                             jnp.asarray(run[i]))), **close)
        sq = run[i][:40]
        np.testing.assert_allclose(
            reference.rbo(t(ref[i]), t(sq), p).numpy(),
            np.asarray(ref_reference.rbo(jnp.asarray(ref[i]),
                                         jnp.asarray(sq), p)), **close)
    gains = rng.rand(5, 30).astype(np.float32)
    np.testing.assert_allclose(
        reference.rbp(t(gains), p).numpy(),
        np.asarray(ref_reference.rbp(jnp.asarray(gains), p)), **close)
    np.testing.assert_allclose(
        reference.batched_med_rbp(t(ref), t(run), p).numpy(),
        np.asarray(ref_reference.batched_med_rbp(jnp.asarray(ref),
                                                 jnp.asarray(run), p=p)),
        **close)
    np.testing.assert_allclose(
        reference.batched_rbo(t(ref), t(run[:, :40]), p).numpy(),
        np.asarray(ref_reference.batched_rbo(jnp.asarray(ref),
                                             jnp.asarray(run[:, :40]), p=p)),
        **close)
    # the batched cutoffs broadcast over rows as the reference's vmap does
    np.testing.assert_array_equal(
        reference.oracle_cutoff(t(ref), t(ranks), t(cutoffs), p,
                                1e-3).numpy(),
        [int(ref_reference.oracle_cutoff(jnp.asarray(a), jnp.asarray(r),
                                         jnp.asarray(cutoffs), p, 1e-3))
         for a, r in zip(ref, ranks)])


def test_metric_edge_cases():
    t = torch.tensor
    same = t([3, 1, 2], dtype=torch.int32)
    assert float(reference.med_rbp(same, same, 0.95)) == 0.0
    assert float(reference.overlap(same, same)) == 1.0
    pad = t([-1, -1], dtype=torch.int32)
    assert float(reference.overlap(pad, pad)) == 0.0
    assert float(reference.med_rbp(pad, same, 0.95)) == 0.0
    # no cutoff reaches the target: the largest
    assert int(reference.oracle_cutoff(
        same, t([9, 9, 9]), t([1, 2]), 0.95, 0.0)) == 2
    assert reference.PAD == ref_reference.PAD


# ---------------------------------------------------------------------------
# isn/oracle
# ---------------------------------------------------------------------------

def _eq(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_oracle_functions_match_reference(small_collection, port_collection):
    corpus, index, ql = small_collection
    pcorpus, pindex = port_collection
    args = (ql.terms, ql.mask)
    rows = np.arange(40, 88)
    q = int(rows[0])
    for ordered in (False, True):
        _eq(oracle._query_postings(pindex, ql.terms[q], ql.mask[q], ordered),
            ref_oracle._query_postings(index, ql.terms[q], ql.mask[q],
                                       ordered))
    acc, work = oracle.exhaustive_scores(pindex, *args, rows)
    acc_w, work_w = ref_oracle.exhaustive_scores(index, *args, rows)
    np.testing.assert_array_equal(acc, acc_w)
    assert work == work_w
    for k in (1, 10, 128):
        _eq(oracle._topk_ids(acc, k), ref_oracle._topk_ids(acc_w, k))
    rho = np.linspace(100, 20000, len(rows)).astype(np.int64)
    for r in (256, 4096, rho, 1 << 62):
        _eq(oracle.jass_scores(pindex, *args, rows, r),
            ref_oracle.jass_scores(index, *args, rows, r))
        rr = (np.resize(r, len(ql.terms)) if np.ndim(r)
              else np.full(len(ql.terms), r, np.int64))
        np.testing.assert_array_equal(
            oracle.jass_work_only(pindex, *args, rr),
            ref_oracle.jass_work_only(index, *args, rr))
    for k, theta in ((10, 1.0), (128, 1.0), (128, 1.2)):
        _eq(oracle.bmw_scores(pindex, *args, rows, k, theta),
            ref_oracle.bmw_scores(index, *args, rows, k, theta))
    ideal = oracle.ideal_rerank(pindex, pcorpus, *args, ql.topic, rows, acc,
                                depth=50, rerank_depth=256)
    np.testing.assert_array_equal(
        ideal, ref_oracle.ideal_rerank(index, corpus, *args, ql.topic, rows,
                                       acc_w, depth=50, rerank_depth=256))
    np.testing.assert_array_equal(oracle.ranks_of(acc, ideal, 1024),
                                  ref_oracle.ranks_of(acc_w, ideal, 1024))


# ---------------------------------------------------------------------------
# core/labels and the LTR training set
# ---------------------------------------------------------------------------

def test_generate_labels_matches_reference(label_pair):
    want, got = label_pair
    assert [f.name for f in dataclasses.fields(labels.LabelSet)] \
        == LABEL_FIELDS
    for name in LABEL_FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    # the labels are not degenerate: both filters and several ρ take rows
    assert 0 < got.keep.sum() <= len(got.keep)
    assert len(np.unique(got.oracle_rho)) > 1
    assert len(np.unique(got.oracle_k)) > 1


def test_label_helpers_match_reference(small_collection, port_collection):
    corpus, index, ql = small_collection
    pcorpus, pindex = port_collection
    rows = np.arange(8)
    acc, _ = oracle.exhaustive_scores(pindex, ql.terms, ql.mask, rows)
    np.testing.assert_array_equal(
        labels._ideal_reference(pindex, pcorpus, ql, rows, acc,
                                labels.LabelConfig()),
        ref_labels._ideal_reference(index, corpus, ql, rows, acc,
                                    ref_labels.LabelConfig()))
    w = reference.rbp_weights(100, 0.95).numpy()
    rng = np.random.RandomState(2)
    for _ in range(20):
        ranks = rng.randint(0, 2000, 100)
        for eps, max_k in ((1e-3, 1024), (0.0, 4096), (0.5, 64)):
            assert labels._oracle_k_row(ranks, w, eps, max_k) \
                == ref_labels._oracle_k_row(ranks, w, eps, max_k)


def test_ltr_training_set_matches_reference(small_collection,
                                            port_collection, label_pair):
    corpus, index, ql = small_collection
    pcorpus, pindex = port_collection
    want_labels, got_labels = label_pair
    rows = np.flatnonzero(got_labels.keep)[:40]
    _eq(ranker.ltr_training_set(pindex, pcorpus, ql, got_labels.ref_lists,
                                rows),
        ref_ranker.ltr_training_set(index, corpus, ql,
                                    want_labels.ref_lists, rows))


# ---------------------------------------------------------------------------
# SearchSystem.fit(ql, labels)
# ---------------------------------------------------------------------------

def _same_forest(got, want):
    for name in ("feat", "thresh", "leaf"):
        np.testing.assert_array_equal(getattr(got.forest, name).numpy(),
                                      np.asarray(getattr(want.forest, name)))
    np.testing.assert_array_equal(got.base.reshape(()).numpy(),
                                  np.float32(want.base))
    np.testing.assert_array_equal(got.bin_edges.numpy(),
                                  np.asarray(want.bin_edges))


def _same_cost(got, want):
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def convert_cfg(cfg):
    """A reference ``SchedulerConfig`` as the port's (same fields)."""
    from repro_torch.serving.scheduler import SchedulerConfig
    return SchedulerConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("calibrate_cost", [True, False])
def test_fit_with_labels_matches_reference(small_collection, port_collection,
                                           label_pair, calibrate_cost):
    corpus, index, ql = small_collection
    pcorpus, pindex = port_collection
    want_labels, got_labels = label_pair
    spec = dataclasses.replace(
        ref_get_preset("paper_200ms"),
        backend=BackendSpec(backend="jnp", calibrate_cost=calibrate_cost))
    a = ref_build_system(spec, index, corpus=corpus)
    b = build_system(convert.cascade_spec(spec), pindex, corpus=pcorpus,
                     device="cpu")
    prior = dataclasses.asdict(b.cost)
    a.fit(ql, want_labels, seed=5)
    assert b.fit(ql, got_labels, seed=5) is b
    for n in ("k", "rho", "t"):
        _same_forest(b.models[n], a.models[n])
    _same_forest(b.ltr.model, a.ltr.model)
    _same_cost(b.cost, a.cost)
    assert (dataclasses.asdict(b.cost) != prior) == calibrate_cost
    assert b._budget_reserve == a._budget_reserve
    assert b.sched.cfg == convert_cfg(a.sched.cfg)
    assert b.cascade_spec.to_json() == a.cascade_spec.to_json()
    for i in range(0, len(ql.terms), BATCH):
        sl = slice(i, i + BATCH)
        ra = a.serve(ql.terms[sl], ql.mask[sl], ql.topic[sl])
        rb = b.serve(ql.terms[sl], ql.mask[sl], ql.topic[sl])
        np.testing.assert_array_equal(rb.topk, ra.topk)
        np.testing.assert_array_equal(rb.final, ra.final)
        np.testing.assert_array_equal(rb.latency, ra.latency)
        assert rb.stats["budget"] == ra.stats["budget"]


def _tail_spec(budget):
    """``tests/test_tail_guarantee.py``'s ``_spec``."""
    return CascadeSpec(
        routing=RoutingSpec(budget=budget, rho_max=1 << 14, t_k=150.0,
                            t_time=18.0),
        stage0=Stage0Spec(n_trees=12, depth=3),
        stage2=Stage2Spec(enabled=True, k_serve=64, t_final=10,
                          ltr_trees=12, n_train_queries=8),
        backend=BackendSpec(backend="jnp"),
        name="tail_test")


def _fake_labels(mod, index, ql, cost, seed=0):
    """``tests/test_tail_guarantee.py``'s ``_fake_labels`` in ``mod``'s
    ``LabelSet``: time labels from ``cost``, no oracle."""
    rng = np.random.RandomState(seed)
    q = len(ql.terms)
    eff = ((index.df[ql.terms] * (ql.mask > 0)).sum(axis=1)
           .astype(np.float64))
    work_bmw = np.maximum((eff * 0.4).astype(np.int64), 1)
    blocks = np.maximum(work_bmw // index.block_size, 1)
    work_exh = np.maximum(eff.astype(np.int64), 1)
    return mod.LabelSet(
        keep=np.ones(q, bool),
        ref_lists=rng.randint(0, index.n_docs, size=(q, 100)),
        oracle_k=np.maximum((eff * 0.05).astype(np.int64), 1),
        oracle_rho=np.maximum((eff * 0.5).astype(np.int64), 256),
        med_at_max=np.zeros(q),
        work_exhaustive=work_exh, work_bmw=work_bmw, blocks_bmw=blocks,
        t_bmw=cost.daat_time(work_bmw, blocks),
        t_exh=cost.saat_time(work_exh))


def test_fit_regresses_cost_model_from_measured_labels(small_collection,
                                                       port_collection):
    """``tests/test_tail_guarantee.py``'s case on the port, and the result
    equal to the reference's."""
    corpus, index, ql = small_collection
    pcorpus, pindex = port_collection
    rates = dict(saat_fixed_us=2.5, saat_per_posting_us=4e-3,
                 daat_fixed_us=6.0, daat_per_posting_us=9e-3,
                 daat_per_block_us=0.05)
    want_labels = _fake_labels(ref_labels, index, ql, RefCostModel(**rates))
    got_labels = _fake_labels(labels, pindex, ql, CostModel(**rates))
    spec = _tail_spec(100.0)
    a = ref_build_system(spec, index, corpus=corpus)
    b = build_system(convert.cascade_spec(spec), pindex, corpus=pcorpus,
                     device="cpu")
    prior = b.cost
    assert prior.saat_per_posting_us != rates["saat_per_posting_us"]
    a.fit(ql, want_labels, seed=5)
    b.fit(ql, got_labels, seed=5)
    assert b.cost.saat_per_posting_us == pytest.approx(4e-3, rel=1e-6)
    assert b.cost.daat_per_posting_us == pytest.approx(9e-3, rel=1e-6)
    # the scheduler's reservation was rebuilt against the measured rates
    assert b._budget_reserve["stage2"] == pytest.approx(
        float(b.cost.ltr_time(np.asarray(b.k_serve))))
    _same_cost(b.cost, a.cost)
    assert b._budget_reserve == a._budget_reserve
    for n in ("k", "rho", "t"):
        _same_forest(b.models[n], a.models[n])
    _same_forest(b.ltr.model, a.ltr.model)

    off_spec = dataclasses.replace(
        spec, backend=BackendSpec(backend="jnp", calibrate_cost=False))
    off = build_system(convert.cascade_spec(off_spec), pindex,
                       corpus=pcorpus, device="cpu")
    off.fit(ql, got_labels, seed=5)
    assert off.cost.saat_per_posting_us == prior.saat_per_posting_us


@pytest.mark.parametrize("n", [7, 8, 24, 32, 33, 384, 4608, 12288])
def test_l2_base_matches_reference(n):
    """The L2 GBRT's base, ``jnp.mean`` as the reference compiles it, at
    the sizes of labelled LTR sets (48 rows a kept query) and below 32."""
    from repro.core import gbrt as ref_gbrt
    from repro_torch.core import gbrt
    rng = np.random.RandomState(n)
    x = rng.rand(n, 3).astype(np.float32)
    y = (rng.standard_cauchy(n) * 10.0).astype(np.float32)
    params = dict(n_trees=2, depth=2, loss="l2")
    want = ref_gbrt.fit(x, y, ref_gbrt.GBRTParams(**params))
    got = gbrt.fit(x, y, gbrt.GBRTParams(**params), device="cpu")
    _same_forest(got, want)
