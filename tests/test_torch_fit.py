"""The port's training path against the reference, bit for bit, on the CPU.

The fit runs the kernels' plain versions here (``level_histogram``,
``boost_update``); every case holds the port to the reference (JAX on the
CPU, its fit compiled as it compiles it) at tolerance 0.0:

* the split histograms of one level (each cell's rows added in row
  order), the cumulative sums over the bins (XLA-CPU's windows of 16),
  ``build_tree`` (dead nodes, exact gain ties), ``leaf_means`` and
  ``leaf_quantiles`` (empty leaves), and the boosting update (one fused
  multiply-add, a forced float32 tie included);
* ``gbrt.fit``: quantile GBRTs at Stage-0's shapes and the LTR's L2 GBRT,
  in base, ``feat``, ``thresh``, ``leaf``, bin edges and predictions;
* ``qd_features`` and ``train_ltr``;
* ``SearchSystem.fit(ql, None, seed=5)`` for ``paper_200ms`` and
  ``hybrid_fusion`` at 1 and 3 shards: the four forests, ``t_k``/``t_time``
  and the spec's routing, then the serve that follows; and
  ``fit(ql, labels, seed=5)`` on each package's oracle labels (the rest of
  the label oracle is in ``tests/test_torch_labels.py``);
* the BENCH_tail flow of ``chip_smoke.tail_flow`` on the CPU against the
  reference's ``benchmarks/bench_tail.run_tail``, figure for figure.
"""

import dataclasses
import json
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs.cascade_presets import get_preset as ref_get_preset
from repro.configs.two_tower_retrieval import REDUCED as REF_REDUCED
from repro.core import gbrt as ref_gbrt
from repro.core import trees as ref_trees
from repro.ltr import ranker as ref_ranker
from repro.models import recsys as ref_recsys
from repro.serving.spec import BackendSpec, DeploySpec
from repro.serving.system import build_system as ref_build_system
from repro_torch import convert
from repro_torch.core import gbrt, trees
from repro_torch.index.builder import build_index
from repro_torch.index.corpus import CorpusParams, build_corpus
from repro_torch.kernels.level_histogram import ops as lh_ops
from repro_torch.ltr import ranker
from repro_torch.serving.system import build_system

ROOT = pathlib.Path(__file__).resolve().parents[1]
BATCH = 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _heavy(rng, n):
    """Heavy-tailed float32 values: sums whose order shows in the bits."""
    return (rng.standard_cauchy(n) * 10.0).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(got: torch.Tensor, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the tree builder's pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,n_feat,n_nodes", [(600, 147, 1), (600, 147, 16),
                                              (2048, 8, 8), (37, 5, 2)])
def test_level_histograms_match_reference(n, n_feat, n_nodes):
    rng = np.random.RandomState(n + n_feat + n_nodes)
    xb = rng.randint(0, 64, (n, n_feat)).astype(np.uint8)
    node = rng.randint(0, n_nodes, n).astype(np.int32)
    grad = _heavy(rng, n)
    weight = (rng.rand(n) < 0.8).astype(np.float32)
    want_g, want_w = jax.jit(ref_trees._level_histograms,
                             static_argnums=(4, 5))(
        jnp.asarray(xb), jnp.asarray(node), jnp.asarray(grad),
        jnp.asarray(weight), n_nodes, 64)
    got_g, got_w = trees._level_histograms(_t(xb.T), _t(node), _t(grad),
                                           _t(weight), n_nodes, 64)
    _eq(got_g, want_g)
    _eq(got_w, want_w)
    # each cell's rows one at a time, in row order, from 0.0
    keys = (node[:, None] * n_feat + np.arange(n_feat)) * 64 + xb
    seq = np.zeros(n_nodes * n_feat * 64, np.float32)
    np.add.at(seq, keys.reshape(-1),
              np.repeat(grad * weight, n_feat).astype(np.float32))
    _eq(got_g.reshape(-1), seq)


@pytest.mark.parametrize("n_bins", [64, 16, 100, 256])
def test_bin_cumsum_matches_jnp_cumsum(n_bins):
    rng = np.random.RandomState(n_bins)
    h = (rng.standard_cauchy((2, 8, 147, n_bins)) * 100).astype(np.float32)
    want = jax.jit(lambda a: jnp.cumsum(a, axis=-1))(jnp.asarray(h))
    _eq(trees._bin_cumsum(_t(h)), want)
    # not the sequential order, which differs at this size
    if n_bins == 64:
        assert not np.array_equal(np.cumsum(h, axis=-1, dtype=np.float32),
                                  np.asarray(want))


def _tree_inputs(case):
    rng = np.random.RandomState(7)
    n, n_feat = 500, 12
    xb = rng.randint(0, 64, (n, n_feat)).astype(np.uint8)
    target = _heavy(rng, n)
    weight = np.ones(n, np.float32)
    mask = np.ones(n_feat, bool)
    params = ref_trees.TreeParams(depth=5, n_bins=64, min_child_weight=10.0)
    if case == "dead_nodes":
        # children of fewer than 100 rows: the deeper nodes cannot split
        params = params._replace(min_child_weight=100.0)
    elif case == "gain_ties":
        # identical columns and a two-valued target: equal gains, the lowest
        # (feature, bin) must win
        xb[:, 5] = xb[:, 2]
        xb[:, 9] = xb[:, 2]
        target = np.where(xb[:, 2] > 31, 1.0, -1.0).astype(np.float32)
    elif case == "masked":
        weight = (rng.rand(n) < 0.7).astype(np.float32)
        mask[[0, 3, 4]] = False
    return xb, target, weight, mask, params


@pytest.mark.parametrize("case", ["plain", "dead_nodes", "gain_ties",
                                  "masked"])
def test_build_tree_matches_reference(case):
    xb, target, weight, mask, params = _tree_inputs(case)
    want = jax.jit(ref_trees.build_tree, static_argnums=(4,))(
        jnp.asarray(xb), jnp.asarray(target), jnp.asarray(weight),
        jnp.asarray(mask), params)
    got = trees.build_tree(_t(xb.T), _t(target), _t(weight), _t(mask),
                           trees.TreeParams(*params))
    for g, w in zip(got, want):
        _eq(g, w)
    feat, thresh, _ = got
    if case == "dead_nodes":
        # the pass-through split of a node no split satisfies
        dead = (feat == 0) & (thresh == 63)
        assert dead[1:].any()
    if case == "gain_ties":
        assert int(feat[0, 0]) == 2


@pytest.mark.parametrize("tau", [None, 0.45, 0.5, 0.55])
def test_leaf_values_match_reference(tau):
    rng = np.random.RandomState(3)
    n, n_leaves = 400, 32
    # leaves 7 and 20 stay empty; a fifth of the rows weigh 0
    leaf = rng.choice(np.setdiff1d(np.arange(n_leaves), [7, 20]), n)
    leaf = leaf.astype(np.int32)
    values = _heavy(rng, n)
    weight = (rng.rand(n) < 0.8).astype(np.float32)
    if tau is None:
        want = ref_trees.leaf_means(jnp.asarray(leaf), jnp.asarray(values),
                                    jnp.asarray(weight), n_leaves, 1.0)
        got = trees.leaf_means(_t(leaf), _t(values), _t(weight), n_leaves,
                               1.0)
    else:
        want = ref_trees.leaf_quantiles(jnp.asarray(leaf),
                                        jnp.asarray(values),
                                        jnp.asarray(weight), n_leaves, tau)
        got = trees.leaf_quantiles(_t(leaf), _t(values), _t(weight),
                                   n_leaves, tau)
        assert float(got[7]) == 0.0 and float(got[20]) == 0.0
    _eq(got, want)


def test_boost_update_is_one_fused_multiply_add():
    rng = np.random.RandomState(5)
    n, lr = 5000, 0.15
    f = _heavy(rng, n)
    raw = _heavy(rng, 32)
    leaf = rng.randint(0, 32, n).astype(np.int32)
    # the reference's update, compiled as its fit compiles it
    want = jax.jit(lambda f, r, l: f + (r * lr)[l])(
        jnp.asarray(f), jnp.asarray(raw), jnp.asarray(leaf))
    got = lh_ops.boost_update(_t(f), _t(raw), _t(leaf), lr)
    _eq(got, want)
    # a product that puts the float64 sum exactly on a float32 tie:
    # (1 + 2^-23) · (1 - 2^-23) · 2^-24 + (1 + 2^-23) is just below the
    # midpoint 1 + 2^-23 + 2^-24, so the one rounding goes down; the float64
    # sum rounds onto the midpoint and then, to even, up
    a = np.float32(1 + 2.0 ** -23)
    b = np.float32((1 - 2.0 ** -23) * 2.0 ** -24)
    c = np.float32(1 + 2.0 ** -23)
    twice = np.float32(np.float64(a) * np.float64(b) + np.float64(c))
    assert twice == np.float32(1 + 2.0 ** -22)
    got = lh_ops.fma32(_t(np.array([a])), _t(np.array([b])),
                       _t(np.array([c])))
    assert got.item() == c
    got = lh_ops.boost_update(_t(np.array([c])), _t(np.array([a])),
                              _t(np.array([0], np.int32)), float(b))
    assert got.item() == c


# ---------------------------------------------------------------------------
# gbrt.fit
# ---------------------------------------------------------------------------

def _assert_same_model(got, want):
    for name in ("feat", "thresh", "leaf"):
        _eq(getattr(got.forest, name), getattr(want.forest, name))
    _eq(got.base.reshape(()), np.float32(want.base))
    _eq(got.bin_edges, want.bin_edges)
    assert got.params == gbrt.GBRTParams(*want.params)


@pytest.mark.parametrize("loss,tau,n,n_feat,depth,lr", [
    ("quantile", 0.45, 600, 147, 5, 0.15),
    ("quantile", 0.5, 600, 147, 5, 0.15),
    ("quantile", 0.55, 600, 147, 5, 0.15),
    ("l2", 0.5, 2048, 8, 4, 0.2)])
def test_gbrt_fit_matches_reference(loss, tau, n, n_feat, depth, lr):
    rng = np.random.RandomState(int(tau * 100) + n_feat)
    x = (rng.standard_cauchy((n, n_feat)) * 3).astype(np.float32)
    x[:, 3] = 1.0                            # a constant column
    y = np.log1p(np.abs(x[:, 0] * 2 + x[:, 1] + rng.randn(n) * 0.3))
    y = y.astype(np.float32)
    params = ref_gbrt.GBRTParams(n_trees=48, depth=depth, loss=loss,
                                 tau=tau, learning_rate=lr)
    want = ref_gbrt.fit(x, y, params)
    got = gbrt.fit(x, y, gbrt.GBRTParams(*params), device="cpu")
    _assert_same_model(got, want)
    _eq(gbrt.predict(got, _t(x)), ref_gbrt.predict(want, jnp.asarray(x)))


def test_fit_refuses_a_missing_card(monkeypatch):
    x = np.zeros((40, 3), np.float32)
    y = np.zeros(40, np.float32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gbrt.fit(x, y, gbrt.GBRTParams(n_trees=2))


# ---------------------------------------------------------------------------
# the LTR training set and model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_collection():
    corpus = build_corpus(CorpusParams(n_docs=4096, vocab=2048,
                                       avg_doclen=80, zipf_a=1.05, seed=3))
    return corpus, build_index(corpus, stop_k=8)


def test_qd_features_and_train_ltr_match_reference(small_collection,
                                                   port_collection):
    corpus, index, ql = small_collection
    pcorpus, pindex = port_collection
    rng = np.random.RandomState(1)
    want, got = [], []
    for q in range(24):
        docs = rng.randint(0, index.n_docs, 64).astype(np.int64)
        args = (ql.terms[q], ql.mask[q], ql.topic[q], docs)
        want.append(ref_ranker.qd_features(index, corpus, *args))
        got.append(ranker.qd_features(pindex, pcorpus, *args))
    np.testing.assert_array_equal(np.concatenate(got), np.concatenate(want))
    lf = np.concatenate(want)
    lg = (lf[:, 5] + 0.2 * lf[:, 1]).astype(np.float32)
    m_want = ref_ranker.train_ltr(lf, lg, n_trees=24)
    m_got = ranker.train_ltr(lf, lg, n_trees=24, device="cpu")
    _assert_same_model(m_got.model, m_want.model)
    _eq(m_got.score(_t(lf)), m_want.score(lf))


# ---------------------------------------------------------------------------
# SearchSystem.fit, then the serve
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_tower_params():
    """The reference's two-tower init (DenseSpec.seed 0) as NumPy arrays."""
    params, _ = ref_recsys.init(REF_REDUCED, jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


def _fitted_pair(small_collection, port_collection, ref_tower_params, name,
                 n_shards):
    corpus, index, ql = small_collection
    pcorpus, pindex = port_collection
    preset = ref_get_preset(name)
    spec = dataclasses.replace(
        preset, backend=BackendSpec(backend="jnp"),
        deploy=dataclasses.replace(preset.deploy, n_shards=n_shards))
    a = ref_build_system(spec, index, corpus=corpus)
    tower = (convert.two_tower_params(ref_tower_params, "cpu")
             if spec.dense.enabled else None)
    b = build_system(convert.cascade_spec(spec), pindex, corpus=pcorpus,
                     tower=tower, device="cpu")
    a.fit(ql, None, seed=5)
    assert b.fit(ql, None, seed=5) is b
    return ql, a, b


@pytest.mark.parametrize("name,n_shards", [("paper_200ms", 1),
                                           ("paper_200ms", 3),
                                           ("hybrid_fusion", 1),
                                           ("hybrid_fusion", 3)])
def test_search_system_fit_matches_reference(small_collection,
                                             port_collection,
                                             ref_tower_params, name,
                                             n_shards):
    ql, a, b = _fitted_pair(small_collection, port_collection,
                            ref_tower_params, name, n_shards)
    models, ltr = convert.system_models(a, "cpu")
    for n in ("k", "rho", "t"):
        _assert_same_model(b.models[n], a.models[n])
        assert b.models[n].params == models[n].params
    _assert_same_model(b.ltr.model, a.ltr.model)
    _eq(b.ltr.model.forest.leaf, ltr.model.forest.leaf.numpy())
    assert b._base_cfg.t_k == a._base_cfg.t_k
    assert b._base_cfg.t_time == a._base_cfg.t_time
    assert (json.loads(b.cascade_spec.to_json())["routing"]
            == json.loads(a.cascade_spec.to_json())["routing"])
    assert b._budget_reserve == a._budget_reserve
    for i in range(0, len(ql.terms), BATCH):
        sl = slice(i, i + BATCH)
        ra = a.serve(ql.terms[sl], ql.mask[sl], ql.topic[sl])
        rb = b.serve(ql.terms[sl], ql.mask[sl], ql.topic[sl])
        np.testing.assert_array_equal(rb.topk, ra.topk)
        np.testing.assert_array_equal(rb.final, ra.final)
        np.testing.assert_array_equal(rb.candidates_used, ra.candidates_used)
        np.testing.assert_array_equal(rb.latency, ra.latency)
        if b.dense is not None:
            for key in ("modality", "theta_skip", "fallback"):
                np.testing.assert_array_equal(rb.dense[key], ra.dense[key])
        for key in ("jass", "bmw", "hedged", "late_hedged", "over_budget"):
            assert rb.stats[key] == ra.stats[key], key
    assert b.stats()["scheduler"] == a.stats()["scheduler"]


def test_fit_with_labels_is_not_ported(port_collection, small_collection,
                                       ref_tower_params):
    """``fit(ql, labels)`` is ported: ``hybrid_fusion`` at 3 shards fitted
    on each package's own oracle labels gives the reference's forests, cost
    model, budget reservation and routing, then the same serve."""
    from repro.core.labels import LabelConfig as RefLabelConfig
    from repro.core.labels import generate_labels as ref_generate_labels
    from repro_torch.core.labels import LabelConfig, generate_labels
    corpus, index, ql = small_collection
    pcorpus, pindex = port_collection
    preset = ref_get_preset("hybrid_fusion")
    spec = dataclasses.replace(
        preset, backend=BackendSpec(backend="jnp"),
        deploy=dataclasses.replace(preset.deploy, n_shards=3))
    a = ref_build_system(spec, index, corpus=corpus)
    b = build_system(convert.cascade_spec(spec), pindex, corpus=pcorpus,
                     tower=convert.two_tower_params(ref_tower_params, "cpu"),
                     device="cpu")
    cfg = dict(max_k=512, batch=48, rho_grid=(512, 2048, 8192))
    a.fit(ql, ref_generate_labels(index, corpus, ql, RefLabelConfig(**cfg),
                                  cost=a.cost), seed=5)
    b.fit(ql, generate_labels(pindex, pcorpus, ql, LabelConfig(**cfg),
                              cost=b.cost), seed=5)
    for n in ("k", "rho", "t"):
        _assert_same_model(b.models[n], a.models[n])
    _assert_same_model(b.ltr.model, a.ltr.model)
    assert dataclasses.asdict(b.cost) == dataclasses.asdict(a.cost)
    assert b._budget_reserve == a._budget_reserve
    assert b.cascade_spec.to_json() == a.cascade_spec.to_json()
    ra = a.serve(ql.terms[:BATCH], ql.mask[:BATCH], ql.topic[:BATCH])
    rb = b.serve(ql.terms[:BATCH], ql.mask[:BATCH], ql.topic[:BATCH])
    for key in ("topk", "final", "latency"):
        np.testing.assert_array_equal(getattr(rb, key), getattr(ra, key))
    for key in ("modality", "theta_skip", "fallback"):
        np.testing.assert_array_equal(rb.dense[key], ra.dense[key])


# ---------------------------------------------------------------------------
# the BENCH_tail flow
# ---------------------------------------------------------------------------

def test_tail_flow_matches_reference_bench(monkeypatch):
    """``chip_smoke.tail_flow`` on the CPU against the reference's own
    ``run_tail`` (its artifact write stubbed out), figure for figure."""
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke
    from benchmarks import bench_tail
    monkeypatch.setattr(bench_tail, "write_bench_artifact",
                        lambda name, payload: None)
    want = bench_tail.run_tail()
    got = chip_smoke.tail_flow("cpu")
    assert got == chip_smoke.tail_figures(want)
    assert got["guarantee_holds"] and got["regression_demonstrated"]
