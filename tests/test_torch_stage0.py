"""The port's Stage-0 inference against the reference.

A reference ``SearchSystem`` is fitted on the fixture (pseudo-labels, the
spec's GBRT shapes) and its models are carried over with
``repro_torch.convert``.  On the fixture's 96 queries: ``extract`` within
1e-6 and the *binned* features identical (a one-ulp feature difference
flips a bin against edges taken from the reference's own features),
``predict_stacked`` within 1e-5, and the scheduler's routes identical.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.configs.cascade_presets import get_preset as ref_get_preset
from repro.core import features as ref_features
from repro.core import gbrt as ref_gbrt
from repro.core import trees as ref_trees
from repro.serving.spec import BackendSpec
from repro.serving.system import build_system as ref_build_system
from repro_torch import convert
from repro_torch.core import features, gbrt, trees
from repro_torch.serving.scheduler import StageZeroScheduler
from repro_torch.serving.system import scheduler_config


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side, and
    torch's thread pool contending with them and with JAX's costs far more
    than it gains at these sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fitted(small_collection):
    corpus, index, ql = small_collection
    spec = dataclasses.replace(ref_get_preset("paper_200ms"),
                               backend=BackendSpec(backend="jnp"))
    ref = ref_build_system(spec, index, corpus=corpus)
    ref.fit(ql, None, seed=5)
    x_ref = np.asarray(ref_features.extract(
        jnp.asarray(index.term_stats), jnp.asarray(index.df),
        jnp.asarray(ql.terms), jnp.asarray(ql.mask)))
    x = features.extract(torch.from_numpy(index.term_stats),
                         torch.from_numpy(index.df),
                         torch.from_numpy(ql.terms),
                         torch.from_numpy(ql.mask))
    return index, ql, ref, x_ref, x, convert.stage0_models(ref.models, "cpu")


def test_extract_matches_reference(fitted):
    _, _, _, x_ref, x, _ = fitted
    assert x.dtype == torch.float32 and x.shape == (96, features.N_FEATURES)
    np.testing.assert_allclose(x.numpy(), x_ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["k", "rho", "t"])
def test_binned_features_identical(fitted, name):
    _, _, ref, x_ref, x, models = fitted
    want = np.asarray(ref_trees.apply_bins(jnp.asarray(x_ref),
                                           ref.models[name].bin_edges))
    got = trees.apply_bins(x, models[name].bin_edges)
    np.testing.assert_array_equal(got.numpy(), want)


def test_xla_log1p_matches_reference_log1p():
    """The features' log1p is the reference's float32 log1p bit for bit,
    on integer counts (the features' inputs) and on general floats."""
    rng = np.random.RandomState(0)
    x = np.concatenate([np.arange(0, 200_000, dtype=np.float32),
                        rng.lognormal(0, 4, 50_000).astype(np.float32),
                        (rng.rand(50_000) * 1.8 - 0.9).astype(np.float32)])
    want = np.asarray(jnp.log1p(jnp.asarray(x)))
    got = features.xla_log1p(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


def test_predict_stacked_matches_reference(fitted):
    _, _, ref, x_ref, x, models = fitted
    want = np.asarray(ref_gbrt.predict_stacked(
        ref._stacked, jnp.asarray(x_ref), ref._stack_depth))
    stacked, depth = gbrt.stack_models([models[n] for n in ("k", "rho", "t")])
    got = gbrt.predict_stacked(stacked, x, depth)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    for i, n in enumerate(("k", "rho", "t")):
        one = gbrt.predict(models[n], x)
        np.testing.assert_allclose(one.numpy(), want[i], rtol=0, atol=1e-5)


def test_routes_identical(fitted):
    _, ql, ref, _, _, models = fitted
    pk, pr, pt = ref.stage0(ql.terms, ql.mask)
    stacked, depth = gbrt.stack_models([models[n] for n in ("k", "rho", "t")])
    x = features.extract(torch.from_numpy(ref.index.term_stats),
                         torch.from_numpy(ref.index.df),
                         torch.from_numpy(ql.terms),
                         torch.from_numpy(ql.mask))
    p = np.expm1(gbrt.predict_stacked(stacked, x, depth).numpy())
    cfg = scheduler_config(ref.cascade_spec.routing)
    a = StageZeroScheduler(cfg).route(pk, pr, pt)
    b = StageZeroScheduler(cfg).route(p[0], p[1], p[2])
    assert len(a.jass_rows) and len(a.bmw_rows)
    for f in ("jass_rows", "bmw_rows", "hedged_rows", "k", "rho"):
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f))
