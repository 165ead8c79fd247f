"""The port's tree-sum order against the reference at every tree count.

``repro_torch.core.trees._sum_trees`` reproduces the order in which the
reference's compiled reduction adds the trees' leaves, so boosted
predictions are bit-equal, not merely close: a route compares a prediction
with a threshold, and one ulp flips it.  Random forests of the repo's
depths (4 and 5) with leaves of mixed magnitude (1e-3, 1 and 1e3: every
association shows in the rounding) go through ``forest_predict_binned``
and ``forest_predict_stacked`` of both packages on the CPU.  A system fitted with few trees then routes
its queries as the reference does.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.configs.cascade_presets import get_preset as ref_get_preset
from repro.core import trees as ref_trees
from repro.serving.spec import BackendSpec
from repro.serving.system import build_system as ref_build_system
from repro_torch import convert
from repro_torch.core import features, gbrt, trees
from repro_torch.serving.scheduler import StageZeroScheduler
from repro_torch.serving.system import scheduler_config

DEPTHS = (4, 5)    # the repo's GBRTs: the LTR re-ranker's and Stage-0's
N_FEATURES = 20
N_BINS = 16
TREE_COUNTS = list(range(1, 41)) + [47, 48, 63, 64, 65, 72, 96, 100, 127, 128]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _forest(rng, shape, depth):
    """Random forest arrays of ``shape + (depth, ...)``, leaves whose
    magnitudes mix 1e-3, 1 and 1e3."""
    half = 2 ** (depth - 1)
    feat = rng.randint(0, N_FEATURES, shape + (depth, half)).astype(np.int32)
    thresh = rng.randint(0, N_BINS, shape + (depth, half)).astype(np.int32)
    scale = rng.choice([1e-3, 1.0, 1e3], shape + (2 * half,))
    leaf = (rng.randn(*shape, 2 * half) * scale).astype(np.float32)
    return feat, thresh, leaf


def _ref_forest(arrays):
    return ref_trees.Forest(*map(jnp.asarray, arrays))


def _forest_t(arrays):
    return trees.Forest(*map(torch.from_numpy, arrays))


@pytest.mark.parametrize("n_trees", TREE_COUNTS)
def test_tree_sum_is_bit_equal_to_reference(n_trees):
    rng = np.random.RandomState(n_trees)
    for depth in DEPTHS:
        arrays = _forest(rng, (n_trees,), depth)
        xb = rng.randint(0, N_BINS + 1, (2000, N_FEATURES)).astype(np.uint8)
        want = np.asarray(ref_trees.forest_predict_binned(
            _ref_forest(arrays), jnp.asarray(xb), depth))
        got = trees.forest_predict_binned(_forest_t(arrays),
                                          torch.from_numpy(xb), depth)
        np.testing.assert_array_equal(got.numpy(), want)

        stacked = _forest(rng, (3, n_trees), depth)
        xbs = rng.randint(0, N_BINS + 1,
                          (3, 500, N_FEATURES)).astype(np.uint8)
        want = np.asarray(ref_trees.forest_predict_stacked(
            _ref_forest(stacked), jnp.asarray(xbs), depth))
        got = trees.forest_predict_stacked(_forest_t(stacked),
                                           torch.from_numpy(xbs), depth)
        np.testing.assert_array_equal(got.numpy(), want)


def test_tree_sum_order_is_not_left_to_right():
    """The crafted case: 8 trees whose leaves are all 1, 2^24 or -2^24,
    placed where XLA's 8 lanes sum exactly and a left-to-right sum does
    not.  Both packages give 1 + (2^24 - 2^24) = 1; the row order would
    give (1 + 2^24) - 2^24 = 0."""
    depth = DEPTHS[0]
    half = 2 ** (depth - 1)
    vals = np.array([1.0, 2.0 ** 24, 0, 0, 0, -2.0 ** 24, 0, 0], np.float32)
    arrays = (np.zeros((8, depth, half), np.int32),
              np.zeros((8, depth, half), np.int32),
              np.repeat(vals[:, None], 2 * half, axis=1))
    xb = np.arange(4 * N_FEATURES, dtype=np.uint8).reshape(4, N_FEATURES)
    want = np.asarray(ref_trees.forest_predict_binned(
        _ref_forest(arrays), jnp.asarray(xb), depth))
    got = trees.forest_predict_binned(_forest_t(arrays),
                                      torch.from_numpy(xb), depth)
    np.testing.assert_array_equal(want, np.ones(4, np.float32))
    np.testing.assert_array_equal(got.numpy(), want)
    assert float(trees._seq_sum(torch.from_numpy(vals))) == 0.0


@pytest.mark.parametrize("n_trees", [16, 24])
def test_routes_from_few_tree_models_match_reference(small_collection,
                                                      n_trees):
    """A system fitted with at most 32 trees a model: the port's Stage-0
    predictions equal the reference's bit for bit, and so do the routes."""
    corpus, index, ql = small_collection
    spec = ref_get_preset("paper_200ms")
    spec = dataclasses.replace(
        spec, backend=BackendSpec(backend="jnp"),
        stage0=dataclasses.replace(spec.stage0, n_trees=n_trees))
    ref = ref_build_system(spec, index, corpus=corpus)
    ref.fit(ql, None, seed=5)
    pk, pr, pt = ref.stage0(ql.terms, ql.mask)

    models = convert.stage0_models(ref.models, "cpu")
    stacked, depth = gbrt.stack_models([models[n] for n in ("k", "rho", "t")])
    assert stacked.forest.leaf.shape[1] == n_trees
    x = features.extract(torch.from_numpy(index.term_stats),
                         torch.from_numpy(index.df),
                         torch.from_numpy(ql.terms),
                         torch.from_numpy(ql.mask))
    p = np.expm1(gbrt.predict_stacked(stacked, x, depth).numpy())
    for got, want in zip(p, (pk, pr, pt)):
        np.testing.assert_array_equal(got, want)

    cfg = scheduler_config(ref.cascade_spec.routing)
    a = StageZeroScheduler(cfg).route(pk, pr, pt)
    b = StageZeroScheduler(cfg).route(p[0], p[1], p[2])
    assert len(a.jass_rows) and len(a.bmw_rows)
    for f in ("jass_rows", "bmw_rows", "hedged_rows", "k", "rho"):
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f))
