"""GBRT column and row sampling (``colsample`` / ``subsample`` < 1) against
the reference, at tolerance 0.0.

``repro_torch.core.gbrt.fit`` draws each tree's feature mask and 0/1 row
weights from the seed as ``repro.core.gbrt._fit_binned`` draws them from
``jax.random`` (``core/prng``); the forests, the base and the predictions
must be the reference's bit for bit, under the L2 and the quantile loss, at
two seeds.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core import gbrt as ref_gbrt
from repro_torch.core import gbrt

N, N_FEAT, N_TREES = 512, 12, 16
SAMPLING = {"colsample": (0.5, 1.0), "subsample": (1.0, 0.7),
            "both": (0.5, 0.7)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(0)
    x = rng.randn(N, N_FEAT).astype(np.float32)
    y = (2.0 * x[:, 0] + np.sin(3.0 * x[:, 1]) + x[:, 2] * x[:, 3]
         + 0.1 * rng.randn(N)).astype(np.float32)
    return x, y


def _bits(a):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int32)


def _params(loss, sampling):
    cs, ss = SAMPLING[sampling]
    return gbrt.GBRTParams(n_trees=N_TREES, depth=5, min_child_weight=5.0,
                           loss=loss, tau=0.75, colsample=cs, subsample=ss)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("sampling", sorted(SAMPLING))
@pytest.mark.parametrize("loss", ["l2", "quantile"])
def test_sampled_fit_bit_equal_to_reference(data, loss, sampling, seed):
    x, y = data
    p = _params(loss, sampling)
    want = ref_gbrt.fit(x, y, ref_gbrt.GBRTParams(*p), seed=seed)
    got = gbrt.fit(x, y, p, seed=seed, device="cpu")
    for f in ("feat", "thresh", "leaf"):
        np.testing.assert_array_equal(_bits(getattr(got.forest, f)),
                                      _bits(getattr(want.forest, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(_bits(got.base), _bits(want.base))
    np.testing.assert_array_equal(_bits(got.bin_edges),
                                  _bits(want.bin_edges))
    np.testing.assert_array_equal(
        _bits(gbrt.predict(got, torch.from_numpy(x))),
        _bits(ref_gbrt.predict(want, jnp.asarray(x))))


@pytest.mark.parametrize("sampling", sorted(SAMPLING))
def test_sampling_changes_the_fit(data, sampling):
    """The draws reach the trees: a sampled fit differs from the unsampled
    one, and the masks are the fractions asked for, roughly."""
    x, y = data
    p = _params("l2", sampling)
    full = gbrt.fit(x, y, p._replace(colsample=1.0, subsample=1.0),
                    device="cpu")
    sampled = gbrt.fit(x, y, p, device="cpu")
    assert not torch.equal(full.forest.leaf, sampled.forest.leaf)
    fmask, w = gbrt.tree_draws(0, N, N_FEAT, p)
    assert fmask.shape == (N_TREES, N_FEAT) and fmask.dtype == np.bool_
    assert w.shape == (N_TREES, N) and w.dtype == np.float32
    assert fmask.all() == (p.colsample >= 1.0)
    assert (w == 1.0).all() == (p.subsample >= 1.0)
    if p.colsample < 1.0:
        assert 0.3 < fmask.mean() < 0.7
    if p.subsample < 1.0:
        assert set(np.unique(w)) == {0.0, 1.0} and 0.6 < w.mean() < 0.8
        # every tree leaves some rows out
        assert not (w == 1.0).all(axis=1).any()


def test_unsampled_fit_keeps_every_feature_and_row():
    fmask, w = gbrt.tree_draws(0, 100, 5, gbrt.GBRTParams(n_trees=4))
    assert fmask.shape == (4, 5) and fmask.all()
    assert w.shape == (4, 100) and (w == 1.0).all()
