"""The fit's tree level (``level_split``, ``level_route``, ``build_trees``)
against the reference, bit for bit, on the CPU.

On the CPU the two level wrappers run their plain versions (the fit's torch
sequence on the host).  Every case holds them to the reference (JAX on the
CPU, ``build_tree`` under ``jit``, one compile a case through a module
fixture) at tolerance 0.0, level by level: each level's ``feat`` and
``thresh`` rows and the rows' nodes after it (the reference's final node
shifted right by the levels still to come).  The cases cover depths 1, 5
and 6, 16, 64, 100 and 256 bins, n = 37 and 4,097 (past the kernel's
4,096-row tile), equal gains across duplicated feature columns (the lowest
feature wins), dead nodes, a one-feature mask and rows of weight 0.
``build_trees`` with T trees equals T ``build_tree`` calls and the
reference's vmapped random forest.  The wrappers refuse bad shapes and, on
``meta`` tensors (the stand-in for device tensors, their checks run
without the device's), bad dtypes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.core import random_forest as ref_rf
from repro.core import trees as ref_trees
from repro_torch import kernels
from repro_torch.core import random_forest, trees
from repro_torch.kernels.level_histogram import ops as lh

# (name, depth, n_bins, n, case)
CASES = [
    ("d1_b16_n37", 1, 16, 37, "plain"),
    ("d1_b256_n4097", 1, 256, 4097, "zero_weights"),
    ("d5_b64_n4097", 5, 64, 4097, "ties"),
    ("d5_b100_n37", 5, 100, 37, "dead"),
    ("d5_b16_n4097", 5, 16, 4097, "one_feature"),
    ("d6_b256_n37", 6, 256, 37, "zero_weights"),
    ("d6_b100_n4097", 6, 100, 4097, "dead"),
    ("d6_b64_n4097", 6, 64, 4097, "masked"),
]
N_FEAT = 7
RF = dict(n=500, n_feat=12, n_trees=6, depth=4, seed=3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(depth, n_bins, n, case):
    rng = np.random.RandomState(depth * 1000 + n_bins + n)
    xb = rng.randint(0, n_bins, (n, N_FEAT)).astype(np.uint8)
    target = (rng.standard_cauchy(n) * 10.0).astype(np.float32)
    weight = rng.poisson(1.0, n).astype(np.float32)
    mask = np.ones(N_FEAT, bool)
    mcw = 10.0
    if case == "ties":
        # identical columns and a two-valued target: equal gains, the lowest
        # feature must win
        xb[:, 3] = xb[:, 1]
        xb[:, 5] = xb[:, 1]
        target = np.where(xb[:, 1] > n_bins // 2, 1.0, -1.0).astype(
            np.float32)
    elif case == "dead":
        # children lighter than min_child_weight: the deeper nodes cannot
        # split and pass every row left
        mcw = n / 12.0
    elif case == "one_feature":
        mask[:] = False
        mask[4] = True
    elif case == "zero_weights":
        weight[rng.rand(n) < 0.4] = 0.0
        target[::7] = -target[::7]
    elif case == "masked":
        mask[[0, 2]] = False
    params = ref_trees.TreeParams(depth=depth, n_bins=n_bins,
                                  min_child_weight=mcw)
    return xb, target, weight, mask, params


@pytest.fixture(scope="module")
def reference():
    """Each case's inputs and the reference's jitted ``build_tree``."""
    out = {}
    for name, depth, n_bins, n, case in CASES:
        xb, target, weight, mask, params = _inputs(depth, n_bins, n, case)
        want = jax.jit(ref_trees.build_tree, static_argnums=(4,))(
            jnp.asarray(xb), jnp.asarray(target), jnp.asarray(weight),
            jnp.asarray(mask), params)
        out[name] = ((xb, target, weight, mask, params),
                     tuple(np.asarray(a) for a in want))
    return out


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("name,depth,n_bins,n,case", CASES,
                         ids=[c[0] for c in CASES])
def test_level_matches_reference_level_by_level(reference, name, depth,
                                                n_bins, n, case):
    (xb, target, weight, mask, params), (feat, thresh, leaf) = \
        reference[name]
    xbt = _t(xb.T)
    node = torch.zeros((1, n), dtype=torch.int32)
    shape = (1, depth, 2 ** (depth - 1))
    got_f = torch.zeros(shape, dtype=torch.int32)
    got_t = torch.zeros(shape, dtype=torch.int32)
    for d in range(depth):
        gain, best = lh.level_split(
            xbt, node, _t(target), _t(weight[None]), _t(mask[None]),
            n_nodes=2 ** d, n_bins=n_bins, l2=params.l2,
            min_child_weight=params.min_child_weight)
        assert gain.shape == best.shape == (1, 2 ** d, N_FEAT)
        assert gain.dtype == torch.float32 and best.dtype == torch.int32
        lh.level_route(xbt, node, gain, best, got_f, got_t, level=d,
                       n_bins=n_bins)
        np.testing.assert_array_equal(got_f[0, d].numpy(), feat[d])
        np.testing.assert_array_equal(got_t[0, d].numpy(), thresh[d])
        np.testing.assert_array_equal(node[0].numpy(),
                                      leaf >> (depth - 1 - d))
    # and the whole builder
    for g, w in zip(trees.build_tree(xbt, _t(target), _t(weight), _t(mask),
                                     trees.TreeParams(*params)),
                    (feat, thresh, leaf)):
        np.testing.assert_array_equal(g.numpy(), w)
    if case == "ties":
        assert int(feat[0, 0]) == 1
    if case == "dead":
        assert ((feat[1:] == 0) & (thresh[1:] == n_bins - 1)).any()
    if case == "one_feature":
        assert set(np.unique(feat)) <= {0, 4}


def test_build_trees_equals_its_trees_and_the_reference_forest():
    rng = np.random.RandomState(RF["seed"])
    n, n_feat = RF["n"], RF["n_feat"]
    x = rng.lognormal(size=(n, n_feat)).astype(np.float32)
    y = (np.log1p(3 * x[:, 0] + x[:, 1]) + 0.3 * rng.randn(n)).astype(
        np.float32)
    p = random_forest.RFParams(n_trees=RF["n_trees"], depth=RF["depth"])
    xbt, yt, edges = trees.fit_inputs(x, y, p.n_bins, torch.device("cpu"))
    weights, fmask = random_forest.tree_draws(RF["seed"], n, n_feat, p)
    tp = trees.TreeParams(p.depth, p.n_bins, p.min_child_weight, p.l2)
    feat, thresh, leaf = trees.build_trees(xbt, yt, _t(weights), _t(fmask),
                                           tp)
    for i in range(p.n_trees):
        one = trees.build_tree(xbt, yt, _t(weights[i]), _t(fmask[i]), tp)
        for g, w in zip((feat[i], thresh[i], leaf[i]), one):
            np.testing.assert_array_equal(g.numpy(), w.numpy())
    forest = random_forest._fit_binned(xbt, yt, _t(weights), _t(fmask), p)
    ref_p = ref_rf.RFParams(n_trees=p.n_trees, depth=p.depth)
    want = ref_rf._fit_binned(jnp.asarray(xbt.T.numpy()), jnp.asarray(y),
                              ref_p, jax.random.PRNGKey(RF["seed"]))
    for field in ("feat", "thresh", "leaf"):
        got = getattr(forest, field).numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      np.asarray(getattr(want, field))
                                      .view(np.int32))
    # the leaves from one batched call equal the per-tree calls
    for i in range(p.n_trees):
        np.testing.assert_array_equal(
            trees.leaf_means(leaf[i], yt, _t(weights[i]), 2 ** p.depth,
                             p.l2).numpy(),
            forest.leaf[i].numpy())


def _split_args(device="cpu", **change):
    args = dict(xbt=torch.zeros((3, 10), dtype=torch.uint8, device=device),
                node=torch.zeros((2, 10), dtype=torch.int32, device=device),
                g=torch.zeros((10,), device=device),
                w=torch.zeros((2, 10), device=device),
                fmask=torch.ones((2, 3), dtype=torch.bool, device=device))
    args.update(change)
    return args


def _route_args(device="cpu", **change):
    args = dict(xbt=torch.zeros((3, 10), dtype=torch.uint8, device=device),
                node=torch.zeros((2, 10), dtype=torch.int32, device=device),
                gain=torch.zeros((2, 4, 3), device=device),
                best=torch.zeros((2, 4, 3), dtype=torch.int32,
                                 device=device),
                feat=torch.zeros((2, 3, 4), dtype=torch.int32, device=device),
                thresh=torch.zeros((2, 3, 4), dtype=torch.int32,
                                   device=device))
    args.update(change)
    return args


SPLIT_KW = dict(n_nodes=4, n_bins=64, l2=1.0, min_child_weight=10.0)


@pytest.mark.parametrize("change,kw", [
    (dict(node=torch.zeros((10,), dtype=torch.int32)), {}),
    (dict(node=torch.zeros((2, 9), dtype=torch.int32)), {}),
    (dict(g=torch.zeros((2, 10))), {}),
    (dict(w=torch.zeros((3, 10))), {}),
    (dict(fmask=torch.ones((2, 4), dtype=torch.bool)), {}),
    ({}, dict(n_bins=257)),
    ({}, dict(n_bins=0)),
    ({}, dict(n_nodes=0)),
])
def test_level_split_refuses_bad_shapes(change, kw):
    with pytest.raises(ValueError):
        lh.level_split(**_split_args(**change), **{**SPLIT_KW, **kw})


@pytest.mark.parametrize("change,kw", [
    (dict(node=torch.zeros((2, 9), dtype=torch.int32)), {}),
    (dict(gain=torch.zeros((2, 4, 5))), {}),
    (dict(best=torch.zeros((2, 3, 3), dtype=torch.int32)), {}),
    (dict(feat=torch.zeros((2, 3, 2), dtype=torch.int32),
          thresh=torch.zeros((2, 3, 2), dtype=torch.int32)), {}),
    (dict(thresh=torch.zeros((2, 3, 5), dtype=torch.int32)), {}),
    ({}, dict(level=3)),
    ({}, dict(n_bins=300)),
])
def test_level_route_refuses_bad_shapes(change, kw):
    with pytest.raises(ValueError):
        lh.level_route(**_route_args(**change), **{**dict(level=1, n_bins=64),
                                                   **kw})


@pytest.fixture
def dtypes_only(monkeypatch):
    """The wrappers' argument checks without the device's (``meta``
    tensors are not CUDA tensors), so that each dtype's refusal shows."""
    check = kernels.check_cuda_args
    monkeypatch.setattr(kernels, "check_cuda_args",
                        lambda name, args, dtypes: check(name, args, dtypes,
                                                         device=False))


@pytest.mark.parametrize("key,dtype", [("xbt", torch.int32),
                                       ("node", torch.int64),
                                       ("g", torch.float64),
                                       ("w", torch.bfloat16),
                                       ("fmask", torch.uint8)])
def test_level_split_refuses_bad_dtypes_off_the_cpu(key, dtype, dtypes_only):
    args = _split_args("meta")
    args[key] = args[key].to(dtype)
    with pytest.raises(ValueError, match=f"{key} must be"):
        lh.level_split(**args, **SPLIT_KW)


@pytest.mark.parametrize("key,dtype", [("node", torch.int64),
                                       ("gain", torch.float64),
                                       ("best", torch.int64),
                                       ("feat", torch.int64)])
def test_level_route_refuses_bad_dtypes_off_the_cpu(key, dtype, dtypes_only):
    args = _route_args("meta")
    args[key] = args[key].to(dtype)
    with pytest.raises(ValueError, match=f"{key} must be"):
        lh.level_route(**args, level=1, n_bins=64)
