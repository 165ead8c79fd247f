"""Stage-0's two kernel wrappers (``repro_torch.kernels.stage0``).

On the CPU each wrapper runs its plain version, here held to the reference:

* ``stage0_features`` on the fixture of ``tests/test_torch_stage0.py``
  (the reference system's fit): bit-equal to ``features.extract``, within
  1e-6 of the reference's compiled features and binned identically;
* ``stage0_forest`` with per-model edges: bit-equal to
  ``gbrt.predict_stacked``, within 1e-5 of the reference's; with the
  ISN step's shared edges and ``expm1``: bit-equal to the reference's
  compiled ``_stage0`` and to the port's;
* the sum over the trees at 10 tree counts (every ``_sum_trees`` branch) and
  depths 3 to 5, per-model and shared edges: bit-equal to the reference's
  compiled ``forest_predict_stacked`` plus the base; and a mirror of the
  kernel's in-place tree sum (``stage0.cu``'s ``tree_sum``) equal to
  ``trees._sum_trees`` up to tens of thousands of trees;
* where +0.0 ties -0.0, the reference's max gives +0.0 and its min -0.0
  in either order, and so does the features' plain version, statistics
  and least df alike (the rule the kernel keeps too);
* the two call sites, ``SearchSystem.stage0`` and the ISN step's
  ``_stage0``, reach the wrappers once each (raw predictions, and through
  ``xla_expm1``).

On the card (marked ``card``; skips without one): the launch counts of both
kernels equal the count of the program's ``stage0`` spans over served
batches of the cascade and steps of the ISN step.  JAX is imported only
inside the CPU tests' fixtures, so on a machine without it:

    python -m pytest --noconftest -m card tests/test_torch_stage0_kernels.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels
from repro_torch.core import features, gbrt, trees
from repro_torch.isn import shard
from repro_torch.kernels.stage0 import ops as s0

TREES = (1, 8, 12, 16, 24, 32, 33, 48, 64, 100)
DEPTHS = (3, 4, 5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fitted(small_collection):
    import test_torch_stage0
    return test_torch_stage0.fit_reference(small_collection)


def _args(index, ql):
    return (torch.from_numpy(index.term_stats), torch.from_numpy(index.df),
            torch.from_numpy(ql.terms), torch.from_numpy(ql.mask))


def _bits(t):
    return np.asarray(t).view(np.int32)


@pytest.mark.parametrize("name", ["k", "rho", "t"])
def test_features_plain_path_matches_reference(fitted, name):
    index, ql, ref, x_ref, x, models = fitted
    got = s0.stage0_features(*_args(index, ql))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(x.numpy()))
    np.testing.assert_allclose(got.numpy(), x_ref, rtol=0, atol=1e-6)
    from repro.core import trees as ref_trees
    import jax.numpy as jnp
    want = np.asarray(ref_trees.apply_bins(jnp.asarray(x_ref),
                                           ref.models[name].bin_edges))
    np.testing.assert_array_equal(
        trees.apply_bins(got, models[name].bin_edges).numpy(), want)


def test_stacked_predictions_plain_path(fitted):
    import jax.numpy as jnp
    from repro.core import gbrt as ref_gbrt
    _, _, ref, x_ref, x, models = fitted
    stacked, depth = gbrt.stack_models([models[n] for n in ("k", "rho", "t")])
    f = stacked.forest
    got = s0.stage0_forest(x, stacked.bin_edges, f.feat, f.thresh, f.leaf,
                           stacked.base, depth=depth)
    np.testing.assert_array_equal(
        _bits(got.numpy()),
        _bits(gbrt.predict_stacked(stacked, x, depth).numpy()))
    want = np.asarray(ref_gbrt.predict_stacked(
        ref._stacked, jnp.asarray(x_ref), ref._stack_depth))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_isn_expm1_predictions_match_reference(fitted):
    import jax
    import jax.numpy as jnp
    from repro.isn import shard as ref_shard
    index, ql, _, _, _, models = fitted
    fa = shard.stage0_forest(models)
    args = _args(index, ql)
    x = features.extract(*args)
    got = s0.stage0_forest(x, fa.bin_edges, fa.feat, fa.thresh, fa.leaf,
                           fa.base, depth=5, expm1=True)
    ref_fa = ref_shard.ForestArrays(*(jnp.asarray(a.numpy()) for a in fa))
    want = jax.jit(ref_shard._stage0, static_argnames="depth")(
        ref_fa, jnp.asarray(index.term_stats), jnp.asarray(index.df),
        jnp.asarray(ql.terms), jnp.asarray(ql.mask), depth=5)
    port = shard._stage0(fa, *args, 5)
    for i in range(3):
        np.testing.assert_array_equal(_bits(got[i].numpy()),
                                      _bits(np.asarray(want[i])))
        np.testing.assert_array_equal(_bits(got[i].numpy()),
                                      _bits(port[i].numpy()))


def _seeded_stack(n_trees, depth, shared, seed, n=40, n_feat=147):
    """Three seeded forests, features and bin edges (per model or shared);
    leaves of mixed magnitudes, so the order of the sum shows."""
    rng = np.random.RandomState(seed)
    w = 2 ** (depth - 1)
    shape = (n_feat, 63) if shared else (3, n_feat, 63)
    return dict(
        x=rng.randn(n, n_feat).astype(np.float32),
        edges=np.sort(rng.randn(*shape).astype(np.float32), -1),
        feat=rng.randint(0, n_feat, (3, n_trees, depth, w)).astype(np.int32),
        thresh=rng.randint(0, 64, (3, n_trees, depth, w)).astype(np.int32),
        leaf=(rng.randn(3, n_trees, 2 ** depth)
              * 10.0 ** rng.uniform(-3, 1, (3, n_trees, 1))).astype(
                  np.float32),
        base=rng.randn(3).astype(np.float32))


@pytest.mark.parametrize("shared", [False, True], ids=["per_model",
                                                       "shared"])
@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("n_trees", TREES)
def test_forest_sum_order_matches_reference(n_trees, depth, shared):
    import jax.numpy as jnp
    from repro.core import trees as ref_trees
    f = _seeded_stack(n_trees, depth, shared, seed=n_trees * 10 + depth)
    t = {k: torch.from_numpy(v) for k, v in f.items()}
    got = s0.stage0_forest(t["x"], t["edges"], t["feat"], t["thresh"],
                           t["leaf"], t["base"], depth=depth)
    edges = f["edges"] if not shared else np.broadcast_to(
        f["edges"], (3,) + f["edges"].shape)
    xb = (f["x"][None, :, :, None] > edges[:, None]).sum(-1).astype(np.uint8)
    sums = np.asarray(ref_trees.forest_predict_stacked(
        ref_trees.Forest(*(jnp.asarray(f[k]) for k in
                           ("feat", "thresh", "leaf"))),
        jnp.asarray(xb), depth))
    want = f["base"][:, None] + sums
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def _kernel_tree_sum(leaves):
    """``stage0.cu``'s ``tree_sum`` step for step in float32 scalars: the
    8-lane sum up to 32 trees, else windows of 32 summed in place into the
    row's first slots, again until at most 32 window sums remain."""
    v = [np.float32(a) for a in leaves]
    t = len(v)

    def seq(n):
        s = v[0]
        for i in range(1, n):
            s = np.float32(s + v[i])
        return s
    if t <= 32:
        if t < 16 and t % 8:
            return seq(t)
        full = t // 8 * 8
        lanes = v[:8]
        for i in range(8, full, 8):
            lanes = [np.float32(a + b) for a, b in zip(lanes, v[i:i + 8])]
        w = 4
        while w >= 1:
            lanes = [np.float32(lanes[j] + lanes[j + w]) for j in range(w)]
            w //= 2
        s = lanes[0]
        for i in range(full, t):
            s = np.float32(s + v[i])
        return s
    while True:
        n = (t + 31) // 32
        lo = (n * 32 - t) // 2
        for w in range(n):
            s = np.float32(0.0)
            for k in range(32):
                i = w * 32 + k - lo
                x = v[i] if 0 <= i < t else np.float32(0.0)
                s = x if k == 0 else np.float32(s + x)
            v[w] = s
        if n <= 32:
            return seq(n)
        t = n


@pytest.mark.parametrize("n_trees", TREES + (7, 1024, 1025, 2000,
                                             33_000))
def test_kernel_tree_sum_mirrors_sum_trees(n_trees):
    rng = np.random.RandomState(n_trees)
    leaves = (rng.randn(n_trees) * 10.0 ** rng.uniform(-4, 2, n_trees)
              ).astype(np.float32)
    leaves[:: 5] = -0.0
    want = trees._sum_trees(torch.from_numpy(leaves)).numpy()
    got = np.float32(_kernel_tree_sum(leaves))
    assert _bits(np.array([got])) == _bits(np.array([want]))


@pytest.mark.parametrize("order", ["pos_first", "neg_first"])
def test_reference_max_min_break_zero_ties_by_sign(order):
    """Over masked statistics and dfs that tie +0.0 with -0.0, the
    reference's max is +0.0 and its min -0.0, in either order; the plain
    version gives the same bits."""
    import jax.numpy as jnp
    from repro.core import features as ref_features
    rows = [0, 1] if order == "pos_first" else [1, 0]
    stats = np.zeros((2, 36), np.float32)
    stats[1] = -0.0
    df = np.array([0.0, -0.0], np.float32)
    args = (stats, df, np.array([rows], np.int32), np.ones((1, 2), np.float32))
    x = np.asarray(ref_features.extract(*(jnp.asarray(a) for a in args)))
    assert not np.signbit(x[0, :36]).any()
    assert np.signbit(x[0, 36:72]).all()
    assert np.signbit(x[0, 146])
    got = s0.stage0_features(*(torch.from_numpy(a) for a in args))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(x))


def _tiny_system():
    from repro_torch.configs.cascade_presets import get_preset
    from repro_torch.index.builder import build_index
    from repro_torch.index.corpus import (CorpusParams, build_corpus,
                                          build_queries)
    corpus = build_corpus(CorpusParams(n_docs=512, vocab=256, avg_doclen=20,
                                       seed=2))
    index = build_index(corpus, stop_k=4)
    ql = build_queries(corpus, 64, stop_k=4, seed=3)
    return get_preset("paper_200ms"), corpus, index, ql


def test_call_sites_reach_the_wrappers(fitted, monkeypatch):
    from repro_torch.serving.system import build_system
    models = fitted[5]
    spec, corpus, index, ql = _tiny_system()
    system = build_system(spec, index, corpus=corpus, device="cpu")
    system.set_models(models)
    calls = []

    def spy(name):
        fn = getattr(s0, name)

        def wrapped(*args, **kw):
            calls.append((name, args[1].dim(), kw.get("expm1", False)))
            return fn(*args, **kw)
        monkeypatch.setattr(s0, name, wrapped)
    spy("stage0_features")
    spy("stage0_forest")
    pk, pr, pt = system.stage0(ql.terms[:8], ql.mask[:8])
    assert calls == [("stage0_features", 1, False),
                     ("stage0_forest", 3, False)]
    assert pk.shape == pr.shape == pt.shape == (8,)
    calls.clear()
    fa = shard.stage0_forest(models)
    out = shard._stage0(fa, system.term_stats, system.df,
                        torch.from_numpy(ql.terms[:8]),
                        torch.from_numpy(ql.mask[:8]), 5)
    assert calls == [("stage0_features", 1, False),
                     ("stage0_forest", 2, True)]
    assert len(out) == 3 and out[0].shape == (8,)


@pytest.mark.card
def test_launches_equal_stage0_spans_on_the_card():
    """Over 4 served batches of the cascade and 2 ISN steps on the card,
    each kernel launches once for every ``stage0`` span the program records
    (spans record while a profiler does)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.index.postings import shard_from_index
    from repro_torch.isn.shard import hybrid_serve_fn
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.serving.system import build_system
    from repro_torch.serving.telemetry import host
    spec, corpus, index, ql = _tiny_system()
    system = build_system(spec, index, corpus=corpus, device="cuda")
    system.fit(ql, None, seed=5)
    s, sspec = shard_from_index(index, device="cuda")
    ts = torch.from_numpy(index.term_stats).cuda()
    mesh = make_local_mesh(device="cuda")
    try:
        step = hybrid_serve_fn(
            mesh, n_docs_shard=sspec.n_docs, n_model=1, k_shard=16,
            k_global=16, rho_max=4096, daat_cap=sspec.max_df,
            daat_bcap=sspec.max_blocks_per_term, n_blocks=sspec.n_blocks,
            block_size=sspec.block_size, t_k=1000.0, t_time=150.0,
            tile_d=sspec.tile_d)
        fa = shard.stage0_forest(system.models)
        terms = torch.from_numpy(ql.terms).cuda()
        mask = torch.from_numpy(ql.mask).cuda()
        step(s, fa, ts, terms[:16], mask[:16])
        torch.cuda.synchronize()
        kernels.reset_launches()
        host.reset()
        with profile(activities=[ProfilerActivity.CPU]):
            for b in range(4):
                rows = slice(8 * b, 8 * b + 8)
                system.serve(ql.terms[rows], ql.mask[rows], ql.topic[rows])
            for b in range(2):
                rows = slice(16 * b, 16 * b + 16)
                step(s, fa, ts, terms[rows], mask[rows])
            torch.cuda.synchronize()
        n_spans = sum(r.name == "stage0" for r in host.records())
        assert n_spans == 6
        assert kernels.LAUNCHES["stage0_features"] == n_spans
        assert kernels.LAUNCHES["stage0_forest"] == n_spans
    finally:
        torch.distributed.destroy_process_group()
        kernels.reset_launches()
