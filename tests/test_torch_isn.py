"""The port's distributed ISN step (``repro_torch.isn.shard``,
``repro_torch.launch.mesh``, ``repro_torch.configs.paper_isn``) against
the reference.

* At the (1, 1) mesh over gloo, ``hybrid_serve_fn`` equals the reference's
  ``shard_map`` step (one compile, three forests of one shape: all JASS,
  all BMW, and a seeded forest with mixed routes and ρ strictly inside
  (1,024, ρ_max)) on ``small_collection``: ids, work and routes exact,
  SAAT rows' scores exact, BMW rows' within 1e-4.
* Stage-0 (``_stage0``: features, ``_forest_predict``, ``xla_expm1``) is
  bit-equal to the reference's compiled one, each target's raw predictions
  (``stage0_forest`` on its slice of the stack) to the reference's
  ``_forest_predict`` at five tree counts, ``xla_expm1`` / ``xla_exp`` to
  jitted ``jnp.expm1`` / ``jnp.exp``.
* At (1, 2) over 2 spawned gloo ranks and (2, 2) over 4, the step equals
  the port's world-size-1 step on each shard merged by
  ``merge_shard_topk``; the reference cannot run at two devices on the
  CPU (ROADMAP §3), so the multi-rank runs are held to that oracle.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import paper_isn as ref_paper_isn
from repro.core import features as ref_features
from repro.index.postings import shard_from_index as ref_shard_from_index
from repro.isn import shard as ref_shard
from repro_torch import convert
from repro_torch.configs import paper_isn
from repro_torch.core import features, gbrt
from repro_torch.index.builder import build_index
from repro_torch.index.corpus import CorpusParams, build_corpus
from repro_torch.index.postings import shard_layouts, shard_to_device
from repro_torch.isn import shard
from repro_torch.isn.backend import merge_shard_topk
from repro_torch.kernels.stage0 import ops as s0
from repro_torch.launch import mesh as port_mesh

from torch_isn_ranks import run_ranks

Q = 16
T_TREES, DEPTH = 48, 5
STEP = dict(k_shard=64, k_global=64, rho_max=4096, t_k=1000.0, t_time=150.0,
            forest_depth=DEPTH)
FORESTS = ("jass", "bmw", "mixed")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def local_mesh():
    """The (1, 1) gloo mesh of this process, its group ended after."""
    mesh = port_mesh.make_local_mesh(device="cpu")
    yield mesh
    torch.distributed.destroy_process_group()


def _identity_forest(const, n_trees=T_TREES):
    """A forest predicting ``const`` for every target (as
    ``tests/test_isn_shard.py``'s)."""
    w = 2 ** (DEPTH - 1)
    return dict(feat=np.zeros((3, n_trees, DEPTH, w), np.int32),
                thresh=np.full((3, n_trees, DEPTH, w), 64, np.int32),
                leaf=np.zeros((3, n_trees, 2 ** DEPTH), np.float32),
                base=np.full((3,), const, np.float32),
                bin_edges=np.full((147, 63), 1e30, np.float32))


def _seeded_forest(x, n_trees=T_TREES, seed=0):
    """Random trees over bin edges taken as quantiles of the features
    ``x``; bases near log1p of t_k (1,000), of ρ inside (1,024, 4,096) and
    of t below t_time (150), so routes and ρ spread."""
    rng = np.random.RandomState(seed)
    w = 2 ** (DEPTH - 1)
    qs = np.linspace(0.0, 100.0, 65)[1:-1]
    edges = np.percentile(x, qs, axis=0).T.astype(np.float32)
    edges = np.maximum.accumulate(edges + 1e-6 * np.arange(63), axis=1)
    return dict(
        feat=rng.randint(0, 147, (3, n_trees, DEPTH, w)).astype(np.int32),
        thresh=rng.randint(0, 63, (3, n_trees, DEPTH, w)).astype(np.int32),
        leaf=rng.normal(0.0, 0.05, (3, n_trees, 2 ** DEPTH))
        .astype(np.float32),
        base=np.log1p(np.array([1000.0, 2000.0, 100.0])).astype(np.float32),
        bin_edges=edges.astype(np.float32))


def _ref_fa(f):
    return ref_shard.ForestArrays(**{k: jnp.asarray(v) for k, v in f.items()})


def _port_fa(f):
    return shard.ForestArrays(**{k: torch.from_numpy(v) for k, v in
                                 f.items()})


@pytest.fixture(scope="module")
def setup(small_collection):
    corpus, index, ql = small_collection
    ref, spec = ref_shard_from_index(index)
    stacked = jax.tree.map(lambda a: a[None], ref)
    ts = jnp.asarray(index.term_stats)[None]
    x = np.asarray(jax.jit(ref_features.extract)(
        jnp.asarray(index.term_stats), ref.df, jnp.asarray(ql.terms),
        jnp.asarray(ql.mask)))
    forests = {"jass": _identity_forest(12.0), "bmw": _identity_forest(0.0),
               "mixed": _seeded_forest(x)}
    sizes = dict(n_docs_shard=spec.n_docs, n_model=1,
                 daat_cap=spec.max_df, daat_bcap=spec.max_blocks_per_term,
                 n_blocks=spec.n_blocks, block_size=spec.block_size, **STEP)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    fn = jax.jit(ref_shard.hybrid_serve_fn(mesh, **sizes))
    terms, mask = jnp.asarray(ql.terms[:Q]), jnp.asarray(ql.mask[:Q])
    want = {}
    with mesh:
        for name, f in forests.items():
            want[name] = [np.asarray(a) for a in
                          fn(stacked, _ref_fa(f), ts, terms, mask)]
    return dict(index=index, ql=ql, ref=ref, spec=spec, stacked=stacked,
                ts=ts, x=x, forests=forests, sizes=sizes, want=want)


def _port_step(mesh, setup, fa):
    serve = shard.hybrid_serve_fn(mesh, **setup["sizes"])
    pieces = shard.rank_inputs(mesh, setup["stacked"], setup["ts"],
                               setup["ql"].terms[:Q], setup["ql"].mask[:Q])
    s, ts, terms, mask = pieces
    return [t.numpy() for t in serve(s, fa, ts, terms, mask)]


def _assert_step_equal(got, want):
    ids, sc, work, route = got
    assert ids.dtype == np.int32 and sc.dtype == np.float32
    assert work.dtype == want[2].dtype and route.dtype == np.bool_
    np.testing.assert_array_equal(route, want[3])
    np.testing.assert_array_equal(work, want[2])
    np.testing.assert_array_equal(ids, want[0])
    np.testing.assert_array_equal(sc[route], want[1][route])
    np.testing.assert_allclose(sc[~route], want[1][~route], rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("forest", FORESTS)
def test_step_matches_reference(setup, local_mesh, forest):
    want = setup["want"][forest]
    got = _port_step(local_mesh, setup, _port_fa(setup["forests"][forest]))
    _assert_step_equal(got, want)
    route, work = want[3], want[2]
    if forest == "jass":
        assert route.all()
    elif forest == "bmw":
        assert not route.any()
    else:
        assert 0 < route.sum() < Q
    if route.any():
        assert work[route].max() <= STEP["rho_max"]


@pytest.mark.parametrize("forest", FORESTS)
def test_stage0_bit_equal_to_reference(setup, forest):
    f = setup["forests"][forest]
    index, ref, ql = setup["index"], setup["ref"], setup["ql"]
    want = jax.jit(ref_shard._stage0, static_argnames="depth")(
        _ref_fa(f), jnp.asarray(index.term_stats), ref.df,
        jnp.asarray(ql.terms[:Q]), jnp.asarray(ql.mask[:Q]), depth=DEPTH)
    got = shard._stage0(_port_fa(f), torch.from_numpy(index.term_stats),
                        torch.from_numpy(np.array(ref.df)),
                        torch.from_numpy(ql.terms[:Q]),
                        torch.from_numpy(ql.mask[:Q]), DEPTH)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy().view(np.int32),
                                      np.asarray(w).view(np.int32))
    if forest == "mixed":
        pk, prho, pt = (np.asarray(a) for a in want)
        assert ((pk > 1000) | (pt > 150)).any() and not \
            ((pk > 1000) | (pt > 150)).all()
        rho = np.clip(prho, 1024, STEP["rho_max"])
        inside = (rho > 1024) & (rho < STEP["rho_max"])
        assert inside.sum() >= Q // 2 and len(np.unique(rho[inside])) > 4


def _target_predict(fa, x, target):
    """Target ``target``'s raw (Q,) predictions: ``stage0_forest`` on its
    slice of the stack, without the step's ``xla_expm1``."""
    t = slice(target, target + 1)
    return s0.stage0_forest(x, fa.bin_edges, fa.feat[t], fa.thresh[t],
                            fa.leaf[t], fa.base[t], depth=DEPTH)[0]


@pytest.mark.parametrize("n_trees", [4, 16, 33, 48, 64])
def test_forest_predict_bit_equal_to_reference(setup, n_trees):
    f = _seeded_forest(setup["x"], n_trees, seed=n_trees)
    x = setup["x"]
    for target in range(3):
        want = jax.jit(ref_shard._forest_predict,
                       static_argnames=("target", "depth"))(
            _ref_fa(f), jnp.asarray(x), target=target, depth=DEPTH)
        got = _target_predict(_port_fa(f), torch.from_numpy(x), target)
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      np.asarray(want).view(np.int32))


def _expm1_inputs():
    rng = np.random.RandomState(0)
    tiny = np.float32(np.finfo(np.float32).tiny)
    edge = np.array([0.0, -0.0, 1e-45, -1e-45, 1e-40, -1e-40, tiny, -tiny,
                     2 * tiny, 3e-38, -3e-38, 0.5, -0.5,
                     np.nextafter(np.float32(0.5), np.float32(1)),
                     np.nextafter(np.float32(0.5), np.float32(0)),
                     0.0004, -0.0004, 0.0008, 88.7, -88.7, 88.72, 88.73,
                     -87.3, -87.4, 89.0, -89.0, 16.0, -16.0, np.inf, -np.inf,
                     np.nan], np.float32)
    sweep = np.concatenate([
        rng.uniform(lo, hi, n).astype(np.float32) for lo, hi, n in
        ((-2, 13, 1 << 19), (-0.5, 0.5, 1 << 18), (-1e-3, 1e-3, 1 << 16),
         (-100, 100, 1 << 16))] + [
        # every 4,099th float32 bit pattern: both signs, every exponent
        np.arange(0, 1 << 32, 4099, dtype=np.uint64).astype(np.uint32)
        .view(np.float32)])
    assert len(sweep) >= 1 << 20
    return edge, sweep


def _same_bits(got, want):
    both_nan = np.isnan(got) & np.isnan(want)
    bad = (got.view(np.int32) != want.view(np.int32)) & ~both_nan
    assert not bad.any(), (np.flatnonzero(bad)[:10], got[bad][:10],
                           want[bad][:10])


@pytest.mark.parametrize("name", ["expm1", "exp"])
def test_xla_exp_functions_bit_equal_to_jnp(name):
    port = {"expm1": features.xla_expm1, "exp": features.xla_exp}[name]
    ref = jax.jit(getattr(jnp, name))
    for x in _expm1_inputs():
        _same_bits(port(torch.from_numpy(x)).numpy(), np.asarray(ref(x)))


def test_converted_forest_gives_the_same_step(setup, local_mesh):
    f = setup["forests"]["mixed"]
    fa = convert.forest_arrays(_ref_fa(f), device="cpu")
    for field in shard.ForestArrays._fields:
        a, b = getattr(fa, field), torch.from_numpy(f[field])
        assert a.dtype == b.dtype and torch.equal(a, b), field
    _assert_step_equal(_port_step(local_mesh, setup, fa),
                       setup["want"]["mixed"])


def test_paper_isn_matches_reference():
    assert paper_isn.FAMILY == ref_paper_isn.FAMILY
    for name in ("CONFIG", "REDUCED"):
        assert dataclasses.asdict(getattr(paper_isn, name)) == \
            dataclasses.asdict(getattr(ref_paper_isn, name))
    assert dataclasses.asdict(paper_isn.ISNConfig()) == \
        dataclasses.asdict(ref_paper_isn.ISNConfig())


def test_forest_specs_match_reference():
    for kw in ({}, dict(n_trees=48), dict(depth=4, n_bins=32)):
        want = ref_shard.forest_specs(**kw)
        got = shard.forest_specs(**kw)
        for w, g in zip(want, got):
            assert g.device.type == "meta"
            assert tuple(g.shape) == w.shape
            assert str(g.dtype).split(".")[-1] == str(w.dtype)


def test_meshes_refuse_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_mesh.make_local_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_mesh.make_production_mesh()
    assert port_mesh.backend_for(torch.device("cpu")) == "gloo"
    assert port_mesh.backend_for(torch.device("cuda")) == "nccl"


def test_local_mesh_info(local_mesh):
    assert port_mesh.mesh_info(local_mesh) == {
        "axes": {"data": 1, "model": 1}, "n_devices": 1}
    assert local_mesh.device_type == "cpu"
    assert torch.distributed.get_backend() == "gloo"


def test_step_refuses_bad_sizes(setup, local_mesh):
    sizes = dict(setup["sizes"])
    with pytest.raises(ValueError, match="model axis"):
        shard.hybrid_serve_fn(local_mesh, **{**sizes, "n_model": 2})
    with pytest.raises(ValueError, match="k_global"):
        shard.hybrid_serve_fn(local_mesh, **{**sizes, "k_global": 65})
    with pytest.raises(ValueError, match="backend"):
        shard.hybrid_serve_fn(local_mesh, **sizes, backend="cuda")


def test_stage0_forest_stacks_fitted_models():
    rng = np.random.RandomState(4)
    x = rng.rand(256, 147).astype(np.float32)
    p = gbrt.GBRTParams(n_trees=4, depth=DEPTH, min_child_weight=5.0)
    models = {n: gbrt.fit(x, rng.rand(256).astype(np.float32), p,
                          device="cpu") for n in ("k", "rho", "t")}
    fa = shard.stage0_forest(models)
    for field, spec in zip(fa, shard.forest_specs(n_trees=4)):
        assert field.shape == spec.shape and field.dtype == spec.dtype
    for i, n in enumerate(("k", "rho", "t")):
        assert torch.equal(fa.leaf[i], models[n].forest.leaf)
        want = gbrt.predict(models[n], torch.from_numpy(x))
        got = _target_predict(fa, torch.from_numpy(x), i)
        assert torch.equal(got, want)
    moved = models["rho"]._replace(bin_edges=models["rho"].bin_edges + 1.0)
    with pytest.raises(ValueError, match="'rho'"):
        shard.stage0_forest({**models, "rho": moved})


# ---------------------------------------------------------------------------
# several ranks: spawned gloo processes against the per-shard oracle
# ---------------------------------------------------------------------------

N_SHARDS = 2
K_GLOBAL = 96


@pytest.fixture(scope="module")
def multi(setup, local_mesh, tmp_path_factory):
    """The (1, 2) and (2, 2) runs, and the oracle: the world-size-1 step on
    each shard, ids globalized by s · n_docs_shard, merged by
    ``merge_shard_topk`` at k_global, shard 0's work and routes."""
    corpus = build_corpus(CorpusParams(n_docs=4096, vocab=2048,
                                       avg_doclen=80, zipf_a=1.05, seed=3))
    index = build_index(corpus, stop_k=8)
    layouts = shard_layouts(index, N_SHARDS)
    specs = [l.spec for l in layouts]
    assert len({s.n_docs for s in specs}) == 1
    sizes = dict(n_docs_shard=specs[0].n_docs, n_model=N_SHARDS,
                 daat_cap=max(s.max_df for s in specs),
                 daat_bcap=max(s.max_blocks_per_term for s in specs),
                 n_blocks=specs[0].n_blocks, block_size=specs[0].block_size,
                 **{**STEP, "k_global": K_GLOBAL})
    f = setup["forests"]["mixed"]
    ql = setup["ql"]
    terms, mask = ql.terms[:Q], ql.mask[:Q]
    ts = index.term_stats.astype(np.float32)

    one = {**sizes, "n_model": 1, "k_global": STEP["k_shard"]}
    parts = []
    for s, layout in enumerate(layouts):
        sh, _ = shard_to_device(layout, "cpu")
        out = shard.hybrid_serve_fn(local_mesh, **one)(
            sh, _port_fa(f), torch.from_numpy(ts), torch.from_numpy(terms),
            torch.from_numpy(mask))
        parts.append(out)
    ids, sc = merge_shard_topk(
        [p[1] for p in parts],
        [p[0] + s * sizes["n_docs_shard"] for s, p in enumerate(parts)],
        K_GLOBAL)
    oracle = dict(ids=ids.numpy(), scores=sc.numpy(),
                  work=parts[0][2].numpy(), route=parts[0][3].numpy())

    fa = tuple(f[k] for k in shard.ForestArrays._fields)
    runs = {world: run_ranks(world, N_SHARDS,
                             tmp_path_factory.mktemp(f"ranks{world}"),
                             layouts, fa, ts, terms, mask, sizes)
            for world in (2, 4)}
    return dict(oracle=oracle, runs=runs, n_docs_shard=sizes["n_docs_shard"])


def _rows(ranks, data):
    """The outputs of the data rank ``data`` (model rank 0's, after
    checking every model rank holds the same)."""
    mine = [r for r in ranks if r["coord"][0] == data]
    for r in mine[1:]:
        for key in ("ids", "scores", "work", "route"):
            np.testing.assert_array_equal(r[key], mine[0][key])
    return mine[0]


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_match_merged_shards(multi, world):
    ranks = multi["runs"][world]
    n_data = world // N_SHARDS
    assert sorted(tuple(r["coord"]) for r in ranks) == \
        [(d, m) for d in range(n_data) for m in range(N_SHARDS)]
    got = {key: np.concatenate([_rows(ranks, d)[key]
                                for d in range(n_data)])
           for key in ("ids", "scores", "work", "route")}
    want = multi["oracle"]
    assert got["ids"].dtype == np.int32 and got["work"].dtype == np.int32
    for key in ("ids", "scores", "work", "route"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert 0 < want["route"].sum() < Q


def test_data_halves_join_to_the_one_row_run(multi):
    four, two = multi["runs"][4], multi["runs"][2]
    for key in ("ids", "scores", "work", "route"):
        np.testing.assert_array_equal(
            np.concatenate([_rows(four, 0)[key], _rows(four, 1)[key]]),
            _rows(two, 0)[key])


def test_merge_breaks_score_ties_toward_the_lower_rank(multi):
    r = _rows(multi["runs"][2], 0)
    ids, sc, n = r["ids"], r["scores"], multi["n_docs_shard"]
    tie = sc[:, 1:] == sc[:, :-1]
    across = tie & (ids[:, :-1] < n) & (ids[:, 1:] >= n)
    backwards = tie & (ids[:, :-1] >= n) & (ids[:, 1:] < n)
    assert across.any() and not backwards.any()
