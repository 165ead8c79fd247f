"""The port's dense modality against the reference's.

Kernel: ``repro_torch.kernels.dense_topk`` (on CPU tensors its plain
version) against the reference's ``dense_topk`` on its ``jnp`` backend and
its Pallas kernel in interpret mode, on grid-quantized embeddings with a
ragged doc count and embed width, exact ties and k ∈ {1, 33, 128}: scores
and ids equal bit for bit (the 1/64 grid makes every dot product exact).
Engine: ``DenseEngine.serve`` at 1 and 3 shards and with a ``drop`` mask,
equal to the reference engine and to the unsharded ``oracle``, and with
the live delta attached (``set_delta``; ``delta_doc_embeddings`` for both
sources) equal to the reference engine.  Fusion:
the hand cases of ``tests/test_dense.py``.  Embeddings: the synthetic
tables are equal; the tower forward with the reference's parameters
carried across by ``convert.two_tower_params`` is within 1e-6 of
``recsys.tower_embed`` before quantization, and the quantized tables on
the fixture collection differ in 0 entries.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs.two_tower_retrieval import REDUCED as REF_REDUCED
from repro.dense import DenseEngine as RefDenseEngine
from repro.dense import embeddings as ref_emb
from repro.dense import fusion as ref_fusion
from repro.index import corpus as ref_corpus
from repro.index.postings import shard_ranges as ref_shard_ranges
from repro.kernels.dense_topk import dense_topk as ref_dense_topk
from repro.models import recsys as ref_recsys
from repro.serving.spec import DenseSpec as RefDenseSpec
from repro_torch import convert
from repro_torch.dense import (DenseEngine, build_embeddings, embed_queries,
                               fusion, quantize, synthetic_embeddings)
from repro_torch.dense.embeddings import (delta_doc_embeddings,
                                          two_tower_embeddings)
from repro_torch.index.postings import shard_ranges
from repro_torch.kernels.dense_topk.ops import dense_topk, dense_topk_tiles
from repro_torch.serving.spec import DenseSpec


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
def small_dense():
    """1000 docs (not a multiple of any tile) of width 24, 32 queries."""
    doc_emb, table = ref_emb.synthetic_embeddings(1000, 256, d=24, seed=3)
    rng = np.random.RandomState(7)
    terms = rng.randint(0, 256, size=(32, 6))
    mask = np.ones((32, 6), np.float32)
    return doc_emb, table, ref_emb.embed_queries(table, terms, mask)


def _ref_topk(q_emb, doc_emb, k, backend, tile_d=512):
    sc, ids = ref_dense_topk(jnp.asarray(q_emb), jnp.asarray(doc_emb), k,
                             tile_d=tile_d, backend=backend)
    return np.asarray(sc), np.asarray(ids, np.int64)


# ---------------------------------------------------------------------------
# kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 33, 128])
@pytest.mark.parametrize("backend", ["jnp", "interpret"])
def test_dense_topk_matches_reference_bitwise(small_dense, k, backend):
    doc_emb, _, q_emb = small_dense
    want_sc, want_ids = _ref_topk(q_emb, doc_emb, k, backend)
    sc, ids = dense_topk(q_emb, torch.from_numpy(doc_emb), k)
    assert sc.dtype == torch.float32 and ids.dtype == torch.int64
    np.testing.assert_array_equal(sc.numpy(), want_sc)
    np.testing.assert_array_equal(ids.numpy(), want_ids)


@pytest.mark.parametrize("backend", ["jnp", "interpret"])
def test_dense_topk_ties_go_to_lower_doc_id(small_dense, backend):
    doc_emb, _, q_emb = small_dense
    dup = np.concatenate([doc_emb[:100]] * 3)      # every score 3x
    want_sc, want_ids = _ref_topk(q_emb, dup, 64, backend, tile_d=128)
    sc, ids = dense_topk(q_emb, torch.from_numpy(dup), 64)
    np.testing.assert_array_equal(sc.numpy(), want_sc)
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    # a tied group's copies come in id order: copy 0 before copies 1, 2
    first = ids.numpy()[:, 0]
    assert (first < 100).all()


def test_dense_topk_single_query_and_ragged_tail(small_dense):
    """Q = 1 and a doc count just past a power of two."""
    doc_emb, _, q_emb = small_dense
    docs = np.concatenate([doc_emb, doc_emb[:25]])     # 1025 docs
    want_sc, want_ids = _ref_topk(q_emb[:1], docs, 128, "interpret")
    sc, ids = dense_topk(q_emb[:1], torch.from_numpy(docs), 128)
    np.testing.assert_array_equal(sc.numpy(), want_sc)
    np.testing.assert_array_equal(ids.numpy(), want_ids)


def test_dense_topk_rejects_bad_k(small_dense):
    doc_emb, _, q_emb = small_dense
    emb = torch.from_numpy(doc_emb)
    q = torch.from_numpy(q_emb)
    for k in (0, -1, len(doc_emb) + 1):
        with pytest.raises(ValueError, match="k="):
            dense_topk_tiles(q, emb, k)
    with pytest.raises(ValueError, match="q_emb"):
        dense_topk_tiles(q[:, :5], emb, 4)
    # the whole collection is a valid k
    sc, ids = dense_topk_tiles(q, emb, len(doc_emb))
    assert sorted(ids[0].tolist()) == list(range(len(doc_emb)))


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_shards", [1, 3])
def test_engine_matches_reference_and_oracle(small_dense, n_shards):
    doc_emb, table, q_emb = small_dense
    ref = RefDenseEngine(doc_emb, table, ref_shard_ranges(1000, n_shards),
                         tile_d=128, backend="jnp")
    eng = DenseEngine(doc_emb, table, shard_ranges(1000, n_shards),
                      tile_d=128, device="cpu")
    assert [eng.n_tiles(s) for s in range(n_shards)] == \
        [ref.n_tiles(s) for s in range(n_shards)]
    assert eng.max_tiles() == ref.max_tiles()
    ids, sc = eng.serve(q_emb, 64)
    r_ids, r_sc = ref.serve(q_emb, 64)
    o_ids, o_sc = eng.oracle(q_emb, 64)
    assert ids.dtype == np.int64
    np.testing.assert_array_equal(ids, r_ids)
    np.testing.assert_array_equal(sc, r_sc)
    np.testing.assert_array_equal(ids, o_ids)
    np.testing.assert_array_equal(sc, o_sc)
    np.testing.assert_array_equal(eng.embed(*_terms(7)),
                                  ref.embed(*_terms(7)))


def _terms(seed):
    rng = np.random.RandomState(seed)
    terms = rng.randint(0, 256, size=(9, 5))
    mask = (rng.rand(9, 5) > 0.3).astype(np.float32)
    mask[0] = 0                                       # an empty query
    return terms, mask


def test_engine_drop_mask_matches_reference(small_dense):
    """Two shards, the second lost for half the queries: the reference's
    merge over the survivors, i.e. the oracle over shard 0's range."""
    doc_emb, table, q_emb = small_dense
    ref = RefDenseEngine(doc_emb, table, ref_shard_ranges(1000, 2),
                         tile_d=128, backend="jnp")
    eng = DenseEngine(doc_emb, table, shard_ranges(1000, 2), tile_d=128,
                      device="cpu")
    q = len(q_emb)
    drop = np.zeros((2, q), bool)
    drop[1, : q // 2] = True
    ids, sc = eng.serve(q_emb, 64, drop=drop)
    r_ids, r_sc = ref.serve(q_emb, 64, drop=drop)
    np.testing.assert_array_equal(ids, r_ids)
    np.testing.assert_array_equal(sc, r_sc)
    lo, hi = shard_ranges(1000, 2)[0]
    s_ids, s_sc = DenseEngine(doc_emb[lo:hi], table, [(lo, hi)],
                              device="cpu").oracle(q_emb[: q // 2], 64)
    np.testing.assert_array_equal(ids[: q // 2], s_ids + lo)
    np.testing.assert_array_equal(sc[: q // 2], s_sc)
    o_ids, _ = eng.oracle(q_emb, 64)
    np.testing.assert_array_equal(ids[q // 2:], o_ids[q // 2:])


def test_engine_single_shard_drop_masks_rows(small_dense):
    """One shard lost for a query leaves it no candidate: ids -1, scores
    float32-min (the reference's single-shard branch writes into a
    read-only array here, so the port is held to the oracle)."""
    doc_emb, table, q_emb = small_dense
    eng = DenseEngine(doc_emb, table, [(0, 1000)], device="cpu")
    q = len(q_emb)
    drop = np.zeros((1, q), bool)
    drop[0, ::3] = True
    ids, sc = eng.serve(q_emb, 64, drop=drop)
    o_ids, o_sc = eng.oracle(q_emb, 64)
    assert (ids[::3] == -1).all()
    assert (sc[::3] == np.finfo(np.float32).min).all()
    np.testing.assert_array_equal(ids[~drop[0]], o_ids[~drop[0]])
    np.testing.assert_array_equal(sc[~drop[0]], o_sc[~drop[0]])


@pytest.mark.parametrize("source", ["synthetic", "two_tower"])
def test_engine_delta_matches_reference(small_collection, tower_pair,
                                        source):
    """The live delta's dense rows (``delta_doc_embeddings``, the two-tower
    rows through the reference's tower carried across) equal the
    reference's, and ``set_delta`` serving (the capacity ranked whole,
    ghost rows masked, at 1 and 2 shards, with and without a drop mask)
    equals the reference engine's; ``clear_delta`` drops it."""
    corpus, _, ql = small_collection
    _, tower = tower_pair
    n, m, cap = corpus.n_docs, 24, 64
    spec = DenseSpec(enabled=True, source=source)
    rspec = RefDenseSpec(enabled=True, source=source)
    topics = ref_corpus.synthesize_feed_docs(corpus, m, seed=5).doc_topics
    rows = delta_doc_embeddings(spec, n_sealed=n, n_new=m,
                                vocab=corpus.vocab, topics=topics,
                                corpus=corpus, tower=tower)
    want = ref_emb.delta_doc_embeddings(rspec, n_sealed=n, n_new=m,
                                        vocab=corpus.vocab, topics=topics,
                                        corpus=corpus)
    np.testing.assert_array_equal(rows, want)
    sealed, table = ref_emb.build_embeddings(rspec, corpus, n_docs=n,
                                             vocab=corpus.vocab)
    pad = np.zeros((cap, sealed.shape[1]), np.float32)
    pad[:m] = rows
    q_emb = ref_emb.embed_queries(table, ql.terms, ql.mask)
    drop = np.zeros((2, len(q_emb)), bool)
    drop[0, ::3] = True
    for ranges in ([(0, n)], ref_shard_ranges(n, 2)):
        eng = DenseEngine(sealed, table, ranges, device="cpu")
        ref = RefDenseEngine(sealed, table, ranges)
        for e in (eng, ref):
            e.set_delta(pad, m, n)
        assert eng.delta_tiles() == ref.delta_tiles()
        for dr in (None, drop[:len(ranges)]):
            ids, sc = eng.serve(q_emb, 32, drop=dr)
            r_ids, r_sc = ref.serve(q_emb, 32, drop=dr)
            np.testing.assert_array_equal(ids, np.asarray(r_ids))
            np.testing.assert_array_equal(sc, np.asarray(r_sc))
            assert int(ids.max()) < n + m
        eng.clear_delta()
        assert eng.delta_tiles() == 0 and int(eng.serve(q_emb, 32)[0]
                                              .max()) < n


# ---------------------------------------------------------------------------
# fusion (the hand cases of tests/test_dense.py)
# ---------------------------------------------------------------------------


def _fusion_cases():
    return [
        ("rrf", dict(lex_ids=np.array([[10, 11, 12]]),
                     dense_ids=np.array([[20, 10, 21]]), k=5, k0=60.0)),
        ("rrf", dict(lex_ids=np.array([[5, -1, -1]]),
                     dense_ids=np.array([[-1, -1, -1]]), k=4)),
        ("weighted", dict(lex_ids=np.array([[1, 2, 3]]),
                          lex_sc=np.array([[9.0, 5.0, 1.0]]),
                          dense_ids=np.array([[3, 4, 5]]),
                          dense_sc=np.array([[0.9, 0.5, 0.1]]), k=3,
                          w_dense=1.0)),
        ("weighted", dict(lex_ids=np.array([[1, 2, 3]]),
                          lex_sc=np.array([[9.0, 5.0, 1.0]]),
                          dense_ids=np.array([[3, 4, 5]]),
                          dense_sc=np.array([[0.9, 0.5, 0.1]]), k=3,
                          w_dense=0.0)),
    ]


@pytest.mark.parametrize("case", range(4))
def test_fusion_matches_reference(case):
    method, kw = _fusion_cases()[case]
    fn = "rrf_fuse" if method == "rrf" else "weighted_fuse"
    ids, sc = getattr(fusion, fn)(**kw)
    r_ids, r_sc = getattr(ref_fusion, fn)(**kw)
    np.testing.assert_array_equal(ids, r_ids)
    np.testing.assert_array_equal(sc, r_sc)
    if case == 0:
        assert list(ids[0]) == [10, 20, 11, 12, 21]
    if case == 2:
        assert list(ids[0]) == [3, 4, 1]


def test_fuse_dispatch_matches_reference_on_random_lists():
    rng = np.random.RandomState(4)
    lex = rng.randint(0, 60, (6, 16))
    den = rng.randint(0, 60, (6, 16))
    lex[2, 5:] = -1
    lex_sc = np.sort(rng.rand(6, 16))[:, ::-1]
    den_sc = np.sort(rng.rand(6, 16))[:, ::-1]
    from repro.serving.spec import FusionSpec as RefFusionSpec
    from repro_torch.serving.spec import FusionSpec
    for method in ("rrf", "weighted"):
        got = fusion.fuse(FusionSpec(method=method, w_dense=0.3), lex, lex_sc,
                          den, den_sc, 12)
        want = ref_fusion.fuse(RefFusionSpec(method=method, w_dense=0.3),
                               lex, lex_sc, den, den_sc, 12)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------


def test_synthetic_embeddings_and_queries_match_reference():
    got = synthetic_embeddings(300, 128, d=16, seed=2)
    want = ref_emb.synthetic_embeddings(300, 128, d=16, seed=2)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    x = np.array([0.01, -1.73205, 3.5, -9.0, 0.0, -0.004])
    np.testing.assert_array_equal(quantize(x), ref_emb.quantize(x))
    terms, mask = _terms(3)
    terms = terms % 128
    np.testing.assert_array_equal(embed_queries(got[1], terms, mask),
                                  ref_emb.embed_queries(want[1], terms, mask))


@pytest.fixture(scope="module")
def tower_pair():
    params, _ = ref_recsys.init(REF_REDUCED, jax.random.PRNGKey(0))
    return params, convert.two_tower_params(
        jax.tree.map(np.asarray, params), "cpu")


def test_tower_forward_matches_reference(tower_pair):
    params, tower = tower_pair
    rng = np.random.RandomState(1)
    for side, rows in (("user", REF_REDUCED.n_users),
                       ("item", REF_REDUCED.n_items)):
        ids = rng.randint(0, rows, (257, 3))
        mask = (rng.rand(257, 3) > 0.3).astype(np.float32)
        want = np.asarray(ref_recsys.tower_embed(
            params, REF_REDUCED, f"{side}_table", f"{side}_mlp",
            jnp.asarray(ids), jnp.asarray(mask)))
        got = tower.tower_embed(side, torch.from_numpy(ids),
                                torch.from_numpy(mask)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_two_tower_tables_match_reference(small_collection, tower_pair):
    """The quantized tables of the fixture collection: 0 entries differ
    (a rounding flip at a grid midpoint would show here first)."""
    corpus, _, _ = small_collection
    _, tower = tower_pair
    want = ref_emb.two_tower_embeddings(corpus, seed=0)
    got = two_tower_embeddings(corpus, tower)
    mismatches = sum(int((a != b).sum()) for a, b in zip(got, want))
    assert mismatches == 0
    # build_embeddings resolves "auto" with a corpus to the tower
    b_doc, b_term = build_embeddings(DenseSpec(enabled=True), corpus,
                                     n_docs=corpus.n_docs,
                                     vocab=corpus.vocab, tower=tower)
    np.testing.assert_array_equal(b_doc, want[0])
    np.testing.assert_array_equal(b_term, want[1])


def test_build_embeddings_sources(small_collection):
    corpus, _, _ = small_collection
    for source in ("synthetic", "auto"):
        spec = DenseSpec(enabled=True, source=source, embed_dim=16, seed=4)
        got = build_embeddings(spec, None, n_docs=64, vocab=128)
        want = ref_emb.build_embeddings(
            RefDenseSpec(enabled=True, source=source, embed_dim=16, seed=4),
            None, n_docs=64, vocab=128)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="two_tower"):
        build_embeddings(DenseSpec(enabled=True, source="two_tower"), None,
                         n_docs=64, vocab=128)
    # the port's own tower: same shapes and grid, its own draws
    doc, term = build_embeddings(DenseSpec(enabled=True), corpus,
                                 n_docs=corpus.n_docs, vocab=corpus.vocab,
                                 device="cpu")
    assert doc.shape == (corpus.n_docs, 32)
    assert term.shape == (corpus.vocab, 32)
    np.testing.assert_array_equal(doc * 64, np.rint(doc * 64))
