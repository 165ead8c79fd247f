"""The port's live ingest against the reference, on the CPU.

``repro_torch.index.delta`` (``DeltaStore``, ``merge_feed_postings``), the
feed helpers of ``index/corpus``, the frozen statistics of
``index/builder``, the capacity overrides of ``postings.shard_layout``,
``isn.saat_serve_segments`` / ``isn.daat_serve_segments``, the dense delta
(``delta_doc_embeddings``, ``DenseEngine.set_delta``) and the ingest paths
of ``SearchSystem`` (``add_documents``, ``merge``, the delta segments of
Stage-1, ``_delta_us``, the cache's ingest epoch, ``stats()["ingest"]``)
and of the online loop are held to the reference:

* every case of ``tests/test_ingest.py`` on both packages, at the port's
  parity bar: index arrays after a merge bit-identical; SAAT ids, scores
  and work bit-exact; DAAT ids identical and scores within 1e-4; dense
  bit-exact; modeled latencies and the online event log at tolerance 0.0;
* the feed helpers and ``merge_feed_postings`` over several seeds; the
  capacity overrides against the reference's ``shard_from_index``;
* the Stage-2 features of an unmerged delta doc (the reference clamps its
  gathers to the last sealed doc, as JAX does: ROADMAP §3);
* a delta system's ``fresh_probe`` isolated from its parent across a
  merge, and ``hybrid_fusion`` with the delta (the reference's tower
  carried across by ``convert.two_tower_params``);
* ``chip_smoke.ingest_flow("cpu")`` against the reference's
  ``benchmarks/bench_ingest.run_ingest`` (its artifact write stubbed), at a
  reduced size.

The reference serves on its ``"jnp"`` backend, the port on the CPU (each
kernel wrapper's plain version).
"""

import dataclasses
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs.cascade_presets import PRESETS as REF_PRESETS
from repro.configs.cascade_presets import get_preset as ref_get_preset
from repro.configs.two_tower_retrieval import REDUCED as REF_REDUCED
from repro.dense import embeddings as ref_emb
from repro.dense.engine import DenseEngine as RefDenseEngine
from repro.index import builder as ref_builder
from repro.index import corpus as ref_corpus
from repro.index import delta as ref_delta
from repro.index.postings import shard_from_index as ref_shard_from_index
from repro.isn import daat as ref_daat
from repro.isn import oracle as ref_oracle
from repro.isn import saat as ref_saat
from repro.ltr import ranker as ref_ranker
from repro.models import recsys as ref_recsys
from repro.serving import spec as ref_spec
from repro.serving.online.simulator import INGEST_EVENT as REF_INGEST_EVENT
from repro.serving.online.traffic import \
    feed_arrival_times as ref_feed_arrival_times
from repro.serving.system import build_system as ref_build_system
from repro_torch import convert
from repro_torch.configs.cascade_presets import PRESETS, get_preset
from repro_torch.dense.embeddings import (build_embeddings,
                                          delta_doc_embeddings,
                                          embed_queries)
from repro_torch.dense.engine import DenseEngine
from repro_torch.index import builder as port_builder
from repro_torch.index.builder import build_index, frozen_stats, pack_tiles
from repro_torch.index.corpus import (CorpusParams, FeedDocs, build_corpus,
                                      extend_corpus, slice_feed,
                                      synthesize_feed_docs)
from repro_torch.index.delta import DeltaStore, merge_feed_postings
from repro_torch.index.postings import (shard_from_index, shard_layout,
                                        shard_to_device)
from repro_torch.isn.backend import query_lane_budget
from repro_torch.isn.daat import daat_serve_segments
from repro_torch.isn.saat import saat_serve, saat_serve_segments
from repro_torch.ltr.ranker import qd_features_batched
from repro_torch.serving import spec as port_spec
from repro_torch.serving.online import fresh_probe
from repro_torch.serving.online.simulator import INGEST_EVENT, MERGE_EVENT
from repro_torch.serving.online.traffic import feed_arrival_times
from repro_torch.serving.system import build_system

ROOT = pathlib.Path(__file__).resolve().parents[1]
BIG = 1 << 20          # a rho budget beyond any segment's work


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port_collection():
    """The port's build of the ``small_collection`` fixture's corpus."""
    corpus = build_corpus(CorpusParams(n_docs=4096, vocab=2048,
                                       avg_doclen=80, zipf_a=1.05, seed=3))
    return corpus, build_index(corpus, stop_k=8)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _same_arrays(got, want, msg=""):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, msg
    np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=msg)


def _same_feed(a, b):
    for f in ("doclen", "doc_topics", "postings_term", "postings_doc",
              "postings_tf"):
        u, v = getattr(a, f), getattr(b, f)
        assert u.dtype == v.dtype, f
        np.testing.assert_array_equal(u, v, err_msg=f)


def _same_corpus(a, b):
    assert a.params.n_docs == b.params.n_docs
    for f in ("doclen", "postings_term", "postings_doc", "postings_tf",
              "doc_topics", "topic_perm", "zipf_probs"):
        u, v = getattr(a, f), getattr(b, f)
        assert u.dtype == v.dtype, f
        np.testing.assert_array_equal(u, v, err_msg=f)


def _same_index(a, b):
    """Every field of two indexes (either package) bit-identical."""
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray) or isinstance(vb, np.ndarray):
            va, vb = np.asarray(va), np.asarray(vb)
            assert va.dtype == vb.dtype, f.name
            np.testing.assert_array_equal(va, vb, err_msg=f.name)
        else:
            assert va == vb, f.name


def _same_shard(port_shard, port_spec_, ref_shard, ref_spec_):
    assert tuple(port_spec_) == tuple(ref_spec_)
    for name, arr in port_shard._asdict().items():
        _same_arrays(arr, getattr(ref_shard, name), name)


def _permute_feed(feed_cls, feed, rng):
    """The same feed docs in a random arrival order (ids re-based)."""
    perm = rng.permutation(feed.n_docs)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(feed.n_docs)
    order = np.lexsort((inv[feed.postings_doc], feed.postings_term))
    return feed_cls(doclen=feed.doclen[perm],
                    doc_topics=feed.doc_topics[perm],
                    postings_term=feed.postings_term[order],
                    postings_doc=inv[feed.postings_doc][order],
                    postings_tf=feed.postings_tf[order])


def _feed_in_batches(delta, feed, rng, slicer):
    """Ingest ``feed`` through the delta in random-sized batches."""
    lo, total = 0, 0
    while lo < feed.n_docs:
        hi = min(lo + int(rng.randint(1, 17)), feed.n_docs)
        total += delta.add(slicer(feed, lo, hi))
        lo = hi
    return total


def _fed_pair(small_collection, port_collection, seed, n_new, **caps):
    """(reference delta, port delta), fed the same permuted feed in the same
    random batches, and the reference's (feed, extended corpus)."""
    corpus, index, _ = small_collection
    pcorpus, pindex = port_collection
    feeds, out = [], []
    for c, make, feed_cls, synth, slicer in (
            (corpus, lambda: ref_delta.DeltaStore(index, **caps),
             ref_corpus.FeedDocs, ref_corpus.synthesize_feed_docs,
             ref_corpus.slice_feed),
            (pcorpus, lambda: DeltaStore(pindex, device="cpu", **caps),
             FeedDocs, synthesize_feed_docs, slice_feed)):
        rng = np.random.RandomState(seed)
        feed = _permute_feed(feed_cls, synth(c, n_new, seed=7), rng)
        delta = make()
        assert _feed_in_batches(delta, feed, rng, slicer) == n_new
        feeds.append(feed)
        out.append(delta)
    _same_feed(feeds[1], feeds[0])
    return out[0], out[1], feeds[0], ref_corpus.extend_corpus(corpus,
                                                              feeds[0])


def _frozen_oracle(builder, index, ext):
    """Monolithic index over the combined collection, scored and quantized
    with the sealed stats and stoplist."""
    keep = ~np.isin(ext.postings_term, index.stoplist)
    return builder.assemble_index(
        ext.postings_term[keep].astype(np.int64),
        ext.postings_doc[keep].astype(np.int64),
        ext.postings_tf[keep].astype(np.float64), ext.doclen, ext.vocab,
        block_size=index.block_size, stoplist=index.stoplist,
        frozen=builder.frozen_stats(index))


# ---------------------------------------------------------------------------
# the feed helpers, the frozen stats, the capacity overrides
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 99])
def test_feed_helpers_match_reference(small_collection, port_collection,
                                      seed):
    """``synthesize_feed_docs``, ``slice_feed``, ``extend_corpus`` and
    ``merge_feed_postings`` bit-equal to the reference's, and the counted
    interleave equal to the global-lexsort oracle."""
    corpus, _, _ = small_collection
    pcorpus, _ = port_collection
    n = 20 + 13 * (seed % 5)
    want = ref_corpus.synthesize_feed_docs(corpus, n, seed=seed)
    got = synthesize_feed_docs(pcorpus, n, seed=seed)
    _same_feed(got, want)
    assert got.n_docs == want.n_docs and got.n_postings == want.n_postings
    for lo, hi in ((0, n), (3, 11), (n - 1, n), (5, 5)):
        _same_feed(slice_feed(got, lo, hi),
                   ref_corpus.slice_feed(want, lo, hi))
    ext = extend_corpus(pcorpus, got)
    _same_corpus(ext, ref_corpus.extend_corpus(corpus, want))
    merged = merge_feed_postings(pcorpus, got)
    _same_corpus(merged, ref_delta.merge_feed_postings(corpus, want))
    _same_corpus(merged, ext)


def test_frozen_stats_and_assemble_match_reference(small_collection,
                                                   port_collection):
    """``assemble_index(..., frozen=)`` (sealed stats, a pinned impact
    scale) bit-equal to the reference's, and the unfrozen build unchanged."""
    corpus, index, _ = small_collection
    pcorpus, pindex = port_collection
    feed = ref_corpus.synthesize_feed_docs(corpus, 40, seed=3)
    ext = ref_corpus.extend_corpus(corpus, feed)
    fa, fb = ref_builder.frozen_stats(index), frozen_stats(pindex)
    for f in dataclasses.fields(fa):
        np.testing.assert_array_equal(getattr(fb, f.name),
                                      getattr(fa, f.name))
    _same_index(_frozen_oracle(port_builder, pindex, ext),
                _frozen_oracle(ref_builder, index, ext))
    _same_index(build_index(ext, stop_k=8),
                ref_builder.build_index(ext, stop_k=8))


@pytest.mark.parametrize("lo,hi", [(0, 4096), (1000, 2300)])
def test_shard_capacity_overrides_match_reference(small_collection,
                                                  port_collection, lo, hi):
    """``shard_layout``'s capacity overrides (``tile_cap``,
    ``pad_postings``, ``max_df``, ``max_blocks_per_term``) against the
    reference's ``shard_from_index``, array for array, and the defaults
    (the sealed layout ``shard_layouts`` shares) unchanged."""
    _, index, _ = small_collection
    _, pindex = port_collection
    p = int(((index.docs >= lo) & (index.docs < hi)).sum())
    lay = shard_layout(pindex, lo, hi)
    caps = dict(tile_cap=lay.spec.tile_cap + 384, pad_postings=p + 777,
                max_df=999, max_blocks_per_term=77)
    got = shard_to_device(shard_layout(pindex, lo, hi, **caps), "cpu")
    want = ref_shard_from_index(index, lo, hi, **caps)
    _same_shard(*got, *want)
    _same_shard(*shard_from_index(pindex, lo, hi, device="cpu"),
                *ref_shard_from_index(index, lo, hi))
    assert lay.spec == shard_from_index(pindex, lo, hi, device="cpu")[1]
    with pytest.raises(ValueError, match="below required cap"):
        shard_layout(pindex, lo, hi, tile_cap=128)
    with pytest.raises(ValueError, match="pad size"):
        shard_layout(pindex, lo, hi, pad_postings=p - 1)
    docs = np.arange(300)
    with pytest.raises(ValueError, match="below required cap"):
        pack_tiles(docs, docs, [], 300, 300, tile_cap=64)


# ---------------------------------------------------------------------------
# DeltaStore mechanics (tests/test_ingest.py)
# ---------------------------------------------------------------------------

def test_delta_admission_and_fill(small_collection, port_collection):
    corpus, index, _ = small_collection
    pcorpus, pindex = port_collection
    feed = ref_corpus.synthesize_feed_docs(corpus, 24, seed=7)
    pfeed = synthesize_feed_docs(pcorpus, 24, seed=7)
    kept = int((~np.isin(feed.postings_term, index.stoplist)).sum())
    for caps in (dict(capacity_docs=16, capacity_postings=1 << 14),
                 dict(capacity_docs=1024, capacity_postings=kept // 2)):
        a = ref_delta.DeltaStore(index, **caps)
        b = DeltaStore(pindex, device="cpu", **caps)
        assert b.admit_count(pfeed) == a.admit_count(feed)
        assert b.add(pfeed) == a.add(feed)
        assert b.add(slice_feed(pfeed, 16, 24)) \
            == a.add(ref_corpus.slice_feed(feed, 16, 24))
        assert b.stats() == a.stats()
        assert b.fill == a.fill and b.n_postings_kept == a.n_postings_kept
    assert b.fill == b.n_postings_kept / b.capacity_postings
    assert 0 < b.n_docs < 24
    tiny = DeltaStore(pindex, capacity_docs=8, capacity_postings=2,
                      device="cpu")
    with pytest.raises(ValueError):
        tiny.add(pfeed)
    with pytest.raises(ValueError):
        DeltaStore(pindex, capacity_docs=0, capacity_postings=2,
                   device="cpu")


def test_delta_rebuild_is_shape_static(small_collection, port_collection):
    """Every fill level gives the same shard shapes and spec (one set of
    kernel shapes from empty to full), each shard equal to the reference's
    array for array."""
    corpus, index, _ = small_collection
    pcorpus, pindex = port_collection
    feed = ref_corpus.synthesize_feed_docs(corpus, 48, seed=7)
    pfeed = synthesize_feed_docs(pcorpus, 48, seed=7)
    a = ref_delta.DeltaStore(index, capacity_docs=64, capacity_postings=8192)
    b = DeltaStore(pindex, capacity_docs=64, capacity_postings=8192,
                   device="cpu")
    shard0, spec0 = b.segment()
    shapes0 = [tuple(x.shape) for x in shard0]
    _same_shard(*b.segment(), *a.segment())
    for lo in (0, 16, 32):
        a.add(ref_corpus.slice_feed(feed, lo, lo + 16))
        b.add(slice_feed(pfeed, lo, lo + 16))
        shard, spec = b.segment()
        assert spec == spec0
        assert [tuple(x.shape) for x in shard] == shapes0
        _same_shard(shard, spec, *a.segment())
        np.testing.assert_array_equal(b.level_cum, a.level_cum)
    assert spec0.tile_cap == 8192 and spec0.n_tiles == 1


def test_merge_matches_rebuild_oracle(small_collection, port_collection):
    corpus, index, _ = small_collection
    ref_d, port_d, feed, ext = _fed_pair(small_collection, port_collection,
                                         41, 56, capacity_docs=64,
                                         capacity_postings=1 << 14)
    pcorpus, _ = port_collection
    new_corpus, new_index = port_d.merged(pcorpus)
    want_corpus, want_index = ref_d.merged(corpus)
    _same_index(new_index, want_index)
    _same_corpus(new_corpus, want_corpus)
    oracle_idx = build_index(extend_corpus(pcorpus, port_d.raw_feed()),
                             stop_k=len(index.stoplist))
    _same_index(new_index, oracle_idx)
    _same_feed(port_d.raw_feed(), ref_d.raw_feed())
    assert new_corpus.n_docs == corpus.n_docs + 56


# ---------------------------------------------------------------------------
# delta-scan parity: sealed + delta segments
# ---------------------------------------------------------------------------

def _segments_pair(index, pindex, ref_d, port_d, bounds):
    ref_segs, port_segs = [], []
    for lo, hi in bounds:
        ref_segs.append((*ref_shard_from_index(index, lo, hi), lo))
        port_segs.append((*shard_from_index(pindex, lo, hi, device="cpu"),
                          lo))
    ref_segs.append((*ref_d.segment(), index.n_docs))
    port_segs.append((*port_d.segment(), pindex.n_docs))
    return ref_segs, port_segs


@pytest.mark.parametrize("trial", [0, 1, 2])
def test_saat_delta_scan_parity(small_collection, port_collection, trial):
    """Random ingest order and batch sizes; the live (sealed + delta) SAAT
    scan equals the reference's and the monolithic frozen oracle's, ids,
    scores and work, bit for bit."""
    _, index, ql = small_collection
    _, pindex = port_collection
    n_new = int(np.random.RandomState(100 + trial).randint(40, 90))
    ref_d, port_d, _, ext = _fed_pair(small_collection, port_collection,
                                      100 + trial, n_new,
                                      capacity_docs=128,
                                      capacity_postings=1 << 14)
    rows = np.arange(32)
    cap = 1 << 14
    ref_segs, port_segs = _segments_pair(index, pindex, ref_d, port_d,
                                         [(0, index.n_docs)])
    rho = np.full(len(rows), BIG)
    want = ref_saat.saat_serve_segments(
        ref_segs, jnp.asarray(ql.terms[rows]), jnp.asarray(ql.mask[rows]),
        [jnp.asarray(rho)] * 2, k=32, cap=cap)
    got = saat_serve_segments(port_segs, _t(ql.terms[rows]),
                              _t(ql.mask[rows]), [_t(rho)] * 2, k=32)
    _same_arrays(got[0], want[0], "ids")
    _same_arrays(got[1], want[1], "scores")
    for u, v in zip(got[2], want[2]):
        _same_arrays(u, v, "work")
    oidx = _frozen_oracle(port_builder, pindex, ext)
    oshard, ospec = shard_from_index(oidx, device="cpu")
    mono = saat_serve(oshard, _t(ql.terms[rows]), _t(ql.mask[rows]),
                      _t(rho), n_docs=ospec.n_docs, k=32)
    _same_arrays(got[0], mono.topk_docs.numpy(), "oracle ids")
    _same_arrays(got[1], mono.topk_scores.numpy(), "oracle scores")
    assert int(got[0].max()) < ext.n_docs


def test_saat_delta_multishard_and_drop(small_collection, port_collection):
    """Two sealed shards + delta, sealed shard 0 dropped for half the batch:
    equal to the reference and to the NumPy oracle, drop mask included."""
    _, index, ql = small_collection
    _, pindex = port_collection
    ref_d, port_d, _, ext = _fed_pair(small_collection, port_collection, 77,
                                      64, capacity_docs=64,
                                      capacity_postings=1 << 14)
    half = index.n_docs // 2
    rows = np.arange(24)
    ref_segs, port_segs = _segments_pair(
        index, pindex, ref_d, port_d, [(0, half), (half, index.n_docs)])
    drop = np.zeros((3, len(rows)), bool)
    drop[0, ::2] = True
    rho = np.full(len(rows), BIG)
    want = ref_saat.saat_serve_segments(
        ref_segs, jnp.asarray(ql.terms[rows]), jnp.asarray(ql.mask[rows]),
        [jnp.asarray(rho)] * 3, k=24, cap=1 << 14, drop=drop)
    got = saat_serve_segments(port_segs, _t(ql.terms[rows]),
                              _t(ql.mask[rows]), [_t(rho)] * 3, k=24,
                              drop=drop)
    _same_arrays(got[0], want[0], "ids")
    _same_arrays(got[1], want[1], "scores")
    oidx = _frozen_oracle(ref_builder, index, ext)
    acc, _ = ref_oracle.jass_scores(oidx, ql.terms, ql.mask, rows, BIG)
    acc = np.asarray(acc, np.float64)
    acc[::2, :half] = -np.inf
    col = np.arange(acc.shape[1])
    o_ids = np.stack([np.lexsort((col, -r))[:24] for r in acc])
    _same_arrays(got[0].long(), o_ids, "oracle ids")
    assert not np.isin(got[0].numpy()[::2], np.arange(half)).any()


def test_daat_delta_scan_parity(small_collection, port_collection):
    """Rank-safe DAAT over sealed + delta: ids identical to the
    reference's, scores within 1e-4, work and blocks per segment equal; a
    delta doc reachable; with the sealed shard dropped only delta ids (or
    -1) remain."""
    _, index, ql = small_collection
    _, pindex = port_collection
    ref_d, port_d, _, ext = _fed_pair(small_collection, port_collection, 55,
                                      72, capacity_docs=128,
                                      capacity_postings=1 << 14)
    rows = np.arange(32)
    ref_segs, port_segs = _segments_pair(index, pindex, ref_d, port_d,
                                         [(0, index.n_docs)])
    theta = np.ones(len(rows), np.float32)
    terms, mask = ql.terms[rows], ql.mask[rows]
    for drop in (None, np.stack([np.ones(len(rows), bool),
                                 np.zeros(len(rows), bool)])):
        want = ref_daat.daat_serve_segments(
            ref_segs, jnp.asarray(terms), jnp.asarray(mask),
            jnp.asarray(theta), k=20, drop=drop)
        got = daat_serve_segments(port_segs, _t(terms), _t(mask),
                                  _t(theta), k=20, drop=drop)
        _same_arrays(got[0], want[0], "ids")
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   rtol=0, atol=1e-4)
        for u, v in zip(got[2] + got[3], want[2] + want[3]):
            _same_arrays(u.to(torch.int64), np.asarray(v, np.int64),
                         "work/blocks")
        ids = got[0].numpy()
        assert int(ids.max()) < ext.n_docs
        if drop is None:
            assert (ids >= index.n_docs).any()
        else:
            assert ((ids >= index.n_docs) | (ids == -1)).all()


# ---------------------------------------------------------------------------
# the dense delta
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_tower():
    params, _ = ref_recsys.init(REF_REDUCED, jax.random.PRNGKey(0))
    return convert.two_tower_params(jax.tree.map(np.asarray, params), "cpu")


def test_dense_delta_parity(small_collection, port_collection, ref_tower):
    """Delta embeddings through the reference's tower equal the
    reference's rows and a full rebuild's slice; the engine's sealed +
    delta scan equals a monolithic engine and the reference engine, bit
    for bit, ghosts never surfacing; ``clear_delta`` drops it."""
    corpus, _, ql = small_collection
    pcorpus, _ = port_collection
    dspec = port_spec.DenseSpec(enabled=True, source="auto")
    rspec = ref_spec.DenseSpec(enabled=True, source="auto")
    n, m = pcorpus.n_docs, 40
    feed = synthesize_feed_docs(pcorpus, m, seed=7)
    ext = extend_corpus(pcorpus, feed)
    emb_ext, tt = build_embeddings(dspec, ext, n_docs=ext.n_docs,
                                   vocab=ext.vocab, tower=ref_tower)
    emb_sealed, _ = build_embeddings(dspec, pcorpus, n_docs=n,
                                     vocab=pcorpus.vocab, tower=ref_tower)
    np.testing.assert_array_equal(emb_ext[:n], emb_sealed)
    rows = delta_doc_embeddings(dspec, n_sealed=n, n_new=m,
                                vocab=pcorpus.vocab, topics=feed.doc_topics,
                                corpus=pcorpus, tower=ref_tower)
    np.testing.assert_array_equal(rows, emb_ext[n:])
    np.testing.assert_array_equal(rows, ref_emb.delta_doc_embeddings(
        rspec, n_sealed=n, n_new=m, vocab=corpus.vocab,
        topics=feed.doc_topics, corpus=corpus))
    cap = 64
    pad = np.zeros((cap, emb_sealed.shape[1]), np.float32)
    pad[:m] = rows
    live = DenseEngine(emb_sealed, tt, [(0, n)], device="cpu")
    live.set_delta(pad, m, n)
    assert live.delta_tiles() == -(-cap // live.tile_d)
    ref_live = RefDenseEngine(emb_sealed, tt, [(0, n)])
    ref_live.set_delta(pad, m, n)
    mono = DenseEngine(emb_ext, tt, [(0, n + m)], device="cpu")
    q_emb = embed_queries(tt, ql.terms, ql.mask)
    ids, sc = live.serve(q_emb, 16)
    o_ids, o_sc = mono.serve(q_emb, 16)
    r_ids, r_sc = ref_live.serve(q_emb, 16)
    for a, b in ((ids, o_ids), (ids, r_ids), (sc, o_sc), (sc, r_sc)):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert int(ids.max()) < n + m
    drop = np.zeros((1, len(q_emb)), bool)
    drop[0, ::3] = True
    d_ids, d_sc = live.serve(q_emb, 16, drop=drop)
    rd_ids, rd_sc = ref_live.serve(q_emb, 16, drop=drop)
    np.testing.assert_array_equal(d_ids, np.asarray(rd_ids))
    np.testing.assert_array_equal(d_sc, np.asarray(rd_sc))
    live.clear_delta()
    assert live.delta_tiles() == 0
    assert int(live.serve(q_emb, 16)[0].max()) < n


# ---------------------------------------------------------------------------
# the spec layer
# ---------------------------------------------------------------------------

def test_presets_round_trip_and_legacy_json():
    assert set(PRESETS) == set(REF_PRESETS)
    for name in PRESETS:
        spec = get_preset(name)
        rt = port_spec.CascadeSpec.from_json(spec.to_json())
        assert rt == spec, name
        assert spec.to_json() == ref_get_preset(name).to_json()
        d = json.loads(spec.to_json())
        d.pop("ingest")
        legacy = port_spec.CascadeSpec.from_json(json.dumps(d))
        assert legacy == dataclasses.replace(spec,
                                             ingest=port_spec.IngestSpec())
        if name != "live_ingest":
            assert legacy == spec
            assert not legacy.ingest.active
    li = get_preset("live_ingest")
    assert li.ingest.active
    assert li.ingest.delta_docs >= li.stage2.k_serve


def test_ingest_spec_validation():
    ing = port_spec.IngestSpec
    with pytest.raises(ValueError):
        ing(enabled=True, delta_docs=0).validate()
    with pytest.raises(ValueError):
        ing(enabled=True, feed_qps=0.0).validate()
    with pytest.raises(ValueError):
        ing(enabled=True, merge_threshold=1.5).validate()
    ing().validate()
    for qps, seed in ((20.0, 0), (8.0, 3), (0.5, 11)):
        ts = feed_arrival_times(ing(enabled=True, feed_qps=qps, seed=seed),
                                32)
        np.testing.assert_array_equal(ts, ref_feed_arrival_times(
            ref_spec.IngestSpec(enabled=True, feed_qps=qps, seed=seed), 32))
        assert (np.diff(ts) >= 0).all()


# ---------------------------------------------------------------------------
# the system layer: tests/test_ingest.py's spec on both packages
# ---------------------------------------------------------------------------

def _spec(mod, ingest=None, cache=None, dense=None, **routing_kw):
    """``tests/test_ingest.py``'s ``_spec``, in either package."""
    routing = {"budget": 200.0, "rho_max": 1 << 14, "t_k": 150.0,
               "t_time": 18.0, "adapt_every": 0}
    routing.update(routing_kw)
    return mod.CascadeSpec(
        routing=mod.RoutingSpec(**routing),
        stage2=mod.Stage2Spec(enabled=True, k_serve=32, t_final=5),
        backend=mod.BackendSpec(backend="jnp"),
        deploy=mod.DeploySpec(),
        cache=cache if cache is not None else mod.CacheSpec(),
        dense=dense if dense is not None else mod.DenseSpec(),
        ingest=ingest if ingest is not None else mod.IngestSpec(),
        online=mod.OnlineSpec(max_batch=8, batch_deadline_us=4.0),
        name="ingest_test")


def _ing(mod, **kw):
    base = dict(enabled=True, delta_docs=64, delta_postings=4096,
                feed_qps=12.0, feed_batch=8, merge_threshold=0.6)
    base.update(kw)
    return mod.IngestSpec(**base)


@pytest.fixture(scope="module")
def fitted(small_collection):
    """``tests/test_ingest.py``'s fit (calibrated, pseudo-labels, seed 5) on
    the reference, its models converted for the port."""
    corpus, index, ql = small_collection
    spec = _spec(ref_spec)
    spec = dataclasses.replace(spec, routing=dataclasses.replace(
        spec.routing, t_k=None, t_time=None, calibrate=True))
    ref = ref_build_system(spec, index, corpus=corpus)
    ref.fit(ql, None, seed=5)
    return ref, convert.system_models(ref, "cpu")


@pytest.fixture
def pair(small_collection, port_collection, fitted):
    """``make(index=, corpus=, pindex=, pcorpus=, tower=, **spec_kw)`` ->
    (reference system, port system) of ``_spec(**spec_kw)`` with the fit's
    thresholds and models; ``spec_kw`` values are reference spec nodes."""
    corpus, index, _ = small_collection
    pcorpus, pindex = port_collection
    ref, (models, ltr) = fitted

    def make(index_=None, corpus_=None, pindex_=None, pcorpus_=None,
             tower=None, **kw):
        spec = _spec(ref_spec, t_k=ref._base_cfg.t_k,
                     t_time=ref._base_cfg.t_time, **kw)
        a = ref_build_system(spec, index if index_ is None else index_,
                             corpus=corpus if corpus_ is None else corpus_,
                             models=ref.models, ltr=ref.ltr)
        b = build_system(convert.cascade_spec(spec),
                         pindex if pindex_ is None else pindex_,
                         corpus=pcorpus if pcorpus_ is None else pcorpus_,
                         models=models, ltr=ltr, tower=tower, device="cpu")
        return a, b
    return make


def _same_result(ra, rb):
    for key in ("topk", "final", "candidates_used", "latency", "coverage"):
        u, v = getattr(ra, key), getattr(rb, key)
        if u is None:
            assert v is None, key
        else:
            assert v.dtype == u.dtype, key
            np.testing.assert_array_equal(v, u, err_msg=key)
    for key in ("stage0", "stage1", "stage2"):
        np.testing.assert_array_equal(rb.stage_latency[key],
                                      ra.stage_latency[key], err_msg=key)
    if ra.dense is not None:
        for key in ("modality", "theta_skip", "fallback"):
            np.testing.assert_array_equal(rb.dense[key], ra.dense[key])
    assert rb.stats == ra.stats


def _same_stats(a, b):
    sa, sb = a.stats(), b.stats()
    assert sb.pop("device") == "cpu"
    assert sb == sa


def _serve_pair(a, b, ql, rows=slice(None)):
    ra = a.serve(ql.terms[rows], ql.mask[rows], ql.topic[rows])
    rb = b.serve(ql.terms[rows], ql.mask[rows], ql.topic[rows])
    _same_result(ra, rb)
    return ra, rb


def _same_online(ra, rb):
    assert rb.event_log == ra.event_log
    for key in ("arrival", "wait", "service", "completion", "response",
                "mode", "batch_of", "topk", "final", "coverage"):
        u, v = getattr(ra, key), getattr(rb, key)
        if u is None:
            assert v is None, key
        else:
            assert v.dtype == u.dtype, key
            np.testing.assert_array_equal(v, u, err_msg=key)
    assert rb.stats == ra.stats


def test_system_lifecycle_merge_bit_parity(small_collection, port_collection,
                                           pair):
    """serve -> ingest -> serve -> merge -> serve, every result equal to the
    reference's; the merged index bit-identical to the reference's and to
    a from-scratch build, and the post-merge results to a system built over
    the extended collection."""
    corpus, index, ql = small_collection
    pcorpus, _ = port_collection
    a, b = pair(ingest=_ing(ref_spec))
    _serve_pair(a, b, ql)
    feed = ref_corpus.synthesize_feed_docs(corpus, 48, seed=7)
    pfeed = synthesize_feed_docs(pcorpus, 48, seed=7)
    assert b.add_documents(pfeed) == a.add_documents(feed) == 48
    mid, _ = _serve_pair(a, b, ql)
    assert (mid.topk >= index.n_docs).sum() > 0
    assert int(mid.topk.max()) < index.n_docs + 48
    assert b.merge() == a.merge() == 48
    assert b.delta.n_docs == 0
    after, _ = _serve_pair(a, b, ql)
    _same_index(b.index, a.index)
    ext = extend_corpus(pcorpus, pfeed)
    _same_index(b.index, build_index(ext, stop_k=len(index.stoplist)))
    _same_stats(a, b)
    a2, b2 = pair(index_=a.index, corpus_=a.corpus, pindex_=b.index,
                  pcorpus_=ext, ingest=_ing(ref_spec))
    _, fresh = _serve_pair(a2, b2, ql)
    for key in ("topk", "final", "latency"):
        np.testing.assert_array_equal(getattr(fresh, key),
                                      getattr(after, key))


def test_worst_case_and_stats_report_delta(small_collection, port_collection,
                                           pair):
    corpus, _, _ = small_collection
    pcorpus, _ = port_collection
    a_off, b_off = pair()
    a, b = pair(ingest=_ing(ref_spec))
    assert b.worst_case_us() == a.worst_case_us()
    assert b.worst_case_us() == pytest.approx(
        b_off.worst_case_us() + b.cost.delta_time(4096))
    assert "ingest" not in b_off.stats()
    _same_stats(a, b)
    s = b.stats()["ingest"]
    assert s["delta_docs"] == 0 and s["capacity_docs"] == 64
    assert s["delta_us"] > 0 and s["merges"] == 0
    a.add_documents(ref_corpus.synthesize_feed_docs(corpus, 16, seed=7))
    b.add_documents(synthesize_feed_docs(pcorpus, 16, seed=7))
    _same_stats(a, b)
    s = b.stats()["ingest"]
    assert s["delta_docs"] == 16 and s["docs_ingested"] == 16
    assert s["feed_batches"] == 1 and 0 < s["fill"] < 1
    with pytest.raises(RuntimeError):
        b_off.add_documents(synthesize_feed_docs(pcorpus, 4, seed=7))
    with pytest.raises(RuntimeError):
        b_off.merge()
    with pytest.raises(ValueError, match="k_serve"):
        pair(ingest=_ing(ref_spec, delta_docs=16))


def test_ingest_epoch_invalidates_cache(small_collection, port_collection,
                                        pair):
    corpus, _, ql = small_collection
    pcorpus, _ = port_collection
    a, b = pair(ingest=_ing(ref_spec),
                cache=ref_spec.CacheSpec(enabled=True))
    q = len(ql.terms)
    hits = []
    for step in ("serve", "serve", "feed", "serve", "serve", "merge",
                 "serve"):
        if step == "serve":
            _serve_pair(a, b, ql)
            assert b.cache.stats() == a.cache.stats()
            hits.append(b.cache.counters["l1_hits"])
        elif step == "feed":
            a.add_documents(ref_corpus.synthesize_feed_docs(corpus, 16,
                                                            seed=7))
            b.add_documents(synthesize_feed_docs(pcorpus, 16, seed=7))
        else:
            assert b.merge() == a.merge()
        assert b._cache_epoch(0.0) == a._cache_epoch(0.0)
    assert hits == [0, q, q, 2 * q, 2 * q]


def test_disabled_ingest_is_bit_identical(small_collection, pair):
    """``IngestSpec(enabled=False)`` is indistinguishable from no ingest
    node: offline results, the worst case, and the online event log, in
    both packages and between them."""
    _, _, ql = small_collection
    inert = ref_spec.IngestSpec(enabled=False, delta_docs=64, feed_qps=50.0)
    a0, b0 = pair()
    a1, b1 = pair(ingest=inert)
    assert b1.delta is None and b1._delta_us == 0.0
    r0, _ = _serve_pair(a0, b0, ql)
    r1, _ = _serve_pair(a1, b1, ql)
    _same_result(r0, r1)
    assert b0.worst_case_us() == b1.worst_case_us() == a1.worst_case_us()
    traffic = ref_spec.TrafficSpec(arrival="bursty", qps=150.0, seed=3)
    ptraffic = port_spec.TrafficSpec(arrival="bursty", qps=150.0, seed=3)
    runs = []
    for kw in ({}, {"ingest": inert}):
        a, b = pair(**kw)
        ra = a.serve_online(ql.terms, ql.mask, ql.topic, traffic=traffic)
        rb = b.serve_online(ql.terms, ql.mask, ql.topic, traffic=ptraffic)
        _same_online(ra, rb)
        assert "ingest" not in rb.stats
        runs.append(rb)
    assert runs[0].event_log == runs[1].event_log


def test_online_ingest_backpressure_and_replay(small_collection, pair):
    """Serving under load while the feed lands: the port's event log (feed
    batches and merges on the virtual clock, their pauses in the query
    waits), arrays and stats equal the reference's, and replay
    bit-identically."""
    _, _, ql = small_collection
    traffic = ref_spec.TrafficSpec(arrival="bursty", qps=60.0, seed=5)
    ptraffic = port_spec.TrafficSpec(arrival="bursty", qps=60.0, seed=5)
    a, b = pair(ingest=_ing(ref_spec))
    ra = a.serve_online(ql.terms, ql.mask, ql.topic, traffic=traffic)
    rb = b.serve_online(ql.terms, ql.mask, ql.topic, traffic=ptraffic)
    _same_online(ra, rb)
    _same_stats(a, b)
    s = rb.stats["ingest"]
    assert s["feed_batches_applied"] > 0 and s["merges"] > 0
    assert s["docs_ingested"] == s["feed_batches_applied"] * 8
    kinds = [int(e[0]) for e in rb.event_log]
    assert INGEST_EVENT == REF_INGEST_EVENT
    assert kinds.count(INGEST_EVENT) == s["feed_batches_applied"]
    assert kinds.count(MERGE_EVENT) == s["merges"]
    assert s["feed_applied"] == s["feed_batches_applied"]
    assert s["merges_applied"] == s["merges"]
    again = pair(ingest=_ing(ref_spec))[1].serve_online(
        ql.terms, ql.mask, ql.topic, traffic=ptraffic)
    assert again.event_log == rb.event_log


def test_stage2_prices_unmerged_delta_docs_as_the_reference(
        small_collection, port_collection, pair):
    """Before a merge a live delta candidate's global id is past the sealed
    collection; the reference's Stage-2 gathers clamp it to the last sealed
    doc (JAX's out-of-range rule), so the port's features for it carry that
    doc's length and topics, and the finals equal the reference's."""
    corpus, index, ql = small_collection
    pcorpus, _ = port_collection
    a, b = pair(ingest=_ing(ref_spec))
    a.add_documents(ref_corpus.synthesize_feed_docs(corpus, 48, seed=7))
    b.add_documents(synthesize_feed_docs(pcorpus, 48, seed=7))
    ra, rb = _serve_pair(a, b, ql)
    live = rb.topk >= index.n_docs
    assert live.sum() > 0
    cand = rb.topk.astype(np.int32)
    last = index.n_docs - 1
    want = np.asarray(ref_ranker.qd_features_batched(
        a.s2, jnp.asarray(ql.terms), jnp.asarray(ql.mask),
        jnp.asarray(ql.topic), jnp.asarray(cand), n_iter=a.n_iter,
        backend="jnp"))
    got = qd_features_batched(
        b.s2, _t(ql.terms), _t(ql.mask), _t(ql.topic), _t(cand),
        qcap=query_lane_budget(b.index.df, ql.terms, ql.mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    exact = [0, 2, 3, 5, 6, 7]
    np.testing.assert_array_equal(got[..., exact], want[..., exact])
    np.testing.assert_array_equal(
        got[live][:, 0], np.full(live.sum(), np.log1p(np.float32(
            index.doclen[last])), np.float32))
    np.testing.assert_array_equal(
        got[live][:, 5], corpus.doc_topics[last][ql.topic[
            np.nonzero(live)[0]]])


def test_fresh_probe_isolated_across_merge(small_collection, port_collection,
                                           pair):
    """A probe taken from a delta system starts with an empty delta (the
    reference's fresh build), and neither its feed nor its parent's merge
    reaches the other; both dense engines keep their own delta."""
    corpus, index, ql = small_collection
    pcorpus, _ = port_collection
    dense = ref_spec.DenseSpec(enabled=True, source="synthetic")
    a, b = pair(ingest=_ing(ref_spec), dense=dense)
    b.add_documents(synthesize_feed_docs(pcorpus, 24, seed=7))
    a.add_documents(ref_corpus.synthesize_feed_docs(corpus, 24, seed=7))
    probe = fresh_probe(b)
    assert probe.delta is not b.delta and probe.delta.n_docs == 0
    assert probe.dense is not b.dense and probe.dense.delta_emb is None
    assert b.dense.delta_live == 24
    sealed_a, sealed_b = pair(ingest=_ing(ref_spec), dense=dense)
    want = sealed_a.serve(ql.terms, ql.mask, ql.topic)
    _same_result(want, probe.serve(ql.terms, ql.mask, ql.topic))
    # the probe ingests; its parent does not see it
    probe.add_documents(synthesize_feed_docs(pcorpus, 8, seed=9))
    assert b.delta.n_docs == 24 and b.dense.delta_live == 24
    # the parent merges; the probe keeps its own sealed shards and delta
    shards = probe.shards
    assert b.merge() == a.merge() == 24
    assert probe.shards is shards and probe.index.n_docs == index.n_docs
    assert probe.delta.n_docs == 8 and probe.dense.delta_live == 8
    again = fresh_probe(sealed_b)
    again.add_documents(synthesize_feed_docs(pcorpus, 8, seed=9))
    r_again = again.serve(ql.terms, ql.mask, ql.topic)
    r_probe = probe.serve(ql.terms, ql.mask, ql.topic)
    for key in ("topk", "final", "latency"):
        np.testing.assert_array_equal(getattr(r_probe, key),
                                      getattr(r_again, key))
    _serve_pair(a, b, ql)


def test_hybrid_fusion_with_ingest_matches_reference(small_collection,
                                                     port_collection, pair,
                                                     ref_tower):
    """The dense modality (two-tower, the reference's tower) with the live
    delta: ingest, serve, merge, serve, equal to the reference, modality
    flags included; the delta's dense tiles charged into ``_delta_us``."""
    corpus, _, ql = small_collection
    pcorpus, _ = port_collection
    dense = ref_spec.DenseSpec(enabled=True, theta_high=0.5, theta_low=0.3)
    a, b = pair(ingest=_ing(ref_spec), dense=dense, tower=ref_tower)
    assert b._delta_us == a._delta_us
    assert b.worst_case_us() == a.worst_case_us()
    a.add_documents(ref_corpus.synthesize_feed_docs(corpus, 40, seed=7))
    b.add_documents(synthesize_feed_docs(pcorpus, 40, seed=7))
    ra, rb = _serve_pair(a, b, ql)
    assert (rb.dense["modality"] != 0).any()
    assert b.merge() == a.merge() == 40
    assert b.dense.delta_emb is None
    _serve_pair(a, b, ql)
    _same_stats(a, b)


# ---------------------------------------------------------------------------
# the BENCH_ingest flow
# ---------------------------------------------------------------------------

@pytest.fixture
def smoke(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke
    return chip_smoke


def test_ingest_flow_matches_reference_bench(monkeypatch, smoke):
    """``chip_smoke.ingest_flow`` on the CPU against the reference's own
    ``run_ingest`` (its artifact write stubbed out), figure for figure, at a
    reduced size; ``worst_case_on`` is the file's 266.2592; the
    ``offline_only`` run (the chip run's CPU side) gives the same parity
    and accounting."""
    from benchmarks import bench_ingest
    monkeypatch.setattr(bench_ingest, "write_bench_artifact",
                        lambda name, payload: None)
    kw = dict(q_batch=32, n_docs=2048, loads=(0.8,))
    want = bench_ingest.run_ingest(**kw)
    got = smoke.ingest_flow("cpu", **kw)
    assert got == smoke.ingest_figures(want)
    assert all(got["gates"].values())
    assert got["accounting"]["worst_case_on"] == pytest.approx(
        smoke.WORST_CASE_ON, abs=1e-9)
    assert smoke.ingest_flow("cpu", **kw, offline_only=True) == {
        k: got[k] for k in ("parity", "accounting")}
