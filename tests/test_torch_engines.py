"""The port's index shards, top-k plumbing and Stage-1 engines against the
reference.

* every ``IndexShard`` field of ``repro_torch.index.postings`` is
  array-equal to ``repro.index.postings.shard_from_index``, at 1 and 3
  shards and with the capacity overrides;
* the tie cases of ``tests/test_merge_shard_ties.py`` replayed against the
  port's ``merge_shard_topk`` / ``topk_from_tiles`` (lower global doc id on
  equal scores, with and without drop masks);
* ``saat_serve`` / ``daat_serve`` (plain versions on the CPU) against the
  reference's batched pipeline on the fixture's 96 queries: ids, ``work``
  and ``blocks`` exact, scores within 1e-4, at θ = 1 and θ > 1.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.index.postings import shard_from_index as ref_shard_from_index
from repro.index.postings import shard_ranges as ref_shard_ranges
from repro.isn.backend import query_lane_budget
from repro.isn.backend import topk_from_tiles as ref_topk_from_tiles
from repro.isn.daat import daat_serve as ref_daat_serve
from repro.isn.saat import _level_cut as ref_level_cut
from repro.isn.saat import saat_serve as ref_saat_serve
from repro_torch.index.builder import build_index
from repro_torch.index.corpus import CorpusParams, build_corpus
from repro_torch.index.postings import shard_from_index, shard_ranges
from repro_torch.isn.backend import (compact_lanes, merge_shard_topk,
                                     tiled_topk, topk_from_tiles)
from repro_torch.isn.daat import daat_serve
from repro_torch.isn.saat import _level_cut, saat_serve

FILL = float(np.finfo(np.float32).min)


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
def port_index(small_collection):
    """The port's own corpus + index from the fixture's parameters; the
    builders are NumPy copies, so every array equals the reference's."""
    corpus, index, ql = small_collection
    pcorpus = build_corpus(CorpusParams(n_docs=4096, vocab=2048,
                                        avg_doclen=80, zipf_a=1.05, seed=3))
    pindex = build_index(pcorpus, stop_k=8)
    for f in ("docs", "tf", "bm25_score", "impact", "offsets", "df",
              "level_cum", "term_stats", "docs_imp", "block_max"):
        np.testing.assert_array_equal(getattr(pindex, f), getattr(index, f))
    return index, pindex, ql


# ---------------------------------------------------------------------------
# shards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_shards", [1, 3])
def test_shard_fields_match_reference(port_index, n_shards):
    index, pindex, _ = port_index
    assert shard_ranges(index.n_docs, n_shards) == \
        ref_shard_ranges(index.n_docs, n_shards)
    for lo, hi in shard_ranges(index.n_docs, n_shards):
        ref, ref_spec = ref_shard_from_index(index, lo, hi)
        got, spec = shard_from_index(pindex, lo, hi, device="cpu")
        assert tuple(spec) == tuple(ref_spec)
        for f in ref._fields:
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(ref, f)),
                                          err_msg=f)


# ---------------------------------------------------------------------------
# top-k plumbing: the tie cases of test_merge_shard_ties.py
# ---------------------------------------------------------------------------

def _shard_lists(rng, n_shards, q, k_s, shard_docs=64, levels=6):
    sc_list, id_list = [], []
    for s in range(n_shards):
        lo = s * shard_docs
        scores = (rng.randint(1, levels + 1,
                              size=(q, shard_docs)) / 8.0).astype(np.float32)
        ids = np.arange(lo, lo + shard_docs, dtype=np.int64)
        order = np.argsort(-scores, axis=1, kind="stable")[:, :k_s]
        sc_list.append(np.take_along_axis(scores, order, axis=1))
        id_list.append(np.broadcast_to(ids, (q, shard_docs))[
            np.arange(q)[:, None], order])
    return sc_list, id_list


def _oracle_merge(sc_list, id_list, k, drop=None):
    q = sc_list[0].shape[0]
    out_sc = np.full((q, k), FILL, np.float32)
    out_id = np.full((q, k), -1, np.int64)
    for i in range(q):
        keep = [s for s in range(len(sc_list))
                if drop is None or not drop[s][i]]
        sc = np.concatenate([sc_list[s][i] for s in keep])
        ids = np.concatenate([id_list[s][i] for s in keep])
        order = np.lexsort((ids, -sc.astype(np.float64)))[:k]
        out_sc[i, :len(order)] = sc[order]
        out_id[i, :len(order)] = ids[order]
    return out_sc, out_id


def _merge(sc_list, id_list, k, drop=None):
    ids, sc = merge_shard_topk([torch.from_numpy(s) for s in sc_list],
                               [torch.from_numpy(i) for i in id_list], k,
                               drop=drop)
    return ids.numpy(), sc.numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n_shards", [2, 3, 5])
def test_cross_shard_ties_pick_lower_global_doc_id(seed, n_shards):
    rng = np.random.RandomState(seed)
    sc_list, id_list = _shard_lists(rng, n_shards, 16, 24)
    ids, sc = _merge(sc_list, id_list, 32)
    o_sc, o_id = _oracle_merge(sc_list, id_list, 32)
    np.testing.assert_array_equal(sc, o_sc)
    np.testing.assert_array_equal(ids, o_id)


def test_tied_scores_never_prefer_higher_shard():
    q, k = 4, 10
    sc_list = [np.ones((q, 8), np.float32) for _ in range(3)]
    id_list = [np.broadcast_to(np.arange(s * 8, (s + 1) * 8, dtype=np.int64),
                               (q, 8)).copy() for s in range(3)]
    ids, sc = _merge(sc_list, id_list, k)
    np.testing.assert_array_equal(
        ids, np.broadcast_to(np.arange(k, dtype=np.int64), (q, k)))
    assert (sc == 1.0).all()


@pytest.mark.parametrize("seed", [3, 4])
def test_ties_with_drop_mask(seed):
    rng = np.random.RandomState(seed)
    n_shards, q, k_s, k = 3, 12, 8, 20
    sc_list, id_list = _shard_lists(rng, n_shards, q, k_s)
    drop = np.zeros((n_shards, q), bool)
    drop[rng.randint(0, n_shards, size=q), np.arange(q)] = True
    ids, sc = _merge(sc_list, id_list, k, drop=drop)
    o_sc, o_id = _oracle_merge(sc_list, id_list, k, drop=drop)
    np.testing.assert_array_equal(ids, o_id)
    np.testing.assert_array_equal(sc, o_sc)
    assert (ids[:, 2 * k_s:] == -1).all()


def test_all_shards_dropped_yields_empty_row():
    q, k = 3, 6
    sc_list = [np.ones((q, 4), np.float32) for _ in range(2)]
    id_list = [np.broadcast_to(np.arange(s * 4, (s + 1) * 4, dtype=np.int64),
                               (q, 4)).copy() for s in range(2)]
    drop = np.zeros((2, q), bool)
    drop[:, 0] = True
    ids, sc = _merge(sc_list, id_list, k, drop=drop)
    assert (ids[0] == -1).all() and (sc[0] == FILL).all()
    assert (ids[1, :4] >= 0).all()


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_topk_from_tiles_ties_and_ghosts_match_reference(dtype):
    """Coarse integer scores (many ties) over tiles with a ghost tail: the
    port's stable top-k equals lax.top_k's, ids and scores."""
    rng = np.random.RandomState(9)
    acc = rng.randint(0, 5, (6, 5, 128)).astype(dtype)
    n_docs = 5 * 128 - 37
    for k in (1, 20, 128, 300):
        w_sc, w_id = map(np.asarray, ref_topk_from_tiles(jnp.asarray(acc), k,
                                                         n_docs=n_docs))
        sc, ids = topk_from_tiles(torch.from_numpy(acc), k, n_docs=n_docs)
        np.testing.assert_array_equal(ids.numpy(), w_id)
        np.testing.assert_array_equal(sc.numpy(), w_sc)
        assert (ids.numpy() < n_docs).all()
    sc, ids = tiled_topk(torch.from_numpy(acc.reshape(6, -1)[:, :n_docs]
                                          .copy()), 50)
    w_sc, w_id = ref_topk_from_tiles(jnp.asarray(acc), 50, n_docs=n_docs)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(w_id))


def test_compact_lanes_layout():
    base = torch.tensor([[10, 50, 0], [0, 0, 0]])
    dfs = torch.tensor([[2, 0, 3], [0, 0, 0]])
    pos, live = compact_lanes(base, dfs, 8)
    assert live.sum().item() == 5
    assert pos[0, :5].tolist() == [10, 11, 0, 1, 2]


# ---------------------------------------------------------------------------
# Stage-1 engines
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def shards(port_index):
    index, pindex, ql = port_index
    ref, ref_spec = ref_shard_from_index(index)
    got, spec = shard_from_index(pindex, device="cpu")
    return index, ql, ref, ref_spec, got, spec


@pytest.mark.parametrize("rho", [256, 2048, 8192])
def test_saat_serve_matches_reference(shards, rho):
    index, ql, ref, ref_spec, shard, spec = shards
    q = len(ql.terms)
    a = ref_saat_serve(ref, jnp.asarray(ql.terms), jnp.asarray(ql.mask),
                       jnp.full(q, rho, jnp.int32), n_docs=ref_spec.n_docs,
                       k=30, cap=rho, backend="jnp")
    b = saat_serve(shard, torch.from_numpy(ql.terms),
                   torch.from_numpy(ql.mask), torch.full((q,), rho),
                   n_docs=spec.n_docs, k=30, q_block=40)
    np.testing.assert_array_equal(b.topk_docs.numpy(), np.asarray(a.topk_docs))
    np.testing.assert_array_equal(b.topk_scores.numpy(),
                                  np.asarray(a.topk_scores))
    np.testing.assert_array_equal(b.work.numpy(), np.asarray(a.work))
    for i in (0, 7):                          # the single-query level cut
        want = ref_level_cut(ref, jnp.asarray(ql.terms[i]),
                             jnp.asarray(ql.mask[i]), rho)
        got = _level_cut(shard, torch.from_numpy(ql.terms[i]),
                         torch.from_numpy(ql.mask[i]), rho)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("theta", [1.0, 1.2])
def test_daat_serve_matches_reference(shards, theta):
    index, ql, ref, ref_spec, got, spec = shards
    q = len(ql.terms)
    kw = dict(n_docs=spec.n_docs, n_blocks=spec.n_blocks,
              block_size=spec.block_size, k=20,
              bcap=spec.max_blocks_per_term)
    a = ref_daat_serve(ref, jnp.asarray(ql.terms), jnp.asarray(ql.mask),
                       jnp.full(q, theta), cap=ref_spec.max_df,
                       qcap=query_lane_budget(index.df, ql.terms, ql.mask),
                       backend="jnp", **kw)
    b = daat_serve(got, torch.from_numpy(ql.terms),
                   torch.from_numpy(ql.mask), torch.full((q,), theta), **kw)
    np.testing.assert_array_equal(b.work.numpy(), np.asarray(a.work))
    np.testing.assert_array_equal(b.blocks.numpy(), np.asarray(a.blocks))
    np.testing.assert_allclose(b.topk_scores.numpy(),
                               np.asarray(a.topk_scores), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(b.topk_docs.numpy(),
                                  np.asarray(a.topk_docs))
