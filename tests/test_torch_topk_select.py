"""Kernels 6 and 7 as redesigned for the H100 around one shared select,
against the plain versions and the reference.

The shared select (``kernels/topk_select.{cuh,py}``) takes the k largest
of a row of 32-bit keys, ties to the lower index: radix rounds of 8 bits
for the k-th key, each of the cluster's 8 blocks counting its contiguous
index range; an ordered compaction that takes every key above the k-th
and the keys equal to it in index order; a sort of the selection.

Kernel 6 (``dense_topk.cu``) keys every (query, doc) score of a doc tile
and selects per query; its plain twin ``dense_topk_selected`` is held bit
for bit to ``dense_topk_plain`` and to the reference's ``dense_topk`` on
its ``jnp`` backend and its Pallas kernel in interpret mode, on
grid-quantized embeddings (every dot product exact in fp32).

Kernel 7 (``score_histogram.cu``) is one fused launch,
``histogram_select``: the histogram, the threshold t and the selection.
Its plain twin ``histogram_topk_selected`` is held to
``histogram_select_plain`` (all three outputs) and to the reference's
``histogram_topk`` with ``interpret=True``.

Cases: ties on the k-th key across tiles and blocks; all-equal rows; -0.0
against +0.0; k = N and k = 2,048; ragged tails; more than k scores past
the last bin (the radix rounds); fewer than k non-negative scores;
negatives tying with zeros at t = 0; N not a multiple of 512.  Integer
outputs and exact fp32 scores: tolerance 0.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.dense import embeddings as ref_emb
from repro.kernels.dense_topk import dense_topk as ref_dense_topk
from repro.kernels.score_histogram.ops import histogram_topk as ref_topk
from repro_torch.kernels import topk_select as ts
from repro_torch.kernels.dense_topk import ops as dt
from repro_torch.kernels.score_histogram import ops as sh


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# the shared select
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,k,hi", [(1000, 10, 1 << 32),
                                    (1000, 1000, 1 << 32), (5000, 2048, 50),
                                    (777, 300, 3), (9, 9, 1),
                                    (3001, 1, 1 << 32), (4096, 129, 1 << 20)])
def test_select_matches_a_stable_sort(n, k, hi):
    """Random 32-bit keys (the top bit set in half of them at 2^32), ties
    by the thousand at small ranges: the k largest, ties to the lower
    index."""
    keys = _t(np.random.RandomState(n + k).randint(0, hi, (3, n),
                                                   dtype=np.int64))
    sel_key, sel_idx = ts.topk(keys, k)
    want = torch.sort(keys, dim=1, descending=True, stable=True)
    np.testing.assert_array_equal(sel_idx.numpy(), want.indices[:, :k])
    np.testing.assert_array_equal(sel_key.numpy(), want.values[:, :k])


def test_radix_counts_are_per_block():
    """The k-th key and each block's counts above and equal to it, over
    the cluster's contiguous ranges (a row of 1,001: the last block is
    short)."""
    rng = np.random.RandomState(5)
    keys = _t(rng.randint(0, 40, (2, 1001), dtype=np.int64))
    kth, above, eq = ts.radix_kth(keys, 300)
    blk = ts.block_of(1001, "cpu")
    assert above.shape == eq.shape == (2, ts.CLUSTER)
    for r in range(2):
        want = torch.sort(keys[r], descending=True).values[299]
        assert kth[r] == want
        for b in range(ts.CLUSTER):
            mine = keys[r][blk == b]
            assert above[r, b] == int((mine > want).sum())
            assert eq[r, b] == int((mine == want).sum())


def test_score_key_orders_floats_and_merges_signed_zeros():
    s = torch.tensor([-3.5, -0.0, 0.0, 1e-30, 2.0, -1e-30, 7.25],
                     dtype=torch.float32)
    key = dt.score_key(s)
    assert key[1] == key[2]                        # -0.0 keys as +0.0
    order = torch.argsort(key, stable=True)
    np.testing.assert_array_equal(order.numpy(), [0, 5, 1, 2, 3, 4, 6])
    back = dt.key_score(key)
    np.testing.assert_array_equal(back.numpy(),
                                  np.array([-3.5, 0, 0, 1e-30, 2, -1e-30,
                                            7.25], np.float32))
    assert not torch.signbit(back[1])
    # through the select, -0.0 and +0.0 tie and go by index, as in a stable
    # sort of the scores
    z = torch.tensor([[-0.0, 0.0, -0.0, 1.0, 0.0, -1.0]])
    _, idx = ts.topk(dt.score_key(z), 4)
    np.testing.assert_array_equal(idx.numpy(), [[3, 0, 1, 2]])
    np.testing.assert_array_equal(
        idx.numpy(), torch.sort(-z, dim=1, stable=True).indices[:, :4])


# ---------------------------------------------------------------------------
# kernel 6: dense_topk_tiles
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def grid_embeddings():
    doc_emb, table = ref_emb.synthetic_embeddings(3000, 256, d=24, seed=11)
    rng = np.random.RandomState(2)
    q_emb = ref_emb.embed_queries(table, rng.randint(0, 256, (6, 5)),
                                  np.ones((6, 5), np.float32))
    return doc_emb, q_emb


def _dense_case(name, doc_emb, q_emb):
    """(q_emb, doc_emb, k) of one named case."""
    if name == "ragged_n_2999_k33":
        return q_emb, doc_emb[:2999], 33
    if name == "ties_across_tiles_and_blocks":   # every score 3x, 100 apart
        return q_emb, np.concatenate([doc_emb[:700]] * 3), 128
    if name == "k_2048":
        return q_emb[:2], np.concatenate([doc_emb[:700]] * 3), 2048
    if name == "k_equals_n":
        return q_emb, doc_emb[:600], 600
    if name == "all_equal_rows":
        return q_emb[:3], np.repeat(doc_emb[:1], 1500, axis=0), 100
    if name == "zero_rows_tie_at_the_kth":
        # non-negative queries and rows score > 0, zero rows 0.0, negated
        # rows < 0: the 400th key is 0, shared by 1,500 rows over all the
        # blocks
        pos, zero = np.abs(doc_emb[:300]), np.zeros((750, 24), np.float32)
        docs = np.concatenate([pos[:150], zero, pos[150:], zero,
                               -pos[:200]])
        return np.abs(q_emb), docs, 400
    if name == "n_not_multiple_of_512_k1":
        return q_emb[:1], doc_emb[:1025], 1
    raise KeyError(name)


DENSE_CASES = ["ragged_n_2999_k33", "ties_across_tiles_and_blocks", "k_2048",
               "k_equals_n", "all_equal_rows", "zero_rows_tie_at_the_kth",
               "n_not_multiple_of_512_k1"]


@pytest.mark.parametrize("case", DENSE_CASES)
def test_dense_twin_equals_plain(grid_embeddings, case):
    q, d, k = _dense_case(case, *grid_embeddings)
    want = dt.dense_topk_plain(_t(q), _t(d), k)
    got = dt.dense_topk_selected(_t(q), _t(d), k)
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int64
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
    # the wrapper on CPU tensors is the plain version
    wrap = dt.dense_topk_tiles(_t(q), _t(d), k)
    np.testing.assert_array_equal(wrap[1].numpy(), want[1].numpy())


@pytest.mark.parametrize("backend", ["jnp", "interpret"])
@pytest.mark.parametrize("case", ["ragged_n_2999_k33",
                                  "ties_across_tiles_and_blocks",
                                  "zero_rows_tie_at_the_kth", "k_2048"])
def test_dense_twin_matches_reference(grid_embeddings, case, backend):
    q, d, k = _dense_case(case, *grid_embeddings)
    if backend == "interpret":
        q = q[:2]                        # the interpreter walks Q x tiles
    sc, ids = ref_dense_topk(jnp.asarray(q), jnp.asarray(d), k,
                             backend=backend)
    got_sc, got_ids = dt.dense_topk_selected(_t(q), _t(d), k)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(ids, np.int64))
    np.testing.assert_array_equal(got_sc.numpy(), np.asarray(sc))


def test_dense_ties_on_the_kth_go_to_the_lower_ids(grid_embeddings):
    q, d, k = _dense_case("zero_rows_tie_at_the_kth", *grid_embeddings)
    _, ids = dt.dense_topk_selected(_t(q), _t(d), k)
    # 300 positive rows first, then the first 100 zero rows by id
    zeros = np.r_[150:900, 1050:1800]
    np.testing.assert_array_equal(np.sort(ids[:, 300:].numpy(), axis=1),
                                  np.tile(zeros[:100], (len(q), 1)))
    assert (np.diff(ids[:, 300:].numpy(), axis=1) > 0).all()


# ---------------------------------------------------------------------------
# kernel 7: score_histogram fused into histogram_topk
# ---------------------------------------------------------------------------

def _scores(name):
    """(int32 scores, k) of one named case."""
    rng = np.random.RandomState(len(name))
    if name == "jass_ties_across_blocks":         # ninety per cent zeros
        s = rng.randint(1, 60, 8192).astype(np.int32)
        s[rng.rand(8192) < 0.9] = 0
        return s, 128
    if name == "kth_tied_by_1500_across_blocks":
        s = np.zeros(8192, np.int32)
        s[rng.choice(8192, 1600, replace=False)] = [50] * 1500 + [60] * 100
        return s, 128
    if name == "all_equal":
        return np.full(4097, 9, np.int32), 2048
    if name == "k_equals_n_ragged":
        return rng.randint(0, 700, 1000).astype(np.int32), 1000
    if name == "k_2048":
        return rng.randint(0, 300, 4096).astype(np.int32), 2048
    if name == "more_than_k_past_the_last_bin":    # the radix rounds
        return rng.randint(0, 9000, 5000).astype(np.int32), 100
    if name == "fewer_than_k_nonnegative":
        s = np.full(3001, -1, np.int32)
        s[[5, 17, 40, 2999]] = [3, 0, 7, 2500]
        return s, 64
    if name == "negatives_tie_with_zeros_at_t0":
        return rng.randint(-3, 1, 4096).astype(np.int32), 128
    if name == "n_not_multiple_of_512":
        s = rng.randint(-5, 3000, 3001).astype(np.int32)
        return s, 333
    raise KeyError(name)


HIST_CASES = ["jass_ties_across_blocks", "kth_tied_by_1500_across_blocks",
              "all_equal", "k_equals_n_ragged", "k_2048",
              "more_than_k_past_the_last_bin", "fewer_than_k_nonnegative",
              "negatives_tie_with_zeros_at_t0", "n_not_multiple_of_512"]


@pytest.mark.parametrize("case", HIST_CASES)
def test_histogram_twin_equals_plain(case):
    s, k = _scores(case)
    want = sh.histogram_select_plain(_t(s), k, 2048)
    got = sh.histogram_topk_selected(_t(s), k, 2048)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    # the entry points on CPU tensors
    vals, idx = sh.histogram_topk(_t(s), k=k)
    np.testing.assert_array_equal(idx.numpy(), want[1].numpy())
    np.testing.assert_array_equal(sh.score_histogram(_t(s)).numpy(),
                                  want[2].numpy())


@pytest.mark.parametrize("case", HIST_CASES)
def test_histogram_twin_matches_reference(case):
    s, k = _scores(case)
    wv, wi = ref_topk(jnp.asarray(s), k=k, interpret=True)
    gv, gi, _ = sh.histogram_topk_selected(_t(s), k, 2048)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def test_histogram_alone_and_no_scores():
    """k = 0 is the histogram alone (``score_histogram``); no scores give an
    empty selection and a zero histogram."""
    s, _ = _scores("n_not_multiple_of_512")
    v, i, h = sh.histogram_topk_selected(_t(s), 0, 512)
    assert v.numel() == i.numel() == 0
    np.testing.assert_array_equal(h.numpy(),
                                  sh.score_histogram_ref(_t(s), 512).numpy())
    v, i, h = sh.histogram_select(torch.zeros(0, dtype=torch.int32), 0, 64)
    assert v.numel() == 0 and not h.any() and h.shape == (64,)
    with pytest.raises(ValueError, match="k="):
        sh.histogram_select(_t(s), len(s) + 1, 2048)


def test_histogram_threshold_paths():
    """Below the last bin the histogram gives the k-th key; at the last bin
    (scores clipped into it) the radix rounds find it: both select the
    same as a stable sort of the keys."""
    for case, radix in (("jass_ties_across_blocks", False),
                        ("more_than_k_past_the_last_bin", True)):
        s, k = _scores(case)
        hist = sh.score_histogram_ref(_t(s), 2048)
        ge = torch.flip(torch.cumsum(torch.flip(hist, [0]), 0), [0])
        t = int(torch.clamp((ge >= k).sum() - 1, min=0))
        assert (t == 2047) == radix
        v, i, _ = sh.histogram_topk_selected(_t(s), k, 2048)
        order = np.lexsort((np.arange(len(s)), -s.astype(np.int64)))[:k]
        np.testing.assert_array_equal(i.numpy(), order)
