"""Kernels 3 and 4 as redesigned for the H100, against the plain versions
and the reference's Pallas kernels.

Kernel 3 (``qd_feature_gather.cu``) is one cluster of blocks per query:
a candidate table in shared memory, match records per block, a
warp per column summing its records ranked by lane position, and a rescan
of the query's lanes for a column whose records overflow.  Its plain twin
``qd_feature_gather_recorded`` runs the same table, records, capacity and
rescan in PyTorch.  The twin is held bit for bit to
``qd_feature_gather_plain`` and to a NumPy loop that adds each
candidate's matching lanes in lane order from 0.0, on all three outputs;
and to the Pallas kernel run with ``interpret=True``: ``cnt`` and ``mx``
exactly, the sum within 1e-5 absolute plus 1e-6 of its magnitude (the
TPU's one-hot matmul adds the same scores in another order, as
``test_torch_kernels.py`` states; the overflow case adds 600 scores into
sums near 1,500).  Cases: a candidate whose matches exceed the records
(in all and in one block), repeated lanes, duplicate and -1
candidates, C = 50, 128 and 300, P not a multiple of 512, nine lane
chunks, Q = 1, all lanes dead.

Kernel 4 (``impact_accumulate_bucketed``) reads only each bucket row's
live prefix when given the rows' lengths.  Its plain version with the
lengths from ``bucket_by_tile`` equals the plain version without them and
the reference's Pallas kernel, on full, empty and mixed rows, and ignores
whatever lies at and past a row's length.  Integer sums: exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels.impact_accumulate.kernel import (
    impact_accumulate_bucketed as ref_ia_bucketed)
from repro.kernels.qd_feature_gather.ops import (
    qd_feature_gather as ref_qd_gather)
from repro_torch.kernels.buckets import bucket_by_tile
from repro_torch.kernels.impact_accumulate import ops as ia
from repro_torch.kernels.qd_feature_gather import ops as qd


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
# kernel 3: qd_feature_gather_lanes
# ---------------------------------------------------------------------------

def _lanes(seed, q, p, c, n, dead=0.2):
    rng = np.random.RandomState(seed)
    docs = rng.randint(0, n, (q, p)).astype(np.int32)
    docs[rng.rand(q, p) < dead] = -1
    scores = np.where(docs >= 0, rng.rand(q, p) * 5, 0).astype(np.float32)
    cand = rng.randint(0, n, (q, c)).astype(np.int32)
    cand[rng.rand(q, c) < 0.15] = -1
    return docs, scores, cand


def _case(name):
    """(lane_docs, lane_scores, cand) of one named case."""
    if name == "c50":
        return _lanes(0, 5, 700, 50, 300)
    if name == "c128":
        return _lanes(1, 4, 1024, 128, 400)
    if name == "c300_ragged_p":              # three column groups, P = 333
        return _lanes(2, 3, 333, 300, 200)
    if name == "q1":
        return _lanes(3, 1, 1000, 77, 120)
    if name == "all_dead":
        docs, scores, cand = _lanes(4, 3, 600, 50, 100, dead=1.0)
        return docs, scores, cand
    if name == "dup_and_pad_cands":
        docs, scores, cand = _lanes(5, 4, 800, 64, 60)
        cand[:, 10:20] = cand[:, :10]             # every doc twice
        cand[1, :] = -1                           # a row of padding
        cand[2, ::3] = -1
        return docs, scores, cand
    if name == "repeated_lanes":
        # a repeated query term repeats its posting range in the lanes
        docs, scores, cand = _lanes(6, 3, 400, 40, 500)
        return (np.concatenate([docs, docs, docs[:, :100]], axis=1),
                np.concatenate([scores, scores, scores[:, :100]], axis=1),
                cand)
    if name == "overflow":
        # doc 7 in 600 of 1,000 lanes: past the records of every segment
        docs, scores, cand = _lanes(7, 2, 1000, 50, 300)
        rng = np.random.RandomState(70)
        docs[:, rng.rand(1000) < 0.6] = 7
        scores = np.where(docs >= 0, rng.rand(2, 1000) * 5, 0
                          ).astype(np.float32)
        cand[:, 3] = 7
        cand[1, 40] = 7                           # and a duplicate of it
        return docs, scores, cand
    if name == "overflow_one_block":
        # 20 matches, all in the first chunk: past one block's records,
        # inside a warp's
        docs, scores, cand = _lanes(8, 2, 1600, 50, 300)
        docs[:, :200:10] = 9
        docs[:, 200:][docs[:, 200:] == 9] = -1
        cand[:, 0] = 9
        return docs, scores, cand
    if name == "many_chunks":
        # 9 chunks of 1,024 lanes: chunk 8 wraps to the first block again
        return _lanes(9, 2, 9001, 128, 2000)
    raise KeyError(name)


CASES = ("c50", "c128", "c300_ragged_p", "q1", "all_dead",
         "dup_and_pad_cands", "repeated_lanes", "many_chunks", "overflow",
         "overflow_one_block")


def _lane_order_oracle(docs, scores, cand):
    """Per (query, candidate) in NumPy: the matching lanes' scores added one
    by one in lane order from 0.0 (float32), their max from 0.0, their
    count."""
    q, c = cand.shape
    bm25 = np.zeros((q, c), np.float32)
    mx = np.zeros((q, c), np.float32)
    cnt = np.zeros((q, c), np.int32)
    for qi in range(q):
        for ci in range(c):
            d = cand[qi, ci]
            if d < 0:
                continue
            s = np.float32(0.0)
            for j in np.flatnonzero(docs[qi] == d):
                s = np.float32(s + scores[qi, j])
                mx[qi, ci] = max(mx[qi, ci], scores[qi, j])
                cnt[qi, ci] += 1
            bm25[qi, ci] = s
    return bm25, mx, cnt


def _fits(docs, cand):
    """Per (query, candidate >= 0): do its records fit the kernel's
    capacity (at most RECORDS in each block, WARP_RECORDS in all)?  Lane
    chunk k goes to block k % CLUSTER."""
    out = []
    for qi in range(docs.shape[0]):
        for d in cand[qi][cand[qi] >= 0]:
            blk = np.flatnonzero(docs[qi] == d) // qd.CHUNK % qd.CLUSTER
            per = np.bincount(blk, minlength=qd.CLUSTER)
            out.append(per.max() <= qd.RECORDS
                       and per.sum() <= qd.WARP_RECORDS)
    return np.asarray(out)


@pytest.mark.parametrize("case", CASES)
def test_recorded_twin_matches_plain_and_lane_order(case):
    docs, scores, cand = _case(case)
    want = _lane_order_oracle(docs, scores, cand)
    plain = qd.qd_feature_gather_plain(_t(docs), _t(scores), _t(cand))
    twin = qd.qd_feature_gather_recorded(_t(docs), _t(scores), _t(cand))
    for w, a, b in zip(want, plain, twin):
        assert a.dtype == b.dtype and a.shape == w.shape
        np.testing.assert_array_equal(a.numpy(), w)
        np.testing.assert_array_equal(b.numpy(), w)
    fits = _fits(docs, cand)
    if case.startswith("overflow"):
        assert not fits.all()                 # the rescan path is taken
    if case == "all_dead":
        assert not want[2].any()
    else:
        assert fits.any() and want[2].max() > 1   # the records are summed


@pytest.mark.parametrize("case", CASES)
def test_recorded_twin_matches_pallas(case):
    docs, scores, cand = _case(case)
    p_tile = 512 if docs.shape[1] > 512 else 256
    w_bm25, w_mx, w_cnt = map(np.asarray, ref_qd_gather(
        jnp.asarray(docs), jnp.asarray(scores), jnp.asarray(cand),
        p_tile=p_tile, interpret=True))
    bm25, mx, cnt = qd.qd_feature_gather_recorded(_t(docs), _t(scores),
                                                  _t(cand))
    np.testing.assert_array_equal(cnt.numpy(), w_cnt)
    np.testing.assert_array_equal(mx.numpy(), w_mx)
    # the matmul's order: 1e-5 absolute, and 1e-6 of the sum for the
    # overflow case's 600 addends (sums near 1,500, ulp 1.2e-4)
    np.testing.assert_allclose(bm25.numpy(), w_bm25, rtol=1e-6,
                               atol=1e-5)


def test_recorded_twin_sums_in_lane_order():
    """Scores whose float sum depends on the order (1e8, 3, -1e8, ...): in
    a column that fits the records and in one that overflows them, the
    twin adds in lane order, as the plain version does; a sum in another
    order gives other bits."""
    vals = np.float32([1e8, 3.0, 3.0, -1e8, 3.0])
    docs = np.full((1, 700), -1, np.int32)
    scores = np.zeros((1, 700), np.float32)
    docs[0, :600] = 5                          # 600 matches: the rescan
    scores[0, :600] = np.tile(vals, 120)
    docs[0, 600:610] = 6                       # 10 matches: the records
    scores[0, 600:610] = np.tile(vals, 2)
    cand = np.asarray([[5, 6, -1, 6]], np.int32)
    want = _lane_order_oracle(docs, scores, cand)
    plain = qd.qd_feature_gather_plain(_t(docs), _t(scores), _t(cand))
    twin = qd.qd_feature_gather_recorded(_t(docs), _t(scores), _t(cand))
    for w, a, b in zip(want, plain, twin):
        np.testing.assert_array_equal(a.numpy(), w)
        np.testing.assert_array_equal(b.numpy(), w)
    np.testing.assert_array_equal(want[2], [[600, 10, 0, 10]])
    reverse = np.float32(0.0)
    for v in scores[0, 600:610][::-1]:
        reverse = np.float32(reverse + v)
    assert reverse != want[0][0, 1]


def test_wrapper_runs_plain_version_on_cpu():
    """``qd_feature_gather_lanes`` on CPU tensors is the plain version, also
    through the padding entry point."""
    docs, scores, cand = _case("c300_ragged_p")
    want = qd.qd_feature_gather_plain(_t(docs), _t(scores), _t(cand))
    for got in (qd.qd_feature_gather_lanes(_t(docs), _t(scores), _t(cand)),
                qd.qd_feature_gather(_t(docs), _t(scores), _t(cand))):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), b.numpy())


# ---------------------------------------------------------------------------
# kernel 4: impact_accumulate_bucketed with each row's live length
# ---------------------------------------------------------------------------

def _flat(rows, seed, n_docs=1000, p=3000, tile_d=128):
    """Flat (docs, imps) lanes: ``full`` rows hold more lanes than the cap,
    ``empty`` rows none (every lane dead), ``mixed`` rows some of each."""
    rng = np.random.RandomState(seed)
    docs = rng.randint(0, n_docs, p).astype(np.int32)
    if rows == "empty":
        docs[:] = -1
    elif rows == "mixed":
        docs[rng.rand(p) < 0.15] = -1
        docs[(docs >= 2 * tile_d) & (docs < 3 * tile_d)] = -1   # tile 2
    imps = rng.randint(1, 256, p).astype(np.int32)
    return docs, imps


@pytest.mark.parametrize("rows,cap", [("full", 128), ("empty", 256),
                                      ("mixed", 512), ("mixed", 64)])
@pytest.mark.parametrize("lstar", [0, 100])
def test_bucketed_lengths_match_whole_rows_and_pallas(rows, cap, lstar):
    n_docs, tile_d = 1000, 128
    docs, imps = _flat(rows, cap + lstar)
    b = bucket_by_tile(_t(docs), _t(imps), 0, n_docs=n_docs, tile_d=tile_d,
                       cap=cap)
    lens = torch.clamp(torch.diff(b.start), max=cap).to(torch.int32)
    cut = torch.tensor([lstar], dtype=torch.int32)
    with_lens = ia.impact_accumulate_bucketed_plain(b.docs_b, b.vals_b, cut,
                                                    lens, tile_d=tile_d)
    whole = ia.impact_accumulate_bucketed_plain(b.docs_b, b.vals_b, cut,
                                                tile_d=tile_d)
    want = np.asarray(ref_ia_bucketed(
        jnp.asarray(b.docs_b.numpy()), jnp.asarray(b.vals_b.numpy()),
        jnp.asarray(lstar, jnp.int32), tile_d=tile_d, interpret=True))
    np.testing.assert_array_equal(with_lens.numpy(), whole.numpy())
    np.testing.assert_array_equal(with_lens.numpy(), want)
    # the wrapper on CPU tensors takes the same path
    np.testing.assert_array_equal(
        ia.impact_accumulate_bucketed(b.docs_b, b.vals_b, cut, lens,
                                      tile_d=tile_d).numpy(), want)
    n = lens.numpy()
    # the rows are prefix-packed: live slots below the length, -1 past it
    slot = np.arange(cap)[None, :]
    assert ((b.docs_b.numpy() >= 0) == (slot < n[:, None])).all()
    if rows == "full":
        assert (n == cap).all()
    elif rows == "empty":
        assert (n == 0).all() and not want.any()
    else:
        assert n[2] == 0 and 0 < n.max()


def test_bucketed_lengths_ignore_slots_past_them():
    """Slots at and past a row's length count for nothing, whatever they
    hold; without lengths the same slots count."""
    rng = np.random.RandomState(11)
    n_tiles, cap, tile_d = 6, 64, 32
    docs_b = rng.randint(0, tile_d, (n_tiles, cap)).astype(np.int32)
    imps_b = rng.randint(1, 256, (n_tiles, cap)).astype(np.int32)
    lens = np.asarray([0, 1, 17, 63, 64, 200], np.int32)   # 200: cap
    cut = torch.tensor([0], dtype=torch.int32)
    got = ia.impact_accumulate_bucketed_plain(_t(docs_b), _t(imps_b), cut,
                                              _t(lens), tile_d=tile_d)
    clean = docs_b.copy()
    clean[np.arange(cap)[None, :] >= lens[:, None]] = -1
    want = ia.impact_accumulate_bucketed_plain(_t(clean), _t(imps_b), cut,
                                               tile_d=tile_d)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert not got[0].any() and got[5].sum() == imps_b[5].sum()
    whole = ia.impact_accumulate_bucketed_plain(_t(docs_b), _t(imps_b), cut,
                                                tile_d=tile_d)
    assert whole.sum() > got.sum()


@pytest.mark.parametrize("n_docs,p,cap,lstar,dead", [
    (1000, 5000, 128, 0, 0.15),      # full rows and a residue
    (1000, 5000, 1024, 128, 0.15),   # no row full
    (300, 700, 64, 0, 1.0),          # every lane dead
    (257, 900, 32, 50, 0.3),         # a ragged tail tile
])
def test_flat_wrapper_matches_scatter(n_docs, p, cap, lstar, dead):
    """``impact_accumulate`` (bucketing, lengths, kernel, residue) against
    the direct integer scatter."""
    rng = np.random.RandomState(p + cap)
    docs = rng.randint(0, n_docs, p).astype(np.int32)
    docs[rng.rand(p) < dead] = -1
    imps = rng.randint(1, 256, p).astype(np.int32)
    got = ia.impact_accumulate(_t(docs), _t(imps), lstar, n_docs=n_docs,
                               cap=cap)
    want = ia.impact_accumulate_ref(_t(docs), _t(imps), lstar, n_docs)
    assert got.dtype == torch.int32 and got.shape == (n_docs,)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
