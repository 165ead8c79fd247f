"""The port's single-query kernel wrappers against the reference's.

``impact_accumulate``, ``blockmax_score``, ``score_histogram`` and
``histogram_topk`` of ``repro_torch.kernels`` (the plain versions, which a
wrapper runs for CPU tensors) against the reference's wrappers run with
``interpret=True`` and against the reference's ``*_ref`` oracles, over the
parameter sweeps of ``tests/test_kernels.py``, plus a ``cap`` small enough
to overflow, ``lstar > 0``, dead lanes, ragged tails and the padding /
``k``-above-count case of ``histogram_topk``.  The bucketed kernels
themselves are held to the reference's Pallas bucketed kernels on one
layout.

Tolerances: integer outputs exact.  ``blockmax_score`` within 1e-4 of the
Pallas interpret output, as the reference's own test asks (its one-hot
f32 matmul adds a doc's scores in another order), and bit-equal to the
port's ``blockmax_score_ref``, a sequential scatter of the flat lanes on
the CPU: the port adds each doc's lanes in their own order.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.kernels.blockmax_score.kernel import (
    blockmax_score_bucketed as ref_bm_bucketed)
from repro.kernels.blockmax_score.ops import blockmax_score as ref_bm
from repro.kernels.blockmax_score.ops import blockmax_score_ref as ref_bm_ref
from repro.kernels.impact_accumulate.kernel import (
    impact_accumulate_bucketed as ref_ia_bucketed)
from repro.kernels.impact_accumulate.ops import impact_accumulate as ref_ia
from repro.kernels.impact_accumulate.ops import (
    impact_accumulate_ref as ref_ia_ref)
from repro.kernels.score_histogram.kernel import (
    score_histogram as ref_histogram)
from repro.kernels.score_histogram.ops import histogram_topk as ref_topk
from repro.kernels.score_histogram.ref import (
    score_histogram_ref as ref_histogram_ref)
from repro_torch.kernels.blockmax_score.ops import (blockmax_score,
                                                    blockmax_score_bucketed,
                                                    blockmax_score_ref)
from repro_torch.kernels.buckets import bucket_by_tile
from repro_torch.kernels.impact_accumulate.ops import (
    impact_accumulate, impact_accumulate_bucketed, impact_accumulate_ref)
from repro_torch.kernels.score_histogram.ops import (histogram_topk,
                                                     score_histogram,
                                                     score_histogram_ref)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side, and
    torch's thread pool contending with them and with JAX's costs far more
    than it gains at these sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _flat_impacts(n_docs, p, lstar):
    """The inputs of ``test_kernels.py``'s impact sweep."""
    rng = np.random.RandomState(n_docs + p + lstar)
    docs = rng.randint(0, n_docs, p).astype(np.int32)
    docs[rng.random_sample(p) < 0.15] = -1
    imps = rng.randint(1, 256, p).astype(np.int32)
    return docs, imps


def _flat_scores(n_docs, p, bs, survive_frac):
    """The inputs of ``test_kernels.py``'s block-max sweep."""
    rng = np.random.RandomState(p)
    docs = rng.randint(0, n_docs, p).astype(np.int32)
    docs[rng.random_sample(p) < 0.1] = -1
    scores = (rng.random_sample(p) * 8).astype(np.float32)
    nb = (n_docs + bs - 1) // bs
    survive = rng.random_sample(nb) < survive_frac
    return docs, scores, survive


def _overflows(docs, n_docs, tile_d, cap):
    b = bucket_by_tile(_t(docs), _t(docs), -1, n_docs=n_docs, tile_d=tile_d,
                       cap=cap)
    return bool(b.overflow(cap).any())


# ---------------------------------------------------------------------------
# impact_accumulate (kernel 4)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_docs,p,tile_d,cap", [
    (512, 2048, 128, 256),
    (1000, 5000, 128, 128),     # overflow residue + ragged tail
    (4096, 512, 256, 512),
    (128, 128, 128, 1024),
])
@pytest.mark.parametrize("lstar", [0, 128])
def test_impact_accumulate_matches_reference(n_docs, p, tile_d, cap, lstar):
    docs, imps = _flat_impacts(n_docs, p, lstar)
    want = np.asarray(ref_ia(jnp.asarray(docs), jnp.asarray(imps),
                             jnp.asarray(lstar, jnp.int32), n_docs=n_docs,
                             tile_d=tile_d, cap=cap, interpret=True))
    np.testing.assert_array_equal(
        want, np.asarray(ref_ia_ref(jnp.asarray(docs), jnp.asarray(imps),
                                    jnp.int32(lstar), n_docs)))
    got = impact_accumulate(_t(docs), _t(imps), lstar, n_docs=n_docs,
                            tile_d=tile_d, cap=cap)
    assert got.dtype == torch.int32 and got.shape == (n_docs,)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        impact_accumulate_ref(_t(docs), _t(imps), lstar, n_docs).numpy(),
        want)
    if (n_docs, cap) == (1000, 128):
        assert _overflows(docs, n_docs, tile_d, cap)


@pytest.mark.parametrize("lstar", [0, 77])
def test_impact_accumulate_bucketed_matches_pallas(lstar):
    """The bucketed function itself on one layout (dead lanes, an empty
    tile, a ragged tail) against the reference's Pallas kernel."""
    n_docs, tile_d, cap = 1000, 128, 512
    docs, imps = _flat_impacts(n_docs, 3000, 0)
    docs[(docs >= 256) & (docs < 384)] = -1            # tile 2 empty
    b = bucket_by_tile(_t(docs), _t(imps), 0, n_docs=n_docs, tile_d=tile_d,
                       cap=cap)
    want = np.asarray(ref_ia_bucketed(
        jnp.asarray(b.docs_b.numpy()), jnp.asarray(b.vals_b.numpy()),
        jnp.asarray(lstar, jnp.int32), tile_d=tile_d, interpret=True))
    got = impact_accumulate_bucketed(
        b.docs_b, b.vals_b, torch.tensor([lstar], dtype=torch.int32),
        tile_d=tile_d)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[2].sum() == 0 and want.sum() > 0


def test_impact_accumulate_all_lanes_dead():
    docs = np.full(700, -1, np.int32)
    imps = np.full(700, 9, np.int32)
    got = impact_accumulate(_t(docs), _t(imps), 0, n_docs=300, cap=64)
    np.testing.assert_array_equal(got.numpy(), np.zeros(300, np.int32))


# ---------------------------------------------------------------------------
# blockmax_score (kernel 5)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_docs,p,bs,survive_frac", [
    (1024, 4096, 64, 0.3),
    (2000, 2000, 64, 1.0),
    (512, 8192, 128, 0.05),
    (1000, 6000, 64, 0.8),      # overflow residue at cap 256, ragged tail
    (700, 3000, 64, 0.0),       # every block pruned
])
def test_blockmax_score_matches_reference(n_docs, p, bs, survive_frac):
    docs, scores, survive = _flat_scores(n_docs, p, bs, survive_frac)
    want = np.asarray(ref_bm(jnp.asarray(docs), jnp.asarray(scores),
                             jnp.asarray(survive), n_docs=n_docs,
                             block_size=bs, tile_d=128, cap=256,
                             interpret=True))
    np.testing.assert_allclose(
        np.asarray(ref_bm_ref(jnp.asarray(docs), jnp.asarray(scores),
                              jnp.asarray(survive), n_docs, bs)),
        want, rtol=0, atol=1e-4)
    got = blockmax_score(_t(docs), _t(scores), _t(survive), n_docs=n_docs,
                         block_size=bs, tile_d=128, cap=256)
    assert got.dtype == torch.float32 and got.shape == (n_docs,)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(
        got.numpy(), blockmax_score_ref(_t(docs), _t(scores), _t(survive),
                                        n_docs, bs).numpy())
    if survive_frac == 0.0:
        assert not got.numpy().any()
    if n_docs == 1000:
        keep = np.where(survive[np.maximum(docs, 0) // bs] & (docs >= 0),
                        docs, -1)
        assert _overflows(keep, n_docs, 128, 256)


def test_blockmax_score_bucketed_matches_pallas():
    """The bucketed function itself (no residue, some tiles flagged dead)
    against the reference's Pallas kernel."""
    n_docs, tile_d, cap = 1000, 128, 1024
    docs, scores, _ = _flat_scores(n_docs, 3000, 64, 1.0)
    b = bucket_by_tile(_t(docs), _t(scores), 0.0, n_docs=n_docs,
                       tile_d=tile_d, cap=cap)
    n_tiles = b.docs_b.shape[0]
    survive_t = np.ones(n_tiles, np.int32)
    survive_t[[1, 5]] = 0
    want = np.asarray(ref_bm_bucketed(
        jnp.asarray(b.docs_b.numpy()), jnp.asarray(b.vals_b.numpy()),
        jnp.asarray(survive_t), tile_d=tile_d, interpret=True))
    got = blockmax_score_bucketed(
        b.docs_b, b.vals_b, _t(survive_t), torch.zeros(0, dtype=torch.int32),
        torch.zeros(0), torch.zeros(n_tiles + 1, dtype=torch.int32),
        tile_d=tile_d)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert not want[[1, 5]].any() and not got.numpy()[[1, 5]].any()


def test_blockmax_score_adds_each_doc_in_lane_order():
    """Rule (d): a doc's scores are added in the flat lanes' order from 0.0,
    the bucket first and then the residue.  With cap 2, doc 5's lanes
    (3, 1e8, 3) lie one in the bucket and two in the residue: in order the
    sum is 1e8 (each 3 is lost to rounding); adding the two 3s first would
    give 1e8 + 8."""
    docs = np.asarray([5, 9, 5, 5], np.int32)
    scores = np.asarray([3.0, 1.0, 1e8, 3.0], np.float32)
    b = bucket_by_tile(_t(docs), _t(scores), 0.0, n_docs=16, tile_d=16,
                       cap=2)
    assert int(b.overflow(2).sum()) == 2       # doc 5's 1e8 and last 3
    got = blockmax_score(_t(docs), _t(scores), torch.ones(1, dtype=bool),
                         n_docs=16, block_size=16, tile_d=16, cap=2)
    want = np.float32(0.0)
    for s in scores[docs == 5]:
        want = np.float32(want + s)
    assert got[5].item() == want == np.float32(1e8)
    assert got[9].item() == 1.0


def _bucketed_layout(tiles, cap):
    """Kernel 5's inputs from per-tile lane lists [(docs, scores), ...]: the
    bucket rows (each tile's first ``cap`` lanes, -1 padded), the run (every
    tile's lanes in order) and the run's tile starts."""
    n_tiles = len(tiles)
    docs_b = np.full((n_tiles, cap), -1, np.int32)
    scores_b = np.zeros((n_tiles, cap), np.float32)
    for i, (d, s) in enumerate(tiles):
        docs_b[i, :min(cap, len(d))] = d[:cap]
        scores_b[i, :min(cap, len(d))] = s[:cap]
    run_start = np.concatenate([[0], np.cumsum([len(d) for d, _ in tiles])])
    run_docs = np.concatenate([d for d, _ in tiles] + [[]]).astype(np.int32)
    run_scores = np.concatenate([s for _, s in tiles] + [[]]
                                ).astype(np.float32)
    return docs_b, scores_b, run_docs, run_scores, run_start.astype(np.int32)


def _edge_tiles(case, rng):
    """(tiles, cap, survive_t, tile_d) of one edge case of kernel 5."""
    def lanes(n, tile_d=128, dead=0.0):
        d = rng.randint(0, tile_d, n).astype(np.int32)
        d[rng.random_sample(n) < dead] = -1
        return d, (rng.random_sample(n) * 8).astype(np.float32)
    if case == "dead_lanes_inside_rows":
        return [lanes(200, dead=0.3) for _ in range(6)], 256, [1] * 6, 128
    if case == "full_row_and_residue":
        return [lanes(256), lanes(556, dead=0.1), lanes(40)], 256, [1] * 3, \
            128
    if case == "dead_tile_with_residue":
        return [lanes(100), lanes(356), lanes(0)], 256, [1, 0, 0], 128
    if case == "one_doc_many_lanes":
        big = np.tile(np.asarray([1e8, 3.0, 3.0, -1e8, 3.0], np.float32),
                      120)
        return [(np.full(600, 7, np.int32), big), lanes(90)], 256, [1, 1], \
            128
    if case == "narrow_tile":          # docs 48 and 49 lie past the tile
        return [lanes(300, 50, dead=0.2) for _ in range(5)], 128, \
            [1, 0, 1, 1, 1], 48
    assert case == "all_tiles_empty"
    return [(np.zeros(0, np.int32), np.zeros(0, np.float32))] * 4, 64, \
        [1, 1, 0, 0], 128


@pytest.mark.parametrize("case", [
    "dead_lanes_inside_rows", "full_row_and_residue",
    "dead_tile_with_residue", "one_doc_many_lanes", "narrow_tile",
    "all_tiles_empty"])
def test_blockmax_score_bucketed_edge_cases(case):
    """The edges of the card's kernel-5 design, which ``chip_smoke.py`` also
    drives on the card: the plain version bit for bit against each doc's
    lanes added in lane order from 0.0 — the bucket, then the residue —
    and against the reference (its Pallas kernel in interpret mode, then
    its scatter of the residue) within the bound on two orders of one f32
    sum: the reference's one-hot matmul adds a doc's lanes in another
    order, which shows where one doc's 600 lanes mix 1e8 and 3."""
    rng = np.random.RandomState(len(case))
    tiles, cap, survive, tile_d = _edge_tiles(case, rng)
    docs_b, scores_b, run_docs, run_scores, run_start = _bucketed_layout(
        tiles, cap)
    survive_t = np.asarray(survive, np.int32)
    got = blockmax_score_bucketed(
        *map(_t, (docs_b, scores_b, survive_t, run_docs, run_scores,
                  run_start)), tile_d=tile_d).numpy()

    n_tiles = len(tiles)
    res_doc, res_val = [], []
    for t in range(n_tiles):
        for j in range(run_start[t] + cap, run_start[t + 1]):
            if 0 <= run_docs[j] < tile_d:
                res_doc.append(t * tile_d + run_docs[j])
                res_val.append(run_scores[j])
    want = ref_bm_bucketed(jnp.asarray(docs_b), jnp.asarray(scores_b),
                           jnp.asarray(survive_t), tile_d=tile_d,
                           interpret=True).reshape(-1)
    want = np.asarray(want.at[jnp.asarray(res_doc, jnp.int32)].add(
        jnp.asarray(res_val, jnp.float32))).reshape(n_tiles, tile_d)

    seq = np.zeros((n_tiles, tile_d), np.float32)
    n = np.zeros((n_tiles, tile_d))
    mag = np.zeros((n_tiles, tile_d))
    for t in range(n_tiles):
        row = list(zip(docs_b[t], scores_b[t])) if survive_t[t] else []
        row += list(zip(run_docs[run_start[t] + cap:run_start[t + 1]],
                        run_scores[run_start[t] + cap:run_start[t + 1]]))
        for d, s in row:
            if 0 <= d < tile_d:
                seq[t, d] = np.float32(seq[t, d] + s)
                n[t, d] += 1
                mag[t, d] += abs(float(s))
    np.testing.assert_array_equal(got, seq)
    # two orders of one f32 sum differ by at most 2 (n - 1) 2^-24 sum |x|
    bound = 2 * np.maximum(n - 1, 0) * 2.0 ** -24 * mag
    assert (np.abs(got.astype(np.float64) - want) <= bound).all()
    if case == "one_doc_many_lanes":     # the order shows in the sum
        assert seq[0, 7] != np.float32(np.sum(tiles[0][1], dtype=np.float64))
    if case == "all_tiles_empty":
        assert not got.any()


# ---------------------------------------------------------------------------
# score_histogram and histogram_topk (kernel 7)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,n_bins", [(4096, 512), (8192, 2048)])
def test_score_histogram_matches_reference(n, n_bins):
    rng = np.random.RandomState(n)
    s = rng.randint(-1, n_bins, n).astype(np.int32)
    want = np.asarray(ref_histogram(jnp.asarray(s), n_bins=n_bins,
                                    tile_n=512, interpret=True))
    got = score_histogram(_t(s), n_bins=n_bins)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(score_histogram_ref(_t(s), n_bins).numpy(),
                                  want)


@pytest.mark.parametrize("n", [1000, 3001])
def test_score_histogram_any_n_and_clipping(n):
    """N not a multiple of 512 (the reference then uses its ref), scores at
    and past n_bins (clipped into the last bin) and negatives (ignored)."""
    rng = np.random.RandomState(n)
    s = rng.randint(-5, 3000, n).astype(np.int32)
    want = np.asarray(ref_histogram_ref(jnp.asarray(s), 2048))
    got = score_histogram(_t(s))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[-1].item() == int((s >= 2047).sum())
    assert got.sum().item() == int((s >= 0).sum())


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("k", [10, 100, 500])
def test_histogram_topk_matches_reference(seed, k):
    rng = np.random.RandomState(seed)
    s = rng.randint(0, 1500, 4096).astype(np.int32)
    wv, wi = ref_topk(jnp.asarray(s), k=k, interpret=True)
    gv, gi = histogram_topk(_t(s), k=k)
    assert gv.dtype == torch.int32 and gi.dtype == torch.int32
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    # lax.top_k's order: score descending, ties to the lower index
    lv, li = jax.lax.top_k(jnp.asarray(s), k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(li))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(lv))


@pytest.mark.parametrize("n,k", [(1000, 10), (777, 64)])
def test_histogram_topk_k_above_nonnegative_count(n, k):
    """Fewer than k scores are >= 0: zeros and -1 padding tie at key 0 and
    are taken by index, as in the reference (not "fixed")."""
    s = np.full(n, -1, np.int32)
    s[[5, n - 100, 17, 40]] = [3, 0, 7, 2500]
    wv, wi = ref_topk(jnp.asarray(s), k=k, interpret=True)
    gv, gi = histogram_topk(_t(s), k=k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    assert gi[:3].tolist() == [40, 17, 5] and gi[3].item() == 0


def test_histogram_topk_ties_go_to_lower_index():
    rng = np.random.RandomState(4)
    s = rng.randint(0, 6, 2048).astype(np.int32)   # heavy ties
    wv, wi = ref_topk(jnp.asarray(s), k=300, interpret=True)
    gv, gi = histogram_topk(_t(s), k=300)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    order = np.lexsort((np.arange(len(s)), -s))[:300]
    np.testing.assert_array_equal(gi.numpy(), order)


def test_histogram_topk_rejects_bad_k():
    with pytest.raises(ValueError):
        histogram_topk(torch.zeros(10, dtype=torch.int32), k=11)
