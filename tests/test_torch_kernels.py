"""The port's kernel functions against the reference's Pallas kernels.

Each plain PyTorch version in ``repro_torch.kernels`` (what a kernel
wrapper runs for CPU tensors) is held to the reference's Pallas kernel run
in interpret mode, on seeded inputs in the real bucketed layout
(``pack_tiles``) that include -1 lanes, -1 query slots, a repeated query
term, tiles with ``survive_t == 0``, an empty tile and a ghost tail tile.

Tolerances: the SAAT sums and the Stage-2 ``cnt``/``mx`` are exact; the
f32 sums of the DAAT and Stage-2 kernels are within 1e-5 (at most L
addends, summed in another order by the TPU's one-hot matmul).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels.blockmax_score.kernel import (
    blockmax_score_batched as ref_blockmax_batched)
from repro.kernels.blockmax_score.ops import (
    blockmax_score_tiles as ref_blockmax_tiles)
from repro.kernels.impact_accumulate.kernel import (
    impact_accumulate_batched as ref_impact_batched)
from repro.kernels.qd_feature_gather.ops import (
    qd_feature_gather as ref_qd_gather)
from repro_torch.index.builder import pack_tiles
from repro_torch.kernels.blockmax_score.ops import (blockmax_score_batched,
                                                    blockmax_score_tiles)
from repro_torch.kernels.impact_accumulate.ops import impact_accumulate_tiles
from repro_torch.kernels.qd_feature_gather.ops import (qd_feature_gather,
                                                       qd_feature_gather_lanes)

TILE_D, BLOCK = 128, 64
N_DOCS, VOCAB = 1000, 40          # 8 tiles; the last one overhangs N_DOCS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side, and
    torch's thread pool contending with them and with JAX's costs far more
    than it gains at these sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mirror(seed):
    """A bucketed mirror of random unique (term, doc) postings; docs
    256..383 hold no posting, so tile 2 is all padding."""
    rng = np.random.RandomState(seed)
    hit = rng.rand(VOCAB, N_DOCS) < 0.08
    hit[:, 256:384] = False
    term, doc = np.nonzero(hit)                  # (term, doc)-sorted
    scores = (rng.rand(len(doc)) * 8).astype(np.float32)
    imps = rng.randint(1, 256, len(doc)).astype(np.int32)
    docs_b, terms_b, (scores_b, imps_b), _ = pack_tiles(
        doc, term, [(scores, 0.0, np.float32), (imps, 0, np.int32)],
        N_DOCS, TILE_D)
    return docs_b, terms_b, scores_b, imps_b


def _qterms():
    """(Q, L) query terms: -1 slots, a repeated term, an all-empty row and
    a term with no postings."""
    return np.asarray([[3, 7, 11, -1, -1],
                       [5, 5, 9, -1, -1],
                       [-1, -1, -1, -1, -1],
                       [0, 1, 2, 3, 4],
                       [39, 20, -1, 12, -1],
                       [17, -1, 17, 30, 31],
                       [VOCAB + 5, 8, -1, -1, -1]], np.int32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("seed", [0, 1])
def test_impact_accumulate_matches_pallas(seed):
    docs_b, terms_b, _, imps_b = _mirror(seed)
    qterms = _qterms()
    lstar = np.asarray([0, 40, 0, 128, 255, 1, 256], np.int32)
    want = np.asarray(ref_impact_batched(
        jnp.asarray(docs_b), jnp.asarray(terms_b), jnp.asarray(imps_b),
        jnp.asarray(qterms), jnp.asarray(lstar), tile_d=TILE_D,
        interpret=True))
    got = impact_accumulate_tiles(_t(docs_b), _t(terms_b), _t(imps_b),
                                  _t(qterms), _t(lstar), tile_d=TILE_D)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[2].sum() == 0 and want[6].sum() == 0   # empty row / cut 256
    assert want[:, 2].sum() == 0                        # the empty tile


@pytest.mark.parametrize("seed", [0, 1])
def test_blockmax_score_tiles_matches_pallas(seed):
    docs_b, terms_b, scores_b, _ = _mirror(seed)
    qterms = _qterms()
    n_blocks = -(-N_DOCS // BLOCK)
    rng = np.random.RandomState(100 + seed)
    survive = rng.rand(len(qterms), n_blocks) < 0.5
    survive[1] = False                     # a query with no surviving tile
    survive[3, :4] = False                 # tiles 0 and 1 pruned for query 3
    want = np.asarray(ref_blockmax_tiles(
        jnp.asarray(docs_b), jnp.asarray(terms_b), jnp.asarray(scores_b),
        jnp.asarray(qterms), jnp.asarray(survive), tile_d=TILE_D,
        block_size=BLOCK, n_blocks=n_blocks, interpret=True))
    got = blockmax_score_tiles(_t(docs_b), _t(terms_b), _t(scores_b),
                               _t(qterms), _t(survive), tile_d=TILE_D,
                               block_size=BLOCK, n_blocks=n_blocks)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.numpy() == 0, want == 0)
    assert (want[1] == 0).all() and (want[3, :2] == 0).all()


def test_blockmax_score_tile_flag_overrides_block_flags():
    """A tile whose survive_t is 0 writes zeros even when block flags are
    set (the output comes from torch.empty on the card)."""
    docs_b, terms_b, scores_b, _ = _mirror(2)
    qterms = _qterms()
    q, n_tiles, bpt = len(qterms), docs_b.shape[0], TILE_D // BLOCK
    rng = np.random.RandomState(7)
    sb = (rng.rand(q, n_tiles, bpt) < 0.7).astype(np.int32)
    st = (rng.rand(q, n_tiles) < 0.6).astype(np.int32)
    want = np.asarray(ref_blockmax_batched(
        jnp.asarray(docs_b), jnp.asarray(terms_b), jnp.asarray(scores_b),
        jnp.asarray(qterms), jnp.asarray(sb), jnp.asarray(st),
        tile_d=TILE_D, block_size=BLOCK, interpret=True))
    got = blockmax_score_batched(_t(docs_b), _t(terms_b), _t(scores_b),
                                 _t(qterms), _t(sb), _t(st), tile_d=TILE_D,
                                 block_size=BLOCK)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert (got.numpy()[st == 0] == 0).all()


def _lanes(seed, q=5, p=700, c=50, n=300):
    rng = np.random.RandomState(seed)
    docs = rng.randint(0, n, (q, p)).astype(np.int32)
    docs[rng.rand(q, p) < 0.2] = -1                      # dead lanes
    docs[:, -37:] = -1                                   # a dead tail
    scores = np.where(docs >= 0, rng.rand(q, p) * 5, 0).astype(np.float32)
    cand = rng.randint(0, n, (q, c)).astype(np.int32)
    cand[rng.rand(q, c) < 0.15] = -1                     # padding slots
    cand[0, :3] = docs[0, :3].clip(0)                    # sure matches
    return docs, scores, cand


@pytest.mark.parametrize("seed", [0, 1])
def test_qd_feature_gather_matches_pallas(seed):
    docs, scores, cand = _lanes(seed)
    w_bm25, w_mx, w_cnt = map(np.asarray, ref_qd_gather(
        jnp.asarray(docs), jnp.asarray(scores), jnp.asarray(cand),
        p_tile=256, interpret=True))
    bm25, mx, cnt = qd_feature_gather(_t(docs), _t(scores), _t(cand),
                                      p_tile=256)
    assert cnt.dtype == torch.int32 and bm25.dtype == torch.float32
    np.testing.assert_array_equal(cnt.numpy(), w_cnt)
    np.testing.assert_array_equal(mx.numpy(), w_mx)
    np.testing.assert_allclose(bm25.numpy(), w_bm25, rtol=0, atol=1e-5)
    assert (w_cnt[cand < 0] == 0).all() and w_cnt.max() > 1


def test_qd_feature_gather_lanes_is_unpadded_function():
    """The kernel-level function needs no padding: it equals the padded
    entry point on ragged shapes."""
    docs, scores, cand = _lanes(3, p=333, c=17)
    a = qd_feature_gather_lanes(_t(docs), _t(scores), _t(cand))
    b = qd_feature_gather(_t(docs), _t(scores), _t(cand))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
