"""The batched mirror kernels' group design against the plain versions and
the reference's Pallas kernels.

``impact_accumulate.cu`` and ``blockmax_score.cu`` serve one doc tile for
a group of up to 32 queries a block, through a per-group term table (query
mask and first slot).  Their plain twins (``impact_accumulate_grouped``,
``blockmax_score_grouped``) run the same table, lookup and cell layout in
PyTorch.  Each twin is held, on ``pack_tiles`` mirrors at Q in
{1, 7, 32, 33, 64} (one group, a full group, a group of one, two full
groups), to its kernel's plain version bit for bit and to the Pallas
kernel run with ``interpret=True``: exactly for the integer SAAT sums;
within 1e-5 and with an equal zero pattern for the f32 DAAT scores (the
TPU's one-hot matmul sums at most L addends in another order).

The inputs hold -1 slots, a term repeated in one query, a term held by
several queries at different slots, an all -1 query, a term with no
postings, an empty tile (docs 256..383) and a ghost tail tile, a cut of
256 and of 0; at Q = 64 the second group's slots are all -1, and at
Q = 33 the DAAT survival prunes every tile of the second group, while
random tile flags of 0 override set block flags elsewhere.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels.blockmax_score.kernel import (
    blockmax_score_batched as ref_blockmax_batched)
from repro.kernels.impact_accumulate.kernel import (
    impact_accumulate_batched as ref_impact_batched)
from repro_torch.index.builder import pack_tiles
from repro_torch.kernels.blockmax_score import ops as bm
from repro_torch.kernels.impact_accumulate import ops as ia

TILE_D, BLOCK, L = 128, 64, 8
N_DOCS, VOCAB = 1000, 40          # 8 tiles; the last one overhangs N_DOCS
SHARED = 17                       # a term held by many queries


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side."""
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


def _queries(q, seed):
    """(Q, L) query terms, (Q,) cuts and (Q, n_tiles, bpt) / (Q, n_tiles)
    DAAT flags with the edge cases of the module docstring."""
    rng = np.random.RandomState(1000 + seed)
    qterms = rng.randint(0, VOCAB, (q, L)).astype(np.int32)
    qterms[rng.rand(q, L) < 0.35] = -1
    qterms[np.arange(q), np.arange(q) % L] = SHARED   # at different slots
    qterms[0, :3] = [5, 5, 5]                          # repeated in a query
    if q > 1:
        qterms[1] = -1                                 # an all -1 query
    if q > 2:
        qterms[2, L - 1] = VOCAB + 5                   # no postings
    if q == 64:
        qterms[32:] = -1                               # a group of -1 slots
    lstar = rng.randint(0, 200, q).astype(np.int32)
    lstar[0] = 0
    if q > 3:
        lstar[3] = 256                                 # cuts every impact
    n_tiles = -(-N_DOCS // TILE_D)
    sb = (rng.rand(q, n_tiles, TILE_D // BLOCK) < 0.7).astype(np.int32)
    st = (rng.rand(q, n_tiles) < 0.7).astype(np.int32)  # 0 over set flags
    if q == 33:
        st[32:] = 0                                    # a group all pruned
    return qterms, lstar, sb, st


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("q", [1, 7, 32, 33, 64])
@pytest.mark.parametrize("kernel", ["impact_accumulate", "blockmax_score"])
def test_grouped_twin_matches_plain_and_pallas(kernel, q, seed):
    docs_b, terms_b, scores_b, imps_b = _mirror(seed)
    qterms, lstar, sb, st = _queries(q, seed)
    if kernel == "impact_accumulate":
        args = (docs_b, terms_b, imps_b, qterms, lstar)
        kw = dict(tile_d=TILE_D)
        twin = ia.impact_accumulate_grouped(*map(_t, args), **kw)
        plain = ia.impact_accumulate_plain(*map(_t, args), **kw)
        want = np.asarray(ref_impact_batched(*map(jnp.asarray, args), **kw,
                                             interpret=True))
        assert twin.dtype == torch.int32
        np.testing.assert_array_equal(twin.numpy(), want)
        if q > 3:
            assert want[3].sum() == 0                  # cut 256
    else:
        args = (docs_b, terms_b, scores_b, qterms, sb, st)
        kw = dict(tile_d=TILE_D, block_size=BLOCK)
        twin = bm.blockmax_score_grouped(*map(_t, args), **kw)
        plain = bm.blockmax_score_plain(*map(_t, args), **kw)
        want = np.asarray(ref_blockmax_batched(*map(jnp.asarray, args), **kw,
                                               interpret=True))
        assert twin.dtype == torch.float32
        np.testing.assert_allclose(twin.numpy(), want, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(twin.numpy() == 0, want == 0)
        assert (want[st == 0] == 0).all()              # tile flag overrides
    assert twin.shape == plain.shape == want.shape
    assert torch.equal(twin.view(torch.int32),
                       plain.view(torch.int32))        # bit for bit
    assert want[:, 2].sum() == 0                       # the empty tile
    if q > 1:
        assert want[1].sum() == 0                      # all -1 slots
    if q == 64:
        assert want[32:].sum() == 0                    # the -1 group
    assert want[0].any()                               # real matches
