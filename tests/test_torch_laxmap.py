"""The port's per-query Stage-1 path against the reference.

* ``saat_serve_laxmap`` / ``daat_serve_laxmap`` of ``repro_torch.isn``
  (plain versions on the CPU) against the reference's on the fixture's 96
  queries, at ρ ∈ {256, 2,048, 8,192} and θ ∈ {1.0, 1.2}: SAAT ids, scores
  and ``work`` exact; DAAT ids, ``work`` and ``blocks`` exact and scores
  within 1e-4 (the largest difference seen is 0.0: the port adds each
  doc's scores in the gathered lanes' term-major order, the order of the
  reference's scatter);
* the port's laxmap against the port's batched engines, replaying
  ``tests/test_serving_pipeline.py``'s batched-vs-laxmap cases (DAAT scores
  within 1e-4: the batched engine sums phase 1 and the rest apart);
* ``_block_bounds`` and ``_accumulate`` against the reference's;
* the three cases of ``tests/test_kernel_engine_integration.py`` replayed
  on the port.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.index.postings import shard_from_index as ref_shard_from_index
from repro.isn.daat import _block_bounds as ref_block_bounds
from repro.isn.daat import daat_serve_laxmap as ref_daat_laxmap
from repro.isn.saat import _accumulate as ref_accumulate
from repro.isn.saat import _level_cut as ref_level_cut
from repro.isn.saat import saat_serve_laxmap as ref_saat_laxmap
from repro_torch.index.builder import build_index
from repro_torch.index.corpus import CorpusParams, build_corpus
from repro_torch.index.postings import shard_from_index
from repro_torch.isn.daat import _block_bounds, daat_serve, daat_serve_laxmap
from repro_torch.isn.saat import (_accumulate, _level_cut,
                                  _level_cut_batched, saat_serve,
                                  saat_serve_laxmap)
from repro_torch.kernels.impact_accumulate.ops import (impact_accumulate,
                                                       impact_accumulate_ref,
                                                       impact_accumulate_tiles)
from repro_torch.kernels.score_histogram.ops import histogram_topk


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
def shards(small_collection):
    """The reference's shard of the fixture and the port's shard of its
    own index built from the same parameters (array-equal, see
    ``test_torch_engines.py``)."""
    corpus, index, ql = small_collection
    ref, ref_spec = ref_shard_from_index(index)
    pindex = build_index(build_corpus(CorpusParams(
        n_docs=4096, vocab=2048, avg_doclen=80, zipf_a=1.05, seed=3)),
        stop_k=8)
    got, spec = shard_from_index(pindex, device="cpu")
    return ql, ref, ref_spec, got, spec


def _daat_kw(spec, k=20):
    return dict(n_docs=spec.n_docs, n_blocks=spec.n_blocks,
                block_size=spec.block_size, k=k, cap=spec.max_df,
                bcap=spec.max_blocks_per_term)


def _queries(ql, q=None):
    return torch.from_numpy(ql.terms[:q]), torch.from_numpy(ql.mask[:q])


# ---------------------------------------------------------------------------
# laxmap vs the reference's laxmap
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rho", [256, 2048, 8192])
def test_saat_laxmap_matches_reference(shards, rho):
    ql, ref, ref_spec, shard, spec = shards
    q = len(ql.terms)
    a = ref_saat_laxmap(ref, jnp.asarray(ql.terms), jnp.asarray(ql.mask),
                        jnp.full(q, rho, jnp.int32), n_docs=ref_spec.n_docs,
                        k=30, cap=rho)
    b = saat_serve_laxmap(shard, *_queries(ql), torch.full((q,), rho),
                          n_docs=spec.n_docs, k=30, cap=rho)
    assert b.topk_docs.dtype == torch.int32
    assert b.topk_scores.dtype == torch.float32
    np.testing.assert_array_equal(b.topk_docs.numpy(), np.asarray(a.topk_docs))
    np.testing.assert_array_equal(b.topk_scores.numpy(),
                                  np.asarray(a.topk_scores))
    np.testing.assert_array_equal(b.work.numpy(), np.asarray(a.work))


@pytest.mark.parametrize("theta", [1.0, 1.2])
def test_daat_laxmap_matches_reference(shards, theta):
    ql, ref, ref_spec, shard, spec = shards
    q = len(ql.terms)
    a = ref_daat_laxmap(ref, jnp.asarray(ql.terms), jnp.asarray(ql.mask),
                        jnp.full(q, theta), **_daat_kw(ref_spec))
    b = daat_serve_laxmap(shard, *_queries(ql), torch.full((q,), theta),
                          **_daat_kw(spec))
    np.testing.assert_array_equal(b.work.numpy(), np.asarray(a.work))
    np.testing.assert_array_equal(b.blocks.numpy(), np.asarray(a.blocks))
    np.testing.assert_allclose(b.topk_scores.numpy(),
                               np.asarray(a.topk_scores), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(b.topk_docs.numpy(),
                                  np.asarray(a.topk_docs))


def test_block_bounds_match_reference(shards):
    ql, ref, ref_spec, shard, spec = shards
    for i in range(16):
        want = ref_block_bounds(ref, jnp.asarray(ql.terms[i]),
                                jnp.asarray(ql.mask[i]), ref_spec.n_blocks,
                                ref_spec.max_blocks_per_term)
        got = _block_bounds(shard, torch.from_numpy(ql.terms[i]),
                            torch.from_numpy(ql.mask[i]), spec.n_blocks,
                            spec.max_blocks_per_term)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("rho", [256, 4096])
def test_accumulate_matches_reference(shards, rho):
    ql, ref, ref_spec, shard, spec = shards
    for i in range(8):
        prefix, _, _ = ref_level_cut(ref, jnp.asarray(ql.terms[i]),
                                     jnp.asarray(ql.mask[i]),
                                     jnp.asarray(rho))
        want = ref_accumulate(ref, jnp.asarray(ql.terms[i]),
                              jnp.minimum(prefix, rho), ref_spec.n_docs, rho)
        got = _accumulate(shard, torch.from_numpy(ql.terms[i]),
                          torch.from_numpy(np.minimum(np.asarray(prefix),
                                                      rho)),
                          spec.n_docs, rho)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# laxmap vs the port's batched engines (test_serving_pipeline.py replayed)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rho", [256, 2048, 8192])
def test_saat_batched_matches_laxmap(shards, rho):
    ql, _, _, shard, spec = shards
    q = len(ql.terms)
    rho_v = torch.full((q,), rho, dtype=torch.int32)
    a = saat_serve(shard, *_queries(ql), rho_v, n_docs=spec.n_docs, k=30)
    b = saat_serve_laxmap(shard, *_queries(ql), rho_v, n_docs=spec.n_docs,
                          k=30, cap=rho)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


@pytest.mark.parametrize("theta", [1.0, 1.2])
def test_daat_batched_matches_laxmap(shards, theta):
    ql, _, _, shard, spec = shards
    q = len(ql.terms)
    kw = _daat_kw(spec)
    cap = kw.pop("cap")
    a = daat_serve(shard, *_queries(ql), torch.full((q,), theta), **kw)
    b = daat_serve_laxmap(shard, *_queries(ql), torch.full((q,), theta),
                          cap=cap, **kw)
    np.testing.assert_array_equal(a.work.numpy(), b.work.numpy())
    np.testing.assert_array_equal(a.blocks.numpy(), b.blocks.numpy())
    np.testing.assert_allclose(a.topk_scores.numpy(), b.topk_scores.numpy(),
                               rtol=0, atol=1e-4)
    np.testing.assert_array_equal(a.topk_docs.numpy(), b.topk_docs.numpy())


def test_daat_batched_chunked_q_block(shards):
    """Streaming a large batch through q_block-sized chunks is exact."""
    ql, _, _, shard, spec = shards
    q = len(ql.terms)
    kw = _daat_kw(spec)
    cap = kw.pop("cap")
    a = daat_serve(shard, *_queries(ql), torch.ones(q), q_block=40, **kw)
    b = daat_serve_laxmap(shard, *_queries(ql), torch.ones(q), cap=cap, **kw)
    np.testing.assert_array_equal(a.topk_docs.numpy(), b.topk_docs.numpy())
    np.testing.assert_array_equal(a.work.numpy(), b.work.numpy())


# ---------------------------------------------------------------------------
# test_kernel_engine_integration.py replayed on the port
# ---------------------------------------------------------------------------

def test_kernel_reproduces_engine_accumulator(shards):
    """The flat kernel wrapper at a bucket width of 256 (overflowing) on the
    raw gathered prefixes reproduces the engine's accumulator and the
    direct scatter."""
    ql, _, _, shard, spec = shards
    rho = 2048
    for q in range(4):
        terms = torch.from_numpy(ql.terms[q])
        mask = torch.from_numpy(ql.mask[q])
        prefix, _, _ = _level_cut(shard, terms, mask, rho)
        prefix = torch.clamp(prefix, max=rho)
        acc_engine = _accumulate(shard, terms, prefix, spec.n_docs, rho)
        lanes = torch.arange(rho)
        pos = shard.offsets[terms.long()].long()[:, None] + lanes
        live = lanes < prefix[:, None]
        pos = torch.clamp(pos, max=shard.docs_imp.shape[0] - 1)
        docs = torch.where(live, shard.docs_imp[pos], -1).reshape(-1)
        imps = torch.where(live, shard.imp[pos], 0).reshape(-1)
        acc_kernel = impact_accumulate(docs, imps, 0, n_docs=spec.n_docs,
                                       tile_d=128, cap=256)
        np.testing.assert_array_equal(acc_engine.numpy(), acc_kernel.numpy())
        np.testing.assert_array_equal(
            acc_kernel.numpy(),
            impact_accumulate_ref(docs, imps, 0, spec.n_docs).numpy())


def test_batched_kernel_reproduces_engine_accumulator(shards):
    """The batched kernel over the shard's mirror reproduces the per-query
    accumulator bit-exactly."""
    ql, _, _, shard, spec = shards
    rho, q = 2048, 4
    terms, mask = _queries(ql, q)
    prefix, _, lstar = _level_cut_batched(shard, terms, mask,
                                          torch.full((q,), rho))
    acc_tiles = impact_accumulate_tiles(
        shard.tile_docs, shard.tile_terms, shard.tile_imps,
        torch.where(mask > 0, terms, -1).to(torch.int32), lstar,
        tile_d=spec.tile_d)
    acc_kernel = acc_tiles.reshape(q, -1)[:, :spec.n_docs]
    for i in range(q):
        acc_engine = _accumulate(shard, terms[i],
                                 torch.clamp(prefix[i], max=rho),
                                 spec.n_docs, rho)
        np.testing.assert_array_equal(acc_engine.numpy(),
                                      acc_kernel[i].numpy())


def test_histogram_topk_on_engine_scores(shards):
    ql, _, _, shard, spec = shards
    terms = torch.from_numpy(ql.terms[0])
    mask = torch.from_numpy(ql.mask[0])
    prefix, _, _ = _level_cut(shard, terms, mask, 4096)
    acc = _accumulate(shard, terms, torch.clamp(prefix, max=4096),
                      spec.n_docs, 4096)
    ref_v, ref_i = jax.lax.top_k(jnp.asarray(acc.numpy()), 64)
    vals, idx = histogram_topk(acc, k=64, n_bins=2048)
    np.testing.assert_array_equal(np.sort(vals.numpy()),
                                  np.sort(np.asarray(ref_v)))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_i))
