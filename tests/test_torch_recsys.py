"""The port's recsys family and embeddings against the reference's.

The four heads at their REDUCED sizes (fp32), with the reference's
``recsys.init(c, PRNGKey(0))`` parameters carried over by
``convert.recsys_params`` and inputs drawn from NumPy seeds
(``data/synthetic``'s generators for DeepFM, xDeepFM and BERT4Rec):

* the configurations and the registry, the parameter trees' shapes against
  the reference's abstract init at CONFIG and REDUCED, ``param_count``;
* each head's logits (or hidden states), loss and gradients against
  ``jax.value_and_grad`` of the reference's loss, leaf by leaf;
* ``streaming_topk`` (kernel 6's plain version on the CPU) and
  ``anytime_retrieval`` against the reference's scan and masked ``top_k``:
  k > n, n off the tile, budgets below k, 0 and past n, on grid-quantized
  embeddings (every dot product exact), so ids and scores are exact;
* the three padded EmbeddingBag modes and the ragged bag, with gradients;
* ``ctr_batches`` and ``seqrec_batches`` bit for bit;
* port-only, as ``tests/test_models_gnn_recsys.py`` checks the reference:
  a few AdamW steps lower each head's loss.

Tolerances: losses 1e-5 relative; logits and hidden states 1e-5 of their
largest magnitude; gradients 1e-4 of each leaf's largest magnitude (fp32
sums in other orders); top-k and the generators exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as ref_registry
from repro.data import synthetic as ref_synthetic
from repro.models import embedding as ref_emb
from repro.models import recsys as ref_rs
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.data import synthetic
from repro_torch.models import embedding, recsys
from repro_torch.train import optimizer, train_loop

HEADS = ("deepfm", "xdeepfm", "two_tower_retrieval", "bert4rec")
LOSS_REL, OUT_REL, GRAD_REL = 1e-5, 1e-5, 1e-4
BATCH = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: several pytest workers run side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _host_batch(arch, c):
    """A batch of ``arch`` as NumPy arrays, from a NumPy seed."""
    if arch in ("deepfm", "xdeepfm"):
        return next(ref_synthetic.ctr_batches(c.n_sparse, c.rows_per_field,
                                              BATCH, seed=1))
    if arch == "bert4rec":
        return next(ref_synthetic.seqrec_batches(c.n_items, BATCH, c.seq_len,
                                                 n_masked=4, n_cands=64,
                                                 seed=1))
    rng = np.random.RandomState(1)
    log_q = rng.randn(BATCH).astype(np.float32) * 0.1
    user_mask = (rng.random_sample((BATCH, c.n_user_feats)) < 0.8)
    user_mask[:, 0] = True
    return {"user_ids": rng.randint(0, c.n_users, (BATCH, c.n_user_feats))
            .astype(np.int32),
            "user_mask": user_mask.astype(np.float32),
            "item_ids": rng.randint(0, c.n_items, (BATCH, c.n_item_feats))
            .astype(np.int32),
            "item_mask": np.ones((BATCH, c.n_item_feats), np.float32),
            "log_q": log_q}


def _ref_loss(arch):
    return {"deepfm": ref_rs.ctr_loss, "xdeepfm": ref_rs.ctr_loss,
            "two_tower_retrieval": ref_rs.two_tower_loss,
            "bert4rec": ref_rs.bert4rec_loss}[arch]


def _loss(arch):
    return {"deepfm": recsys.ctr_loss, "xdeepfm": recsys.ctr_loss,
            "two_tower_retrieval": recsys.two_tower_loss,
            "bert4rec": recsys.bert4rec_loss}[arch]


def _outputs(mod, arch, c, p, b):
    """The head's forward outputs the loss is built on."""
    if arch == "deepfm":
        return {"logits": mod.deepfm_logits(p, c, b["ids"])}
    if arch == "xdeepfm":
        return {"logits": mod.xdeepfm_logits(p, c, b["ids"])}
    if arch == "bert4rec":
        return {"hidden": mod.bert4rec_hidden(p, c, b["items"]),
                "logits": mod.bert4rec_logits(p, c, b["items"][:2])}
    u = mod.tower_embed(p, c, "user_table", "user_mlp", b["user_ids"],
                        b["user_mask"])
    i = mod.tower_embed(p, c, "item_table", "item_mlp", b["item_ids"],
                        b["item_mask"])
    return {"user": u, "item": i,
            "scores": mod.retrieval_scores(p, c, u[:1], i)}


def _walk(tree, prefix=""):
    """{"a/b": leaf} of a nested dict."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_walk(v, f"{prefix}/{k}" if prefix else k))
    return out


def _flat(tree):
    return {k: np.asarray(v.detach().numpy() if isinstance(v, torch.Tensor)
                          else v) for k, v in _walk(tree).items()}


@pytest.fixture(scope="module")
def ref():
    """The reference's configs, parameters, batches, outputs, losses and
    gradients of each head (run once for the module)."""
    out = {}
    for arch in HEADS:
        c, fam = ref_registry.get_reduced(arch)
        params = jax.jit(lambda key: ref_rs.init(c, key)[0])(
            jax.random.PRNGKey(0))
        host = _host_batch(arch, c)
        b = jax.tree.map(jnp.asarray, host)
        loss, grads = jax.jit(jax.value_and_grad(_ref_loss(arch)),
                              static_argnums=1)(params, c, b)
        outputs = jax.jit(lambda p, b_: _outputs(ref_rs, arch, c, p, b_))(
            params, b)
        out[arch] = dict(c=c, fam=fam, params=params, host=host,
                         outputs=_flat(outputs), loss=float(loss),
                         grads=_flat(grads))
    return out


def _port(ref, arch):
    r = ref[arch]
    c, _ = registry.get_reduced(arch)
    p = convert.recsys_params(r["params"], "cpu")
    b = {k: torch.from_numpy(np.asarray(v)) for k, v in r["host"].items()}
    return c, p, b


def _rel(got, want):
    top = float(np.abs(want).max())
    return float(np.abs(got - want).max()) / (top if top > 0 else 1.0)


@pytest.mark.parametrize("arch", HEADS)
def test_configs_match_reference(arch):
    for get, ref_get in ((registry.get_arch, ref_registry.get_arch),
                         (registry.get_reduced, ref_registry.get_reduced)):
        (pc, pf), (rc, rf) = get(arch), ref_get(arch.replace("_", "-"))
        assert pf == rf == "recsys"
        assert dataclasses.asdict(pc) == dataclasses.asdict(rc)
        assert pc.total_rows == rc.total_rows


@pytest.mark.parametrize("arch", HEADS)
def test_param_shapes_match_reference(arch):
    """The tree's leaves, shapes and count against the reference's
    abstract init, at CONFIG (nothing drawn) and REDUCED."""
    for get, ref_get in ((registry.get_arch, ref_registry.get_arch),
                         (registry.get_reduced, ref_registry.get_reduced)):
        pc, rc = get(arch)[0], ref_get(arch)[0]
        want, _ = ref_rs.init(rc, abstract=True)
        want = {k: tuple(v.shape) for k, v in _walk(want).items()}
        got = {k: leaf.shape for k, leaf in
               _walk(recsys.param_shapes(pc)).items()}
        assert got == want
        assert pc.param_count() == rc.param_count()


@pytest.mark.parametrize("arch", HEADS)
def test_init_draws_the_reference_scales(arch):
    """The port's own init at REDUCED: every leaf of the reference's shape,
    normal leaves at their scale, biases 0, norms 1; the card by default."""
    c, _ = registry.get_reduced(arch)
    p = _flat(recsys.init(c, seed=3, device="cpu"))
    for key, leaf in _walk(recsys.param_shapes(c)).items():
        assert p[key].shape == leaf.shape and p[key].dtype == np.float32
        if leaf.fill == "normal":
            std = float(p[key].std())
            assert 0.5 * leaf.scale < std < 1.5 * leaf.scale, key
        else:
            assert np.all(p[key] == (leaf.fill == "ones")), key
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            recsys.init(c)


@pytest.mark.parametrize("arch", HEADS)
def test_outputs_match_reference(ref, arch):
    c, p, b = _port(ref, arch)
    with torch.no_grad():
        got = _flat(_outputs(recsys, arch, c, p, b))
    want = ref[arch]["outputs"]
    assert got.keys() == want.keys()
    for key, w in want.items():
        assert got[key].shape == w.shape, key
        assert _rel(got[key], w) <= OUT_REL, key


@pytest.mark.parametrize("arch", HEADS)
def test_loss_and_gradients_match_reference(ref, arch):
    c, p, b = _port(ref, arch)
    loss, grads = train_loop.value_and_grad(
        lambda params, batch: _loss(arch)(params, c, batch), p, b)
    want = ref[arch]["loss"]
    assert abs(float(loss) - want) <= LOSS_REL * abs(want)
    got = _flat(grads)
    assert got.keys() == ref[arch]["grads"].keys()
    for key, w in ref[arch]["grads"].items():
        assert _rel(got[key], w) <= GRAD_REL, key


@pytest.mark.parametrize("arch", HEADS)
def test_adamw_steps_lower_the_loss(ref, arch):
    c, p, b = _port(ref, arch)
    cfg = optimizer.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=60,
                                weight_decay=0.0)
    opt = optimizer.init(p)
    losses = []
    for _ in range(8):
        loss, grads = train_loop.value_and_grad(
            lambda params, batch: _loss(arch)(params, c, batch), p, b)
        p, opt, _ = optimizer.apply(p, grads, opt, cfg)
        losses.append(float(loss))
    assert np.isfinite(losses[-1]) and losses[-1] < losses[0]


def _grid(rng, shape, span=8):
    """Integer multiples of 1/16 within ±span/16: every dot product of a
    few such vectors is exact in fp32, and many tie."""
    return (rng.randint(-span, span + 1, shape) / 16.0).astype(np.float32)


@pytest.mark.parametrize("b,n,k,tile", [(3, 300, 10, 64), (2, 256, 256, 256),
                                        (2, 40, 64, 16), (1, 7, 9, 16384),
                                        (4, 1000, 128, 384)])
def test_streaming_topk_matches_reference(b, n, k, tile):
    """Ids and scores exact: k > n (the (-inf, 0) fill), n off the tile,
    k = n, a single short tile, ties everywhere."""
    rng = np.random.RandomState(n + k)
    q, cand = _grid(rng, (b, 8)), _grid(rng, (n, 8), span=2)
    wv, wi = ref_rs.streaming_topk(jnp.asarray(q), jnp.asarray(cand), k,
                                   tile)
    gv, gi = recsys.streaming_topk(torch.from_numpy(q),
                                   torch.from_numpy(cand), k, tile)
    assert gi.dtype == torch.int64 and gv.shape == (b, k)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


@pytest.mark.parametrize("budget", [1000, 777, 5, 0, 4096, -3])
def test_anytime_retrieval_matches_reference(budget):
    """The full budget, one off the grid, below k, 0, past n and negative:
    (k,) scores and ids exact, the fill ids budget, budget + 1, …."""
    rng = np.random.RandomState(7)
    q, cand, k = _grid(rng, (1, 8)), _grid(rng, (1000, 8), span=3), 16
    wv, wi = ref_rs.anytime_retrieval(jnp.asarray(q), jnp.asarray(cand),
                                      jnp.asarray(budget), k)
    gv, gi = recsys.anytime_retrieval(torch.from_numpy(q),
                                      torch.from_numpy(cand),
                                      torch.tensor(budget), k)
    assert gv.shape == gi.shape == (k,)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_embedding_bag_matches_reference(mode):
    """Values and the table's gradient; an empty bag (mean: 0, max:
    -inf)."""
    rng = np.random.RandomState(0)
    table = rng.randn(50, 8).astype(np.float32)
    ids = rng.randint(0, 50, (6, 5)).astype(np.int32)
    mask = (rng.random_sample((6, 5)) < 0.6).astype(np.float32)
    mask[0] = 0.0
    mask[1] = 1.0
    want = ref_emb.embedding_bag(jnp.asarray(table), jnp.asarray(ids),
                                 jnp.asarray(mask), mode)
    t = torch.from_numpy(table).requires_grad_(True)
    got = embedding.embedding_bag(t, torch.from_numpy(ids),
                                  torch.from_numpy(mask), mode)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-7)
    live = slice(1, None)

    def ref_sum(tab):
        return jnp.sum(ref_emb.embedding_bag(tab, jnp.asarray(ids),
                                             jnp.asarray(mask), mode)[live])
    want_g = jax.grad(ref_sum)(jnp.asarray(table))
    got[live].sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_g),
                               rtol=1e-6, atol=1e-7)


def test_ragged_bag_and_lookup_match_reference():
    rng = np.random.RandomState(1)
    table = rng.randn(40, 6).astype(np.float32)
    flat = rng.randint(0, 40, 30).astype(np.int32)
    bags = np.sort(rng.randint(0, 7, 30)).astype(np.int32)
    w = rng.random_sample(30).astype(np.float32)
    for weights in (None, w):
        want = ref_emb.ragged_embedding_bag(
            jnp.asarray(table), jnp.asarray(flat), jnp.asarray(bags), 8,
            None if weights is None else jnp.asarray(weights))
        got = embedding.ragged_embedding_bag(
            torch.from_numpy(table), torch.from_numpy(flat),
            torch.from_numpy(bags), 8,
            None if weights is None else torch.from_numpy(weights))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
    ids = rng.randint(0, 40, (3, 4)).astype(np.int32)
    np.testing.assert_array_equal(
        embedding.lookup(torch.from_numpy(table), torch.from_numpy(ids))
        .numpy(), np.asarray(ref_emb.lookup(jnp.asarray(table),
                                            jnp.asarray(ids))))


@pytest.mark.parametrize("gen", ["ctr", "seqrec"])
def test_synthetic_generators_bit_for_bit(gen):
    if gen == "ctr":
        want = ref_synthetic.ctr_batches(8, 128, 32, seed=4)
        got = synthetic.ctr_batches(8, 128, 32, seed=4)
    else:
        want = ref_synthetic.seqrec_batches(256, 8, 24, n_masked=4,
                                            n_cands=64, seed=4)
        got = synthetic.seqrec_batches(256, 8, 24, n_masked=4, n_cands=64,
                                       seed=4)
    for _ in range(3):
        w, g = next(want), next(got)
        assert w.keys() == g.keys()
        for key in w:
            assert g[key].dtype == w[key].dtype
            np.testing.assert_array_equal(g[key], w[key])


def test_two_tower_module_matches_functional_tower(ref):
    """``TwoTower`` (the dense modality's tower, over the RecsysConfig)
    equals ``tower_embed`` on the same parameters."""
    c, p, b = _port(ref, "two_tower_retrieval")
    module = convert.two_tower_params(ref["two_tower_retrieval"]["params"],
                                      "cpu")
    for side, n_feats in (("user", c.n_user_feats), ("item", c.n_item_feats)):
        ids, mask = b[f"{side}_ids"], b[f"{side}_mask"]
        with torch.no_grad():
            want = recsys.tower_embed(p, c, f"{side}_table", f"{side}_mlp",
                                      ids, mask)
        assert torch.equal(module.tower_embed(side, ids, mask), want)
    tower = recsys.TwoTower.init(c, seed=2, device="cpu")
    assert tower.tables["item"].shape == (c.n_items, recsys.TABLE_DIM)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_donated_update_is_bit_equal(ref, dtype):
    """``optimizer.apply(..., donate=True)`` (the full-width steps' update:
    parameters, moments and gradients written in place) equals the
    functional update bit for bit over three steps, on the two-tower
    parameters with seeded gradients; and the functional update leaves its
    inputs as they were."""
    dt = getattr(torch, dtype)
    _, p, _ = _port(ref, "two_tower_retrieval")
    gen = torch.Generator().manual_seed(5)

    def like(tree, fn):
        return {k: like(v, fn) if isinstance(v, dict) else fn(v)
                for k, v in tree.items()}
    params = like(p, lambda x: x.to(dt))
    opt = optimizer.init(params)
    cfg = optimizer.AdamWConfig(lr=1e-2, warmup_steps=1)
    for _ in range(3):
        grads = like(params, lambda x: torch.randn(x.shape, generator=gen)
                     .to(dt))
        before = [like(t, torch.clone) for t in (params, grads, opt.m, opt.v)]
        want_p, want_o, _ = optimizer.apply(params, grads, opt, cfg)
        for kept, now in zip(before, (params, grads, opt.m, opt.v)):
            now = _walk(now)
            assert all(torch.equal(now[key], x)
                       for key, x in _walk(kept).items())
        got_p, got_o, _ = optimizer.apply(
            like(params, torch.clone), like(grads, torch.clone),
            optimizer.OptState(like(opt.m, torch.clone),
                               like(opt.v, torch.clone), opt.step.clone()),
            cfg, donate=True)
        for got, want in ((got_p, want_p), (got_o.m, want_o.m),
                          (got_o.v, want_o.v)):
            got = _walk(got)
            for key, w in _walk(want).items():
                assert got[key].dtype == w.dtype
                assert torch.equal(got[key], w), key
        params, opt = want_p, want_o
