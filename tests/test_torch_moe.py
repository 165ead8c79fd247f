"""The port's MoE FFN and the MoE transformers against the reference's.

granite-MoE and Moonlight (``moonshot_v1_16b_a3b``, with shared experts) at
their REDUCED sizes (2 layers, fp32), with the reference's
``transformer.init(c, PRNGKey(0))`` parameters carried over by
``convert.lm_params``: ``moe_forward``'s output and router loss, its routes
(the top-k experts of each token) and capacity drops, at the configured
capacity factor and at 1.0 (where the reference drops tokens), with an
exact gate tie between two experts (the lower id wins, as ``lax.top_k``
keeps it) and in bf16; then ``forward`` (logits and the summed router
loss), ``prefill``, decode from an empty cache and decode continuing a
prefill; the configurations and parameter counts copied.  All on the CPU.

The reference's routes are read from its own lines (``moe.py:75-98``) run
in JAX on the same inputs: ``lax.top_k`` of the fp32 softmax, the stable
``argsort`` of the experts, each pair's place in its bucket.

Tolerance: 1e-4 of the compared tensor's largest magnitude (both sides
compute in fp32 and add in other orders), 1e-6 of its magnitude for the
router loss; routes and drops exact.  In bf16 the output is held within
2e-2 of its largest magnitude, as ``test_torch_lm.py`` holds ``swiglu``:
XLA and torch round the bf16 products and the SiLU differently by an ulp,
and a token's k expert outputs (O(100) at REDUCED) nearly cancel in places,
so an element's own magnitude is no scale for the error.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import granite_moe_3b_a800m as ref_granite
from repro.configs import moonshot_v1_16b_a3b as ref_moonshot
from repro.models import moe as ref_moe
from repro.models import transformer as ref_tr
from repro_torch import convert
from repro_torch.configs import granite_moe_3b_a800m, moonshot_v1_16b_a3b
from repro_torch.models import moe
from repro_torch.models import transformer as tr

ARCHS = {"granite": (ref_granite, granite_moe_3b_a800m),
         "moonshot": (ref_moonshot, moonshot_v1_16b_a3b)}
REL = 1e-4
# op by op: jit fuses the router's softmax into the loss's mean, whose exp
# then rounds otherwise (2.2e-6 of the loss in bf16; the eager reference and
# the port agree to the last bit there)
REF_MOE = ref_moe.moe_forward
REF_FORWARD = jax.jit(ref_tr.forward, static_argnums=(1,))
REF_PREFILL = jax.jit(ref_tr.prefill, static_argnums=(1,))
REF_DECODE = jax.jit(ref_tr.decode_step, static_argnums=(1,))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: several pytest workers run side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=sorted(ARCHS))
def model(request):
    """(reference config, port config, reference params, port params)."""
    ref_mod, port_mod = ARCHS[request.param]
    rc, pc = ref_mod.REDUCED, port_mod.REDUCED
    rp, _ = ref_tr.init(rc, jax.random.PRNGKey(0))
    return rc, pc, rp, convert.lm_params(rp, device="cpu")


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor)
                      else x, np.float32)


def _close(got, want, rel=REL):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(_np(got), want,
                               atol=rel * np.abs(want).max())


def _tokens(c, shape, seed):
    return np.random.RandomState(seed).randint(0, c.vocab, shape).astype(
        np.int32)


def _ffn0(rp, dtype=jnp.float32):
    """Layer 0's FFN leaves: the reference's (as ``dtype``) and the port's
    with the same values."""
    ref = {k: jnp.asarray(v[0], dtype) for k, v in rp["layers"]["ffn"].items()}
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    port = {k: torch.from_numpy(np.array(v, np.float32)).to(tdt)
            for k, v in ref.items()}
    return ref, port


def _ref_routes(router, x, cfg):
    """The reference's routes, from its own lines (``moe.py:75-98``): each
    token's top-k experts, their gates' gap to the next expert's, and
    which of its pairs fit the capacity."""
    t = x.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    gates = jax.nn.softmax((x @ router).astype(jnp.float32), axis=-1)
    topv, tope = jax.lax.top_k(gates, k + 1)
    cap = max(int(t * k / e * cfg.capacity_factor), 4)
    e_f = tope[:, :k].reshape(-1)
    order = jnp.argsort(e_f)
    l_s = e_f[order]
    counts = jnp.zeros((e,), jnp.int32).at[l_s].add(1)
    starts = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                              jnp.cumsum(counts)[:-1].astype(jnp.int32)])
    pos = jnp.arange(t * k, dtype=jnp.int32) - starts[l_s]
    fits = np.empty(t * k, bool)
    fits[np.asarray(order)] = np.asarray(pos < cap)
    return (np.asarray(tope[:, :k]), np.asarray(topv[:, k - 1] - topv[:, k]),
            fits.reshape(t, k))


def _port_routes(router, x, cfg):
    _, _, tope = moe.route(router, x, cfg)
    return tope.numpy(), moe.kept(tope, cfg.n_experts,
                                  moe.capacity(x.shape[0], cfg)).numpy()


def _x(rc, t, seed, dtype=jnp.float32):
    x = np.random.RandomState(seed).randn(t, rc.d_model)
    xj = jnp.asarray(x, dtype)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    return xj, torch.from_numpy(np.array(xj, np.float32)).to(tdt)


def _check_moe(rc, pc, ref_p, port_p, xj, xt, rel=REL):
    """moe_forward's (y, aux), routes and drops against the reference's;
    returns the reference's drops."""
    want, want_aux = REF_MOE(ref_p, xj, rc.moe)
    got, aux = moe.moe_forward(port_p, xt, pc.moe)
    assert got.shape == tuple(want.shape) and got.dtype == xt.dtype
    assert aux.dtype == torch.float32 and aux.shape == ()
    _close(got, want, 2e-2 if xt.dtype == torch.bfloat16 else rel)
    np.testing.assert_allclose(float(aux), float(want_aux),
                               atol=1e-6 * abs(float(want_aux)))
    tope, _, fits = _ref_routes(ref_p["router"], xj, rc.moe)
    p_tope, p_fits = _port_routes(port_p["router"], xt, pc.moe)
    np.testing.assert_array_equal(p_tope, tope)
    np.testing.assert_array_equal(p_fits, fits)
    return fits


def test_moe_forward_matches_reference(model):
    rc, pc, rp, _ = model
    ref_p, port_p = _ffn0(rp)
    xj, xt = _x(rc, 96, 1)
    fits = _check_moe(rc, pc, ref_p, port_p, xj, xt)
    assert fits.all()       # REDUCED's capacity factor 8: drop-free
    assert ("shared_gate" in port_p) == (pc.moe.n_shared > 0)


def test_moe_drops_tokens_as_the_reference_at_capacity_factor_one(model):
    """At capacity factor 1.0 the buckets overflow: the same pairs are
    dropped, and the dropped tokens' outputs lack the same experts."""
    rc, pc, rp, _ = model
    rc = dataclasses.replace(rc, moe=rc.moe._replace(capacity_factor=1.0))
    pc = dataclasses.replace(pc, moe=pc.moe._replace(capacity_factor=1.0))
    ref_p, port_p = _ffn0(rp)
    xj, xt = _x(rc, 200, 2)
    fits = _check_moe(rc, pc, ref_p, port_p, xj, xt)
    assert not fits.all()
    assert moe.capacity(200, pc.moe) == max(
        int(200 * rc.moe.top_k / rc.moe.n_experts * 1.0), 4)


def test_moe_tie_keeps_the_lower_expert(model):
    """Two identical router columns give two experts the same gate for
    every token; where they straddle the k-th place the lower id is
    routed, as ``lax.top_k`` keeps the earlier index."""
    rc, pc, rp, _ = model
    ref_p, port_p = _ffn0(rp)
    lo, hi = 2, 5
    router = np.array(ref_p["router"])
    router[:, hi] = router[:, lo]
    ref_p = dict(ref_p, router=jnp.asarray(router))
    port_p = dict(port_p, router=torch.from_numpy(router))
    xj, xt = _x(rc, 256, 3)
    _check_moe(rc, pc, ref_p, port_p, xj, xt)
    tope, gap, _ = _ref_routes(ref_p["router"], xj, rc.moe)
    boundary = gap == 0.0
    assert boundary.any()
    # at a tie on the k-th place the lower of the two is the one routed
    assert ((tope[boundary] == lo).any(axis=1)
            & ~(tope[boundary] == hi).any(axis=1)).all()


def test_moe_bf16_routes_exactly(model):
    """bf16 tokens and weights, as served: the router's product rounds to
    bf16 before the fp32 softmax (ties follow), the routes and drops equal
    the reference's, the output within the bf16 bar."""
    rc, pc, rp, _ = model
    ref_p, port_p = _ffn0(rp, jnp.bfloat16)
    xj, xt = _x(rc, 128, 4, jnp.bfloat16)
    _check_moe(rc, pc, ref_p, port_p, xj, xt)


def test_forward_matches_reference(model):
    rc, pc, rp, pp = model
    toks = _tokens(rc, (2, 32), 1)
    want, want_aux = REF_FORWARD(rp, rc, jnp.asarray(toks))
    got, aux = tr.forward(pp, pc, torch.from_numpy(toks))
    assert got.shape == (2, 32, pc.padded_vocab)
    _close(got, want)
    assert float(want_aux) > 0
    np.testing.assert_allclose(float(aux), float(want_aux),
                               atol=1e-6 * float(want_aux))


def test_prefill_matches_reference(model):
    rc, pc, rp, pp = model
    toks = _tokens(rc, (2, 24), 2)
    want, want_cache = REF_PREFILL(rp, rc, jnp.asarray(toks))
    got, cache = tr.prefill(pp, pc, torch.from_numpy(toks))
    _close(got, want)
    assert sorted(cache) == sorted(want_cache) == ["k", "v"]
    for k in ("k", "v"):
        assert tuple(cache[k].shape) == want_cache[k].shape
        _close(cache[k], want_cache[k])


def test_decode_steps_match_reference(model):
    """10 steps from an empty cache: each step's MoE routes its B tokens at
    the capacity floor of 4."""
    rc, pc, rp, pp = model
    s = 10
    toks = _tokens(rc, (3, s), 3)
    want_cache, _ = ref_tr.init_cache(rc, 3, s)
    cache = tr.init_cache(pc, 3, s, device="cpu")
    kv = np.zeros(3, np.int32)
    for t in range(s):
        want, want_cache = REF_DECODE(rp, rc, jnp.asarray(toks[:, t]),
                                      want_cache, jnp.asarray(kv))
        got, cache = tr.decode_step(pp, pc, torch.from_numpy(toks[:, t]),
                                    cache, torch.from_numpy(kv))
        _close(got, want)
        kv = kv + 1
    for k in ("k", "v"):
        _close(cache[k], want_cache[k])


def test_decode_continues_a_prefill_like_the_reference(model):
    """The serving order: a prefill, its cache padded, greedy steps."""
    rc, pc, rp, pp = model
    s, n = 16, 4
    toks = _tokens(rc, (2, s), 4)
    want, want_cache = REF_PREFILL(rp, rc, jnp.asarray(toks))
    got, cache = tr.prefill(pp, pc, torch.from_numpy(toks))
    want_cache = {k: jnp.pad(v, [(0, 0)] * 3 + [(0, n), (0, 0)])
                  for k, v in want_cache.items()}
    cache = {k: torch.nn.functional.pad(v, (0, 0, 0, n))
             for k, v in cache.items()}
    kv = np.full(2, s, np.int32)
    for _ in range(n):
        nxt = np.asarray(jnp.argmax(want, axis=-1)).astype(np.int32)
        np.testing.assert_array_equal(_np(got).argmax(-1), nxt)
        want, want_cache = REF_DECODE(rp, rc, jnp.asarray(nxt), want_cache,
                                      jnp.asarray(kv))
        got, cache = tr.decode_step(pp, pc, torch.from_numpy(nxt), cache,
                                    torch.from_numpy(kv))
        _close(got, want)
        kv = kv + 1
    for k in ("k", "v"):
        _close(cache[k], want_cache[k])


def test_converted_params_keep_the_moe_tree(model):
    rc, pc, rp, pp = model
    ffn = tr.FFN_KEYS["moe"] + (tr.FFN_KEYS["shared"] if pc.moe.n_shared
                                else ())
    assert sorted(pp["layers"]["ffn"]) == sorted(rp["layers"]["ffn"]) \
        == sorted(ffn)
    for group in ("attn", "ffn"):
        for k, leaf in rp["layers"][group].items():
            np.testing.assert_array_equal(_np(pp["layers"][group][k]),
                                          np.asarray(leaf))


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_configs_copy_the_reference(name):
    ref_mod, port_mod = ARCHS[name]
    assert port_mod.FAMILY == ref_mod.FAMILY == "lm"
    for which in ("CONFIG", "REDUCED"):
        rc, pc = getattr(ref_mod, which), getattr(port_mod, which)
        assert dataclasses.asdict(pc) == dataclasses.asdict(rc)
        assert pc.moe._fields == rc.moe._fields
        assert pc.param_count() == rc.param_count()
        assert pc.active_param_count() == rc.active_param_count()
        assert pc.active_param_count() < pc.param_count()
    assert granite_moe_3b_a800m.CONFIG.param_count() == 3_374_294_016
    assert moonshot_v1_16b_a3b.CONFIG.active_param_count() == 4_804_771_840


def test_init_draws_the_moe_shapes_and_scales():
    """The port's own draw of an MoE model: the reference's shapes, the
    router at 0.02, the experts at 1/√L, equal for equal seeds."""
    c = dataclasses.replace(moonshot_v1_16b_a3b.REDUCED, n_layers=4)
    rp, _ = ref_tr.init(dataclasses.replace(ref_moonshot.REDUCED, n_layers=4),
                        jax.random.PRNGKey(0))
    pp = tr.init(c, seed=7, device="cpu")
    again = tr.init(c, seed=7, device="cpu")
    for k, leaf in rp["layers"]["ffn"].items():
        t = pp["layers"]["ffn"][k]
        assert tuple(t.shape) == leaf.shape and t.dtype == torch.float32, k
        assert torch.equal(t, again["layers"]["ffn"][k]), k
        r = np.asarray(leaf)
        assert abs(t.std().item() / r.std() - 1) < 0.05, k
    assert abs(pp["layers"]["ffn"]["router"].std().item() - 0.02) < 1e-3
