"""The port's LM serving path against the reference's.

Yi-6B and Minitron-8B at their REDUCED sizes (2 layers, d_model 128, fp32;
kv heads 1 and 2), with the reference's ``transformer.init(c,
PRNGKey(0))`` parameters carried over by ``convert.lm_params``: ``forward``
logits, ``prefill`` logits and cache, 12 ``decode_step``s from an empty
cache and 4 from a prefill cache, against the reference, all on the CPU
(where attention runs its plain versions); ``chunked_attention`` and
``gqa_decode`` against the reference's; the reference's decode RoPE fault
reproduced; the configurations and parameter counts copied.  Training has
its own file (``test_torch_train.py``).  MoE and MLA have their own files
(``test_torch_moe.py``, ``test_torch_mla.py``), and so do the model code
under a mesh (``test_torch_mesh.py``).

Tolerance: 1e-4 of the compared tensor's largest magnitude.  Both sides
compute in fp32 and add in other orders (matmuls, the softmax sums); the
logits are O(1) and the cached k, v O(10) (the reference draws each stacked
layer leaf with scale 1/√L), and an order change moves an element by up to
~4e-5 of that magnitude.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import minitron_8b as ref_minitron
from repro.configs import yi_6b as ref_yi
from repro.models import attention as ref_attn
from repro.models import common as ref_common
from repro.models import transformer as ref_tr
from repro_torch import convert
from repro_torch.configs import minitron_8b, yi_6b
from repro_torch.models import attention as attn
from repro_torch.models import common
from repro_torch.models import transformer as tr

ARCHS = {"yi_6b": (ref_yi, yi_6b), "minitron_8b": (ref_minitron, minitron_8b)}
REL = 1e-4
# the reference's entry points, compiled once per configuration and shape
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


def _tokens(c, shape, seed):
    return np.random.RandomState(seed).randint(0, c.vocab, shape).astype(
        np.int32)


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor)
                      else x, np.float32)


def _close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(_np(got), want,
                               atol=REL * np.abs(want).max())


def _pad_seq(cache, n, jax_side):
    """A prefill cache padded with ``n`` empty positions (the decode room)."""
    if jax_side:
        return {k: jnp.pad(v, [(0, 0)] * 3 + [(0, n), (0, 0)])
                for k, v in cache.items()}
    return {k: torch.nn.functional.pad(v, (0, 0, 0, n))
            for k, v in cache.items()}


def test_configs_copy_the_reference():
    for name, (ref_mod, port_mod) in ARCHS.items():
        for which in ("CONFIG", "REDUCED"):
            rc, pc = getattr(ref_mod, which), getattr(port_mod, which)
            assert dataclasses.asdict(pc) == dataclasses.asdict(rc), name
            assert pc.padded_vocab == rc.padded_vocab
            assert pc.param_count() == rc.param_count()
            assert pc.torch_dtype == (torch.bfloat16 if rc.dtype == "bfloat16"
                                      else torch.float32)
    assert yi_6b.CONFIG.param_count() == 6_061_031_424


def test_converted_params_keep_the_tree(model):
    rc, pc, rp, pp = model
    for key in ("embed", "unembed", "final_ln"):
        np.testing.assert_array_equal(_np(pp[key]), np.asarray(rp[key]))
    for group, keys in tr.LAYER_KEYS.items():
        for k in keys:
            np.testing.assert_array_equal(_np(pp["layers"][group][k]),
                                          np.asarray(rp["layers"][group][k]))
    for k in ("ln1", "ln2"):
        np.testing.assert_array_equal(_np(pp["layers"][k]),
                                      np.asarray(rp["layers"][k]))


def test_init_draws_the_reference_shapes_and_scales():
    c = dataclasses.replace(yi_6b.REDUCED, n_layers=4)
    rp, _ = ref_tr.init(dataclasses.replace(ref_yi.REDUCED, n_layers=4),
                        jax.random.PRNGKey(0))
    pp = tr.init(c, seed=7, device="cpu")
    again = tr.init(c, seed=7, device="cpu")
    flat_r = jax.tree_util.tree_flatten_with_path(rp)[0]
    for path, leaf in flat_r:
        keys = [p.key for p in path]
        t = pp
        for k in keys:
            t = t[k]
        assert tuple(t.shape) == leaf.shape and t.dtype == torch.float32
        u = again
        for k in keys:
            u = u[k]
        assert torch.equal(t, u), keys
        r = np.asarray(leaf)
        if keys[-1] in ("ln1", "ln2", "final_ln"):
            np.testing.assert_array_equal(t.numpy(), r)
        else:
            # normal draws of the reference's scale (L = 4 for the stacked
            # layer leaves, 0.02 for the embedding)
            assert abs(t.std().item() / r.std() - 1) < 0.05, keys
            assert abs(t.mean().item()) < 0.05 * r.std() + 1e-3, keys


def test_forward_matches_reference(model):
    rc, pc, rp, pp = model
    toks = _tokens(rc, (2, 32), 1)
    want, _ = REF_FORWARD(rp, rc, jnp.asarray(toks))
    got, aux = tr.forward(pp, pc, torch.from_numpy(toks))
    assert got.shape == (2, 32, pc.padded_vocab) and float(aux) == 0.0
    _close(got, want)


def test_prefill_matches_reference(model):
    rc, pc, rp, pp = model
    toks = _tokens(rc, (2, 24), 2)
    want, want_cache = REF_PREFILL(rp, rc, jnp.asarray(toks))
    got, cache = tr.prefill(pp, pc, torch.from_numpy(toks))
    _close(got, want)
    for k in ("k", "v"):
        assert tuple(cache[k].shape) == want_cache[k].shape
        _close(cache[k], want_cache[k])


def test_decode_steps_match_reference(model):
    """12 steps from an empty cache, the reference's own decode test."""
    rc, pc, rp, pp = model
    s = 12
    toks = _tokens(rc, (2, s), 3)
    want_cache, _ = ref_tr.init_cache(rc, 2, s)
    cache = tr.init_cache(pc, 2, s, device="cpu")
    kv = np.zeros(2, np.int32)
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
    want_cache, cache = _pad_seq(want_cache, n, True), _pad_seq(cache, n,
                                                                 False)
    kv = np.full(2, s, np.int32)
    for _ in range(n):
        nxt = np.asarray(jnp.argmax(want, axis=-1)).astype(np.int32)
        np.testing.assert_array_equal(_np(got).argmax(-1), nxt)
        want, want_cache = REF_DECODE(rp, rc, jnp.asarray(nxt),
                                              want_cache, jnp.asarray(kv))
        got, cache = tr.decode_step(pp, pc, torch.from_numpy(nxt), cache,
                                    torch.from_numpy(kv))
        _close(got, want)
        kv = kv + 1
    for k in ("k", "v"):
        _close(cache[k], want_cache[k])


def test_decode_keeps_the_reference_rope_fault():
    """At rope_theta 5e6 the reference's decode rotates with 10,000 while
    forward uses 5e6 (ROADMAP §3, fault 3).  The port's decode equals the
    reference's, and both differ from forward's last row."""
    rc = dataclasses.replace(ref_yi.REDUCED, rope_theta=5e6)
    pc = dataclasses.replace(yi_6b.REDUCED, rope_theta=5e6)
    rp, _ = ref_tr.init(rc, jax.random.PRNGKey(0))
    pp = convert.lm_params(rp, device="cpu")
    s = 12
    toks = _tokens(rc, (2, s), 5)
    want_cache, _ = ref_tr.init_cache(rc, 2, s)
    cache = tr.init_cache(pc, 2, s, device="cpu")
    kv = np.zeros(2, np.int32)
    for t in range(s):
        want, want_cache = REF_DECODE(rp, rc, jnp.asarray(toks[:, t]),
                                              want_cache, jnp.asarray(kv))
        got, cache = tr.decode_step(pp, pc, torch.from_numpy(toks[:, t]),
                                    cache, torch.from_numpy(kv))
        kv = kv + 1
    _close(got, want)
    full, _ = REF_FORWARD(rp, rc, jnp.asarray(toks))
    port_full, _ = tr.forward(pp, pc, torch.from_numpy(toks))
    _close(port_full, full)
    assert np.abs(np.asarray(want) - np.asarray(full[:, -1])).max() > 0.1
    assert np.abs(_np(got) - _np(port_full[:, -1])).max() > 0.1


@pytest.mark.parametrize("b,h,hkv,sq,sk,d,causal", [
    (2, 8, 2, 64, 64, 16, True),
    (1, 4, 1, 1024, 1024, 16, True),      # two 512 chunks
    (1, 4, 4, 300, 300, 32, False),       # one ragged chunk below 512
    (2, 4, 2, 48, 1536, 16, False),       # Sq != Sk, three chunks
])
def test_chunked_attention_matches_reference(b, h, hkv, sq, sk, d, causal):
    rng = np.random.RandomState(sq + sk)
    q = rng.randn(b, h, sq, d).astype(np.float32)
    k = rng.randn(b, hkv, sk, d).astype(np.float32) * 0.5
    v = rng.randn(b, hkv, sk, d).astype(np.float32)
    want = ref_attn.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal=causal)
    got = attn.chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-5)


def test_chunked_attention_raises_where_the_reference_reshape_does():
    q = np.zeros((1, 2, 700, 16), np.float32)
    with pytest.raises(TypeError, match="reshape"):
        ref_attn.chunked_attention(jnp.asarray(q), jnp.asarray(q[:, :1]),
                                   jnp.asarray(q[:, :1]), causal=True)
    t = torch.from_numpy(q)
    with pytest.raises(TypeError, match="reshape"):
        attn.chunked_attention(t, t[:, :1], t[:, :1], causal=True)


@pytest.mark.parametrize("hkv", [1, 2, 8])
def test_gqa_decode_matches_reference(hkv):
    rng = np.random.RandomState(hkv)
    q = rng.randn(3, 8, 16).astype(np.float32)
    k = rng.randn(3, hkv, 40, 16).astype(np.float32)
    v = rng.randn(3, hkv, 40, 16).astype(np.float32)
    kv_len = np.asarray([1, 17, 40], np.int32)
    want = ref_attn.gqa_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(kv_len))
    got = attn.gqa_decode(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), torch.from_numpy(kv_len))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_numerics_match_reference(dtype):
    """rms_norm and rope with the reference's promotion order: in bf16 they
    round where the reference rounds, so they are bit-equal.  swiglu in
    bf16 is held within 2e-2 of its largest output: XLA's bf16 logistic
    differs from torch's sigmoid by one bf16 ulp on some inputs, and the
    products carry that on."""
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    rng = np.random.RandomState(9)

    def pair(a):
        j = jnp.asarray(a, dtype)
        return j, torch.from_numpy(np.array(j, np.float32)).to(tdt)
    xj, xt = pair(rng.randn(2, 3, 5, 32) * 3)
    gj, gt = pair(rng.rand(32) + 0.5)
    pos = rng.randint(0, 4096, (2, 3, 5)).astype(np.int32)
    w = [pair(rng.randn(*s) / 6) for s in ((32, 48), (32, 48), (48, 32))]
    bf16 = dtype == jnp.bfloat16
    for name, got, want in (
            ("rms_norm", common.rms_norm(xt, gt), ref_common.rms_norm(xj, gj)),
            ("rope", common.rope(xt, torch.from_numpy(pos), 5e6),
             ref_common.rope(xj, jnp.asarray(pos), 5e6)),
            ("swiglu", common.swiglu(xt, *(t for _, t in w)),
             ref_common.swiglu(xj, *(j for j, _ in w)))):
        assert got.dtype == tdt and got.shape == want.shape
        want = np.asarray(want, np.float32)
        if bf16 and name != "swiglu":
            np.testing.assert_array_equal(_np(got), want, err_msg=name)
        else:
            scale = (2e-2 if bf16 else 1e-5) * np.abs(want).max()
            np.testing.assert_allclose(_np(got), want, atol=scale,
                                       err_msg=name)
