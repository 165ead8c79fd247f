"""The port's MLA attention and the MiniCPM3 transformer against the
reference's, and the prefill kernels' wrappers at MLA's width pair.

``mla_forward`` and ``mla_decode`` (``repro_torch.models.attention``) at
MiniCPM3's REDUCED widths and at its real head widths (q/k 64 + 32, v 64,
KV rank 256, with few heads and a narrow d_model, so that the (96, 64)
shapes run through the plain versions), with parameters the reference's
``mla_params`` draws; then ``minicpm3_4b`` REDUCED (2 layers, fp32) with
the reference's ``transformer.init(c, PRNGKey(0))`` parameters carried
over by ``convert.lm_params``: ``forward``, ``prefill`` (its ``c`` and
``rope`` caches), decode from an empty cache and decode continuing a
prefill; ``_cache_insert_2d``'s clamp at kv_len >= S; ``attention_ref`` and
``attention_tc_plain`` at (96, 64) in fp32 and bf16 against the reference's
``chunked_attention``; and the card wrapper on meta tensors with a fake
extension, which passes (96, 64) to its launch with an output 64 wide and
refuses width pairs it is not built for.  All on the CPU.

Tolerance: 1e-4 of the compared tensor's largest magnitude (both sides
compute in fp32 and add in other orders); cache positions exact.  In bf16
the attention is held to 2e-2 of max(1, |want|), the reference's bf16 bar
(``tests/test_kernels.py``), as ``test_torch_flash.py`` holds it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import minicpm3_4b as ref_minicpm
from repro.models import attention as ref_attn
from repro.models import common as ref_common
from repro.models import transformer as ref_tr
from repro_torch import convert, kernels
from repro_torch.configs import minicpm3_4b
from repro_torch.kernels.flash_attention import ops
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tr

REL = 1e-4
REF_FORWARD = jax.jit(ref_tr.forward, static_argnums=(1,))
REF_PREFILL = jax.jit(ref_tr.prefill, static_argnums=(1,))
REF_DECODE = jax.jit(ref_tr.decode_step, static_argnums=(1,))
REF_MLA = jax.jit(ref_attn.mla_forward, static_argnums=(3, 4, 5))
REF_MLA_DECODE = jax.jit(ref_attn.mla_decode, static_argnums=(5, 6))
# MiniCPM3's head widths at a width the CPU runs quickly
REAL_HEADS = dict(d_model=256, n_heads=4, mla=minicpm3_4b.CONFIG.mla)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: several pytest workers run side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    """(reference config, port config, reference params, port params)."""
    rc, pc = ref_minicpm.REDUCED, minicpm3_4b.REDUCED
    rp, _ = ref_tr.init(rc, jax.random.PRNGKey(0))
    return rc, pc, rp, convert.lm_params(rp, device="cpu")


@pytest.fixture(scope="module", params=["reduced", "real_heads"])
def mla_layer(request):
    """(d_model, n_heads, MLAConfig, reference params, port params) of one
    MLA block from the reference's ``mla_params``."""
    if request.param == "reduced":
        c = minicpm3_4b.REDUCED
        dm, h, cfg = c.d_model, c.n_heads, c.mla
    else:
        dm, h, cfg = (REAL_HEADS[k] for k in ("d_model", "n_heads", "mla"))
    ref_cfg = ref_attn.MLAConfig(*cfg)
    pf = ref_common.ParamFactory(jax.random.PRNGKey(1))
    rp = ref_attn.mla_params(pf, "attn", dm, h, ref_cfg)
    pp = {k: torch.from_numpy(np.array(v, np.float32)) for k, v in
          rp.items()}
    return dm, h, ref_cfg, cfg, rp, pp


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


@pytest.mark.parametrize("causal", [True, False])
def test_mla_forward_matches_reference(mla_layer, causal):
    dm, h, ref_cfg, cfg, rp, pp = mla_layer
    b, s = 2, 48
    x = np.random.RandomState(2).randn(b, s, dm).astype(np.float32)
    pos = np.broadcast_to(np.arange(s)[None], (b, s)).astype(np.int32)
    want = REF_MLA(rp, jnp.asarray(x), jnp.asarray(pos), h, ref_cfg, causal)
    got = attn.mla_forward(pp, torch.from_numpy(x), torch.from_numpy(pos), h,
                           cfg, causal=causal)
    assert got.shape == (b, s, dm)
    _close(got, want)


def test_mla_decode_matches_reference(mla_layer):
    """The absorbed form over a latent cache of 40 positions, kv_len from 1
    to the full cache, the query's RoPE position given and defaulted."""
    dm, h, ref_cfg, cfg, rp, pp = mla_layer
    b, s = 3, 40
    rng = np.random.RandomState(3)
    x = rng.randn(b, dm).astype(np.float32)
    c_cache = rng.randn(b, s, cfg.kv_lora_rank).astype(np.float32)
    r_cache = rng.randn(b, s, cfg.qk_rope_dim).astype(np.float32)
    kv_len = np.asarray([1, 17, 40], np.int32)
    for q_pos in (None, np.asarray([5, 0, 39], np.int32)):
        want = REF_MLA_DECODE(rp, jnp.asarray(x), jnp.asarray(c_cache),
                              jnp.asarray(r_cache), jnp.asarray(kv_len), h,
                              ref_cfg, None if q_pos is None
                              else jnp.asarray(q_pos))
        got = attn.mla_decode(pp, torch.from_numpy(x),
                              torch.from_numpy(c_cache),
                              torch.from_numpy(r_cache),
                              torch.from_numpy(kv_len), h, cfg,
                              None if q_pos is None
                              else torch.from_numpy(q_pos))
        assert got.shape == (b, dm)
        _close(got, want)


def test_mla_params_draw_the_reference_shapes(mla_layer):
    dm, h, ref_cfg, cfg, rp, _ = mla_layer
    gen = torch.Generator().manual_seed(0)
    pp = attn.mla_params(gen, dm, h, cfg, stack=(3,))
    assert sorted(pp) == sorted(rp)
    for k, leaf in rp.items():
        assert tuple(pp[k].shape) == (3,) + leaf.shape, k
        if k.endswith("norm"):
            assert bool((pp[k] == 1).all()), k
        else:
            assert abs(pp[k].std().item() * 3 ** 0.5 - 1) < 0.05, k


def test_forward_matches_reference(model):
    rc, pc, rp, pp = model
    toks = _tokens(rc, (2, 32), 1)
    want, want_aux = REF_FORWARD(rp, rc, jnp.asarray(toks))
    got, aux = tr.forward(pp, pc, torch.from_numpy(toks))
    assert got.shape == (2, 32, pc.padded_vocab)
    assert float(aux) == float(want_aux) == 0.0
    _close(got, want)


def test_prefill_matches_reference(model):
    rc, pc, rp, pp = model
    toks = _tokens(rc, (2, 24), 2)
    want, want_cache = REF_PREFILL(rp, rc, jnp.asarray(toks))
    got, cache = tr.prefill(pp, pc, torch.from_numpy(toks))
    _close(got, want)
    assert sorted(cache) == sorted(want_cache) == ["c", "rope"]
    for k in ("c", "rope"):
        assert tuple(cache[k].shape) == want_cache[k].shape
        _close(cache[k], want_cache[k])
    empty = tr.init_cache(pc, 2, 24, device="cpu")
    ref_empty, _ = ref_tr.init_cache(rc, 2, 24)
    assert {k: tuple(v.shape) for k, v in empty.items()} == {
        k: v.shape for k, v in ref_empty.items()}


def test_decode_steps_match_reference(model):
    """12 steps from an empty cache of 10 positions: the last two write at
    kv_len >= S, where the reference's ``dynamic_update_slice`` overwrites
    the last row."""
    rc, pc, rp, pp = model
    s = 10
    toks = _tokens(rc, (2, s + 2), 3)
    want_cache, _ = ref_tr.init_cache(rc, 2, s)
    cache = tr.init_cache(pc, 2, s, device="cpu")
    kv = np.zeros(2, np.int32)
    for t in range(s + 2):
        want, want_cache = REF_DECODE(rp, rc, jnp.asarray(toks[:, t]),
                                      want_cache, jnp.asarray(kv))
        got, cache = tr.decode_step(pp, pc, torch.from_numpy(toks[:, t]),
                                    cache, torch.from_numpy(kv))
        _close(got, want)
        kv = kv + 1
    for k in ("c", "rope"):
        _close(cache[k], want_cache[k])


def test_decode_continues_a_prefill_like_the_reference(model):
    """The serving order: a prefill, its latent cache padded, greedy
    steps."""
    rc, pc, rp, pp = model
    s, n = 16, 4
    toks = _tokens(rc, (2, s), 4)
    want, want_cache = REF_PREFILL(rp, rc, jnp.asarray(toks))
    got, cache = tr.prefill(pp, pc, torch.from_numpy(toks))
    want_cache = {k: jnp.pad(v, [(0, 0), (0, 0), (0, n), (0, 0)])
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
    for k in ("c", "rope"):
        _close(cache[k], want_cache[k])


def test_cache_insert_2d_clamps_as_the_reference():
    """kv_len 0, inside, S - 1, S and past S: the row written is the
    reference's, in place (the same tensor returned)."""
    rng = np.random.RandomState(5)
    b, s, r = 5, 6, 8
    cache = rng.randn(b, s, r).astype(np.float32)
    new = rng.randn(b, r).astype(np.float32)
    kv_len = np.asarray([0, 3, s - 1, s, s + 4], np.int32)
    want = np.asarray(ref_tr._cache_insert_2d(jnp.asarray(cache),
                                              jnp.asarray(new),
                                              jnp.asarray(kv_len)))
    t = torch.from_numpy(cache.copy())
    got = tr._cache_insert_2d(t, torch.from_numpy(new),
                              torch.from_numpy(kv_len))
    assert got is t
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want[3, s - 1], new[3])
    np.testing.assert_array_equal(want[4, s - 1], new[4])


def _mla_qkv(b, h, hkv, s, dtype, seed):
    rng = np.random.RandomState(seed)
    qj = jnp.asarray(rng.randn(b, h, s, 96) * 0.4, dtype)
    kj = jnp.asarray(rng.randn(b, hkv, s, 96) * 0.4, dtype)
    vj = jnp.asarray(rng.randn(b, hkv, s, 64), dtype)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    return (qj, kj, vj), tuple(torch.from_numpy(np.array(a, np.float32)).to(
        tdt) for a in (qj, kj, vj))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("s,hkv,causal", [
    (127, 4, True), (129, 1, False), (512, 4, True), (1024, 1, True)])
def test_plain_versions_at_mla_widths_match_reference(dtype, s, hkv, causal):
    """q/k 96 and v 64: ``attention_ref`` (the CPU path of
    ``flash_attention``) and ``attention_tc_plain`` (the bf16 kernel's
    arithmetic) against the reference's ``chunked_attention`` at MLA's
    scale, Hkv = H and a GQA group of 4."""
    (qj, kj, vj), (qt, kt, vt) = _mla_qkv(1, 4, hkv, s, dtype, s + hkv)
    scale = 96 ** -0.5
    want = np.asarray(ref_attn.chunked_attention(qj, kj, vj, causal=causal,
                                                 scale=scale), np.float32)
    outs = [ops.flash_attention(qt, kt, vt, causal=causal, scale=scale),
            attn.chunked_attention(qt, kt, vt, causal=causal, scale=scale)]
    if dtype == jnp.bfloat16:
        outs.append(ops.attention_tc_plain(qt, kt, vt, causal=causal,
                                           scale=scale))
    for got in outs:
        assert got.shape == (1, 4, s, 64) and got.dtype == qt.dtype
        if dtype == jnp.bfloat16:
            err = np.abs(_np(got) - want) / np.maximum(1.0, np.abs(want))
            assert err.max() <= 2e-2, err.max()
        else:
            np.testing.assert_allclose(_np(got), want, atol=2e-5)


class _FakeExtension:
    """Stands in for the compiled module: records each launch's name and
    the widths of q, v and the output it was given."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def launch(q, k, v, out, *args):
            self.calls.append((name, q.shape[-1], v.shape[-1],
                               tuple(out.shape)))
        return launch


@pytest.mark.parametrize("dtype,launch", [
    (torch.float32, "flash_attention"),
    (torch.bfloat16, "flash_attention_sm90")])
def test_card_wrapper_launches_mla_widths(monkeypatch, dtype, launch):
    """On device tensors the wrapper passes q/k 96 and v 64 to the kernel
    of its dtype with an output (B, H, S, 64), counted once; it refuses the
    pairs not built ((96, 96), (64, 96), (96, 32)) and a k narrower than q,
    before any launch."""
    fake = _FakeExtension()
    monkeypatch.setattr(kernels, "extension", lambda: fake)
    kernels.reset_launches()

    def empty(*shape):
        return torch.empty(shape, dtype=dtype, device="meta")
    monkeypatch.setattr(ops, "_check_tma", lambda *a: None)
    real_check = ops._check_kernel_inputs

    def meta_check(name, q, k, v, pairs=None):
        # the meta tensors are no CUDA tensors: check all but the device
        try:
            real_check(name, q, k, v, pairs)
        except ValueError as e:
            if "CUDA tensor" not in str(e):
                raise
    monkeypatch.setattr(ops, "_check_kernel_inputs", meta_check)
    out = ops.flash_attention(empty(2, 8, 64, 96), empty(2, 2, 64, 96),
                              empty(2, 2, 64, 64), causal=True)
    assert tuple(out.shape) == (2, 8, 64, 64) and out.dtype == dtype
    assert fake.calls == [(launch, 96, 64, (2, 8, 64, 64))]
    assert kernels.LAUNCHES["flash_attention"] == 1
    for dqk, dv in ((96, 96), (64, 96), (96, 32)):
        with pytest.raises(ValueError, match="not a pair the kernel is "
                                             "built for"):
            ops.flash_attention(empty(1, 4, 64, dqk), empty(1, 4, 64, dqk),
                                empty(1, 4, 64, dv))
    with pytest.raises(ValueError, match="k's width must equal q's"):
        ops.flash_attention(empty(1, 4, 64, 96), empty(1, 4, 64, 64),
                            empty(1, 4, 64, 64))
    assert len(fake.calls) == 1
    kernels.reset_launches()


def test_configs_copy_the_reference():
    assert minicpm3_4b.FAMILY == ref_minicpm.FAMILY == "lm"
    for which in ("CONFIG", "REDUCED"):
        rc, pc = getattr(ref_minicpm, which), getattr(minicpm3_4b, which)
        assert dataclasses.asdict(pc) == dataclasses.asdict(rc)
        assert pc.mla._fields == rc.mla._fields
        assert pc.param_count() == rc.param_count()
        assert pc.active_param_count() == rc.active_param_count()
    m = minicpm3_4b.CONFIG.mla
    assert (m.qk_nope_dim + m.qk_rope_dim, m.v_head_dim) in \
        ops.PREFILL_WIDTHS
    assert minicpm3_4b.CONFIG.param_count() == 4_261_836_800


def test_init_draws_the_mla_tree():
    c = dataclasses.replace(minicpm3_4b.REDUCED, n_layers=3)
    rp, _ = ref_tr.init(dataclasses.replace(ref_minicpm.REDUCED, n_layers=3),
                        jax.random.PRNGKey(0))
    pp = tr.init(c, seed=7, device="cpu")
    assert sorted(pp["layers"]["attn"]) == sorted(rp["layers"]["attn"])
    for k, leaf in rp["layers"]["attn"].items():
        t = pp["layers"]["attn"][k]
        assert tuple(t.shape) == leaf.shape, k
        r = np.asarray(leaf)
        if k.endswith("norm"):
            np.testing.assert_array_equal(t.numpy(), r)
        else:
            assert abs(t.std().item() / r.std() - 1) < 0.1, k
