"""The port's attention kernel wrappers against the reference's.

``flash_attention`` / ``flash_decode`` of ``repro_torch.kernels.
flash_attention.ops`` (on CPU tensors they run their plain versions
``attention_ref`` / ``decode_ref``) against the reference's Pallas kernels
run with ``interpret=True`` at the shapes of ``tests/test_kernels.py``, the
public ``attention`` / ``decode_attention`` against the reference's ops,
and, at a ragged sequence or cache length, against the reference's oracles
— where the reference's kernels drop the tail (ROADMAP §3).  The decode
kernel's split partials and their log-sum-exp merge (the merge kernel on
the card) are held to ``decode_ref`` through their plain version, at the
design's edges too, and ``merge_splits`` to the reference's merge; the
bf16 tensor-core prefill kernel's arithmetic (``attention_tc_plain``: its
128 x 128 tiles, P as bf16 hi + lo) to the reference's kernel and oracle.

Tolerances: fp32 2e-5 and bf16 2e-2, the reference's own bars
(``tests/test_kernels.py``); the two sides sum in other orders.  Where a
bf16 output can exceed magnitude 1, its 2e-2 is relative above 1 (a
one-ulp rounding flip is 2^-8 to 2^-7 of the value), as ``chip_smoke.py``
holds the kernel.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels.flash_attention import ops as ref_ops
from repro.kernels.flash_attention.kernel import (
    flash_attention as ref_flash_attention)
from repro.kernels.flash_attention.kernel import (
    flash_decode as ref_flash_decode)
from repro.kernels.flash_attention.ref import attention_ref as ref_attention
from repro.kernels.flash_attention.ref import decode_ref as ref_decode
from repro_torch import kernels
from repro_torch.kernels.flash_attention import ops
from repro_torch.models import attention as attn


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: several pytest workers run side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(a, dtype):
    """``a`` as a JAX array of ``dtype`` and the same values as a torch
    tensor of the matching dtype (bf16 values pass through fp32 exactly)."""
    j = jnp.asarray(a, dtype)
    t = torch.from_numpy(np.array(j, np.float32))
    return j, t.to(torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _qkv(b, h, hkv, s, d, dtype, seed, sk=None):
    rng = np.random.RandomState(seed)
    sk = sk or s
    q = _pair(rng.randn(b, h, s, d) * 0.4, dtype)
    k = _pair(rng.randn(b, hkv, sk, d) * 0.4, dtype)
    v = _pair(rng.randn(b, hkv, sk, d), dtype)
    return q, k, v


@pytest.mark.parametrize("b,h,hkv,s,d,dtype", [
    (1, 4, 4, 128, 32, jnp.float32),     # MHA
    (2, 8, 2, 256, 64, jnp.float32),     # GQA 4:1
    (1, 8, 1, 128, 64, jnp.bfloat16),    # MQA bf16
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_reference_kernel(b, h, hkv, s, d, dtype,
                                                  causal):
    (qj, qt), (kj, kt), (vj, vt) = _qkv(b, h, hkv, s, d, dtype, h * s)
    want = ref_flash_attention(qj, kj, vj, causal=causal, tq=64, tk=64,
                               interpret=True)
    got = ops.flash_attention(qt, kt, vt, causal=causal)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    tol = 2e-2 if dtype == jnp.bfloat16 else 2e-5
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol)


def _bf16_close(got, want, tol=2e-2):
    """|got - want| <= tol · max(1, |want|) everywhere."""
    got, want = _f32(got), _f32(want)
    assert np.isfinite(got).all()
    err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert err.max() <= tol, err.max()


def _tc_against_reference(b, h, hkv, s, d, causal, seed, qk_scale=0.4):
    """``attention_tc_plain`` on bf16 inputs against the reference's oracle
    and, where it covers every row (S a multiple of its 128-row tile, or
    one tile), its interpret-mode kernel."""
    rng = np.random.RandomState(seed)
    qj, qt = _pair(rng.randn(b, h, s, d) * qk_scale, jnp.bfloat16)
    kj, kt = _pair(rng.randn(b, hkv, s, d) * qk_scale, jnp.bfloat16)
    vj, vt = _pair(rng.randn(b, hkv, s, d), jnp.bfloat16)
    got = ops.attention_tc_plain(qt, kt, vt, causal=causal)
    assert got.dtype == torch.bfloat16 and got.shape == qt.shape
    _bf16_close(got, ref_attention(qj, kj, vj, causal=causal))
    if s <= 128 or s % 128 == 0:
        _bf16_close(got, ref_flash_attention(qj, kj, vj, causal=causal,
                                             interpret=True))
    return got, (qt, kt, vt)


@pytest.mark.parametrize("s", [1, 127, 128, 129, 300])
@pytest.mark.parametrize("causal", [True, False])
def test_tc_plain_matches_reference_on_tile_edges(s, causal):
    """Sequences on and off the bf16 kernel's 128-row and 128-key tiles;
    ragged ones against the oracle only (the reference's kernel drops
    the tail)."""
    _tc_against_reference(1, 8, 2, s, 64, causal, seed=s)


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("group", [1, 4, 8])
def test_tc_plain_matches_reference_across_gqa_and_head_widths(group, d):
    _tc_against_reference(1, 8, 8 // group, 256, d, True, seed=group * d)


@pytest.mark.parametrize("causal", [True, False])
def test_tc_plain_near_one_hot_softmax(causal):
    """Logits with a std of ~40, as the reference's 1/√L weight scale makes
    them in the model (module docstring of ``chip_smoke.py``): the softmax
    is nearly one-hot and the output sits at the chosen v rows; the plain
    version agrees with ``attention_ref`` of the port too."""
    got, (qt, kt, vt) = _tc_against_reference(2, 8, 1, 256, 128, causal,
                                              seed=17, qk_scale=6.3)
    _bf16_close(got, ops.attention_ref(qt, kt, vt, causal=causal))


@pytest.mark.parametrize("p_halves,within", [(1, False), (2, True)])
def test_tc_plain_p_split_keeps_large_values_within_the_bar(p_halves,
                                                            within):
    """v values of magnitude ~20 beside outputs below 1, as the model's
    weight scale makes them (the recorded Yi-6B call's outputs reach 58):
    P rounded once to bf16 (2^-9 relative) moves such outputs by more
    than 2e-2; its hi + lo split, which the kernel uses, does not."""
    rng = np.random.RandomState(3)
    qj, qt = _pair(rng.randn(1, 4, 256, 64), jnp.bfloat16)
    kj, kt = _pair(rng.randn(1, 1, 256, 64), jnp.bfloat16)
    vj, vt = _pair(rng.randn(1, 1, 256, 64) * 20, jnp.bfloat16)
    got = _f32(ops.attention_tc_plain(qt, kt, vt, p_halves=p_halves))
    want = np.asarray(ref_attention(qj, kj, vj, causal=True), np.float32)
    err = (np.abs(got - want) / np.maximum(1.0, np.abs(want))).max()
    assert (err <= 2e-2) == within, err


@pytest.mark.parametrize("b,h,hkv,s,d,tk", [
    (2, 8, 2, 256, 64, 64),
    (1, 4, 4, 512, 32, 128),
])
def test_flash_decode_matches_reference_kernel(b, h, hkv, s, d, tk):
    rng = np.random.RandomState(s)
    qj, qt = _pair(rng.randn(b, h, d) * 0.4, jnp.float32)
    kj, kt = _pair(rng.randn(b, hkv, s, d) * 0.4, jnp.float32)
    vj, vt = _pair(rng.randn(b, hkv, s, d), jnp.float32)
    kv_len = rng.randint(1, s, b).astype(np.int32)
    want = ref_flash_decode(qj, kj, vj, jnp.asarray(kv_len), tk=tk,
                            interpret=True)
    got = ops.flash_decode(qt, kt, vt, torch.from_numpy(kv_len))
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-5)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_public_ops_match_reference_ops(dtype):
    (qj, qt), (kj, kt), (vj, vt) = _qkv(2, 8, 2, 96, 32, dtype, 5)
    tol = 2e-2 if dtype == jnp.bfloat16 else 2e-5
    for causal in (True, False):
        np.testing.assert_allclose(
            _f32(ops.attention(qt, kt, vt, causal=causal)),
            _f32(ref_ops.attention(qj, kj, vj, causal=causal)), atol=tol)
    kv_len = np.asarray([1, 96], np.int32)
    np.testing.assert_allclose(
        _f32(ops.decode_attention(qt[:, :, 0], kt, vt,
                                  torch.from_numpy(kv_len))),
        _f32(ref_ops.decode_attention(qj[:, :, 0], kj, vj,
                                      jnp.asarray(kv_len))), atol=tol)


@pytest.mark.parametrize("s", [200, 700])
@pytest.mark.parametrize("causal", [True, False])
def test_ragged_sequence_matches_oracle(s, causal):
    """Sequences that are not a multiple of the tile: the port's function
    equals the reference's oracle; the reference's kernel returns NaN rows
    past the last full tile, and (causal) the rows before it right, since
    they see no dropped key (ROADMAP §3, fault 1)."""
    (qj, qt), (kj, kt), (vj, vt) = _qkv(1, 2, 1, s, 32, jnp.float32, s)
    want = np.asarray(ref_attention(qj, kj, vj, causal=causal))
    got = _f32(ops.flash_attention(qt, kt, vt, causal=causal))
    np.testing.assert_allclose(got, want, atol=2e-5)
    assert np.isfinite(got).all()
    kern = np.asarray(ref_flash_attention(qj, kj, vj, causal=causal,
                                          interpret=True))
    full = s // 128 * 128
    if causal:
        np.testing.assert_allclose(kern[:, :, :full], want[:, :, :full],
                                   atol=2e-5)
    assert np.isnan(kern[:, :, full:]).all()


def test_ragged_cache_matches_oracle():
    """A cache of 700 positions: the port equals ``decode_ref``; the
    reference's kernel ignores the positions past its last full 512-split
    (ROADMAP §3, fault 2): row 0 (kv_len 650) is off, row 1 (100) right."""
    rng = np.random.RandomState(700)
    qj, qt = _pair(rng.randn(2, 4, 32) * 0.4, jnp.float32)
    kj, kt = _pair(rng.randn(2, 2, 700, 32) * 0.4, jnp.float32)
    vj, vt = _pair(rng.randn(2, 2, 700, 32), jnp.float32)
    kv_len = np.asarray([650, 100], np.int32)
    want = np.asarray(ref_decode(qj, kj, vj, jnp.asarray(kv_len)))
    got = _f32(ops.flash_decode(qt, kt, vt, torch.from_numpy(kv_len)))
    np.testing.assert_allclose(got, want, atol=2e-5)
    kern = np.asarray(ref_flash_decode(qj, kj, vj, jnp.asarray(kv_len),
                                       interpret=True))
    assert np.abs(kern[0] - want[0]).max() > 1e-2
    np.testing.assert_allclose(kern[1], want[1], atol=2e-5)


@pytest.mark.parametrize("t,lens", [
    (700, (1, 650)), (1024, (512, 513)), (1500, (1500, 1024)),
    (512, (0, 511)), (4608, (4097, 4608)),
])
def test_split_partials_merge_to_the_oracle(t, lens):
    """The card's decode path — per-split partials (skipped splits past
    kv_len carry (0, -1e30, 0)) merged by log-sum-exp in the wrapper —
    equals ``decode_ref``, through the kernel's plain version; kv_len 0
    gives the reference's uniform average."""
    rng = np.random.RandomState(t)
    qj, qt = _pair(rng.randn(2, 8, 32) * 0.4, jnp.float32)
    kj, kt = _pair(rng.randn(2, 2, t, 32) * 0.4, jnp.float32)
    vj, vt = _pair(rng.randn(2, 2, t, 32), jnp.float32)
    kv_len = np.asarray(lens, np.int32)
    acc, m, l = ops.decode_partials_plain(qt, kt, vt,
                                          torch.from_numpy(kv_len))
    n_sp = -(-t // ops.SPLIT)
    assert acc.shape == (2, 8, n_sp, 32) and m.shape == l.shape == (2, 8,
                                                                    n_sp)
    got = _f32(ops.merge_splits(acc, m, l, torch.float32))
    want = np.asarray(ref_decode(qj, kj, vj, jnp.asarray(kv_len)))
    np.testing.assert_allclose(got, want, atol=2e-5)
    for row, n in enumerate(lens):
        skipped = np.arange(n_sp) * ops.SPLIT >= n if n > 0 else np.zeros(
            n_sp, bool)
        assert (l[row][:, skipped] == 0).all()
        assert (m[row][:, skipped] == ops.NEG_INF).all()


def _bf16_err(got, want):
    """max |got - want| / max(1, |want|): the bf16 bar."""
    return (np.abs(got - want) / np.maximum(1.0, np.abs(want))).max()


@pytest.mark.parametrize("b,h,hkv,t,d,dtype,lens", [
    (3, 4, 4, 1536, 32, jnp.bfloat16, (1536, 0, 1025)),   # group 1
    (3, 4, 2, 1100, 64, jnp.bfloat16, (0, 1024, 1100)),   # group 2
    (2, 16, 4, 1024, 128, jnp.float32, (1024, 512)),      # group 4
    (2, 12, 2, 2049, 128, jnp.float32, (2048, 2049)),     # group 6
    (2, 16, 2, 513, 16, jnp.float32, (513, 1)),           # group 8
    (1, 32, 2, 777, 64, jnp.bfloat16, (777,)),            # group 16
    (1, 32, 2, 777, 64, jnp.float32, (700,)),
    (1, 32, 1, 600, 128, jnp.bfloat16, (600,)),           # group 32
    (2, 8, 8, 64, 16, jnp.bfloat16, (64, 0)),
])
def test_decode_edge_cases_match_the_reference(b, h, hkv, t, d, dtype, lens):
    """The card's decode design at its edges — GQA groups 1 to 32 (a block
    takes 16 heads a pass in bf16, 8 in fp32), every head width, fp32 and
    bf16, kv_len 0, 1, on a split boundary and T, T off the split — through
    its arithmetic in plain PyTorch (``decode_partials_plain`` merged by
    ``merge_splits``) and the wrapper's CPU path, against the reference's
    oracle and, where T is a whole number of 512-splits, its Pallas kernel
    in interpret mode."""
    rng = np.random.RandomState(t + h)
    qj, qt = _pair(rng.randn(b, h, d) * 0.4, dtype)
    kj, kt = _pair(rng.randn(b, hkv, t, d) * 0.4, dtype)
    vj, vt = _pair(rng.randn(b, hkv, t, d), dtype)
    kv_len = np.asarray(lens, np.int32)
    want = _f32(ref_decode(qj, kj, vj, jnp.asarray(kv_len)))
    acc, m, l = ops.decode_partials_plain(qt, kt, vt, torch.from_numpy(kv_len))
    fused = ops.merge_splits(acc, m, l, qt.dtype)
    cpu = ops.flash_decode(qt, kt, vt, torch.from_numpy(kv_len))
    assert fused.dtype == cpu.dtype == qt.dtype and fused.shape == (b, h, d)
    outs = [_f32(fused), _f32(cpu)]
    if t % ops.SPLIT == 0:
        outs.append(_f32(ref_flash_decode(qj, kj, vj, jnp.asarray(kv_len),
                                          interpret=True)))
    for got in outs:
        if dtype == jnp.bfloat16:
            assert _bf16_err(got, want) <= 2e-2
        else:
            np.testing.assert_allclose(got, want, atol=2e-5)


def test_merge_splits_is_the_reference_merge():
    """``merge_splits`` against the reference wrapper's merge of the split
    partials (``repro/kernels/flash_attention/kernel.py``, the lines after
    its ``pallas_call``), on partials that hold skipped splits (m = -1e30,
    l = 0), an all-masked row (every m = -1e30) and m spread over 60."""
    rng = np.random.RandomState(9)
    b, h, n_sp, d = 3, 4, 7, 32
    acc = rng.randn(b, h, n_sp, d).astype(np.float32) * 5
    m = (rng.rand(b, h, n_sp) * 60 - 30).astype(np.float32)
    l = (rng.rand(b, h, n_sp) * 40 + 1).astype(np.float32)
    m[0, :, 4:] = ops.NEG_INF
    l[0, :, 4:] = 0.0
    acc[0, :, 4:] = 0.0
    m[1] = ops.NEG_INF
    accj, mj, lj = map(jnp.asarray, (acc, m, l))
    m_star = jnp.max(mj, axis=-1, keepdims=True)
    scale_sp = jnp.exp(mj - m_star)
    denom = jnp.maximum(jnp.sum(scale_sp * lj, axis=-1, keepdims=True), 1e-30)
    want = np.asarray(jnp.sum(accj * scale_sp[..., None], axis=2) / denom)
    got = ops.merge_splits(*map(torch.from_numpy, (acc, m, l)),
                           torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


class _FakeExtension:
    """Stands in for the compiled module: records launches."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def launch(*args):
            self.calls.append(name)
        return launch


def _meta_calls(dtype=torch.float32):
    def empty(*shape):
        return torch.empty(shape, dtype=dtype, device="meta")
    kv_len = torch.empty((2,), dtype=torch.int32, device="meta")
    return [
        lambda: ops.flash_attention(empty(2, 8, 64, 64), empty(2, 2, 64, 64),
                                    empty(2, 2, 64, 64)),
        lambda: attn.chunked_attention(empty(2, 8, 64, 64),
                                       empty(2, 2, 64, 64),
                                       empty(2, 2, 64, 64), causal=True),
        lambda: ops.flash_decode(empty(2, 8, 64), empty(2, 2, 600, 64),
                                 empty(2, 2, 600, 64), kv_len),
        lambda: attn.gqa_decode(empty(2, 8, 64), empty(2, 2, 600, 64),
                                empty(2, 2, 600, 64), kv_len),
    ]


def test_device_tensors_never_reach_the_plain_versions(monkeypatch):
    fake = _FakeExtension()
    monkeypatch.setattr(kernels, "extension", lambda: fake)

    def refuse(*a, **k):
        raise AssertionError("plain version reached")
    for name in ("attention_ref", "attention_tc_plain", "decode_ref",
                 "decode_partials_plain"):
        monkeypatch.setattr(ops, name, refuse)
    monkeypatch.setattr(attn, "_repeat_kv", refuse)
    # tensors off the CPU that are not CUDA tensors: refused, no plain path
    for call in _meta_calls():
        with pytest.raises(ValueError, match="CUDA tensor"):
            call()
    assert fake.calls == []
    # past the device check the wrappers launch their kernels and count:
    # the prefill launch by dtype, bf16 on the tensor cores, fp32 on the
    # CUDA cores, one count a call either way
    monkeypatch.setattr(ops, "_check_kernel_inputs", lambda *a: None)
    for dtype, prefill in ((torch.float32, "flash_attention"),
                           (torch.bfloat16, "flash_attention_sm90")):
        fake.calls.clear()
        kernels.reset_launches()
        outs = [call() for call in _meta_calls(dtype)]
        assert fake.calls == [prefill] * 2 + ["flash_decode"] * 2
        assert kernels.LAUNCHES["flash_attention"] == 2
        assert kernels.LAUNCHES["flash_decode"] == 2
        assert [tuple(o.shape) for o in outs] == [(2, 8, 64, 64)] * 2 + [
            (2, 8, 64)] * 2
        assert all(o.dtype == dtype for o in outs)
    kernels.reset_launches()


@pytest.mark.parametrize("case,match", [
    (dict(d=48), "head width"),
    (dict(dv=32), "widths must equal"),
    (dict(dtype=torch.float16), "dtype"),
    (dict(sk=128), "Sq == Sk"),
])
def test_card_wrapper_refuses_what_the_kernel_does_not_take(case, match):
    d, sk = case.get("d", 64), case.get("sk", 64)
    dt = case.get("dtype", torch.float32)
    q = torch.empty((1, 4, 64, d), dtype=dt, device="meta")
    k = torch.empty((1, 2, sk, d), dtype=dt, device="meta")
    v = torch.empty((1, 2, sk, case.get("dv", d)), dtype=dt, device="meta")
    with pytest.raises(ValueError, match=match):
        ops.flash_attention(q, k, v, causal=True)
    if "sk" not in case:
        with pytest.raises(ValueError, match=match):
            ops.flash_decode(q[:, :, 0], k, v,
                             torch.ones(1, dtype=torch.int32, device="meta"))


def test_card_decode_refuses_a_misaligned_cache(monkeypatch):
    """The decode kernel stages q and the cache with 16-byte copies: the
    wrapper raises on a base off a 16-byte boundary before any launch."""
    fake = _FakeExtension()
    monkeypatch.setattr(kernels, "extension", lambda: fake)
    monkeypatch.setattr(ops, "_check_kernel_inputs", lambda *a: None)
    kv_len = torch.ones((1,), dtype=torch.int32, device="meta")
    q = torch.empty((1, 4, 64), device="meta")
    cache = torch.empty((1, 2, 600, 64), device="meta")
    off = torch.empty(2 * 600 * 64 + 1, device="meta")[1:].view(1, 2, 600,
                                                                  64)
    for args in ((q, off, cache), (q, cache, off)):
        with pytest.raises(ValueError, match="16-byte boundary"):
            ops.flash_decode(*args, kv_len)
    assert fake.calls == []
    ops.flash_decode(q, cache, cache, kv_len)
    assert fake.calls == ["flash_decode"]
    kernels.reset_launches()


@pytest.mark.parametrize("case,match", [
    ("base", "16-byte boundary"),
    ("stride", "multiple of 16 bytes"),
])
def test_card_wrapper_refuses_what_tma_does_not_take(monkeypatch, case,
                                                      match):
    """The bf16 route's TMA needs 16-byte-aligned bases and (B, H, S)
    strides; the wrapper raises on either before any launch (no copy, no
    fallback)."""
    fake = _FakeExtension()
    monkeypatch.setattr(kernels, "extension", lambda: fake)
    monkeypatch.setattr(ops, "_check_kernel_inputs", lambda *a: None)
    def view(dtype):
        if case == "base":     # one element past an aligned start
            t = torch.empty(4 * 64 * 64 + 1, dtype=dtype, device="meta")
            return t[1:].view(1, 4, 64, 64)
        # rows of 66 elements: 132 bytes in bf16
        return torch.empty((1, 4, 64, 66), dtype=dtype,
                           device="meta")[..., :64]

    for dtype, taken in ((torch.bfloat16, False), (torch.float32, True)):
        k = torch.empty((1, 2, 64, 64), dtype=dtype, device="meta")
        if taken:   # the CUDA-core kernel takes the same view in fp32
            ops.flash_attention(view(dtype), k, k.clone(), causal=True)
            assert fake.calls == ["flash_attention"]
        else:
            with pytest.raises(ValueError, match=match):
                ops.flash_attention(view(dtype), k, k.clone(), causal=True)
            assert fake.calls == []
