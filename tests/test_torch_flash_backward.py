"""Kernel 8's backward (training) against the reference's autodiff.

The reference has no backward kernel: it trains through ``jax.grad`` of
its ``chunked_attention`` (a checkpointed scan).  The port's
``ops.flash_attention_backward_plain`` (the backward kernels' recurrence
from the saved log-sum-exp) and the CPU backward of
``models.attention.ChunkedAttention`` (what ``chunked_attention`` runs
when a gradient is needed) are held to ``jax.grad`` of the reference's
``chunked_attention`` on the same inputs: causal and not, GQA groups 1, 2
and 3, widths (16, 16) and (24, 32), a sequence that is not a multiple of
the chunk's tile.  The forward's log-sum-exp (the plain loop's, the
wrapper's and ``attention_tc_plain``'s) is held to the reference's
logits' ``logsumexp``.  No gradient needed, the serving path launches the
prefill kernel as before and writes no log-sum-exp; on device tensors
(meta, with a fake extension) the backward wrapper launches its kernel once
a call, counted, refuses what the kernel does not take, hands it o and dO
contiguous (copies where they are not) and, in fp32 past the kernel's KV
tile, scratch for its dQ partials.

Tolerance: 1e-5 of the compared tensor's largest magnitude.  Both sides
compute in fp32 on O(1) inputs and sum in other orders (the reference's
autodiff of the online softmax, the port's recurrence from the
log-sum-exp); an order change moves an element by a few 1e-7 of that
magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import attention as ref_attn
from repro_torch import kernels
from repro_torch.kernels.flash_attention import ops
from repro_torch.models import attention as attn

REL = 1e-5
# (B, H, Hkv, S, D, Dv, chunk)
CASES = [(2, 4, 4, 64, 16, 16, 16), (1, 6, 2, 48, 24, 32, 16),
         (2, 6, 3, 40, 16, 16, 40), (1, 4, 1, 96, 24, 32, 32)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: several pytest workers run side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(case, seed):
    b, h, hkv, s, d, dv, _ = case
    rng = np.random.RandomState(seed)
    return (rng.randn(b, h, s, d).astype(np.float32),
            rng.randn(b, hkv, s, d).astype(np.float32),
            rng.randn(b, hkv, s, dv).astype(np.float32),
            rng.randn(b, h, s, dv).astype(np.float32))


def _ref_grads(q, k, v, do, causal, chunk):
    def f(q, k, v):
        out = ref_attn.chunked_attention(q, k, v, causal=causal, chunk=chunk)
        return jnp.sum(out * do)
    return [np.asarray(g) for g in
            jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v))]


def _close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().numpy(), want,
                               atol=REL * np.abs(want).max())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", CASES)
def test_backward_plain_matches_reference_grad(case, causal):
    q, k, v, do = _inputs(case, 1)
    chunk = case[-1]
    want = _ref_grads(q, k, v, do, causal, chunk)
    qt, kt, vt, dot = (torch.from_numpy(x) for x in (q, k, v, do))
    out, lse = attn.chunked_attention_plain(qt, kt, vt, causal=causal,
                                            chunk=chunk, return_lse=True)
    got = ops.flash_attention_backward_plain(qt, kt, vt, out, lse, dot,
                                             causal=causal, chunk=chunk)
    for g, w, shape in zip(got, want, (q.shape, k.shape, v.shape)):
        assert tuple(g.shape) == shape and g.dtype == torch.float32
        _close(g, w)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", CASES)
def test_function_cpu_backward_matches_reference_grad(case, causal):
    q, k, v, do = _inputs(case, 2)
    chunk = case[-1]
    want = _ref_grads(q, k, v, do, causal, chunk)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = attn.chunked_attention(*leaves, causal=causal, chunk=chunk)
    ref_out = ref_attn.chunked_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                         causal=causal, chunk=chunk)
    _close(out, ref_out)
    assert out.grad_fn is not None \
        and type(out.grad_fn).__name__.startswith("ChunkedAttention")
    out.backward(torch.from_numpy(do))
    for leaf, w in zip(leaves, want):
        _close(leaf.grad, w)


@pytest.mark.parametrize("causal", [True, False])
def test_forward_lse_matches_reference_logsumexp(causal):
    q, k, v, _ = _inputs(CASES[1], 3)
    b, h, hkv, s, d = CASES[1][:5]
    kx = np.repeat(k, h // hkv, axis=1)
    logits = jnp.einsum("bhqd,bhkd->bhqk", jnp.asarray(q) * d ** -0.5,
                        jnp.asarray(kx))
    if causal:
        logits = jnp.where(jnp.tril(jnp.ones((s, s), bool)), logits, -1e30)
    want = np.asarray(jax.nn.logsumexp(logits, axis=-1))
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    for chunk in (16, 48):
        _, lse = attn.chunked_attention_plain(qt, kt, vt, causal=causal,
                                              chunk=chunk, return_lse=True)
        np.testing.assert_allclose(lse.numpy(), want, rtol=1e-6, atol=1e-5)
    _, lse = ops.flash_attention(qt, kt, vt, causal=causal, return_lse=True)
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_tensor_core_plain_lse_matches_reference_logsumexp(causal):
    """``attention_tc_plain`` (the bf16 kernel's arithmetic) returns the
    same output with ``return_lse`` as without, and the reference's
    logsumexp of the logits, over several of its 128-row query blocks."""
    b, h, hkv, s, d = 1, 4, 2, 300, 16
    rng = np.random.RandomState(5)
    q, k, v = (rng.randn(b, n, s, d).astype(np.float32)
               for n in (h, hkv, hkv))
    kx = np.repeat(k, h // hkv, axis=1)
    logits = jnp.einsum("bhqd,bhkd->bhqk", jnp.asarray(q),
                        jnp.asarray(kx)) * d ** -0.5
    if causal:
        logits = jnp.where(jnp.tril(jnp.ones((s, s), bool)), logits, -1e30)
    want = np.asarray(jax.nn.logsumexp(logits, axis=-1))
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    out, lse = ops.attention_tc_plain(qt, kt, vt, causal=causal,
                                      return_lse=True)
    assert torch.equal(out, ops.attention_tc_plain(qt, kt, vt,
                                                   causal=causal))
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-6, atol=1e-5)


def test_no_grad_path_is_the_serving_call(monkeypatch):
    """Without a gradient the call never enters the autograd Function and
    asks for no log-sum-exp; with one it does."""
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(CASES[0], 4))
    seen = []
    real = attn._attend
    monkeypatch.setattr(attn, "_attend",
                        lambda *a: seen.append(a[-1]) or real(*a))
    with torch.no_grad():
        attn.chunked_attention(q.requires_grad_(True), k, v, causal=True)
    attn.chunked_attention(q.detach(), k, v, causal=True)
    assert seen == [False, False]
    attn.chunked_attention(q.detach().requires_grad_(True), k, v,
                           causal=True)
    assert seen == [False, False, True]


class _FakeExtension:
    """Stands in for the compiled module: records each launch's name and
    whether it was handed a log-sum-exp tensor (forward) or the widths of
    its gradients (backward; and whether o and dO came contiguous, and the
    size of the fp32 kernel's dQ partials)."""

    def __init__(self):
        self.calls = []
        self.rows = []

    def __getattr__(self, name):
        def launch(*args):
            if name == "flash_attention_backward":
                dq, dk, dv, part = args[7:11]
                self.calls.append((name, tuple(dq.shape), tuple(dk.shape),
                                   tuple(dv.shape), dq.dtype))
                self.rows.append((args[3].is_contiguous(),
                                  args[4].is_contiguous(),
                                  None if part is None else part.numel()))
            else:
                self.calls.append((name, args[-1] is not None))
        return launch


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,dv", [(128, 128), (96, 64), (16, 16)])
def test_card_wrappers_launch_and_count(monkeypatch, dtype, d, dv):
    fake = _FakeExtension()
    monkeypatch.setattr(kernels, "extension", lambda: fake)
    monkeypatch.setattr(kernels, "check_cuda_args", lambda *a: None)
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
    kernels.reset_launches()

    def empty(*shape, dt=dtype):
        return torch.empty(shape, dtype=dt, device="meta")
    q, k, v = empty(2, 8, 64, d), empty(2, 2, 64, d), empty(2, 2, 64, dv)
    out = ops.flash_attention(q, k, v, causal=True)
    out, lse = ops.flash_attention(q, k, v, causal=True, return_lse=True)
    assert tuple(lse.shape) == (2, 8, 64) and lse.dtype == torch.float32
    dq, dk, dvv = ops.flash_attention_backward(
        q, k, v, out, lse, empty(2, 8, 64, dv), causal=True)
    launch = "flash_attention_sm90" if dtype == torch.bfloat16 \
        else "flash_attention"
    assert fake.calls == [
        (launch, False), (launch, True),
        ("flash_attention_backward", (2, 8, 64, d), (2, 2, 64, d),
         (2, 2, 64, dv), dtype)]
    assert (dq.shape, dk.shape, dvv.shape) == (q.shape, k.shape, v.shape)
    assert kernels.LAUNCHES["flash_attention"] == 2
    assert kernels.LAUNCHES["flash_attention_backward"] == 1
    # refused before any launch: an unbuilt width pair, a causal Sq != Sk,
    # a log-sum-exp of the wrong shape
    with pytest.raises(ValueError, match="not a pair the kernel is built"):
        ops.flash_attention_backward(
            empty(1, 4, 64, d), empty(1, 4, 64, d), empty(1, 4, 64, 32),
            empty(1, 4, 64, 32), empty(1, 4, 64, dt=torch.float32),
            empty(1, 4, 64, 32))
    with pytest.raises(ValueError, match="causal mode needs Sq == Sk"):
        ops.flash_attention_backward(
            empty(1, 4, 32, d), empty(1, 2, 64, d), empty(1, 2, 64, dv),
            empty(1, 4, 32, dv), empty(1, 4, 32, dt=torch.float32),
            empty(1, 4, 32, dv))
    with pytest.raises(ValueError, match="lse must be"):
        ops.flash_attention_backward(q, k, v, out, lse[:, :4], out)
    assert len(fake.calls) == 3
    # o and dO of other strides reach the kernels as contiguous copies; an
    # fp32 call past the kernel's KV tile takes dQ partials a tile
    ops.flash_attention_backward(
        q, k, v, empty(2, 8, dv, 64).transpose(2, 3),
        lse, empty(2, 64, 8, dv).transpose(1, 2), causal=True)
    sk = 3 * ops.f32_key_tile(d, dv) - 1
    long_q, long_k = empty(1, 2, sk, d), empty(1, 1, sk, d)
    ops.flash_attention_backward(
        long_q, long_k, empty(1, 1, sk, dv), empty(1, 2, sk, dv),
        empty(1, 2, sk, dt=torch.float32), empty(1, 2, sk, dv), causal=True)
    assert fake.rows == [(True, True, None)] * 2 + [
        (True, True, None if dtype == torch.bfloat16 else 3 * 2 * sk * d)]
    assert kernels.LAUNCHES["flash_attention_backward"] == 3
    kernels.reset_launches()
