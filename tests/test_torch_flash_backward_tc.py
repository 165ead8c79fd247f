"""The bf16 backward kernels' arithmetic (``flash_attention_backward_tc_plain``)
against the reference's autodiff and the port's plain backward.

On the card kernel 8's bf16 backward feeds P and dS to the tensor cores as
bf16, rounded once (``halves=1``) or split into hi + lo halves
(``halves=2``); ``flash_attention_backward_tc_plain`` is that arithmetic in
plain PyTorch, and ``chip_smoke.py`` measures both roundings on the card's
calls to choose between them.  Here, at small shapes on bf16 inputs drawn
from a NumPy seed — widths (16, 16), (96, 64) and (32, 32), GQA groups 1,
2 and 3, a ragged S of 129, causal and not — each rounding is held to:

* ``jax.grad`` of the reference's ``chunked_attention``
  (``src/repro/models/attention.py:35``) on the same bf16 q, k, v and dO,
  whose gradients come back in bf16;
* ``flash_attention_backward_plain`` (P and dS unrounded) on the same
  inputs, output and log-sum-exp (``attention_tc_plain``'s, the bf16
  forward kernel's arithmetic).

Bars, of each gradient's largest magnitude: every side rounds its fp32
gradients to bf16 once, and one bf16 ulp is up to 2^-7 of a value.  Against
the plain backward: 2^-7 with hi + lo (16 bits of P and dS: only the final
rounding differs), 2^-6 rounded once (P and dS carry 2^-9 relative errors
into every sum).  Against the reference: 2^-6 (its autodiff differentiates
the fp32 output; the port's D = rowsum(dO ∘ O) reads the bf16 output).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import attention as ref_attn
from repro_torch.kernels.flash_attention import ops

ULP = 2.0 ** -7
BAR_PLAIN = {2: ULP, 1: 2 * ULP}
BAR_REF = 2 * ULP
# (B, H, Hkv, S, D, Dv)
CASES = [(2, 4, 4, 64, 16, 16), (1, 4, 2, 64, 96, 64),
         (1, 6, 2, 48, 32, 32), (1, 2, 1, 129, 16, 16)]
_CACHE = {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: several pytest workers run side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16(x):
    """``x`` rounded to bf16 values, as fp32 NumPy."""
    return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def _setup(case, causal):
    """(bf16 q, k, v, dO as torch tensors; the port's forward output and
    log-sum-exp; the reference's gradients as fp32 NumPy), once a case."""
    key = (case, causal)
    if key not in _CACHE:
        b, h, hkv, s, d, dv = case
        rng = np.random.RandomState(s + d)
        q, k, v, do = (_bf16(rng.randn(*shape)) for shape in
                       ((b, h, s, d), (b, hkv, s, d), (b, hkv, s, dv),
                        (b, h, s, dv)))
        chunk = 32 if s % 32 == 0 else s

        def f(q_, k_, v_):
            out = ref_attn.chunked_attention(q_, k_, v_, causal=causal,
                                             chunk=chunk)
            return jnp.sum(out.astype(jnp.float32) * jnp.asarray(do))
        want = jax.grad(f, argnums=(0, 1, 2))(
            *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
        assert all(w.dtype == jnp.bfloat16 for w in want)
        args = tuple(torch.tensor(x).to(torch.bfloat16)
                     for x in (q, k, v, do))
        o, lse = ops.attention_tc_plain(*args[:3], causal=causal,
                                        return_lse=True)
        _CACHE[key] = (args, o, lse, [np.asarray(w, np.float32)
                                      for w in want])
    return _CACHE[key]


def _err(got, want):
    """The largest error of the three gradients, each of its own largest
    magnitude."""
    return max(float(np.abs(g.float().numpy() - w).max() / np.abs(w).max())
               for g, w in zip(got, want))


@pytest.mark.parametrize("halves", [1, 2])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", CASES)
def test_tc_plain_matches_reference_and_plain(case, causal, halves):
    (q, k, v, do), o, lse, want = _setup(case, causal)
    got = ops.flash_attention_backward_tc_plain(q, k, v, o, lse, do,
                                                causal=causal, halves=halves)
    for g, x in zip(got, (q, k, v)):
        assert g.shape == x.shape and g.dtype == torch.bfloat16
    assert _err(got, want) <= BAR_REF
    plain = ops.flash_attention_backward_plain(q, k, v, o, lse, do,
                                               causal=causal)
    assert _err(got, [p.float().numpy() for p in plain]) <= BAR_PLAIN[halves]


def test_tc_plain_rounds_p_and_ds():
    """halves=1 differs from the unrounded recurrence, hi + lo much less;
    any other ``halves`` is refused."""
    (q, k, v, do), o, lse, _ = _setup(CASES[0], True)
    args = (q.float(), k.float(), v.float(), o.float(), lse, do.float())
    plain = ops.flash_attention_backward_plain(*args, causal=True)
    one = ops.flash_attention_backward_tc_plain(*args, causal=True, halves=1)
    two = ops.flash_attention_backward_tc_plain(*args, causal=True, halves=2)
    want = [p.numpy() for p in plain]
    assert _err(one, want) > 10 * _err(two, want) > 0
    with pytest.raises(ValueError, match="halves"):
        ops.flash_attention_backward_tc_plain(*args, causal=True, halves=3)
