"""Kernel 8's fp32 forward (``flash_attention.cu``) through its plain twin,
against the reference.

``ops.attention_f32_tiles_plain`` repeats the fp32 kernel's arithmetic
(its 128-row query tiles and 32-key online-softmax steps, from
``ops.f32_forward_tiles``) in plain PyTorch.  It is held on the CPU to the
reference's Pallas ``flash_attention`` (``interpret=True``, with ``tq`` and
``tk`` dividing S, since it drops a ragged tail; only where it takes the
call: Sq = Sk and v as wide as q) and to the reference model's jnp
``chunked_attention`` (one chunk: Sk <= 512), on the output, and on the
log-sum-exp against the log-sum-exp of the scaled, masked logits (float64,
NumPy): BERT4Rec's (2, 2, 200, 32) non-causal as strided (B, S, H, D)
views, (1, 4, 129, 16) causal, GQA group 2 at D 64, MLA's (96, 64) causal,
and Sk of 1, 255, 256 and 257 at D 32, causal (Sq = Sk) and not.  The
geometry itself: every built width pair's shared memory within a block's
227 KB and its blocks an SM within the SM's 228 KB, and every lane of a
warp owning accumulator columns, each (row, column) of a warp's tile
owned once.  On CPU tensors the wrapper runs ``attention_ref``, the plain
version of the main path.

Tolerance: 1e-5 absolute, on outputs and log-sum-exps of O(1) inputs:
both sides compute in fp32 and sum in other orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention.kernel import (
    flash_attention as ref_flash_attention)
from repro.models.attention import chunked_attention as ref_chunked
from repro_torch.kernels.flash_attention import ops

TOL = 1e-5
SMEM_BLOCK, SMEM_SM, SMEM_RESERVED = 232_448, 233_472, 1_024

# (B, H, Hkv, Sq, Sk, D, Dv, causal, strided, tq): tq the reference
# kernel's tile (it takes tq = tk dividing S), None where it does not take
# the call
CASES = [
    (2, 2, 2, 200, 200, 32, 32, False, True, 100),   # BERT4Rec, views
    (1, 4, 4, 129, 129, 16, 16, True, False, 43),
    (1, 4, 2, 96, 96, 64, 64, True, False, 48),      # GQA group 2
    (1, 4, 2, 96, 96, 64, 64, False, False, 48),
    (1, 2, 2, 130, 130, 96, 64, True, False, None),  # MLA's widths
]
SK_EDGES = (1, 255, 256, 257)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: several pytest workers run side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(b, h, hkv, sq, sk, d, dv, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, h, sq, d).astype(np.float32) * 0.4,
            rng.randn(b, hkv, sk, d).astype(np.float32) * 0.4,
            rng.randn(b, hkv, sk, dv).astype(np.float32))


def _torch(x, strided):
    """(B, H, S, W) as a torch tensor; ``strided``: a view of a (B, S,
    H·W) tensor, as the model passes q, k and v."""
    if not strided:
        return torch.from_numpy(x.copy())
    b, h, s, w = x.shape
    flat = torch.from_numpy(np.ascontiguousarray(
        x.transpose(0, 2, 1, 3)).reshape(b, s, h * w))
    return flat.view(b, s, h, w).transpose(1, 2)


def _ref_lse(q, k, causal):
    """The logsumexp of the scaled, masked logits (B, H, Sq), in float64."""
    group = q.shape[1] // k.shape[1]
    kx = np.repeat(k.astype(np.float64), group, axis=1)
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), kx)
    s *= q.shape[-1] ** -0.5
    if causal:
        s = np.where(np.tril(np.ones(s.shape[-2:], bool)), s, -1e30)
    mx = s.max(axis=-1, keepdims=True)
    return (mx + np.log(np.exp(s - mx).sum(axis=-1, keepdims=True)))[..., 0]


def _check(case, seed):
    b, h, hkv, sq, sk, d, dv, causal, strided, tq = case
    q, k, v = _inputs(b, h, hkv, sq, sk, d, dv, seed)
    tq_, tk_, tv_ = (_torch(x, strided) for x in (q, k, v))
    if strided:
        assert not tq_.is_contiguous()
    out, lse = ops.attention_f32_tiles_plain(tq_, tk_, tv_, causal=causal,
                                             return_lse=True)
    out, lse = out.numpy(), lse.numpy()
    want = np.asarray(ref_chunked(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal))
    np.testing.assert_allclose(out, want, rtol=0, atol=TOL)
    if tq is not None:
        want = np.asarray(ref_flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
            tq=tq, tk=tq, interpret=True))
        np.testing.assert_allclose(out, want, rtol=0, atol=TOL)
    np.testing.assert_allclose(lse, _ref_lse(q, k, causal), rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("case", CASES)
def test_tiles_plain_matches_reference(case):
    _check(case, seed=sum(case[:7]))


@pytest.mark.parametrize("sk", SK_EDGES)
@pytest.mark.parametrize("causal", [True, False])
def test_tiles_plain_at_key_tile_edges(sk, causal):
    sq = sk if causal else 37
    tq = {1: 1, 255: 85, 256: 128, 257: 257}[sk] if causal else None
    _check((1, 2, 1, sq, sk, 32, 32, causal, False, tq), seed=sk)


@pytest.mark.parametrize("pair", ops.PREFILL_WIDTHS)
def test_geometry_fits_the_card(pair):
    t = ops.f32_forward_tiles(*pair)
    assert t["smem_bytes"] <= SMEM_BLOCK
    assert t["min_blocks"] * (t["smem_bytes"] + SMEM_RESERVED) <= SMEM_SM
    assert t["rows"] == t["warps"] * t["rows_warp"]
    assert t["rows_warp"] == 4 * t["rows_lane"]
    assert t["keys"] % t["chunk"] == 0 and t["stages"] >= 2


@pytest.mark.parametrize("pair", ops.PREFILL_WIDTHS)
def test_every_lane_owns_output_columns(pair):
    t = ops.f32_forward_tiles(*pair)
    lanes = ops.f32_forward_lanes(*pair)
    assert len(lanes) == 32
    owned = [(r, c) for rows, cols in lanes for r in rows for c in cols]
    assert all(rows and cols for rows, cols in lanes)
    assert len(owned) == len(set(owned)) == t["rows_warp"] * pair[1]
    assert {c for _, c in owned} == set(range(pair[1]))


def test_cpu_wrapper_runs_the_plain_version():
    case = CASES[0]
    q, k, v = (_torch(x, True) for x in _inputs(*case[:7], seed=3))
    got, lse = ops.flash_attention(q, k, v, causal=False, return_lse=True)
    want, want_lse = ops.attention_ref(q, k, v, causal=False,
                                       return_lse=True)
    assert torch.equal(got, want) and torch.equal(lse, want_lse)
    tiles, tiles_lse = ops.attention_f32_tiles_plain(q, k, v, causal=False,
                                                     return_lse=True)
    assert float((tiles - want).abs().max()) <= TOL
    assert float((tiles_lse - want_lse).abs().max()) <= TOL
