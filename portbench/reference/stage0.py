"""Stage-0 of the plain reference: the 147 pre-retrieval features of a
query and the fixed-depth descent of a fitted forest (Algorithm 2's route
is the replay's, ``cascade.Replay``).

The feature arithmetic is a frozen copy of the program's float32 steps
(``repro_torch.core.features.extract`` with its ``xla_log1p``, and the
step's ``xla_expm1``): the forests bin a feature with ``x > edge`` against
edges that are the fit log's own feature values, so one ulp moves a bin.
With ``dtype=torch.bfloat16`` the same features and tree sums are taken in
bfloat16: the control, one precision below the configuration's float32.
"""

from __future__ import annotations

import struct

import torch


def _f32(hex_double: str) -> float:
    return struct.unpack(">d", bytes.fromhex(hex_double))[0]


def _round32(v: float) -> float:
    return struct.unpack("f", struct.pack("f", v))[0]


_LOG_P = [_f32(h) for h in (
    "3FB2043760000000", "BFBD7A3700000000", "3FBDE4A340000000",
    "BFBFCBA9E0000000", "3FC23D37E0000000", "BFC555CA00000000",
    "3FC999D580000000", "BFCFFFFF80000000", "3FD5555540000000")]
_LOG_Q1 = _f32("BF2BD01060000000")
_LOG_Q2 = _f32("3FE6300000000000")
_SQRTHF = _f32("3FE6A09E60000000")
_MIN_NORMAL = _f32("3810000000000000")
_L1P_NUM = [_f32(h) for h in (
    "3F07BC0960000000", "3FDFE818A0000000", "401A509F40000000",
    "403DE97380000000", "404E798EC0000000", "404C8E75A0000000",
    "40340A2020000000")]
_L1P_DEN = [_f32(h) for h in (
    "402E2035A0000000", "4054C30B60000000", "406BB865A0000000",
    "4073519460000000", "406B0DB140000000", "404E0F3040000000")]
_L1P_SMALL = _f32("3FDA8279A0000000")
_EXP_LO, _EXP_HI = _round32(-87.8), _round32(88.8)
_LOG2E = _round32(1.44269504088896341)
_EXP_C1, _EXP_C2 = _round32(0.693359375), _round32(-2.12194440e-4)
_EXP_P = [_round32(v) for v in (1.9875691500e-4, 1.3981999507e-3,
                                8.3334519073e-3, 4.1665795894e-2,
                                1.6666665459e-1, 5.0000001201e-1)]
_TANH_CLAMP = _round32(7.99881172180175781)
_TANH_SMALL = _round32(0.0004)
_TANH_NUM = [_round32(v) for v in (
    -2.76076847742355e-16, 2.00018790482477e-13, -8.60467152213735e-11,
    5.12229709037114e-08, 1.48572235717979e-05, 6.37261928875436e-04,
    4.89352455891786e-03)]
_TANH_DEN = [_round32(v) for v in (
    1.19825839466702e-06, 1.18534705686654e-04, 2.26843463243900e-03,
    4.89352518554385e-03)]


def _fma(a, b, c):
    """float32 a·b + c rounded once."""
    return (a.double() * torch.as_tensor(b, dtype=torch.float64)
            + torch.as_tensor(c, dtype=torch.float64)).float()


def _log(v):
    v = v.float()
    bits = torch.clamp(v, min=_MIN_NORMAL).view(torch.int32)
    e = ((bits >> 23) - 127).float() + 1.0
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    small_m = m < _SQRTHF
    z = (m + -1.0) + torch.where(small_m, m, 0.0)
    e = e - small_m.float()
    z2 = z * z
    z3 = z2 * z
    p = _LOG_P
    y = _fma(_fma(z, p[0], p[1]), z, p[2])
    y1 = _fma(_fma(z, p[3], p[4]), z, p[5])
    y2 = _fma(_fma(z, p[6], p[7]), z, p[8])
    y = _fma(_fma(y, z3, y1), z3, y2)
    y = _fma(y, z3, e * _LOG_Q1)
    out = _fma(e, _LOG_Q2, _fma(z2, -0.5, z) + y)
    out = torch.where(v == float("inf"), v, out)
    out = torch.where(v == 0, float("-inf"), out)
    return torch.where(v < 0, float("nan"), out)


def _log1p(x):
    x = x.float()
    big = _log(x + 1.0)
    num = torch.full_like(x, _L1P_NUM[0])
    for c in _L1P_NUM[1:]:
        num = _fma(num, x, c)
    den = torch.ones_like(x)
    for c in _L1P_DEN:
        den = _fma(den, x, c)
    x2 = x * x
    small = x + _fma(x2, -0.5, (x * x2) * (num / den))
    return torch.where(x.abs() < _L1P_SMALL, small, big)


def _flush(v):
    return torch.where(v.abs() < _MIN_NORMAL, 0.0, v)


def _exp(x):
    c = torch.clamp(x.float(), _EXP_LO, _EXP_HI)
    n = torch.clamp(torch.floor(_fma(c, _LOG2E, 0.5)), -127.0, 127.0)
    r = _fma(n, -_EXP_C2, _fma(n, -_EXP_C1, c))
    z = _fma(r, _EXP_P[0], _EXP_P[1])
    for p in _EXP_P[2:]:
        z = _fma(z, r, p)
    z = _fma(z, r * r, r) + 1.0
    pow2 = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    return _flush(z * pow2)


def _tanh(x):
    xc = torch.clamp(x, -_TANH_CLAMP, _TANH_CLAMP)
    x2 = xc * xc
    num = torch.full_like(x, _TANH_NUM[0])
    for c in _TANH_NUM[1:]:
        num = _fma(x2, num, c)
    den = torch.full_like(x, _TANH_DEN[0])
    for c in _TANH_DEN[1:]:
        den = _fma(x2, den, c)
    return torch.where(x.abs() < _TANH_SMALL, x, (xc * num) / den)


def expm1_step(x):
    """float32 ``expm1`` of the ISN step's compiled definition."""
    x = x.float()
    half = _flush(x * 0.5)
    small = _tanh(half) * (_exp(x) + 1.0)
    out = torch.where(x.abs() > 0.5, _exp(x) - 1.0, small)
    return torch.where(half == 0, x, out)


def _sum_terms(x):
    s = x[:, 0]
    for i in range(1, x.shape[1]):
        s = s + x[:, i]
    return s


def features(term_stats, df, terms, mask, dtype=torch.float32):
    """(Q, 147) features: per-term statistics aggregated over the query's
    terms by max, min, mean and variance (sums left to right), then the
    term count, log1p of the summed df and of the least df."""
    t = torch.as_tensor(terms).long()
    qm = torch.as_tensor(mask).to(dtype)
    stats = torch.as_tensor(term_stats)[t].to(dtype)
    m = qm[:, :, None]
    big = 1e30
    n_terms = torch.clamp(_sum_terms(qm), min=1.0)
    mx = torch.where(m > 0, stats, torch.tensor(-big, dtype=dtype)).amax(1)
    mn = torch.where(m > 0, stats, torch.tensor(big, dtype=dtype)).amin(1)
    mean = _sum_terms(stats * m) / n_terms[:, None]
    d = stats - mean[:, None, :]
    var = _sum_terms(d * d * m) / n_terms[:, None]
    dfq = torch.as_tensor(df)[t].to(dtype)
    sum_df = _sum_terms(dfq * qm)
    min_df = torch.where(qm > 0, dfq, torch.tensor(big, dtype=dtype)).amin(1)
    if dtype == torch.float32:
        l_sum, l_min = _log1p(sum_df), _log1p(min_df)
    else:
        l_sum, l_min = torch.log1p(sum_df), torch.log1p(min_df)
    q = torch.stack([n_terms, l_sum, l_min], dim=1)
    return torch.cat([mx, mn, mean, var, q], dim=1).float()


def _seq_sum(x):
    s = x[..., 0]
    for i in range(1, x.shape[-1]):
        s = s + x[..., i]
    return s


def _vector_sum(x):
    t = x.shape[-1]
    if t < 16 and t % 8:
        return _seq_sum(x)
    v = t // 8 * 8
    lanes = x[..., 0:8]
    for i in range(8, v, 8):
        lanes = lanes + x[..., i:i + 8]
    w = 8
    while w > 1:
        w //= 2
        lanes = lanes[..., :w] + lanes[..., w:2 * w]
    s = lanes[..., 0]
    for i in range(v, t):
        s = s + x[..., i]
    return s


def _window_sum(x):
    t = x.shape[-1]
    n = -(-t // 32)
    pad = n * 32 - t
    x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
    parts = _seq_sum(x.reshape(*x.shape[:-1], n, 32))
    return _seq_sum(parts) if n <= 32 else _window_sum(parts)


def tree_sum(leaves):
    """The trees' leaf values of each row summed in the definition's order
    (up to 32 trees in 8 lanes, more in windows of 32)."""
    return _vector_sum(leaves) if leaves.shape[-1] <= 32 else \
        _window_sum(leaves)


def forest_predict(forest: dict, x, dtype=torch.float32):
    """(Q,) base + Σ trees of a fitted forest ({feat, thresh: (T, D, W),
    leaf: (T, 2^D), base, bin_edges: (F, B-1)}) on (Q, F) features: the
    bin of a feature is the count of edges below it, a node goes right
    where the bin is above its threshold."""
    edges = forest["bin_edges"]
    xb = (x[:, :, None] > edges[None]).sum(-1).long()
    feat, thresh = forest["feat"].long(), forest["thresh"].long()
    n_trees, depth = feat.shape[0], feat.shape[1]
    tree = torch.arange(n_trees)[None, :]
    row = torch.arange(x.shape[0])[:, None]
    node = torch.zeros((x.shape[0], n_trees), dtype=torch.long)
    for d in range(depth):
        f = feat[tree, d, node]
        b = thresh[tree, d, node]
        node = node * 2 + (xb[row, f] > b).long()
    leaves = forest["leaf"].to(dtype)[tree, node]
    return (forest["base"].to(dtype) + tree_sum(leaves)).float()
