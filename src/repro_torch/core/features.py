"""Stage-0 pre-retrieval feature extraction (147 features).

Following Culpepper et al. [16] and the paper: for each query term we read
aggregate statistics of its postings-list *scores* under six similarity
functions (TF·IDF, BM25, query likelihood, Bose-Einstein, DPH, DFR/PL2) —
{max, arithmetic mean, geometric mean, harmonic mean, median, std} — and
aggregate each statistic over the query terms with {max, min, mean, variance},
giving 6 × 6 × 4 = 144 features, plus 3 query-level features (query length,
log total document frequency, log min document frequency) = 147.

The per-term statistics are precomputed at index-build time into a dense
``(vocab, 36)`` table, so query featurization is a gather + masked reduce.

Exactness: the Stage-0 GBRTs bin these features with ``x > edge`` against
edges that are quantiles of the reference's own features, so a one-ulp
difference can flip a bin, a leaf and then a route.  ``extract`` therefore
keeps the reference's float32 arithmetic step for step: the reductions
over query terms run left to right, as the reference's compiled sums do,
and ``log1p`` is ``xla_log1p``, the float32 polynomial the reference's
compiled program evaluates (not the platform's ``log1p``, which differs in
the last bit on about 1 % of inputs).
"""

from __future__ import annotations

import struct

import torch

N_SIMS = 6
N_STATS = 6
N_TERM_FEATURES = N_SIMS * N_STATS        # 36
N_QUERY_AGGS = 4
N_FEATURES = N_TERM_FEATURES * N_QUERY_AGGS + 3   # 147

SIM_NAMES = ("tfidf", "bm25", "ql", "bose_einstein", "dph", "pl2")
STAT_NAMES = ("max", "amean", "gmean", "hmean", "median", "std")


def _f32(hex_double: str) -> float:
    """A float32 constant written as the hex of its float64 widening."""
    return struct.unpack(">d", bytes.fromhex(hex_double))[0]


# Cephes-style log kernel constants (float32 values)
_LOG_P = [_f32(h) for h in (
    "3FB2043760000000", "BFBD7A3700000000", "3FBDE4A340000000",
    "BFBFCBA9E0000000", "3FC23D37E0000000", "BFC555CA00000000",
    "3FC999D580000000", "BFCFFFFF80000000", "3FD5555540000000")]
_LOG_Q1 = _f32("BF2BD01060000000")        # -2.12194440e-4
_LOG_Q2 = _f32("3FE6300000000000")        # 0.693359375
_SQRTHF = _f32("3FE6A09E60000000")
_MIN_NORMAL = _f32("3810000000000000")
# rational approximation for |x| < sqrt(2) - 1
_L1P_NUM = [_f32(h) for h in (
    "3F07BC0960000000", "3FDFE818A0000000", "401A509F40000000",
    "403DE97380000000", "404E798EC0000000", "404C8E75A0000000",
    "40340A2020000000")]
_L1P_DEN = [_f32(h) for h in (
    "402E2035A0000000", "4054C30B60000000", "406BB865A0000000",
    "4073519460000000", "406B0DB140000000", "404E0F3040000000")]
_L1P_SMALL = _f32("3FDA8279A0000000")


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 fused multiply-add: the float64 product of two float32
    values is exact, so one rounding of product + addend to float32."""
    return (a.double() * torch.as_tensor(b, dtype=torch.float64)
            + torch.as_tensor(c, dtype=torch.float64)).float()


def xla_log1p(x: torch.Tensor) -> torch.Tensor:
    """float32 ``log1p`` as the reference's compiled program evaluates it
    (Cephes-style range reduction and polynomial, fused multiply-adds where
    the compiled program fuses them), bit for bit."""
    x = x.float()
    v = x + 1.0
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
    big = _fma(e, _LOG_Q2, _fma(z2, -0.5, z) + y)
    big = torch.where(v == float("inf"), v, big)
    big = torch.where(v == 0, float("-inf"), big)
    big = torch.where(v < 0, float("nan"), big)
    num = torch.full_like(x, _L1P_NUM[0])
    for c in _L1P_NUM[1:]:
        num = _fma(num, x, c)
    den = torch.ones_like(x)
    for c in _L1P_DEN:
        den = _fma(den, x, c)
    x2 = x * x
    small = x + _fma(x2, -0.5, (x * x2) * (num / den))
    return torch.where(x.abs() < _L1P_SMALL, small, big)


def _sum_terms(x: torch.Tensor) -> torch.Tensor:
    """Sum over the query-term axis (dim 1), left to right."""
    s = x[:, 0]
    for l in range(1, x.shape[1]):
        s = s + x[:, l]
    return s


def extract(term_stats: torch.Tensor, term_df: torch.Tensor,
            query_terms: torch.Tensor, query_mask: torch.Tensor
            ) -> torch.Tensor:
    """Featurize a batch of queries.

    Args:
      term_stats: (V, 36) float32 per-term score statistics.
      term_df: (V,) document frequencies.
      query_terms: (Q, L) padded term ids.
      query_mask: (Q, L) 1.0 for real terms.
    Returns:
      (Q, 147) float32 feature matrix.
    """
    t = query_terms.long()
    qm = query_mask.float()
    stats = term_stats[t].float()                        # (Q, L, 36)
    m = qm[:, :, None]
    big = 1e30
    n_terms = torch.clamp(_sum_terms(qm), min=1.0)       # (Q,)

    mx = torch.where(m > 0, stats, -big).amax(dim=1)
    mn = torch.where(m > 0, stats, big).amin(dim=1)
    mean = _sum_terms(stats * m) / n_terms[:, None]
    d = stats - mean[:, None, :]
    var = _sum_terms(d * d * m) / n_terms[:, None]

    df = term_df[t].float()                              # (Q, L)
    sum_df = _sum_terms(df * qm)
    min_df = torch.where(qm > 0, df, big).amin(dim=1)
    qlevel = torch.stack([n_terms, xla_log1p(sum_df), xla_log1p(min_df)],
                         dim=1)
    return torch.cat([mx, mn, mean, var, qlevel], dim=1).float()

