"""Stage-0 on the card: the 147 pre-retrieval features, and the stacked
forests' bins, descent and tree sums — the kernel wrappers and their plain
versions.

Two kernels live in ``stage0.cu``, each with a wrapper that launches it
for CUDA tensors and runs its plain version for CPU tensors:

* ``stage0_features`` (plain: ``stage0_features_plain``):
  ``core.features.extract`` of a (Q, L) batch in one launch.
* ``stage0_forest`` (plain: ``stage0_forest_plain``): the (M, Q)
  predictions of M stacked GBRTs in one launch — the bins (a feature's
  count of edges below it), the fixed-depth descent of every tree, the
  trees' sum in ``trees._sum_trees``'s order, the base added after, and,
  where the caller asks for it, ``xla_expm1`` of the result.  The bin
  edges are per model, (M, F, B - 1) as ``gbrt.StackedGBRT`` holds them,
  or shared, (F, B - 1) as the ISN step's ``ForestArrays`` holds them.

The plain versions are the torch sequences Stage-0 ran before the kernels
(``extract``'s body, with the reference's rule where +0.0 ties -0.0 in a
max or a min; ``gbrt.predict_stacked``'s, and the ISN step's
per-target descent with ``xla_expm1``), so the kernels answer to them bit
for bit.  Both kernels are also custom operators (``kernels.card_op``),
which fake tensors, DTensors and calls under a dispatch mode (the dry
run's) take: a fake that runs the launch's checks, a FLOP formula, and
shardings that split the queries.

This module also holds the float32 functions of the reference's compiled
program that Stage-0 needs bit for bit (``xla_log``, ``xla_log1p``,
``xla_exp``, ``xla_expm1``; ``core.features`` re-exports them): torch
sequences whose fused multiply-adds (``_fma``) take the exact float64
product and one float64 add, then round to float32.  The kernels evaluate
the same polynomials with ``__fmaf_rn`` in those places.
"""

from __future__ import annotations

import struct

import torch

from repro_torch import kernels
from repro_torch.core import trees as T

N_STATS = 36                  # per-term statistic columns
N_FEATURES = 4 * N_STATS + 3  # max, min, mean, var, then 3 query-level
MAX_EDGES = 255               # a bin is a uint8 count of edges below
MAX_SMEM = 227 * 1024         # one block's shared memory, opted in


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


def _round32(v: float) -> float:
    """A float64 constant rounded to float32, as the compiler reads it."""
    return struct.unpack("f", struct.pack("f", v))[0]


# Cephes-style exp: range reduction by n·ln 2 in two parts, then a
# polynomial for e^r on (-ln 2 / 2, ln 2 / 2)
_EXP_LO, _EXP_HI = _round32(-87.8), _round32(88.8)
_LOG2E = _round32(1.44269504088896341)
_EXP_C1, _EXP_C2 = _round32(0.693359375), _round32(-2.12194440e-4)
_EXP_P = [_round32(v) for v in (1.9875691500e-4, 1.3981999507e-3,
                                8.3334519073e-3, 4.1665795894e-2,
                                1.6666665459e-1, 5.0000001201e-1)]
# rational tanh, exact ±1 at the clamp; x itself below _TANH_SMALL
_TANH_CLAMP = _round32(7.99881172180175781)
_TANH_SMALL = _round32(0.0004)
_TANH_NUM = [_round32(v) for v in (
    -2.76076847742355e-16, 2.00018790482477e-13, -8.60467152213735e-11,
    5.12229709037114e-08, 1.48572235717979e-05, 6.37261928875436e-04,
    4.89352455891786e-03)]
_TANH_DEN = [_round32(v) for v in (
    1.19825839466702e-06, 1.18534705686654e-04, 2.26843463243900e-03,
    4.89352518554385e-03)]


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 fused multiply-add: the float64 product of two float32
    values is exact, so one rounding of product + addend to float32."""
    return (a.double() * torch.as_tensor(b, dtype=torch.float64)
            + torch.as_tensor(c, dtype=torch.float64)).float()


def xla_log(v: torch.Tensor) -> torch.Tensor:
    """float32 ``log`` as the reference's compiled program evaluates it
    (Cephes-style range reduction and polynomial, fused multiply-adds where
    the compiled program fuses them), bit for bit: 0 → -inf, a negative
    value → nan, inf → inf."""
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


def xla_log1p(x: torch.Tensor) -> torch.Tensor:
    """float32 ``log1p`` as the reference's compiled program evaluates it,
    bit for bit: ``xla_log(x + 1)``, and a rational approximation where
    |x| is small."""
    x = x.float()
    big = xla_log(x + 1.0)
    num = torch.full_like(x, _L1P_NUM[0])
    for c in _L1P_NUM[1:]:
        num = _fma(num, x, c)
    den = torch.ones_like(x)
    for c in _L1P_DEN:
        den = _fma(den, x, c)
    x2 = x * x
    small = x + _fma(x2, -0.5, (x * x2) * (num / den))
    return torch.where(x.abs() < _L1P_SMALL, small, big)


def _flush(v: torch.Tensor) -> torch.Tensor:
    """A subnormal result flushed to +0, as the compiled program's
    flush-to-zero mode does."""
    return torch.where(v.abs() < _MIN_NORMAL, 0.0, v)


def xla_exp(x: torch.Tensor) -> torch.Tensor:
    """float32 ``exp`` as the reference's compiled program evaluates it, bit
    for bit: the input clamped to [-87.8, 88.8], n = floor(x·log2 e + 0.5)
    clamped to [-127, 127], r = x - n·ln 2 (two fused steps), a degree-5
    polynomial for e^r, times 2^n built from its exponent bits; subnormal
    results flushed to 0, nan through."""
    x = x.float()
    c = torch.clamp(x, _EXP_LO, _EXP_HI)
    n = torch.clamp(torch.floor(_fma(c, _LOG2E, 0.5)), -127.0, 127.0)
    r = _fma(n, -_EXP_C2, _fma(n, -_EXP_C1, c))
    z = _fma(r, _EXP_P[0], _EXP_P[1])
    for p in _EXP_P[2:]:
        z = _fma(z, r, p)
    z = _fma(z, r * r, r) + 1.0
    pow2 = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    return _flush(z * pow2)


def _xla_tanh(x: torch.Tensor) -> torch.Tensor:
    """float32 ``tanh`` of the compiled program: a rational function of the
    clamped input in fused steps, x itself where |x| < 0.0004."""
    xc = torch.clamp(x, -_TANH_CLAMP, _TANH_CLAMP)
    x2 = xc * xc
    num = torch.full_like(x, _TANH_NUM[0])
    for c in _TANH_NUM[1:]:
        num = _fma(x2, num, c)
    den = torch.full_like(x, _TANH_DEN[0])
    for c in _TANH_DEN[1:]:
        den = _fma(x2, den, c)
    return torch.where(x.abs() < _TANH_SMALL, x, (xc * num) / den)


def xla_expm1(x: torch.Tensor) -> torch.Tensor:
    """float32 ``expm1`` as the reference's compiled program evaluates it,
    bit for bit: ``xla_exp(x) - 1`` where |x| > 0.5, else
    tanh(x/2)·(exp(x) + 1); x itself where x/2 flushes to 0 (±0 and
    |x| < 2^-125).  Neither branch is the platform's ``expm1`` (which
    differs on about 14 % of [-2, 13])."""
    x = x.float()
    half = _flush(x * 0.5)
    e = xla_exp(x)
    small = _xla_tanh(half) * (e + 1.0)
    out = torch.where(x.abs() > 0.5, e - 1.0, small)
    return torch.where(half == 0, x, out)


# ---------------------------------------------------------------------------
# the 147 features
# ---------------------------------------------------------------------------

def _sum_terms(x: torch.Tensor) -> torch.Tensor:
    """Sum over the query-term axis (dim 1), left to right."""
    s = x[:, 0]
    for l in range(1, x.shape[1]):
        s = s + x[:, l]
    return s


def stage0_features_plain(term_stats: torch.Tensor, term_df: torch.Tensor,
                          query_terms: torch.Tensor, query_mask: torch.Tensor
                          ) -> torch.Tensor:
    """Plain PyTorch version: ``extract``'s float32 steps (module
    docstring of ``core.features``); (Q, 147) float32 on the inputs'
    device.  Where +0.0 ties -0.0 in a max or a min, the reference's rule
    (``_zero_ties``)."""
    t = query_terms.long()
    qm = query_mask.float()
    stats = term_stats[t].float()                        # (Q, L, 36)
    m = qm[:, :, None]
    n_terms = torch.clamp(_sum_terms(qm), min=1.0)       # (Q,)

    mx, mn = _zero_ties(stats, m > 0)
    mean = _sum_terms(stats * m) / n_terms[:, None]
    d = stats - mean[:, None, :]
    var = _sum_terms(d * d * m) / n_terms[:, None]

    df = term_df[t].float()                              # (Q, L)
    sum_df = _sum_terms(df * qm)
    min_df = _zero_ties(df, qm > 0)[1]
    qlevel = torch.stack([n_terms, xla_log1p(sum_df), xla_log1p(min_df)],
                         dim=1)
    return torch.cat([mx, mn, mean, var, qlevel], dim=1).float()


def _zero_ties(v: torch.Tensor, live: torch.Tensor):
    """Max and min over dim 1 of ``v`` where ``live`` (±1e30 elsewhere), as
    the reference's reduces give them: NaN wins, and where +0.0 ties -0.0
    the max is +0.0 and the min -0.0 whatever their order (torch's amax and
    amin keep whichever their loop meets first)."""
    big = 1e30
    mx = torch.where(live, v, -big).amax(dim=1)
    mn = torch.where(live, v, big).amin(dim=1)
    zero = live & (v == 0)
    neg = torch.signbit(v)
    mx = torch.where((mx == 0) & (zero & ~neg).any(dim=1), 0.0, mx)
    mn = torch.where((mn == 0) & (zero & neg).any(dim=1), -0.0, mn)
    return mx, mn


def stage0_features(term_stats: torch.Tensor, term_df: torch.Tensor,
                    query_terms: torch.Tensor, query_mask: torch.Tensor
                    ) -> torch.Tensor:
    """The 147 Stage-0 features of a batch of queries, in one launch.

    Args:
      term_stats: (V, 36) float32 per-term statistics.
      term_df: (V,) document frequencies (int32, or any dtype ``.float()``
        takes).
      query_terms: (Q, L) term ids in [-V, V) (a negative id counts from
        the end, as torch's indexing takes it), L >= 1.
      query_mask: (Q, L) 1.0 for real terms.
    Returns:
      (Q, 147) float32: max, min, mean and variance of each statistic over
      the query's terms, then the term count, log1p of the summed df and
      of the least df.
    """
    kernels.on_cpu(term_stats, term_df, query_terms, query_mask)
    if term_df.dtype != torch.int32:
        term_df = term_df.float()
    return kernels.call("stage0_features", term_stats, term_df,
                        query_terms.to(torch.int32).contiguous(),
                        query_mask.float().contiguous())


def _features_checks(term_stats, term_df, query_terms, query_mask,
                     real=True):
    """What the features kernel refuses; without ``real`` (a fake's checks)
    not the device."""
    n_q, n_slots = query_terms.shape
    if (term_stats.dim() != 2 or term_stats.shape[1] != N_STATS
            or term_df.shape != term_stats.shape[:1]
            or query_mask.shape != (n_q, n_slots) or n_slots < 1):
        raise ValueError("stage0_features: term_stats must be (V, 36), "
                         "term_df (V,), query_terms and query_mask (Q, L) "
                         "with L >= 1")
    kernels.check_cuda_args(
        "stage0_features", dict(term_stats=term_stats, term_df=term_df,
                                query_terms=query_terms,
                                query_mask=query_mask),
        dict(term_stats=torch.float32, query_terms=torch.int32,
             query_mask=torch.float32,
             term_df=torch.int32 if term_df.dtype == torch.int32
             else torch.float32), real)


def _features_launch(term_stats: torch.Tensor, term_df: torch.Tensor,
                     query_terms: torch.Tensor, query_mask: torch.Tensor
                     ) -> torch.Tensor:
    """The features kernel's launch on CUDA tensors."""
    _features_checks(term_stats, term_df, query_terms, query_mask)
    n_q = query_terms.shape[0]
    out = torch.empty((n_q, N_FEATURES), dtype=torch.float32,
                      device=query_terms.device)
    if n_q:
        kernels.extension().stage0_features(term_stats, term_df,
                                            query_terms, query_mask, out)
        kernels.LAUNCHES["stage0_features"] += 1
    return out


def _features_fake(term_stats, term_df, query_terms, query_mask):
    _features_checks(term_stats, term_df, query_terms, query_mask, False)
    return torch.empty((query_terms.shape[0], N_FEATURES),
                       dtype=torch.float32, device=query_terms.device)


def _features_flops(term_stats, term_df, query_terms, query_mask, *args,
                    **kwargs):
    """Six operations per (query, slot, statistic) and 60 for the
    query-level features (chip_smoke.work_of)."""
    n_q, n_slots = query_terms
    return n_q * (216 * n_slots + 60)


def _features_shardings(*args):
    """The queries may split; the term table stays whole."""
    from torch.distributed.tensor import Replicate, Shard
    r, s = Replicate(), Shard(0)
    return [([r], [r, r, r, r]), ([s], [r, r, s, s])]


def _features_plain(term_stats, term_df, query_terms, query_mask):
    return stage0_features_plain(term_stats, term_df, query_terms,
                                 query_mask)


kernels.card_op("stage0_features", _features_launch, _features_plain,
                _features_fake, _features_flops, _features_shardings)


# ---------------------------------------------------------------------------
# the stacked forests
# ---------------------------------------------------------------------------

def stage0_forest_plain(x: torch.Tensor, bin_edges: torch.Tensor,
                        feat: torch.Tensor, thresh: torch.Tensor,
                        leaf: torch.Tensor, base: torch.Tensor, *,
                        depth: int, expm1: bool = False) -> torch.Tensor:
    """Plain PyTorch version: per-model edges take ``predict_stacked``'s
    sequence (uint8 bins a model, ``trees.forest_predict_stacked``, the base
    added after); shared edges the ISN step's (int32 bins once, each
    target's ``forest_leaves`` and ``_sum_trees``, its base added after).
    (M, Q) float32, through ``xla_expm1`` where ``expm1``."""
    x = x.float()
    if bin_edges.dim() == 3:
        xb = torch.stack([T.apply_bins(x, e) for e in bin_edges])
        preds = base[:, None] + T.forest_predict_stacked(
            T.Forest(feat, thresh, leaf), xb, depth)
    else:
        xb = (x[:, :, None] > bin_edges[None]).sum(dim=-1).to(torch.int32)
        preds = torch.stack([
            base[i] + T._sum_trees(T.forest_leaves(
                T.Forest(feat[i], thresh[i], leaf[i]), xb, depth))
            for i in range(base.shape[0])])
    return xla_expm1(preds) if expm1 else preds


def forest_smem_bytes(n_feat: int, edge_sets: int, n_models: int,
                      n_trees: int) -> int:
    """The forest kernel's shared memory a block: the query's features, its
    bins under each edge set, every tree's leaf value."""
    return 4 * (n_feat + edge_sets * n_feat + n_models * n_trees)


def stage0_forest(x: torch.Tensor, bin_edges: torch.Tensor,
                  feat: torch.Tensor, thresh: torch.Tensor,
                  leaf: torch.Tensor, base: torch.Tensor, *, depth: int,
                  expm1: bool = False) -> torch.Tensor:
    """The predictions of M stacked GBRTs for a batch, in one launch.

    Args:
      x: (Q, F) float32 raw features.
      bin_edges: (M, F, B - 1) float32 edges a model, or (F, B - 1) shared;
        B - 1 <= 255.
      feat, thresh: (M, T, D, W) int32 split feature (in [-F, F)) and bin
        of each node (D >= depth, W >= 2^(depth - 1)); a node goes right
        where its feature's bin is above its threshold.
      leaf: (M, T, N) float32 leaf values (N >= 2^depth).
      base: (M,) float32 base predictions.
      depth: levels walked.
      expm1: apply ``xla_expm1`` to the predictions (the ISN step's; the
        cascade takes them raw and expm1s on the host).
    Returns:
      (M, Q) float32: base + the trees' leaf values summed in
      ``trees._sum_trees``'s order, through ``xla_expm1`` where asked.
    """
    kernels.on_cpu(x, bin_edges, feat, thresh, leaf, base)
    return kernels.call("stage0_forest", x, bin_edges, feat, thresh, leaf,
                        base, depth, expm1)


def _forest_checks(x, bin_edges, feat, thresh, leaf, base, depth,
                   real=True):
    """What the forest kernel refuses; without ``real`` (a fake's checks)
    not the device."""
    n_q, n_feat = x.shape
    n_models, n_trees, levels, width = feat.shape
    edge_sets = n_models if bin_edges.dim() == 3 else 1
    if (bin_edges.dim() not in (2, 3) or bin_edges.shape[-2] != n_feat
            or (bin_edges.dim() == 3 and bin_edges.shape[0] != n_models)
            or thresh.shape != feat.shape
            or leaf.shape[:2] != (n_models, n_trees) or leaf.dim() != 3
            or base.shape != (n_models,)):
        raise ValueError("stage0_forest: x must be (Q, F), bin_edges (M, F, "
                         "E) or (F, E), feat and thresh (M, T, D, W), leaf "
                         "(M, T, N) and base (M,)")
    if (n_trees < 1 or not 0 <= depth <= levels
            or (depth and width < 2 ** (depth - 1))
            or leaf.shape[2] < 2 ** depth
            or bin_edges.shape[-1] > MAX_EDGES):
        raise ValueError(f"stage0_forest: no trees, depth {depth} does not "
                         f"fit the forest {tuple(feat.shape)} / "
                         f"{tuple(leaf.shape)}, or more than {MAX_EDGES} "
                         "edges")
    if forest_smem_bytes(n_feat, edge_sets, n_models, n_trees) > MAX_SMEM:
        raise ValueError(f"stage0_forest: {n_models} x {n_trees} trees over "
                         f"{n_feat} features exceed one block's shared "
                         "memory")
    kernels.check_cuda_args(
        "stage0_forest", dict(x=x, bin_edges=bin_edges, feat=feat,
                              thresh=thresh, leaf=leaf, base=base),
        dict(x=torch.float32, bin_edges=torch.float32, feat=torch.int32,
             thresh=torch.int32, leaf=torch.float32, base=torch.float32),
        real)


def _forest_launch(x: torch.Tensor, bin_edges: torch.Tensor,
                   feat: torch.Tensor, thresh: torch.Tensor,
                   leaf: torch.Tensor, base: torch.Tensor, depth: int,
                   expm1: bool) -> torch.Tensor:
    """The forest kernel's launch on CUDA tensors."""
    _forest_checks(x, bin_edges, feat, thresh, leaf, base, depth)
    n_q, n_models = x.shape[0], feat.shape[0]
    out = torch.empty((n_models, n_q), dtype=torch.float32, device=x.device)
    if n_q and n_models:
        kernels.extension().stage0_forest(x, bin_edges, feat, thresh, leaf,
                                          base, out, depth, expm1)
        kernels.LAUNCHES["stage0_forest"] += 1
    return out


def _forest_plain(x, bin_edges, feat, thresh, leaf, base, depth, expm1):
    return stage0_forest_plain(x, bin_edges, feat, thresh, leaf, base,
                               depth=depth, expm1=expm1)


def _forest_fake(x, bin_edges, feat, thresh, leaf, base, depth, expm1):
    _forest_checks(x, bin_edges, feat, thresh, leaf, base, depth, False)
    return torch.empty((feat.shape[0], x.shape[0]), dtype=torch.float32,
                       device=x.device)


def _forest_flops(x, bin_edges, feat, thresh, leaf, base, depth, expm1,
                  *args, **kwargs):
    """A compare per (query, edge) and two operations per (query, tree,
    level) (chip_smoke.work_of)."""
    edges = 1
    for n in bin_edges:
        edges *= n
    return x[0] * (edges + 2 * feat[0] * feat[1] * depth)


def _forest_shardings(*args):
    """The queries may split (the predictions' dim 1); the forests and
    edges stay whole."""
    from torch.distributed.tensor import Replicate, Shard
    r = Replicate()
    return [([r], [r] * 6 + [None, None]),
            ([Shard(1)], [Shard(0)] + [r] * 5 + [None, None])]


kernels.card_op("stage0_forest", _forest_launch, _forest_plain,
                _forest_fake, _forest_flops, _forest_shardings)
