#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py              # the full run, on the first GPU

It imports nothing of JAX and nothing of the JAX package ``repro``.  In
order, it

1. prints the card's name and power limit (``nvidia-smi``) and builds the
   seven kernels from the sources under ``src/repro_torch``;
2. builds the ``paper_200ms`` cascade at one shard of 196,608 docs (the
   per-chip shard of the paper's ISN deployment) on the card, with Stage-0
   and LTR GBRTs of the spec's shapes made here from a NumPy seed (bin
   edges from quantiles of a calibration query log, routing thresholds
   from the 60th/75th percentiles of the predictions, as ``fit`` sets
   them), and the same system on the CPU;
3. serves one batch of 32 queries on both (the CPU runs the kernels'
   plain versions) and requires ``topk``, ``final`` and the modeled
   ``latency`` to be equal, while recording every kernel call's inputs;
4. per-query phase: runs the per-query Stage-1 path
   (``saat_serve_laxmap`` at two budgets, ``daat_serve_laxmap`` at two
   θ) over the same 32 queries on both systems' shards, counted from 0 on
   the card, and requires the card to equal the CPU and the batched
   engines (DAAT scores of the batched engine within 1e-4), recording the
   largest call of each of its three kernels; prints the wall time per
   query on the card;
5. builds the ``hybrid_fusion`` cascade (the dense Stage-1 modality) from
   the same index, on the card and on the CPU, with the same kind of
   GBRTs and one two-tower model drawn from the spec's seed; where the
   preset's θ bands catch none of the calibration queries' top dense
   scores, sets them from quantiles of those scores; serves one batch of
   32 queries picked to reach the θ-skip and fallback branches on both
   and requires ``topk``, ``final``, ``latency`` and the per-query
   modality, θ-skip and fallback flags to be equal, recording the dense
   kernel's inputs;
6. kernel phase: runs each kernel on the recorded main-path inputs and on
   edge cases against its plain version on the card (the integer kernels,
   the dense top-k and the per-query float scoring exact, the batched
   float sums within 1e-5) and times the kernel, its plain version and,
   where one exists, the library call with CUDA events;
7. serve phases: for each preset, sets the launch counts to 0, serves 8
   batches of 32 queries on the card and reads the counts: for
   ``paper_200ms`` both routes must take queries, Stage-2 must re-rank and
   its three kernels must have launched; for ``hybrid_fusion`` lexical,
   dense-only and fused rows must each occur and the dense kernel must
   have launched; prints the wall time per batch and the device memory;
8. prints the total elapsed time, the ``kernels`` JSON line, then the card
   line, then the result.

Any failed check exits non-zero without the result line.  ``--n-docs``
and ``--batches`` shrink the run for a quick check; ``--profile`` adds a
``torch.profiler`` breakdown of one more served batch of each preset
(wall, device busy time, host time per cascade stage, busiest device
kernels).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device-memory rate
FP32_FLOPS_PER_S = 67e12      # H100 SXM fp32 rate outside the tensor cores
# H100 SXM int32 rate: the published 67 TFLOP/s fp32 is 132 SMs x 128 fp32
# lanes x 2 (an FMA) x 1.98 GHz; an SM issues 64 int32 operations a clock,
# a quarter of that.  The kernels' work is int32 compares.
INT32_OPS_PER_S = 67e12 / 4
SEED = 20171003
BATCH = 32
REPS = 20                     # timed runs of each kernel (median)
DEVICE = "cuda"

KERNELS = {
    "impact_accumulate_batched": dict(
        source="src/repro_torch/kernels/impact_accumulate/impact_accumulate.cu",
        replaces="src/repro/kernels/impact_accumulate/kernel.py:79"),
    "blockmax_score_batched": dict(
        source="src/repro_torch/kernels/blockmax_score/blockmax_score.cu",
        replaces="src/repro/kernels/blockmax_score/kernel.py:104"),
    "qd_feature_gather_lanes": dict(
        source="src/repro_torch/kernels/qd_feature_gather/qd_feature_gather.cu",
        replaces="src/repro/kernels/qd_feature_gather/kernel.py:67"),
    "dense_topk_tiles": dict(
        source="src/repro_torch/kernels/dense_topk/dense_topk.cu",
        replaces="src/repro/kernels/dense_topk/kernel.py:61"),
    "impact_accumulate_bucketed": dict(
        source="src/repro_torch/kernels/impact_accumulate/impact_accumulate.cu",
        replaces="src/repro/kernels/impact_accumulate/kernel.py:113"),
    "blockmax_score_bucketed": dict(
        source="src/repro_torch/kernels/blockmax_score/blockmax_score.cu",
        replaces="src/repro/kernels/blockmax_score/kernel.py:143"),
    "score_histogram": dict(
        source="src/repro_torch/kernels/score_histogram/score_histogram.cu",
        replaces="src/repro/kernels/score_histogram/kernel.py:47"),
}
# the kernels of the per-query Stage-1 path (saat/daat_serve_laxmap), and
# those of the two served cascades
LAXMAP_KERNELS = ("impact_accumulate_bucketed", "blockmax_score_bucketed",
                  "score_histogram")
SERVE_KERNELS = tuple(n for n in KERNELS if n not in LAXMAP_KERNELS)


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(f"[chip_smoke] {msg}", flush=True)


# ---------------------------------------------------------------------------
# models of the spec's shapes from a NumPy seed
# ---------------------------------------------------------------------------

def quantile_edges(x, n_bins):
    """(F, n_bins - 1) strictly increasing quantile bin edges."""
    import numpy as np
    qs = np.linspace(0.0, 100.0, n_bins + 1)[1:-1]
    edges = np.percentile(x, qs, axis=0).T.astype(np.float32)
    return np.maximum.accumulate(edges + 1e-9 * np.arange(edges.shape[1]),
                                 axis=1).astype(np.float32)


def random_gbrt(rng, x_calib, *, n_trees, depth, base, leaf_scale, device,
                tau=0.5, loss="quantile"):
    import numpy as np
    import torch
    from repro_torch.core.gbrt import GBRTModel, GBRTParams
    from repro_torch.core.trees import Forest
    params = GBRTParams(n_trees=n_trees, depth=depth, loss=loss, tau=tau)
    n_feat = x_calib.shape[1]
    width = 2 ** (depth - 1)
    feat = rng.randint(0, n_feat, (n_trees, depth, width)).astype(np.int32)
    thresh = rng.randint(0, params.n_bins - 1,
                         (n_trees, depth, width)).astype(np.int32)
    leaf = (rng.randn(n_trees, 2 ** depth) * leaf_scale).astype(np.float32)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return GBRTModel(forest=Forest(dev(feat), dev(thresh), dev(leaf)),
                     base=torch.tensor(base, dtype=torch.float32,
                                       device=device),
                     bin_edges=dev(quantile_edges(x_calib, params.n_bins)),
                     params=params)


def make_models(spec, index, corpus, device, seed):
    """Stage-0 (k, rho, t) and LTR GBRTs of the spec's shapes, and the spec
    with t_k/t_time set from the predictions as ``fit`` sets them."""
    import numpy as np
    import torch
    from repro_torch.core import features as F
    from repro_torch.core import gbrt
    from repro_torch.index.corpus import build_queries
    from repro_torch.isn.backend import query_lane_budget
    from repro_torch.ltr.ranker import LTRModel, qd_features_batched
    from repro_torch.ltr.ranker import stage2_arrays

    rng = np.random.RandomState(seed)
    calib = build_queries(corpus, 256, stop_k=spec.index.stop_k,
                          seed=seed % 10_000)
    term_stats = torch.from_numpy(index.term_stats).to(device)
    df = torch.from_numpy(index.df).to(device)
    x = F.extract(term_stats, df, torch.from_numpy(calib.terms).to(device),
                  torch.from_numpy(calib.mask).to(device))
    x_np = x.cpu().numpy()
    s0 = spec.stage0
    models = {}
    # bases put the median prediction near k=500, rho=50k postings and
    # t=60 modeled units, so both routes take traffic
    for name, base, tau in (("k", 500.0, s0.tau_k), ("rho", 5e4, s0.tau_rho),
                            ("t", 60.0, s0.tau_t)):
        models[name] = random_gbrt(rng, x_np, n_trees=s0.n_trees,
                                   depth=s0.depth,
                                   base=float(np.log1p(base)),
                                   leaf_scale=0.05, device=device, tau=tau)

    # LTR: edges from the features of calibration (query, doc) pairs
    s2 = stage2_arrays(index, corpus, device)
    cand = rng.randint(0, index.n_docs, (64, 64)).astype(np.int32)
    qcap = query_lane_budget(index.df, calib.terms[:64], calib.mask[:64])
    lf = qd_features_batched(
        s2, torch.from_numpy(calib.terms[:64]).to(device),
        torch.from_numpy(calib.mask[:64]).to(device),
        torch.from_numpy(calib.topic[:64]).to(device),
        torch.from_numpy(cand).to(device), qcap=qcap)
    ltr = LTRModel(random_gbrt(rng, lf.reshape(-1, 8).cpu().numpy(),
                               n_trees=spec.stage2.ltr_trees, depth=4,
                               base=0.1, leaf_scale=0.02, device=device,
                               loss="l2"))

    # routing thresholds from the predictions' own distribution
    pk = np.expm1(gbrt.predict(models["k"], x).cpu().numpy())
    pt = np.expm1(gbrt.predict(models["t"], x).cpu().numpy())
    t_k = float(np.percentile(pk, 60))
    t_time = float(min(spec.routing.budget * 0.75, np.percentile(pt, 75)))
    spec = dataclasses.replace(spec, routing=dataclasses.replace(
        spec.routing, t_k=t_k, t_time=t_time))
    return spec, models, ltr


def to_device(models, ltr, device):
    from repro_torch.core.gbrt import GBRTModel
    from repro_torch.core.trees import Forest
    from repro_torch.ltr.ranker import LTRModel

    def move(m):
        return GBRTModel(Forest(*(t.to(device) for t in m.forest)),
                         m.base.to(device), m.bin_edges.to(device), m.params)
    return {n: move(m) for n, m in models.items()}, LTRModel(move(ltr.model))


# ---------------------------------------------------------------------------
# kernel phase helpers
# ---------------------------------------------------------------------------

def kernel_modules():
    """The ops module of each kernel wrapper, by kernel name."""
    from repro_torch.kernels.blockmax_score import ops as bm
    from repro_torch.kernels.dense_topk import ops as dt
    from repro_torch.kernels.impact_accumulate import ops as ia
    from repro_torch.kernels.qd_feature_gather import ops as qd
    from repro_torch.kernels.score_histogram import ops as sh
    return {"impact_accumulate_batched": ia, "blockmax_score_batched": bm,
            "qd_feature_gather_lanes": qd, "dense_topk_tiles": dt,
            "impact_accumulate_bucketed": ia, "blockmax_score_bucketed": bm,
            "score_histogram": sh}


class Recorder:
    """Records the arguments of every call of the named kernel wrappers (the
    main path's real inputs) while passing the call through; with
    ``largest``, only the call that moves the most bytes is kept."""

    def __init__(self, names=SERVE_KERNELS, largest=False):
        mods = kernel_modules()
        self.sites = {name: mods[name] for name in names}
        self.calls = {name: [] for name in self.sites}
        self.largest = largest
        self.orig = {}

    def __enter__(self):
        for name, mod in self.sites.items():
            fn = getattr(mod, name)
            self.orig[name] = fn

            def wrapped(*args, _fn=fn, _name=name, **kw):
                calls = self.calls[_name]
                calls.append((args, kw))
                if self.largest and len(calls) > 1:
                    calls[:] = [max(calls,
                                    key=lambda c: work_of(_name, *c)[0])]
                return _fn(*args, **kw)
            setattr(mod, name, wrapped)
        return self

    def __exit__(self, *exc):
        for name, mod in self.sites.items():
            setattr(mod, name, self.orig[name])


def cuda_ms(fn, reps):
    """Median milliseconds of ``fn()`` over ``reps`` runs, each timed with
    CUDA events after a synchronize (one warm-up run first)."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def work_of(name, args, kw):
    """(bytes, ops, ops per second) the call must move and do on these
    inputs.  Lexical and Stage-2 kernels: the live lanes it needs read
    once, flags and query terms read once, the output written once; one
    int32 compare per (query, live lane it scores, query term) — per (live
    lane, candidate) for the Stage-2 gather.  Dense top-k: the embeddings
    and queries read once, (Q, k) scores and ids written once; two fp32
    operations (one FMA) per (query, doc, dimension).  Per-query bucketed
    kernels: the live lanes the function needs (doc and value, 8 B; for
    kernel 5 those of the surviving tiles and the residue), the flags and
    offsets and the cut read once, the tiles written once; for kernel 4 one
    int32 compare with the cut and one add per live lane, for kernel 5 one
    fp32 add per lane.  Histogram: the scores read once, the bins written
    once, one int32 increment per score."""
    import torch
    if name == "impact_accumulate_bucketed":
        docs_b, imps_b, lstar = args
        tile_d = kw["tile_d"]
        live = int(((docs_b >= 0) & (docs_b < tile_d)).sum())
        return (8 * live + 4 + 4 * docs_b.shape[0] * tile_d, 2 * live,
                INT32_OPS_PER_S)
    if name == "blockmax_score_bucketed":
        lanes = bucketed_score_lanes(*args)
        n_tiles, tile_d = args[0].shape[0], kw["tile_d"]
        return (8 * lanes + 4 * (2 * n_tiles + 1) + 4 * n_tiles * tile_d,
                lanes, FP32_FLOPS_PER_S)
    if name == "score_histogram":
        n = args[0].shape[0]
        return 4 * n + 4 * kw.get("n_bins", 2048), n, INT32_OPS_PER_S
    if name == "dense_topk_tiles":
        q_emb, doc_emb, k = args
        (q, d), n = q_emb.shape, doc_emb.shape[0]
        return (4 * (n * d + q * d) + 12 * q * k, 2 * q * n * d,
                FP32_FLOPS_PER_S)
    if name == "impact_accumulate_batched":
        docs, terms, imps, qterms, lstar = args
        q, n_terms = qterms.shape
        live = int((docs >= 0).sum())
        tile_d = kw["tile_d"]
        out = q * docs.shape[0] * tile_d * 4
        return (12 * live + 4 * qterms.numel() + 4 * q + out,
                q * live * n_terms, INT32_OPS_PER_S)
    if name == "blockmax_score_batched":
        docs, terms, scores, qterms, sb, st = args
        q, n_terms = qterms.shape
        per_tile = (docs >= 0).sum(dim=1).to(torch.int64)      # (n_tiles,)
        # the mirror's lanes of every tile some query needs, read once
        needed = int(per_tile[(st > 0).any(dim=0)].sum())
        scored = int(((st > 0).to(torch.int64) * per_tile[None]).sum())
        out = q * docs.shape[0] * kw["tile_d"] * 4
        return (12 * needed + 4 * (sb.numel() + st.numel() + qterms.numel())
                + out, scored * n_terms, INT32_OPS_PER_S)
    lane_docs, lane_scores, cand = args
    live = int((lane_docs >= 0).sum())
    return (8 * live + 4 * cand.numel() + 12 * cand.numel(),
            live * cand.shape[1], INT32_OPS_PER_S)


def compare(name, got, want, tol=1e-5):
    """Max abs error; raises if the kernel disagrees with its plain version
    beyond the stated tolerance (integers exact, floats within ``tol``)."""
    import torch
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0.0
    for g, w in zip(got, want):
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"{name}: kernel output {tuple(g.shape)} {g.dtype} vs plain "
              f"{tuple(w.shape)} {w.dtype}")
        if g.dtype.is_floating_point:
            e = float((g - w).abs().max()) if g.numel() else 0.0
            check(e <= tol, f"{name}: max abs error {e} > {tol}")
        else:
            e = float((g.long() - w.long()).abs().max()) if g.numel() else 0.0
            check(e == 0, f"{name}: integer outputs differ by {e}")
        err = max(err, e)
    return err


def edge_calls(device):
    """Small seeded inputs with the edge cases the main path rarely shows:
    -1 query slots, a repeated query term, an empty tile, a ghost tail
    tile, tiles whose survive_t is 0 under set block flags, dead lanes
    and -1 candidates; for the dense top-k, exact ties (duplicated doc
    rows), doc counts that are not a multiple of the kernel's chunk,
    k in {1, 33, 128} and a single query.  Lists of (args, kwargs)."""
    import numpy as np
    import torch
    from repro_torch.dense import embed_queries, synthetic_embeddings
    from repro_torch.index.builder import pack_tiles
    rng = np.random.RandomState(SEED)
    n_docs, vocab, tile_d, block = 1000, 40, 128, 64
    hit = rng.rand(vocab, n_docs) < 0.08
    hit[:, 256:384] = False
    term, doc = np.nonzero(hit)
    scores = (rng.rand(len(doc)) * 8).astype(np.float32)
    imps = rng.randint(1, 256, len(doc)).astype(np.int32)
    docs_b, terms_b, (scores_b, imps_b), _ = pack_tiles(
        doc, term, [(scores, 0.0, np.float32), (imps, 0, np.int32)], n_docs,
        tile_d)
    qterms = np.asarray([[3, 7, 11, -1, -1], [5, 5, 9, -1, -1],
                         [-1, -1, -1, -1, -1], [17, -1, 17, 30, 31]],
                        np.int32)
    q, n_tiles = len(qterms), docs_b.shape[0]
    sb = (rng.rand(q, n_tiles, tile_d // block) < 0.7).astype(np.int32)
    st = (rng.rand(q, n_tiles) < 0.6).astype(np.int32)
    lanes = rng.randint(0, 300, (q, 700)).astype(np.int32)
    lanes[rng.rand(q, 700) < 0.2] = -1
    lane_sc = np.where(lanes >= 0, rng.rand(q, 700) * 5, 0).astype(np.float32)
    cand = rng.randint(0, 300, (q, 50)).astype(np.int32)
    cand[rng.rand(q, 50) < 0.15] = -1

    doc_emb, table = synthetic_embeddings(3000, 512, d=32, seed=SEED % 997)
    q_emb = embed_queries(table, rng.randint(0, 512, (24, 6)),
                          np.ones((24, 6), np.float32))
    ties = np.concatenate([doc_emb[:700]] * 3)          # 2,100 docs, 3x ties

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return {
        "impact_accumulate_batched": [(
            (t(docs_b), t(terms_b), t(imps_b), t(qterms),
             t(np.asarray([0, 40, 0, 1], np.int32))), dict(tile_d=tile_d))],
        "blockmax_score_batched": [(
            (t(docs_b), t(terms_b), t(scores_b), t(qterms), t(sb), t(st)),
            dict(tile_d=tile_d, block_size=block))],
        "qd_feature_gather_lanes": [((t(lanes), t(lane_sc), t(cand)), {})],
        "dense_topk_tiles": [
            ((t(q_emb), t(ties), 128), {}),
            ((t(q_emb), t(doc_emb[:1025]), 33), {}),
            ((t(q_emb), t(doc_emb), 1), {}),
            ((t(q_emb[:1]), t(doc_emb), 128), {}),
            ((t(q_emb[:5]), t(doc_emb[:2999]), 33), {}),
        ],
    }


def laxmap_edge_calls(device):
    """Edge inputs of the per-query kernels, driven through their flat
    wrappers on the card, each flat result held to its plain counterpart:
    for kernel 4 a ``cap`` below the densest tile (the overflow residue),
    ``lstar`` > 0, ``n_docs`` not a multiple of ``tile_d`` and all lanes
    dead, against the direct integer scatter (exact); for kernel 5 the
    residue, every block pruned and a ragged ``n_docs``, against the same
    wrapper on the CPU (bit-equal); for kernel 7 N not a multiple of 512
    with scores >= n_bins, k above the count of non-negative scores and all
    scores negative, ``histogram_topk`` against its selection over the
    plain histogram (exact).  Returns the bucketed kernel calls the
    wrappers made (lists of (args, kwargs)) and the largest error of the
    flat checks, per kernel."""
    import numpy as np
    import torch
    from repro_torch.kernels.blockmax_score import ops as bm
    from repro_torch.kernels.impact_accumulate import ops as ia
    from repro_torch.kernels.score_histogram import ops as sh
    rng = np.random.RandomState(SEED + 1)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def flat_docs(n_docs, p, dead):
        docs = rng.randint(0, n_docs, p).astype(np.int32)
        docs[rng.rand(p) < dead] = -1
        return docs

    errs = dict.fromkeys(LAXMAP_KERNELS, 0.0)
    with Recorder(LAXMAP_KERNELS) as rec:
        name = "impact_accumulate_bucketed"
        for n_docs, p, cap, lstar, dead in ((1000, 5000, 128, 0, 0.15),
                                            (1000, 5000, 128, 128, 0.15),
                                            (300, 700, 64, 0, 1.0)):
            docs = t(flat_docs(n_docs, p, dead))
            imps = t(rng.randint(1, 256, p).astype(np.int32))
            got = ia.impact_accumulate(docs, imps, lstar, n_docs=n_docs,
                                       cap=cap)
            want = ia.impact_accumulate_ref(docs, imps, lstar, n_docs)
            errs[name] = max(errs[name], compare(name + " (flat)", got, want))
        name = "blockmax_score_bucketed"
        for n_docs, p, frac, cap in ((1000, 6000, 0.8, 256),
                                     (1000, 6000, 0.0, 256),
                                     (700, 3000, 0.5, 1024)):
            docs = flat_docs(n_docs, p, 0.1)
            scores = (rng.rand(p) * 8).astype(np.float32)
            survive = rng.rand(-(-n_docs // 64)) < frac
            kw = dict(n_docs=n_docs, block_size=64, cap=cap)
            got = bm.blockmax_score(t(docs), t(scores), t(survive), **kw)
            want = bm.blockmax_score(
                *(torch.from_numpy(a) for a in (docs, scores, survive)), **kw)
            errs[name] = max(errs[name], compare(
                name + " (flat)", got, want.to(device), tol=0.0))
        name = "score_histogram"
        for n, lo, hi, neg, k in ((1000, 0, 3000, 0.1, 100),
                                  (777, 0, 2500, 0.99, 64),
                                  (2048, -3, 0, 0.0, 5)):
            s = rng.randint(lo, hi, n).astype(np.int32)
            s[rng.rand(n) < neg] = -1
            s = t(s)
            got = sh.histogram_topk(s, k=k)
            want = sh.topk_from_histogram(s, sh.score_histogram_ref(s, 2048),
                                          k, 2048)
            errs[name] = max(errs[name], compare("histogram_topk", got, want))
    # the CPU run of the kernel-5 wrapper called its plain version
    return ({n: [c for c in calls if c[0][0].is_cuda]
             for n, calls in rec.calls.items()}, errs)


def bucketed_score_lanes(docs_b, scores_b, survive_t, run_docs, run_scores,
                         run_start):
    """Lanes kernel 5 must add: the live bucket lanes of the surviving tiles
    and every tile's overflow residue."""
    cap = docs_b.shape[1]
    bucket = int(((docs_b >= 0) & (survive_t[:, None] != 0)).sum())
    res = (run_start[1:] - run_start[:-1] - cap).clamp(min=0)
    return bucket + int(res.sum())


def library_calls():
    """Per kernel, a maker of the one PyTorch call that computes the same
    function on a call's inputs (its operands prepared outside the timed
    call), timed as the library yardstick and used nowhere in the port."""
    import torch
    from repro_torch.kernels.blockmax_score import ops as bm

    def dense(args, kw):
        # the nearest composition: one fp32 product, one stable sort
        q_emb, doc_emb, k = args
        return lambda: torch.sort(q_emb @ doc_emb.T, dim=1, descending=True,
                                  stable=True)

    def scatter(idx, val, n):
        return lambda: torch.zeros(n, dtype=val.dtype,
                                   device=val.device).index_add_(0, idx, val)

    def impact(args, kw):
        # integer index_add_ over the live lanes that reach the cut
        docs_b, imps_b, lstar = args
        tile_d = kw["tile_d"]
        rows = torch.arange(docs_b.shape[0], device=docs_b.device)[:, None]
        live = (docs_b >= 0) & (docs_b < tile_d) & (imps_b >= lstar)
        idx = (rows * tile_d + docs_b)[live].long()
        return scatter(idx, imps_b[live], docs_b.shape[0] * tile_d)

    def score(args, kw):
        # fp32 index_add_ over the lanes kernel 5 adds; its float atomics
        # add in no fixed order, so the port never uses it
        docs_b, scores_b, survive_t, run_docs, run_scores, run_start = args
        tile_d = kw["tile_d"]
        n_tiles, cap = docs_b.shape
        rows = torch.arange(n_tiles, device=docs_b.device)[:, None]
        live = (docs_b >= 0) & (survive_t[:, None] != 0)
        j, tile_r = bm._residue_lanes(run_start, cap, run_docs.shape[0])
        idx = torch.cat([(rows * tile_d + docs_b)[live].long(),
                         tile_r * tile_d + run_docs[j].long()])
        val = torch.cat([scores_b[live], run_scores[j]])
        return scatter(idx, val, n_tiles * tile_d)

    def histogram(args, kw):
        (s,), n_bins = args, kw.get("n_bins", 2048)
        return lambda: torch.bincount(torch.clamp(s[s >= 0], max=n_bins - 1),
                                      minlength=n_bins)

    return {"dense_topk_tiles": dense, "impact_accumulate_bucketed": impact,
            "blockmax_score_bucketed": score, "score_histogram": histogram}


def kernel_phase(recorded, k_topk):
    """Every recorded main-path call, and the edge cases: kernel vs plain
    version on the card.  ``k_topk`` is the per-query path's depth, at
    which ``histogram_topk`` is also checked and timed on the recorded
    histogram call."""
    import torch
    from repro_torch.kernels.score_histogram import ops as sh
    mods = kernel_modules()
    plain = {"impact_accumulate_batched": "impact_accumulate_plain",
             "blockmax_score_batched": "blockmax_score_plain",
             "qd_feature_gather_lanes": "qd_feature_gather_plain",
             "dense_topk_tiles": "dense_topk_plain",
             "impact_accumulate_bucketed": "impact_accumulate_bucketed_plain",
             "blockmax_score_bucketed": "blockmax_score_bucketed_plain",
             "score_histogram": "score_histogram_ref"}
    plain = {name: getattr(mods[name], fn) for name, fn in plain.items()}
    kern = {name: getattr(mods[name], name) for name in KERNELS}
    library = library_calls()
    # the dense top-k is exact on the grid-quantized embeddings; kernel 5
    # adds each doc's lanes in the plain version's order
    tols = {"dense_topk_tiles": 0.0, "blockmax_score_bucketed": 0.0}
    rows = {}
    dev = recorded["qd_feature_gather_lanes"][0][0][0].device
    edges = edge_calls(dev)
    lax_edges, flat_errs = laxmap_edge_calls(dev)
    edges.update(lax_edges)
    for name in KERNELS:
        calls = recorded[name]
        check(calls, f"{name}: the main path never called it")
        err = flat_errs.get(name, 0.0)
        for args, kw in calls + edges[name]:
            got = kern[name](*args, **kw)
            want = plain[name](*args, **kw)
            torch.cuda.synchronize()
            err = max(err, compare(name, got, want, tols.get(name, 1e-5)))
        # time the largest call of the batch (the one with most work)
        args, kw = max(calls, key=lambda c: work_of(name, *c)[0])
        nbytes, ops, rate = work_of(name, args, kw)
        ms = cuda_ms(lambda: kern[name](*args, **kw), REPS)
        plain_ms = cuda_ms(lambda: plain[name](*args, **kw), REPS // 4)
        library_ms = (cuda_ms(library[name](args, kw), REPS)
                      if name in library else None)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / rate * 1e3
        rows[name] = dict(
            name=name, route="cuda", **KERNELS[name], launches=0,
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=library_ms)
        log(f"kernel {name}: {len(calls)} main-path calls and "
            f"{len(edges[name])} edge cases checked, max_abs_err={err}, "
            f"ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={library_ms} "
            f"bound_ms={rows[name]['bound_ms']:.4f} "
            f"({rows[name]['bound_by']}: {nbytes} B, {ops} ops)")
        if name == "score_histogram":
            (s,) = args
            got = sh.histogram_topk(s, k=k_topk)
            want = sh.topk_from_histogram(
                s, sh.score_histogram_ref(s, 2048), k_topk, 2048)
            rows[name]["max_abs_err"] = max(
                err, compare("histogram_topk", got, want))
            topk_ms = cuda_ms(lambda: sh.histogram_topk(s, k=k_topk), REPS)
            sort_ms = cuda_ms(lambda: torch.sort(
                s, descending=True, stable=True).indices[:k_topk], REPS)
            log(f"histogram_topk k={k_topk} over {s.shape[0]} scores: "
                f"{topk_ms:.4f} ms (histogram kernel + selection sort); "
                f"stable torch.sort top-k {sort_ms:.4f} ms")
    return rows


def profile_batch(system, terms, mask, topics):
    """One more served batch under ``torch.profiler``: wall time, device
    busy time (the union of the card's own kernel and copy intervals; the
    host-side aten ops that launched them are not counted again), host
    time per cascade stage, and the busiest device kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    stages = ("stage0", "_stage1_full", "stage2") + (
        ("_stage1_dense",) if system.dense is not None else ())
    for name in stages:
        def timed(*a, _fn=getattr(system, name), _name=name, **kw):
            with record_function(f"stage:{_name}"):
                return _fn(*a, **kw)
        setattr(system, name, timed)
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            system.serve(terms, mask, topics)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
    finally:
        for name in stages:
            delattr(system, name)

    def on_card(e):
        # the card's kernels and copies; the stage annotations are mirrored
        # onto the device timeline too, spanning whole stages
        return (e.device_type == DeviceType.CUDA
                and not e.key.startswith("stage:"))
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if on_card(e))
    check(spans, "profile: the profiler recorded no device activity")
    busy_us, last = 0.0, spans[0][0]
    for start, end in spans:
        busy_us += max(0.0, end - max(start, last))
        last = max(last, end)
    busy_ms = busy_us / 1e3
    log(f"profile: wall {wall_ms:.2f} ms (profiler on), device busy "
        f"{busy_ms:.3f} ms = {100 * busy_ms / wall_ms:.1f} % of wall, "
        f"idle {100 - 100 * busy_ms / wall_ms:.1f} % ({len(spans)} device "
        f"events)")
    events = prof.key_averages()
    for e in events:
        if e.key.startswith("stage:") and e.cpu_time_total > 0:
            log(f"profile: {e.key} host {e.cpu_time_total / 1e3:.2f} ms")
    device = [e for e in events if on_card(e)]
    for e in sorted(device, key=lambda e: e.device_time_total,
                    reverse=True)[:12]:
        log(f"profile: device {e.device_time_total / 1e3:8.3f} ms "
            f"x{e.count:<4d} {e.key[:70]}")


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def same_batch(label, a, b, dense=False):
    """Card (a) against CPU (b) results of one served batch."""
    import numpy as np
    check(np.array_equal(a.topk, b.topk), f"{label}: topk differs")
    check(np.array_equal(a.final, b.final), f"{label}: final differs")
    check(np.array_equal(a.latency, b.latency),
          f"{label}: modeled latency differs")
    if dense:
        for key in ("modality", "theta_skip", "fallback"):
            check(np.array_equal(a.dense[key], b.dense[key]),
                  f"{label}: {key} differs")


def calibrate_thetas(system, calib):
    """The ``hybrid_fusion`` θ bands: the preset's, unless a band catches
    none of the calibration queries' top-1 dense scores; then that band
    moves to a quantile of those scores (θ_high the 80th, θ_low the 30th
    percentile), as the preset's own comment describes.  Returns the
    spec."""
    import numpy as np
    ds = system.cascade_spec.dense
    _, sc = system.dense.serve(system.dense.embed(calib.terms, calib.mask),
                               system.k_serve)
    top = sc[:, 0].astype(np.float64)
    hi, lo = ds.theta_high, ds.theta_low
    if not (top >= hi).any():
        hi = float(np.percentile(top, 80))
    if not (top < lo).any():
        lo = float(np.percentile(top, 30))
    log(f"hybrid_fusion: calibration top-1 dense scores "
        f"p0/p30/p50/p80/p100 = "
        + "/".join(f"{v:.4f}" for v in np.percentile(top, [0, 30, 50, 80,
                                                           100]))
        + f"; theta_high {ds.theta_high} -> {hi}, theta_low "
        f"{ds.theta_low} -> {lo}")
    return dataclasses.replace(system.cascade_spec, dense=dataclasses.replace(
        ds, theta_high=hi, theta_low=min(lo, hi)))


def cross_check_rows(system, ql):
    """32 query rows for the hybrid_fusion cross-check that reach every
    dense branch: up to 4 dense-only rows below θ_low (the lexical
    fallback), up to 4 dense rows at or above θ_high (the Stage-2 skip),
    the rest in log order.  Stage-0 and the dense scan change no state of
    the system; the scheduler's route is decided when the batch is
    served."""
    import numpy as np
    from repro_torch.dense import M_DENSE, M_LEX
    ds = system.cascade_spec.dense
    pt = system.stage0(ql.terms, ql.mask)[2]
    modality = system._modality(pt)
    d_rows = np.flatnonzero(modality != M_LEX)
    _, sc = system.dense.serve(
        system.dense.embed(ql.terms[d_rows], ql.mask[d_rows]),
        system.k_serve)
    top = sc[:, 0]
    low = d_rows[(modality[d_rows] == M_DENSE) & (top < ds.theta_low)][:4]
    high = d_rows[top >= ds.theta_high][:4]
    rows = list(dict.fromkeys([*low, *high, *range(len(ql.terms))]))
    return np.asarray(rows[:BATCH])


def laxmap_phase(gpu, cpu, ql, spec):
    """The per-query Stage-1 path (``saat_serve_laxmap`` at ρ = 8,192 and
    ρ_max with cap = ρ, ``daat_serve_laxmap`` at θ = 1.0 and 1.2 with cap =
    max_df and bcap = max_blocks_per_term, k = k_serve) over the 32
    cross-check queries on the systems' shards.  A first pass on the card
    records each per-query kernel's largest call; then, counted from 0, a
    timed pass on the card, the same on the CPU shard (plain versions) and
    the card's batched engines on the same queries.  Requires SAAT equal on
    the card and the CPU (ids, scores, work) and to the batched engine;
    DAAT ids, work, blocks and scores bit-equal on the card and the CPU,
    and ids, work and blocks equal to the batched engine with scores within
    1e-4 (it sums phase 1 and the rest apart).  Returns (launches, the
    recorded calls)."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.isn.daat import daat_serve, daat_serve_laxmap
    from repro_torch.isn.saat import saat_serve, saat_serve_laxmap
    sp = gpu.shard_specs[0]
    k = spec.stage2.k_serve
    saat_kw = dict(n_docs=sp.n_docs, k=k)
    daat_kw = dict(n_docs=sp.n_docs, n_blocks=sp.n_blocks,
                   block_size=sp.block_size, k=k,
                   bcap=sp.max_blocks_per_term)
    runs = [("saat", rho) for rho in (8192, spec.routing.rho_max)] + [
        ("daat", theta) for theta in (1.0, 1.2)]

    def laxmap(shard, engine, x, walls=None):
        dev = shard.offsets.device
        terms = torch.from_numpy(ql.terms[:BATCH]).to(dev)
        mask = torch.from_numpy(ql.mask[:BATCH]).to(dev)
        full = torch.full((BATCH,), x, device=dev)
        t = time.perf_counter()
        if engine == "saat":
            res = saat_serve_laxmap(shard, terms, mask, full, cap=x,
                                    **saat_kw)
        else:
            res = daat_serve_laxmap(shard, terms, mask, full, cap=sp.max_df,
                                    **daat_kw)
        if walls is not None:
            torch.cuda.synchronize()
            walls[(engine, x)] = time.perf_counter() - t
        return [np.asarray(f.cpu()) for f in res]

    with Recorder(LAXMAP_KERNELS, largest=True) as rec:
        for engine, x in runs:
            laxmap(gpu.shards[0], engine, x)
        torch.cuda.synchronize()
    walls = {}
    kernels.reset_launches()
    card = {run: laxmap(gpu.shards[0], *run, walls) for run in runs}
    launches = dict(kernels.LAUNCHES)
    t = time.perf_counter()
    host = {run: laxmap(cpu.shards[0], *run) for run in runs}
    t_cpu = time.perf_counter() - t
    dev = gpu.shards[0].offsets.device
    terms = torch.from_numpy(ql.terms[:BATCH]).to(dev)
    mask = torch.from_numpy(ql.mask[:BATCH]).to(dev)
    for engine, x in runs:
        label = f"laxmap {engine} {x}"
        a, b = card[(engine, x)], host[(engine, x)]
        for field, u, v in zip(("ids", "scores", "work", "blocks"), a, b):
            check(np.array_equal(u, v),
                  f"{label}: {field} differ on the card and the CPU")
        full = torch.full((BATCH,), x, device=dev)
        if engine == "saat":
            bat = saat_serve(gpu.shards[0], terms, mask, full, **saat_kw)
        else:
            bat = daat_serve(gpu.shards[0], terms, mask, full, **daat_kw)
        bat = [np.asarray(f.cpu()) for f in bat]
        for field, u, v in zip(("ids", "scores", "work", "blocks"), a, bat):
            if engine == "daat" and field == "scores":
                err = float(np.abs(u - v).max())
                check(err <= 1e-4, f"{label}: scores {err} from the batched "
                      "engine's")
            else:
                check(np.array_equal(u, v), f"{label}: {field} differ from "
                      "the batched engine's")
        extra = (f", blocks mean {a[3].mean():.1f}" if engine == "daat"
                 else "")
        log(f"{label}: card {1e3 * walls[(engine, x)] / BATCH:.3f} ms per "
            f"query ({BATCH} queries, k={k}); work mean {a[2].mean():.1f}"
            f"{extra}; equal on the card and the CPU and to the batched "
            f"engine")
    log(f"laxmap: CPU shard runs {t_cpu:.1f} s; launches {launches}")
    for name in LAXMAP_KERNELS:
        check(launches[name] > 0, f"laxmap: kernel {name} never launched")
    return launches, rec.calls


def serve_phase(system, ql, n_batches, n_docs, spec):
    """The counted main path: launch counts set to 0, ``n_batches``
    batches of 32 served on the card, the counts read.  Returns (launches,
    route counts, dense stat sums, walls, last result)."""
    import numpy as np
    import torch
    from repro_torch import kernels
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    routes = {"jass": 0, "bmw": 0, "reranked": 0}
    dense = {}
    for i in range(n_batches):
        sl = slice(i * BATCH, (i + 1) * BATCH)
        jass0, bmw0 = system.sched.stats["jass"], system.sched.stats["bmw"]
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = system.serve(ql.terms[sl], ql.mask[sl], ql.topic[sl])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        routes["jass"] += system.sched.stats["jass"] - jass0
        routes["bmw"] += system.sched.stats["bmw"] - bmw0
        routes["reranked"] += int((res.candidates_used > 0).sum())
        for key, n in res.stats.get("dense", {}).items():
            dense[key] = dense.get(key, 0) + n
        check(res.topk.shape == (BATCH, spec.stage2.k_serve)
              and res.final.shape == (BATCH, spec.stage2.t_final),
              f"{spec.name} serve: result shapes")
        check(np.isfinite(res.latency).all() and (res.topk >= 0).all()
              and (res.topk < n_docs).all(),
              f"{spec.name} serve: ids or latency invalid")
        check(float(res.latency.max()) <= system.worst_case_us() + 1e-9,
              f"{spec.name} serve: latency above the worst-case bound")
    launches = dict(kernels.LAUNCHES)
    log(f"{spec.name}: served {n_batches} x {BATCH} queries: {routes} "
        f"{dense}; launches {launches}")
    log(f"{spec.name}: wall s per batch: "
        + " ".join(f"{w:.4f}" for w in walls)
        + f" (median {statistics.median(walls):.4f})")
    log(f"{spec.name}: device memory: {torch.cuda.memory_allocated()} B in "
        f"use, {torch.cuda.max_memory_allocated()} B peak during serving; "
        f"modeled p99 {res.stats['p99']:.3f}, worst-case bound "
        f"{system.worst_case_us():.3f}")
    check(routes["reranked"] > 0, f"{spec.name} serve: Stage-2 re-ranked no "
          "query")
    return launches, routes, dense


def run(n_docs, n_batches, profile=False):
    import torch
    from repro_torch import kernels
    from repro_torch.configs.cascade_presets import get_preset
    from repro_torch.configs.two_tower_retrieval import REDUCED
    from repro_torch.index.builder import build_index
    from repro_torch.index.corpus import (CorpusParams, build_corpus,
                                          build_queries)
    from repro_torch.models.recsys import TwoTower
    from repro_torch.serving.system import build_system

    card = card_line()
    print(card, flush=True)
    dev = torch.device(DEVICE)

    t = time.perf_counter()
    kernels.extension()
    log(f"kernels built in {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    spec = get_preset("paper_200ms")
    corpus = build_corpus(CorpusParams(n_docs=n_docs))
    t_corpus = time.perf_counter() - t
    index = build_index(corpus, block_size=spec.index.block_size,
                        stop_k=spec.index.stop_k)
    log(f"corpus {n_docs} docs in {t_corpus:.1f} s, index "
        f"{index.n_postings} postings in "
        f"{time.perf_counter() - t - t_corpus:.1f} s")
    ql = build_queries(corpus, n_batches * BATCH, stop_k=spec.index.stop_k)

    spec, models, ltr = make_models(spec, index, corpus, dev, SEED)
    t = time.perf_counter()
    gpu = build_system(spec, index, corpus=corpus, models=models, ltr=ltr,
                       device=dev)
    torch.cuda.synchronize()
    log(f"system on {dev} built in {time.perf_counter() - t:.1f} s; "
        f"shard {gpu.shard_specs[0]}")
    cpu_models, cpu_ltr = to_device(models, ltr, "cpu")
    cpu = build_system(spec, index, corpus=corpus, models=cpu_models,
                       ltr=cpu_ltr, device="cpu")

    # cross-check: one batch through fresh systems on the card and the CPU;
    # the card's kernel calls are recorded for the kernel phase
    sl = slice(0, BATCH)
    with Recorder() as rec:
        t = time.perf_counter()
        a = gpu.serve(ql.terms[sl], ql.mask[sl], ql.topic[sl])
        torch.cuda.synchronize()
        t_first = time.perf_counter() - t
    t = time.perf_counter()
    b = cpu.serve(ql.terms[sl], ql.mask[sl], ql.topic[sl])
    log(f"cross-check batch: card {t_first:.2f} s (first call), CPU "
        f"{time.perf_counter() - t:.2f} s")
    same_batch("paper_200ms cross-check", a, b)
    log("cross-check: topk, final and latency equal on the card and CPU")
    recorded = dict(rec.calls)

    # the per-query Stage-1 path on the same shard, card and CPU
    lax_launches, lax_calls = laxmap_phase(gpu, cpu, ql, spec)
    recorded.update(lax_calls)
    del cpu

    # the dense modality: hybrid_fusion from the same index; one tower,
    # drawn on the host, embeds the collection for both systems
    t = time.perf_counter()
    spec_h, models_h, ltr_h = make_models(get_preset("hybrid_fusion"), index,
                                          corpus, dev, SEED)
    tower = TwoTower.init(REDUCED, spec_h.dense.seed, device="cpu")
    gpu_h = build_system(spec_h, index, corpus=corpus, models=models_h,
                         ltr=ltr_h, tower=tower, device=dev)
    calib = build_queries(corpus, 256, stop_k=spec_h.index.stop_k,
                          seed=SEED % 10_000)
    spec_h = calibrate_thetas(gpu_h, calib)
    gpu_h.cascade_spec = spec_h
    torch.cuda.synchronize()
    log(f"hybrid_fusion on {dev} built in {time.perf_counter() - t:.1f} s: "
        f"{gpu_h.dense.n_shards} shard of {gpu_h.dense.shard_docs[0]} docs x "
        f"d={gpu_h.dense.d}, {gpu_h.dense.n_tiles(0)} tiles of "
        f"{gpu_h.dense.tile_d}")
    cpu_models, cpu_ltr = to_device(models_h, ltr_h, "cpu")
    cpu_h = build_system(spec_h, index, corpus=corpus, models=cpu_models,
                         ltr=cpu_ltr, tower=tower, device="cpu")
    rows_h = cross_check_rows(gpu_h, ql)
    with Recorder() as rec_h:
        a = gpu_h.serve(ql.terms[rows_h], ql.mask[rows_h], ql.topic[rows_h])
        torch.cuda.synchronize()
    b = cpu_h.serve(ql.terms[rows_h], ql.mask[rows_h], ql.topic[rows_h])
    same_batch("hybrid_fusion cross-check", a, b, dense=True)
    log(f"hybrid_fusion cross-check: topk, final, latency, modality, "
        f"theta_skip and fallback equal on the card and CPU "
        f"({a.stats['dense']})")
    del cpu_h
    recorded["dense_topk_tiles"] = rec_h.calls["dense_topk_tiles"]

    rows = kernel_phase(recorded, spec.stage2.k_serve)
    for name in LAXMAP_KERNELS:
        rows[name]["launches"] = lax_launches[name]

    # serve phases: each preset's main path, counted on its own
    launches, routes, _ = serve_phase(gpu, ql, n_batches, n_docs, spec)
    check(routes["jass"] > 0 and routes["bmw"] > 0,
          "paper_200ms serve: both routes must take queries")
    for name in ("impact_accumulate_batched", "blockmax_score_batched",
                 "qd_feature_gather_lanes"):
        check(launches[name] > 0, f"serve: kernel {name} never launched")
        rows[name]["launches"] = launches[name]
    launches, _, dense = serve_phase(gpu_h, ql, n_batches, n_docs, spec_h)
    for key in ("lexical", "dense_only", "fused"):
        check(dense[key] > 0, f"hybrid_fusion serve: no {key} rows")
    log(f"hybrid_fusion: theta_skips={dense['theta_skips']} "
        f"fallbacks={dense['fallbacks']}")
    check(launches["dense_topk_tiles"] > 0,
          "serve: kernel dense_topk_tiles never launched")
    rows["dense_topk_tiles"]["launches"] = launches["dense_topk_tiles"]
    if profile:
        for system in (gpu, gpu_h):
            log(f"profile of {system.cascade_spec.name}:")
            profile_batch(system, ql.terms[sl], ql.mask[sl], ql.topic[sl])
    return card, rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-docs", type=int, default=196_608)
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--profile", action="store_true",
                    help="also profile one served batch (torch.profiler)")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        log("FAIL: src/repro_torch not found: run from a checkout's root")
        return 2
    try:
        import torch
    except ImportError:
        log("FAIL: PyTorch is not installed")
        return 2
    if not torch.cuda.is_available():
        log("FAIL: no CUDA device")
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        card, rows = run(args.n_docs, args.batches, args.profile)
    except SmokeFailure as e:
        log(f"FAIL: {e}")
        return 1
    log(f"total elapsed {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [rows[n] for n in KERNELS]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
