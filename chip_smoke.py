#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py              # the full run, on the first GPU

It imports nothing of JAX and nothing of the JAX package ``repro``.  In
order, it

1. prints the card's name and power limit (``nvidia-smi``) and builds the
   three serving kernels from the sources under ``src/repro_torch``;
2. builds the ``paper_200ms`` cascade at one shard of 196,608 docs (the
   per-chip shard of the paper's ISN deployment) on the card, with Stage-0
   and LTR GBRTs of the spec's shapes made here from a NumPy seed (bin
   edges from quantiles of a calibration query log, routing thresholds
   from the 60th/75th percentiles of the predictions, as ``fit`` sets
   them), and the same system on the CPU;
3. serves one batch of 32 queries on both (the CPU runs the kernels'
   plain versions) and requires ``topk``, ``final`` and the modeled
   ``latency`` to be equal, while recording every kernel call's inputs;
4. kernel phase: runs each kernel on the recorded main-path inputs against
   its plain version on the card (kernel 1 and the counts of kernel 3
   exact, the float sums within 1e-5) and times both with CUDA events;
5. serve phase: sets the launch counts to 0, serves 8 batches of 32
   queries on the card, and requires both routes to take queries, Stage-2
   to re-rank, and every kernel to have launched; prints the wall time per
   batch and the device memory;
6. prints the ``kernels`` JSON line, then the card line, then the result.

Any failed check exits non-zero without the result line.  ``--n-docs``
and ``--batches`` shrink the run for a quick check; ``--profile`` adds a
``torch.profiler`` breakdown of one more served batch (wall, device busy
time, host time per cascade stage, busiest device kernels).
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
}


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

class Recorder:
    """Records the arguments of every kernel-wrapper call (the main path's
    real inputs) while passing the call through."""

    def __init__(self):
        from repro_torch.kernels.blockmax_score import ops as bm
        from repro_torch.kernels.impact_accumulate import ops as ia
        from repro_torch.kernels.qd_feature_gather import ops as qd
        self.sites = {"impact_accumulate_batched": ia,
                      "blockmax_score_batched": bm,
                      "qd_feature_gather_lanes": qd}
        self.calls = {name: [] for name in self.sites}
        self.orig = {}

    def __enter__(self):
        for name, mod in self.sites.items():
            fn = getattr(mod, name)
            self.orig[name] = fn

            def wrapped(*args, _fn=fn, _name=name, **kw):
                self.calls[_name].append((args, kw))
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
    """(bytes, ops) the call must move and do on these inputs: the live
    lanes it needs read once, flags and query terms read once, the output
    written once; one int32 compare per (query, live lane it scores, query
    term) — per (live lane, candidate) for the Stage-2 gather."""
    import torch
    if name == "impact_accumulate_batched":
        docs, terms, imps, qterms, lstar = args
        q, n_terms = qterms.shape
        live = int((docs >= 0).sum())
        tile_d = kw["tile_d"]
        out = q * docs.shape[0] * tile_d * 4
        return (12 * live + 4 * qterms.numel() + 4 * q + out,
                q * live * n_terms)
    if name == "blockmax_score_batched":
        docs, terms, scores, qterms, sb, st = args
        q, n_terms = qterms.shape
        per_tile = (docs >= 0).sum(dim=1).to(torch.int64)      # (n_tiles,)
        # the mirror's lanes of every tile some query needs, read once
        needed = int(per_tile[(st > 0).any(dim=0)].sum())
        scored = int(((st > 0).to(torch.int64) * per_tile[None]).sum())
        out = q * docs.shape[0] * kw["tile_d"] * 4
        return (12 * needed + 4 * (sb.numel() + st.numel() + qterms.numel())
                + out, scored * n_terms)
    lane_docs, lane_scores, cand = args
    live = int((lane_docs >= 0).sum())
    return (8 * live + 4 * cand.numel() + 12 * cand.numel(),
            live * cand.shape[1])


def compare(name, got, want):
    """Max abs error; raises if the kernel disagrees with its plain version
    beyond the stated tolerance (integers exact, float sums 1e-5)."""
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
            check(e <= 1e-5, f"{name}: max abs error {e} > 1e-5")
        else:
            e = float((g.long() - w.long()).abs().max()) if g.numel() else 0.0
            check(e == 0, f"{name}: integer outputs differ by {e}")
        err = max(err, e)
    return err


def edge_calls(device):
    """Small seeded inputs with the edge cases the main path rarely shows:
    -1 query slots, a repeated query term, an empty tile, a ghost tail
    tile, tiles whose survive_t is 0 under set block flags, dead lanes
    and -1 candidates."""
    import numpy as np
    import torch
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

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return {
        "impact_accumulate_batched": (
            (t(docs_b), t(terms_b), t(imps_b), t(qterms),
             t(np.asarray([0, 40, 0, 1], np.int32))), dict(tile_d=tile_d)),
        "blockmax_score_batched": (
            (t(docs_b), t(terms_b), t(scores_b), t(qterms), t(sb), t(st)),
            dict(tile_d=tile_d, block_size=block)),
        "qd_feature_gather_lanes": ((t(lanes), t(lane_sc), t(cand)), {}),
    }


def kernel_phase(recorded):
    """Every recorded main-path call, and the edge cases: kernel vs plain
    version on the card."""
    import torch
    from repro_torch.kernels.blockmax_score import ops as bm
    from repro_torch.kernels.impact_accumulate import ops as ia
    from repro_torch.kernels.qd_feature_gather import ops as qd
    plain = {"impact_accumulate_batched": ia.impact_accumulate_plain,
             "blockmax_score_batched": bm.blockmax_score_plain,
             "qd_feature_gather_lanes": qd.qd_feature_gather_plain}
    kern = {"impact_accumulate_batched": ia.impact_accumulate_batched,
            "blockmax_score_batched": bm.blockmax_score_batched,
            "qd_feature_gather_lanes": qd.qd_feature_gather_lanes}
    rows = {}
    edges = edge_calls(recorded["qd_feature_gather_lanes"][0][0][0].device)
    for name, calls in recorded.items():
        check(calls, f"{name}: the main path never called it")
        err = 0.0
        for args, kw in calls + [edges[name]]:
            got = kern[name](*args, **kw)
            want = plain[name](*args, **kw)
            torch.cuda.synchronize()
            err = max(err, compare(name, got, want))
        # time the largest call of the batch (the one with most work)
        args, kw = max(calls, key=lambda c: work_of(name, *c)[0])
        nbytes, ops = work_of(name, args, kw)
        ms = cuda_ms(lambda: kern[name](*args, **kw), REPS)
        plain_ms = cuda_ms(lambda: plain[name](*args, **kw), REPS // 4)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / INT32_OPS_PER_S * 1e3
        rows[name] = dict(
            name=name, route="cuda", **KERNELS[name], launches=0,
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=None)
        log(f"kernel {name}: {len(calls)} main-path calls and the edge "
            f"cases checked, max_abs_err={err}, "
            f"ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"bound_ms={rows[name]['bound_ms']:.4f} "
            f"({rows[name]['bound_by']}: {nbytes} B, {ops} ops)")
    return rows


def profile_batch(system, terms, mask, topics):
    """One more served batch under ``torch.profiler``: wall time, device
    busy time (the union of the card's own kernel and copy intervals; the
    host-side aten ops that launched them are not counted again), host
    time per cascade stage, and the busiest device kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    stages = ("stage0", "_stage1_full", "stage2")
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


def run(n_docs, n_batches, profile=False):
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.configs.cascade_presets import get_preset
    from repro_torch.index.builder import build_index
    from repro_torch.index.corpus import (CorpusParams, build_corpus,
                                          build_queries)
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
    check(np.array_equal(a.topk, b.topk), "cross-check: topk differs")
    check(np.array_equal(a.final, b.final), "cross-check: final differs")
    check(np.array_equal(a.latency, b.latency),
          "cross-check: modeled latency differs")
    log("cross-check: topk, final and latency equal on the card and CPU")
    del cpu

    rows = kernel_phase(rec.calls)

    # serve phase: the main path, counted
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    jass = bmw = reranked = 0
    for i in range(n_batches):
        sl = slice(i * BATCH, (i + 1) * BATCH)
        jass0, bmw0 = gpu.sched.stats["jass"], gpu.sched.stats["bmw"]
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = gpu.serve(ql.terms[sl], ql.mask[sl], ql.topic[sl])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        jass += gpu.sched.stats["jass"] - jass0
        bmw += gpu.sched.stats["bmw"] - bmw0
        reranked += int((res.candidates_used > 0).sum())
        check(res.topk.shape == (BATCH, spec.stage2.k_serve)
              and res.final.shape == (BATCH, spec.stage2.t_final),
              "serve: result shapes")
        check(np.isfinite(res.latency).all() and (res.topk >= 0).all()
              and (res.topk < n_docs).all(), "serve: ids or latency invalid")
    launches = dict(kernels.LAUNCHES)
    mem = torch.cuda.memory_allocated()
    peak = torch.cuda.max_memory_allocated()
    log(f"served {n_batches} x {BATCH} queries: jass={jass} bmw={bmw} "
        f"reranked={reranked}; launches {launches}")
    log("wall s per batch: " + " ".join(f"{w:.4f}" for w in walls)
        + f" (median {statistics.median(walls):.4f})")
    log(f"device memory: {mem} B in use, {peak} B peak during serving; "
        f"modeled p99 {res.stats['p99']:.3f}")
    check(jass > 0 and bmw > 0, "serve: both routes must take queries")
    check(reranked > 0, "serve: Stage-2 re-ranked no query")
    for name, n in launches.items():
        check(n > 0, f"serve: kernel {name} never launched")
        rows[name]["launches"] = n
    if profile:
        sl = slice(0, BATCH)
        profile_batch(gpu, ql.terms[sl], ql.mask[sl], ql.topic[sl])
    print(json.dumps({"kernels": [rows[n] for n in KERNELS]}), flush=True)
    return card


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-docs", type=int, default=196_608)
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--profile", action="store_true",
                    help="also profile one served batch (torch.profiler)")
    args = ap.parse_args(argv)
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
        card = run(args.n_docs, args.batches, args.profile)
    except SmokeFailure as e:
        log(f"FAIL: {e}")
        return 1
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
