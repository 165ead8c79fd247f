"""One run of one cell: set-up, warm-up, the measured window, the check
against the plain reference, and the result line.

``Setup`` and ``result`` are ``run.py``'s body; the tests call them on
the CPU (``device`` given) at small sizes.
"""

from __future__ import annotations

import gc
import json
import os
import sys
import time

import numpy as np
import torch

from portbench.data.corpus import CorpusParams, build_corpus
from portbench.harness import registry, spans, store, traffic
from portbench.harness import trace as tr
from portbench.reference import index as ref_index
from portbench.reference.stage1 import RefIndex

TOP_OPS = 10


class NoChip(SystemExit):
    """The cell's chips are not there."""


def process_start() -> float:
    """The process's start on the wall clock (``/proc``), else now."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


def require_chips(n: int) -> None:
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        raise NoChip(f"portbench: the cell needs {n} CUDA device(s), "
                     f"found {have}")


def corpus_of(cfg: dict) -> dict:
    params = CorpusParams(**cfg["corpus"])
    return store.cached("corpus", {"corpus": cfg["corpus"]},
                        lambda: build_corpus(params))


def reference_index(cfg: dict, corpus: dict) -> dict:
    ix = cfg["index"]
    return store.cached(
        "refindex", {"corpus": cfg["corpus"], "stop_k": ix["stop_k"],
                     "block_size": ix["block_size"]},
        lambda: ref_index.build(corpus, stop_k=ix["stop_k"],
                                block_size=ix["block_size"]))


def window(sut, mix, terms, mask, topic, sampled, seconds, trace_s):
    """The closed loop: one batch in flight until ``seconds`` have passed,
    the profiler on for the first ``trace_s`` seconds where given.
    Returns {walls: per-batch seconds, queries, seconds} and, traced, the
    profiler, its window in wall-clock ns and its batches and queries."""
    b = mix["batch"]
    n = len(terms)
    walls = []
    pos = 0
    out = {}
    if trace_s is not None:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
        spans.TRACING[0] = True
        out.update(prof=prof, t_prof=[time.time_ns(), None])

    def stop_trace():
        spans.TRACING[0] = False
        out["t_prof"][1] = time.time_ns()
        out["prof"].__exit__(None, None, None)
        out.update(traced_batches=len(walls), traced_queries=len(walls) * b)

    t0 = time.perf_counter()
    out["wall"] = [time.time(), None]
    t_end = t0 + seconds
    traced = trace_s is not None
    while True:
        at = np.arange(pos, pos + b)
        idx = at % n
        tb, mb, pb = terms[idx], mask[idx], topic[idx]
        ts = time.perf_counter()
        res = sut.serve(tb, mb, pb)
        te = time.perf_counter()
        walls.append(te - ts)
        sut.keep(np.flatnonzero(sampled[idx] & (at < n)), tb, mb, pb, res,
                 traced)
        pos += b
        if traced and (te - t0 >= trace_s or te >= t_end):
            stop_trace()
            traced = False
        if te >= t_end:
            break
    out["wall"][1] = time.time()
    out.update(walls=walls, queries=pos, seconds=te - t0)
    return out


def per_layer(bench, workload, ctx) -> dict:
    out = {}
    for m in registry.metrics_of(bench, workload, "per_layer"):
        v = registry.reader(m["name"]).read(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def judge(mod, cfg, state, kept, ref, ref_dev, corpus, dtype=torch.float32,
          memo=None):
    """The numbers compared for the sampled answers, with the program's
    outputs (or, with ``dtype`` below float32, the control's) against the
    plain reference's.  ``memo`` carries each side's replay of the batches
    from one call to the next (``Setup.memo``)."""
    memo = {} if memo is None else memo
    want = mod.outputs(cfg, state, kept, ref, ref_dev, corpus,
                       memo.setdefault("reference", {}))
    got = (mod.program_outputs(kept, state) if dtype == torch.float32 else
           mod.outputs(cfg, state, kept, ref, ref_dev, corpus,
                       memo.setdefault(str(dtype), {}), dtype))
    return mod.numbers(got, want)


def keep_caches_inside() -> None:
    """Build caches in the checkout, at fixed paths (the port builds its
    kernels into ``build/kernels`` itself), and NCCL's one-rank group off
    ``/dev/shm``."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(store.CACHE_DIR / sub))
    os.environ.setdefault("NCCL_SHM_DISABLE", "1")


class Setup:
    """A cell's parts and its built system under test."""

    def __init__(self, workload, *, device=None, root=registry.ROOT,
                 bench_dir=registry.BENCH_DIR):
        self.t_start = process_start()
        keep_caches_inside()
        self.workload = workload
        self.bench = registry.load_benchmark(root)
        self.w = registry.cell(self.bench, workload)
        self.cfg, self.mod = registry.config(self.bench, self.w["config"],
                                             bench_dir)
        self.mix = registry.traffic(self.w["traffic"], bench_dir)
        if device is None:
            require_chips(self.w["chips"])
            device = "cuda"
        self.device = device
        self.on_card = torch.device(device).type == "cuda"
        self.corpus = corpus_of(self.cfg)
        self.sut = self.mod.build(self.cfg, self.corpus, device, self.mix)
        self.memo: dict = {}

    def measure(self, seed: int, seconds: float, trace: bool) -> dict:
        """Warm up on the seed's warm-up batches, then the window."""
        sut, mix = self.sut, self.mix
        terms, mask, topic = traffic.pool(self.corpus, mix, self.cfg, seed)
        sampled = traffic.sample(self.corpus, mix, seed, terms, mask)
        wt, wm, wp = traffic.warm(self.corpus, mix, self.cfg, seed)
        for lo in range(0, len(wt), mix["batch"]):
            sl = slice(lo, lo + mix["batch"])
            sut.serve(wt[sl], wm[sl], wp[sl])
        sut.kept.clear()
        sut.traced.clear()
        if self.on_card:
            torch.cuda.synchronize()
        setup_s = time.time() - self.t_start
        win = window(sut, mix, terms, mask, topic, sampled, seconds,
                     mix["trace_seconds"] if trace else None)
        win["setup_s"] = setup_s
        return win

    def reference(self):
        ref = reference_index(self.cfg, self.corpus)
        return ref, RefIndex(ref, self.device)


def result(st: Setup, seed: int, seconds: float, trace: bool,
           close: bool = True) -> dict:
    """The window of ``st``'s cell on ``seed``, the check and the result
    line's object.  With ``close`` the system is freed before the
    reference runs (a run's order); without, it stays for another
    window (the tests)."""
    win = st.measure(seed, seconds, trace)
    workload = st.workload
    on_card, cfg, mod = st.on_card, st.cfg, st.mod
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0

    sut = st.sut
    state = sut.state()
    kept, traced = list(sut.kept), list(sut.traced)
    if close:
        sut.close()
        st.sut = sut = None
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
    ref, ref_dev = st.reference()
    nums = (judge(mod, cfg, state, kept, ref, ref_dev, st.corpus,
                  memo=st.memo) if kept else {})
    limits = cfg["limits"]
    checks = {k: {"value": v, "limit": limits.get(k)} for k, v in nums.items()}
    correct = bool(kept) and all(
        c["limit"] is not None and c["value"] <= c["limit"]
        for c in checks.values())

    bench, w = st.bench, st.w
    e2e = {m["name"]: m for m in registry.metrics_of(bench, workload,
                                                     "end_to_end")}
    walls = np.asarray(win["walls"])
    values = {"qps": win["queries"] / win["seconds"],
              "p95_ms": float(np.percentile(walls, 95) * 1e3),
              "setup_s": win["setup_s"]}
    device_info = {
        "platform": "gpu" if on_card else torch.device(st.device).type,
        "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
        "count": w["chips"], "memory_peak_bytes": int(memory_peak)}
    result = {"correct": correct, "attempted": int(win["queries"]),
              "failed": 0}
    if trace:
        prof_read = tr.read_profile(win["prof"])
        t0_ns, t1_ns = win["t_prof"]
        ops = [o for o in prof_read["ops"] if o[1] > t0_ns and o[0] < t1_ns]
        busy = sum(min(e, t1_ns) - max(s, t0_ns)
                   for s, e in tr.busy_intervals(ops)) * 1e-9
        ctx = dict(ops=ops, spans=prof_read["spans"], t0_ns=t0_ns,
                   t1_ns=t1_ns, batches=win["traced_batches"],
                   queries=win["traced_queries"],
                   work=mod.traced_work(cfg, state, traced, ref, ref_dev))
        result["metrics"] = per_layer(bench, workload, ctx)
        device_info.update(busy_s=busy, window_s=(t1_ns - t0_ns) * 1e-9)
        by_op: dict = {}
        for name, s in tr.op_seconds(ops).items():
            key = tr.short_name(name)
            by_op[key] = by_op.get(key, 0.0) + s
        idle = tr.idle_by_span(ops, prof_read["spans"], t0_ns, t1_ns)
        result["breakdown"] = {
            "device_ops": sorted(([k, v] for k, v in by_op.items()),
                                 key=lambda kv: -kv[1])[:TOP_OPS],
            "idle_gaps": sorted(([k, v] for k, v in idle.items()),
                                key=lambda kv: -kv[1])[:TOP_OPS]}
    else:
        result["metrics"] = {n: {"value": values[n], "unit": m["unit"]}
                             for n, m in e2e.items()}
    result["device"] = device_info
    result["checks"] = checks
    st.window_wall = win["wall"]
    return result


def emit(result: dict) -> None:
    """The compared numbers beside their limits as the last lines of
    standard error, then the result as the last line of standard output."""
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
