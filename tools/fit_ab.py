"""The fit and the predictors' fits, timed in one or more checkouts on one card.

    python tools/fit_ab.py ROOT [ROOT ...]

Each ROOT is a checkout that holds ``src/repro_torch``.  First every
distinct ROOT's kernels are built, all at once, each into its own
``build/kernels``; ptxas's registers, shared memory and spills of the
checkout's ``level_histogram.cu`` are printed beside.  Then one process a
ROOT, in the order given (list the checkouts as A B B A to see the card
drift between runs), through the port's public entry points only, which
are the same in every checkout since the fit's port:

* ``fit``: the ``paper_200ms`` corpus of 196,608 docs, its index and a log
  of 4,096 queries (seed 5) built on the host, a card system from them,
  and ``SearchSystem.fit(ql, None, seed=5)`` three times (host clock
  around the fit and a synchronize; the first fit of the process first),
  with the launch counts of the last;
* ``predict``: the serving CLI's run at its defaults
  (``launch.serve.run``: 16,384 docs, 2,000 queries, the oracle labels,
  the labelled fit, one serve), then ``cross_val_predict`` (10 folds, 64
  trees; QR at τ 0.5, RF, LR) on the ``t_bmw`` target of the kept queries'
  Stage-0 features, each method timed as ``chip_smoke.py``'s predict phase
  times it, with its launch counts;
* ``level_histogram``: the fit's largest level (16 nodes, 147 features,
  4,096 rows, 64 bins; seeded inputs) timed with CUDA events (median of
  20 after a warm-up), its device time a call (``torch.profiler`` over 20
  calls), and fp32 ``index_add_`` on the same keys timed the same way.

Prints the card's name and power limit, one JSON line a run, and each
ROOT's figures side by side.  Needs one card, ``nvcc`` and the checkouts'
sources; writes only under each ROOT's ``build/``.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
from pathlib import Path

NVCC = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                    "bin", "nvcc")

_RUN = r"""
import json, statistics, sys, time
root = sys.argv[1]
sys.path[:0] = [root + "/src"]
import numpy as np
import torch
from repro_torch import kernels
kernels.extension()
if sys.argv[2] == "build":
    sys.exit(0)
dev = torch.device("cuda")
row = {}

def counts():
    return {k: v for k, v in kernels.LAUNCHES.items() if v}

def ms(fn, reps=20):
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

def device_ms(fn, reps=20):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / reps / 1e3

# the fit's largest level as one level_histogram call, and index_add_
from repro_torch.kernels.level_histogram import ops as lh
rng = np.random.RandomState(5)
n, n_feat, n_nodes, n_bins = 4096, 147, 16, 64
xbt = torch.from_numpy(rng.randint(0, n_bins, (n_feat, n)).astype(np.uint8)).to(dev)
node = torch.from_numpy(rng.randint(0, n_nodes, n).astype(np.int32)).to(dev)
w = torch.from_numpy(rng.poisson(1.0, n).astype(np.float32)).to(dev)
gw = torch.from_numpy((rng.standard_cauchy(n) * 10).astype(np.float32)).to(dev) * w
kern = lambda: lh.level_histogram(xbt, node, gw, w, n_nodes=n_nodes, n_bins=n_bins)
keys = ((node.long()[:, None] * n_feat + torch.arange(n_feat, device=dev)[None, :])
        * n_bins + xbt.T.long()).reshape(-1)
vals = torch.stack([gw, w], 1)[:, None, :].expand(n, n_feat, 2).reshape(-1, 2)
lib = lambda: torch.zeros((n_nodes * n_feat * n_bins, 2), device=dev).index_add_(0, keys, vals)
row["level_histogram_ms"] = ms(kern)
row["level_histogram_device_ms"] = device_ms(kern)
row["index_add_ms"] = ms(lib)
row["index_add_device_ms"] = device_ms(lib)

from repro_torch.configs.cascade_presets import get_preset
from repro_torch.index.builder import build_index
from repro_torch.index.corpus import CorpusParams, build_corpus, build_queries
from repro_torch.serving.system import build_system
spec = get_preset("paper_200ms")
corpus = build_corpus(CorpusParams(n_docs=196_608))
index = build_index(corpus, block_size=spec.index.block_size, stop_k=spec.index.stop_k)
ql = build_queries(corpus, 4096, stop_k=spec.index.stop_k, seed=5)
system = build_system(spec, index, corpus=corpus, device=dev)
torch.cuda.synchronize()
walls = []
for _ in range(3):
    kernels.reset_launches()
    t = time.perf_counter()
    system.fit(ql, None, seed=5)
    torch.cuda.synchronize()
    walls.append(time.perf_counter() - t)
row["fit_s"] = walls
row["fit_launches"] = counts()
del system, index, corpus

from repro_torch.core import features as F
from repro_torch.core import predictors
from repro_torch.launch import serve
card = serve.run(["--device", "cuda"], say=lambda line: None)
row["cli_walls_s"] = card.walls
g, labels, cql = card.system, card.labels, card.ql
x = F.extract(g.term_stats, g.df, torch.as_tensor(cql.terms, device=dev),
              torch.as_tensor(cql.mask, device=dev)).cpu().numpy()
keep = np.flatnonzero(labels.keep)
x, y = x[keep], labels.t_bmw[keep]
for method in ("qr", "rf", "lr"):
    cfg = predictors.PredictorConfig(method=method, tau=0.5)
    kernels.reset_launches()
    t = time.perf_counter()
    predictors.cross_val_predict(x, y, cfg, device=dev)
    torch.cuda.synchronize()
    row[f"predict_{method}_s"] = time.perf_counter() - t
    row[f"predict_{method}_launches"] = counts()
print(json.dumps(row))
"""


def ptxas_report(root: Path) -> subprocess.Popen:
    """Start ``nvcc -Xptxas -v`` on the checkout's level kernels."""
    src = root / "src/repro_torch/kernels/level_histogram/level_histogram.cu"
    out = root / "build" / "ab_level.o"
    out.parent.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen(
        [NVCC, "-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
         "-Xptxas", "-v", "-c", str(src), "-o", str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def kernel_lines(text: str) -> list[str]:
    """ptxas's lines of each kernel: its name, then its stack/spill,
    register and shared memory lines; and any compiler error."""
    out = []
    for line in text.splitlines():
        if "error" in line.lower() and "ptxas info" not in line:
            out.append(line)
        if "Compiling entry function" in line:
            out.append(line.split("'")[1])
        elif re.search(r"spill|registers", line):
            out.append("    " + line.split("ptxas info    :")[-1].strip())
    return out


def main() -> int:
    roots = [Path(r).resolve() for r in sys.argv[1:]]
    if not roots:
        print(__doc__)
        return 2
    name = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"card: {name}", flush=True)
    distinct = list(dict.fromkeys(roots))
    reports = {r: ptxas_report(r) for r in distinct}
    builds = {r: subprocess.Popen([sys.executable, "-c", _RUN, str(r),
                                   "build"]) for r in distinct}
    for r, proc in reports.items():
        text, _ = proc.communicate()
        print(f"ptxas, {r}: rc {proc.returncode}", flush=True)
        for line in kernel_lines(text):
            print(f"  {line}", flush=True)
    for r, proc in builds.items():
        if proc.wait() != 0:
            print(f"build failed: {r}", flush=True)
            return 1
    rows = []
    for r in roots:
        proc = subprocess.run([sys.executable, "-c", _RUN, str(r), "run"],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], flush=True)
            return 1
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        rows.append((r, row))
        print(json.dumps({"root": str(r), **row}), flush=True)
    keys = ("level_histogram_ms", "level_histogram_device_ms",
            "index_add_ms", "index_add_device_ms", "fit_s",
            "predict_qr_s", "predict_rf_s", "predict_lr_s")
    for key in keys:
        print(f"{key}: " + " | ".join(
            f"{r.name}: {json.dumps(row[key])}" for r, row in rows),
            flush=True)
    print(f"card: {name}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
