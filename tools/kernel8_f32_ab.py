"""Kernel 8's fp32 forward at its three recorded calls, timed in one or more checkouts on one card.

    python tools/kernel8_f32_ab.py [--check] ROOT [ROOT ...]

Each ROOT is a checkout that holds ``src/repro_torch`` (and, for
``--check``, ``chip_smoke.py``).  First, for each distinct ROOT at once:
``flash_attention.cu`` compiled alone with ``-Xptxas -v`` (ptxas's
registers, stack and spills of every instantiation of
``flash_attention_kernel`` are printed, and any compiler error), and the
checkout's kernels built into its own ``build/kernels``.  Then one process
a ROOT, in the order given (list the checkouts as A B B A to see the card
drift between runs), timing ``ops.flash_attention`` with CUDA events after
a synchronize, the median of 20 after one warm-up, at:

* ``bert4rec_serve``: BERT4Rec's serve call, (512, 2, 200, 32) fp32,
  non-causal, q, k and v the strided (B, S, H·D) tensors viewed as (B, H,
  S, D), as the model passes them; no log-sum-exp;
* ``bert4rec_train``: BERT4Rec's training forward, (4,096, 2, 200, 32),
  the same views, with the log-sum-exp;
* ``yi_f32``: the largest recorded fp32 call, Yi-6B's cross-check
  prefill: q (2, 32, 1,024, 128), k and v (2, 4, 1,024, 128), causal, q
  and k contiguous (as RoPE writes them), v a (B, S, H·D) view;

and, once a process, ``scaled_dot_product_attention`` on the same inputs
(``enable_gqa``; no log-sum-exp); each also as device time
(``torch.profiler`` over 5 calls, the mean of a call's device kernels).
Inputs are drawn from a seed.  With ``--check`` each process also holds
the kernel, where the checkout's
``chip_smoke.py`` has ``f32_check``, on the three calls and on its
``f32_edge_calls`` (two launches bit-equal; ``attention_ref`` and
``attention_f32_tiles_plain`` under its bars).  Prints the card's name and
power limit, one JSON line a run, and the runs of each ROOT with their
median.  Needs one card, ``nvcc`` and the checkouts' sources; writes only
under each ROOT's ``build/``.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
from pathlib import Path

REPS = 20
CALLS = ("bert4rec_serve", "bert4rec_train", "yi_f32")
NVCC = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                    "bin", "nvcc")

_RUN = r"""
import json, statistics, sys
root = sys.argv[1]
sys.path[:0] = [root + "/src", root]
import torch
from repro_torch import kernels
from repro_torch.kernels.flash_attention import ops
kernels.extension()
if sys.argv[2] == "build":
    sys.exit(0)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
reps = int(sys.argv[3])
gen = torch.Generator(device="cuda")
gen.manual_seed(13)

def randn(*shape, scale=1.0):
    return torch.randn(shape, generator=gen, device="cuda") * scale

def views(b, s, h, d, scale=1.0):
    return randn(b, s, h * d, scale=scale).view(b, s, h, d).transpose(1, 2)

def ms(fn):
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

calls = {}
for name, b in (("bert4rec_serve", 512), ("bert4rec_train", 4096)):
    calls[name] = ((views(b, 200, 2, 32, 0.5), views(b, 200, 2, 32, 0.5),
                    views(b, 200, 2, 32)),
                   dict(causal=False, return_lse=name == "bert4rec_train"))
calls["yi_f32"] = ((randn(2, 32, 1024, 128, scale=0.5),
                    randn(2, 4, 1024, 128, scale=0.5),
                    views(2, 1024, 4, 128)), dict(causal=True))
sdpa = torch.nn.functional.scaled_dot_product_attention

def device_ms(fn, n=5):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / n / 1e3

row = {}
for name, (args, kw) in calls.items():
    kern = lambda: ops.flash_attention(*args, **kw)
    lib = lambda: sdpa(*args, is_causal=kw["causal"], enable_gqa=True)
    row[name + "_ms"] = ms(kern)
    row[name + "_device_ms"] = device_ms(kern)
    row[name + "_sdpa_ms"] = ms(lib)
    row[name + "_sdpa_device_ms"] = device_ms(lib)
if sys.argv[2] == "check":
    import chip_smoke as cs
    if hasattr(cs, "f32_check"):
        bars = {"bert4rec_serve": "rg", "bert4rec_train": "rg",
                "yi_f32": "model"}
        errs = {name: cs.f32_check(name, args, kw, bars[name])
                for name, (args, kw) in calls.items()}
        edges = cs.f32_edge_calls("cuda")
        errs["edges"] = max(cs.f32_check(f"edge {tuple(a[0].shape)} "
                                         f"{tuple(a[1].shape)} {kw}", a, kw)
                            for a, kw in edges)
        row["checked_edges"] = len(edges)
        row["errs"] = errs
print(json.dumps(row))
"""


def ptxas_report(root: Path) -> subprocess.Popen:
    """Start ``nvcc -Xptxas -v`` on the checkout's fp32 prefill source."""
    src = root / "src/repro_torch/kernels/flash_attention"
    out = root / "build" / "ab_f32.o"
    out.parent.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen(
        [NVCC, "-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
         "-Xptxas", "-v", "-c", str(src / "flash_attention.cu"),
         "-o", str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def kernel_lines(text: str) -> list[str]:
    """ptxas's lines of each ``flash_attention_kernel`` instantiation: its
    name, then its stack/spill and register lines; and any compiler
    error."""
    out, keep = [], False
    for line in text.splitlines():
        if "error" in line.lower() and "ptxas info" not in line:
            out.append(line)
        if "Compiling entry function" in line or "Function properties" in line:
            keep = "flash_attention_kernel" in line
            if keep and "Compiling entry" in line:
                out.append(line.split("'")[1])
        elif keep and re.search(r"spill|registers", line):
            out.append("    " + line.split("ptxas info    :")[-1].strip())
    return out


def main() -> int:
    args = sys.argv[1:]
    mode = "check" if "--check" in args else "time"
    roots = [Path(r).resolve() for r in args if not r.startswith("--")]
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
    failed = [r for r, proc in builds.items() if proc.wait() != 0]
    if failed:
        print(f"build failed in {failed}", flush=True)
        return 1
    results: dict[Path, dict[str, list[float]]] = {r: {} for r in distinct}
    for r in roots:
        done = subprocess.run([sys.executable, "-c", _RUN, str(r), mode,
                               str(REPS)], capture_output=True, text=True)
        if done.returncode != 0:
            print(done.stdout[-2000:], done.stderr[-6000:], flush=True)
            return 1
        row = json.loads(done.stdout.strip().splitlines()[-1])
        for key in CALLS:
            for unit in ("_ms", "_device_ms"):
                results[r].setdefault(key + unit, []).append(row[key + unit])
        print(json.dumps({"root": str(r), **row}), flush=True)
    for r, res in results.items():
        for key, ms in res.items():
            print(f"{r} {key}: runs {ms}, median {statistics.median(ms)}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
