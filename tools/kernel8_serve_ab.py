"""Kernel 8's bf16 serving call, timed in two or more checkouts on one card.

    python tools/kernel8_serve_ab.py ROOT [ROOT ...]

Each ROOT is a checkout that holds ``src/repro_torch``.  First, for each
distinct ROOT at once: ``flash_attention_sm90.cu`` compiled alone with
``-Xptxas -v`` (ptxas's registers, stack and spills of every instantiation
of ``flash_attention_sm90_kernel`` are printed), and the checkout's kernels
built into its own ``build/kernels``.  Then one process a ROOT, in the
order given (list a checkout twice, as A B B A, to see the card drift
between runs): ``ops.flash_attention`` at the LM phase's serving call
(Yi-6B's prefill, q (4, 32, 4,096, 128), k and v (4, 4, 4,096, 128), bf16,
causal, contiguous, drawn from a seed), no log-sum-exp, timed with CUDA
events after a synchronize, the median of 50 after one warm-up.  Prints
the card's name and power limit, one JSON line a run, and the medians of
each ROOT.  Needs one card, ``nvcc`` and the checkouts' sources; writes
only under each ROOT's ``build/``.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
from pathlib import Path

SHAPE = dict(b=4, h=32, hkv=4, s=4096, d=128)
REPS = 50
NVCC = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                    "bin", "nvcc")

_RUN = r"""
import json, statistics, sys
sys.path.insert(0, sys.argv[1] + "/src")
import torch
from repro_torch import kernels
from repro_torch.kernels.flash_attention import ops
kernels.extension()
if sys.argv[2] == "build":
    sys.exit(0)
b, h, hkv, s, d, reps = (int(x) for x in sys.argv[3:9])
gen = torch.Generator(device="cuda")
gen.manual_seed(7)
def randn(*shape, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(
        torch.bfloat16)
q = randn(b, h, s, d, scale=0.5)
k = randn(b, hkv, s, d, scale=0.5)
v = randn(b, hkv, s, d)
ops.flash_attention(q, k, v, causal=True)
torch.cuda.synchronize()
times = []
for _ in range(reps):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    ops.flash_attention(q, k, v, causal=True)
    end.record()
    torch.cuda.synchronize()
    times.append(start.elapsed_time(end))
print(json.dumps({"ms": statistics.median(times), "min_ms": min(times)}))
"""


def ptxas_report(root: Path) -> subprocess.Popen:
    """Start ``nvcc -Xptxas -v`` on the checkout's sm90 prefill source."""
    src = root / "src/repro_torch/kernels/flash_attention"
    out = root / "build" / "ab_sm90.o"
    out.parent.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen(
        [NVCC, "-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
         "-Xptxas", "-v", "-c", str(src / "flash_attention_sm90.cu"),
         "-o", str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def kernel_lines(text: str) -> list[str]:
    """ptxas's lines of each ``flash_attention_sm90_kernel``
    instantiation: its name, then its stack/spill and register lines."""
    out, keep = [], False
    for line in text.splitlines():
        if "Compiling entry function" in line or "Function properties" in line:
            keep = "flash_attention_sm90_kernel" in line
            if keep and "Compiling entry" in line:
                out.append(line.split("'")[1])
        elif keep and re.search(r"spill|registers", line):
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
            print(f"build failed in {r}", flush=True)
            return 1
    results: dict[Path, list[float]] = {r: [] for r in distinct}
    shape = [str(SHAPE[x]) for x in ("b", "h", "hkv", "s", "d")]
    for r in roots:
        done = subprocess.run([sys.executable, "-c", _RUN, str(r), "time",
                               *shape, str(REPS)], capture_output=True,
                              text=True)
        if done.returncode != 0:
            print(done.stderr[-4000:], flush=True)
            return 1
        row = json.loads(done.stdout.strip().splitlines()[-1])
        results[r].append(row["ms"])
        print(json.dumps({"root": str(r), **row}), flush=True)
    for r, ms in results.items():
        print(f"{r}: median ms of its runs {ms}, "
              f"mean {statistics.mean(ms)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
