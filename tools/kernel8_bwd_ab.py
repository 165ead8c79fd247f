"""Kernel 8's backward at its two training calls, timed in one or more checkouts on one card.

    python tools/kernel8_bwd_ab.py [--check] [--profile] ROOT [ROOT ...]

Each ROOT is a checkout that holds ``src/repro_torch`` and ``chip_smoke.py``.
First, for each distinct ROOT at once: ``flash_attention_bwd.cu`` compiled
alone with ``-Xptxas -v`` (ptxas's registers, stack and spills of every
``bwd_*`` kernel instantiation are printed), and the checkout's kernels
built into its own ``build/kernels``.  Then one process a ROOT, in the
order given (list the checkouts as A B B A to see the card drift between
runs), timing ``ops.flash_attention_backward`` — and, once a process,
``scaled_dot_product_attention``'s backward on the same inputs (k and v
repeated to every head outside the timed call) — with CUDA events after a
synchronize, the median of 20 after one warm-up, at:

* Yi-6B's training call: q and dO (2, 32, 4,096, 128), k and v (2, 4,
  4,096, 128), bf16, causal, q, k, v contiguous, dO of unit scale;
* BERT4Rec's training call: (4,096, 2, 200, 32) fp32, non-causal, q, k
  and v the strided (B, S, H·D) views the model passes.

Inputs are drawn from a seed; o and the log-sum-exp come from the
checkout's forward kernel.  With ``--check`` each process also holds the
kernel to its plain version on both calls and on ``chip_smoke.py``'s edge
calls (``bwd_edge_calls``, ``bwd_check``: two launches bit-equal, the
bars of ``chip_smoke.py``), and where the checkout has
``flash_attention_backward_tc_plain`` prints the error of its bf16
rounding of P and dS once and as hi + lo over the bf16 calls.  With
``--profile`` each process also prints, for each call, the device time of
every kernel the backward launches (``torch.profiler`` over 5 calls, the
mean a call, by kernel name).  Prints the card's name and power limit, one
JSON line a run, and the medians of each ROOT.  Needs one card, ``nvcc``
and the checkouts' sources; writes only under each ROOT's ``build/``.
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
NVCC = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                    "bin", "nvcc")

_RUN = r"""
import inspect, json, statistics, sys
root = sys.argv[1]
sys.path[:0] = [root + "/src", root]
import torch
from repro_torch import kernels
from repro_torch.kernels.flash_attention import ops
kernels.extension()
if sys.argv[2] == "build":
    sys.exit(0)
check, profile = "check" in sys.argv[2], "profile" in sys.argv[2]
reps = int(sys.argv[3])
gen = torch.Generator(device="cuda")
gen.manual_seed(11)

def randn(*shape, dt=torch.bfloat16, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dt)

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

def sdpa(q, k, v, do, causal):
    group = q.shape[1] // k.shape[1]
    leaves = [q.detach().requires_grad_(True),
              k.repeat_interleave(group, 1).requires_grad_(True),
              v.repeat_interleave(group, 1).requires_grad_(True)]
    out = torch.nn.functional.scaled_dot_product_attention(
        *leaves, is_causal=causal)
    return lambda: torch.autograd.grad(out, leaves, do, retain_graph=True)

calls = {}
q = randn(2, 32, 4096, 128, scale=0.5)
k = randn(2, 4, 4096, 128, scale=0.5)
v = randn(2, 4, 4096, 128)
o, lse = ops.flash_attention(q, k, v, causal=True, return_lse=True)
calls["yi_bf16"] = ((q, k, v, o, lse, randn(2, 32, 4096, 128)), True)
b, s, h, d = 4096, 200, 2, 32
q, k, v = (randn(b, s, h * d, dt=torch.float32, scale=0.5)
           .view(b, s, h, d).transpose(1, 2) for _ in range(3))
o, lse = ops.flash_attention(q, k, v, causal=False, return_lse=True)
calls["bert4rec_f32"] = ((q, k, v, o, lse,
                          randn(b, h, s, d, dt=torch.float32)), False)
row = {}
for name, (args, causal) in calls.items():
    row[name + "_ms"] = ms(lambda: ops.flash_attention_backward(
        *args, causal=causal))
    row[name + "_sdpa_ms"] = ms(sdpa(args[0], args[1], args[2], args[5],
                                     causal))
if profile:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    for name, (args, causal) in calls.items():
        ops.flash_attention_backward(*args, causal=causal)
        torch.cuda.synchronize()
        with prof_ctx(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                ops.flash_attention_backward(*args, causal=causal)
            torch.cuda.synchronize()
        row[name + "_device_ms"] = {
            e.key[:60]: round(e.device_time_total / 5e3, 4)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.device_time_total > 0}
if check:
    import chip_smoke as cs
    halves = ({1: [], 2: []} if "halves" in
              inspect.signature(cs.bwd_check).parameters else None)
    kw = {} if halves is None else {"halves": halves}
    errs = []
    for name, (args, causal) in calls.items():
        errs.append(cs.bwd_check(name, args, dict(causal=causal), **kw)[0])
    for (q, k, v, do), causal in cs.bwd_edge_calls("cuda"):
        o, lse = ops.flash_attention(q, k, v, causal=causal, return_lse=True)
        errs.append(cs.bwd_check(f"edge {tuple(q.shape)} {tuple(v.shape)} "
                                 f"{q.dtype} causal={causal}",
                                 (q, k, v, o, lse, do), dict(causal=causal),
                                 **kw)[0])
    row["checked_calls"] = len(errs)
    row["worst_err"] = max(errs)
    row["yi_bf16_err"], row["bert4rec_f32_err"] = errs[:2]
    if halves is not None:
        row["halves1_worst"], row["halves2_worst"] = (max(halves[1]),
                                                      max(halves[2]))
        row["halves1_yi_unit_do"], row["halves2_yi_unit_do"] = (
            halves[1][-1], halves[2][-1])
print(json.dumps(row))
"""


def ptxas_report(root: Path) -> subprocess.Popen:
    """Start ``nvcc -Xptxas -v`` on the checkout's backward source."""
    src = root / "src/repro_torch/kernels/flash_attention"
    out = root / "build" / "ab_bwd.o"
    out.parent.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen(
        [NVCC, "-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
         "-Xptxas", "-v", "-c", str(src / "flash_attention_bwd.cu"),
         "-o", str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def kernel_lines(text: str) -> list[str]:
    """ptxas's lines of each ``bwd_*`` kernel instantiation: its name, then
    its stack/spill, register and wgmma (serialization) lines; and any
    compiler error."""
    out, keep = [], False
    for line in text.splitlines():
        if "error" in line.lower() and "ptxas info" not in line:
            out.append(line)
        if "Compiling entry function" in line or "Function properties" in line:
            keep = "bwd_" in line
            if keep and "Compiling entry" in line:
                out.append(line.split("'")[1])
        elif keep and re.search(r"spill|registers|wgmma", line):
            out.append("    " + line.split("ptxas info    :")[-1].strip())
    return out


def main() -> int:
    args = sys.argv[1:]
    mode = "".join(m for m in ("check", "profile") if f"--{m}" in args)
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
    for r, proc in builds.items():
        if proc.wait() != 0:
            print(f"build failed in {r}", flush=True)
            return 1
    results: dict[Path, dict[str, list[float]]] = {r: {} for r in distinct}
    for r in roots:
        done = subprocess.run([sys.executable, "-c", _RUN, str(r),
                               mode or "time", str(REPS)],
                              capture_output=True, text=True)
        if done.returncode != 0:
            print(done.stdout[-2000:], done.stderr[-6000:], flush=True)
            return 1
        row = json.loads(done.stdout.strip().splitlines()[-1])
        for key in ("yi_bf16_ms", "bert4rec_f32_ms"):
            results[r].setdefault(key, []).append(row[key])
        print(json.dumps({"root": str(r), **row}), flush=True)
    for r, res in results.items():
        for key, ms in res.items():
            print(f"{r} {key}: runs {ms}, median {statistics.median(ms)}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
