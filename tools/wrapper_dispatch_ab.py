"""The host cost of the kernel wrappers, timed in two or more checkouts on
one card.

    python tools/wrapper_dispatch_ab.py ROOT [ROOT ...]

Each ROOT is a checkout that holds ``src/repro_torch``.  First each
distinct ROOT's kernels are built into its own ``build/kernels``, all at
once.  Then one process a ROOT, in the order given (list a checkout twice,
as A B B A, to see the card and host drift between runs), times four
wrapper calls of the main path, each at a small input so that the host,
not the card, sets the pace:

* ``flash_decode`` (kernel 9) at one layer of Yi-6B's decode step: q (4,
  32, 128), caches (4, 4, 1,024, 128), bf16;
* ``flash_attention`` (kernel 8) at one layer of granite-MoE's prefill
  cut to 128 tokens: q (4, 24, 128, 64), k and v (4, 8, 128, 64), bf16,
  causal;
* ``dense_topk_tiles`` (kernel 6): 32 queries over 8,192 docs, d 32, k 10;
* ``recsys.anytime_retrieval`` (kernel 6): one query over 131,072
  candidates, d 256, the budget a Python int (500), k 100.

For each: the host's microseconds a call (``time.perf_counter`` over 200
calls issued back to back, then one synchronize; the median of 7 such
rounds after a warm-up round) and the card's (CUDA events around the same
200 calls).  Prints the card's name and power limit, one JSON line a run,
and each ROOT's medians.  Needs one card and ``nvcc``; writes only under
each ROOT's ``build/``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

_RUN = r"""
import json, statistics, sys, time
sys.path.insert(0, sys.argv[1] + "/src")
import torch
from repro_torch import kernels
kernels.extension()
if sys.argv[2] == "build":
    sys.exit(0)
from repro_torch.kernels.dense_topk import ops as dense_ops
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.models import recsys
gen = torch.Generator(device="cuda")
gen.manual_seed(11)
def randn(*shape, dtype=torch.bfloat16, scale=0.5):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)
qd, kd, vd = randn(4, 32, 128), randn(4, 4, 1024, 128), randn(4, 4, 1024, 128)
kv_len = torch.full((4,), 1000, dtype=torch.int32, device="cuda")
qp, kp, vp = randn(4, 24, 128, 64), randn(4, 8, 128, 64), randn(4, 8, 128, 64)
qe = randn(32, 32, dtype=torch.float32)
de = randn(8192, 32, dtype=torch.float32)
qa = randn(1, 256, dtype=torch.float32)
ca = randn(131072, 256, dtype=torch.float32)
calls = {
    "flash_decode": lambda: fa.flash_decode(qd, kd, vd, kv_len),
    "flash_attention": lambda: fa.flash_attention(qp, kp, vp, causal=True),
    "dense_topk_tiles": lambda: dense_ops.dense_topk_tiles(qe, de, 10),
    "anytime_retrieval": lambda: recsys.anytime_retrieval(qa, ca, 500, 100),
}
N, ROUNDS = 200, 7
out = {}
for name, f in calls.items():
    host, card = [], []
    for r in range(ROUNDS + 1):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        start.record()
        for _ in range(N):
            f()
        end.record()
        h = time.perf_counter() - t
        torch.cuda.synchronize()
        if r:
            host.append(h / N * 1e6)
            card.append(start.elapsed_time(end) / N * 1e3)
    out[name] = {"host_us": statistics.median(host),
                 "card_us": statistics.median(card)}
print(json.dumps(out))
"""


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
    builds = {r: subprocess.Popen([sys.executable, "-c", _RUN, str(r),
                                   "build"]) for r in distinct}
    for r, proc in builds.items():
        if proc.wait() != 0:
            print(f"build failed in {r}", flush=True)
            return 1
    results: dict[Path, list[dict]] = {r: [] for r in distinct}
    for r in roots:
        done = subprocess.run([sys.executable, "-c", _RUN, str(r), "time"],
                              capture_output=True, text=True)
        if done.returncode != 0:
            print(done.stderr[-4000:], flush=True)
            return 1
        row = json.loads(done.stdout.strip().splitlines()[-1])
        results[r].append(row)
        print(json.dumps({"root": str(r), **row}), flush=True)
    for r, rows in results.items():
        for call in rows[0]:
            host = [row[call]["host_us"] for row in rows]
            card = [row[call]["card_us"] for row in rows]
            print(f"{r} {call}: host us a call {host}, card us {card}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
