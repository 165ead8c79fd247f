#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port: one run of one cell.

    python3 portbench/run.py --workload paper_200ms.mq_b32 --seed 7 \
        --seconds 20 --trace 0

From the root of a checkout.  Loads the cell's configuration and traffic
mix (``BENCHMARK.json``), builds and warms the port's system, serves the
mix for ``--seconds`` and checks the answers against the plain reference.
With ``--trace 0`` the result line holds the cell's end-to-end metrics;
with ``--trace 1`` its per-layer metrics, read from a ``torch.profiler``
trace of the window's first seconds.  The compared numbers and their
limits are the last lines of standard error; the result is the last line
of standard output.  Exits 2, printing no result, where the cell's CUDA
devices are not there.
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# the checkout's root and the port's sources; not this directory, whose
# module names are the benchmark's own
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))

from portbench.harness import guard  # noqa: E402

guard.install()


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    if not guard.clean():
        return 3
    from portbench.harness import cell
    try:
        setup = cell.Setup(a.workload)
    except cell.NoChip as e:
        print(e, file=sys.stderr)
        return 2
    result = cell.result(setup, a.seed, a.seconds, bool(a.trace))
    if not guard.clean():
        return 3
    print("window (unix s): %.3f to %.3f" % tuple(setup.window_wall),
          file=sys.stderr)
    cell.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
