#!/usr/bin/env python3
"""The readings that a cell's limits are set from: the program's numbers
over many seeds and the control's, in one process.

    python3 portbench/control.py --workload paper_200ms.mq_b32 \
        --seeds 11,12,13 --seconds 5

For each seed: the cell's warm-up and a window of ``--seconds`` at its own
load, then the numbers compared twice for the same sampled answers: the
program's outputs against the plain reference (the lower readings), and
the control's, the reference computed in bfloat16 in the program's place
(the upper readings).  One JSON line a seed, then the largest program
reading and the smallest control reading of each number.  The
benchmark's own runs do not run this.
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))

from portbench.harness import guard  # noqa: E402

guard.install()


def readings(setup, seeds, seconds, out=print) -> dict:
    """{"program": {number: [reading a seed]}, "control": {...}}."""
    import torch

    from portbench.harness.cell import judge
    ref, ref_dev = setup.reference()
    got = {"program": {}, "control": {}}
    for seed in seeds:
        setup.measure(seed, seconds, False)
        sut = setup.sut
        state, kept = sut.state(), list(sut.kept)
        line = {"seed": seed, "answers": len(kept)}
        for side, dtype in (("program", torch.float32),
                            ("control", torch.bfloat16)):
            nums = judge(setup.mod, setup.cfg, state, kept, ref, ref_dev,
                         setup.corpus, dtype, setup.memo)
            line[side] = nums
            for k, v in nums.items():
                got[side].setdefault(k, []).append(v)
        out(line)
    return got


def main(argv=None) -> int:
    import argparse
    import json
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated seeds")
    p.add_argument("--seconds", type=float, default=5.0)
    a = p.parse_args(argv)
    from portbench.harness.cell import NoChip, Setup
    try:
        setup = Setup(a.workload)
    except NoChip as e:
        print(e, file=sys.stderr)
        return 2
    got = readings(setup, [int(s) for s in a.seeds.split(",")], a.seconds,
                   lambda line: print(json.dumps(line), flush=True))
    setup.sut.close()
    if not guard.clean():
        return 3
    summary = {k: {"lower": max(got["program"][k]),
                   "upper": min(got["control"][k])
                   if k in got["control"] else None}
               for k in got["program"]}
    print(json.dumps({"workload": a.workload, "readings": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
