"""BERT4Rec's card-vs-CPU check over several seeds, at two inits, on one card.

    python tools/bert4rec_xc_seeds.py [N_SEEDS]

Runs ``chip_smoke.rg_cross_check(dev, "bert4rec", seed, fan_in)`` (CONFIG
widths, n_items 4,096, 8 histories, fp32: the loss and gradients of one
batch on the card and the CPU, one AdamW step, the loss after it) for
``N_SEEDS`` seeds (8 by default: ``chip_smoke.SEED`` and the next ones),
each at the reference's init (stacked block matrices at 1/√n_blocks) and
with them at 1/√(fan-in) (``chip_smoke.fan_in_scale``).  Each run logs
chip_smoke's line (the losses' and the gradients' largest gaps, the
attention rows' largest logits and top-2 gaps) and whether its checks
held under ``TRAIN_LOSS_TOL`` and ``TRAIN_GRAD_TOL``; the last line counts
the runs that held at each init.  Prints the card's name and power limit
first.  Needs one card; builds the kernels under ``build/``.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    n_seeds = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as cs
    from repro_torch import kernels
    kernels.extension()
    dev = torch.device("cuda")
    held = {False: 0, True: 0}
    for i in range(n_seeds):
        for fan_in in (False, True):
            seed = cs.SEED + i
            print(f"seed {seed}, "
                  + ("1/√(fan-in)" if fan_in else "the reference's init"),
                  flush=True)
            try:
                cs.rg_cross_check(dev, "bert4rec", seed, fan_in)
                held[fan_in] += 1
                print("  held", flush=True)
            except cs.SmokeFailure as e:
                print(f"  FAILED: {e}", flush=True)
    print(f"held: the reference's init {held[False]} of {n_seeds}, "
          f"1/√(fan-in) {held[True]} of {n_seeds}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
