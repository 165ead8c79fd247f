"""How well BERT4Rec's fp32 gradients are conditioned at two inits, on the CPU.

    python tools/bert4rec_conditioning.py [N_SEEDS]

The model of ``chip_smoke.rg_cross_check``'s BERT4Rec check (CONFIG widths:
d 64, 2 heads of 32, 2 blocks, 200 positions; n_items cut to 4,096; 8
histories, 8 masked slots, 256 candidates) is drawn on the CPU for
``N_SEEDS`` seeds (4 by default: ``chip_smoke.SEED`` and the next ones),
each at the reference's init (stacked block matrices at 1/√n_blocks) and
with them at 1/√(fan-in) (``chip_smoke.fan_in_scale``).  For each, the
loss and gradients of one batch in fp32, and again in fp64 from the same
parameters and batch (the port's ``rms_norm`` and ``cross_entropy`` cast
to fp32 as the reference's do; here they are swapped, for this run only,
for copies that keep the input's type).  Prints the loss's relative gap
and the largest gradient gap, each leaf's over its largest fp64
magnitude, with the leaf: the part of a card-vs-CPU gap that fp32 alone
makes.  Runs on the CPU only.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    n_seeds = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    import chip_smoke as cs
    from repro_torch.models import common
    from repro_torch.train import train_loop
    from repro_torch.train.tree import leaves, map_tree

    def rms_norm(x, gamma, eps=1e-6):
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * gamma

    def cross_entropy(logits, labels, vocab):
        if logits.shape[-1] > vocab:
            live = torch.arange(logits.shape[-1]) < vocab
            logits = torch.where(live, logits, -1e30)
        labels = labels.long()
        gold = torch.gather(logits, -1,
                            torch.clamp(labels, min=0)[..., None])[..., 0]
        mask = (labels >= 0).to(logits.dtype)
        return (((torch.logsumexp(logits, -1) - gold) * mask).sum()
                / torch.clamp(mask.sum(), min=1.0))

    @contextlib.contextmanager
    def in_fp64():
        kept = common.rms_norm, common.cross_entropy
        common.rms_norm, common.cross_entropy = rms_norm, cross_entropy
        try:
            yield
        finally:
            common.rms_norm, common.cross_entropy = kept

    c = dataclasses.replace(cs.rg_config("bert4rec", reduced=False),
                            n_items=cs.RG_XC["bert_items"])
    loss_fn = cs.rg_loss("bert4rec", c)
    for fan_in in (False, True):
        for i in range(n_seeds):
            seed = cs.SEED + i
            p32 = cs.rg_init("bert4rec", c, "cpu", fan_in, seed)
            batch = cs.to_device(cs.rg_host_batch(
                "bert4rec", c, cs.RG_XC["bert_batch"], seed % 10_000,
                cs.RG_BERT["xc_cands"]), "cpu")
            l32, g32 = train_loop.value_and_grad(loss_fn, p32, batch)
            with in_fp64():
                l64, g64 = train_loop.value_and_grad(
                    loss_fn, map_tree(torch.Tensor.double, p32), batch)
            assert all(g.dtype == torch.float64 for g in leaves(g64))
            worst, where = 0.0, None
            for (key, x), y in zip(cs.leaves_with_keys(g32), leaves(g64)):
                gap = float((x.double() - y).abs().max() / y.abs().max())
                if gap > worst:
                    worst, where = gap, key
            rel = abs(float(l32) - float(l64)) / abs(float(l64))
            print(f"{'1/√(fan-in)' if fan_in else 'reference init'}, seed "
                  f"{seed}: loss fp32 {float(l32):.7f} fp64 {float(l64):.7f} "
                  f"(relative gap {rel:.3e}); gradients fp32 vs fp64 at "
                  f"most {worst:.3e} of the leaf's largest ({where})",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
