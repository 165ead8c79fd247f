"""Training entry point: ``python -m repro_torch.launch.train --arch <id> ...``

A port of the reference's ``launch/train.py``: a real (reduced-config by
default) training job of the LM family with the full loop — gradient
accumulation, checkpoint/restart, the resumable data cursor — printing the
reference's ``[train]`` lines.  It runs on the card unless ``--device``
names another device (the tests pass ``--device cpu``); ``devices=`` counts
the port's devices of that kind.  The checkpoint directory defaults to one
under the temporary directory.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi_6b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--full-config", action="store_true",
                    help="use the production config (needs a real cluster)")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--resume", action="store_true", default=True)
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a crash at this step (restart testing)")
    ap.add_argument("--device", default=None,
                    help="the device to train on (default: the card)")
    args = ap.parse_args(argv)

    from repro_torch.configs import registry
    from repro_torch.data import synthetic
    from repro_torch.data.pipeline import PrefetchingLoader
    from repro_torch.isn.backend import resolve_device
    from repro_torch.models import transformer as tr
    from repro_torch.train import train_loop
    from repro_torch.train.tree import leaves

    config, family = (registry.get_arch if args.full_config
                      else registry.get_reduced)(args.arch)
    if family != "lm":
        raise SystemExit("train.py drives the LM family; see examples/ for "
                         "gnn/recsys training drivers")
    dev = resolve_device(args.device)
    n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1

    params = tr.init(config, 0, device=dev)
    n_params = sum(p.numel() for p in leaves(params))
    print(f"[train] arch={config.name} params={n_params/1e6:.1f}M "
          f"devices={n_dev}")

    def loss_fn(params, batch):
        return tr.loss_fn(params, config, batch["tokens"], batch["labels"])

    gen = synthetic.lm_batches(config.vocab, args.batch, args.seq)
    loader = PrefetchingLoader(gen, device=dev)
    cfg = train_loop.TrainConfig(steps=args.steps,
                                 microbatches=args.microbatches,
                                 ckpt_dir=args.ckpt_dir)
    params, opt, losses = train_loop.run(params, loss_fn, loader, cfg,
                                         resume=args.resume,
                                         fail_at=args.fail_at)
    print(f"[train] done: loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    loader.close()


if __name__ == "__main__":
    main()
