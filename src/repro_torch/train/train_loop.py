"""Training loop: gradient accumulation, checkpoint/restart, failure
injection and throughput accounting.

A port of the reference's ``train/train_loop.py``.  The loop takes a
``loss_fn(params, batch)`` and a tree of parameters; ``launch/train.py``
wires it to the LM family.  Where the reference jits the step and takes
gradients with ``jax.value_and_grad``, the port runs eagerly and takes them
with ``torch.autograd.grad`` over the tree's leaves.
"""

from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable

import torch

from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import compression, optimizer
from repro_torch.train.tree import leaves, map_tree


@dataclass
class TrainConfig:
    steps: int = 200
    microbatches: int = 1             # grad accumulation factor
    ckpt_every: int = 50
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    log_every: int = 10
    compress_grads: bool = False
    opt: optimizer.AdamWConfig = field(default_factory=optimizer.AdamWConfig)


def value_and_grad(loss_fn: Callable, params, batch):
    """(loss, gradient tree) of ``loss_fn(params, batch)``, each gradient
    in its parameter's type (zeros where a leaf takes no part)."""
    live = map_tree(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss = loss_fn(live, batch)
        flat = leaves(live)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    by_id = {id(p): (g if g is not None else torch.zeros_like(p))
             for p, g in zip(flat, grads)}
    return loss.detach(), map_tree(lambda p: by_id[id(p)], live)


def _split(batch, n: int, i: int):
    """Microbatch ``i`` of ``n``: rows i·B/n .. (i+1)·B/n of every array."""
    if isinstance(batch, dict):
        return {k: _split(v, n, i) for k, v in batch.items()}
    return batch.reshape((n, batch.shape[0] // n) + tuple(batch.shape[1:]))[i]


def make_train_step(loss_fn: Callable, cfg: TrainConfig):
    """Returns train_step(params, opt, batch) -> (params, opt, loss,
    metrics).

    With microbatches > 1 the batch is cut into that many slices along its
    first axis; their gradients accumulate into an fp32 zero tree and are
    divided by the count, as is the summed loss."""
    def step(params, opt, batch):
        if cfg.microbatches == 1:
            loss, grads = value_and_grad(loss_fn, params, batch)
        else:
            grads = map_tree(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            lsum = 0.0
            for i in range(cfg.microbatches):
                l, g = value_and_grad(loss_fn, params,
                                      _split(batch, cfg.microbatches, i))
                grads = map_tree(torch.add, grads, g)
                lsum = lsum + l
            grads = map_tree(lambda g: g / cfg.microbatches, grads)
            loss = lsum / cfg.microbatches
        if cfg.compress_grads:
            q, _ = compression.compress_grads(
                grads, compression.init_error(grads))
            grads = compression.decompress_grads(q)
        new_p, new_opt, metrics = optimizer.apply(params, grads, opt, cfg.opt)
        return new_p, new_opt, loss, metrics
    return step


def run(params, loss_fn: Callable, data_iter, cfg: TrainConfig,
        resume: bool = True, fail_at: int | None = None):
    """Train with checkpoint/restart. ``fail_at`` injects a crash (tests).
    Checkpoints restore onto the parameters' device."""
    mgr = ckpt_lib.CheckpointManager(cfg.ckpt_dir)
    opt = optimizer.init(params)
    start = 0
    if resume:
        step0, state, extra = mgr.restore_latest(
            {"params": params, "opt_m": opt.m, "opt_v": opt.v},
            device=leaves(params)[0].device)
        if step0 is not None:
            params = state["params"]
            opt = optimizer.OptState(
                state["opt_m"], state["opt_v"],
                torch.tensor(step0, dtype=torch.int32,
                             device=opt.step.device))
            start = step0
            print(f"[train] resumed from step {step0}")

    step_fn = make_train_step(loss_fn, cfg)
    losses = []
    t0 = time.time()
    for step in range(start, cfg.steps):
        batch = next(data_iter)
        params, opt, loss, metrics = step_fn(params, opt, batch)
        losses.append(float(loss))
        if fail_at is not None and step == fail_at:
            mgr.wait()
            raise RuntimeError(f"injected failure at step {step}")
        if (step + 1) % cfg.ckpt_every == 0:
            mgr.save_async(step + 1, {"params": params, "opt_m": opt.m,
                                      "opt_v": opt.v})
        if (step + 1) % cfg.log_every == 0:
            dt = time.time() - t0
            print(f"[train] step {step + 1} loss={float(loss):.4f} "
                  f"({(step + 1 - start) / dt:.2f} steps/s)")
    mgr.wait()
    mgr.save(cfg.steps, {"params": params, "opt_m": opt.m, "opt_v": opt.v})
    return params, opt, losses
