"""Rank processes of the port's distributed ISN step, for
``tests/test_torch_isn.py``.

``run_ranks`` spawns one process a rank (``torch.multiprocessing``), each
joining a gloo group over a ``FileStore`` and serving its pieces through
``repro_torch.isn.shard.hybrid_serve_fn``; it joins them against a
deadline and kills them past it.  This module imports only the port, so a
spawned rank loads neither JAX nor the reference.
"""

from __future__ import annotations

import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

RANK_TIMEOUT = timedelta(seconds=60)


def _rank_main(rank, world, store_path, out_dir, model_axis, layouts, fa,
               term_stats, terms, mask, sizes):
    from repro_torch.index.postings import shard_to_device
    from repro_torch.isn.shard import ForestArrays, hybrid_serve_fn
    from repro_torch.launch.mesh import make_local_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world,
                            timeout=RANK_TIMEOUT)
    try:
        mesh = make_local_mesh(model_axis, device="cpu")
        m = mesh.get_local_rank("model")
        d, n_data = mesh.get_local_rank("data"), mesh.shape[0]
        shard, _ = shard_to_device(layouts[m], "cpu")
        q = len(terms) // n_data
        rows = slice(d * q, (d + 1) * q)
        serve = hybrid_serve_fn(mesh, **sizes)
        out = serve(shard, ForestArrays(*map(torch.from_numpy, fa)),
                    torch.from_numpy(term_stats),
                    torch.from_numpy(terms[rows]),
                    torch.from_numpy(mask[rows]))
        np.savez(Path(out_dir) / f"rank{rank}.npz",
                 **dict(zip(("ids", "scores", "work", "route"),
                            (t.numpy() for t in out))),
                 coord=np.array([d, m]))
    finally:
        dist.destroy_process_group()


def run_ranks(world, model_axis, tmp_dir, layouts, fa, term_stats, terms,
              mask, sizes, deadline_s=120.0):
    """Serve one step on ``world`` spawned gloo ranks of a (world //
    model_axis, model_axis) mesh; returns each rank's outputs as a dict
    (ids, scores, work, route, coord = (data rank, model rank)).  Raises
    if a rank fails, and kills every rank past ``deadline_s``."""
    tmp_dir = Path(tmp_dir)
    tmp_dir.mkdir(parents=True, exist_ok=True)
    args = (world, str(tmp_dir / "store"), str(tmp_dir), model_axis,
            layouts, tuple(np.asarray(a) for a in fa), term_stats, terms,
            mask, sizes)
    ctx = mp.start_processes(_rank_main, args=args, nprocs=world,
                             join=False, start_method="spawn")
    end = time.monotonic() + deadline_s
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > end:
                raise TimeoutError(f"{world} ranks still running after "
                                   f"{deadline_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
    return [dict(np.load(tmp_dir / f"rank{r}.npz")) for r in range(world)]
