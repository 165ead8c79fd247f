"""The port's side of ``tests/test_torch_cells.py`` that runs outside the
test process: the cells on four spawned gloo ranks (``run_ranks``) and
the dry-run records on the production meshes (``python
tests/torch_cells_ranks.py dryrun specs.pkl out.pkl``, a process of its
own, since its ``fake`` group of 256 or 512 ranks would take the test
process's default group).  This module imports only the port, so neither
a rank nor the dry run loads JAX or the reference.
"""

from __future__ import annotations

import dataclasses
import pickle
import sys
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

RANK_TIMEOUT = timedelta(seconds=60)
AXES = ("data", "model")
MESHES = [(2, 2), (1, 4)]


def walk_paths(tree, prefix=""):
    """{path: leaf} over dicts, tuples and NamedTuples (fields by name), as
    the reference's side walks its cells."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(walk_paths(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (tuple, list)):
        names = getattr(tree, "_fields", None) or range(len(tree))
        out = {}
        for k, v in zip(names, tree):
            out.update(walk_paths(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def tensors(tree):
    """NumPy leaves (dicts, tuples, NamedTuples) as CPU tensors."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tensors(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        items = [tensors(v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else \
            type(tree)(items)
    return torch.from_numpy(np.array(tree))


def arrays(tree):
    """Tensor leaves (DTensors gathered whole) as NumPy."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        return {k: arrays(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return [arrays(v) for v in tree]
    if isinstance(tree, DTensor):
        tree = tree.full_tensor()
    return tree.detach().numpy() if isinstance(tree, torch.Tensor) else tree


def train_args(case):
    """A train case's arguments: (params, AdamW state, *batch) tensors."""
    from repro_torch.train import optimizer
    m, v, step = case["opt"]
    args = [tensors(a) for a in case["args"]]
    args[1] = optimizer.OptState(tensors(m), tensors(v),
                                 torch.tensor(step, dtype=torch.int32))
    return args


def train_out(out) -> dict:
    new_p, opt, loss, metrics = out
    return {"params": arrays(new_p), "m": arrays(opt.m), "v": arrays(opt.v),
            "step": arrays(opt.step), "loss": arrays(loss),
            "metrics": arrays(metrics)}


def run_case(case, mesh, distribute: bool = False):
    """The port's cell of ``case`` (REDUCED, with the case's fields) on
    ``mesh``, its ``fn`` called on the case's inputs under the mesh: whole
    tensors on every rank, or with ``distribute`` DTensors of the cell's
    in-shardings."""
    from repro_torch.configs import registry
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import mesh_context
    from repro_torch.models import common

    c, _ = registry.get_reduced(case["arch"])
    if case.get("config"):
        c = dataclasses.replace(c, **case["config"])
    cell = steps.build_cell(case["arch"], case["shape"], mesh,
                            rules_override=case.get("rules"),
                            config_override=c)
    train = cell.kind == "train"
    args = train_args(case) if train else [tensors(a) for a in case["args"]]
    if distribute:
        args = _distribute(args, cell.in_shardings, common)
    with mesh_context(mesh):
        out = cell.fn(*args)
    return train_out(out) if train else arrays(out)


def _distribute(args, shardings, common):
    if isinstance(args, dict):
        return {k: _distribute(v, shardings[k], common)
                for k, v in args.items()}
    if isinstance(args, (tuple, list)):
        items = [_distribute(a, s, common) for a, s in zip(args, shardings)]
        return type(args)(*items) if hasattr(args, "_fields") else \
            type(args)(items)
    return common.distribute(args, shardings)


def isn_case(inputs, mesh):
    """The ISN cell at ``paper_isn.REDUCED`` on ``mesh`` from the whole
    stacked index, and ``hybrid_serve_fn`` called directly on this rank's
    pieces (``rank_inputs``) with the reference's recorded sizes."""
    from repro_torch.configs import registry
    from repro_torch.isn import shard
    from repro_torch.launch import steps

    isn = inputs["isn"]
    c, _ = registry.get_reduced("paper_isn")
    cell = steps.build_cell("paper_isn", "serve_trace", mesh,
                            config_override=c)
    index = shard.IndexShard(*(torch.from_numpy(a) for a in isn["index"]))
    fa = shard.ForestArrays(*(torch.from_numpy(a) for a in isn["fa"]))
    ts, terms, mask = (torch.from_numpy(isn[k])
                       for k in ("term_stats", "terms", "mask"))
    try:
        got = cell.fn(index, fa, ts, terms, mask)
    except ValueError as e:
        return {"error": str(e)}
    pieces = shard.rank_inputs(mesh, shard.IndexShard(*isn["index"]),
                               isn["term_stats"], isn["terms"], isn["mask"])
    direct = shard.hybrid_serve_fn(mesh, **inputs["isn_kwargs"])(
        pieces[0], fa, *pieces[1:])
    return {"cell": arrays(got), "direct": arrays(direct)}


def _rank_main(rank, world, store_path, out_dir, inputs):
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world,
                            timeout=RANK_TIMEOUT)
    try:
        outs = {}
        for shape in MESHES:
            mesh = init_device_mesh("cpu", shape, mesh_dim_names=AXES)
            coords = tuple(mesh.get_coordinate())
            outs[shape] = {
                "coords": coords,
                "yi": run_case(inputs["yi"], mesh, distribute=True),
                "granite": run_case(inputs["granite"], mesh),
                "isn": isn_case(inputs, mesh),
            }
        with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(outs, f)
    finally:
        dist.destroy_process_group()


def run_ranks(world, tmp_dir, inputs, deadline_s=150.0):
    """Run the cases on ``world`` spawned gloo ranks at each mesh of
    ``MESHES``; returns each rank's {mesh shape: outputs}.  Raises if a
    rank fails, and kills every rank past ``deadline_s``."""
    tmp_dir = Path(tmp_dir)
    tmp_dir.mkdir(parents=True, exist_ok=True)
    ctx = mp.start_processes(_rank_main,
                             args=(world, str(tmp_dir / "store"),
                                   str(tmp_dir), inputs),
                             nprocs=world, join=False, start_method="spawn")
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
    out = []
    for r in range(world):
        with open(tmp_dir / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def dryrun_records(specs) -> dict:
    """{spec: the dry run's record, or its error} for each (arch, shape,
    multi_pod, reduced) of ``specs``, on the fake CPU path without the
    two-depth extrapolation; one ``fake`` group a mesh."""
    from repro_torch.configs import registry
    from repro_torch.launch import dryrun

    torch.set_num_threads(1)
    out = {}
    for multi in (False, True):
        mine = [s for s in specs if s[2] == multi]
        if not mine:
            continue
        with dryrun.fake_group(512 if multi else 256):
            for spec in mine:
                arch, shape, _, reduced = spec
                c = registry.get_reduced(arch)[0] if reduced else None
                try:
                    out[spec] = dryrun.run_cell(arch, shape, multi,
                                                exact=False, device="cpu",
                                                config_override=c)
                except Exception as e:  # the record carries the error
                    out[spec] = {"error": f"{type(e).__name__}: {e}"}
    return out


if __name__ == "__main__":
    if sys.argv[1] == "dryrun":
        with open(sys.argv[2], "rb") as f:
            specs = pickle.load(f)
        records = dryrun_records(specs)
        with open(sys.argv[3], "wb") as f:
            pickle.dump(records, f)
