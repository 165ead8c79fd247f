"""The port's side of ``tests/test_torch_mesh.py``: the model code under a
mesh, run on one rank (``port_cases``) and on spawned gloo ranks
(``run_ranks``).

``run_ranks`` spawns one process a rank (``torch.multiprocessing``), each
joining a gloo group over a ``FileStore``; every rank builds each of its
world's meshes ((1, 2) at 2 ranks; (2, 2) and (1, 4) at 4), runs
``port_cases`` under ``launch/mesh.mesh_context`` and writes its outputs.
The parent joins them against a deadline and kills them past it.  This
module imports only the port, so a spawned rank loads neither JAX nor the
reference.
"""

from __future__ import annotations

import pickle
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

RANK_TIMEOUT = timedelta(seconds=60)
AXES = ("data", "model")
MESHES = {1: [(1, 1)], 2: [(1, 2)], 4: [(2, 2), (1, 4)]}


def _t(tree, grad=False):
    """NumPy leaves as CPU tensors (leaves needing a gradient if asked)."""
    if isinstance(tree, dict):
        return {k: _t(v, grad) for k, v in tree.items()}
    return torch.tensor(tree, requires_grad=grad)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.detach().numpy()


def _edge_block(batch: dict, block: int, n_blocks: int) -> dict:
    """This rank's slice of the edge and triplet arrays (the reference's
    ``P(("data", "model"))`` block), the node arrays whole."""
    out = {}
    for k, v in batch.items():
        if k in ("feat", "pos", "node_mask", "target"):
            out[k] = v
        else:
            n = len(v) // n_blocks
            out[k] = v[block * n:(block + 1) * n]
    return out


def port_cases(inputs: dict, mesh, shape: tuple, ckpt_dir: Path) -> dict:
    """Every case of ``inputs`` at mesh ``shape`` on this rank, under
    ``mesh_context(mesh)``: {case name: outputs as NumPy}."""
    from repro_torch.configs import registry
    from repro_torch.configs.shapes import FAMILY_SHAPES, rules_for
    from repro_torch.launch.mesh import mesh_context
    from repro_torch.models import (common, embedding, gnn, moe, recsys,
                                    transformer)
    from repro_torch.train import elastic
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.tree import leaves

    out = {}
    coords = common.mesh_coords(mesh)
    block = coords["data"] * shape[1] + coords["model"]
    with mesh_context(mesh), torch.no_grad():
        for case in inputs["moe"]:
            if case["mesh"] != shape:
                continue
            cfg = moe.MoEConfig(**case["cfg"])
            params, x = _t(case["params"]), _t(case["x"])
            y, aux = moe.moe_forward(params, x, cfg)
            # the same leaves as DTensors under the train rules (experts
            # on "model", the FFN width on "data"): each rank takes its
            # experts from its redistributed shard
            placed = elastic.reshard_tree(
                params, common.leaf_names(moe.moe_shapes(x.shape[1], cfg)),
                rules_for("lm", FAMILY_SHAPES["lm"]["train_4k"]), mesh)
            y_d, _ = moe.moe_forward(placed, x, cfg)
            out[case["name"]] = {"y": y.numpy(), "aux": aux.numpy(),
                                 "y_dtensor": y_d.numpy()}
        for case in inputs["topk"]:
            v, i = recsys.sharded_streaming_topk(
                _t(case["q"]), _t(case["cand"]), case["k"])
            out[case["name"]] = {"vals": v.numpy(), "ids": i.numpy()}
        table, ids = inputs["lookup"]["table"], inputs["lookup"]["ids"]
        rows = len(table) // shape[1]
        local = table[coords["model"] * rows:(coords["model"] + 1) * rows]
        out["lookup"] = {"rows": embedding.sharded_lookup_manual(
            _t(local), _t(ids), "model", rows).numpy()}
        for name, tree in inputs["trees"].items():
            arch, family, cell = tree["arch"], tree["family"], tree["cell"]
            c, _ = registry.get_reduced(arch)
            names = {"lm": transformer, "gnn": gnn,
                     "recsys": recsys}[family].param_names(c)
            rules = rules_for(family, FAMILY_SHAPES[family][cell])
            placed = elastic.reshard_tree(_t(tree["params"]), names, rules,
                                          mesh)
            # the restore onto the same shardings, from a checkpoint that
            # rank 0 writes
            where = ckpt_dir / f"{name}_{shape[0]}x{shape[1]}"
            if dist.get_rank() == 0:
                CheckpointManager(str(where)).save(1, tree["params"])
            dist.barrier()
            _, back, _ = CheckpointManager(str(where)).restore_latest(
                tree["params"], device="cpu", shardings=elastic.sharding_tree(
                    tree["params"], names, rules, mesh))
            out[name] = {
                "local": _flat_local(placed),
                "restored": _flat_local(back),
                "full_equal": all(
                    np.array_equal(d.full_tensor().numpy(), w)
                    for d, w in zip(leaves(placed), leaves(tree["params"])))}
    # MoE's mesh branch differentiated: sum(y · r) + aux, the experts as
    # stacked tensors and as DTensors under the train rules
    for case in inputs["moe"]:
        if case["mesh"] != shape:
            continue
        cfg = moe.MoEConfig(**case["cfg"])
        x = _t(case["x"], grad=True)
        params = _t(case["params"], grad=True)
        with mesh_context(mesh):
            y, aux = moe.moe_forward(params, x, cfg)
            loss = (y * _t(case["r"])).sum() + aux
        loss.backward()
        placed = elastic.reshard_tree(
            _t(case["params"]),
            common.leaf_names(moe.moe_shapes(x.shape[1], cfg)),
            rules_for("lm", FAMILY_SHAPES["lm"]["train_4k"]), mesh)
        placed = {k: v.detach().requires_grad_() for k, v in placed.items()}
        x_d = _t(case["x"], grad=True)
        with mesh_context(mesh):
            y_d, aux_d = moe.moe_forward(placed, x_d, cfg)
            ((y_d * _t(case["r"])).sum() + aux_d).backward()
        out[case["name"]].update(
            loss=loss.detach().numpy(), grads=_np(_grads(params)),
            grad_x=x.grad.numpy(),
            grads_dtensor={k: v.grad.full_tensor().numpy()
                           for k, v in placed.items()},
            grad_x_dtensor=x_d.grad.numpy())
    # the partitioned loss differentiates: no torch.no_grad() here
    g = inputs["gnn"]
    c, _ = registry.get_reduced("dimenet")
    params = _t(g["params"], grad=True)
    batch = _t(_edge_block(g["batches"][shape[0] * shape[1]], block,
                           shape[0] * shape[1]))
    with mesh_context(mesh):
        loss = gnn.loss_fn_partitioned(params, c, batch, AXES)
    loss.backward()
    out["partitioned_loss"] = {"loss": loss.detach().numpy(),
                  "grads": _np(_grads(params))}
    out["coords"] = (coords["data"], coords["model"])
    return out


def _flat_local(tree, prefix="") -> dict:
    """{"a/b": this rank's local block} of a tree of DTensors."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_local(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree.to_local().numpy()}


def _grads(tree):
    if isinstance(tree, dict):
        return {k: _grads(v) for k, v in tree.items()}
    return tree.grad


def _rank_main(rank, world, store_path, out_dir, inputs):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world,
                            timeout=RANK_TIMEOUT)
    try:
        from torch.distributed.device_mesh import init_device_mesh
        outs = {}
        for shape in MESHES[world]:
            mesh = init_device_mesh("cpu", shape, mesh_dim_names=AXES)
            outs[shape] = port_cases(inputs, mesh, shape, Path(out_dir))
        with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(outs, f)
    finally:
        dist.destroy_process_group()


def run_ranks(world, tmp_dir, inputs, deadline_s=120.0):
    """Run ``port_cases`` on ``world`` spawned gloo ranks, at each mesh of
    ``MESHES[world]``; returns each rank's {mesh shape: outputs}.  Raises
    if a rank fails, and kills every rank past ``deadline_s``."""
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
