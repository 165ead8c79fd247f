"""The reference's side of ``tests/test_torch_cells.py``, in an interpreter
of its own with 512 forced host devices:

    XLA_FLAGS=--xla_force_host_platform_device_count=512 JAX_PLATFORMS=cpu \\
        python tests/torch_cells_reference.py inputs.pkl outputs.pkl

It builds every cell of ``all_cells()`` with the reference's
``launch/steps.build_cell`` on Auto meshes of (16, 16) and (2, 16, 16)
devices, without compiling, and records each cell's argument leaves (path,
shape, dtype), its in- and out-shardings' specs, ``donate_argnums``,
``kind``, ``family`` and ``meta``, and the keyword arguments that
``build_serve_cell`` passes to ``hybrid_serve_fn``.  Then it runs each
numbers case of ``inputs.pkl``: the cell of (arch, shape) at its REDUCED
configuration (``config_override``, with the case's fields replaced) on
an Auto mesh of the case's shape, its ``fn`` jitted and called on the
case's concrete inputs under ``jax.set_mesh`` (the reference's own
``mesh_context`` fails on JAX 0.9: ROADMAP §3 open 14).
"""

import dataclasses
import os
import pickle
import sys

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=512")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import registry  # noqa: E402
from repro.isn import shard as isn_shard  # noqa: E402
from repro.launch import steps  # noqa: E402
from repro.train import optimizer  # noqa: E402

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def make_mesh(shape, names=("data", "model")):
    n = int(np.prod(shape))
    return jax.make_mesh(shape, names,
                         axis_types=(jax.sharding.AxisType.Auto,) * len(shape),
                         devices=jax.devices()[:n])


def walk(tree, prefix=""):
    """{path: leaf} over dicts, tuples and NamedTuples (fields by name)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(walk(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (tuple, list)):
        names = getattr(tree, "_fields", None) or range(len(tree))
        out = {}
        for k, v in zip(names, tree):
            out.update(walk(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def spec_of(sharding):
    return tuple(tuple(e) if isinstance(e, tuple) else e
                 for e in sharding.spec)


def record(cell):
    return {
        "args": {p: (tuple(a.shape), str(np.dtype(a.dtype)))
                 for p, a in walk(cell.args).items()},
        "in": {p: spec_of(s) for p, s in walk(cell.in_shardings).items()},
        "out": {p: spec_of(s) for p, s in walk(cell.out_shardings).items()},
        "donate": tuple(cell.donate_argnums), "kind": cell.kind,
        "family": cell.family, "meta": cell.meta,
    }


def build_all():
    cells, serve_kwargs = {}, {}
    real = isn_shard.hybrid_serve_fn

    def spy(mesh, **kw):
        serve_kwargs[spy.key] = kw
        return real(mesh, **kw)

    isn_shard.hybrid_serve_fn = spy
    try:
        for key, (shape, names) in MESHES.items():
            mesh = make_mesh(shape, names)
            for arch, cell_name in registry.all_cells():
                spy.key = key
                cells[arch, cell_name, key] = record(
                    steps.build_cell(arch, cell_name, mesh))
        # the ISN cell at REDUCED on the ranks' (1, 4) mesh
        spy.key = "reduced_1x4"
        c, _ = registry.get_reduced("paper_isn")
        steps.build_cell("paper_isn", "serve_trace", make_mesh((1, 4)),
                         config_override=c)
    finally:
        isn_shard.hybrid_serve_fn = real
    return cells, serve_kwargs


def tree(x):
    if isinstance(x, dict):
        return {k: tree(v) for k, v in x.items()}
    return jnp.asarray(x)


def numbers(case):
    c, _ = registry.get_reduced(case["arch"])
    if case.get("config"):
        c = dataclasses.replace(c, **case["config"])
    mesh = make_mesh(case["mesh"])
    cell = steps.build_cell(case["arch"], case["shape"], mesh,
                            rules_override=case.get("rules"),
                            config_override=c)
    args = [None if a is None else tree(a) for a in case["args"]]
    if cell.kind == "train":
        m, v, step = case["opt"]
        args[1] = optimizer.OptState(tree(m), tree(v),
                                     jnp.asarray(step, jnp.int32))
    with jax.set_mesh(mesh):
        out = jax.tree.map(np.asarray, jax.jit(cell.fn)(*args))
    if cell.kind == "train":
        new_p, opt, loss, metrics = out
        return {"params": new_p, "m": opt.m, "v": opt.v, "step": opt.step,
                "loss": loss, "metrics": metrics}
    return out


def main(src, dst):
    with open(src, "rb") as f:
        inputs = pickle.load(f)
    cells, serve_kwargs = build_all()
    out = {"cells": cells, "serve_kwargs": serve_kwargs, "numbers": {}}
    for name, case in inputs["numbers"].items():
        if not case.get("port_only"):
            out["numbers"][name] = numbers(case)
    with open(dst, "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main(*sys.argv[1:3])
