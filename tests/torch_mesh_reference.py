"""The reference's side of ``tests/test_torch_mesh.py``, in an interpreter
of its own with four forced host devices:

    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \\
        python tests/torch_mesh_reference.py inputs.pkl outputs.pkl

It runs every mesh case of ``inputs.pkl`` through the reference and writes
the outputs.  The meshes are ``jax.make_mesh`` meshes with Auto axes,
entered with ``jax.set_mesh`` around each jitted call: the reference's own
``launch/mesh.mesh_context`` fails on JAX 0.9 (``make_mesh`` makes
Explicit axes, where ``with_sharding_constraint`` asserts, and the
abstract mesh alone finds no device assignment; ROADMAP §3).  The
functions that the reference runs inside ``shard_map``
(``loss_fn_partitioned``, ``sharded_lookup_manual``) run in an explicit
``shard_map``, the partitioned loss as ``launch/steps.py:298-313`` builds
it.  Each reshard case gives, for every leaf's fitted spec, the block that
``NamedSharding(mesh, spec).devices_indices_map(shape)`` gives the device
at each mesh coordinate.
"""

import os
import pickle
import sys

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=4")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.experimental.shard_map import shard_map as _shard_map  # noqa
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import registry, shapes  # noqa: E402
from repro.models import common, embedding, gnn, moe, recsys  # noqa: E402
from repro.models import transformer  # noqa: E402

AXES = ("data", "model")
INIT = {"lm": transformer.init, "gnn": gnn.init, "recsys": recsys.init}


def make_mesh(shape):
    n = shape[0] * shape[1]
    return jax.make_mesh(shape, AXES,
                         axis_types=(jax.sharding.AxisType.Auto,) * 2,
                         devices=jax.devices()[:n])


def shard_map(fn, mesh, in_specs, out_specs):
    """The reference's ``shard_map`` call (``launch/steps.py:308-311``)."""
    return _shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                      check_rep=False)


def _walk(tree, prefix=""):
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_walk(v, f"{prefix}/{k}" if prefix else k))
    return out


def moe_case(case):
    """The branch's outputs, and ``value_and_grad`` of sum(y · r) + aux
    with respect to the parameters and x."""
    cfg = moe.MoEConfig(**case["cfg"])
    fn = jax.jit(lambda p, x: moe.moe_forward(p, x, cfg))

    def loss(p, x):
        y, aux = moe.moe_forward(p, x, cfg)
        return jnp.sum(y * jnp.asarray(case["r"])) + aux

    grad_fn = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))
    params = jax.tree.map(jnp.asarray, case["params"])
    with jax.set_mesh(make_mesh(case["mesh"])):
        y, aux = fn(params, jnp.asarray(case["x"]))
        value, (g_params, g_x) = grad_fn(params, jnp.asarray(case["x"]))
    return {"y": np.asarray(y), "aux": np.asarray(aux),
            "loss": np.asarray(value),
            "grads": {k: np.asarray(v) for k, v in g_params.items()},
            "grad_x": np.asarray(g_x)}


def topk_case(case, shape):
    fn = jax.jit(lambda q, c: recsys.sharded_streaming_topk(q, c,
                                                            case["k"]))
    with jax.set_mesh(make_mesh(shape)):
        v, i = fn(jnp.asarray(case["q"]), jnp.asarray(case["cand"]))
    return {"vals": np.asarray(v), "ids": np.asarray(i)}


def lookup_case(inputs, shape):
    mesh = make_mesh(shape)
    table, ids = inputs["table"], inputs["ids"]
    rows = len(table) // shape[1]
    fn = jax.jit(shard_map(
        lambda t, i: embedding.sharded_lookup_manual(t, i, "model", rows),
        mesh, (P("model", None), P()), P()))
    with jax.set_mesh(mesh):
        return {"rows": np.asarray(fn(jnp.asarray(table), jnp.asarray(ids)))}


def gnn_case(g, shape):
    c, _ = registry.get_reduced("dimenet")
    mesh = make_mesh(shape)
    batch = g["batches"][shape[0] * shape[1]]
    edge_keys = ("edge_src", "edge_dst", "trip_kj", "trip_ji", "edge_mask",
                 "trip_mask")
    b_specs = {k: (P(AXES) if k in edge_keys else P()) for k in batch}

    def loss_sharded(params, b):
        return shard_map(
            lambda p, b_: gnn.loss_fn_partitioned(p, c, b_, AXES),
            mesh, (P(), b_specs), P())(params, b)

    with jax.set_mesh(mesh):
        loss, grads = jax.jit(jax.value_and_grad(loss_sharded))(
            jax.tree.map(jnp.asarray, g["params"]),
            jax.tree.map(jnp.asarray, batch))
    return {"loss": np.asarray(loss),
            "grads": jax.tree.map(np.asarray, grads)}


def blocks_case(tree, shape):
    """{leaf path: {mesh coordinate: ((start, stop) a dimension)}} of each
    leaf's fitted spec."""
    c, family = registry.get_reduced(tree["arch"])
    params, names = INIT[family](c, abstract=True)
    names = _walk(common.names_tree_of(params, names))
    rules = shapes.rules_for(family, shapes.FAMILY_SHAPES[family][tree["cell"]])
    mesh = make_mesh(shape)
    coords = {d: tuple(int(i) for i in np.argwhere(mesh.devices == d)[0])
              for d in mesh.devices.flat}
    out = {}
    for path, leaf in _walk(params).items():
        spec = common.fit_spec_to_shape(
            common.resolve_pspec(names[path], rules, mesh), leaf.shape, mesh)
        idx = jax.sharding.NamedSharding(mesh, spec).devices_indices_map(
            leaf.shape)
        out[path] = {coords[d]: tuple(s.indices(n)[:2]
                                      for s, n in zip(sl, leaf.shape))
                     for d, sl in idx.items()}
    return out


def main(src, dst):
    with open(src, "rb") as f:
        inputs = pickle.load(f)
    out = {}
    for case in inputs["moe"]:
        out[case["name"], case["mesh"]] = moe_case(case)
    for shape in inputs["meshes"]:
        for case in inputs["topk"]:
            out[case["name"], shape] = topk_case(case, shape)
        out["lookup", shape] = lookup_case(inputs["lookup"], shape)
        out["partitioned_loss", shape] = gnn_case(inputs["gnn"], shape)
        for name, tree in inputs["trees"].items():
            if shape != (1, 1):
                out[name, shape] = blocks_case(tree, shape)
    with open(dst, "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main(*sys.argv[1:3])
