"""The port's logical sharding and model code under a mesh
(``models/common``'s specs, names and placements; ``configs/shapes``;
``launch/mesh.mesh_context``; MoE's mesh branch; ``sharded_streaming_topk``,
``sharded_lookup_manual``, ``loss_fn_partitioned``; ``reshard_tree`` and
the restore onto shardings) against the reference.

* Pure parity, in this process: ``resolve_pspec`` / ``fit_spec_to_shape``
  on hand cases; the shape tables, ``rules_for`` and ``all_cells``; every
  model architecture's names tree (``param_names(CONFIG)`` against
  ``names_tree_of(*init(CONFIG, abstract=True))``); every cell's specs,
  resolved and fitted, on the abstract meshes (1, 1), (16, 16) and (2, 16,
  16) with "pod"; an out-of-order axis tuple refused by ``placements``.
* The mesh cases: one reference interpreter (``torch_mesh_reference.py``,
  four forced host devices, Auto meshes under ``jax.set_mesh``) computes
  every reference output while two gloo spawns (``torch_mesh_ranks.py``: 2
  ranks at (1, 2); 4 at (2, 2) and (1, 4)) and this process (1, 1) run the
  port's: MoE at (1, 1), (1, 2), (1, 4) and (2, 2) with the experts split,
  at (1, 4) with 6 experts (tokens over every axis) and at (2, 2) with 5
  experts and 30 tokens (the "model" token axis dropped), capacity factor 1
  (tokens dropped), the experts given as stacked tensors and as DTensors
  sharded under the train rules; the top-k with tied scores across ranks, at k 5 and at
  k 20 (past a "model" rank's 16 rows); the lookup; the partitioned DimeNet
  loss and its gradients; each rank's block after ``reshard_tree`` (and
  after a restore onto the same shardings) for a REDUCED LM, DimeNet and
  BERT4Rec against ``devices_indices_map``.  At (1, 1) MoE also equals the
  branch without a mesh bit for bit, the top-k ``streaming_topk``, and the
  partitioned loss ``loss_fn`` with its gradients.
* ``common.segment_sum`` against ``jax.ops.segment_sum`` (ids out of range
  dropped, empty segments), and ``constrain``, ``transformer.prefill`` and
  the MoE branch's training gradients at a (1, 1) gloo mesh.
* MoE's mesh branch differentiated: ``value_and_grad`` of sum(y · r) + aux
  at every MoE case's mesh, against JAX's, every gradient leaf on every
  rank (experts stacked and as DTensors); at (1, 1) bit-equal to the
  branch without a mesh.

Bars: MoE's output within 1e-4 of its largest magnitude and its router
loss 1e-6 relative (``test_torch_moe.py``'s); the partitioned loss 1e-5
relative and each gradient leaf 1e-4 of its largest magnitude
(``test_torch_gnn.py``'s); top-k ids, lookups and blocks exact, top-k
scores within 1e-6.  Every rank returns the same bits.
"""

import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import registry as ref_registry
from repro.configs import shapes as ref_shapes
from repro.models import common as ref_common
from repro.models import gnn as ref_gnn
from repro.models import recsys as ref_recsys
from repro.models import transformer as ref_tr
from repro_torch.configs import registry, shapes
from repro_torch.data import synthetic
from repro_torch.launch import mesh as port_mesh
from repro_torch.models import common, gnn, moe, recsys
from repro_torch.models import transformer as tr

from torch_mesh_ranks import port_cases, run_ranks

HERE = Path(__file__).resolve().parent
MODEL_ARCHS = [a for a in registry.ARCH_IDS if a != "paper_isn"]
REF_INIT = {"lm": ref_tr.init, "gnn": ref_gnn.init, "recsys": ref_recsys.init}
PORT_NAMES = {"lm": tr.param_names, "gnn": gnn.param_names,
              "recsys": recsys.param_names}
PORT_SHAPES = {"lm": tr.param_shapes, "gnn": gnn.param_shapes,
               "recsys": recsys.param_shapes}
ABSTRACT = {"1x1": ((1, 1), ("data", "model")),
            "16x16": ((16, 16), ("data", "model")),
            "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
MESHES = [(1, 1), (1, 2), (2, 2), (1, 4)]
REL, AUX_REL, LOSS_REL, GRAD_REL, SCORE_TOL = 1e-4, 1e-6, 1e-5, 1e-4, 1e-6

D_MODEL = 16
MOE8 = dict(n_experts=8, top_k=2, d_ff_expert=8, n_shared=0,
            capacity_factor=1.0, router_aux_weight=0.01)
MOE_CASES = {                    # name: (mesh, config, tokens)
    "moe_1x1": ((1, 1), MOE8, 32),
    "moe_ep_1x2": ((1, 2), MOE8, 32),
    "moe_ep_1x4": ((1, 4), MOE8, 32),
    "moe_tokens_1x4": ((1, 4), dict(MOE8, n_experts=6), 32),
    "moe_ep_shared_2x2": ((2, 2), dict(MOE8, n_shared=1), 32),
    "moe_axis_dropped_2x2": ((2, 2), dict(MOE8, n_experts=5), 30),
}
TOPK_CASES = {"topk_k5": 5, "topk_k20": 20}
TREES = {"lm": ("granite_moe_3b_a800m", "lm", "train_4k"),
         "gnn": ("dimenet", "gnn", "full_graph_sm"),
         "recsys": ("bert4rec", "recsys", "train_batch")}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: several pytest workers run side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _walk(tree, prefix=""):
    """{"a/b": leaf} of a nested dict."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_walk(v, f"{prefix}/{k}" if prefix else k))
    return out


def _jax_mesh(key):
    sizes, names = ABSTRACT[key]
    return jax.sharding.AbstractMesh(sizes, names)


def _port_mesh(key):
    sizes, names = ABSTRACT[key]
    return common.AbstractMesh(names, sizes)


# ---------------------------------------------------------------------------
# pure parity
# ---------------------------------------------------------------------------

HAND = {  # names, rules, mesh, shape, resolved, fitted
    "pod_dropped": (("batch", "embed"), common.DEFAULT_RULES, "16x16",
                    (32, 8), ("data", None), ("data", None)),
    "pod_kept": (("batch", "embed"), common.DEFAULT_RULES, "2x16x16",
                 (64, 8), (("pod", "data"), None), (("pod", "data"), None)),
    "axis_reused": (("heads", "ffn", "vocab"), common.DEFAULT_RULES, "16x16",
                    (32, 32, 32), ("model", None, None),
                    ("model", None, None)),
    "not_divisible": (("batch", "heads"), common.DEFAULT_RULES, "16x16",
                      (24, 48), ("data", "model"), (None, "model")),
    "tuple_not_divisible": (("batch", None), shapes.rules_for(
        "lm", shapes.LM_SHAPES["train_4k"]), "2x16x16", (256, 3),
        (("pod", "data", "model"), None), (None, None)),
    "tuple_partly_absent": (("nodes",), common.DEFAULT_RULES, "16x16",
                            (512,), (("data", "model"),), (("data", "model"),)),
}


@pytest.mark.parametrize("case", sorted(HAND))
def test_resolve_and_fit_hand_cases(case):
    names, rules, mesh, shape, resolved, fitted = HAND[case]
    got = common.resolve_pspec(names, rules, _port_mesh(mesh))
    want = ref_common.resolve_pspec(names, rules, _jax_mesh(mesh))
    assert tuple(got) == tuple(want) == resolved
    got_fit = common.fit_spec_to_shape(got, shape, _port_mesh(mesh))
    want_fit = ref_common.fit_spec_to_shape(want, shape, _jax_mesh(mesh))
    assert tuple(got_fit) == tuple(want_fit) == fitted


def test_shape_tables_and_rules_match_reference():
    for family, table in ref_shapes.FAMILY_SHAPES.items():
        got = shapes.FAMILY_SHAPES[family]
        assert list(got) == list(table)
        for name, cell in table.items():
            assert dataclasses.asdict(got[name]) == dataclasses.asdict(cell)
            assert shapes.extras_dict(got[name]) == ref_shapes.extras_dict(
                cell)
            assert shapes.rules_for(family, got[name]) == \
                ref_shapes.rules_for(family, cell)
    assert shapes.LM_TRAIN_TPSP == ref_shapes.LM_TRAIN_TPSP
    assert common.DEFAULT_RULES == ref_common.DEFAULT_RULES
    with pytest.raises(ValueError):
        shapes.rules_for("vision", shapes.LM_SHAPES["train_4k"])


def test_all_cells_match_reference():
    assert registry.all_cells() == ref_registry.all_cells()
    assert len(registry.all_cells()) == 41


def _ref_names(arch, which="CONFIG"):
    get = ref_registry.get_arch if which == "CONFIG" else \
        ref_registry.get_reduced
    c, family = get(arch)
    params, names = REF_INIT[family](c, abstract=True)
    return (_walk(ref_common.names_tree_of(params, names)),
            {k: tuple(v.shape) for k, v in _walk(params).items()})


@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_param_names_match_reference(arch):
    c, family = registry.get_arch(arch)
    want, _ = _ref_names(arch)
    names = PORT_NAMES[family](c)
    got = _walk(names)
    assert got == want
    # the flat {"a/b": names} form back onto the parameter tree
    assert common.names_tree_of(PORT_SHAPES[family](c), got) == names


@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_cell_specs_match_reference(arch):
    """Every cell of ``arch``, every leaf, resolved and fitted, on the
    three abstract meshes."""
    c, family = registry.get_arch(arch)
    want_names, leaf_shapes = _ref_names(arch)
    names = PORT_NAMES[family](c)
    cells = [s for a, s in registry.all_cells() if a == arch]
    assert cells == list(shapes.FAMILY_SHAPES[family])
    for cell in cells:
        rules = shapes.rules_for(family, shapes.FAMILY_SHAPES[family][cell])
        ref_rules = ref_shapes.rules_for(family,
                                         ref_shapes.FAMILY_SHAPES[family][cell])
        for key in ABSTRACT:
            got = _walk(common.tree_pspecs(names, rules, _port_mesh(key)))
            want = _walk(ref_common.tree_pspecs(
                ref_common.names_tree_of(*REF_INIT[family](
                    ref_registry.get_arch(arch)[0], abstract=True)),
                ref_rules, _jax_mesh(key)))
            assert got.keys() == want.keys() == want_names.keys()
            for path, spec in got.items():
                assert tuple(spec) == tuple(want[path]), (cell, key, path)
                fit = common.fit_spec_to_shape(spec, leaf_shapes[path],
                                               _port_mesh(key))
                ref_fit = ref_common.fit_spec_to_shape(
                    want[path], leaf_shapes[path], _jax_mesh(key))
                assert tuple(fit) == tuple(ref_fit), (cell, key, path)


def test_placements_follow_the_mesh_order():
    mesh = common.AbstractMesh(("pod", "data", "model"), (2, 2, 2))
    got = common.placements(common.P(("pod", "model"), None, "data"), mesh)
    assert got == [common.Shard(0), common.Shard(2), common.Shard(0)]
    assert common.placements(common.P(), mesh) == [common.Replicate()] * 3
    with pytest.raises(ValueError, match="out of the mesh's order"):
        common.placements(common.P(("model", "data")), mesh)


# ---------------------------------------------------------------------------
# the mesh cases: reference interpreter, gloo ranks, this process
# ---------------------------------------------------------------------------

def _draw(tree, rng):
    """NumPy values of a ``Leaf`` tree at its fills and scales."""
    if isinstance(tree, dict):
        return {k: _draw(v, rng) for k, v in tree.items()}
    if tree.fill == "zeros":
        return np.zeros(tree.shape, np.float32)
    if tree.fill == "ones":
        return np.ones(tree.shape, np.float32)
    return (rng.randn(*tree.shape) * tree.scale).astype(np.float32)


def _partition(host, n):
    """The molecule batch's edges in ``n`` equal blocks of whole graphs,
    each block's valid triplets local to it (padded with masked ones),
    edge indices local, node ids global."""
    e = host["edge_src"].shape[0]
    per = e // n
    ji, kj, tm = host["trip_ji"], host["trip_kj"], host["trip_mask"]
    parts = []
    for r in range(n):
        sel = ji // per == r
        k_ = np.where(tm[sel] > 0, kj[sel] - r * per, 0)
        assert np.all((k_ >= 0) & (k_ < per))
        parts.append((k_, ji[sel] - r * per, tm[sel]))
    t = max(len(p[0]) for p in parts)

    def pad(a, dtype):
        return np.concatenate([a, np.zeros(t - len(a), a.dtype)]).astype(
            dtype)
    out = {k: host[k] for k in ("feat", "pos", "node_mask", "target",
                                "edge_src", "edge_dst", "edge_mask")}
    out["trip_kj"] = np.concatenate([pad(p[0], np.int32) for p in parts])
    out["trip_ji"] = np.concatenate([pad(p[1], np.int32) for p in parts])
    out["trip_mask"] = np.concatenate([pad(p[2], np.float32)
                                       for p in parts])
    return out


def _inputs():
    rng = np.random.RandomState(0)
    moe_cases = []
    for name, (mesh, cfg, t) in MOE_CASES.items():
        shapes_ = moe.moe_shapes(D_MODEL, moe.MoEConfig(**cfg))
        params = _draw(shapes_, rng)
        params["router"] = (rng.randn(D_MODEL, cfg["n_experts"])
                            * 0.5).astype(np.float32)
        moe_cases.append(dict(name=name, mesh=mesh, cfg=cfg, params=params,
                              x=rng.randn(t, D_MODEL).astype(np.float32)))
    for case in moe_cases:
        case["r"] = rng.randn(*case["x"].shape).astype(np.float32)
    # quantized scores with rows repeated across "model" ranks: exact ties
    # between ranks and inside one
    cand = (np.round(rng.randn(64, 16) * 4) / 4).astype(np.float32)
    cand[32:40] = cand[0:8]
    cand[20] = cand[3]
    q = (np.round(rng.randn(8, 16) * 2) / 2).astype(np.float32)
    topk = [dict(name=name, q=q, cand=cand, k=k)
            for name, k in TOPK_CASES.items()]
    lookup = dict(table=rng.randn(32, 8).astype(np.float32),
                  ids=rng.randint(0, 32, (6, 3)).astype(np.int32))
    c, _ = registry.get_reduced("dimenet")
    host = synthetic.make_molecule_batch(np.random.RandomState(1), 4, 12, 24,
                                         c.d_feat)
    gnn_in = dict(params=_draw(gnn.param_shapes(c), rng),
                  batches={n: _partition(host, n) for n in (1, 2, 4)})
    trees = {}
    for name, (arch, family, cell) in TREES.items():
        rc, _ = registry.get_reduced(arch)
        mod = {"lm": tr, "gnn": gnn, "recsys": recsys}[family]
        trees[name] = dict(arch=arch, family=family, cell=cell,
                           params=_draw(mod.param_shapes(rc), rng))
    return dict(moe=moe_cases, topk=topk, lookup=lookup, gnn=gnn_in,
                trees=trees, meshes=MESHES)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, {mesh: every rank's port outputs}, the reference's
    outputs): the reference interpreter runs beside the two gloo spawns and
    this process's (1, 1) mesh."""
    tmp = tmp_path_factory.mktemp("mesh")
    inputs = _inputs()
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   [str(HERE.parent / "src"), os.environ.get("PYTHONPATH",
                                                              "")]))
    ref = subprocess.Popen(
        [sys.executable, str(HERE / "torch_mesh_reference.py"),
         str(tmp / "inputs.pkl"), str(tmp / "ref.pkl")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        ranks = {w: run_ranks(w, tmp / f"world{w}", inputs) for w in (2, 4)}
        mesh = port_mesh.make_local_mesh(device="cpu")
        try:
            one = port_cases(inputs, mesh, (1, 1), tmp)
        finally:
            torch.distributed.destroy_process_group()
        log, _ = ref.communicate(timeout=300)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, log.decode()[-4000:]
    with open(tmp / "ref.pkl", "rb") as f:
        want = pickle.load(f)
    port = {(1, 1): [one], (1, 2): [r[(1, 2)] for r in ranks[2]],
            (2, 2): [r[(2, 2)] for r in ranks[4]],
            (1, 4): [r[(1, 4)] for r in ranks[4]]}
    return inputs, port, want


def _same_on_every_rank(outs, key):
    first = _walk(outs[0][key])
    for o in outs[1:]:
        for path, v in _walk(o[key]).items():
            np.testing.assert_array_equal(v, first[path], err_msg=path)
    return outs[0][key]


def _close(got, want, rel):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, atol=rel * np.abs(want).max())


@pytest.mark.parametrize("name", sorted(MOE_CASES))
def test_moe_under_a_mesh_matches_reference(runs, name):
    inputs, port, want = runs
    mesh, cfg, t = MOE_CASES[name]
    got = _same_on_every_rank(port[mesh], name)
    ref = want[name, mesh]
    assert got["y"].shape == (t, D_MODEL)
    _close(got["y"], ref["y"], REL)
    np.testing.assert_array_equal(got["y_dtensor"], got["y"])
    np.testing.assert_allclose(got["aux"], ref["aux"],
                               atol=AUX_REL * abs(float(ref["aux"])))
    # the capacity comes from the local token count: pairs are dropped
    case = next(c for c in inputs["moe"] if c["name"] == name)
    cfg = moe.MoEConfig(**cfg)
    plan = moe.mesh_plan(t, cfg, dict(zip(("data", "model"), mesh)))
    x, router = torch.from_numpy(case["x"]), torch.from_numpy(
        case["params"]["router"])
    dropped = 0
    for b in range(t // plan.t_local):
        xb = x[b * plan.t_local:(b + 1) * plan.t_local]
        _, _, tope = moe.route(router, xb, cfg)
        dropped += int((~moe.kept(tope, cfg.n_experts, plan.cap)).sum())
    assert dropped > 0
    if mesh == (1, 1):
        with torch.no_grad():
            y, aux = moe.moe_forward(
                {k: torch.from_numpy(v) for k, v in case["params"].items()},
                x, cfg)
        np.testing.assert_array_equal(got["y"], y.numpy())
        np.testing.assert_array_equal(got["aux"], aux.numpy())


@pytest.mark.parametrize("name", sorted(MOE_CASES))
def test_moe_gradients_under_a_mesh_match_reference(runs, name):
    """``value_and_grad`` of sum(y · r) + aux through the mesh branch: the
    loss and every gradient leaf (router, experts, shared experts, x) on
    every rank within the branch's bars of JAX's, the experts given as
    stacked tensors and as DTensors; at (1, 1) bit-equal to the branch
    without a mesh."""
    inputs, port, want = runs
    mesh, cfg, t = MOE_CASES[name]
    got = _same_on_every_rank(port[mesh], name)
    ref = want[name, mesh]
    np.testing.assert_allclose(got["loss"], ref["loss"],
                               rtol=AUX_REL, atol=AUX_REL)
    assert got["grads"].keys() == ref["grads"].keys()
    for key, g in got["grads"].items():
        _close(g, ref["grads"][key], REL)
        _close(got["grads_dtensor"][key], ref["grads"][key], REL)
    _close(got["grad_x"], ref["grad_x"], REL)
    _close(got["grad_x_dtensor"], ref["grad_x"], REL)
    if mesh == (1, 1):
        case = next(c for c in inputs["moe"] if c["name"] == name)
        params = {k: torch.tensor(v, requires_grad=True)
                  for k, v in case["params"].items()}
        x = torch.tensor(case["x"], requires_grad=True)
        y, aux = moe.moe_forward(params, x, moe.MoEConfig(**cfg))
        loss = (y * torch.from_numpy(case["r"])).sum() + aux
        loss.backward()
        np.testing.assert_array_equal(got["loss"], loss.detach().numpy())
        np.testing.assert_array_equal(got["grad_x"], x.grad.numpy())
        for key, v in params.items():
            np.testing.assert_array_equal(got["grads"][key], v.grad.numpy(),
                                          err_msg=key)


def test_moe_plans_match_the_cases():
    """The split each case was built to reach."""
    plans = {name: moe.mesh_plan(t, moe.MoEConfig(**cfg),
                                 dict(zip(("data", "model"), mesh)))
             for name, (mesh, cfg, t) in MOE_CASES.items()}
    assert plans["moe_ep_1x4"] == moe.MeshPlan(True, ("data",), 32, 2, 8)
    assert plans["moe_tokens_1x4"] == moe.MeshPlan(False, ("data", "model"),
                                                   8, 6, 4)
    assert plans["moe_ep_shared_2x2"] == moe.MeshPlan(True, ("data",), 16,
                                                      4, 4)
    assert plans["moe_axis_dropped_2x2"] == moe.MeshPlan(False, ("data",),
                                                         15, 5, 6)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("name", sorted(TOPK_CASES))
def test_sharded_topk_matches_reference(runs, name, mesh):
    inputs, port, want = runs
    got = _same_on_every_rank(port[mesh], name)
    ref = want[name, mesh]
    np.testing.assert_array_equal(got["ids"], ref["ids"])
    np.testing.assert_allclose(got["vals"], ref["vals"], atol=SCORE_TOL)
    case = next(c for c in inputs["topk"] if c["name"] == name)
    v, i = recsys.streaming_topk(torch.from_numpy(case["q"]),
                                 torch.from_numpy(case["cand"]), case["k"])
    np.testing.assert_array_equal(got["ids"], i.numpy())
    if mesh == (1, 1):
        np.testing.assert_array_equal(got["vals"], v.numpy())


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_lookup_matches_reference(runs, mesh):
    inputs, port, want = runs
    got = _same_on_every_rank(port[mesh], "lookup")
    np.testing.assert_array_equal(got["rows"], want["lookup", mesh]["rows"])
    lk = inputs["lookup"]
    np.testing.assert_array_equal(got["rows"], lk["table"][lk["ids"]])


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_partitioned_loss_matches_reference(runs, mesh):
    inputs, port, want = runs
    got = _same_on_every_rank(port[mesh], "partitioned_loss")
    ref = want["partitioned_loss", mesh]
    np.testing.assert_allclose(got["loss"], ref["loss"],
                               rtol=LOSS_REL)
    ref_grads = _walk(ref["grads"])
    grads = _walk(got["grads"])
    assert grads.keys() == ref_grads.keys()
    for path, g in grads.items():
        _close(g, ref_grads[path], GRAD_REL)
    if mesh == (1, 1):
        c, _ = registry.get_reduced("dimenet")
        params = {k: v for k, v in _walk(inputs["gnn"]["params"]).items()}
        leaves = {k: torch.tensor(v, requires_grad=True)
                  for k, v in params.items()}
        tree = {}
        for k, v in leaves.items():
            node = tree
            *head, last = k.split("/")
            for h in head:
                node = node.setdefault(h, {})
            node[last] = v
        batch = {k: torch.from_numpy(v)
                 for k, v in inputs["gnn"]["batches"][1].items()}
        loss = gnn.loss_fn(tree, c, batch)
        loss.backward()
        np.testing.assert_array_equal(got["loss"], loss.detach().numpy())
        for k, v in leaves.items():
            np.testing.assert_array_equal(grads[k], v.grad.numpy(),
                                          err_msg=k)


@pytest.mark.parametrize("mesh", MESHES[1:], ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("tree", sorted(TREES))
def test_reshard_blocks_match_jax(runs, tree, mesh):
    """Each rank's block of every leaf, after ``reshard_tree`` and after a
    restore onto the same shardings, is the block JAX's
    ``devices_indices_map`` gives the device at its mesh coordinates."""
    inputs, port, want = runs
    whole = _walk(inputs["trees"][tree]["params"])
    blocks = want[tree, mesh]
    assert blocks.keys() == whole.keys()
    split = 0
    for out in port[mesh]:
        coord = out["coords"]
        got = out[tree]
        assert got["full_equal"]
        for path, value in whole.items():
            idx = tuple(slice(a, b) for a, b in blocks[path][coord])
            np.testing.assert_array_equal(got["local"][path], value[idx],
                                          err_msg=path)
            np.testing.assert_array_equal(got["restored"][path], value[idx],
                                          err_msg=path)
            split += got["local"][path].shape != value.shape
    assert split > 0 or tree == "gnn"


@pytest.mark.parametrize("tree", sorted(TREES))
def test_reshard_at_one_rank_keeps_each_leaf_whole(runs, tree):
    inputs, port, _ = runs
    got = port[(1, 1)][0][tree]
    for path, value in _walk(inputs["trees"][tree]["params"]).items():
        np.testing.assert_array_equal(got["local"][path], value)
        np.testing.assert_array_equal(got["restored"][path], value)


# ---------------------------------------------------------------------------
# segment sums and the model code at a (1, 1) mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_segments", [1, 7, 40])
def test_segment_sum_matches_reference(n_segments):
    """Ids past the segments (and negative ones) dropped, empty segments
    zero, each segment summed in row order as the reference's."""
    rng = np.random.RandomState(n_segments)
    data = rng.randn(200, 5).astype(np.float32)
    ids = rng.randint(-2, n_segments + 3, 200).astype(np.int32)
    want = jax.jit(jax.ops.segment_sum, static_argnums=2)(
        jnp.asarray(data), jnp.asarray(ids), n_segments)
    got = common.segment_sum(torch.from_numpy(data), torch.from_numpy(ids),
                             n_segments)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    x = torch.from_numpy(data).requires_grad_()
    common.segment_sum(x, torch.from_numpy(ids), n_segments).sum().backward()
    live = (ids >= 0) & (ids < n_segments)
    np.testing.assert_array_equal(x.grad.numpy(),
                                  np.repeat(live[:, None], 5, 1).astype(
                                      np.float32))


@pytest.fixture
def local_mesh():
    mesh = port_mesh.make_local_mesh(device="cpu")
    yield mesh
    torch.distributed.destroy_process_group()


def test_model_code_at_a_one_rank_mesh(local_mesh):
    """``mesh_context`` puts the mesh in scope; ``constrain`` leaves plain
    tensors and redistributes a DTensor; granite-MoE's prefill under the
    mesh (its MoE mesh branch) equals the prefill without one bit for bit;
    granite-MoE's loss and gradients under the mesh equal those without
    one bit for bit."""
    assert common.get_abstract_mesh_or_none() is None
    x = torch.randn(4, 6)
    with port_mesh.mesh_context(local_mesh):
        assert common.get_abstract_mesh_or_none() is local_mesh
        assert common.constrain(x, ("batch", "embed"),
                                common.DEFAULT_RULES) is x
        d = common.distribute(x, common.NamedSharding(local_mesh,
                                                      common.P("data")))
        got = common.constrain(d, ("batch", "embed"), {"batch": None})
        assert got.placements == (common.Replicate(),) * 2
        assert torch.equal(got.to_local(), x)
    assert common.get_abstract_mesh_or_none() is None

    c, _ = registry.get_reduced("granite_moe_3b_a800m")
    c = dataclasses.replace(c, moe=c.moe._replace(capacity_factor=1.0))
    params = tr.init(c, seed=1, device="cpu")
    toks = torch.from_numpy(np.random.RandomState(2).randint(
        0, c.vocab, (2, 24)))
    with torch.no_grad():
        want, want_cache = tr.prefill(params, c, toks)
        with port_mesh.mesh_context(local_mesh):
            got, cache = tr.prefill(params, c, toks,
                                    rules=shapes.rules_for(
                                        "lm", shapes.LM_SHAPES["prefill_32k"]))
    assert torch.equal(got, want)
    for k in cache:
        assert torch.equal(cache[k], want_cache[k])
    # the branch's backward: loss and every gradient leaf bit-equal to the
    # training step without a mesh
    from repro_torch.train import train_loop
    from repro_torch.train.tree import leaves

    def loss(p, batch):
        return tr.loss_fn(p, c, batch, batch)

    want_loss, want_grads = train_loop.value_and_grad(loss, params, toks)
    with port_mesh.mesh_context(local_mesh):
        got_loss, got_grads = train_loop.value_and_grad(loss, params, toks)
    assert torch.equal(got_loss, want_loss)
    for g, w in zip(leaves(got_grads), leaves(want_grads)):
        assert torch.equal(g, w)
