"""The dry-run cells and the dry run (``repro_torch.launch.steps`` and
``launch/dryrun``, ``isn/shard.build_serve_cell``,
``optimizer.abstract_init``, the models' ``init(..., abstract=True)``)
against the reference.

* **One reference interpreter** (``torch_cells_reference.py``: 512 forced
  host devices, Auto meshes) builds the reference's 82 cells (41 × the
  (16, 16) and (2, 16, 16) meshes) without compiling, and runs the
  numbers cases: each cell's ``fn`` at REDUCED through
  ``config_override``, jitted on small concrete inputs at the case's mesh.
* **Cell parity, all 82**: the port's ``build_cell`` on ``fake`` groups of
  256 and 512 ranks gives every argument leaf's path, shape and dtype,
  every in- and out-sharding's spec, ``donate_argnums``, ``kind``,
  ``family`` and ``meta`` of the reference's cell; the ISN cell's sizes
  (``serve_cell_sizes``) are the keyword arguments the reference's
  ``build_serve_cell`` passes to ``hybrid_serve_fn``.
* **Numbers at (1, 1)** (this process, a world-size-1 gloo group): an LM
  train step with one microbatch and with two, the GNN train step
  partitioned and not, a recsys train, serve and retrieval step, an LM
  prefill and a decode step, each against the reference's ``cell.fn``
  within its family's bar.
* **Four gloo ranks** (``torch_cells_ranks.run_ranks``) at (2, 2) and (1,
  4): the REDUCED Yi train step on DTensors of the cell's in-shardings,
  within the train bar of the (1, 1) result; the REDUCED granite-MoE train
  step (MoE's mesh branch differentiated) against the reference's at the
  same mesh; the ISN cell at ``paper_isn.REDUCED`` equal to
  ``hybrid_serve_fn`` called directly with the reference's sizes at (1, 4)
  — at (2, 2) its 2 × 32 candidates cannot fill k_global 128 and the step
  refuses, as the reference's ``top_k`` would.
* **The dry run's pieces**: ``roofline`` and ``memory_traffic_bytes``
  against the reference's, the collective counter on a ``fake`` group
  against ``test_collective_parser``'s figures, a sharded matmul counted
  at 1/256 of its global FLOPs, a kernel call under a counter taking its
  operator (its FLOP formula), the kernels' fakes refusing on either
  device type what the card refuses, ``exact_costs``' extrapolation equal
  to the full-depth count for an LM, a GNN and a recsys cell, and a record
  with no error for one cell of each (family, kind) on both production
  meshes (a process of its own: ``torch_cells_ranks.py dryrun``).

Bars: LM train 1e-5 on the loss and 5e-3 of each leaf's largest on the
first moment (``test_torch_train.py``'s gradient bar; AdamW's first step
moves a parameter by about lr · sign(g), so parameters are held to 2.2 lr,
with at most 1e-3 of the entries past 1e-5); GNN and recsys 1e-5 on the
loss and 1e-4 on the moment (``test_torch_gnn.py``, ``test_torch_recsys.py``);
serve and retrieval ids exact, scores 1e-5 of the largest; LM prefill and
decode logits and caches 1e-4 of the largest (``test_torch_lm.py``).
"""

import dataclasses
import math
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import paper_isn, registry  # noqa: E402
from repro_torch.configs.shapes import FAMILY_SHAPES  # noqa: E402
from repro_torch.index.builder import build_index  # noqa: E402
from repro_torch.index.corpus import (CorpusParams, build_corpus,  # noqa
                                      build_queries)
from repro_torch.index.postings import shard_layout, shard_ranges  # noqa
from repro_torch.isn import shard as isn_shard  # noqa: E402
from repro_torch.launch import dryrun, steps  # noqa: E402
from repro_torch.launch import mesh as port_mesh  # noqa: E402
from repro_torch.models import gnn, recsys  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402

from torch_cells_ranks import (arrays, run_case, run_ranks,  # noqa: E402
                               walk_paths)

HERE = Path(__file__).resolve().parent
MESHES = {"16x16": (False, 256), "2x16x16": (True, 512)}
LM_GRAD, GRAD, LOSS, OUT = 5e-3, 1e-4, 1e-5, 1e-4

NUMBERS = {   # name: (arch, shape, config fields, rules override, mesh)
    "lm_train_mb1": ("yi_6b", "train_4k", None, None, (1, 1)),
    "lm_train_mb2": ("yi_6b", "train_4k", {"train_microbatches": 2}, None,
                     (1, 1)),
    "gnn_partitioned": ("dimenet", "molecule", None, None, (1, 1)),
    "gnn_unpartitioned": ("dimenet", "molecule", None,
                          {"partition_gnn": False}, (1, 1)),
    "recsys_train": ("deepfm", "train_batch", None, None, (1, 1)),
    "recsys_serve": ("bert4rec", "serve_p99", None, None, (1, 1)),
    "recsys_retrieval": ("xdeepfm", "retrieval_cand", None, None, (1, 1)),
    "lm_prefill": ("yi_6b", "prefill_32k", None, None, (1, 1)),
    "lm_decode": ("yi_6b", "decode_32k", None, None, (1, 1)),
    "granite_2x2": ("granite_moe_3b_a800m", "train_4k", None, None, (2, 2)),
    "granite_1x4": ("granite_moe_3b_a800m", "train_4k", None, None, (1, 4)),
}
# one cell of each (family, kind) for the dry-run records, each on both
# production meshes (the LM cells at REDUCED widths, train and prefill on
# the 256-rank mesh only: on the 512-rank mesh DTensor's redistribution
# planner searches the layouts of their (batch, sequence) tokens for one
# to two minutes a cell on one core, past this file's budget; the full
# dry run records every cell at CONFIG, PERF.md §5), and DimeNet's bf16
# cell on the fp32 graph (JAX's type promotion, ROADMAP §3 closed 16)
DRY = [("yi_6b", "train_4k", True, ("16x16",)),
       ("yi_6b", "prefill_32k", True, ("16x16",)),
       ("yi_6b", "decode_32k", True, ("16x16", "2x16x16")),
       ("dimenet", "molecule", False, ("16x16", "2x16x16")),
       ("dimenet", "ogb_products", False, ("16x16",)),
       ("deepfm", "train_batch", False, ("16x16", "2x16x16")),
       ("bert4rec", "serve_p99", False, ("16x16", "2x16x16")),
       ("deepfm", "retrieval_cand", False, ("16x16", "2x16x16")),
       ("paper_isn", "serve_trace", False, ("16x16", "2x16x16"))]
DRY_CASES = [(a, s, r, m) for a, s, r, meshes in DRY for m in meshes]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: several pytest workers run side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# inputs
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


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    return np.zeros(tree.shape, np.float32)


def _ids(rng, c, rows):
    """CTR ids (rows, n_sparse) with each field's offset applied."""
    return (rng.randint(0, c.rows_per_field, (rows, c.n_sparse))
            + np.arange(c.n_sparse) * c.rows_per_field).astype(np.int32)


def _case(name, rng):
    arch, shape, fields, rules, mesh = NUMBERS[name]
    c, family = registry.get_reduced(arch)
    if fields:
        c = dataclasses.replace(c, **fields)
    shapes = {"lm": tr.param_shapes, "gnn": gnn.param_shapes,
              "recsys": recsys.param_shapes}[family](c)
    params = _draw(shapes, rng)
    case = dict(arch=arch, shape=shape, config=fields, rules=rules,
                mesh=mesh)
    train = FAMILY_SHAPES[family][shape].kind == "train"
    if train:
        case["opt"] = (_zeros_like(params), _zeros_like(params), 0)
    if family == "lm" and train:
        toks = rng.randint(0, c.vocab, (4, 32)).astype(np.int32)
        case["args"] = [params, None, toks, np.roll(toks, -1, 1)]
    elif family == "gnn":
        batch = synthetic.make_molecule_batch(rng, 4, 12, 24, c.d_feat)
        case["args"] = [params, None, batch]
    elif name == "recsys_train":
        case["args"] = [params, None, {
            "ids": _ids(rng, c, 16),
            "label": rng.randint(0, 2, 16).astype(np.int32)}]
    elif name == "recsys_serve":
        case["args"] = [params, rng.randint(0, c.n_items, (4, c.seq_len))
                        .astype(np.int32)]
    elif name == "recsys_retrieval":
        case["args"] = [params, _ids(rng, c, 1024)]
    elif name == "lm_prefill":
        case["args"] = [params, rng.randint(0, c.vocab, (2, 32))
                        .astype(np.int32)]
    else:   # decode
        kv = (c.n_layers, 2, c.n_kv_heads, 32, c.head_dim)
        cache = {k: (rng.randn(*kv) * 0.5).astype(np.float32)
                 for k in ("k", "v")}
        case["args"] = [params,
                        rng.randint(0, c.vocab, 2).astype(np.int32), cache,
                        np.array([5, 17], np.int32)]
    return case


def _isn_inputs(rng):
    """``paper_isn.REDUCED`` over four model shards: an 8,192-doc index cut
    into four shards of 2,048 docs at common capacities and stacked, a
    random depth-5 forest of three targets, and the step's 32 queries."""
    cfg = paper_isn.REDUCED
    corpus = build_corpus(CorpusParams(n_docs=cfg.n_docs, vocab=cfg.vocab,
                                       avg_doclen=40, seed=5))
    index = build_index(corpus, stop_k=8)
    ranges = shard_ranges(index.n_docs, 4)
    natural = [shard_layout(index, lo, hi, cfg.tile_d) for lo, hi in ranges]
    pad = max(len(l.arrays.docs) for l in natural)
    pad = max(pad, max(len(l.arrays.bm_block_id) for l in natural))
    cap = max(l.arrays.tile_docs.shape[1] for l in natural)
    layouts = [shard_layout(index, lo, hi, cfg.tile_d, tile_cap=cap,
                            pad_postings=pad) for lo, hi in ranges]
    stacked = tuple(np.stack([getattr(l.arrays, f) for l in layouts])
                    for f in isn_shard.IndexShard._fields)
    ql = build_queries(corpus, cfg.queries_per_step, max_len=cfg.query_len,
                       stop_k=8, seed=9)
    n_t, depth, n_f, n_b = 64, 5, 147, 64
    fa = (rng.randint(0, n_f, (3, n_t, depth, 16)).astype(np.int32),
          rng.randint(0, n_b, (3, n_t, depth, 16)).astype(np.int32),
          (rng.randn(3, n_t, 2 ** depth) * 0.02).astype(np.float32),
          np.log([1000.0, 2000.0, 150.0]).astype(np.float32),
          np.sort(rng.randn(n_f, n_b - 1).astype(np.float32), axis=1))
    ts = np.stack([index.term_stats.astype(np.float32)] * 4)
    return dict(index=stacked, fa=fa, term_stats=ts,
                terms=ql.terms.astype(np.int32),
                mask=ql.mask.astype(np.float32))


def _inputs():
    rng = np.random.RandomState(0)
    numbers = {name: _case(name, rng) for name in NUMBERS
               if name != "granite_1x4"}
    numbers["granite_1x4"] = dict(numbers["granite_2x2"], mesh=(1, 4))
    # the reference's accumulation reshapes to the cell's own (256, 4096)
    # batch, so its two-microbatch step cannot take a small one: the port's
    # is held to the reference's one-microbatch step on the same batch (the
    # mean of the halves' means, every label counted)
    numbers["lm_train_mb2"] = dict(numbers["lm_train_mb1"],
                                   config={"train_microbatches": 2},
                                   port_only=True)
    return dict(numbers=numbers, yi=numbers["lm_train_mb1"],
                granite=numbers["granite_2x2"],
                isn=_isn_inputs(rng),
                isn_kwargs=isn_shard.serve_cell_sizes(paper_isn.REDUCED, 4))


# ---------------------------------------------------------------------------
# the runs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, the reference's outputs, the port's (1, 1) numbers, every
    rank's outputs at (2, 2) and (1, 4), the dry-run records): the
    reference interpreter and the dry-run process run beside the four
    ranks and this process's (1, 1) cases."""
    tmp = tmp_path_factory.mktemp("cells")
    inputs = _inputs()
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    dry_specs = [(a, s, MESHES[m][0], reduced)
                 for a, s, reduced, m in DRY_CASES]
    with open(tmp / "dry.pkl", "wb") as f:
        pickle.dump(dry_specs, f)
    path = os.pathsep.join([str(HERE.parent / "src"), str(HERE),
                            os.environ.get("PYTHONPATH", "")])
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=path,
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    procs = [subprocess.Popen(
        [sys.executable, str(HERE / "torch_cells_reference.py"),
         str(tmp / "inputs.pkl"), str(tmp / "ref.pkl")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)]
    procs.append(subprocess.Popen(
        [sys.executable, str(HERE / "torch_cells_ranks.py"), "dryrun",
         str(tmp / "dry.pkl"), str(tmp / "dry_out.pkl")],
        env=dict(os.environ, PYTHONPATH=path), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT))
    try:
        ranks = run_ranks(4, tmp / "world4", inputs)
        mesh = port_mesh.make_local_mesh(device="cpu")
        try:
            one = {name: run_case(case, mesh)
                   for name, case in inputs["numbers"].items()
                   if case["mesh"] == (1, 1)}
        finally:
            torch.distributed.destroy_process_group()
        logs = [p.communicate(timeout=400)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log.decode()[-4000:]
    with open(tmp / "ref.pkl", "rb") as f:
        want = pickle.load(f)
    with open(tmp / "dry_out.pkl", "rb") as f:
        dry = pickle.load(f)
    return dict(inputs=inputs, want=want, one=one, ranks=ranks, dry=dry)


# ---------------------------------------------------------------------------
# cell parity
# ---------------------------------------------------------------------------

def _spec(sharding):
    return tuple(tuple(e) if isinstance(e, tuple) else e
                 for e in sharding.spec)


def _record(cell):
    return {
        "args": {p: (tuple(a.shape), str(a.dtype).replace("torch.", ""))
                 for p, a in walk_paths(cell.args).items()},
        "in": {p: _spec(s) for p, s in walk_paths(cell.in_shardings).items()},
        "out": {p: _spec(s) for p, s in walk_paths(cell.out_shardings)
                .items()},
        "donate": tuple(cell.donate_argnums), "kind": cell.kind,
        "family": cell.family, "meta": cell.meta,
    }


@pytest.fixture(scope="module")
def port_cells():
    """Every cell of the port on the production meshes, each over a
    ``fake`` group that the fixture ends."""
    out = {}
    for key, (multi, world) in MESHES.items():
        with dryrun.fake_group(world):
            mesh = port_mesh.make_production_mesh(multi_pod=multi,
                                                  device="cpu", fake=True)
            for arch, shape in registry.all_cells():
                out[arch, shape, key] = _record(
                    steps.build_cell(arch, shape, mesh))
    assert not torch.distributed.is_initialized()
    return out


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch,shape", registry.all_cells(),
                         ids=[f"{a}-{s}" for a, s in registry.all_cells()])
def test_cell_matches_reference(runs, port_cells, arch, shape, mesh):
    got = port_cells[arch, shape, mesh]
    want = runs["want"]["cells"][arch, shape, mesh]
    assert got["args"] == want["args"]
    assert got["in"] == want["in"]
    assert got["out"] == want["out"]
    for key in ("donate", "kind", "family", "meta"):
        assert got[key] == want[key], key


def test_isn_sizes_match_reference(runs):
    kw = runs["want"]["serve_kwargs"]
    assert isn_shard.serve_cell_sizes(paper_isn.CONFIG, 16) == kw["16x16"]
    assert isn_shard.serve_cell_sizes(paper_isn.CONFIG, 16) == kw["2x16x16"]
    assert runs["inputs"]["isn_kwargs"] == kw["reduced_1x4"]


# ---------------------------------------------------------------------------
# numbers
# ---------------------------------------------------------------------------

def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def _close(got, want, rel, what=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want,
                               atol=rel * max(float(np.abs(want).max()),
                                              1e-30), err_msg=what)


def _check_train(got, want, grad_bar):
    assert abs(float(got["loss"]) - float(want["loss"])) <= \
        LOSS * abs(float(want["loss"]))
    assert int(got["step"]) == int(want["step"]) == 1
    lr = float(want["metrics"]["lr"])
    assert abs(float(got["metrics"]["lr"]) - lr) <= 1e-6 * lr
    gn = float(want["metrics"]["grad_norm"])
    assert abs(float(got["metrics"]["grad_norm"]) - gn) <= grad_bar * gn
    m_got, m_want = _flat(got["m"]), _flat(want["m"])
    assert m_got.keys() == m_want.keys()
    for path, w in m_want.items():
        _close(m_got[path], w, grad_bar, path)
    p_got, p_want = _flat(got["params"]), _flat(want["params"])
    assert p_got.keys() == p_want.keys()
    flips = total = 0
    for path, w in p_want.items():
        diff = np.abs(p_got[path].astype(np.float64) - w)
        assert diff.max() <= 2.2 * lr, path
        flips += int((diff > 1e-5).sum())
        total += diff.size
    assert flips <= 1e-3 * total


def _want(runs, name):
    return runs["want"]["numbers"][name]


@pytest.mark.parametrize("name", ["lm_train_mb1", "lm_train_mb2"])
def test_lm_train_step_matches_reference(runs, name):
    _check_train(runs["one"][name], _want(runs, "lm_train_mb1"), LM_GRAD)


@pytest.mark.parametrize("name", ["gnn_partitioned", "gnn_unpartitioned",
                                  "recsys_train"])
def test_train_step_matches_reference(runs, name):
    _check_train(runs["one"][name], _want(runs, name), GRAD)


@pytest.mark.parametrize("name", ["recsys_serve", "recsys_retrieval"])
def test_serve_and_retrieval_match_reference(runs, name):
    got, want = runs["one"][name], _want(runs, name)
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))
    _close(got[0], want[0], LOSS)


def test_prefill_and_decode_match_reference(runs):
    for name in ("lm_prefill", "lm_decode"):
        got, want = runs["one"][name], _want(runs, name)
        _close(got[0], want[0], OUT, name)
        for key, w in want[1].items():
            _close(got[1][key], w, OUT, f"{name} cache {key}")


# ---------------------------------------------------------------------------
# four ranks
# ---------------------------------------------------------------------------

def _same_on_every_rank(runs, shape, key):
    outs = [r[shape][key] for r in runs["ranks"]]
    first = _flat(outs[0]) if isinstance(outs[0], dict) else None
    for o in outs[1:]:
        for path, v in _flat(o).items():
            np.testing.assert_array_equal(v, first[path], err_msg=path)
    return outs[0]


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)], ids=["2x2", "1x4"])
def test_yi_train_on_dtensors_matches_one_rank(runs, shape):
    got = _same_on_every_rank(runs, shape, "yi")
    _check_train(got, runs["one"]["lm_train_mb1"], LM_GRAD)


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)], ids=["2x2", "1x4"])
def test_granite_train_under_a_mesh_matches_reference(runs, shape):
    got = _same_on_every_rank(runs, shape, "granite")
    name = f"granite_{shape[0]}x{shape[1]}"
    _check_train(got, _want(runs, name), LM_GRAD)


def test_isn_cell_matches_the_direct_step(runs):
    for r in runs["ranks"]:
        out = r[(1, 4)]["isn"]
        for got, want in zip(out["cell"], out["direct"]):
            np.testing.assert_array_equal(got, want)
        ids, scores, work, route = out["cell"]
        assert ids.shape == (32, 128) and np.isfinite(scores).all()
        assert "k_global 128 exceeds" in r[(2, 2)]["isn"]["error"]
    first = runs["ranks"][0][(1, 4)]["isn"]["cell"]
    for r in runs["ranks"][1:]:
        for got, want in zip(r[(1, 4)]["isn"]["cell"], first):
            np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the dry run's pieces
# ---------------------------------------------------------------------------

def test_roofline_and_memory_traffic_match_reference():
    from repro.launch import dryrun as ref
    t = dryrun.roofline(dryrun.PEAK_FLOPS, dryrun.HBM_BW, dryrun.NET_BW, 256)
    assert t == {"compute_s": 1.0, "memory_s": 1.0, "collective_s": 1.0}
    assert (dryrun.PEAK_FLOPS, dryrun.HBM_BW, dryrun.NET_BW) == (
        989e12, 3.35e12, 50e9)
    cases = [({"argument_size": 100, "output_size": 50, "temp_size": 25},
              1e9), ({}, 123.0)]
    rng = np.random.RandomState(4)
    for _ in range(50):
        info = {k: int(rng.randint(0, 1000)) for k in
                ("argument_size", "output_size", "temp_size")
                if rng.rand() < 0.8}
        cases.append((info, float(rng.choice([0.0, rng.rand() * 3000]))))
    for info, hlo in cases:
        assert dryrun.memory_traffic_bytes(info, hlo) == \
            ref.memory_traffic_bytes(info, hlo)
        for flops in (0.0, 1e15):
            got = dryrun.roofline(flops, hlo, hlo, 256)
            want = ref.roofline(flops, hlo, hlo, 256)
            assert got["compute_s"] * dryrun.PEAK_FLOPS == pytest.approx(
                want["compute_s"] * ref.PEAK_FLOPS)
            assert got["memory_s"] * dryrun.HBM_BW == pytest.approx(
                want["memory_s"] * ref.HBM_BW)


def test_collective_counter_matches_the_parser_figures():
    """The ops of ``test_collective_parser``, issued on a ``fake`` group
    of 16 ranks: an f32 (16, 128) all-gather, one all-reduce of two bf16
    (64,) tensors, and a u32 (8, 4) permute (a send)."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch._subclasses.fake_tensor import FakeTensorMode
    with dryrun.fake_group(16), FakeTensorMode():
        counter = dryrun.RankCounter()
        with counter:
            out = torch.empty(16, 128)
            dist.all_gather_into_tensor(out, torch.empty(1, 128))
            funcol.all_reduce_coalesced(
                [torch.empty(64, dtype=torch.bfloat16),
                 torch.empty(64, dtype=torch.bfloat16)], "sum",
                dist.group.WORLD)
            dist.send(torch.empty(8, 4, dtype=torch.uint32), dst=1)
    coll = counter.coll
    assert coll["n_ops"] == {"all-gather": 1, "all-reduce": 1,
                             "reduce-scatter": 0, "all-to-all": 0,
                             "collective-permute": 1}
    assert coll["all-gather"] == 16 * 128 * 4
    assert coll["all-reduce"] == 2 * 64 * 2
    assert coll["collective-permute"] == 8 * 4 * 4
    assert coll["total"] == 16 * 128 * 4 + 2 * 64 * 2 + 8 * 4 * 4


def test_sharded_matmul_counts_one_rank():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard
    n = 4096
    with dryrun.fake_group(256):
        mesh = port_mesh.make_production_mesh(device="cpu", fake=True)
        with FakeTensorMode(), dryrun._dtensor_bookkeeping():
            x = DTensor.from_local(torch.empty(n // 16, n), mesh,
                                   [Shard(0), Replicate()], run_check=False,
                                   shape=(n, n), stride=(n, 1))
            w = DTensor.from_local(torch.empty(n, n // 16), mesh,
                                   [Replicate(), Shard(1)], run_check=False,
                                   shape=(n, n), stride=(n, 1))
            counter = dryrun.RankCounter()
            with counter:
                y = x @ w
            assert tuple(y.to_local().shape) == (n // 16, n // 16)
    assert counter.flops == 2 * n ** 3 // 256
    assert counter.coll["total"] == 0


@pytest.mark.parametrize("arch,shape", [("yi_6b", "decode_32k"),
                                        ("dimenet", "molecule"),
                                        ("bert4rec", "serve_p99")])
def test_exact_costs_extrapolate_to_the_full_depth(arch, shape):
    """At CONFIG widths and depth (Yi's 32 layers cut to 4: its depths 2
    and 3 extrapolate to 4 as they would to 32, at an eighth of the
    count's time)."""
    config, family = registry.get_arch(arch)
    field = dryrun._DEPTH_FIELD[family]
    if arch == "yi_6b":
        config = dataclasses.replace(config, n_layers=4)
    with dryrun.fake_group(256):
        mesh = port_mesh.make_production_mesh(device="cpu", fake=True)
        cell = steps.build_cell(arch, shape, mesh, config_override=config)
        m = dryrun.measure(cell, mesh, "cpu")
        ex = dryrun.exact_costs(arch, shape, mesh, cell, device="cpu",
                                full=(m["flops"], m["bytes"],
                                      m["coll"]["total"]), config=config)
    assert ex["equals_full_depth"]
    assert ex["flops"] == m["flops"] > 0
    assert ex["depth"] == getattr(config, field)


def test_kernel_calls_under_a_counter_take_the_operator():
    """Outside a dispatch mode a kernel call on ordinary tensors skips its
    operator (``kernels.direct``); under a counter it takes the operator,
    so the counter sees the kernel's FLOP formula, the dry run's count
    (``chip_smoke.py``'s cells phase holds the dry run's FLOPs to this
    counter on the real step)."""
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import ops as fa
    rng = np.random.RandomState(3)
    q = torch.from_numpy(rng.randn(2, 4, 16).astype(np.float32))
    k, v = (torch.from_numpy(rng.randn(2, 2, 32, 16).astype(np.float32))
            for _ in range(2))
    kv_len = torch.tensor([5, 32], dtype=torch.int32)
    assert kernels.direct(q, k, v, kv_len)
    want = fa.flash_decode(q, k, v, kv_len)
    counter = dryrun.RankCounter()
    with counter:
        assert not kernels.direct(q, k, v, kv_len)
        got = fa.flash_decode(q, k, v, kv_len)
    assert counter.flops == 4 * 4 * 16 * 2 * 32
    assert torch.equal(got, want)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("case,match", [
    ("head_width", "head width"), ("causal", "Sq == Sk"),
    ("topk", "exceeds the kernel's limit"), ("dtype", "must be"),
])
def test_fakes_refuse_what_the_card_refuses(device, case, match):
    """A kernel's fake runs the launch's checks but the device's on either
    device type, so a dry run on the CPU path fails a cell the card would
    refuse (ROADMAP §3 open 2)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels.dense_topk import ops as dense_ops
    from repro_torch.kernels.flash_attention import ops as fa
    with FakeTensorMode(allow_non_fake_inputs=False):
        def t(*shape, dtype=torch.float32):
            return torch.empty(shape, dtype=dtype, device=device)
        calls = {
            "head_width": lambda: fa.flash_attention(
                t(1, 2, 8, 48), t(1, 2, 8, 48), t(1, 2, 8, 48)),
            "causal": lambda: fa.flash_attention(
                t(1, 2, 8, 64), t(1, 2, 16, 64), t(1, 2, 16, 64)),
            "topk": lambda: dense_ops.dense_topk_tiles(
                t(4, 32), t(4096, 32), dense_ops.MAX_K + 1),
            "dtype": lambda: fa.flash_decode(
                t(2, 4, 64, dtype=torch.float16),
                t(2, 2, 32, 64, dtype=torch.float16),
                t(2, 2, 32, 64, dtype=torch.float16),
                t(2, dtype=torch.int32)),
        }
        with pytest.raises(ValueError, match=match):
            calls[case]()


@pytest.mark.parametrize("arch,shape,reduced,mesh", DRY_CASES,
                         ids=[f"{a}-{s}-{m}" for a, s, _, m in DRY_CASES])
def test_dryrun_record_per_family_and_kind(runs, arch, shape, reduced,
                                           mesh):
    multi, world = MESHES[mesh]
    rec = runs["dry"][arch, shape, multi, reduced]
    assert "error" not in rec, rec.get("error")
    assert rec["mesh"] == mesh and rec["n_chips"] == world
    keys = {"arch", "shape", "mesh", "n_chips", "lower_s", "compile_s",
            "flops_per_device", "bytes_per_device", "hlo_bytes_unfused",
            "collective_bytes_per_device", "collective_ops", "memory",
            "roofline", "dominant", "exact", "meta"}
    assert keys <= rec.keys()
    assert rec["flops_per_device"] > 0
    assert set(rec["memory"]) == {"argument_size", "output_size",
                                  "temp_size"}
    assert rec["dominant"] in rec["roofline"]
    assert math.isclose(rec["roofline"]["compute_s"],
                        rec["flops_per_device"] / dryrun.PEAK_FLOPS)
    assert set(rec["collective_ops"]) >= set(dryrun._COLLECTIVES)
