"""The port stands alone and runs on the card unless told otherwise.

* Importing every ``repro_torch`` module (and ``chip_smoke.py``) in a fresh
  interpreter loads neither JAX nor any module of the reference package
  ``repro``; no source file of the port imports them.
* With no CUDA device, entry points given no device raise instead of
  falling back to the CPU.
* A kernel wrapper given a tensor that is not on the CPU launches its
  kernel (or raises) and never reaches its plain version.
"""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels
from repro_torch.configs import yi_6b
from repro_torch.configs.cascade_presets import get_preset
from repro_torch.core import linreg, predictors, random_forest
from repro_torch.core.random_forest import RFParams
from repro_torch.index.builder import build_index
from repro_torch.index.corpus import CorpusParams, build_corpus
from repro_torch.index.postings import shard_from_index
from repro_torch.convert import forest_arrays
from repro_torch.isn.backend import resolve_backend, resolve_device
from repro_torch.isn.shard import forest_specs
from repro_torch.kernels.blockmax_score import ops as bm_ops
from repro_torch.kernels.dense_topk import ops as dt_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.impact_accumulate import ops as ia_ops
from repro_torch.kernels.level_histogram import ops as lh_ops
from repro_torch.kernels.qd_feature_gather import ops as qd_ops
from repro_torch.kernels.score_histogram import ops as sh_ops
from repro_torch.kernels.stage0 import ops as s0_ops
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import transformer
from repro_torch.serving.pipeline import CascadePipeline
from repro_torch.serving.scheduler import SchedulerConfig
from repro_torch.serving.server import HybridServer
from repro_torch.serving.system import build_system

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def test_import_loads_no_jax_and_no_reference():
    code = f"""
import importlib, pkgutil, sys
sys.path.insert(0, {str(ROOT / "src")!r})
sys.path.insert(0, {str(ROOT)!r})
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
assert set("repro_torch.serving.online." + m for m in
           ("admission", "batcher", "simulator", "traffic")) <= set(names)
assert set("repro_torch.serving." + m for m in ("cache", "faults")) \
    <= set(names)
assert "repro_torch.index.delta" in names
assert set("repro_torch.serving.telemetry" + m for m in
           ("", ".metrics", ".trace", ".export")) <= set(names)
assert set(["repro_torch.isn.shard", "repro_torch.launch.mesh",
            "repro_torch.configs.paper_isn"]) <= set(names)
assert set("repro_torch.train." + m for m in
           ("checkpoint", "compression", "elastic", "optimizer",
            "train_loop", "tree")) <= set(names)
assert set(["repro_torch.data.synthetic", "repro_torch.data.pipeline",
            "repro_torch.launch.train", "repro_torch.configs.registry"]) \
    <= set(names)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
print(len(names), bad)
assert not bad, bad
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 96


def test_sources_import_nothing_of_jax_or_reference():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    scanned = {str(p.relative_to(PORT)) for p in files if p.is_relative_to(
        PORT)}
    assert {"train/optimizer.py", "train/checkpoint.py",
            "train/train_loop.py", "data/pipeline.py", "data/synthetic.py",
            "launch/train.py"} <= scanned
    for path in files:
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                top = m.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), (path, m)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_refuse_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")
    corpus = build_corpus(CorpusParams(n_docs=512, vocab=256, avg_doclen=20,
                                       seed=2))
    index = build_index(corpus, stop_k=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        shard_from_index(index)
    spec = get_preset("stage1_only")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_system(spec, index, corpus=corpus)
    system = build_system(spec, index, corpus=corpus, device="cpu")
    assert system.device == torch.device("cpu") and system.backend == "torch"
    x = np.random.RandomState(0).rand(40, 5).astype(np.float32)
    for fit in (lambda: random_forest.fit(x, x[:, 0], RFParams(n_trees=2)),
                lambda: linreg.fit(x, x[:, 0]),
                lambda: predictors.cross_val_predict(
                    x, x[:, 0], predictors.PredictorConfig(n_folds=2)),
                lambda: CascadePipeline(index, {}, SchedulerConfig()),
                lambda: HybridServer(index, {}, SchedulerConfig())):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fit()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        transformer.init(yi_6b.REDUCED, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        transformer.init_cache(yi_6b.REDUCED, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_local_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        forest_arrays(forest_specs())


def test_resolve_backend_follows_the_device():
    assert resolve_backend(None, "cpu") == "torch"
    assert resolve_backend(None, "cuda") == "cuda"
    for name in ("pallas", "interpret", "jnp"):
        assert resolve_backend(name, "cpu") == "torch"
        assert resolve_backend(name, "cuda") == "cuda"
    for name in ("cuda", "torch", "triton"):
        with pytest.raises(ValueError):
            resolve_backend(name, "cpu")


class _FakeExtension:
    """Stands in for the compiled module: records launches."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def launch(*args):
            self.calls.append(name)
        return launch


def _calls():
    i32 = torch.int32
    tiles = dict(size=(4, 256), dtype=i32)
    return [
        (ia_ops, "impact_accumulate_plain", lambda d: ia_ops
         .impact_accumulate_batched(
             torch.empty(**tiles, device=d), torch.empty(**tiles, device=d),
             torch.empty(**tiles, device=d),
             torch.empty((3, 5), dtype=i32, device=d),
             torch.empty((3,), dtype=i32, device=d), tile_d=128)),
        (bm_ops, "blockmax_score_plain", lambda d: bm_ops
         .blockmax_score_batched(
             torch.empty(**tiles, device=d), torch.empty(**tiles, device=d),
             torch.empty((4, 256), device=d),
             torch.empty((3, 5), dtype=i32, device=d),
             torch.empty((3, 4, 2), dtype=i32, device=d),
             torch.empty((3, 4), dtype=i32, device=d), tile_d=128,
             block_size=64)),
        (qd_ops, "qd_feature_gather_plain", lambda d: qd_ops
         .qd_feature_gather_lanes(
             torch.empty((3, 512), dtype=i32, device=d),
             torch.empty((3, 512), device=d),
             torch.empty((3, 128), dtype=i32, device=d))),
        (dt_ops, "dense_topk_plain", lambda d: dt_ops.dense_topk(
            torch.empty((3, 32), device=d), torch.empty((1000, 32), device=d),
            128)),
        (ia_ops, "impact_accumulate_bucketed_plain", lambda d: ia_ops
         .impact_accumulate_bucketed(
             torch.empty(**tiles, device=d), torch.empty(**tiles, device=d),
             torch.empty((1,), dtype=i32, device=d), tile_d=128)),
        (bm_ops, "blockmax_score_bucketed_plain", lambda d: bm_ops
         .blockmax_score_bucketed(
             torch.empty(**tiles, device=d), torch.empty((4, 256), device=d),
             torch.empty((4,), dtype=i32, device=d),
             torch.empty((900,), dtype=i32, device=d),
             torch.empty((900,), device=d),
             torch.empty((5,), dtype=i32, device=d), tile_d=128)),
        (sh_ops, "score_histogram_ref", lambda d: sh_ops.score_histogram(
            torch.empty((1000,), dtype=i32, device=d))),
        (fa_ops, "attention_ref", lambda d: fa_ops.flash_attention(
            torch.empty((1, 4, 64, 64), device=d),
            torch.empty((1, 2, 64, 64), device=d),
            torch.empty((1, 2, 64, 64), device=d))),
        (fa_ops, "decode_ref", lambda d: fa_ops.flash_decode(
            torch.empty((1, 4, 64), device=d),
            torch.empty((1, 2, 600, 64), device=d),
            torch.empty((1, 2, 600, 64), device=d),
            torch.empty((1,), dtype=i32, device=d))),
        (lh_ops, "level_histogram_plain", lambda d: lh_ops.level_histogram(
            torch.empty((3, 100), dtype=torch.uint8, device=d),
            torch.empty((100,), dtype=i32, device=d),
            torch.empty((100,), device=d), torch.empty((100,), device=d),
            n_nodes=2, n_bins=64)),
        (lh_ops, "boost_update_plain", lambda d: lh_ops.boost_update(
            torch.empty((100,), device=d), torch.empty((32,), device=d),
            torch.empty((100,), dtype=i32, device=d), 0.15)),
        (fa_ops, "flash_attention_backward_plain", lambda d: fa_ops
         .flash_attention_backward(
             torch.empty((1, 4, 64, 64), device=d),
             torch.empty((1, 2, 64, 64), device=d),
             torch.empty((1, 2, 64, 64), device=d),
             torch.empty((1, 4, 64, 64), device=d),
             torch.empty((1, 4, 64), device=d),
             torch.empty((1, 4, 64, 64), device=d))),
        (lh_ops, "level_split_plain", lambda d: lh_ops.level_split(
            torch.empty((3, 100), dtype=torch.uint8, device=d),
            torch.empty((2, 100), dtype=i32, device=d),
            torch.empty((100,), device=d), torch.empty((2, 100), device=d),
            torch.empty((2, 3), dtype=torch.bool, device=d), n_nodes=4,
            n_bins=64, l2=1.0, min_child_weight=10.0)),
        (lh_ops, "level_route_plain", lambda d: lh_ops.level_route(
            torch.empty((3, 100), dtype=torch.uint8, device=d),
            torch.empty((2, 100), dtype=i32, device=d),
            torch.empty((2, 4, 3), device=d),
            torch.empty((2, 4, 3), dtype=i32, device=d),
            torch.empty((2, 3, 4), dtype=i32, device=d),
            torch.empty((2, 3, 4), dtype=i32, device=d), level=2,
            n_bins=64)),
        (s0_ops, "stage0_features_plain", lambda d: s0_ops.stage0_features(
            torch.empty((10, 36), device=d),
            torch.empty((10,), dtype=i32, device=d),
            torch.empty((3, 5), dtype=i32, device=d),
            torch.empty((3, 5), device=d))),
        (s0_ops, "stage0_forest_plain", lambda d: s0_ops.stage0_forest(
            torch.empty((3, 147), device=d), torch.empty((147, 63), device=d),
            torch.empty((3, 4, 5, 16), dtype=i32, device=d),
            torch.empty((3, 4, 5, 16), dtype=i32, device=d),
            torch.empty((3, 4, 32), device=d), torch.empty((3,), device=d),
            depth=5, expm1=True)),
    ]


def test_device_tensors_never_reach_the_plain_version(monkeypatch):
    fake = _FakeExtension()
    monkeypatch.setattr(kernels, "extension", lambda: fake)
    for mod, plain, call in _calls():
        def refuse(*a, **k):
            raise AssertionError("plain version reached")
        monkeypatch.setattr(mod, plain, refuse)
        # a tensor off the CPU that is not a CUDA tensor: refused, no plain
        with pytest.raises(ValueError, match="CUDA tensor"):
            call("meta")
    assert fake.calls == []
    # past the argument checks the wrapper launches its kernel and counts it
    monkeypatch.setattr(kernels, "check_cuda_args", lambda *a: None)
    monkeypatch.setattr(fa_ops, "_check_kernel_inputs", lambda *a: None)
    kernels.reset_launches()
    for mod, plain, call in _calls():
        call("meta")
    assert fake.calls == ["impact_accumulate", "blockmax_score",
                          "qd_feature_gather", "dense_topk",
                          "impact_accumulate_bucketed",
                          "blockmax_score_bucketed", "score_histogram",
                          "flash_attention", "flash_decode",
                          "level_histogram", "boost_update",
                          "flash_attention_backward", "level_split",
                          "level_route", "stage0_features", "stage0_forest"]
    assert all(n == 1 for n in kernels.LAUNCHES.values())
    kernels.reset_launches()
    # a call under a dispatch mode (the dry run's counter) and a DTensor
    # whose blocks lie off the CPU take the kernel's operator (its fake
    # here, the launch on the card), never the plain sequence
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.launch import dryrun

    class Seen(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(func.name())
            return func(*args, **(kwargs or {}))

    fake.calls.clear()
    i32 = torch.int32
    stage0 = [(plain, call) for mod, plain, call in _calls() if mod is s0_ops]
    shapes = {"stage0_features_plain": (3, 147),
              "stage0_forest_plain": (3, 3)}
    for plain, call in stage0:
        with Seen() as seen:
            out = call("meta")
        assert f"repro_torch::{plain[:-6]}" in seen.ops
        assert out.shape == shapes[plain]
    r, s = Replicate(), Shard(0)
    with dryrun.fake_group(2):
        mesh = DeviceMesh("cpu", [0, 1])

        def dt(shape, place, dtype=torch.float32):
            return DTensor.from_local(
                torch.empty(shape, dtype=dtype, device="meta"), mesh,
                [place], run_check=False)
        feats = s0_ops.stage0_features(
            dt((10, 36), r), dt((10,), r, i32), dt((2, 5), s, i32),
            dt((2, 5), s))
        assert feats.placements == (s,) and feats.shape == (4, 147)
        preds = s0_ops.stage0_forest(
            dt((2, 147), s), dt((147, 63), r), dt((3, 4, 5, 16), r, i32),
            dt((3, 4, 5, 16), r, i32), dt((3, 4, 32), r), dt((3,), r),
            depth=5, expm1=True)
        assert preds.placements == (Shard(1),) and preds.shape == (3, 4)
    assert fake.calls == [] and all(n == 0 for n in kernels.LAUNCHES.values())


def test_mixed_devices_are_refused():
    with pytest.raises(ValueError, match="mix"):
        kernels.on_cpu(torch.zeros(2), torch.empty(2, device="meta"))


def test_cpu_tensors_run_the_plain_version_uncounted():
    kernels.reset_launches()
    docs = torch.tensor([[0, 1, -1, -1]], dtype=torch.int32)
    terms = torch.tensor([[3, 3, -1, -1]], dtype=torch.int32)
    imps = torch.tensor([[5, 7, 0, 0]], dtype=torch.int32)
    out = ia_ops.impact_accumulate_batched(
        docs, terms, imps, torch.tensor([[3, -1]], dtype=torch.int32),
        torch.tensor([6], dtype=torch.int32), tile_d=4)
    np.testing.assert_array_equal(out.numpy(), [[[0, 7, 0, 0]]])
    assert all(n == 0 for n in kernels.LAUNCHES.values())
