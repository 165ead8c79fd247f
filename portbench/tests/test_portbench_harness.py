"""The benchmark's harness on the CPU: parts found by name, traffic from
the seed, work counted from the inputs alone, the import guard, and the
result line."""

import json
import shutil
import subprocess
import sys

import numpy as np
import pytest

from portbench_small import ROOT, make_small

from portbench.harness import guard, registry, traffic
from portbench.data.corpus import CorpusParams, build_corpus


def test_every_part_is_found_by_name():
    bench = registry.load_benchmark()
    for w in bench["workloads"]:
        cfg, mod = registry.config(bench, w["config"])
        assert cfg["name"] == w["config"]
        for fn in ("build", "outputs", "program_outputs", "numbers",
                   "traced_work"):
            assert callable(getattr(mod, fn))
        assert registry.traffic(w["traffic"])["batch"] > 0
        assert registry.metrics_of(bench, w["name"], "end_to_end")
        for m in registry.metrics_of(bench, w["name"], "per_layer"):
            assert m["moves"] == "qps"
            assert callable(registry.reader(m["name"]).read)


def test_new_parts_are_added_as_files(tmp_path):
    """A configuration, a traffic mix and a per-layer metric added as new
    files and entries, no file edited."""
    bench_dir = make_small(tmp_path)
    (bench_dir / "traffic" / "mq_b8.json").write_text(json.dumps(
        {**registry.traffic("mq_b32", bench_dir), "batch": 8}))
    shutil.copy(bench_dir / "configs" / "paper_200ms.json",
                bench_dir / "configs" / "paper_200ms_b.json")
    shutil.copy(bench_dir / "configs" / "paper_200ms.py",
                bench_dir / "configs" / "paper_200ms_b.py")
    (bench_dir / "metrics" / "batches.py").write_text(
        "def read(ctx):\n    return float(ctx['batches']) or None\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({**bench["configs"][0], "name": "paper_200ms_b",
                             "file": "portbench/configs/paper_200ms_b.json"})
    bench["workloads"].append({"name": "paper_200ms_b.mq_b8",
                               "config": "paper_200ms_b",
                               "traffic": "mq_b8", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "batches", "unit": "batches",
                               "better": "higher", "source": "host_clock",
                               "layer": "the card", "moves": "qps",
                               "workloads": ["paper_200ms_b.mq_b8"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    bench = registry.load_benchmark(tmp_path)
    w = registry.cell(bench, "paper_200ms_b.mq_b8")
    cfg, mod = registry.config(bench, w["config"], bench_dir)
    assert cfg["corpus"]["n_docs"] == 8192 and callable(mod.build)
    assert registry.traffic(w["traffic"], bench_dir)["batch"] == 8
    names = [m["name"] for m in registry.metrics_of(bench, w["name"],
                                                    "per_layer")]
    assert names == ["batches"]
    assert registry.reader("batches", bench_dir).read({"batches": 3}) == 3.0


@pytest.fixture(scope="module")
def tiny_corpus():
    return build_corpus(CorpusParams(n_docs=2048, vocab=1024, seed=3))


@pytest.mark.parametrize("seed", [7, 2 ** 31 + 5, -3])
def test_traffic_is_fixed_by_the_seed(tiny_corpus, seed):
    mix = {**registry.traffic("mq_b32"), "pool": 256, "sample": 32}
    cfg = {"index": {"stop_k": 16}}
    a = traffic.pool(tiny_corpus, mix, cfg, seed)
    b = traffic.pool(tiny_corpus, mix, cfg, seed)
    c = traffic.pool(tiny_corpus, mix, cfg, seed + 1)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    s = traffic.sample(tiny_corpus, mix, seed, a[0], a[1])
    assert np.array_equal(s, traffic.sample(tiny_corpus, mix, seed, a[0],
                                            a[1]))
    assert 32 <= s.sum() <= 33
    lengths = (a[1] > 0).sum(1)
    assert lengths.min() >= 1 and lengths.max() <= mix["max_terms"]


def test_work_is_counted_from_the_inputs(tiny_corpus):
    """The bytes of the kernels' bound come from the reference index and
    the queries: the port's tile width and lane capacity do not move
    them."""
    import torch
    from repro_torch.index.builder import build_index
    from repro_torch.index.corpus import Corpus, CorpusParams as PCP
    from repro_torch.index.postings import shard_layout

    from portbench.configs import paper_200ms
    from portbench.reference import index as ref_index
    from portbench.reference.stage1 import RefIndex

    ref = ref_index.build(tiny_corpus, stop_k=16, block_size=64)
    ref_dev = RefIndex(ref, "cpu")
    mix = {**registry.traffic("mq_b32"), "pool": 64}
    terms, mask, _ = traffic.pool(tiny_corpus, mix, {"index": {"stop_k": 16}},
                                  5)
    jass = np.arange(64) % 2 == 0
    traced = [dict(terms=terms, mask=mask, jass=jass,
                   rho=np.full(64, 500, np.int64))]
    state = {"k_serve": 128}
    want = paper_200ms.traced_work({}, state, traced, ref, ref_dev)
    assert want["stage1_bytes"] > 0 and want["stage2_bytes"] > 0
    index = build_index(Corpus(PCP(n_docs=2048, vocab=1024, seed=3),
                               **tiny_corpus), stop_k=16)
    caps = set()
    for tile_d, tile_cap in ((128, None), (256, None), (128, 16384)):
        lay = shard_layout(index, tile_d=tile_d, tile_cap=tile_cap)
        caps.add(lay.spec.tile_cap)
        got = paper_200ms.traced_work({}, state, traced, ref, ref_dev)
        assert got == want
    assert len(caps) > 1
    # the reference's postings are the program's index's, posting for
    # posting, whatever the layout
    assert np.array_equal(ref["docs"], index.docs)
    assert np.array_equal(ref["score"], index.bm25_score)
    from portbench.reference.stage1 import level_totals
    live = (mask > 0)[:, :, None]
    assert np.array_equal(level_totals(ref, terms, mask),
                          (index.level_cum[terms].astype(np.int64)
                           * live).sum(1))


def test_guard_refuses_jax_and_the_jax_package():
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from portbench.harness import guard; guard.install()\n"
        "import repro_torch\n"
        "for name in ('jax', 'repro', 'repro.core', 'benchmarks.common',"
        " 'flax'):\n"
        "    try:\n"
        "        __import__(name)\n"
        "    except ImportError:\n"
        "        continue\n"
        "    raise SystemExit('imported ' + name)\n"
        "print('refused')\n" % (str(ROOT), str(ROOT / "src")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and "refused" in out.stdout, out.stderr


def test_run_loads_nothing_of_jax():
    """Everything a run imports (the harness, every configuration, the
    reference, the readers and the port modules they reach) leaves no
    banned module in ``sys.modules``."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from portbench.harness import guard, registry, cell\n"
        "b = registry.load_benchmark()\n"
        "for w in b['workloads']:\n"
        "    registry.config(b, w['config'])\n"
        "    for m in registry.metrics_of(b, w['name'], 'per_layer'):\n"
        "        registry.reader(m['name'])\n"
        "import repro_torch.serving.system, repro_torch.isn.shard\n"
        "import repro_torch.launch.mesh, torch.profiler\n"
        "print(guard.loaded())\n" % (str(ROOT), str(ROOT / "src")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_chip_no_result():
    """Without the cell's CUDA devices the command exits non-zero and
    prints no result."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
         "paper_200ms.mq_b32", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr
