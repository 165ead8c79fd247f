"""The readers of the program's own spans and counters on the CPU, at the
small size: a traced window of each configuration, with the nine metrics
entered in a copy of ``BENCHMARK.json`` for the cells they describe."""

import json

import numpy as np
import pytest

from portbench_small import make_small

CASCADE, ISN = "paper_200ms.mq_b32", "paper_isn.mq_s256"
# name: (unit, moves, cells); idle_unattributed reads nothing on the CPU,
# which has no device operations
NEW = {
    "features_ms": ("ms/batch", "qps", (CASCADE, ISN)),
    "forest_ms": ("ms/batch", "qps", (CASCADE, ISN)),
    "sched_ms": ("ms/batch", "qps", (CASCADE,)),
    "topk_ms": ("ms/batch", "qps", (CASCADE, ISN)),
    "sync_wait_ms": ("ms/batch", "qps", (CASCADE,)),
    "syncs_per_batch": ("syncs/batch", "qps", (CASCADE,)),
    "postings_per_q": ("postings/query", "qps", (CASCADE, ISN)),
    "idle_unattributed": ("%", "qps", (CASCADE, ISN)),
    "setup_index_s": ("s", "setup_s", (CASCADE, ISN)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small_nine(tmp_path_factory):
    """A small copy of the benchmark whose ``BENCHMARK.json`` lists the
    nine metrics."""
    from portbench.harness import store
    cache = store.CACHE_DIR
    store.CACHE_DIR = tmp_path_factory.mktemp("portbench_cache")
    bench_dir = make_small(tmp_path_factory.mktemp("portbench_nine"))
    path = bench_dir.parent / "BENCHMARK.json"
    bench = json.loads(path.read_text())
    names = {m["name"] for m in bench["per_layer"]}
    bench["per_layer"] = [m for m in bench["per_layer"]
                          if m["name"] not in NEW]
    for name, (unit, moves, cells) in NEW.items():
        bench["per_layer"].append({
            "name": name, "unit": unit, "better": "lower",
            "source": "program_span", "layer": "x", "moves": moves,
            "workloads": list(cells)})
    path.write_text(json.dumps(bench))
    assert names <= {m["name"] for m in bench["per_layer"]}
    yield bench_dir
    store.CACHE_DIR = cache


@pytest.mark.parametrize("workload", [CASCADE, ISN])
def test_every_new_metric_reads(small_nine, workload):
    from portbench.harness import cell
    st = cell.Setup(workload, device="cpu", root=small_nine.parent,
                    bench_dir=small_nine)
    line = json.loads(json.dumps(cell.result(st, 2 ** 31 + 11, 0.3, True)))
    assert line["correct"] is True
    got = line["metrics"]
    for name, (unit, _, cells) in NEW.items():
        if workload not in cells or name == "idle_unattributed":
            assert name not in got, name
            continue
        assert np.isfinite(got[name]["value"]), name
        assert got[name]["unit"] == unit
    assert got["setup_index_s"]["value"] >= 0
    assert got["syncs_per_batch" if workload == CASCADE
               else "postings_per_q"]["value"] > 0
    # the harness's own metrics read as before
    assert {"stage0_ms", "stage1_ms"} <= set(got)


def test_readers_read_nothing_without_the_programs_spans(monkeypatch):
    """On a checkout whose program has no spans (its span module missing,
    or no span in the window) every reader gives None and raises
    nothing."""
    import sys

    from portbench.harness import registry
    ctx = dict(ops=[(10, 20, "k")], spans=[], t0_ns=0, t1_ns=100,
               batches=1, queries=32, work={})
    for name in NEW:
        assert registry.reader(name).read(ctx) is None, name
    monkeypatch.setitem(sys.modules, "repro_torch.serving.telemetry.host",
                        None)
    monkeypatch.delattr("repro_torch.serving.telemetry.host",
                        raising=False)
    for name in NEW:
        assert registry.reader(name).read(ctx) is None, name


def test_self_time_and_idle_arithmetic(monkeypatch):
    """Self time is a span's duration less its children's; the idle share
    counts the device's gaps that no span below ``serve`` covers."""
    from portbench.harness import registry
    from portbench.metrics import _program
    from repro_torch.serving.telemetry import host

    S = host.HostSpan
    recs = [S(0, 100, "serve", 1, None, 0, {}),
            S(10, 50, "stage0", 2, 1, 0, {}),
            S(20, 30, "stage0.features", 3, 2, 0, {"postings": 64}),
            S(60, 90, "sched.route", 4, 1, 0, {})]
    monkeypatch.setattr(host, "records", lambda: recs)
    assert _program.self_ns(recs) == {1: 30, 2: 30, 3: 10, 4: 30}
    # the device busy over [0, 5] and [40, 70]: idle 5..40 and 70..100,
    # of which 10..40 and 70..90 lie under a span below ``serve``
    ctx = dict(ops=[(0, 5, "a"), (40, 70, "b")], spans=[], t0_ns=0,
               t1_ns=100, batches=2, queries=64, work={})
    read = {n: registry.reader(n).read(ctx) for n in NEW}
    assert read["idle_unattributed"] == pytest.approx(100 * 15 / 65)
    assert read["features_ms"] == pytest.approx(10e-6 / 2)
    assert read["sched_ms"] == pytest.approx(30e-6 / 2)
    assert read["postings_per_q"] == 1.0
    assert read["syncs_per_batch"] is None and read["topk_ms"] is None
