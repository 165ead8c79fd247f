"""Finding a cell's parts by name.

``BENCHMARK.json`` at the checkout's root names each cell's configuration
and traffic mix and each metric.  A configuration is
``configs/<name>.json`` (its sizes, source and limits) with
``configs/<name>.py`` beside it (how the port's system is built from the
data and served); a traffic mix is ``traffic/<name>.json``; a per-layer
metric is ``metrics/<name>.py``, a reader with ``read(ctx)``.  New files
and entries add parts; no file here names one.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, bench_dir: Path = BENCH_DIR):
    """(the configuration's JSON as a dict, its module)."""
    entry = next((c for c in bench["configs"] if c["name"] == name), None)
    if entry is None:
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")
    path = bench_dir.parent / entry["file"]
    with open(path) as f:
        cfg = json.load(f)
    mod = _module(path.with_suffix(".py"), f"portbench_config_{name}")
    return cfg, mod


def traffic(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    with open(bench_dir / "traffic" / f"{name}.json") as f:
        return json.load(f)


def metrics_of(bench: dict, workload: str, kind: str) -> list[dict]:
    """The ``kind`` ("end_to_end" or "per_layer") metrics a workload
    reports: those that list it, and those that list no workloads but move
    (per-layer) or are (end-to-end) a metric the workload reports."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    if kind == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", ())
            or ("workloads" not in m and m["moves"] in names)]


def reader(name: str, bench_dir: Path = BENCH_DIR):
    """The per-layer metric's reader module (``read(ctx) -> float | None``)."""
    return _module(bench_dir / "metrics" / f"{name}.py",
                   "portbench_metric_" + name.replace(".", "_"))
