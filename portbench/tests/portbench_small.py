"""The benchmark at a small size for the CPU tests: the checkout's root,
and a copy of ``portbench/`` whose configurations and traffic mixes are cut
so that a run takes seconds."""

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

# the small size: a collection of 8,192 docs (a vocabulary of 4,096,
# documents of about 150 tokens), a fit log of 256 queries,
# pools of 512 queries, one warm-up batch, ISN steps of 16 queries
SMALL_CORPUS = {"n_docs": 8192, "vocab": 4096, "avg_doclen": 150}
SMALL_MIX = {"pool": 512, "sample": 64, "warmup_batches": 1,
             "trace_seconds": 0.5}
SMALL_BATCH = {"mq_s256": 16, "mq_b256": 64}


def make_small(dst: Path) -> Path:
    """A copy of the benchmark under ``dst`` at the small size; returns
    the copy's ``portbench`` directory."""
    bench = dst / "portbench"
    shutil.copytree(ROOT / "portbench", bench,
                    ignore=shutil.ignore_patterns(".cache", "__pycache__",
                                                  "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    for path in (bench / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg["corpus"].update(SMALL_CORPUS)
        cfg["fit"]["queries"] = 256
        path.write_text(json.dumps(cfg))
    for path in (bench / "traffic").glob("*.json"):
        mix = json.loads(path.read_text())
        mix.update(SMALL_MIX)
        mix["batch"] = SMALL_BATCH.get(path.stem, mix["batch"])
        path.write_text(json.dumps(mix))
    return bench
