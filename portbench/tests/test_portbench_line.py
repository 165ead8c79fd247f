"""The result line at the small size on the CPU: its keys, untraced and
traced."""

import json

import numpy as np


def test_result_line(small):
    """The last line's keys at the small size, untraced and traced."""
    from portbench.harness import cell
    st = cell.Setup("paper_200ms.mq_b32", device="cpu", root=small.parent,
                    bench_dir=small)
    for trace in (False, True):
        r = cell.result(st, 5, 0.3, trace, close=trace)
        line = json.loads(json.dumps(r))
        assert list(line)[-1] == "checks"
        assert {"correct", "attempted", "failed", "metrics",
                "device"} <= set(line)
        assert line["correct"] is True and line["attempted"] > 0
        assert set(line["device"]) >= {"platform", "kind", "count",
                                       "memory_peak_bytes"}
        for m in line["metrics"].values():
            assert np.isfinite(m["value"]) and m["unit"]
        if trace:
            assert set(line["metrics"]) <= {
                "stage0_ms", "stage1_ms", "stage2_ms", "stage1_roofline",
                "stage2_roofline", "device_idle", "device_ops_per_q"}
            assert {"stage0_ms", "stage1_ms"} <= set(line["metrics"])
            assert {"busy_s", "window_s"} <= set(line["device"])
            assert len(line["breakdown"]["idle_gaps"]) <= 10
        else:
            assert set(line["metrics"]) == {"qps", "p95_ms", "setup_s"}
