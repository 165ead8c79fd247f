"""The observability gate's flow on the port against the reference's.

``chip_smoke.obs_flow("cpu")`` (the flow of ``benchmarks/obs_diff.py``'s
``run_gate``, with its own ``diff_snapshots`` / ``inject_regression``
copy, since ``chip_smoke.py`` imports nothing of ``benchmarks``) is held
to the reference's ``run_gate()`` at its defaults as it runs today, with
its artifact write stubbed out: the snapshot without traces, the four
gates, the findings against ``results/BENCH_obs_baseline.json`` (read,
never written), ``capacity_qps`` and ``traces_kept``.
``results/BENCH_obs.json`` is stale against the reference and is not
compared.  ``tests/test_telemetry.py``'s ``test_obs_diff_rules`` cases run
on the copy, whose findings equal the reference's on each input.

Each flow runs once per module; the port serves on the CPU (each kernel
wrapper's plain version), the reference on its ``"jnp"`` backend.
"""

import json
import pathlib

import pytest

torch = pytest.importorskip("torch")

from benchmarks import obs_diff

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def smoke():
    mp = pytest.MonkeyPatch()
    mp.syspath_prepend(str(ROOT))
    import chip_smoke
    yield chip_smoke
    mp.undo()


@pytest.fixture(scope="module")
def gate(smoke):
    """(the reference's ``run_gate()`` payload, ``obs_flow("cpu")``)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(obs_diff, "write_bench_artifact", lambda name, payload: None)
    try:
        want = obs_diff.run_gate()
    finally:
        mp.undo()
    return want, smoke.obs_flow("cpu")


def _leaves(d):
    if isinstance(d, dict):
        return sum(_leaves(v) for v in d.values())
    if isinstance(d, list):
        return sum(_leaves(v) for v in d)
    return 1


def test_obs_flow_matches_reference_gate(gate, smoke):
    want, got = gate
    assert got == smoke.obs_figures(want)
    assert json.dumps(got, sort_keys=True) \
        == json.dumps(smoke.obs_figures(want), sort_keys=True)


def test_obs_flow_snapshot_matches_reference(gate):
    want, got = gate
    assert got["snapshot"] == want["snapshot"]
    assert _leaves(got["snapshot"]) == 147
    assert obs_diff.render_gate(dict(want, snapshot=got["snapshot"])) \
        == obs_diff.render_gate(want)


def test_obs_flow_gates_hold(gate):
    want, got = gate
    assert got["gates"] == want["gates"]
    assert all(got["gates"].values()), got["gates"]
    assert got["findings"] == want["findings"] == []


def test_obs_flow_capacity_and_traces(gate):
    want, got = gate
    assert got["capacity_qps"] == want["capacity_qps"]
    assert round(got["capacity_qps"], 4) == 460.7379
    assert got["traces_kept"] == want["traces_kept"] == 32
    c = got["snapshot"]["counters"]
    assert c["queries_served"] == 512.0
    assert c["batches_served"] == want["snapshot"]["counters"][
        "batches_served"]


def test_obs_diff_on_the_committed_baseline(smoke):
    """The copy on the committed baseline's snapshot: clean against
    itself, and against its injected regression (both ways) the
    reference's findings and text."""
    snap = json.loads(smoke.OBS_BASELINE.read_text())["snapshot"]
    assert smoke.diff_snapshots(snap, snap) == []
    worse = smoke.inject_regression(snap)
    assert worse == obs_diff.inject_regression(snap)
    for a, b in ((snap, worse), (worse, snap)):
        f = smoke.diff_snapshots(a, b)
        assert f == obs_diff.diff_snapshots(a, b)
        assert smoke.format_findings(f) == obs_diff.format_findings(f)
    assert {"latency", "zero_to_nonzero"} <= {
        f["rule"] for f in smoke.diff_snapshots(snap, worse)}


def _fake_snap(p99=100.0, violations=0, shed=0, hit=0.5):
    return {
        "counters": {"budget_violations": violations,
                     'shed_queries{where="arrival"}': shed,
                     "queries_served": 100},
        "gauges": {"cache_hit_ratio": hit},
        "histograms": {"service_latency_us": {
            "count": 100, "sum": 5000.0, "min": 1.0, "max": p99 * 1.2,
            "p50": p99 / 2, "p95": p99 * 0.9, "p99": p99,
            "p99.99": p99 * 1.1}},
    }


def test_obs_diff_rules(smoke):
    """``tests/test_telemetry.py``'s ``test_obs_diff_rules`` on the copy;
    on every input its findings and text equal the reference's."""
    diff = smoke.diff_snapshots

    def both(base, cur):
        got = diff(base, cur)
        assert got == obs_diff.diff_snapshots(base, cur)
        return got

    base = _fake_snap()
    assert both(base, base) == []
    assert both(base, _fake_snap(p99=50.0)) == []
    f = both(base, _fake_snap(p99=200.0))
    assert f and all(x["rule"] == "latency" for x in f)
    f = both(base, _fake_snap(violations=1))
    assert [x["rule"] for x in f] == ["zero_to_nonzero"]
    f = both(_fake_snap(shed=10), _fake_snap(shed=20))
    assert [x["rule"] for x in f] == ["count"]
    assert both(_fake_snap(shed=10), _fake_snap(shed=12)) == []
    f = both(base, _fake_snap(hit=0.1))
    assert [x["rule"] for x in f] == ["hit_ratio"]
    gone = _fake_snap()
    gone["histograms"] = {}
    assert [x["rule"] for x in both(base, gone)] == ["missing"]
    rules = {x["rule"] for x in both(base, smoke.inject_regression(base))}
    assert {"latency", "zero_to_nonzero"} <= rules
    assert smoke.inject_regression(base) == obs_diff.inject_regression(base)
    assert "regression" in smoke.format_findings(f)
    assert smoke.format_findings(f) == obs_diff.format_findings(f)


@pytest.mark.parametrize("tol", [None, {"latency_rel": 0.0},
                                 {"count_rel": 0.0, "count_abs": 0.0},
                                 {"hit_ratio_drop": 0.5}])
def test_obs_diff_tolerances_match_reference(smoke, tol):
    """Other tolerances, mirrored sections and absent keys: the copy's
    findings equal the reference's."""
    base = _fake_snap(shed=4, hit=0.6)
    base["counters"].update({'faults{key="retries"}': 3,
                             'admission{key="shed_arrival"}': 0,
                             'scheduler{key="late_hedged"}': 2,
                             'scheduler{key="jass"}': 10})
    base["histograms"]["queue_wait_us"] = {"count": 0}
    base["histograms"]["stage_latency_us{stage=\"stage1\"}"] = {
        "count": 5, "p50": 3.0, "p99": 4.0}
    cur = _fake_snap(p99=101.5, shed=6, hit=0.4)
    cur["counters"].update({'faults{key="retries"}': 9,
                            'admission{key="shed_arrival"}': 1,
                            'scheduler{key="jass"}': 99})
    cur["histograms"]["stage_latency_us{stage=\"stage1\"}"] = {
        "count": 5, "p50": 3.5, "p99": 4.9}
    for a, b in ((base, cur), (cur, base)):
        assert smoke.diff_snapshots(a, b, tol) \
            == obs_diff.diff_snapshots(a, b, tol)
