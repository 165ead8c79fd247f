"""The port's CLIs against the reference's, on the CPU.

``python -m repro_torch.launch.serve --device cpu`` against
``repro.launch.serve`` at ``--n-docs 2048 --vocab 1024 --queries 128``: the
printed lines equal, line for line, in seventeen modes (the default
labelled path, ``--pseudo-labels``, ``--no-ltr``, ``--shards 3``,
``--preset hybrid_fusion``, ``--dryrun``, ``--online`` under poisson,
bursty and trace arrivals, at a given ``--qps`` and with ``--zipf-skew``,
the result cache offline and online (``--preset cached --online
--zipf-skew 1.2``, ``--cache-bytes``), and fault schedules
(``--fault-scenario crash_one`` offline, ``timeout_storm`` online on 4
shards, ``--fault-json``)); ``--spec-json`` files byte-identical; each
unported flag (live ingest, telemetry) raising with its ROADMAP item; no
card and no ``--device`` raising.  ``launch/dryrun_cascade``: ``corpus_df``, ``WorkProxies`` and the
``dryrun`` dict equal to the reference's, pre-build and post-build, and
its CLI's output equal.

``hybrid_fusion`` embeds with a two-tower model: the reference draws it
from ``jax.random``, the port from a ``torch.Generator``, so the port's
draw is replaced here by the reference's tower carried across
(``convert.two_tower_params``), as ``tests/test_torch_system.py`` does.
"""

import dataclasses
import json
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from repro.configs.two_tower_retrieval import REDUCED as REF_REDUCED
from repro.launch import dryrun_cascade as ref_dryrun
from repro.launch import serve as ref_serve
from repro.models import recsys as ref_recsys
from repro.serving.spec import CascadeSpec as RefCascadeSpec
from repro.serving.spec import RoutingSpec
from repro_torch import convert
from repro_torch.launch import dryrun_cascade, serve
from repro_torch.models.recsys import TwoTower
from repro_torch.serving.spec import CascadeSpec

SMALL = ["--n-docs", "2048", "--vocab", "1024", "--queries", "128"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def ref_tower(monkeypatch):
    """The port draws the reference's two-tower model (by its seed)."""
    def init(c, seed=0, device=None):
        params, _ = ref_recsys.init(REF_REDUCED, jax.random.PRNGKey(seed))
        return convert.two_tower_params(jax.tree.map(np.asarray, params),
                                        device)
    monkeypatch.setattr(TwoTower, "init", staticmethod(init))


def _ref_main(mod, argv, monkeypatch, capsys):
    """Run a reference CLI's ``main`` with ``argv``; its stdout lines."""
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", [mod.__name__, *argv])
    mod.main()
    return capsys.readouterr().out.splitlines()


def _port_main(main, argv, capsys):
    capsys.readouterr()
    main(argv)
    return capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("flags", [[], ["--pseudo-labels"], ["--no-ltr"],
                                   ["--shards", "3"],
                                   ["--preset", "hybrid_fusion"],
                                   ["--dryrun"], ["--online"],
                                   ["--online", "--arrival", "bursty"],
                                   ["--online", "--qps", "12"],
                                   ["--online", "--zipf-skew", "1.2"],
                                   ["--online", "--arrival", "trace",
                                    "--trace-path", None],
                                   ["--preset", "cached", "--online",
                                    "--zipf-skew", "1.2"],
                                   ["--cache", "--pseudo-labels",
                                    "--cache-bytes", "4096"],
                                   ["--fault-scenario", "crash_one",
                                    "--fault-horizon", "0",
                                    "--failover-timeout", "25",
                                    "--max-retries", "1", "--pseudo-labels"],
                                   ["--fault-scenario", "timeout_storm",
                                    "--shards", "4", "--replicas", "3",
                                    "--failover-timeout", "25",
                                    "--max-retries", "2", "--fault-horizon",
                                    "400", "--online", "--pseudo-labels"]],
                         ids=["labels", "pseudo", "no_ltr", "shards3",
                              "hybrid_fusion", "dryrun", "online",
                              "online_bursty", "online_qps",
                              "online_zipf_skew", "online_trace",
                              "cached_online_zipf", "cache_bytes",
                              "fault_crash_one", "fault_storm_online"])
def test_serve_lines_match_reference(flags, tmp_path, monkeypatch, capsys,
                                     ref_tower):
    if None in flags:
        trace = tmp_path / "trace.npy"
        np.save(trace, np.cumsum(np.random.RandomState(0).exponential(
            20.0, 200)))
        flags = [str(trace) if f is None else f for f in flags]
    want = _ref_main(ref_serve, SMALL + flags, monkeypatch, capsys)
    got = _port_main(serve.main, ["--device", "cpu"] + SMALL + flags, capsys)
    assert got == want
    assert len(got) >= (6 if "--dryrun" in flags else 12)
    if "cached" in flags or "--cache" in flags:
        assert any(line.startswith("[serve] cache:") for line in got)
    if "--fault-scenario" in flags:
        assert any(line.startswith("[serve] faults:") for line in got)


def test_run_returns_the_served_system():
    out = serve.run(["--device", "cpu", "--pseudo-labels"] + SMALL,
                    say=lambda line: None)
    assert out.labels is None and out.dryrun is None
    assert out.result.topk.shape == (128, out.spec.stage2.k_serve)
    assert out.fitted.routing.t_k != out.spec.routing.t_k
    assert out.fitted.routing.t_k == out.system.cascade_spec.routing.t_k
    assert set(out.walls) == {"corpus", "build", "fit", "serve"}
    assert out.system.device == torch.device("cpu")
    assert out.ql.terms.shape[0] == 128


@pytest.fixture
def fault_json(tmp_path):
    path = tmp_path / "fault.json"
    path.write_text(json.dumps({"crashes": [[0, 0, 0.0, 50.0]],
                                "stragglers": [[0, 1, 0.0, 80.0, 3.0]]}))
    return str(path)


@pytest.mark.parametrize("flags", [
    [], ["--fault-json", None, "--failover-timeout", "25"],
    ["--cache", "--cache-entries", "64", "--max-batch", "16", "--dense",
     "--theta-high", "0.5", "--budget", "150", "--shards", "3",
     "--no-ltr", "--backend", "jnp"],
    ["--ingest", "--delta-docs", "512", "--metrics-json", "m.json",
     "--online", "--failover-timeout", "25", "--max-retries", "2",
     "--fusion", "weighted", "--no-admission", "--preset", "throughput"]],
    ids=["default", "fault_json", "spec_fields", "unported_flags"])
def test_spec_json_bytes_match_reference(flags, tmp_path, fault_json,
                                         monkeypatch, capsys):
    flags = [fault_json if f is None else f for f in flags]
    want, got = tmp_path / "want.json", tmp_path / "got.json"
    lines_want = _ref_main(ref_serve, flags + ["--spec-json", str(want)],
                           monkeypatch, capsys)
    lines_got = _port_main(serve.main, flags + ["--spec-json", str(got)],
                           capsys)
    assert got.read_bytes() == want.read_bytes()
    assert [s.replace("got.json", "") for s in lines_got] \
        == [s.replace("want.json", "") for s in lines_want]
    spec = CascadeSpec.from_json(got.read_text())
    assert spec.to_json() + "\n" == want.read_text()
    assert RefCascadeSpec.from_json(got.read_text()).to_json() \
        == spec.to_json()


@pytest.mark.parametrize("flags,item", [
    pytest.param(["--ingest"], "Live ingest", id="flags3-Live ingest"),
    pytest.param(["--delta-postings", "9000"], "Live ingest",
                 id="flags4-Live ingest"),
    pytest.param(["--metrics-json", "m.json"], "Telemetry",
                 id="flags5-Telemetry"),
    pytest.param(["--trace-slowest", "3"], "Telemetry",
                 id="flags6-Telemetry")])
def test_unported_flags_raise_with_their_item(flags, item, capsys):
    with pytest.raises(NotImplementedError,
                       match=rf"ROADMAP\.md, section 1: {item}\)"):
        serve.run(["--device", "cpu"] + SMALL + flags)
    # nothing was built: the raise comes before the first progress line
    assert capsys.readouterr().out == ""


def test_active_fault_json_raises_and_no_card_raises(fault_json,
                                                     monkeypatch, capsys):
    """An active ``--fault-json`` schedule is served (its lines equal the
    reference's, the faults line included); no card and no ``--device``
    raises."""
    flags = ["--fault-json", fault_json, "--failover-timeout", "25",
             "--pseudo-labels"] + SMALL
    want = _ref_main(ref_serve, flags, monkeypatch, capsys)
    got = _port_main(serve.main, ["--device", "cpu"] + flags, capsys)
    assert got == want
    assert any(line.startswith("[serve] faults: coverage") for line in got)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.run(SMALL, say=lambda line: None)


# ---------------------------------------------------------------------------
# launch/dryrun_cascade
# ---------------------------------------------------------------------------

def _tail_spec(budget, **kw):
    """``tests/test_tail_guarantee.py``'s ``_spec`` (the reference's)."""
    from repro.serving.spec import (BackendSpec, Stage0Spec, Stage2Spec)
    return RefCascadeSpec(
        routing=RoutingSpec(budget=budget, rho_max=1 << 14, t_k=150.0,
                            t_time=18.0),
        stage0=Stage0Spec(n_trees=12, depth=3),
        stage2=Stage2Spec(enabled=True, k_serve=64, t_final=10,
                          ltr_trees=12, n_train_queries=8),
        backend=BackendSpec(backend="jnp"), name="tail_test", **kw)


@pytest.fixture(scope="module")
def port_pair(small_collection):
    """The port's corpus and index of the fixture's collection."""
    from repro_torch.index.builder import build_index
    from repro_torch.index.corpus import CorpusParams, build_corpus
    corpus = build_corpus(CorpusParams(n_docs=4096, vocab=2048,
                                       avg_doclen=80, zipf_a=1.05, seed=3))
    return corpus, build_index(corpus, stop_k=8)


@pytest.mark.parametrize("case", ["dry", "stop8", "dense_3shards"])
def test_dryrun_matches_reference(case, small_collection, port_pair):
    """``tests/test_tail_guarantee.py:383-388`` and
    ``tests/test_online.py:382-407``'s calls, the port's dict equal to the
    reference's pre-build and post-build."""
    from repro.serving.spec import DenseSpec, DeploySpec, IndexSpec
    corpus, index, ql = small_collection
    pcorpus, pindex = port_pair
    ref_spec = {
        "dry": dataclasses.replace(_tail_spec(30.0), name="dry"),
        "stop8": _tail_spec(200.0, index=IndexSpec(stop_k=8)),
        "dense_3shards": _tail_spec(
            120.0, index=IndexSpec(stop_k=8),
            dense=DenseSpec(enabled=True, source="synthetic"),
            deploy=DeploySpec(n_shards=3))}[case]
    spec = convert.cascade_spec(ref_spec)
    np.testing.assert_array_equal(dryrun_cascade.corpus_df(pcorpus, 8),
                                  ref_dryrun.corpus_df(corpus, 8))
    pre = dryrun_cascade.WorkProxies.from_corpus(pcorpus, spec)
    post = dryrun_cascade.WorkProxies.from_index(pindex, spec)
    ref_pre = ref_dryrun.WorkProxies.from_corpus(corpus, ref_spec)
    ref_post = ref_dryrun.WorkProxies.from_index(index, ref_spec)
    assert not pre.post_build and post.post_build
    rows = np.arange(len(ql.terms))
    rho = np.full(len(rows), 256.0)
    for got, want in ((pre, ref_pre), (post, ref_post)):
        np.testing.assert_array_equal(got.jass(ql.terms, ql.mask, rows, rho),
                                      want.jass(ql.terms, ql.mask, rows, rho))
        for a, b in zip(got.bmw(ql.terms, ql.mask, 0.5),
                        want.bmw(ql.terms, ql.mask, 0.5)):
            np.testing.assert_array_equal(a, b)
    for idx, ref_idx in ((None, None), (pindex, index)):
        got = dryrun_cascade.dryrun(spec, pcorpus, ql=ql, index=idx)
        want = ref_dryrun.dryrun(ref_spec, corpus, ql=ql, index=ref_idx)
        assert got == want
        assert dryrun_cascade.render(got) == ref_dryrun.render(want)
        assert got["config"]["costing"] == ("corpus" if idx is None
                                            else "index")


@pytest.mark.parametrize("flags", [[], ["--build-index", "--shards", "2"]],
                         ids=["pre_build", "post_build"])
def test_dryrun_cli_matches_reference(flags, tmp_path, monkeypatch, capsys):
    flags = SMALL + ["--daat-prune", "0.5"] + flags
    want = _ref_main(ref_dryrun, flags + ["--out", str(tmp_path / "a.json")],
                     monkeypatch, capsys)
    got = _port_main(dryrun_cascade.main,
                     flags + ["--out", str(tmp_path / "b.json")], capsys)
    assert got[:-1] == want[:-1]
    assert (tmp_path / "b.json").read_bytes() \
        == (tmp_path / "a.json").read_bytes()
