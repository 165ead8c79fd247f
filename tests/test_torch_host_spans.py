"""The port's wall-clock spans and counters
(``repro_torch.serving.telemetry.host``), on the CPU.

* With no profiler recording, ``span`` (as a context and as a decorator),
  ``count`` and the copy helpers record nothing and open no profiler
  event; the copies are the plain ones; phases are recorded all the same.
* Under ``torch.profiler.profile`` a served batch of a small
  ``SearchSystem`` and a step of the ISN on the (1, 1) gloo mesh give the
  spans of their layers, each nested in its parent's interval, all under
  one ``serve`` with one batch id, each within 1 ms of its
  ``repro_torch:`` profiler event, and none of those events user-scoped.
* A tensor handed to ``count`` is summed when the records are read, not
  when it is counted.
* The profiler's own flag, which the spans read, is there and follows the
  profiler.
"""

import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.cascade_presets import get_preset
from repro_torch.index.builder import build_index
from repro_torch.index.corpus import CorpusParams, build_corpus, build_queries
from repro_torch.index.postings import shard_layouts, shard_to_device
from repro_torch.isn import shard as isn
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.serving.system import build_system
from repro_torch.serving.telemetry import host

CASCADE = {"serve", "stage0", "stage0.features", "stage0.forest",
           "sched.route", "sched.pool", "sched.resolve", "sched.adapt",
           "sched.stats", "stage1", "stage1.saat", "stage1.daat",
           "stage1.topk", "stage1.merge", "stage2", "stage2.features",
           "stage2.ltr", "sync.h2d", "sync.d2h"}
ISN = {"serve", "stage0", "stage0.features", "stage0.forest", "stage1",
       "stage1.saat", "stage1.daat", "stage1.topk", "stage1.merge",
       "stage1.gather"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fitted():
    """A small ``paper_200ms`` system on the CPU, fitted on pseudo-labels,
    with its index's layouts and query log."""
    corpus = build_corpus(CorpusParams(n_docs=4096, vocab=2048,
                                       avg_doclen=80, zipf_a=1.05, seed=3))
    index = build_index(corpus, stop_k=8)
    ql = build_queries(corpus, 96, stop_k=8, seed=11)
    spec = get_preset("paper_200ms")
    layouts = shard_layouts(index, spec.deploy.n_shards, spec.index.tile_d)
    system = build_system(spec, index, corpus=corpus, device="cpu",
                          layouts=layouts)
    system.fit(ql, None, seed=5)
    return system, index, layouts, ql


def _traced(fn):
    """``fn()`` under the profiler: (its result, the window's program
    spans, the profiler's ``repro_torch:`` events as (start_ns, end_ns,
    name, scope))."""
    host.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    events = sorted(
        (int(e.start_ns()), int(e.start_ns()) + int(e.duration_ns()),
         e.name()[len(host.PREFIX):], int(e.scope()))
        for e in prof.profiler.kineto_results.events()
        if e.name().startswith(host.PREFIX))
    return out, host.records(), events


def _check_tree(recs, names):
    """The spans are ``names``, one ``serve`` root, every other span
    inside its parent's interval, and one batch id for all."""
    assert {r.name for r in recs} == names
    by_id = {r.id: r for r in recs}
    roots = [r for r in recs if r.parent is None]
    assert [r.name for r in roots] == [host.ROOT]
    for r in recs:
        if r.parent is not None:
            up = by_id[r.parent]
            assert up.start_ns <= r.start_ns <= r.end_ns <= up.end_ns
        assert r.batch == roots[0].batch is not None


def _check_events(recs, events):
    """Each span lies within 1 ms of its profiler event, at both ends, and
    no event is user-scoped (a user-scoped event is also drawn over the
    device's timeline)."""
    spans = sorted((r.start_ns, r.end_ns, r.name) for r in recs)
    assert [e[2] for e in events] == [s[2] for s in spans]
    for (s0, s1, _), (e0, e1, _, scope) in zip(spans, events):
        assert abs(s0 - e0) < 1_000_000 and abs(s1 - e1) < 1_000_000
        assert scope != int(torch._C._profiler.RecordScope.USER_SCOPE)


def test_the_profilers_flag_is_there():
    flag = torch.autograd.profiler._is_profiler_enabled
    assert flag is False
    with profile(activities=[ProfilerActivity.CPU]):
        assert torch.autograd.profiler._is_profiler_enabled is True
    assert torch.autograd.profiler._is_profiler_enabled is False


def test_off_records_nothing_and_opens_no_event(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a profiler event was opened")
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    host.reset()

    @host.span("decorated")
    def twice(x):
        return 2 * x

    t = torch.arange(6)
    with host.span("a"):
        with host.span("b"):
            host.count("n", 3)
            host.count("n", t)
            assert twice(4) == 8
        got = host.to_host(t)
        card = host.to_card(np.arange(3), "cpu")
    assert host.span("a") is host.span("a")
    assert host.records() == [] and host.dropped() == 0
    assert torch.equal(got, t) and torch.equal(card, torch.arange(3))
    with host.phase("setup.x"):
        pass
    assert [p.name for p in host.phases()] == ["setup.x"]


def test_a_tensor_count_is_summed_at_read():
    t = torch.tensor([1, 2, 3])
    host.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with host.span(host.ROOT):
            with host.span("stage1.saat"):
                host.count("postings", t)
                host.count("postings", 4)
            host.count("other", 1.5)
    t += 10                     # after the span closed, before the read
    recs = {r.name: r for r in host.records()}
    assert recs["stage1.saat"].counts == {"postings": 40}
    assert recs[host.ROOT].counts == {"other": 1.5}
    t += 10                     # read once: the total stays
    assert {r.name: r for r in host.records()}["stage1.saat"].counts == {
        "postings": 40}


def test_a_served_batch_of_the_cascade(fitted):
    """The batch's spans, and the same answers as an untraced copy of the
    system serving the same batch."""
    system, _, _, ql = fitted
    twin = copy.deepcopy(system)
    sl = slice(0, 32)
    batch = (ql.terms[sl], ql.mask[sl], ql.topic[sl])
    want = twin.serve(*batch)
    out, recs, events = _traced(lambda: system.serve(*batch))
    _check_tree(recs, CASCADE)
    _check_events(recs, events)
    names = [r.name for r in recs]
    assert names.count("sync.h2d") + names.count("sync.d2h") >= 10
    assert sum(r.counts.get("postings", 0) for r in recs) > 0
    for key in ("topk", "final", "candidates_used", "latency"):
        assert np.array_equal(getattr(out, key), getattr(want, key)), key


def test_a_step_of_the_isn_on_the_cpu_mesh(fitted):
    system, index, layouts, ql = fitted
    shard, spec = shard_to_device(layouts[0], "cpu")
    fa = isn.stage0_forest(system.models)
    depth = system.models["k"].params.depth
    n_blocks = spec.n_blocks
    mesh = make_local_mesh(device="cpu")
    try:
        step = isn.hybrid_serve_fn(
            mesh, n_docs_shard=spec.n_docs, n_model=1, k_shard=64,
            k_global=64, rho_max=4096, daat_cap=min(spec.n_docs, 1 << 19),
            daat_bcap=min(n_blocks, 1 << 14), n_blocks=n_blocks,
            block_size=spec.block_size, t_k=1000.0, t_time=150.0,
            forest_depth=depth, tile_d=spec.tile_d)
        ts = torch.from_numpy(np.ascontiguousarray(index.term_stats,
                                                   np.float32))
        terms = torch.from_numpy(ql.terms[:16].astype(np.int32))
        mask = torch.from_numpy(ql.mask[:16].astype(np.float32))
        plain = step(shard, fa, ts, terms, mask)
        out, recs, events = _traced(lambda: step(shard, fa, ts, terms, mask))
    finally:
        torch.distributed.destroy_process_group()
    _check_tree(recs, ISN)
    _check_events(recs, events)
    for a, b in zip(plain, out):
        assert torch.equal(a, b)
    # both engines run on every query and both count what they scored
    counted = [r for r in recs if "postings" in r.counts]
    assert {r.name for r in counted} == {"stage1.saat", "stage1.daat"}
    assert sum(r.counts["postings"] for r in counted) > 0
