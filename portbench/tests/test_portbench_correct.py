"""``correct`` at the small size on the CPU: the program's answers agree
with the plain reference, and the control (the reference in bfloat16 in
the program's place) and each fault a serving cell can have, planted in
the timed path, come out as not correct."""

import json

import pytest
import torch

from portbench.harness.cell import Setup, judge, result


def _fails(setup, nums) -> bool:
    lim = setup.cfg["limits"]
    return any(v > lim[k] for k, v in nums.items())


def _control(setup, seed):
    """The control's numbers: the reference in bfloat16 in the program's
    place, for the answers of one window."""
    setup.measure(seed, 0.3, False)
    ref, ref_dev = setup.reference()
    sut = setup.sut
    assert sut.kept
    return judge(setup.mod, setup.cfg, sut.state(), list(sut.kept), ref,
                 ref_dev, setup.corpus, torch.bfloat16, setup.memo)


def _correct(setup, seed) -> bool:
    """``correct`` of a run's window, check and result on ``setup``."""
    line = json.loads(json.dumps(result(setup, seed, 0.3, False,
                                        close=False)))
    assert line["attempted"] > 0
    return line["correct"]


@pytest.fixture(scope="module")
def cascade(small):
    torch.set_num_threads(2)
    return Setup("paper_200ms.mq_b32", device="cpu", root=small.parent,
                 bench_dir=small)


@pytest.fixture(scope="module")
def isn(small):
    torch.set_num_threads(2)
    st = Setup("paper_isn.mq_s256", device="cpu", root=small.parent,
               bench_dir=small)
    yield st
    st.sut.close()


def _tree(fn, *outs):
    """``fn`` over the tensors of equal-shaped results (tuples, lists)."""
    a = outs[0]
    if isinstance(a, torch.Tensor):
        return fn(*outs)
    parts = [_tree(fn, *xs) for xs in zip(*outs)]
    return type(a)(*parts) if hasattr(a, "_fields") else type(a)(parts)


def _tensors(out):
    got = []
    _tree(lambda x: got.append(x) or x, out)
    return got


def _stale(fn):
    """A step that returns its state unchanged: every call after the first
    answers with the first call's rows."""
    first = {}

    def f(*a, **k):
        out = fn(*a, **k)
        if "out" not in first:
            first["out"] = out
            return out
        return _tree(lambda new, old: old[torch.arange(new.shape[0])
                                          % max(old.shape[0], 1)]
                     if new.dim() else new, out, first["out"])
    return f


def _half(fn):
    """Half of the batch left out: the second half's lists are zeros."""
    def f(*a, **k):
        out = fn(*a, **k)
        for x in _tensors(out)[:2]:
            x[x.shape[0] // 2:] = 0
        return out
    return f


def _altered(fn):
    """An answer altered where it is produced: the fourth id of every
    list moved by one."""
    def f(*a, **k):
        out = fn(*a, **k)
        ids = [x for x in _tensors(out) if x.dim() == 2
               and not x.is_floating_point()]
        for x in ids[:1]:
            x[:, 3] += 1
        return out
    return f


FAULTS = {"stale": _stale, "half": _half, "altered": _altered}


def test_cascade_agrees_with_the_reference(cascade):
    assert _correct(cascade, 31)


def test_cascade_control_is_not_correct(cascade):
    nums = _control(cascade, 32)
    assert _fails(cascade, nums), nums


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_cascade_fault_is_not_correct(cascade, fault, monkeypatch):
    from repro_torch.serving import system
    for name in ("saat_scan_segments", "daat_scan_segments"):
        monkeypatch.setattr(system, name, FAULTS[fault](getattr(system,
                                                                name)))
    assert not _correct(cascade, 33), fault


def test_isn_agrees_with_the_reference(isn):
    assert _correct(isn, 41)


def test_isn_control_is_not_correct(isn):
    nums = _control(isn, 42)
    assert _fails(isn, nums), nums


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_isn_fault_is_not_correct(isn, fault, monkeypatch):
    from repro_torch.isn import shard
    for name in ("saat_serve", "daat_serve"):
        monkeypatch.setattr(shard, name, FAULTS[fault](getattr(shard, name)))
    assert not _correct(isn, 43), fault


@pytest.mark.chip
def test_a_cell_on_the_card(chip, tmp_path):
    """One short run of each cell on the card, correct."""
    import subprocess
    import sys

    from portbench_small import ROOT
    for w in ("paper_200ms.mq_b32", "paper_isn.mq_s256"):
        out = subprocess.run(
            [sys.executable, str(ROOT / "portbench" / "run.py"),
             "--workload", w, "--seed", "3", "--seconds", "2", "--trace",
             "0"], capture_output=True, text=True, cwd=ROOT, timeout=1200)
        assert out.returncode == 0, out.stderr[-2000:]
        assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
