"""Shared arithmetic of the readers of the program's own spans and
counters (``repro_torch.serving.telemetry.host``, on while the traced
window's profiler records): the window's spans, each span's self time (its
duration less what its child spans cover), and sums of them a batch.
Where the program has no such spans (a checkout before them) every helper
gives None."""

from __future__ import annotations

from collections import defaultdict


def host():
    """The program's span module, or None where it has none."""
    try:
        from repro_torch.serving.telemetry import host
    except ImportError:
        return None
    return host


def spans(ctx):
    """The program's spans inside the traced window, or None."""
    h = host()
    if h is None:
        return None
    t0, t1 = ctx["t0_ns"], ctx["t1_ns"]
    out = [r for r in h.records() if r.start_ns >= t0 and r.end_ns <= t1]
    return out or None


def self_ns(recs) -> dict:
    """Each span's self time in ns, by id: its duration less its child
    spans' (the spans of one thread nest, so children never overlap)."""
    covered: dict = defaultdict(int)
    for r in recs:
        if r.parent is not None:
            covered[r.parent] += r.end_ns - r.start_ns
    return {r.id: r.end_ns - r.start_ns - covered[r.id] for r in recs}


def self_ms_per_batch(ctx, match):
    """Self time of the spans whose name ``match`` accepts, in ms a traced
    batch; None where no such span ran."""
    recs = spans(ctx)
    if recs is None or not ctx["batches"]:
        return None
    own = self_ns(recs)
    hit = [own[r.id] for r in recs if match(r.name)]
    if not hit:
        return None
    return sum(hit) * 1e-6 / ctx["batches"]


def is_sync(name: str) -> bool:
    return name.startswith("sync.")
