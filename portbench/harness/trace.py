"""Reading a ``torch.profiler`` trace of the traced window.

The device's operations (kernels, copies, fills) give the busy time, as
the union of their intervals, and the idle gaps between them; the
harness's own spans (``record_function`` names that start with
``SPAN_PREFIX``) say what the host was doing during each gap.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

SPAN_PREFIX = "portbench:"


def read_profile(prof) -> dict:
    """The traced window's device operations and host spans:
    ``ops`` [(start_ns, end_ns, name)], every event on the device but the
    device-side copies of the harness's spans; ``spans`` [(start_ns,
    end_ns, name)], the harness's spans on the host; both sorted by
    start."""
    ops, spans = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start = int(e.start_ns())
        end = start + int(e.duration_ns())
        on_device = "CPU" not in str(e.device_type())
        if name.startswith(SPAN_PREFIX):
            if not on_device:
                spans.append((start, end, name[len(SPAN_PREFIX):]))
        elif on_device:
            ops.append((start, end, name))
    ops.sort()
    spans.sort()
    return {"ops": ops, "spans": spans}


def busy_intervals(ops) -> list[tuple[int, int]]:
    """The union of the operations' intervals, as disjoint intervals."""
    out: list[list[int]] = []
    for s, e, _ in ops:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _label(spans, starts, t: int) -> str:
    """The harness span covering instant ``t`` (the spans do not nest and
    are sorted by start; ``starts`` their starts), or "outside stages"."""
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and spans[i][1] >= t:
        return spans[i][2]
    return "outside stages"


def idle_by_span(ops, spans, t0: int, t1: int) -> dict:
    """Seconds of device idle time inside [t0, t1], by the host span at
    each gap's midpoint."""
    out: dict = defaultdict(float)
    starts = [s for s, _, _ in spans]
    cur = t0
    for s, e in busy_intervals(ops) + [(t1, t1)]:
        s, e = max(s, t0), min(e, t1)
        if s > cur:
            out[_label(spans, starts, (cur + s) // 2)] += (s - cur) * 1e-9
        cur = max(cur, e)
    return dict(out)


def op_seconds(ops) -> dict:
    """Device seconds by operation name."""
    out: dict = defaultdict(float)
    for s, e, name in ops:
        out[name] += (e - s) * 1e-9
    return dict(out)


def short_name(name: str) -> str:
    """A kernel's name without its argument list."""
    name = name.replace("(anonymous namespace)::", "")
    return (name.split("(")[0] or name)[:120]
