"""``idle_unattributed``: the share of the traced window's device idle
time (the gaps between its device operations) during which no program span
below the root ``serve`` was open on the host, in percent: the idle time
that the program's spans do not name."""

from portbench.harness.trace import busy_intervals
from portbench.metrics._program import host, spans


def read(ctx):
    recs = spans(ctx)
    t0, t1 = ctx["t0_ns"], ctx["t1_ns"]
    if recs is None or not ctx["ops"] or t1 <= t0:
        return None
    root = host().ROOT
    named = busy_intervals(sorted((r.start_ns, r.end_ns, r.name)
                                  for r in recs if r.name != root))
    gaps, cur = [], t0
    for s, e in busy_intervals(ctx["ops"]) + [(t1, t1)]:
        s, e = max(s, t0), min(e, t1)
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    idle = sum(e - s for s, e in gaps)
    if idle <= 0:
        return None
    covered, i = 0, 0
    for s, e in gaps:
        while i < len(named) and named[i][1] <= s:
            i += 1
        j = i
        while j < len(named) and named[j][0] < e:
            covered += min(e, named[j][1]) - max(s, named[j][0])
            j += 1
    return 100.0 * (idle - covered) / idle
