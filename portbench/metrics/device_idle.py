"""``device_idle``: the share of the traced window in which no operation
(kernel, copy, fill) ran on the card, in percent."""

from portbench.harness.trace import busy_intervals


def read(ctx):
    t0, t1 = ctx["t0_ns"], ctx["t1_ns"]
    if not ctx["ops"] or t1 <= t0:
        return None
    busy = sum(min(e, t1) - max(s, t0) for s, e in busy_intervals(ctx["ops"]))
    return 100.0 * (1.0 - busy / (t1 - t0))
