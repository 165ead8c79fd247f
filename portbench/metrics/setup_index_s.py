"""``setup_index_s``: seconds of the process's set-up (its phases ended
before the traced window) spent building the program's index and its
shard layouts (the ``setup.index`` and ``setup.layout`` phases)."""

from portbench.metrics._program import host


def read(ctx):
    h = host()
    if h is None:
        return None
    d = [p.end_ns - p.start_ns for p in h.phases()
         if p.name in ("setup.index", "setup.layout")
         and p.end_ns <= ctx["t0_ns"]]
    if not d:
        return None
    return sum(d) * 1e-9
