"""``syncs_per_batch``: the program's copies between host and card
(``sync.h2d``, ``sync.d2h`` spans) a traced batch."""

from portbench.metrics._program import is_sync, spans


def read(ctx):
    recs = spans(ctx)
    if recs is None or not ctx["batches"]:
        return None
    n = sum(1 for r in recs if is_sync(r.name))
    return n / ctx["batches"] if n else None
