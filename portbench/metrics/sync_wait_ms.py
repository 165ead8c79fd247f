"""``sync_wait_ms``: host ms a batch inside the program's copies between
host and card (``sync.h2d``, ``sync.d2h``: each waits for the card's
stream), over the traced window's batches."""

from portbench.metrics._program import is_sync, spans


def read(ctx):
    recs = spans(ctx)
    if recs is None or not ctx["batches"]:
        return None
    d = [r.end_ns - r.start_ns for r in recs if is_sync(r.name)]
    if not d:
        return None
    return sum(d) * 1e-6 / ctx["batches"]
