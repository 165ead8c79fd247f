"""``postings_per_q``: postings the Stage-1 engines scored (the program's
``postings`` counts, from ``saat_serve`` and ``daat_serve``) a traced
query."""

from portbench.metrics._program import spans


def read(ctx):
    recs = spans(ctx)
    if recs is None or not ctx["queries"]:
        return None
    n = [r.counts["postings"] for r in recs if "postings" in r.counts]
    if not n:
        return None
    return float(sum(n)) / ctx["queries"]
