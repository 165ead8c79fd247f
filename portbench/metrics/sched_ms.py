"""``sched_ms``: host ms a batch inside the program's scheduler spans
(``sched.route``, ``sched.pool``, ``sched.resolve``, ``sched.adapt``,
``sched.stats``), less their child spans, over the traced window's
batches."""

from portbench.metrics._program import self_ms_per_batch


def read(ctx):
    return self_ms_per_batch(ctx, lambda name: name.startswith("sched."))
