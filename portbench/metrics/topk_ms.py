"""``topk_ms``: host ms a batch inside the program's ``stage1.topk`` and
``stage1.merge`` spans, less their child spans (the copies of a merge to
the host are ``sync.d2h``), over the traced window's batches."""

from portbench.metrics._program import self_ms_per_batch


def read(ctx):
    return self_ms_per_batch(
        ctx, lambda name: name in ("stage1.topk", "stage1.merge"))
