"""``stage0_ms``: host ms a batch inside Stage-0 (the harness's
``portbench:stage0`` spans, from ``torch.profiler``), over the traced
window's batches."""

from portbench.metrics._stage_span import ms_per_batch


def read(ctx):
    return ms_per_batch(ctx, "stage0")
