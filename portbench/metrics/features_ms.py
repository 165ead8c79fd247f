"""``features_ms``: host ms a batch inside the program's ``stage0.features``
spans, less their child spans, over the traced window's batches."""

from portbench.metrics._program import self_ms_per_batch


def read(ctx):
    return self_ms_per_batch(ctx, lambda name: name == "stage0.features")
