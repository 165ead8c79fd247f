"""Shared arithmetic of the stage-span readers: a stage's host time a
batch, from the harness's ``portbench:<stage>`` spans in the traced
window."""


def ms_per_batch(ctx, stage: str):
    d = [e - s for s, e, name in ctx["spans"] if name == stage]
    if not d or not ctx["batches"]:
        return None
    return sum(d) * 1e-6 / ctx["batches"]
