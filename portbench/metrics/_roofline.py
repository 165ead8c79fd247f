"""Shared arithmetic of the kernel roofline readers: the least time the
kernels' bytes need at the H100's 3.35 TB/s (``portbench.work``, counted
from the traced batches' inputs) over the kernels' device time in the
traced window, in percent."""

from portbench.work import HBM_BYTES_PER_S


def share(ctx, work_key: str, kernels: tuple):
    bytes_ = ctx["work"].get(work_key)
    dev = sum(e - s for s, e, name in ctx["ops"]
              if any(k in name for k in kernels)) * 1e-9
    if not bytes_ or dev <= 0:
        return None
    return 100.0 * (bytes_ / HBM_BYTES_PER_S) / dev
