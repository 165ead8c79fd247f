"""``stage1_roofline``: kernels 1 and 2 (``impact_accumulate_kernel``,
``blockmax_score_kernel``) against the bound of the bytes their queries
need, in percent of the bound."""

from portbench.metrics._roofline import share

KERNELS = ("impact_accumulate_kernel", "blockmax_score_kernel")


def read(ctx):
    return share(ctx, "stage1_bytes", KERNELS)
