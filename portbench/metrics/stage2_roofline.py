"""``stage2_roofline``: kernel 3 (``qd_feature_gather_kernel``) against
the bound of the bytes its candidate grids need, in percent."""

from portbench.metrics._roofline import share

KERNELS = ("qd_feature_gather_kernel",)


def read(ctx):
    return share(ctx, "stage2_bytes", KERNELS)
