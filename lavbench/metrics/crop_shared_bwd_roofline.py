"""The student crops' backward least time (`counts.crop_bwd`: the
output gradients and grids read, the source gradients written) over the
device time of the kernels of `csrc/crop_shared_bwd.cu`, in %."""

from lavbench.trace import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "crop_shared_bwd", "crop_bwd")
