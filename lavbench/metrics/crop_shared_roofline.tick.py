"""The tick's crops' least time (`counts.crop`: the source pixels their
taps read, the grids and the outputs at the HBM bandwidth) over the
device time of the kernels of `csrc/crop_shared.cu`, in %."""

from lavbench.trace import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "crop_shared", "crop")
