"""The int8 convs' least time (their ops at the int8 peak or their bytes
at the HBM bandwidth, the larger, `counts.conv2d_int8`) over the device
time of the kernels of `csrc/conv2d_int8.cu`, in %."""

from lavbench.trace import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "conv2d_int8", "conv2d_int8")
