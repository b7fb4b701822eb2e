"""The whole unit's least time at the published peaks (the int8 convs'
ops at 1,979 TOP/s, every other FLOP that FlopCounterMode counts on the
reference at the configuration's precision) over the measured wall time
a unit in the window, in %."""


def read(ctx):
    least = ctx["least"]
    if not least or not least["step_least_s"] or not ctx["unit_s"]:
        return None
    return 100.0 * least["step_least_s"] / ctx["unit_s"]
