"""The share of a unit's wall time in which no operation ran on the
device, in %: the device's busy time a unit in the traced stretch over
the mean wall time a unit in the rest of the window (the profiler slows
the host in the traced stretch, not the device's operations)."""


def read(ctx):
    s = ctx["summary"]
    if not s or not s["busy_us"] or not ctx["unit_s"]:
        return None
    return 100.0 * (1.0 - s["busy_us"] / 1e6 / s["units"] / ctx["unit_s"])
