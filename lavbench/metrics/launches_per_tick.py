"""Device operations (kernels, copies, fills) launched a tick, from the
trace."""


def read(ctx):
    s = ctx["summary"]
    return len(s["device"]) / s["units"] if s and s["device"] else None
