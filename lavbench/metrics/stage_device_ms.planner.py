"""Device ms a tick of the kernels launched under the `agent/planner` span,
from the trace."""


def read(ctx):
    s = ctx["summary"]
    us = sum(d[-1] for d in s["device"] if d[3] == "agent/planner") if s else 0
    return us / 1e3 / s["units"] if us else None
