"""Device ms a step of the kernels launched under the
`distill/backward/recompute` spans: remat's recompute of the forward in
the backward pass, from the trace."""


def read(ctx):
    s = ctx["summary"]
    us = sum(d[-1] for d in s["device"]
             if d[3].startswith("distill/backward/recompute")) if s else 0
    return us / 1e3 / s["units"] if us else None
