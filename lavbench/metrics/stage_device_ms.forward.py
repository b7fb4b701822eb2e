"""Device ms a step of the kernels launched under the `distill/forward`
spans (the lidar model, the student with its teacher, the losses), from
the trace."""


def read(ctx):
    s = ctx["summary"]
    us = sum(d[-1] for d in s["device"]
             if d[3].startswith("distill/forward")) if s else 0
    return us / 1e3 / s["units"] if us else None
