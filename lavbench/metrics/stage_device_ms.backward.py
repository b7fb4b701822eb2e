"""Device ms a step of the kernels launched under the `distill/backward`
span outside its recomputes: autograd's gradient kernels, from the
trace."""


def read(ctx):
    s = ctx["summary"]
    us = sum(d[-1] for d in s["device"]
             if d[3].startswith("distill/backward")
             and not d[3].startswith("distill/backward/recompute")) \
        if s else 0
    return us / 1e3 / s["units"] if us else None
