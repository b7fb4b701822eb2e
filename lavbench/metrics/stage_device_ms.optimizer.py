"""Device ms a step of the kernels launched under the `distill/optimizer`
spans (the gradients' norm, the optimizer's step, the BN merge), from the
trace."""


def read(ctx):
    s = ctx["summary"]
    us = sum(d[-1] for d in s["device"]
             if d[3].startswith("distill/optimizer")) if s else 0
    return us / 1e3 / s["units"] if us else None
