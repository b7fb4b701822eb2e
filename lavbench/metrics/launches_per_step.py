"""Device operations (kernels, copies, fills) launched a distillation
step, from the trace; None where no operation ran under a `distill/`
span (a tick's trace)."""


def read(ctx):
    s = ctx["summary"]
    if not s or not any(d[3].startswith("distill/") for d in s["device"]):
        return None
    return len(s["device"]) / s["units"]
