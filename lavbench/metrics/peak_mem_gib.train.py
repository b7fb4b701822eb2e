"""The process's peak of allocated device memory, in GiB."""


def read(ctx):
    peak = ctx["memory_peak_bytes"]
    return peak / 2 ** 30 if peak else None
