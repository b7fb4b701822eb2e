"""Calls of the reference's crops and int8 convs, noted while `CALLS` is a
list (the op and byte counts of `lavbench/counts.py` read them)."""

CALLS = None


def note(kind: str, **info) -> None:
    if CALLS is not None:
        CALLS.append((kind, info))
