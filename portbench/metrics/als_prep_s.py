"""``als_prep_s``: per solve of the window, the host seconds of the
program's ``cpals.prep.*`` spans (``cp_als``'s validation, mode sorts,
and policies, layouts and mode updates), from the traced window's
outermost host events.  ``None`` without a trace of the device (a run on
the CPU traces none) or without such a span (a program that records
none)."""

PREFIX = "cpals.prep."


def read(run):
    if run.trace is None or not run.trace.device or not run.solves:
        return None
    ns = [e - s for n, s, e in run.trace.host if n.startswith(PREFIX)]
    return sum(ns) * 1e-9 / len(run.solves) if ns else None
