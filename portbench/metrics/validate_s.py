"""``validate_s``: per solve of the window, the host seconds of the
program's ``cpapr.prep.validate`` spans (the entry's input validation:
its copy of the indices and values to the host and its checks), from the
traced window's outermost host events.  ``None`` without a trace of the
device (a run on the CPU traces none) or without such a span (a program
that records none)."""

NAME = "cpapr.prep.validate"


def span_seconds(run, name: str) -> "float | None":
    """Host seconds of the spans called ``name`` over the window's solves,
    or ``None`` where there is nothing to read."""
    if run.trace is None or not run.trace.device or not run.solves:
        return None
    ns = [e - s for n, s, e in run.trace.host if n == name]
    return sum(ns) * 1e-9 / len(run.solves) if ns else None


def read(run):
    return span_seconds(run, NAME)
