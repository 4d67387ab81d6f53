"""``host_syncs``: host reads of a device value per outer sweep, the count
of the program's ``cpapr.sweep.sync`` spans in the traced window over
its sweeps: one per inner iteration (the KKT value that decides the
next), one guard flag per mode and one log-likelihood per sweep.
``None`` without a trace of the device (a run on the CPU traces none)
or without such a span (a program that records none)."""

NAME = "cpapr.sweep.sync"


def read(run):
    if run.trace is None or not run.trace.device or not run.sweeps:
        return None
    count = sum(n == NAME for n, _, _ in run.trace.host)
    return count / run.sweeps if count else None
