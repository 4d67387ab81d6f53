"""``als_host_syncs``: host reads of a device value per CP-ALS iteration,
the count of the program's ``cpals.iter.sync`` spans in the traced window
over its iterations: one per ridge solve (one a mode) and one for the
fit.  ``None`` without a trace of the device (a run on the CPU traces
none) or without such a span (a program that records none)."""

NAME = "cpals.iter.sync"


def read(run):
    if run.trace is None or not run.trace.device or not run.sweeps:
        return None
    count = sum(n == NAME for n, _, _ in run.trace.host)
    return count / run.sweeps if count else None
