"""``sweep_idle_ms``: device idle milliseconds per outer sweep charged to
the program's sweep spans (names starting ``cpapr.sweep.``: the mode
update's inputs, scooch, fused steps and renormalisation, the host
syncs, the guard and the log-likelihood), from the traced window's idle
gaps as ``Trace.idle_gaps`` shares them out.  ``None`` without a trace
or without such a span (a program that records none)."""

PREFIX = "cpapr.sweep."


def read(run):
    if run.trace is None or not run.sweeps:
        return None
    s = sum(sec for name, sec in run.trace.idle_gaps(top=None)
            if name.startswith(PREFIX))
    return s * 1e3 / run.sweeps if s > 0 else None
