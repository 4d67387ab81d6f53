"""``als_idle_ms``: device idle milliseconds per CP-ALS iteration charged
to the program's iteration spans (names starting ``cpals.iter.``: each
mode update's Khatri-Rao inputs, MTTKRP and Gram product, the host syncs,
the fit), from the traced window's idle gaps as ``Trace.idle_gaps``
shares them out.  ``None`` without a trace or without such a span (a
program that records none)."""

PREFIX = "cpals.iter."


def read(run):
    if run.trace is None or not run.sweeps:
        return None
    s = sum(sec for name, sec in run.trace.idle_gaps(top=None)
            if name.startswith(PREFIX))
    return s * 1e3 / run.sweeps if s > 0 else None
