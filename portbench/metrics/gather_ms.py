"""``gather_ms``: device milliseconds per outer sweep of gather, index and
scatter kernels, from the traced window, by the kernel names below: the
mode update's Π gathers and layout expansion's gathers, and besides them
the entry's permutation gathers and the log-likelihood's row gathers,
which kernel names cannot tell apart.  Host-device copies (the entry's
layouts) are not counted: ``prep_s`` holds them."""

#: substrings of the device names of gather, index and scatter kernels
NAMES = ("gather", "Gather", "index", "Index", "scatter", "Scatter")


def is_gather(name: str) -> bool:
    return any(k in name for k in NAMES)


def read(run):
    if run.trace is None or not run.sweeps:
        return None
    s = run.trace.device_seconds(is_gather)
    return s * 1e3 / run.sweeps if s > 0 else None
