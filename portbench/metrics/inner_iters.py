"""``inner_iters``: inner MU iterations per outer sweep, summed over the
modes (``CPAPRResult.inner_iters``), over the window's solves."""


def read(run):
    iters = sum(s.get("inner_iters", 0) for s in run.solves)
    return iters / run.sweeps if run.sweeps and iters else None
