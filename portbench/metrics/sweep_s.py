"""``sweep_s``: the window's seconds over the outer sweeps its solves
completed (each solve's own preparation inside the call included)."""


def read(run):
    return run.window_s / run.sweeps if run.sweeps else None
