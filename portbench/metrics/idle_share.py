"""``idle_share``: the share of the traced window in which no operation
ran on the device, 100 (1 - busy / window), busy being the union of the
device's intervals over the window's whole solves."""


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.window_s)
