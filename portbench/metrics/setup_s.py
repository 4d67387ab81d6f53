"""``setup_s``: seconds from the start of the process to the window's
opening: imports, the kernels' build where the checkout has none, the
tensor and start drawn on the device, the warm-up solve."""


def read(run):
    return run.setup_s
