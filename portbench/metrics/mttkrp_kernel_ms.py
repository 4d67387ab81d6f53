"""``mttkrp_kernel_ms``: device milliseconds per CP-ALS iteration of the
sparse MTTKRP kernel (B3 ``mttkrp_blocked``: ``csrc/accum.cuh``'s blocked
accumulation instantiated for MTTKRP), from the traced window, by the
kernel name below; ``None`` where the window ran no such kernel."""

#: substring of B3's device name (Φ's B1/B2 are ``phi_accum_kernel<true``)
NAME = "phi_accum_kernel<false"


def is_mttkrp(name: str) -> bool:
    return NAME in name


def seconds(run) -> float:
    return run.trace.device_seconds(is_mttkrp) if run.trace is not None \
        else 0.0


def read(run):
    s = seconds(run)
    return s * 1e3 / run.sweeps if s > 0 and run.sweeps else None
