"""``phi_kernel_ms``: device milliseconds per outer sweep of the Φ
kernels (B1 ``phi_mu_blocked``: the blocked accumulation and its MU
epilogue; B2 ``phi_blocked``: the accumulation alone), from the traced
window, by the kernel names below."""

#: substrings of the device names of the Φ kernels (``csrc/accum.cuh``'s
#: accumulation instantiated for Φ, and ``csrc/common.cuh``'s epilogue)
NAMES = ("phi_accum_kernel<true", "mu_epilogue_kernel")


def is_phi(name: str) -> bool:
    return any(k in name for k in NAMES)


def seconds(run) -> float:
    return run.trace.device_seconds(is_phi) if run.trace is not None else 0.0


def read(run):
    s = seconds(run)
    return s * 1e3 / run.sweeps if s > 0 and run.sweeps else None
