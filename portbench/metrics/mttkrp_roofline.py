"""``mttkrp_roofline``: the least time of the window's MTTKRP evaluations
over the device time of the MTTKRP kernel, in %.

A CP-ALS iteration (a sweep) evaluates one MTTKRP per mode, N in all,
each charged its own mode's least time,
``portbench.roofline_mttkrp.mttkrp_least_seconds``.  The kernel time is
``mttkrp_kernel_ms``'s."""
from pathlib import Path

from portbench import roofline_mttkrp
from portbench.harness import load_metric


def read(run):
    kernel_s = load_metric("mttkrp_kernel_ms", Path(__file__).parent.parent) \
        .seconds(run)
    if kernel_s <= 0:
        return None
    p = run.problem
    dims, nnz, rank = p["dims"], p["nnz_stored"], int(p["lam0"].shape[0])
    per_sweep = sum(roofline_mttkrp.mttkrp_least_seconds(dims, nnz, rank, n)
                    for n in range(len(dims)))
    return 100.0 * run.sweeps * per_sweep / kernel_s
