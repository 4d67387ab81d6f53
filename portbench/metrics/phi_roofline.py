"""``phi_roofline``: the least time of the window's Φ^(n) evaluations over
the device time of the Φ kernels, in %.

Evaluations are counted from the solver's counters: one per inner
iteration (``inner_iters``) and one per mode update for the scooch
(paper Alg. 1, line 3), ``N`` per sweep.  Each costs at least
``portbench.roofline.phi_least_seconds``; the mode of an inner
iteration is not counted, so each is charged the least over the modes,
which never counts high.  The kernel time is ``phi_kernel_ms``'s."""
from pathlib import Path

from portbench import roofline
from portbench.harness import load_metric


def read(run):
    phi_s = load_metric("phi_kernel_ms", Path(__file__).parent.parent) \
        .seconds(run)
    if phi_s <= 0:
        return None
    p = run.problem
    dims, nnz, rank = p["dims"], p["nnz_stored"], int(p["lam0"].shape[0])
    least = min(roofline.phi_least_seconds(dims, nnz, rank, n)
                for n in range(len(dims)))
    evals = sum(s["inner_iters"] + len(dims) * s["sweeps"]
                for s in run.solves)
    return 100.0 * evals * least / phi_s
