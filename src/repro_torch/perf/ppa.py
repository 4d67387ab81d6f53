"""Pressure Point Analysis harness (paper Sec. 3.3, Exps. 1-2).

PPA deliberately breaks correctness to measure how much a suspected
hardware resource limits performance.  Perturbations (see core/phi.py):

  no_conflict    — keyed reduction replaced with uniform-segment sum:
                   the "remove atomics" pressure point (Sec. 3.3.1).
  perfect_reuse  — all gather indices clamped to row 0:
                   the "perfect cache reuse" pressure point (Sec. 3.3.2).
  both           — the combined upper bound (paper Figs. 5-6 teal bars).

They apply to the plain strategies (``scatter``, ``segment``, ``blocked``);
``cuda`` raises on a perturbation.  ``run_ppa`` measures wall clock on the
device the tensors lie on, fenced (``perf.timing.bench_seconds``);
speedups are vs. the unperturbed strategy.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from ..core.phi import phi_from_rows, phi_mode
from ..core.pi import pi_rows
from ..core.sparse_tensor import KTensor, SparseTensor, sort_mode
from ..device import check_on_device, resolve_device
from .timing import bench_seconds

__all__ = ["PERTURBATIONS", "PPAResult", "run_ppa"]

PERTURBATIONS = (None, "no_conflict", "perfect_reuse", "both")


@dataclasses.dataclass
class PPAResult:
    strategy: str
    mode: int
    seconds: dict  # perturbation -> seconds
    speedup: dict  # perturbation -> baseline/perturbed


def _phi_fn(mv, factors, b, strategy, perturb, device):
    """The Φ call one perturbation times, as a closure of no arguments."""
    if perturb == "both":
        # perfect_reuse on the reads and no_conflict on the reduce;
        # phi_mode applies one at a time, so the combination is inlined.
        def f_both():
            idx = torch.zeros_like(mv.sorted_idx)
            pi = pi_rows(idx, factors, mv.mode)
            return phi_from_rows(
                torch.zeros_like(mv.rows),
                mv.sorted_vals,
                pi,
                b,
                n_rows=mv.n_rows,
                strategy=strategy,
                perturb="no_conflict",
                device=device,
            )

        return f_both

    def f():
        return phi_mode(mv, factors, b, strategy=strategy, perturb=perturb,
                        device=device)

    return f


def run_ppa(
    t: SparseTensor,
    kt: KTensor,
    mode: int = 0,
    strategy: str = "segment",
    perturbations: Sequence = PERTURBATIONS,
    iters: int = 5,
    device="cuda",
) -> PPAResult:
    """Seconds of Φ^(n) for ``mode`` under each perturbation, and the
    speedup of each over the unperturbed strategy.  ``t`` and ``kt`` must
    lie on ``device``."""
    dev = resolve_device(device)
    check_on_device("run_ppa", dev, t.indices, t.values, kt.lam, *kt.factors)
    mv = sort_mode(t, mode)
    b = kt.factors[mode] * kt.lam[None, :]
    secs = {}
    for p in perturbations:
        fn = _phi_fn(mv, kt.factors, b, strategy, p, dev)
        secs[str(p)] = bench_seconds(fn, iters=iters)
    if "None" in secs:
        base = secs["None"]
    else:
        # perturbations without the unperturbed baseline: measure it once
        # for the speedup denominator, but keep it out of ``seconds`` so
        # the result reports exactly what was asked for.
        base = bench_seconds(_phi_fn(mv, kt.factors, b, strategy, None, dev),
                             iters=iters)
    speedup = {k: base / v if v > 0 else float("inf") for k, v in secs.items()}
    return PPAResult(strategy=strategy, mode=mode, seconds=secs, speedup=speedup)
