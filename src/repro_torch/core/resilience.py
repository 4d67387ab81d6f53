"""Numerical guards and input validation for the CP-APR solver.

The parts of the JAX package's ``repro.core.resilience`` that the
solver's normal path calls:

* :func:`validate_decomposition_inputs` — reject garbage inputs at the
  solve boundary with an error naming the offending mode or position;
* :func:`guard_ok` / :func:`state_ok` — the per-mode finite/nonnegative
  check behind the solver's restore-and-retry kappa ladder.

The degradation ladder, failure classification and checkpoints are
later work of the port (ROADMAP A4).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = [
    "RecoveryEvent",
    "guard_ok",
    "state_ok",
    "validate_decomposition_inputs",
]


@dataclasses.dataclass
class RecoveryEvent:
    """One recovery action the solver took instead of crashing.

    ``kind`` is ``nan_guard`` (a mode's state went non-finite or negative
    and the sweep-start state was restored) or ``loglik_guard`` (the
    sweep's log-likelihood was non-finite; the sweep was redone).
    ``outer`` is the 1-based sweep, ``mode`` the mode index (-1 for
    solve-level events), ``attempt`` the retry count at that point.
    """

    kind: str
    outer: int
    mode: int = -1
    attempt: int = 0
    detail: dict = dataclasses.field(default_factory=dict)


def guard_ok(a: torch.Tensor, lam: torch.Tensor, viol=None) -> torch.Tensor:
    """0-d bool tensor on the device: ``a`` and ``lam`` finite and
    nonnegative, and ``viol`` (when given) finite.  The solver reads it
    once at sweep end, not per mode."""
    ok = (torch.isfinite(a).all() & (a >= 0).all()
          & torch.isfinite(lam).all() & (lam >= 0).all())
    if viol is not None:
        ok = ok & torch.isfinite(torch.as_tensor(viol)).all()
    return ok


def state_ok(a, lam, viol=None) -> bool:
    """Host-level guard over concrete tensors or arrays."""
    return bool(guard_ok(torch.as_tensor(a), torch.as_tensor(lam),
                         None if viol is None else torch.as_tensor(viol)))


def validate_decomposition_inputs(t, rank: int, where: str = "cpapr_mu",
                                  nonneg: bool = True) -> None:
    """Reject garbage inputs with a clear error *naming the offending
    mode/position* instead of producing silent NaN factors.

    Checks: ``rank`` positive; indices shaped (nnz, ndim) and in-range
    per mode; values finite; values nonnegative (Poisson count data) when
    ``nonneg``.  One host pass over the nonzeros, once per solve.
    """
    if not isinstance(rank, (int, np.integer)) or rank <= 0:
        raise ValueError(f"{where}: rank must be a positive integer, "
                         f"got {rank!r}")
    idx = t.indices.detach().cpu().numpy()
    vals = t.values.detach().cpu().numpy()
    ndim = len(t.shape)
    if idx.ndim != 2 or idx.shape[1] != ndim:
        raise ValueError(
            f"{where}: indices must have shape (nnz, {ndim}) for a "
            f"{ndim}-mode tensor, got {idx.shape}"
        )
    if vals.shape != (idx.shape[0],):
        raise ValueError(
            f"{where}: values must have shape ({idx.shape[0]},) to match "
            f"indices, got {vals.shape}"
        )
    for n, dim in enumerate(t.shape):
        col = idx[:, n]
        bad = (col < 0) | (col >= dim)
        if bad.any():
            j = int(np.argmax(bad))
            raise ValueError(
                f"{where}: mode {n} has out-of-range index {int(col[j])} at "
                f"nonzero {j} (valid range [0, {int(dim)}))"
            )
    finite = np.isfinite(vals)
    if not finite.all():
        j = int(np.argmax(~finite))
        raise ValueError(
            f"{where}: non-finite nonzero value {vals[j]!r} at position {j}"
        )
    if nonneg:
        neg = vals < 0
        if neg.any():
            j = int(np.argmax(neg))
            raise ValueError(
                f"{where}: negative nonzero value {vals[j]!r} at position "
                f"{j}; the solvers assume nonnegative (Poisson count) data"
            )
