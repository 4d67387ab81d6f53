"""Π^(n) computation: Khatri-Rao rows, gathered per nonzero.

Materializing Π in full (R x prod_{m!=n} I_m) is infeasible, so one row
of Π is computed per nonzero:

    pi[j, r] = prod_{m != n} A^(m)[ idx[j, m], r ]

A pure gather + elementwise product with no reduction conflicts.
"""
from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["pi_rows", "pi_rows_flops_words", "pi_rows_local"]


def pi_rows(indices: torch.Tensor, factors: Sequence[torch.Tensor],
            n: int) -> torch.Tensor:
    """Gathered Khatri-Rao rows for mode ``n``: (nnz, R).

    ``indices`` are (nnz, N) coordinates (a ModeView's ``sorted_idx``
    gives rows aligned with the sorted layout).  The factors multiply in
    ascending mode order, as the JAX package's ``pi_rows`` does, so the
    f32 rounding matches.
    """
    nnz = indices.shape[0]
    r = factors[0].shape[1]
    out = torch.ones((nnz, r), dtype=factors[0].dtype,
                     device=factors[0].device)
    for m, f in enumerate(factors):
        if m == n:
            continue
        out = out * f[indices[:, m]]
    return out


def pi_rows_local(local_factors: Sequence[torch.Tensor],
                  local_idx: Sequence[torch.Tensor],
                  valid: torch.Tensor) -> torch.Tensor:
    """Shard-local Π rows from gathered factor rows: (slot, R).

    The sharded counterpart of :func:`pi_rows`: each shard gets only the
    factor rows its nonzeros touch (``local_factors[m]``: (U_m, R), from a
    :class:`repro_torch.core.layout.ShardedPiGather`) and per-slot
    positions into them (``local_idx[m]``: (slot,)).  ``valid`` masks
    padding slots to zero, as the layout expansion of the replicated rows
    does.  The multiplication order is :func:`pi_rows`'s (ascending
    mode), so the result is bitwise the expanded replicated Π rows.
    """
    f0 = local_factors[0]
    out = torch.ones((valid.shape[-1], f0.shape[1]), dtype=f0.dtype,
                     device=f0.device)
    for f, li in zip(local_factors, local_idx):
        out = out * f[li]
    return torch.where(valid[:, None], out, out.new_zeros(()))


def pi_rows_flops_words(nnz: int, rank: int, n_modes: int) -> tuple:
    """(FLOPs, f32 words moved) for the Π^(n) gather-product."""
    flops = nnz * rank * (n_modes - 2)  # (N-2) elementwise multiplies
    words = nnz * rank * (n_modes - 1) + nnz * rank  # gathers + store
    return flops, words
