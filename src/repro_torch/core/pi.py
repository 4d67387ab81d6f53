"""Π^(n) computation: Khatri-Rao rows, gathered per nonzero.

Materializing Π in full (R x prod_{m!=n} I_m) is infeasible, so one row
of Π is computed per nonzero:

    pi[j, r] = prod_{m != n} A^(m)[ idx[j, m], r ]

A pure gather + elementwise product with no reduction conflicts.
"""
from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["pi_rows", "pi_rows_flops_words"]


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


def pi_rows_flops_words(nnz: int, rank: int, n_modes: int) -> tuple:
    """(FLOPs, f32 words moved) for the Π^(n) gather-product."""
    flops = nnz * rank * (n_modes - 2)  # (N-2) elementwise multiplies
    words = nnz * rank * (n_modes - 1) + nnz * rank  # gathers + store
    return flops, words
