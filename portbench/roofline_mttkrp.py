"""The work of one sparse MTTKRP evaluation: the yardstick of the
``mttkrp_roofline`` metric, kept beside ``roofline.py`` (whose peaks it
reads) so that no change to the program can move it.

One mode-n MTTKRP, M_n = X_(n) (Khatri-Rao product of the other factors),
as the algorithm needs it, whatever implements it: it reads each
nonzero's value (4 B) and its N indices as int32 (4N B) once, reads every
other factor matrix once (I_m x R float32 each), and writes the I_n x R
result once.  The Khatri-Rao rows are formed from the factors, so they
are no input and their bytes are not counted (the port's B3 reads them
materialised, nnz x R float32: that is one implementation's traffic, not
this yardstick).  Its operations are nnz R (N + 1): per nonzero and
column, one product for each of the N - 1 other factors' rows (the
first into a row of ones), one by the value, and one sum into the
result.  At the benchmark's sizes the bytes' time is several times the
operations', so the count of operations does not set the share.
"""
from __future__ import annotations

from .roofline import H100_F32_FLOPS, H100_HBM_BYTES_S

__all__ = ["mttkrp_bytes", "mttkrp_flops", "mttkrp_least_seconds"]


def mttkrp_bytes(dims, nnz: int, rank: int, mode: int) -> int:
    """Bytes one mode-``mode`` MTTKRP has to move."""
    n_modes = len(dims)
    others = sum(int(d) for m, d in enumerate(dims) if m != mode)
    return (int(nnz) * (4 + 4 * n_modes) + others * int(rank) * 4
            + int(dims[mode]) * int(rank) * 4)


def mttkrp_flops(nnz: int, rank: int, n_modes: int) -> int:
    """Operations of one MTTKRP, nnz R (N + 1)."""
    return int(nnz) * int(rank) * (int(n_modes) + 1)


def mttkrp_least_seconds(dims, nnz: int, rank: int, mode: int) -> float:
    """The least time one mode-``mode`` MTTKRP can take on the card."""
    return max(mttkrp_bytes(dims, nnz, rank, mode) / H100_HBM_BYTES_S,
               mttkrp_flops(nnz, rank, len(dims)) / H100_F32_FLOPS)
