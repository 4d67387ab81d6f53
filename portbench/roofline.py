"""Peaks of the card and the work of one Φ^(n) evaluation: the yardstick
of the ``*_roofline`` metrics, kept here so that no change to the program
can move it.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W): 3.35 TB/s of HBM3 and 67 TFLOP/s of float32 outside the
tensor cores.

One Φ^(n) evaluation (paper Alg. 1, line 6, as the algorithm needs it,
whatever implements it) reads each nonzero's value (4 B) and its N
indices as int32 (4N B) once, reads every factor matrix once (B^(n) in
place of A^(n): I_m x R float32 each), and writes the I_n x R result once.
Π is formed from the factors, so it is no input and its bytes are not
counted.  Its operations are the paper's W = nnz (4R + 2).  (The paper's
Eqs. 6-7 count SparTen's traffic with Π materialised: that is one
implementation's traffic, not this yardstick.)
"""
from __future__ import annotations

__all__ = ["H100_F32_FLOPS", "H100_HBM_BYTES_S", "phi_bytes", "phi_flops",
           "phi_least_seconds"]

H100_HBM_BYTES_S = 3.35e12
H100_F32_FLOPS = 67e12


def phi_bytes(dims, nnz: int, rank: int, mode: int) -> int:
    """Bytes one Φ^(mode) evaluation has to move."""
    n_modes = len(dims)
    return (int(nnz) * (4 + 4 * n_modes)
            + sum(int(d) for d in dims) * int(rank) * 4
            + int(dims[mode]) * int(rank) * 4)


def phi_flops(nnz: int, rank: int) -> int:
    """Operations of one Φ evaluation, the paper's W = nnz (4R + 2)."""
    return int(nnz) * (4 * int(rank) + 2)


def phi_least_seconds(dims, nnz: int, rank: int, mode: int) -> float:
    """The least time one Φ^(mode) evaluation can take on the card."""
    return max(phi_bytes(dims, nnz, rank, mode) / H100_HBM_BYTES_S,
               phi_flops(nnz, rank) / H100_F32_FLOPS)
