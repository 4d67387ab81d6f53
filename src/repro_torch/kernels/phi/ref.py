"""Plain PyTorch versions of the Φ kernels (same function, same rounding).

The wrappers in :mod:`repro_torch.kernels.phi.ops` take these for tensors
that lie on the CPU, and the tests and ``chip_smoke.py`` hold the CUDA
kernels against them.  They repeat the kernels' arithmetic: products and
sums in f32 (the accumulator), each contribution ``w * pi`` rounded once
to the element dtype before it is accumulated, padding slots (x <= 0)
weighted exactly 0.  The sums run in another order than the kernels'
atomics, so the two agree to a tolerance, not bitwise.
"""
from __future__ import annotations

import torch

from ..dtypes import ACC_DTYPE

__all__ = ["phi_ref", "phi_blocked_ref", "phi_mu_ref", "phi_mu_blocked_ref"]


def _acc(dtype: torch.dtype) -> torch.dtype:
    # f64 stays f64 (the plain strategies keep it); kernel tiers use f32
    return torch.float64 if dtype == torch.float64 else ACC_DTYPE


def phi_ref(rows, vals, pi, b, n_rows: int, eps: float) -> torch.Tensor:
    """Φ^(n) from raw per-nonzero arrays; returns the accumulator dtype."""
    acc = _acc(pi.dtype)
    pi_a = pi.to(acc)
    s = torch.sum(b[rows].to(acc) * pi_a, dim=1)
    v = vals.to(acc)
    w = torch.where(v > 0, v / torch.clamp_min(s, eps), torch.zeros_like(v))
    contrib = (w[:, None] * pi_a).to(pi.dtype).to(acc)
    out = torch.zeros((n_rows, pi.shape[1]), dtype=acc, device=pi.device)
    return out.index_add_(0, rows, contrib)


def _global_rows(grid_rb, local_rows, block_nnz: int, block_rows: int):
    return (torch.repeat_interleave(grid_rb.long(), block_nnz) * block_rows
            + local_rows.long())


def phi_blocked_ref(grid_rb, vals_e, local_rows, pi_e, b_win, *,
                    block_nnz: int, block_rows: int,
                    eps: float) -> torch.Tensor:
    """Φ on layout-expanded inputs: the padded (n_rows_pad, R) window,
    accumulator dtype (the plain version of the ``phi_blocked`` kernel)."""
    rows = _global_rows(grid_rb, local_rows, block_nnz, block_rows)
    return phi_ref(rows, vals_e, pi_e, b_win, b_win.shape[0], eps)


def _mu_epilogue_ref(b, phi) -> tuple:
    bf = b.to(phi.dtype)
    viol = torch.max(torch.abs(torch.minimum(bf, 1.0 - phi)))
    return (bf * phi).to(b.dtype), viol


def phi_mu_ref(rows, vals, pi, b, n_rows: int, eps: float) -> tuple:
    """Fused MU step from raw arrays: ``(B*Φ, max|min(B, 1-Φ)|)``."""
    return _mu_epilogue_ref(b, phi_ref(rows, vals, pi, b, n_rows, eps))


def phi_mu_blocked_ref(grid_rb, vals_e, local_rows, pi_e, b_win, *,
                       block_nnz: int, block_rows: int,
                       eps: float) -> tuple:
    """Plain version of the ``phi_mu_blocked`` kernel: ``(mu, viol)``
    with ``mu = B*Φ`` over the padded window in B's dtype and ``viol``
    the f32 KKT violation (padded rows have B = 0 and add exactly 0)."""
    phi = phi_blocked_ref(grid_rb, vals_e, local_rows, pi_e, b_win,
                          block_nnz=block_nnz, block_rows=block_rows, eps=eps)
    return _mu_epilogue_ref(b_win, phi)
