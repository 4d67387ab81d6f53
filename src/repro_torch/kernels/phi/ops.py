"""Wrappers for the Φ CUDA kernels: checks, padding and launch counts.

``phi_blocked``/``phi_blocked_arrays`` run the plain Φ^(n) reduction
(kernel ``phi_blocked_launch``); ``phi_mu_blocked`` runs the fused MU
step (Φ + ``B*Φ`` + KKT violation, kernel ``phi_mu_blocked_launch``).
All take layout-expanded inputs (``repro_torch.core.phi.expand_to_layout``)
with the JAX package's signatures.

A wrapper given tensors on the CPU computes the kernel's plain version
(``ref.py``); given CUDA tensors it launches the kernel or raises.  Each
launch adds one to :data:`launch_counts` under the kernel's name.
"""
from __future__ import annotations

import torch

from ...core.layout import BlockedLayout, pad_rows
from .._checks import check_layout_operands
from ..dtypes import ACC_DTYPE
from . import kernel, ref

__all__ = ["launch_counts", "phi_blocked", "phi_blocked_arrays",
           "phi_mu_blocked", "reset_launch_counts"]

#: kernel launches per kernel name since the last reset
launch_counts = {"phi_blocked": 0, "phi_mu_blocked": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _check_inputs(name, grid_rb, vals_e, local_rows, pi_e, b_win,
                  block_nnz: int, block_rows: int) -> torch.dtype:
    n_rows_pad = b_win.shape[0] if b_win.dim() else -1
    return check_layout_operands(
        name, grid_rb, vals_e, local_rows, pi_e, n_rows_pad, b_win,
        block_nnz=block_nnz, block_rows=block_rows,
        smem_bytes=lambda r: 4 * (block_nnz + block_rows * r))


def phi_blocked_arrays(grid_rb, vals_e, local_rows, pi_e, b_win, *,
                       block_nnz: int, block_rows: int,
                       eps: float) -> torch.Tensor:
    """Φ on raw layout tensors (``grid_rb``/``local_rows`` int32 device
    tensors, not host constants).  ``b_win`` is the (n_rows_pad, R) B
    window; returns the padded (n_rows_pad, R) Φ window in the caller's
    element dtype (f32 or bf16; f64 raises).  Accumulation is f32."""
    dt = _check_inputs("phi_blocked", grid_rb, vals_e, local_rows, pi_e,
                       b_win, block_nnz, block_rows)
    if b_win.device.type == "cpu":
        return ref.phi_blocked_ref(grid_rb, vals_e, local_rows, pi_e, b_win,
                                   block_nnz=block_nnz, block_rows=block_rows,
                                   eps=eps).to(dt)
    phi = torch.zeros(b_win.shape, dtype=ACC_DTYPE, device=b_win.device)
    kernel.launch_phi(grid_rb, vals_e, local_rows, pi_e, b_win, phi,
                      block_nnz=block_nnz, block_rows=block_rows, eps=eps)
    launch_counts["phi_blocked"] += 1
    return phi.to(dt)


def _phi_mu_blocked_arrays(grid_rb, vals_e, local_rows, pi_e, b_win, *,
                          block_nnz: int, block_rows: int,
                          eps: float) -> tuple:
    """Fused MU step on raw layout tensors: ``(mu, viol)`` with ``mu`` the
    padded (n_rows_pad, R) ``B*Φ`` in B's dtype and ``viol`` the 0-d f32
    KKT violation ``max |min(B, 1-Φ)|`` (padded rows add exactly 0)."""
    _check_inputs("phi_mu_blocked", grid_rb, vals_e, local_rows, pi_e,
                  b_win, block_nnz, block_rows)
    if b_win.device.type == "cpu":
        return ref.phi_mu_blocked_ref(grid_rb, vals_e, local_rows, pi_e,
                                      b_win, block_nnz=block_nnz,
                                      block_rows=block_rows, eps=eps)
    phi = torch.zeros(b_win.shape, dtype=ACC_DTYPE, device=b_win.device)
    mu = torch.empty_like(b_win)
    viol = torch.zeros((), dtype=ACC_DTYPE, device=b_win.device)
    kernel.launch_phi_mu(grid_rb, vals_e, local_rows, pi_e, b_win, phi, mu,
                         viol, block_nnz=block_nnz, block_rows=block_rows,
                         eps=eps)
    launch_counts["phi_mu_blocked"] += 1
    return mu, viol


def phi_blocked(layout: BlockedLayout, vals_e, pi_e, b,
                eps: float = 1e-10) -> torch.Tensor:
    """Φ^(n) via the kernel on a prebuilt blocked layout.

    Returns the padded (n_rows_pad, R) result; callers slice to n_rows.
    """
    lt = layout.on(b.device)
    return phi_blocked_arrays(lt.grid_rb, vals_e, lt.local_rows, pi_e,
                              pad_rows(b, layout.n_rows_pad),
                              block_nnz=layout.block_nnz,
                              block_rows=layout.block_rows, eps=float(eps))


def phi_mu_blocked(layout: BlockedLayout, vals_e, pi_e, b,
                   eps: float = 1e-10) -> tuple:
    """Fused MU fast path via the kernels: ``(mu, viol)`` where ``mu`` is
    the padded (n_rows_pad, R) ``B * Φ^(n)`` (callers slice to n_rows) and
    ``viol`` the 0-d KKT violation ``max |min(B, 1 - Φ)|``."""
    lt = layout.on(b.device)
    return _phi_mu_blocked_arrays(lt.grid_rb, vals_e, lt.local_rows, pi_e,
                                 pad_rows(b, layout.n_rows_pad),
                                 block_nnz=layout.block_nnz,
                                 block_rows=layout.block_rows,
                                 eps=float(eps))
