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
from ..dtypes import ACC_DTYPE, check_kernel_dtype
from . import kernel, ref

__all__ = ["launch_counts", "phi_blocked", "phi_blocked_arrays",
           "phi_mu_blocked", "reset_launch_counts"]

#: kernel launches per kernel name since the last reset
launch_counts = {"phi_blocked": 0, "phi_mu_blocked": 0}

_MAX_RANK = 1024  # the kernel puts one thread per rank column
_SMEM_LIMIT = 232_448  # bytes of shared memory a block may use on Hopper


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _check_inputs(name, grid_rb, vals_e, local_rows, pi_e, b_win,
                  block_nnz: int, block_rows: int) -> torch.dtype:
    dt = check_kernel_dtype(name, vals_e, pi_e, b_win)
    g = grid_rb.shape[0]
    r = pi_e.shape[1] if pi_e.dim() == 2 else -1
    if (grid_rb.dim() != 1 or vals_e.shape != (g * block_nnz,)
            or local_rows.shape != (g * block_nnz,)
            or pi_e.shape != (g * block_nnz, r) or b_win.dim() != 2
            or b_win.shape[1] != r or b_win.shape[0] % block_rows):
        raise ValueError(
            f"{name}: shapes do not fit the layout (block_nnz={block_nnz}, "
            f"block_rows={block_rows}): grid_rb {tuple(grid_rb.shape)}, "
            f"vals_e {tuple(vals_e.shape)}, local_rows "
            f"{tuple(local_rows.shape)}, pi_e {tuple(pi_e.shape)}, b_win "
            f"{tuple(b_win.shape)}"
        )
    if grid_rb.dtype != torch.int32 or local_rows.dtype != torch.int32:
        raise ValueError(f"{name}: grid_rb and local_rows must be int32")
    devs = {t.device for t in (grid_rb, vals_e, local_rows, pi_e, b_win)}
    if len(devs) != 1:
        raise ValueError(f"{name}: operands on several devices {devs}")
    if not all(t.is_contiguous()
               for t in (grid_rb, vals_e, local_rows, pi_e, b_win)):
        raise ValueError(f"{name}: operands must be contiguous")
    if b_win.device.type == "cuda":
        if not 1 <= r <= _MAX_RANK:
            raise ValueError(f"{name}: rank {r} outside 1..{_MAX_RANK}")
        smem = 4 * (block_nnz + block_rows * r)
        if smem > _SMEM_LIMIT:
            raise ValueError(
                f"{name}: block_nnz={block_nnz}, block_rows={block_rows} at "
                f"rank {r} need {smem} bytes of shared memory per block "
                f"(limit {_SMEM_LIMIT})"
            )
    elif b_win.device.type != "cpu":
        raise ValueError(f"{name}: no kernel for device {b_win.device}")
    return dt


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
