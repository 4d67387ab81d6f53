"""Operand checks shared by the wrappers of the blocked-layout kernels.

The Φ kernels (``phi``) and the MTTKRP kernel (``mttkrp``) read the same
layout-expanded operands; their wrappers validate them here before any
pointer reaches CUDA, and raise on what a kernel does not take.
"""
from __future__ import annotations

from typing import Callable

import torch

from .dtypes import check_kernel_dtype

__all__ = ["CardLimitError", "MAX_RANK", "SMEM_LIMIT", "check_card_limits",
           "check_layout_operands", "runs_plain"]

MAX_RANK = 1024  # the largest rank the CUDA kernels take
SMEM_LIMIT = 232_448  # bytes of shared memory a block may use on Hopper


class CardLimitError(ValueError):
    """A launch the card could not run, refused before it starts: a rank
    outside 1..MAX_RANK or more shared memory per block than Hopper has.
    The JAX package's kernel tier fails the same cases at compile time."""


def runs_plain(name: str, device: torch.device,
               interpret: "bool | None") -> bool:
    """Whether a wrapper computes its kernel's plain version: only when the
    operands lie on the CPU, where no kernel runs.

    ``interpret`` has the JAX package's slot and is checked against the
    operands, never used to pick a path: ``None`` takes the operands'
    device (the kernel on CUDA tensors, the plain version on CPU tensors);
    ``True`` (the plain version) is allowed only on CPU tensors and
    ``False`` (the kernel) only on CUDA tensors; the other pairs raise.
    Any other device raises.
    """
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {device}")
    if device.type == "cpu":
        if interpret is False:
            raise ValueError(
                f"{name}: interpret=False asks for the CUDA kernel, but the "
                f"operands lie on the CPU; pass CUDA tensors, or "
                f"interpret=None/True for the plain version")
        return True
    if interpret:
        raise ValueError(
            f"{name}: interpret=True asks for the plain version, but the "
            f"operands lie on the card, where the wrapper runs its CUDA "
            f"kernel; pass CPU tensors, or interpret=None/False")
    return False


def check_layout_operands(name: str, grid_rb, vals_e, local_rows, rows_e,
                          n_rows_pad: int, *windows, block_nnz: int,
                          block_rows: int, smem_bytes: Callable[[int], int],
                          interpret: "bool | None" = None) -> tuple:
    """Validate layout-expanded kernel operands; returns ``(dtype, plain)``:
    the element dtype, and whether the plain version runs
    (:func:`runs_plain`).

    ``rows_e`` is the (n_grid*block_nnz, R) expanded Π or Khatri-Rao rows;
    each of ``windows`` must be an (n_rows_pad, R) window (the B window of
    the Φ kernels).  ``smem_bytes(R)`` is the kernel's shared memory per
    block, checked against Hopper's limit when the kernel is to run.
    """
    dt = check_kernel_dtype(name, vals_e, rows_e, *windows)
    g = grid_rb.shape[0] if grid_rb.dim() else -1
    r = rows_e.shape[1] if rows_e.dim() == 2 else -1
    if (grid_rb.dim() != 1 or vals_e.shape != (g * block_nnz,)
            or local_rows.shape != (g * block_nnz,)
            or rows_e.shape != (g * block_nnz, r)
            or n_rows_pad % block_rows
            or any(w.shape != (n_rows_pad, r) for w in windows)):
        raise ValueError(
            f"{name}: shapes do not fit the layout (block_nnz={block_nnz}, "
            f"block_rows={block_rows}, n_rows_pad={n_rows_pad}): grid_rb "
            f"{tuple(grid_rb.shape)}, vals_e {tuple(vals_e.shape)}, "
            f"local_rows {tuple(local_rows.shape)}, rows "
            f"{tuple(rows_e.shape)}, windows "
            f"{[tuple(w.shape) for w in windows]}"
        )
    if grid_rb.dtype != torch.int32 or local_rows.dtype != torch.int32:
        raise ValueError(f"{name}: grid_rb and local_rows must be int32")
    ops = (grid_rb, vals_e, local_rows, rows_e, *windows)
    devs = {t.device for t in ops}
    if len(devs) != 1:
        raise ValueError(f"{name}: operands on several devices {devs}")
    if not all(t.is_contiguous() for t in ops):
        raise ValueError(f"{name}: operands must be contiguous")
    plain = runs_plain(name, rows_e.device, interpret)
    if not plain:
        check_card_limits(name, r, block_nnz=block_nnz,
                          block_rows=block_rows, smem_bytes=smem_bytes)
    return dt, plain


def check_card_limits(name: str, rank: int, *, block_nnz: int,
                      block_rows: int,
                      smem_bytes: Callable[[int], int]) -> None:
    """Raise where a launch on the card could not run: a rank outside
    1..MAX_RANK, or ``smem_bytes(rank)`` above Hopper's shared memory."""
    if not 1 <= rank <= MAX_RANK:
        raise CardLimitError(f"{name}: rank {rank} outside 1..{MAX_RANK}")
    smem = smem_bytes(rank)
    if smem > SMEM_LIMIT:
        raise CardLimitError(
            f"{name}: block_nnz={block_nnz}, block_rows={block_rows} at "
            f"rank {rank} need {smem} bytes of shared memory per block "
            f"(limit {SMEM_LIMIT})"
        )
