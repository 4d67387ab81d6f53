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
           "check_layout_operands"]

MAX_RANK = 1024  # the largest rank the CUDA kernels take
SMEM_LIMIT = 232_448  # bytes of shared memory a block may use on Hopper


class CardLimitError(ValueError):
    """A launch the card could not run, refused before it starts: a rank
    outside 1..MAX_RANK or more shared memory per block than Hopper has.
    The JAX package's kernel tier fails the same cases at compile time."""


def check_layout_operands(name: str, grid_rb, vals_e, local_rows, rows_e,
                          n_rows_pad: int, *windows, block_nnz: int,
                          block_rows: int,
                          smem_bytes: Callable[[int], int]) -> torch.dtype:
    """Validate layout-expanded kernel operands; returns the element dtype.

    ``rows_e`` is the (n_grid*block_nnz, R) expanded Π or Khatri-Rao rows;
    each of ``windows`` must be an (n_rows_pad, R) window (the B window of
    the Φ kernels).  ``smem_bytes(R)`` is the kernel's shared memory per
    block, checked against Hopper's limit when the operands are on a card.
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
    dev = rows_e.device
    if dev.type == "cuda":
        check_card_limits(name, r, block_nnz=block_nnz,
                          block_rows=block_rows, smem_bytes=smem_bytes)
    elif dev.type != "cpu":
        raise ValueError(f"{name}: no kernel for device {dev}")
    return dt


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
