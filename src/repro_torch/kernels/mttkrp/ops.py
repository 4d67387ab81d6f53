"""Wrappers for the MTTKRP CUDA kernel: checks, padding and launch counts.

``mttkrp_blocked``/``mttkrp_blocked_arrays`` take layout-expanded inputs
(``repro_torch.core.phi.expand_to_layout``) with the JAX package's
signatures and return the padded (n_rows_pad, R) window in the caller's
element dtype (f32 or bf16; f64 raises).  Accumulation is f32.

A wrapper given tensors on the CPU computes the kernel's plain version
(``ref.py``); given CUDA tensors it launches the kernel or raises.
``interpret`` is the JAX package's parameter, checked against the
operands' device as
:func:`repro_torch.kernels._checks.runs_plain`.  Each launch adds one to
:data:`launch_counts`.
"""
from __future__ import annotations

import torch

from ...core.layout import BlockedLayout
from .._checks import check_layout_operands
from ..dtypes import ACC_DTYPE
from ..phi import kernel as phi_kernel
from . import kernel, ref

__all__ = ["launch_counts", "mttkrp_blocked", "mttkrp_blocked_arrays",
           "reset_launch_counts", "smem_bytes"]

#: kernel launches since the last reset
launch_counts = {"mttkrp_blocked": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def smem_bytes(block_nnz: int, block_rows: int, rank: int,
               dtype: torch.dtype = torch.float32) -> int:
    """Shared memory per CTA of the MTTKRP kernel: it runs the Φ kernels'
    accumulation (``csrc/accum.cuh``), so this is their footprint
    (:func:`repro_torch.kernels.phi.kernel.smem_bytes`), which does not
    grow with block_nnz x rank and ignores block_rows."""
    return phi_kernel.smem_bytes(block_nnz, block_rows, rank, dtype)


def mttkrp_blocked_arrays(grid_rb, vals_e, local_rows, kr_e, *,
                          block_nnz: int, block_rows: int, n_rows_pad: int,
                          interpret: bool | None = None) -> torch.Tensor:
    """MTTKRP on raw layout tensors (``grid_rb``/``local_rows`` int32
    tensors on the operands' device): the padded (n_rows_pad, R) window."""
    dt, plain = check_layout_operands(
        "mttkrp_blocked", grid_rb, vals_e, local_rows, kr_e, n_rows_pad,
        block_nnz=block_nnz, block_rows=block_rows,
        smem_bytes=lambda r: smem_bytes(block_nnz, block_rows, r,
                                        kr_e.dtype),
        interpret=interpret)
    kw = dict(block_nnz=block_nnz, block_rows=block_rows)
    if plain:
        return ref.mttkrp_blocked_arrays_ref(
            grid_rb, vals_e, local_rows, kr_e, n_rows_pad=n_rows_pad,
            **kw).to(dt)
    out = torch.zeros((n_rows_pad, kr_e.shape[1]), dtype=ACC_DTYPE,
                      device=kr_e.device)
    kernel.launch_mttkrp(grid_rb, vals_e, local_rows, kr_e, out, **kw)
    launch_counts["mttkrp_blocked"] += 1
    return out.to(dt)


def mttkrp_blocked(layout: BlockedLayout, vals_e, kr_e,
                   interpret: bool | None = None) -> torch.Tensor:
    """MTTKRP via the kernel on a prebuilt blocked layout; returns the
    padded (n_rows_pad, R) result (callers slice to n_rows)."""
    lt = layout.on(kr_e.device)
    return mttkrp_blocked_arrays(lt.grid_rb, vals_e, lt.local_rows, kr_e,
                                 block_nnz=layout.block_nnz,
                                 block_rows=layout.block_rows,
                                 n_rows_pad=layout.n_rows_pad,
                                 interpret=interpret)
