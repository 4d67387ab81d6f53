"""Wrapper for the Π-rows kernel: checks and the launch count.

``pi_gather`` forms mode ``n``'s Π rows straight in a blocked layout's
slot order, with the values beside them (``csrc/pi.cu``): what
``expand_to_layout`` makes of the values and ``pi_rows``, bitwise, in
one pass.  The ``cuda`` kernel family runs it once per mode update
(``repro_torch.core.phi.bind_mode``).

Given tensors on the CPU the wrapper computes the kernel's plain version
(``ref.py``); given CUDA tensors it launches the kernel or raises.  Each
launch adds one to :data:`launch_counts`.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ...core.layout import BlockedLayout
from .._checks import MAX_RANK, CardLimitError, runs_plain
from ..dtypes import check_kernel_dtype
from . import kernel, ref

__all__ = ["launch_counts", "pi_gather", "reset_launch_counts"]

#: kernel launches since the last reset
launch_counts = {"pi_gather": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _check_inputs(idx, vals, factors, n: int) -> tuple:
    """``(dtype, rank)`` of valid operands; raises on what the kernel does
    not take."""
    n_modes = len(factors)
    if not 0 <= n < n_modes:
        raise ValueError(f"pi_gather: mode {n} outside 0..{n_modes - 1}")
    dt = check_kernel_dtype("pi_gather", vals, *factors)
    r = factors[0].shape[1] if factors[0].dim() == 2 else -1
    if (idx.shape != (idx.shape[0], n_modes)
            or vals.shape != (idx.shape[0],)
            or any(f.shape != (f.shape[0], r) for f in factors)):
        raise ValueError(
            f"pi_gather: idx {tuple(idx.shape)}, vals {tuple(vals.shape)} "
            f"and factors {[tuple(f.shape) for f in factors]} are not "
            f"(nnz, N) coordinates, (nnz,) values and N (I_m, R) factors")
    if idx.dtype != torch.int64:
        raise ValueError("pi_gather: idx must be int64")
    if not all(t.is_contiguous() for t in (idx, vals, *factors)):
        raise ValueError("pi_gather: operands must be contiguous")
    devs = {t.device for t in (idx, vals, *factors)}
    if len(devs) != 1:
        raise ValueError(f"pi_gather: operands on several devices {devs}")
    return dt, r


def pi_gather(layout: BlockedLayout, idx: torch.Tensor, vals: torch.Tensor,
              factors: Sequence[torch.Tensor], n: int) -> tuple:
    """``(vals_e, pi_e)``: the values and mode ``n``'s Π rows in
    ``layout``'s slot order, as :func:`repro_torch.core.phi.expand_to_layout`
    gives them.  ``pi_e`` holds the (n_grid*block_nnz, R) rows
    ``prod_{m != n} A^(m)[idx[gather[j], m]]`` (ascending ``m``, each
    product rounded to the element dtype), ``vals_e`` the (n_grid*
    block_nnz,) values ``vals[gather[j]]``, both 0 on padding slots.
    ``idx`` and ``vals`` are the (nnz, N) sorted coordinates and (nnz,)
    values the layout was built on."""
    dt, r = _check_inputs(idx, vals, factors, n)
    if runs_plain("pi_gather", idx.device, None):
        return ref.pi_gather_ref(layout, idx, vals, factors, n)
    if not 1 <= r <= MAX_RANK:
        raise CardLimitError(f"pi_gather: rank {r} outside 1..{MAX_RANK}")
    lt = layout.on(idx.device)
    n_slots = lt.gather.shape[0]
    vals_e = torch.empty((n_slots,), dtype=dt, device=idx.device)
    pi_e = torch.empty((n_slots, r), dtype=dt, device=idx.device)
    kernel.launch_pi_gather(lt.gather, lt.valid, idx, vals, factors, n, pi_e,
                            vals_e)
    launch_counts["pi_gather"] += 1
    return vals_e, pi_e
