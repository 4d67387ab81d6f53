"""Plain PyTorch versions of the MTTKRP kernel (same function, same rounding).

``M[row, :] += x * kr_row``: the Φ reduction without the model divide.
Each contribution ``x * kr`` is rounded once to the element dtype (the TPU
kernel's ``vals * kr`` in that dtype) and accumulated in f32.  The wrapper
in :mod:`repro_torch.kernels.mttkrp.ops` takes these for CPU tensors, and
the tests and ``chip_smoke.py`` hold the CUDA kernel against them.
"""
from __future__ import annotations

import torch

from ..phi.ref import _acc, _global_rows

__all__ = ["mttkrp_ref", "mttkrp_blocked_ref"]


def mttkrp_ref(rows, vals, kr, n_rows: int) -> torch.Tensor:
    """Unblocked MTTKRP from raw per-nonzero arrays (rows in any order);
    returns the accumulator dtype."""
    acc = _acc(kr.dtype)
    contrib = (vals[:, None] * kr).to(acc)
    out = torch.zeros((n_rows, kr.shape[1]), dtype=acc, device=kr.device)
    return out.index_add_(0, rows, contrib)


def mttkrp_blocked_ref(grid_rb, vals_e, local_rows, kr_e, *, block_nnz: int,
                       block_rows: int, n_rows_pad: int) -> torch.Tensor:
    """MTTKRP on layout-expanded inputs: the padded (n_rows_pad, R)
    window, accumulator dtype (the plain version of ``mttkrp_blocked``).
    Padding slots carry x = 0 and add exactly 0."""
    rows = _global_rows(grid_rb, local_rows, block_nnz, block_rows)
    return mttkrp_ref(rows, vals_e, kr_e, n_rows_pad)
