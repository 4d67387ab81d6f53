"""ctypes launcher for the MTTKRP CUDA kernel (``kernels/csrc/mttkrp.cu``).

Built from the checkout's source at first use and loaded once per
process, like the Φ kernels' library (:mod:`repro_torch.kernels.phi.kernel`),
whose accumulation kernel it shares (``csrc/accum.cuh``), and so its
shared-memory footprint (``phi.kernel.smem_bytes``).
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .._build import DTYPE_CODE, I as _I, P as _P, check_launch, stream_of

__all__ = ["launch_mttkrp", "library_smem_bytes", "load_library"]

_SIGNATURES = {
    "mttkrp_blocked_launch": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "mttkrp_accum_smem_bytes": [_I, _I, _I, _I],
}


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the MTTKRP kernel's shared library."""
    return _build.load_library("mttkrp", _SIGNATURES)


def library_smem_bytes(block_nnz: int, block_rows: int, rank: int,
                       dtype: torch.dtype = torch.float32) -> int:
    """The compiled kernel's own count of its shared memory per CTA, which
    :func:`repro_torch.kernels.phi.kernel.smem_bytes` mirrors."""
    return int(load_library().mttkrp_accum_smem_bytes(
        DTYPE_CODE[dtype], block_nnz, block_rows, rank))


def launch_mttkrp(grid_rb, vals_e, local_rows, kr_e, out, *, block_nnz: int,
                  block_rows: int) -> None:
    """Enqueue the MTTKRP kernel; ``out`` is a zeroed f32 window."""
    lib = load_library()
    with torch.cuda.device(kr_e.device):
        err = lib.mttkrp_blocked_launch(
            DTYPE_CODE[kr_e.dtype], grid_rb.data_ptr(), vals_e.data_ptr(),
            local_rows.data_ptr(), kr_e.data_ptr(), out.data_ptr(),
            int(grid_rb.shape[0]), int(block_nnz), int(block_rows),
            int(kr_e.shape[1]), stream_of(kr_e))
    check_launch("mttkrp_blocked", err)
