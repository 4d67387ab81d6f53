"""ctypes launchers for the Φ CUDA kernels (``kernels/csrc/phi.cu``).

The library is built from the checkout's source at first use
(:mod:`repro_torch.kernels._build`) and loaded once per process.  The
launchers take device tensors that the wrappers in ``ops.py`` have
already checked, enqueue on PyTorch's current stream without
synchronising, and raise if the C launcher reports a CUDA error.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .._build import DTYPE_CODE, F as _F, I as _I, P as _P, check_launch, stream_of

__all__ = ["launch_phi", "launch_phi_mu", "library_smem_bytes",
           "load_library", "smem_bytes"]

_SIGNATURES = {
    "phi_blocked_launch": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "phi_mu_blocked_launch": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                              _I, ctypes.c_longlong, _F, _P],
    "phi_accum_smem_bytes": [_I, _I, _I, _I],
}

# the per-warp ring of csrc/accum.cuh (the accumulation kernel that Φ and
# sparse MTTKRP share); smem_bytes mirrors its accum_shape
_STAGES = 2
_CHUNK_BYTES = 2048
_SMEM_BUDGET = 56 * 1024
_MAX_WARPS = 8


def _region(n: int) -> int:
    """Shared bytes that hold a copy of n bytes at any 16-byte phase."""
    return (n + 15) // 16 * 16 + 16


def smem_bytes(block_nnz: int, block_rows: int, rank: int,
               dtype: torch.dtype = torch.float32) -> int:
    """Shared memory per CTA of the accumulation kernel that Φ and sparse
    MTTKRP share (``csrc/accum.cuh``; f32 unless ``dtype`` says bf16).
    Each warp has a ring of two stages, each a chunk of Π (or Khatri-Rao)
    rows (2 KB of f32 rows, the same count of bf16 rows; at least one row,
    at most a grid step) with its values, local rows and row blocks, each
    region padded to copy at any 16-byte phase; a CTA has as many warps (at
    most 8) as fit 56 KB in f32.  The footprint does not grow with
    block_nnz x rank and does not depend on block_rows."""
    chunk = min(block_nnz, max(1, _CHUNK_BYTES // (4 * rank)))

    def stage(isz):
        return sum(_region(n) for n in (chunk * rank * isz, chunk * isz,
                                        4 * chunk, 8))

    # warps from the f32 stage, so a bf16 CTA is never larger
    warps = min(_MAX_WARPS, max(1, _SMEM_BUDGET // (_STAGES * stage(4))))
    return warps * _STAGES * stage(2 if dtype == torch.bfloat16 else 4)


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the Φ kernels' shared library."""
    return _build.load_library("phi", _SIGNATURES)


def library_smem_bytes(block_nnz: int, block_rows: int, rank: int,
                       dtype: torch.dtype = torch.float32) -> int:
    """The compiled kernel's own count of :func:`smem_bytes`."""
    return int(load_library().phi_accum_smem_bytes(
        DTYPE_CODE[dtype], block_nnz, block_rows, rank))


def launch_phi(grid_rb, vals_e, local_rows, pi_e, b_win, phi, *,
               block_nnz: int, block_rows: int, eps: float) -> None:
    """Enqueue the plain Φ kernel; ``phi`` is a zeroed f32 window."""
    lib = load_library()
    with torch.cuda.device(b_win.device):
        err = lib.phi_blocked_launch(
            DTYPE_CODE[pi_e.dtype], grid_rb.data_ptr(), vals_e.data_ptr(),
            local_rows.data_ptr(), pi_e.data_ptr(), b_win.data_ptr(),
            phi.data_ptr(), int(grid_rb.shape[0]), int(block_nnz),
            int(block_rows), int(pi_e.shape[1]), float(eps), stream_of(b_win))
    check_launch("phi_blocked", err)


def launch_phi_mu(grid_rb, vals_e, local_rows, pi_e, b_win, phi, mu, viol, *,
                  block_nnz: int, block_rows: int, eps: float) -> None:
    """Enqueue the fused Φ -> (B*Φ, KKT) kernels; ``phi`` is zeroed f32
    scratch, ``viol`` one zeroed f32."""
    lib = load_library()
    with torch.cuda.device(b_win.device):
        err = lib.phi_mu_blocked_launch(
            DTYPE_CODE[pi_e.dtype], grid_rb.data_ptr(), vals_e.data_ptr(),
            local_rows.data_ptr(), pi_e.data_ptr(), b_win.data_ptr(),
            phi.data_ptr(), mu.data_ptr(), viol.data_ptr(),
            int(grid_rb.shape[0]), int(block_nnz), int(block_rows),
            int(pi_e.shape[1]), int(b_win.shape[0]), float(eps),
            stream_of(b_win))
    check_launch("phi_mu_blocked", err)
