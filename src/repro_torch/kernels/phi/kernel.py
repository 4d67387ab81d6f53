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

__all__ = ["launch_phi", "launch_phi_mu", "load_library"]

_SIGNATURES = {
    "phi_blocked_launch": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "phi_mu_blocked_launch": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                              _I, ctypes.c_longlong, _F, _P],
}


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the Φ kernels' shared library."""
    return _build.load_library("phi", _SIGNATURES)


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
