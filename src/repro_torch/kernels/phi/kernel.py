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

__all__ = ["launch_phi", "launch_phi_mu", "load_library"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_lib = None


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the Φ kernels' shared library."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_build.build_library("phi")))
        lib.phi_blocked_launch.argtypes = [
            _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _P]
        lib.phi_blocked_launch.restype = _I
        lib.phi_mu_blocked_launch.argtypes = [
            _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
            ctypes.c_longlong, ctypes.c_float, _P]
        lib.phi_mu_blocked_launch.restype = _I
        _lib = lib
    return _lib


def _check(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def launch_phi(grid_rb, vals_e, local_rows, pi_e, b_win, phi, *,
               block_nnz: int, block_rows: int, eps: float) -> None:
    """Enqueue the plain Φ kernel; ``phi`` is a zeroed f32 window."""
    lib = load_library()
    with torch.cuda.device(b_win.device):
        err = lib.phi_blocked_launch(
            _DTYPE_CODE[pi_e.dtype], grid_rb.data_ptr(), vals_e.data_ptr(),
            local_rows.data_ptr(), pi_e.data_ptr(), b_win.data_ptr(),
            phi.data_ptr(), int(grid_rb.shape[0]), int(block_nnz),
            int(block_rows), int(pi_e.shape[1]), float(eps), _stream(b_win))
    _check("phi_blocked", err)


def launch_phi_mu(grid_rb, vals_e, local_rows, pi_e, b_win, phi, mu, viol, *,
                  block_nnz: int, block_rows: int, eps: float) -> None:
    """Enqueue the fused Φ -> (B*Φ, KKT) kernels; ``phi`` is zeroed f32
    scratch, ``viol`` one zeroed f32."""
    lib = load_library()
    with torch.cuda.device(b_win.device):
        err = lib.phi_mu_blocked_launch(
            _DTYPE_CODE[pi_e.dtype], grid_rb.data_ptr(), vals_e.data_ptr(),
            local_rows.data_ptr(), pi_e.data_ptr(), b_win.data_ptr(),
            phi.data_ptr(), mu.data_ptr(), viol.data_ptr(),
            int(grid_rb.shape[0]), int(block_nnz), int(block_rows),
            int(pi_e.shape[1]), int(b_win.shape[0]), float(eps),
            _stream(b_win))
    _check("phi_mu_blocked", err)
