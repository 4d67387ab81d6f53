"""ctypes launcher for the Π-rows kernel (``kernels/csrc/pi.cu``).

Built from the checkout's source at first use and loaded once per
process, like the Φ kernels' library (:mod:`repro_torch.kernels.phi.kernel`).
The launcher takes device tensors that the wrapper in ``ops.py`` has
already checked, enqueues on PyTorch's current stream without
synchronising, and raises if the C launcher reports a CUDA error.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .._build import DTYPE_CODE, I as _I, P as _P, check_launch, stream_of

__all__ = ["launch_pi_gather", "load_library"]

_SIGNATURES = {
    "pi_gather_launch": [_I, _P, _P, _P, _P, _I, _I, ctypes.POINTER(_P), _P,
                         _P, ctypes.c_longlong, _I, _P],
}


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the Π-rows kernel's shared library."""
    return _build.load_library("pi", _SIGNATURES)


def launch_pi_gather(gather, valid, idx, vals, factors, n: int, out,
                     vals_out) -> None:
    """Enqueue the kernel: ``out`` (n_slots, R) gets mode ``n``'s Π rows
    and ``vals_out`` (n_slots,) the values, both in slot order, every
    element written."""
    lib = load_library()
    ptrs = (_P * len(factors))(*(f.data_ptr() for f in factors))
    with torch.cuda.device(out.device):
        err = lib.pi_gather_launch(
            DTYPE_CODE[out.dtype], gather.data_ptr(), valid.data_ptr(),
            idx.data_ptr(), vals.data_ptr(), len(factors), int(n), ptrs,
            out.data_ptr(), vals_out.data_ptr(), int(out.shape[0]),
            int(out.shape[1]), stream_of(out))
    check_launch("pi_gather", err)
