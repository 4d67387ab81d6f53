"""ctypes launcher for the STREAM CUDA kernel (``kernels/csrc/stream.cu``).

Built from the checkout's source at first use and loaded once per
process, like the Φ kernels' library (:mod:`repro_torch.kernels.phi.kernel`).
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .._build import DTYPE_CODE, F as _F, I as _I, P as _P, check_launch, stream_of

__all__ = ["STREAM_OPS", "launch_stream", "load_library"]

STREAM_OPS = ("copy", "scale", "add", "triad")

_SIGNATURES = {
    "stream_launch": [_I, _I, _P, _P, _P, ctypes.c_longlong, _I, _F, _P],
}


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the STREAM kernel's shared library."""
    return _build.load_library("stream", _SIGNATURES)


def launch_stream(op: str, b, c, out, *, block_rows: int, s: float) -> None:
    """Enqueue one STREAM op over ``b`` (and ``c``) into ``out``: all
    contiguous, 16-byte aligned, of one length that is a multiple of
    128*block_rows.  ``c`` is read only by add and triad."""
    lib = load_library()
    with torch.cuda.device(b.device):
        err = lib.stream_launch(
            STREAM_OPS.index(op), DTYPE_CODE[b.dtype], b.data_ptr(),
            c.data_ptr(), out.data_ptr(), int(b.shape[0]), int(block_rows),
            float(s), stream_of(b))
    check_launch(f"stream_{op}", err)
