"""ctypes launchers for the dense kernels (``kernels/csrc/dense.cu``).

Built from the checkout's source at first use and loaded once per
process.  The launchers take device tensors that the wrappers in
``ops.py`` have already checked, enqueue on PyTorch's current stream
without synchronising, and raise if the C launcher reports a CUDA error.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .._build import DTYPE_CODE, F as _F, I as _I, P as _P, check_launch, stream_of

__all__ = ["launch_mttkrp", "launch_phi", "launch_phi_mu", "load_library"]

_SIGNATURES = {
    "dense_mttkrp_launch": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "dense_phi_launch": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    "dense_phi_mu_launch": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                            _I, _F, _P],
}


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the dense kernels' shared library."""
    return _build.load_library("dense", _SIGNATURES)


def _dims(x, c, block_k: int) -> tuple:
    k, i, j = x.shape
    return int(k), int(i), int(j), int(c.shape[1]), int(block_k)


def launch_mttkrp(x, c, a, out, *, block_k: int) -> None:
    """Enqueue the dense MTTKRP kernel; ``out`` is a zeroed f32 (I, R)."""
    lib = load_library()
    with torch.cuda.device(x.device):
        err = lib.dense_mttkrp_launch(
            DTYPE_CODE[x.dtype], x.data_ptr(), c.data_ptr(), a.data_ptr(),
            out.data_ptr(), *_dims(x, c, block_k), stream_of(x))
    check_launch("dense_mttkrp", err)


def launch_phi(x, c, a, b, phi, *, block_k: int, eps: float) -> None:
    """Enqueue the dense Φ kernel; ``phi`` is a zeroed f32 (I, R)."""
    lib = load_library()
    with torch.cuda.device(x.device):
        err = lib.dense_phi_launch(
            DTYPE_CODE[x.dtype], x.data_ptr(), c.data_ptr(), a.data_ptr(),
            b.data_ptr(), phi.data_ptr(), *_dims(x, c, block_k), float(eps),
            stream_of(x))
    check_launch("dense_phi", err)


def launch_phi_mu(x, c, a, b, phi, mu, viol, *, block_k: int,
                  eps: float) -> None:
    """Enqueue the fused dense Φ -> (B*Φ, KKT) kernels; ``phi`` is zeroed
    f32 scratch, ``viol`` one zeroed f32."""
    lib = load_library()
    with torch.cuda.device(x.device):
        err = lib.dense_phi_mu_launch(
            DTYPE_CODE[x.dtype], x.data_ptr(), c.data_ptr(), a.data_ptr(),
            b.data_ptr(), phi.data_ptr(), mu.data_ptr(), viol.data_ptr(),
            *_dims(x, c, block_k), float(eps), stream_of(x))
    check_launch("dense_phi_mu", err)
