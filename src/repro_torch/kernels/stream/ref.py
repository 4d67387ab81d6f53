"""Plain PyTorch versions of the STREAM ops (paper Table 3).

Scale and triad round after each operation, as the JAX package's
``s * b`` and ``b + s * c`` do (never one fused multiply-add), so the
CUDA kernel is held to these bitwise on the card.  Copy returns a fresh
tensor holding b's bits (the reference writes ``b + 0.0``, which would
also turn -0.0 into +0.0).
"""
from __future__ import annotations

import torch

__all__ = ["stream_ref", "stream_bytes_flops"]


def stream_ref(op: str, b: torch.Tensor, c: torch.Tensor | None = None,
               s: float = 3.0) -> torch.Tensor:
    if op == "copy":
        return b.clone()
    if op == "scale":
        return s * b
    if op == "add":
        return b + c
    if op == "triad":
        return b + s * c
    raise ValueError(op)


def stream_bytes_flops(op: str, n_elems: int, itemsize: int = 4) -> tuple:
    """(bytes moved, FLOPs) per paper Table 3 (8-byte words there; we scale)."""
    table = {"copy": (2, 0), "scale": (2, 1), "add": (3, 1), "triad": (3, 2)}
    words, flops = table[op]
    return words * n_elems * itemsize, flops * n_elems
