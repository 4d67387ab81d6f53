"""Wrapper for the STREAM CUDA kernel: checks and launch counts.

``stream_op`` keeps every check of the JAX package's ``stream_op``, with
the same messages: the op name, a 1-D input whose length is a multiple
of 128 and of 128*block_rows, ``c`` required (never aliased to ``b``)
and of ``b``'s shape for add and triad, and the element dtype (f32 or
bf16; f64 raises).  The output is a fresh tensor in the input dtype.

Given tensors on the CPU it computes the plain version (``ref.py``);
given CUDA tensors it launches the kernel or raises.  ``interpret`` is
the JAX package's parameter, checked against the
operands' device as
:func:`repro_torch.kernels._checks.runs_plain`.  Each launch adds one to
:data:`launch_counts` under ``stream_<op>``.
"""
from __future__ import annotations

import torch

from .._checks import runs_plain
from ..dtypes import check_kernel_dtype
from . import kernel, ref
from .kernel import STREAM_OPS

__all__ = ["STREAM_OPS", "launch_counts", "reset_launch_counts", "stream_op"]

#: kernel launches per kernel name since the last reset
launch_counts = {f"stream_{op}": 0 for op in STREAM_OPS}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def stream_op(op: str, b: torch.Tensor, c: torch.Tensor | None = None,
              block_rows: int = 256, s: float = 3.0,
              interpret: bool | None = None) -> torch.Tensor:
    """One STREAM op.  Input length must be a multiple of 128*block_rows
    (benchmarks size arrays accordingly)."""
    if op not in STREAM_OPS:
        raise ValueError(
            f"unknown STREAM op {op!r} (choose from {sorted(STREAM_OPS)})"
        )
    if b.ndim != 1:
        raise ValueError(f"stream_op expects a 1-D array, got shape "
                         f"{tuple(b.shape)}")
    if block_rows < 1:
        raise ValueError(f"stream_op block_rows must be >= 1, got "
                         f"{block_rows}")
    n = b.shape[0]
    if n % 128 != 0:
        raise ValueError(
            f"stream_op input length {n} is not a multiple of the 128-lane "
            f"width; pad the array (it would be silently truncated to "
            f"{(n // 128) * 128} elements)"
        )
    tile = 128 * block_rows
    if n % tile != 0:
        raise ValueError(
            f"stream_op input length {n} is not a multiple of "
            f"128*block_rows={tile} (block_rows={block_rows}); pad the "
            f"array or pass a block_rows that divides {n // 128} rows"
        )
    needs_c = op in ("add", "triad")
    if needs_c:
        if c is None:
            raise ValueError(
                f"STREAM op {op!r} reads two arrays; pass c explicitly "
                f"(aliasing b would silently compute e.g. b+b)"
            )
        if c.shape != b.shape:
            raise ValueError(
                f"stream_op c shape {tuple(c.shape)} does not match b "
                f"shape {tuple(b.shape)}"
            )
    c_in = c if needs_c else b
    check_kernel_dtype("stream_op", b, c_in)
    if c_in.device != b.device:
        raise ValueError(f"stream_op: b on {b.device} but c on {c_in.device}")
    if runs_plain("stream_op", b.device, interpret):
        return ref.stream_ref(op, b, c_in if needs_c else None, s)
    for name, x in (("b", b), ("c", c_in)):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(
                f"stream_op: {name} must be contiguous and 16-byte aligned "
                f"on the card (the kernel moves 16-byte vectors); pass "
                f"{name}.clone()")
    out = torch.empty_like(b)
    if n == 0:
        return out
    kernel.launch_stream(op, b, c_in, out, block_rows=block_rows, s=s)
    launch_counts[f"stream_{op}"] += 1
    return out
