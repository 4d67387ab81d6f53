"""Timing on the card with CUDA events.

:func:`cuda_ms` refuses to run without a CUDA device: a time taken on
the CPU is never reported as a device time.
"""
from __future__ import annotations

from typing import Callable

import torch

__all__ = ["cuda_ms"]


def _require_cuda(where: str) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(f"{where}: needs a CUDA device (none available)")


def cuda_ms(fn: Callable, *args, warmup: int = 2, iters: int = 10,
            **kwargs) -> float:
    """Mean device milliseconds per call of ``fn``, from CUDA events
    around ``iters`` back-to-back calls after ``warmup`` untimed ones."""
    _require_cuda("cuda_ms")
    for _ in range(warmup):
        fn(*args, **kwargs)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args, **kwargs)
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters
