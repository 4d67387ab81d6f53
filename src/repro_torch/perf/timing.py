"""Timing harness: CUDA events on the card, and fenced wall clock.

:func:`cuda_ms` refuses to run without a CUDA device: a time taken on
the CPU is never reported as a device time.

:func:`bench_seconds` and :func:`bench_burst_seconds` keep the JAX
package's signatures and median semantics (the paper averages 5 runs per
experiment, Sec. 4; these report the median of ``iters`` timed calls
after ``warmup`` untimed ones).  Each call is fenced with
``torch.cuda.synchronize()`` where its outputs lie on a CUDA device, in
place of ``block_until_ready``, so the host clock covers the device work.

:func:`bench_burst_seconds` is the variant for functions that loop
internally: one call covers ``burst`` algorithm iterations, so
per-iteration numbers include the revisit/cache effects a one-shot call
misses while amortizing the launch overhead a one-shot call over-counts.

:func:`step_burst_seconds` times ``burst`` chained calls ``b <- step(b)``
(the autotuner's probe of the solver's inner loop).  On the card the
burst is captured once in a CUDA graph (:func:`graph_burst`) and the
replays are timed with CUDA events, so the host's time per wrapper call
(0.03-0.15 ms) stays out of the measurement; on the CPU the plain loop is
timed with ``perf_counter``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from ..kernels.dense.kernel import hold_workspaces

__all__ = ["bandwidth_gbs", "bench_burst_seconds", "bench_seconds", "cuda_ms",
           "graph_burst", "step_burst_seconds"]


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


def _cuda_devices(out, found: set) -> None:
    """Collect the CUDA devices of the tensors in ``out`` (tensors,
    sequences, dicts and dataclasses, searched recursively)."""
    if isinstance(out, torch.Tensor):
        if out.device.type == "cuda":
            found.add(out.device)
    elif isinstance(out, (list, tuple)):
        for x in out:
            _cuda_devices(x, found)
    elif isinstance(out, dict):
        for x in out.values():
            _cuda_devices(x, found)
    elif dataclasses.is_dataclass(out) and not isinstance(out, type):
        for f in dataclasses.fields(out):
            _cuda_devices(getattr(out, f.name), found)


def _block_until_ready(out) -> None:
    """Wait for the device work behind ``out``: synchronize every CUDA
    device one of its tensors lies on."""
    found: set = set()
    _cuda_devices(out, found)
    for dev in found:
        torch.cuda.synchronize(dev)


def bench_seconds(
    fn: Callable, *args, warmup: int = 2, iters: int = 5, **kwargs
) -> float:
    """Median seconds per call of ``fn`` (fenced)."""
    for _ in range(warmup):
        _block_until_ready(fn(*args, **kwargs))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _block_until_ready(fn(*args, **kwargs))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def bench_burst_seconds(
    fn: Callable, *args, burst: int, warmup: int = 1, iters: int = 2,
    pass_burst: bool = True, **kwargs
) -> float:
    """Median per-iteration seconds of an internally-looping function.

    ``fn`` must accept ``burst`` as a keyword (the loop's bound) and
    execute that many algorithm iterations per call.  Returns the timed
    median divided by ``burst``: directly comparable to
    :func:`bench_seconds` of one iteration.  ``pass_burst=False`` is for
    callables with the loop bound already fixed; the divisor is still
    ``burst``, it just isn't forwarded as a keyword.
    """
    if burst < 1:
        raise ValueError(f"burst must be >= 1, got {burst}")
    if pass_burst:
        kwargs["burst"] = burst
    sec = bench_seconds(fn, *args, warmup=warmup, iters=iters, **kwargs)
    return sec / burst


def _chain(step: Callable, b, burst: int) -> tuple:
    """``burst`` calls ``b <- step(b)``; returns the last ``(b, viol)``."""
    viol = None
    for _ in range(burst):
        b, viol = step(b)
    return b, viol


def graph_burst(step: Callable, b: torch.Tensor, burst: int,
                warmup: int = 1) -> tuple:
    """Capture ``burst`` chained calls ``b <- step(b)`` in one CUDA graph.

    ``step(b) -> (b', viol)`` must be capturable (no host sync).  After
    ``warmup`` eager bursts (which load the kernels' libraries and cache
    the layouts' device copies) the burst is captured.  Returns
    ``(replay, (b_out, viol))``: each ``replay()`` reruns the burst from
    ``b``, leaving its result in the static ``b_out`` and ``viol``.
    """
    if burst < 1:
        raise ValueError(f"burst must be >= 1, got {burst}")
    _require_cuda("graph_burst")
    for _ in range(warmup):
        _chain(step, b, burst)
    torch.cuda.synchronize(b.device)
    graph = torch.cuda.CUDAGraph()
    with hold_workspaces() as held, torch.cuda.graph(graph):
        out = _chain(step, b, burst)
    graph.held_workspaces = held  # alive as long as graph.replay is
    return graph.replay, out


def step_burst_seconds(step: Callable, b: torch.Tensor, burst: int,
                       warmup: int = 1, iters: int = 2) -> float:
    """Median seconds per step of ``burst`` chained calls ``b <- step(b)``.

    On a CUDA ``b`` the burst runs as one CUDA graph (:func:`graph_burst`)
    replayed ``iters`` times between CUDA events: device time, with no
    host time per call in it.  On the CPU the plain loop is timed with
    the host clock (:func:`bench_burst_seconds`).
    """
    if burst < 1:
        raise ValueError(f"burst must be >= 1, got {burst}")
    if b.device.type != "cuda":
        return bench_burst_seconds(lambda: _chain(step, b, burst),
                                   burst=burst, warmup=warmup, iters=iters,
                                   pass_burst=False)
    replay, _ = graph_burst(step, b, burst, warmup=warmup)
    times = []
    for _ in range(max(iters, 1)):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        replay()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / 1e3)
    times.sort()
    return times[len(times) // 2] / burst


def bandwidth_gbs(bytes_moved: float, seconds: float) -> float:
    return bytes_moved / seconds / 1e9 if seconds > 0 else 0.0
