"""The traced window: torch.profiler's events reduced to what the readers
of per-layer metrics and the result's ``breakdown`` need.

The profiler records the host's operators and the device's kernels,
copies and sets over the window; :func:`reduce_events` keeps the device
intervals by name and the outermost host operators, and works out the
device's busy time as the union of its intervals (a frozen copy of the
port's ``perf/trace.py::busy_us`` arithmetic, in nanoseconds).
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import warnings

import torch

__all__ = ["Trace", "busy_ns", "profiled", "reduce_events"]


@dataclasses.dataclass
class Trace:
    """The device's intervals over a traced window, in nanoseconds of the
    profiler's clock: ``device`` as ``(name, start, end)``; ``host`` the
    outermost host operators as ``(name, start, end)``, by start."""

    device: list
    host: list

    def busy_s(self) -> float:
        return busy_ns([(s, e) for _, s, e in self.device]) * 1e-9

    def device_seconds(self, match) -> float:
        """Seconds of device work whose name ``match(name)`` accepts."""
        return sum(e - s for name, s, e in self.device if match(name)) * 1e-9

    def device_ops(self, top: int = 10) -> list:
        """The ``top`` device operations by total seconds, as
        ``[name, seconds]``."""
        by_name: dict = {}
        for name, s, e in self.device:
            by_name[name] = by_name.get(name, 0) + (e - s)
        ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        return [[name[:120], ns * 1e-9] for name, ns in ranked]

    def idle_gaps(self, top: int = 10) -> list:
        """The device's idle time between its first and last interval, by
        what the host was doing meanwhile: each gap's time shared out to
        the outermost host operators under way in it, the rest to
        ``python``; the ``top`` largest as ``[name, seconds]``."""
        starts = [s for _, s, _ in self.host]
        by_name: dict = {}
        end = None
        for _, s, e in sorted(self.device, key=lambda x: x[1]):
            if end is not None and s > end:
                self._share_gap(end, s, starts, by_name)
            end = e if end is None else max(end, e)
        ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        return [[name[:120], ns * 1e-9] for name, ns in ranked]

    def _share_gap(self, g0: int, g1: int, starts: list, by_name: dict) -> None:
        i = max(bisect.bisect_right(starts, g0) - 1, 0)
        covered = 0
        while i < len(self.host) and self.host[i][1] < g1:
            name, s, e = self.host[i]
            overlap = min(e, g1) - max(s, g0)
            if overlap > 0:
                by_name[name] = by_name.get(name, 0) + overlap
                covered += overlap
            i += 1
        if g1 - g0 > covered:
            by_name["python"] = by_name.get("python", 0) + (g1 - g0 - covered)


def busy_ns(intervals: list) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


@contextlib.contextmanager
def profiled(enabled: bool):
    """A torch.profiler session over the block (host and, where there is
    one, the device); yields a list that holds the :class:`Trace` once the
    block has ended, or stays empty when ``enabled`` is false."""
    out: list = []
    if not enabled:
        yield out
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield out
    finally:
        with warnings.catch_warnings():  # one cycle: all its events are kept
            warnings.simplefilter("ignore", UserWarning)
            prof.stop()
    out.append(reduce_events(prof))


def reduce_events(prof) -> Trace:
    """The :class:`Trace` of a stopped profiler, from its raw events (the
    profiler's own event tree costs seconds per million events)."""
    cuda = torch.autograd.DeviceType.CUDA
    device, host = [], []
    for ev in prof.profiler.kineto_results.events():
        s, e = ev.start_ns(), ev.end_ns()
        if e > s:
            (device if ev.device_type() == cuda else host).append(
                (ev.name(), s, e))
    host.sort(key=lambda x: x[1])
    outer, end = [], None
    for h in host:
        if end is None or h[1] >= end:
            outer.append(h)
            end = h[2]
    return Trace(device=device, host=outer)
