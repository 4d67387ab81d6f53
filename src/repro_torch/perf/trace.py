"""Where a steady sweep's time goes on the card (torch.profiler).

  PYTHONPATH=src python -m repro_torch.perf.trace --tensor uber --rank 16
  PYTHONPATH=src python -m repro_torch.perf.trace --solver cp_als
  PYTHONPATH=src python -m repro_torch.perf.trace --tensor near-dense \
      --strategy dense

Makes the tensor from the seed (``near-dense`` is the dense tier's
(128, 256, 128) tensor at its cap) and runs a warm-up solve.  A sweep is
one outer iteration of ``cpapr_mu`` or one iteration of ``cp_als``.
Then:

* unprofiled solves give the steady sweep's host seconds: for
  ``cpapr_mu`` the median of its sweeps after the first, for ``cp_als``
  a 1-iteration solve subtracted from a ``1 + --sweeps`` one;
* two profiled solves, of 1 and of ``1 + --sweeps`` sweeps, are
  subtracted, so the solve's set-up (validation, sorts, layouts, their
  host<->device copies) and the first sweep cancel, leaving the device
  time per steady sweep by kernel name and the device-busy time (the
  union of all device intervals).

The idle share is ``1 - busy / steady sweep seconds``: the part of a
sweep the card spends waiting for the host.  The same two profiles give
the device time under each of the solve's spans (:mod:`repro_torch.spans`:
``SPANS`` for ``cpapr_mu``, ``ALS_SPANS`` for ``cp_als``), with the
kernels that make it up: the preparation's spans per solve, the sweep's
(an iteration's) per steady sweep (the difference).  ``--json`` also
writes the numbers to a file.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from ..core.cpals import cp_als
from ..core.cpapr import CPAPRConfig, cpapr_mu
from ..data.tensors import TENSOR_NAMES, make_near_dense, make_tensor
from ..device import resolve_device
from ..spans import ALS_SPANS, SPANS

__all__ = ["busy_us", "main", "span_kernels_us", "sweep_breakdown"]

_NAMES = frozenset(SPANS + ALS_SPANS)
#: prefixes of the spans that recur every sweep (or iteration)
_PER_SWEEP = ("cpapr.sweep.", "cpals.iter.")


def busy_us(intervals: list) -> float:
    """Length of the union of ``(start, end)`` intervals (microseconds)."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _solver(solver: str, rank: int, seed: int, max_inner: int,
            strategy: str, dev):
    """``run(t, n)``: the solve of ``n`` sweeps; a CP-APR result or the
    CP-ALS ``(KTensor, fits)``."""
    if solver == "cp_als":
        return lambda t, n: cp_als(t, rank, n_iters=n, seed=seed,
                                   strategy=strategy, device=dev)
    return lambda t, n: cpapr_mu(
        t, rank, seed=seed, device=dev,
        config=CPAPRConfig(rank=rank, max_outer=n, max_inner=max_inner,
                           strategy=strategy))


def span_kernels_us(events) -> dict:
    """``{span: {kernel name: µs}}``: the device time of the kernels
    launched under each of the solve's spans, from the profiler's event
    tree (``prof.events()``; a kernel hangs under the operator that
    launched it)."""
    out: dict = {}
    for e in events:
        if e.name not in _NAMES:
            continue
        by_kernel = out.setdefault(e.name, {})
        stack = [e]
        while stack:
            ev = stack.pop()
            for k in ev.kernels:
                by_kernel[k.name] = by_kernel.get(k.name, 0.0) + k.duration
            stack.extend(ev.cpu_children)
    return out


def _profiled(run, t, n: int, dev) -> tuple:
    """(device busy µs, {kernel name: µs}, :func:`span_kernels_us`) of one
    solve of ``n`` sweeps."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        run(t, n)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    on_device = [e for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: dict = {}
    for e in on_device:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    intervals = [(e.time_range.start, e.time_range.end) for e in on_device]
    return busy_us(intervals), by_name, span_kernels_us(prof.events())


def _per_span(s1: dict, s_n: dict, sweeps: int) -> dict:
    """``{span: {kernel name: s}}``: a preparation span's seconds per solve
    (the longer solve's), a sweep span's per steady sweep (the longer
    solve's less the 1-sweep solve's, over ``sweeps``)."""
    out = {}
    for span, kernels in s_n.items():
        if span.startswith(_PER_SWEEP):
            base = s1.get(span, {})
            sec = {k: (us - base.get(k, 0.0)) / sweeps / 1e6
                   for k, us in kernels.items()}
        else:
            sec = {k: us / 1e6 for k, us in kernels.items()}
        out[span] = dict(sorted(sec.items(), key=lambda kv: -kv[1]))
    return out


def _host_s(run, t, n: int, dev) -> float:
    t0 = time.perf_counter()
    run(t, n)
    torch.cuda.synchronize(dev)
    return time.perf_counter() - t0


def _breakdown(t, rank: int, seed: int, sweeps: int, max_inner: int,
               strategy: str, dev, solver: str = "cpapr") -> dict:
    run = _solver(solver, rank, seed, max_inner, strategy, dev)
    run(t, 1)  # warm-up
    out = {"nnz": t.nnz, "rank": rank, "solver": solver,
           "strategy": strategy}
    if solver == "cp_als":
        steady_s = (_host_s(run, t, 1 + sweeps, dev)
                    - _host_s(run, t, 1, dev)) / sweeps
    else:
        res = run(t, 1 + sweeps)
        steady_s = statistics.median(res.sweep_seconds[1:])
        out["inner_iters"] = res.inner_iters
    busy1, k1, s1 = _profiled(run, t, 1, dev)
    busy_n, k_n, s_n = _profiled(run, t, 1 + sweeps, dev)
    per_sweep = {name: (us - k1.get(name, 0.0)) / sweeps / 1e6
                 for name, us in k_n.items()}
    out["span_kernel_s"] = _per_span(s1, s_n, sweeps)
    busy_s = (busy_n - busy1) / sweeps / 1e6
    return {
        **out,
        "steady_sweep_s": steady_s,
        "device_busy_per_sweep_s": busy_s,
        "device_idle_share": 1.0 - busy_s / steady_s,
        "kernel_s_per_sweep": dict(sorted(per_sweep.items(),
                                          key=lambda kv: -kv[1])),
    }


def sweep_breakdown(tensor: str = "uber", scale: float = 1.0, rank: int = 16,
                    seed: int = 0, sweeps: int = 2, max_inner: int = 10,
                    strategy: str = "cuda", device="cuda",
                    solver: str = "cpapr") -> dict:
    """The steady-sweep breakdown of one tensor on the card."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("sweep_breakdown measures the card: device must "
                           "be a CUDA device")
    if tensor == "near-dense":
        t = make_near_dense(seed=seed, device=dev)
    else:
        t, _ = make_tensor(tensor, scale=scale, rank=rank, seed=seed,
                           device=dev)
    out = _breakdown(t, rank, seed, sweeps, max_inner, strategy, dev, solver)
    out["tensor"] = tensor
    out["card"] = torch.cuda.get_device_name(dev)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tensor", default="uber",
                    choices=TENSOR_NAMES + ("near-dense",))
    ap.add_argument("--solver", default="cpapr", choices=("cpapr", "cp_als"))
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--rank", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sweeps", type=int, default=2)
    ap.add_argument("--strategy", default="cuda",
                    choices=("cuda", "blocked", "segment", "scatter", "dense"))
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    out = sweep_breakdown(args.tensor, args.scale, args.rank, args.seed,
                          args.sweeps, strategy=args.strategy,
                          solver=args.solver)
    print(f"{out['tensor']} rank {out['rank']} nnz {out['nnz']} "
          f"{out['solver']} {out['strategy']} on {out['card']}: steady sweep "
          f"{out['steady_sweep_s']:.6f} s, device busy "
          f"{out['device_busy_per_sweep_s']:.6f} s per sweep, idle share "
          f"{out['device_idle_share']:.3f}")
    for name, s in list(out["kernel_s_per_sweep"].items())[:15]:
        print(f"  {s * 1e3:10.4f} ms/sweep  {name[:100]}")
    for span, kernels in out["span_kernel_s"].items():
        per = "sweep" if span.startswith(_PER_SWEEP) else "solve"
        print(f"  {sum(kernels.values()) * 1e3:10.4f} ms/{per:5s}  {span}")
        for name, s in list(kernels.items())[:4]:
            print(f"  {s * 1e3:16.4f}  {name[:90]}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
