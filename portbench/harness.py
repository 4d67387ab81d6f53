"""One run of one cell of the port's benchmark.

A cell is an entry of ``workloads`` in ``BENCHMARK.json``: a
configuration (``configs/<file>.json``: the tensor's sizes and how they
are drawn), a traffic mix (``traffic/<name>.json``: the solve and its
parameters), and a cell file (``cells/<name>.json``: the limit of each
number the correctness check compares).  The harness finds all of them,
the solver module the traffic names (``solvers/<solver>.py``), the
generator the configuration names (``generators/<generator>.py``) and
one reader per metric (``metrics/<metric>.py``), by name; a new cell,
mix, configuration or metric is a new file and its entries.

A run: load the cell; set up (draw the tensor and the start on the
device from the seed, one short warm-up solve); run the window (whole
solves back to back, each started while the window is open and timed
from its call to its return after a device synchronise; the window ends
when the last solve started in it returns); compare every solve of the
window with the plain reference; print the result's line.  With
``trace`` the window runs under torch.profiler and the per-layer metrics
are reported; without it, the end-to-end ones.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import re
import subprocess
import sys
import time
import traceback
from pathlib import Path

import torch

from .tracing import Trace, profiled

__all__ = ["Cell", "Run", "execute", "foreign_modules", "judge", "load_cell",
           "load_metric", "load_module", "main", "make_problem"]

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level module names that may not be loaded in a run's process: JAX
#: and the JAX package the port was made from
FOREIGN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    bench_dir: Path


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _entry(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json has no {what} named {name!r}")


def _for_cell(metrics: list, cell: str) -> list:
    return [m for m in metrics if cell in m.get("workloads", [cell])]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``, with its files."""
    bench = _json(root / "BENCHMARK.json")
    w = _entry(bench["workloads"], name, "workload")
    bench_dir = root / bench["paths"][0]
    config = _json(root / _entry(bench["configs"], w["config"],
                                 "configuration")["file"])
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=_json(bench_dir / "traffic" / f"{w['traffic']}.json"),
                limits=_json(bench_dir / "cells" / f"{name}.json")["limits"],
                end_to_end=_for_cell(bench["end_to_end"], name),
                per_layer=_for_cell(bench["per_layer"], name),
                bench_dir=bench_dir)


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` of the harness (a solver or a generator)."""
    if not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", name):
        raise ValueError(f"{kind} name {name!r} is no module name")
    return importlib.import_module(f"{__package__}.{kind}.{name}")


def load_metric(name: str, bench_dir: Path = HERE):
    """The reader of metric ``name``: ``metrics/<name>.py``, loaded by path
    (a metric's name may hold dots)."""
    path = bench_dir / "metrics" / f"{name}.py"
    mod_name = f"{__package__}.metrics." + re.sub(r"\W", "_", name)
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no reader for metric {name!r} at {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Run:
    """What a run measured, as the metric readers see it."""

    cell: Cell
    problem: dict
    setup_s: float
    solves: list  # the window's whole solves (the solver's fields + wall_s)
    window_s: float
    window_peak_bytes: int
    trace: "Trace | None"

    @property
    def sweeps(self) -> int:
        return sum(s["sweeps"] for s in self.solves)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _peak(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) \
        if device.type == "cuda" else 0


def _log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def make_problem(cell: Cell, seed: int, device) -> dict:
    """The tensor and the start for ``seed`` on ``device``, handed alike to
    the program and to the reference."""
    gen = load_module("generators", cell.config["generator"])
    indices, values, info = gen.make(cell.config, seed, device)
    lam0, factors0 = gen.draw_start(cell.config["dims"], cell.traffic["rank"],
                                    seed, device)
    return {"dims": [int(d) for d in cell.config["dims"]],
            "indices": indices, "values": values, "lam0": lam0,
            "factors0": factors0, **info}


def execute(cell: Cell, seed: int, seconds: float, trace: bool, device,
            t_start: float) -> dict:
    """Set up, run the window, judge it; returns the result's fields."""
    solver = load_module("solvers", cell.traffic["solver"])
    problem = make_problem(cell, seed, device)
    _log(f"{cell.config['name']}: dims {problem['dims']}, nnz drawn "
         f"{problem['nnz_drawn']}, stored {problem['nnz_stored']}")
    inputs = solver.program_inputs(problem)
    solver.solve(inputs, cell.traffic, device, warmup=True)
    _sync(device)
    setup_peak = _peak(device)
    setup_s = time.perf_counter() - t_start
    gc.collect()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    solves, errors = [], []
    with profiled(trace) as traced:
        t0 = ts = time.perf_counter()
        while ts - t0 < seconds or not solves:  # the window opens with a solve
            try:
                ans = solver.solve(inputs, cell.traffic, device)
                _sync(device)
            except Exception:  # a solve that fails counts, and ends the window
                errors.append(traceback.format_exc())
                break
            now = time.perf_counter()
            ans["wall_s"] = now - ts
            solves.append(ans)
            ts = now
        window_s = time.perf_counter() - t0
    window_peak = _peak(device)
    for e in errors:
        _log(f"solve failed:\n{e}")
    _log(f"window {window_s:.3f} s: {len(solves)} solves, walls "
         + " ".join(f"{s['wall_s']:.3f}" for s in solves) + ", in-solve "
         + " ".join(f"{s.get('program_s', math.nan):.3f}" for s in solves))

    del inputs
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    run = Run(cell=cell, problem=problem, setup_s=setup_s,
              solves=solves, window_s=window_s, window_peak_bytes=window_peak,
              trace=traced[0] if traced else None)

    checks, wrong = judge(cell, solver, problem, solves)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = load_metric(m["name"], cell.bench_dir).read(run)
        if value is None:
            if not trace:
                raise RuntimeError(f"end-to-end metric {m['name']} read "
                                   "nothing")
            continue
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    out = {
        "correct": bool(solves) and not errors and wrong == 0,
        "attempted": len(solves) + len(errors),
        "failed": len(errors) + wrong,
        "metrics": metrics,
        "device": _device(cell, device, max(setup_peak, window_peak), run,
                          trace),
    }
    if run.trace is not None:
        out["breakdown"] = {"device_ops": run.trace.device_ops(),
                            "idle_gaps": run.trace.idle_gaps()}
    out["checks"] = checks
    return out


def judge(cell: Cell, solver, problem: dict, solves: list) -> tuple:
    """Every solve of the window against one run of the plain reference
    (all start from the same tensor and start): ``({number: {value,
    limit}}, solves over a limit)``, each value the largest over the
    solves."""
    t0 = time.perf_counter()
    ref = solver.reference(problem, cell.traffic)
    _log(f"reference {time.perf_counter() - t0:.3f} s")
    worst = {k: 0.0 for k in cell.limits}
    wrong = 0
    for ans in solves:
        nums = solver.compare(ans, ref)
        missing = set(nums) ^ set(cell.limits)
        if missing:
            raise KeyError(f"cell {cell.name}: compared numbers and limits "
                           f"differ in {sorted(missing)}")
        wrong += any(not nums[k] <= cell.limits[k] for k in nums)
        for k, v in nums.items():
            worst[k] = v if math.isnan(v) else max(worst[k], v)
    return {k: {"value": worst[k], "limit": cell.limits[k]}
            for k in cell.limits}, wrong


def _power_limit() -> "str | None":
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def _device(cell: Cell, device, peak: int, run: Run, trace: bool) -> dict:
    on_card = device.type == "cuda"
    d = {"platform": "gpu" if on_card else "cpu",
         "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
         "count": cell.chips, "memory_peak_bytes": peak}
    if trace:
        d["busy_s"] = run.trace.busy_s() if run.trace is not None else 0.0
        d["window_s"] = run.window_s
    if on_card:
        d["power_limit"] = _power_limit()
    return d


def foreign_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FOREIGN)


def main(argv, t_start: float) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        _log(f"cell {cell.name} needs {cell.chips} CUDA device(s); "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
             " available")
        return 2
    result = execute(cell, args.seed, args.seconds, bool(args.trace),
                     torch.device("cuda", 0), t_start)
    found = foreign_modules()
    if found:
        _log(f"JAX or the JAX package was loaded: {', '.join(found)}")
        return 3
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0
