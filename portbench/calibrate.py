"""Readings behind a cell's limits: the program's and the control's.

    python3 portbench/calibrate.py --workload <cell> --seeds 1 2 3 \
        [--control-seeds 1 2 3] [--out file]

For each seed, at the cell's own size and in one process: the tensor and
start as a run draws them, one solve of the program through the timed
path's own call (after one warm-up solve in the process), the plain
reference, and, for the control seeds, the control (the reference in the
nearest precision below float32 with TF32 off: TF32), each judged by the
comparison a run makes.  A cell's limit lies between the largest reading
of the program's sound solves (the benchmark's own runs print theirs
too) and the smallest reading of the control.  The benchmark's runs
never run this.  Needs a CUDA device.
"""
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:] = [str(ROOT / "src"), str(ROOT)] + [
    p for p in sys.path if Path(p or ".").resolve() != ROOT / "portbench"]

import torch  # noqa: E402

from portbench.harness import load_cell, load_module, make_problem  # noqa: E402


def readings(cell, seed: int, device, control: bool, warm: bool) -> dict:
    """The program's (and the control's) compared numbers for ``seed``."""
    solver = load_module("solvers", cell.traffic["solver"])
    problem = make_problem(cell, seed, device)
    inputs = solver.program_inputs(problem)
    if not warm:
        solver.solve(inputs, cell.traffic, device, warmup=True)
    ans = solver.solve(inputs, cell.traffic, device)
    del inputs
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = solver.reference(problem, cell.traffic)
    out = {"seed": seed, "nnz_stored": problem["nnz_stored"],
           "reference_s": time.perf_counter() - t0,
           "program": solver.compare(ans, ref)}
    if control:
        t0 = time.perf_counter()
        ctl = solver.reference(problem, cell.traffic, control=True)
        out["control_s"] = time.perf_counter() - t0
        out["control"] = solver.compare(ctl, ref)
    return out


def main(argv) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="portbench/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    rows = []
    ctl = set(args.seeds if args.control_seeds is None else args.control_seeds)
    for i, seed in enumerate(args.seeds):
        rows.append(readings(cell, seed, torch.device("cuda", 0),
                             seed in ctl, warm=i > 0))
        print(json.dumps(rows[-1]), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
