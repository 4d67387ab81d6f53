"""The readers of the program's spans: ``validate_s``, ``sort_s``,
``layout_s``, ``host_syncs`` and ``sweep_idle_ms``, on hand-built traces
with known spans and idle gaps, and on a traced solve of the program."""
import pytest
import torch

from portbench import harness
from portbench.tracing import Trace, profiled

MS = 1_000_000  # ns

# device busy 0-1, 3-4 and 10-11 ms: idle gaps 1-3 and 4-10 ms
DEVICE = [("k", 0, 1 * MS), ("k", 3 * MS, 4 * MS), ("k", 10 * MS, 11 * MS)]
HOST = [
    ("cpapr.prep.validate", 1 * MS, 2 * MS + MS // 2),  # 1.5 ms of gap 1
    ("cpapr.prep.sort", 2 * MS + MS // 2, 3 * MS),  # 0.5 ms of gap 1
    ("cpapr.prep.layout", 4 * MS, 7 * MS),  # 3 ms of gap 2
    ("cpapr.sweep.step", 7 * MS, 8 * MS),  # 1 ms of gap 2
    ("cpapr.sweep.sync", 8 * MS, 9 * MS + MS // 2),  # 1.5 ms of gap 2
    ("aten::mm", 9 * MS + MS // 2, 10 * MS),  # 0.5 ms of gap 2
    ("cpapr.sweep.sync", 10 * MS, 10 * MS + MS // 2),  # device busy
    ("cpapr.prep.layout", 11 * MS, 12 * MS),  # after the last interval
]
SOLVES = [{"sweeps": 2}, {"sweeps": 3}]
KNOWN = {
    "validate_s": 1.5e-3 / 2,
    "sort_s": 0.5e-3 / 2,
    "layout_s": (3e-3 + 1e-3) / 2,
    "host_syncs": 2 / 5,
    "sweep_idle_ms": (1.0 + 1.5) / 5,
}


def _run(trace, solves=SOLVES):
    return harness.Run(cell=None, problem={}, setup_s=0.0, solves=solves,
                       window_s=0.012, window_peak_bytes=0, trace=trace)


def _read(name, run):
    return harness.load_metric(name).read(run)


@pytest.mark.parametrize("name", sorted(KNOWN))
def test_reader_reads_the_known_value(name):
    got = _read(name, _run(Trace(device=DEVICE, host=HOST)))
    assert got == pytest.approx(KNOWN[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(KNOWN))
def test_reader_without_a_trace_reads_nothing(name):
    assert _read(name, _run(None)) is None


@pytest.mark.parametrize("name", sorted(KNOWN))
def test_reader_of_a_program_without_spans_reads_nothing(name):
    host = [("aten::mm", 1 * MS, 2 * MS), ("cudaLaunchKernel", 4 * MS, 9 * MS)]
    assert _read(name, _run(Trace(device=DEVICE, host=host))) is None


@pytest.mark.parametrize("name", ["validate_s", "sort_s", "layout_s",
                                  "host_syncs"])
def test_reader_without_device_intervals_reads_nothing(name):
    """A window traced on the CPU holds the spans but nothing of a card."""
    assert _read(name, _run(Trace(device=[], host=HOST))) is None


def test_program_spans_reach_the_readers():
    """A tiny solve of the program, traced as the harness traces a window:
    its spans are outermost host events, so the readers find them (given a
    device interval on each side of the solve, which the CPU lacks)."""
    from conftest import shrunk

    cell = shrunk("uber.cpapr", 16, max_outer=2, max_inner=3)
    solver = harness.load_module("solvers", cell.traffic["solver"])
    problem = harness.make_problem(cell, 2**31 + 7, torch.device("cpu"))
    inputs = solver.program_inputs(problem)
    with profiled(True) as traced:
        ans = solver.solve(inputs, cell.traffic, torch.device("cpu"))
    host = traced[0].host
    t0, t1 = host[0][1], max(e for _, _, e in host)
    trace = Trace(device=[("k", t0 - 2, t0 - 1), ("k", t1 + 1, t1 + 2)],
                  host=host)
    run = _run(trace, [ans])
    n_modes = len(problem["dims"])
    assert _read("host_syncs", run) == \
        (ans["inner_iters"] + ans["sweeps"] * (n_modes + 1)) / ans["sweeps"]
    prep = [_read(n, run) for n in ("validate_s", "sort_s", "layout_s")]
    assert all(p is not None and p > 0 for p in prep)
    assert _read("sweep_idle_ms", run) > 0
    assert sum(prep) < (t1 - t0) * 1e-9
