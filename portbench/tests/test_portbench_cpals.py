"""The ``uber.cpals`` cell: its run through the harness on a cut of it, the
work counts of ``mttkrp_roofline``, its five per-layer readers on a trace
made up here and with nothing to read, and, on the card, the program
within every limit and the control outside one at the cell's own size.

The cut divides each dim by 8 and the nonzeros by 64 and fits at rank 4
(its hour mode keeps 3 rows: at rank 16 that mode's normal equations
would be singular but for the ridge).  Its solves run the program's plain
CPU versions, held only to the cell's limits, which were set on the card
(``calibrate.py``; PERF.md).
"""
import pytest
import torch
from conftest import shrunk

from portbench import harness, roofline_mttkrp
from portbench.solvers import cp_als as solver
from portbench.tracing import Trace

CPU = torch.device("cpu")
READERS = ("mttkrp_kernel_ms", "mttkrp_roofline", "als_prep_s",
           "als_idle_ms", "als_host_syncs")
MS = 1_000_000  # ns
B3 = ("void repro_torch::blocked::phi_accum_kernel<false, float, 4, 1, 4>"
      "(int)")
B1 = "void repro_torch::blocked::phi_accum_kernel<true, float, 4, 1, 4>(int)"


def test_cell_runs_correct_through_the_harness():
    cell = shrunk("uber.cpals", 8, rank=4, n_iters=5)
    out = harness.execute(cell, 2**31 + 5, 0.0, False, CPU, 0.0)
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] == 1 and out["failed"] == 0
    assert set(out["checks"]) == {"lam_rel", "factor_rel", "model_rel"}
    assert set(out["metrics"]) == {"sweep_s", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == set(READERS)


def test_traced_cell_on_the_cpu_reads_no_per_layer_metric():
    """Traced on the CPU the window holds the spans but no device interval:
    every reader finds nothing, and the line leaves them out."""
    cell = shrunk("uber.cpals", 8, rank=4, n_iters=2)
    out = harness.execute(cell, 2**31 + 5, 0.0, True, CPU, 0.0)
    assert out["correct"] is True, out["checks"]
    assert out["metrics"] == {}


def test_mttkrp_counts():
    # nnz (4 B value + 4 B per index) + the other factors + the result
    assert roofline_mttkrp.mttkrp_bytes([2, 3, 4], 10, 2, 1) == \
        10 * (4 + 3 * 4) + (2 + 4) * 2 * 4 + 3 * 2 * 4
    assert roofline_mttkrp.mttkrp_flops(10, 2, 3) == 10 * 2 * 4
    dims, nnz, r = [183, 24, 1140, 1717], 3_309_490, 16
    t = roofline_mttkrp.mttkrp_least_seconds(dims, nnz, r, 1)
    assert t == pytest.approx(
        (nnz * 20 + sum(dims) * r * 4) / 3.35e12)  # bound by bytes, ~20 us
    assert t > roofline_mttkrp.mttkrp_flops(nnz, r, 4) / 67e12
    assert roofline_mttkrp.mttkrp_least_seconds([1, 1], 10**6, 1000, 0) == \
        pytest.approx(roofline_mttkrp.mttkrp_flops(10**6, 1000, 2) / 67e12)


# device busy 0-1, 3-4 and 10-11 ms: idle gaps 1-3 and 4-10 ms
DEVICE = [(B3, 0, 1 * MS), (B1, 3 * MS, 4 * MS), (B3, 10 * MS, 11 * MS)]
HOST = [
    ("cpals.prep.validate", 1 * MS, 2 * MS),  # 1 ms of gap 1
    ("cpals.prep.layout", 2 * MS, 3 * MS),  # 1 ms of gap 1
    ("cpals.iter.inputs", 4 * MS, 6 * MS),  # 2 ms of gap 2
    ("cpals.iter.sync", 6 * MS, 7 * MS),  # 1 ms of gap 2
    ("cpapr.sweep.sync", 7 * MS, 8 * MS),  # not CP-ALS's
    ("cpals.iter.fit", 8 * MS, 9 * MS),  # 1 ms of gap 2
    ("cpals.iter.sync", 10 * MS, 10 * MS + MS // 2),  # device busy
]
SOLVES = [{"sweeps": 2}, {"sweeps": 3}]
DIMS, NNZ, RANK = [4, 5, 6], 100, 16
KNOWN = {
    "mttkrp_kernel_ms": 2.0 / 5,
    "mttkrp_roofline": 100 * 5 * sum(
        roofline_mttkrp.mttkrp_least_seconds(DIMS, NNZ, RANK, n)
        for n in range(3)) / 2e-3,
    "als_prep_s": 2e-3 / 2,
    "als_idle_ms": (2.0 + 1.0 + 1.0) / 5,
    "als_host_syncs": 2 / 5,
}


def _run(trace):
    problem = {"dims": DIMS, "nnz_stored": NNZ, "lam0": torch.ones(RANK)}
    return harness.Run(cell=None, problem=problem, setup_s=0.0,
                       solves=SOLVES, window_s=0.012, window_peak_bytes=0,
                       trace=trace)


def _read(name, run):
    return harness.load_metric(name).read(run)


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_the_known_value(name):
    got = _read(name, _run(Trace(device=DEVICE, host=HOST)))
    assert got == pytest.approx(KNOWN[name], rel=1e-12)


@pytest.mark.parametrize("name", READERS)
def test_reader_without_a_device_trace_reads_nothing(name):
    assert _read(name, _run(None)) is None
    assert _read(name, _run(Trace(device=[], host=HOST))) is None


@pytest.mark.parametrize("name", ["als_prep_s", "als_idle_ms",
                                  "als_host_syncs"])
def test_span_reader_of_a_program_without_spans_reads_nothing(name):
    """The parent of the spans: a device trace, no ``cpals.*`` span."""
    host = [("aten::mm", 1 * MS, 2 * MS), ("cpapr.sweep.sync", 4 * MS, 9 * MS)]
    assert _read(name, _run(Trace(device=DEVICE, host=host))) is None


@pytest.mark.cuda
def test_program_passes_and_control_fails_at_the_cell_size(card):
    """On the card, at the cell's own size: the program's solve within
    every limit, the control outside one (three seeds)."""
    c = harness.load_cell("uber.cpals")
    for seed in (2**31 + 11, 2**31 + 12, 2**31 + 13):
        problem = harness.make_problem(c, seed, card)
        inputs = solver.program_inputs(problem)
        ans = solver.solve(inputs, c.traffic, card)
        del inputs
        ref = solver.reference(problem, c.traffic)
        prog = solver.compare(ans, ref)
        ctl = solver.compare(solver.reference(problem, c.traffic,
                                              control=True), ref)
        assert all(prog[k] <= c.limits[k] for k in c.limits), (seed, prog)
        assert any(ctl[k] > c.limits[k] for k in c.limits), (seed, ctl)
