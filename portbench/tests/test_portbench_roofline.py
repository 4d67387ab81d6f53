"""``phi_roofline``'s count of bytes and operations, and the readers of the
traced metrics on a trace made up here."""
import pytest
from conftest import shrunk

from portbench import harness, roofline
from portbench.tracing import Trace


def test_phi_bytes_count_the_algorithm_not_pi():
    # nnz (4 B value + 4 B per index) + every factor + the written result
    assert roofline.phi_bytes([2, 3, 4], 10, 2, 1) == \
        10 * (4 + 3 * 4) + (2 + 3 + 4) * 2 * 4 + 3 * 2 * 4
    assert roofline.phi_flops(10, 2) == 10 * (4 * 2 + 2)


def test_phi_least_time_is_the_larger_bound():
    dims, nnz, r = [12092, 9184, 28818], 76_878_432, 16
    b = roofline.phi_bytes(dims, nnz, r, 0)
    assert b == nnz * 16 + sum(dims) * r * 4 + dims[0] * r * 4
    t = roofline.phi_least_seconds(dims, nnz, r, 0)
    assert t == pytest.approx(b / 3.35e12)  # bound by bytes, ~0.368 ms
    assert t > roofline.phi_flops(nnz, r) / 67e12
    assert 0.36e-3 < t < 0.38e-3
    # bound by operations: many nonzeros, a rank far above 60
    assert roofline.phi_least_seconds([1, 1], 10**6, 1000, 0) == \
        pytest.approx(roofline.phi_flops(10**6, 1000) / 67e12)


PHI = "void repro_torch::blocked::phi_accum_kernel<true, float, 4, 1, 4>(int)"
EPI = "void repro_torch::mu_epilogue_kernel<float>(float const*)"
GATHER = "void at::native::vectorized_gather_kernel<16, long>(char*)"
INDEX = "void at::native::index_elementwise_kernel<128, 4>(int)"
OTHER = "void at::native::vectorized_elementwise_kernel<4, FillFunctor>()"
MEMCPY = "Memcpy DtoH (Device -> Pageable)"


def _run(trace, solves, dims=(4, 5, 6), nnz=100, rank=16):
    cell = shrunk("uber.cpapr", 8)
    import torch
    problem = {"dims": list(dims), "nnz_stored": nnz,
               "lam0": torch.ones(rank)}
    return harness.Run(cell=cell, problem=problem, setup_s=1.5,
                       solves=solves, window_s=10.0, window_peak_bytes=2**31,
                       trace=trace)


def _read(name, run):
    return harness.load_metric(name).read(run)


def test_trace_readers():
    ms = 1_000_000  # ns
    trace = Trace(device=[(PHI, 0, 4 * ms), (EPI, 4 * ms, 5 * ms),
                          (GATHER, 6 * ms, 8 * ms), (INDEX, 7 * ms, 9 * ms),
                          (OTHER, 20 * ms, 21 * ms), (MEMCPY, 30 * ms, 40 * ms)],
                  host=[("aten::item", 9 * ms, 15 * ms)])
    solves = [{"sweeps": 2, "inner_iters": 6, "wall_s": 4.0,
               "program_s": 3.0},
              {"sweeps": 3, "inner_iters": 9, "wall_s": 5.0,
               "program_s": 4.5}]
    run = _run(trace, solves)
    assert _read("phi_kernel_ms", run) == pytest.approx(5.0 / 5)
    assert _read("gather_ms", run) == pytest.approx(4.0 / 5)  # no Memcpy
    assert _read("inner_iters", run) == pytest.approx(15 / 5)
    assert _read("prep_s", run) == pytest.approx((1.0 + 0.5) / 2)
    assert _read("sweep_s", run) == pytest.approx(10.0 / 5)
    assert _read("setup_s", run) == 1.5
    assert _read("peak_gib", run) == 2.0
    # busy: [0, 5] + [6, 9] + [20, 21] + [30, 40] ms of the 10 s window
    assert _read("idle_share", run) == pytest.approx(100 * (1 - 0.019 / 10))
    evals = 15 + 3 * 5  # inner iterations + one scooch per mode update
    least = min(roofline.phi_least_seconds([4, 5, 6], 100, 16, n)
                for n in range(3))
    assert _read("phi_roofline", run) == pytest.approx(
        100 * evals * least / 5e-3)
    assert trace.idle_gaps() == [["python", pytest.approx(0.015)],
                                 ["aten::item", pytest.approx(0.006)]]
    assert trace.device_ops(2) == [[MEMCPY, pytest.approx(0.01)],
                                   [PHI, pytest.approx(0.004)]]


def test_readers_find_nothing_without_a_trace():
    run = _run(None, [{"sweeps": 2, "inner_iters": 6, "wall_s": 1.0,
                       "program_s": 0.5}])
    for name in ("phi_kernel_ms", "gather_ms", "phi_roofline", "idle_share"):
        assert _read(name, run) is None
    empty = _run(Trace(device=[], host=[]), run.solves)
    for name in ("phi_kernel_ms", "gather_ms", "phi_roofline", "idle_share"):
        assert _read(name, empty) is None
