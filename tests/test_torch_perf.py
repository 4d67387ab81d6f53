"""The port's analysis layer against the JAX package's.

Roofline (paper Eqs. 1-8), the policy search (``policy_grid``,
``grid_search``, ``model_top_k``, ``model_ambiguous_prefix``), the
``cuda`` branch of ``heuristic_policy``, pressure-point analysis and the
fenced timing harness.  Where both packages compute the same function,
the same inputs go to both (the conformance fixtures, handed over as
numpy arrays; explicitly built hardware specs) and the results must be
equal, or within ``TOL`` for Φ.  The ``cpu`` and ``tpu`` branches of
``heuristic_policy`` are held array-equal to the reference on the
fixtures' ModeStats by ``tests/test_torch_layout.py``.
"""
import functools
import math

import numpy as np
import pytest
import torch

from repro.core import policy as R_policy
from repro.core.sparse_tensor import sort_mode as r_sort_mode
from repro.perf import ppa as R_ppa
from repro.perf import roofline as R_roof

from repro_torch.core import layout as P_layout
from repro_torch.core import policy as P_policy
from repro_torch.core.convert import ktensor_from_numpy, sparse_tensor_from_numpy
from repro_torch.core.sparse_tensor import sort_mode as p_sort_mode
from repro_torch.kernels._checks import SMEM_LIMIT
from repro_torch.kernels.phi.kernel import smem_bytes
from repro_torch.perf import ppa as P_ppa
from repro_torch.perf import roofline as P_roof
from repro_torch.perf import timing as P_timing

from test_conformance import FIXTURES, TOL, make_fixture

MODES = (0, 1, 2)

# --- roofline ---------------------------------------------------------------


def test_roofline_paper_bounds():
    """The paper's headline bounds from its stated intensities (Sec. 3.2):
    41.5 GFLOP/s on the dual Xeon, 60 GFLOP/s on the K80."""
    cpu, gpu = P_roof.HARDWARE["e5_2690v4_dual"], P_roof.HARDWARE["k80"]
    stated = P_roof.PAPER_STATED_INTENSITY
    np.testing.assert_allclose(P_roof.attainable_gflops(stated["cpu"], cpu),
                               41.472, rtol=1e-3)
    np.testing.assert_allclose(P_roof.attainable_gflops(stated["gpu"], gpu),
                               60.0, rtol=1e-3)
    assert stated == R_roof.PAPER_STATED_INTENSITY


@pytest.mark.parametrize("key", ("e5_2690v4_dual", "k80"))
def test_paper_systems_equal(key):
    p, r = P_roof.HARDWARE[key], R_roof.HARDWARE[key]
    for f in ("name", "peak_flops", "hbm_bw", "link_bw", "vmem_bytes"):
        assert getattr(p, f) == getattr(r, f), f
    assert p.balance == r.balance
    for i in (0.01, 0.125, 0.27, 3.0, 1e4):
        assert P_roof.attainable_gflops(i, p) == R_roof.attainable_gflops(i, r)


def test_h100_spec():
    h = P_roof.HARDWARE["h100_sxm"]
    assert (h.peak_flops, h.hbm_bw, h.vmem_bytes) == (67e12, 3.35e12,
                                                      SMEM_LIMIT)
    assert h.balance == pytest.approx(20.0)
    # paper-literal Φ intensity at rank 16, 4-byte words: 66 / 82 / 4
    i = P_roof.operational_intensity_phi(16, "gpu", word_bytes=4)
    assert i == pytest.approx(66 / 82 / 4)
    assert P_roof.attainable_gflops(i, h) == pytest.approx(3350 * i)
    assert "tpu_v5e" not in P_roof.HARDWARE and "host_cpu" not in P_roof.HARDWARE
    assert P_roof.RooflineTerms(*([0.0] * 7), n_chips=1).peak_flops == 67e12
    assert P_roof.roofline_terms(67e12, 0.0, 0.0, 1).compute_s == 1.0


@pytest.mark.parametrize("field", ("op_overhead_s", "serial_instr_s",
                                   "scatter_elem_s"))
def test_overhead_coefficients_are_refused_not_dropped(field):
    """The reference's overhead slots bind, but the port's autotuner does
    not model them: its host spec's non-zero coefficient raises, 0.0
    builds."""
    value = getattr(R_roof.HARDWARE["host_cpu"], field)
    assert value > 0.0
    with pytest.raises(ValueError, match=field):
        P_roof.HardwareSpec("test", 1e9, 1e9, **{field: value})
    assert getattr(P_roof.HardwareSpec("test", 1e9, 1e9, **{field: 0.0}),
                   field) == 0.0


@pytest.mark.parametrize("word_bytes", (4, 8))
@pytest.mark.parametrize("variant", ("gpu", "cpu"))
@pytest.mark.parametrize("rank", (1, 4, 16, 200, 10_000))
def test_operational_intensity_equal(rank, variant, word_bytes):
    for nnz in (1, 10**6):
        assert P_roof.operational_intensity_phi(
            rank, variant, word_bytes=word_bytes, nnz=nnz) == \
            R_roof.operational_intensity_phi(
                rank, variant, word_bytes=word_bytes, nnz=nnz)


def _spec_pair(**kw):
    return P_roof.HardwareSpec("test", **kw), R_roof.HardwareSpec("test", **kw)


@pytest.mark.parametrize("link_bw", (0.0, 5e10))
@pytest.mark.parametrize("flops,nbytes,coll,chips,model", [
    (1e15, 1e12, 1e5, 256, 8e14),
    (1e12, 1e12, 1e12, 256, 0.0),
    (3e9, 7e10, 0.0, 1, 2e9),
    (0.0, 0.0, 0.0, 4, 0.0),
])
def test_roofline_terms_equal(flops, nbytes, coll, chips, model, link_bw):
    ps, rs = _spec_pair(peak_flops=1e12, hbm_bw=1e11, link_bw=link_bw,
                        vmem_bytes=1 << 20)
    p = P_roof.roofline_terms(flops, nbytes, coll, chips, hw=ps,
                              model_flops=model)
    r = R_roof.roofline_terms(flops, nbytes, coll, chips, hw=rs,
                              model_flops=model)
    for f in ("compute_s", "memory_s", "collective_s", "hlo_flops",
              "hlo_bytes", "collective_bytes", "model_flops", "n_chips",
              "peak_flops", "dominant", "bound_s", "useful_flops_ratio",
              "mfu_bound"):
        assert getattr(p, f) == getattr(r, f), f


def test_detect_hardware_spec(monkeypatch):
    h100 = P_roof.HARDWARE["h100_sxm"]
    monkeypatch.delenv("REPRO_HARDWARE_SPEC", raising=False)
    assert P_roof.detect_hardware_spec("k80") is P_roof.HARDWARE["k80"]
    with pytest.raises(ValueError, match="platform 'cpu'"):
        P_roof.detect_hardware_spec("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P_roof.detect_hardware_spec()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for name, want in (("NVIDIA H100 80GB HBM3", h100),
                       ("NVIDIA H100 PCIe", None), ("Tesla K80", None),
                       ("NVIDIA A100-SXM4-80GB", None)):
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda *a, n=name: n)
        for platform in (None, "cuda", "gpu"):
            if want is None:
                with pytest.raises(ValueError, match=name):
                    P_roof.detect_hardware_spec(platform)
            else:
                assert P_roof.detect_hardware_spec(platform) is want
    # the environment wins over the argument and the card
    monkeypatch.setenv("REPRO_HARDWARE_SPEC", "e5_2690v4_dual")
    assert P_roof.detect_hardware_spec("k80") is \
        P_roof.HARDWARE["e5_2690v4_dual"]


# --- policy search -------------------------------------------------------------

GRIDS = [
    dict(),
    dict(strategies=("segment", "cuda")),
    dict(strategies=("scatter", "segment", "cuda"), block_nnz=(64, 2048),
         block_rows=(8,)),
    dict(strategies=("cuda",), block_nnz=(), block_rows=(64,)),
]


@pytest.mark.parametrize("kw", GRIDS)
def test_policy_grid_labels_equal(kw):
    ref_kw = dict(kw)
    if "strategies" in kw:
        ref_kw["strategies"] = tuple("pallas" if s == "cuda" else s
                                     for s in kw["strategies"])
    port = [p.label() for p in P_policy.policy_grid(**kw)]
    ref = [p.label().replace("pallas:", "cuda:")
           for p in R_policy.policy_grid(**ref_kw)]
    assert port == ref


def _outcomes(ranked):
    return [(p.label(), s, e) for p, s, e in ranked]


def test_grid_search_records_failures_and_sorts():
    """The same time function through both packages: the failures carry
    their reason, results are (policy, seconds, error) fastest-first."""
    times = {"segment": 0.5, "scatter": 0.1}

    def time_fn(p):
        if p.strategy not in times:
            raise ValueError(f"bad block shape {p.block_nnz}")
        return times[p.strategy]

    strategies = ("segment", "scatter", "blocked")
    port = P_policy.grid_search(time_fn, P_policy.policy_grid(
        strategies, block_nnz=(64, 128), block_rows=(8,)))
    ref = R_policy.grid_search(time_fn, R_policy.policy_grid(
        strategies, block_nnz=(64, 128), block_rows=(8,)))
    assert _outcomes(port) == _outcomes(ref)
    assert all(isinstance(r, tuple) and len(r) == 3 for r in port)
    assert [s for _, s, _ in port] == sorted(s for _, s, _ in port)
    assert [p.strategy for p, _, _ in port[:2]] == ["scatter", "segment"]
    assert port[2][1] == float("inf")
    assert "ValueError" in port[2][2] and "bad block shape" in port[2][2]


def test_grid_search_retries_device_memory_errors():
    calls = {"n": 0}

    def flaky(p):
        calls["n"] += 1
        if calls["n"] == 1:
            raise torch.cuda.OutOfMemoryError("out of memory")
        return 0.5

    (pol, secs, err), = P_policy.grid_search(flaky, [P_policy.PhiPolicy()],
                                             retries=1, backoff=0.0)
    assert calls["n"] == 2 and secs == 0.5 and err is None


@pytest.mark.parametrize("exc,retried,tag", [
    (ValueError("block_rows too large"), False, False),
    (NotImplementedError("later slice"), False, False),
    (torch.cuda.OutOfMemoryError("persistent"), True, True),
])
def test_grid_search_retry_classes(exc, retried, tag):
    calls = {"n": 0}

    def bad(p):
        calls["n"] += 1
        raise exc

    (pol, secs, err), = P_policy.grid_search(bad, [P_policy.PhiPolicy()],
                                             retries=3, backoff=0.0)
    assert calls["n"] == (4 if retried else 1)
    assert secs == float("inf") and err.endswith("(retryable)") == tag
    assert P_policy.probe_error_is_retryable(exc) == retried


def test_grid_search_propagates_unexpected_errors():
    """A failed launch (a RuntimeError that is not an out-of-memory error)
    is a fault, not a pruned point."""
    with pytest.raises(RuntimeError, match="cudaError"):
        P_policy.grid_search(
            lambda p: (_ for _ in ()).throw(
                RuntimeError("phi_blocked: CUDA launch failed with cudaError 9")),
            [P_policy.PhiPolicy()])


def _scored_pair(entries):
    """The same (strategy, bn, br, score) list as both packages' policies."""
    mk = lambda mod: [(mod.PhiPolicy(strategy=s, block_nnz=bn, block_rows=br),
                       score) for s, bn, br, score in entries]
    return mk(P_policy), mk(R_policy)


SCORED = [
    [("blocked", 64, 16, 1.0), ("blocked", 128, 16, 1.1),
     ("blocked", 256, 16, 1.2), ("segment", 256, 256, 5.0),
     ("scatter", 256, 256, 6.0)],
    [("segment", 256, 256, float("inf")), ("scatter", 256, 256, 2.0),
     ("blocked", 256, 256, float("nan")), ("blocked", 64, 64, 1.0)],
    [("cuda", 64, 8, 3.0), ("cuda", 128, 8, 3.0), ("segment", 256, 256, 2.9),
     ("cuda", 512, 64, 3.05), ("scatter", 256, 256, 9.0)],
    [],
]


def _labels(pairs):
    return [(p.label(), s) for p, s in pairs]


@pytest.mark.parametrize("per_family", (True, False))
@pytest.mark.parametrize("k", (0, 1, 3, 10))
@pytest.mark.parametrize("case", range(len(SCORED)))
def test_model_top_k_equal(case, k, per_family):
    port, ref = _scored_pair(SCORED[case])
    assert _labels(P_policy.model_top_k(port, k=k, per_family=per_family)) \
        == _labels(R_policy.model_top_k(ref, k=k, per_family=per_family))


@pytest.mark.parametrize("bound_factor,cap", [(1.5, 3), (1.2, 3), (0.5, 3),
                                              (10.0, 2), (1.05, 5)])
@pytest.mark.parametrize("case", range(len(SCORED)))
def test_model_ambiguous_prefix_equal(case, bound_factor, cap):
    port, ref = _scored_pair(SCORED[case])
    port = P_policy.model_top_k(port, k=5)
    ref = R_policy.model_top_k(ref, k=5)
    assert _labels(P_policy.model_ambiguous_prefix(port, bound_factor, cap)) \
        == _labels(R_policy.model_ambiguous_prefix(ref, bound_factor, cap))


@functools.lru_cache(maxsize=None)
def _port_fixture(kind):
    t, kt = make_fixture(kind)
    pt = sparse_tensor_from_numpy(t.shape, np.asarray(t.indices),
                                  np.asarray(t.values), device="cpu")
    pkt = ktensor_from_numpy(np.asarray(kt.lam),
                             [np.asarray(f) for f in kt.factors], device="cpu")
    return t, kt, pt, pkt


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", FIXTURES)
def test_heuristic_cuda_branch_fits_shared_memory(kind, mode):
    _, _, pt, _ = _port_fixture(kind)
    mv = p_sort_mode(pt, mode)
    width = int(np.prod([s for m, s in enumerate(pt.shape) if m != mode]))
    for rw in (None, width):
        stats = P_layout.mode_run_stats(mv.rows.numpy(), mv.n_rows, rw)
        tpu = P_policy.heuristic_policy(mv.nnz, mv.n_rows, 16,
                                        platform="tpu", stats=stats)
        for rank in (4, 16, 200, 1024):
            p = P_policy.heuristic_policy(mv.nnz, mv.n_rows, rank,
                                          platform="cuda", stats=stats)
            if tpu.strategy == "dense":  # the same near-dense cut
                assert p == tpu
                continue
            assert p.strategy == "cuda"
            assert smem_bytes(p.block_nnz, p.block_rows, rank) <= \
                SMEM_LIMIT // 4
            assert 64 <= p.block_nnz <= 2048 and 8 <= p.block_rows <= 1024
            assert p.block_nnz & (p.block_nnz - 1) == 0
            assert p.block_rows & (p.block_rows - 1) == 0


@pytest.mark.parametrize("nnz,n_rows", [
    (3_309_490, 24), (3_309_490, 183), (3_309_490, 1717),
    (76_879_419, 28_818), (100, 5000), (0, 10),
])
def test_heuristic_cuda_branch_sizes(nnz, n_rows):
    """block_nnz covers ~4 average rows, capped so that 4 waves of 8 blocks
    fill the 132 SMs; at rank 1024 the row window shrinks to fit."""
    p = P_policy.heuristic_policy(nnz, n_rows, 16, platform="cuda")
    d = max(1.0, nnz / max(1, n_rows))
    want = min(4 * d, nnz / (4 * 132 * 8))
    assert p.block_nnz == int(2 ** np.clip(np.floor(np.log2(max(want, 1.0))),
                                           6, 11))
    wide = P_policy.heuristic_policy(nnz, n_rows, 1024, platform="cuda")
    assert smem_bytes(wide.block_nnz, wide.block_rows, 1024) <= \
        SMEM_LIMIT // 4


# --- pressure-point analysis ------------------------------------------------


@pytest.mark.parametrize("strategy", ("scatter", "segment", "blocked"))
@pytest.mark.parametrize("perturb", P_ppa.PERTURBATIONS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", FIXTURES)
def test_perturbed_phi_matches_reference(kind, mode, perturb, strategy):
    """Each perturbation's Φ (the ``both`` case inlined in both packages)
    equals the reference's at TOL."""
    t, kt, pt, pkt = _port_fixture(kind)
    rmv = r_sort_mode(t, mode)
    want = R_ppa._phi_fn(rmv, kt.factors, kt.factors[mode] * kt.lam[None, :],
                         strategy, perturb)()
    pmv = p_sort_mode(pt, mode)
    got = P_ppa._phi_fn(pmv, pkt.factors, pkt.factors[mode] * pkt.lam[None, :],
                        strategy, perturb, torch.device("cpu"))()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("strategy", ("scatter", "segment", "blocked"))
def test_run_ppa_on_the_cpu(strategy):
    _, _, pt, pkt = _port_fixture("hub")
    res = P_ppa.run_ppa(pt, pkt, mode=0, strategy=strategy, iters=2,
                        device="cpu")
    assert (res.strategy, res.mode) == (strategy, 0)
    assert set(res.seconds) == {str(p) for p in P_ppa.PERTURBATIONS}
    assert all(v > 0 for v in res.seconds.values())
    assert all(math.isfinite(v) and v > 0 for v in res.speedup.values())
    assert res.speedup["None"] == 1.0


def test_run_ppa_without_baseline_and_on_the_kernel():
    _, _, pt, pkt = _port_fixture("uniform")
    res = P_ppa.run_ppa(pt, pkt, mode=1, perturbations=("perfect_reuse",),
                        iters=1, device="cpu")
    assert set(res.seconds) == {"perfect_reuse"}
    assert math.isfinite(res.speedup["perfect_reuse"])
    with pytest.raises(ValueError, match="perturb is not supported"):
        P_ppa.run_ppa(pt, pkt, strategy="cuda", perturbations=("both",),
                      iters=1, device="cpu")


def test_run_ppa_defaults_to_the_card(monkeypatch):
    _, _, pt, pkt = _port_fixture("uniform")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P_ppa.run_ppa(pt, pkt)


# --- timing --------------------------------------------------------------------


def test_bench_seconds_is_the_median(monkeypatch):
    clock = iter([0.0, 1.0, 1.0, 4.0, 4.0, 6.0])  # calls of 1, 3 and 2 s
    monkeypatch.setattr(P_timing.time, "perf_counter", lambda: next(clock))
    calls = []
    secs = P_timing.bench_seconds(lambda x: calls.append(x), 7, warmup=2,
                                  iters=3)
    assert secs == 2.0 and calls == [7] * 5


def test_bench_burst_seconds_divides_by_burst(monkeypatch):
    monkeypatch.setattr(P_timing, "bench_seconds",
                        lambda fn, *a, **kw: (kw.pop("warmup"), kw.pop("iters"),
                                              fn(*a, **kw))[2])
    assert P_timing.bench_burst_seconds(lambda burst: 8.0 * burst, burst=4) \
        == 8.0
    assert P_timing.bench_burst_seconds(lambda: 8.0, burst=4,
                                        pass_burst=False) == 2.0
    with pytest.raises(ValueError, match="burst must be >= 1"):
        P_timing.bench_burst_seconds(lambda burst: 1.0, burst=0)


def test_fence_synchronizes_only_cuda_outputs(monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda d=None: synced.append(d))
    _, _, _, pkt = _port_fixture("hub")
    P_timing._block_until_ready({"a": (torch.ones(2), [torch.zeros(1)]),
                                 "b": None, "kt": pkt})
    assert synced == []
    found = set()
    P_timing._cuda_devices([pkt, {"x": (torch.ones(1),)}], found)
    assert found == set()


def test_bandwidth_gbs():
    assert P_timing.bandwidth_gbs(3.35e9, 1e-3) == pytest.approx(3350.0)
    assert P_timing.bandwidth_gbs(1.0, 0.0) == 0.0
