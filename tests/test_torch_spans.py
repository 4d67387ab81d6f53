"""The host spans inside the port's CP-APR solve (``repro_torch.spans``).

A tiny ``cuda`` solve (the kernels' plain versions on the CPU) runs under
``torch.profiler`` on a 3-mode and a 4-mode tensor: every span name is
recorded, no span lies inside another, the host-sync span counts one per
inner iteration, one guard flag per mode and one log-likelihood per
sweep, and the fitted model is bitwise the one of an unprofiled solve.
"""
from types import SimpleNamespace

import pytest
import torch

from repro_torch.core.cpapr import CPAPRConfig, cpapr_mu
from repro_torch.core.policy import PhiPolicy
from repro_torch.core.sparse_tensor import random_poisson_tensor
from repro_torch.perf.trace import span_kernels_us
from repro_torch.spans import PREP_SORT, SPANS, SWEEP_STEP, SWEEP_SYNC, span

SHAPES = {"3mode": ((12, 10, 9), 300), "4mode": ((8, 7, 6, 5), 300)}
RANK = 3


@pytest.fixture(params=sorted(SHAPES))
def problem(request):
    shape, nnz = SHAPES[request.param]
    t, _ = random_poisson_tensor(7, shape, nnz, rank=RANK, device="cpu")
    return t


def solve(t):
    cfg = CPAPRConfig(rank=RANK, max_outer=3, max_inner=4, strategy="cuda",
                      policy=PhiPolicy(block_nnz=32, block_rows=4))
    return cpapr_mu(t, RANK, seed=1, config=cfg, device="cpu")


def profiled_solve(t):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        res = solve(t)
    events = [(e.name(), e.start_ns(), e.end_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name() in SPANS]
    return res, events


def test_span_is_the_shared_null_context_without_a_profiler(problem):
    assert not torch._C._autograd._profiler_enabled()
    assert all(span(name) is span(SPANS[0]) for name in SPANS)
    with span(SPANS[0]) as got:
        assert got is None


def test_profiled_solve_records_every_span(problem):
    _, events = profiled_solve(problem)
    assert {name for name, _, _ in events} == set(SPANS)


def test_spans_are_flat(problem):
    _, events = profiled_solve(problem)
    events.sort(key=lambda e: e[1])
    for (name0, s0, e0), (name1, s1, e1) in zip(events, events[1:]):
        assert s0 <= e0 <= s1 <= e1, (name0, name1)


def test_host_syncs_count_inner_iterations_guards_and_logliks(problem):
    res, events = profiled_solve(problem)
    syncs = sum(name == SWEEP_SYNC for name, _, _ in events)
    n_modes = len(problem.shape)
    assert syncs == sum(res.inner_iters) + res.n_outer * (n_modes + 1)


def test_profiler_leaves_the_model_bitwise(problem):
    plain = solve(problem)
    traced, _ = profiled_solve(problem)
    assert torch.equal(plain.ktensor.lam, traced.ktensor.lam)
    for a, b in zip(plain.ktensor.factors, traced.ktensor.factors):
        assert torch.equal(a, b)
    assert plain.inner_iters == traced.inner_iters


def _event(name, kernels=(), children=()):
    return SimpleNamespace(
        name=name, cpu_children=list(children),
        kernels=[SimpleNamespace(name=k, duration=us) for k, us in kernels])


def test_span_kernels_sum_the_kernels_launched_under_each_span():
    """``perf.trace.span_kernels_us`` walks the profiler's event tree: each
    kernel counts under the span whose operators launched it."""
    mm = _event("aten::mm", [("gemm", 2.0)],
                [_event("cudaLaunchKernel", [("gemm", 1.5)])])
    events = [
        _event(SWEEP_STEP, [("phi", 3.0)], [mm, _event("aten::add")]),
        _event(SWEEP_STEP, [("phi", 4.0)]),
        _event(PREP_SORT, children=[_event("aten::sort", [("radix", 0.5)])]),
        mm, _event("aten::item", [("memcpy", 9.0)]),
    ]
    assert span_kernels_us(events) == {
        SWEEP_STEP: {"phi": 7.0, "gemm": 3.5}, PREP_SORT: {"radix": 0.5}}
