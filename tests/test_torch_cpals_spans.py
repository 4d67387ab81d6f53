"""The host spans inside the port's CP-ALS solve (``repro_torch.spans``'s
``ALS_SPANS``).

A tiny ``cuda`` solve (the MTTKRP kernel's plain version on the CPU) runs
under ``torch.profiler`` on a 3-mode and a 4-mode tensor: exactly the
CP-ALS span names are recorded, none lies inside another, the
preparation's spans occur once a solve, the Khatri-Rao inputs, MTTKRP and
Gram product once per mode update and the fit once per iteration, the
host-sync span counts one per ridge solve and one per fit, and the fitted
model is bitwise the one of an unprofiled solve.  A CP-APR solve records
none of these names, and a CP-ALS solve none of CP-APR's.
"""
import pytest
import torch

from repro_torch.core.cpals import cp_als
from repro_torch.core.cpapr import CPAPRConfig, cpapr_mu
from repro_torch.core.policy import PhiPolicy
from repro_torch.core.sparse_tensor import random_poisson_tensor
from repro_torch.spans import (
    ALS_ITER_FIT,
    ALS_ITER_INPUTS,
    ALS_ITER_MTTKRP,
    ALS_ITER_SOLVE,
    ALS_ITER_SYNC,
    ALS_PREP_LAYOUT,
    ALS_PREP_SORT,
    ALS_PREP_VALIDATE,
    ALS_SPANS,
    SPANS,
)

SHAPES = {"3mode": ((12, 10, 9), 300), "4mode": ((8, 7, 6, 5), 300)}
RANK, ITERS = 3, 3


@pytest.fixture(params=sorted(SHAPES))
def problem(request):
    shape, nnz = SHAPES[request.param]
    t, _ = random_poisson_tensor(7, shape, nnz, rank=RANK, device="cpu")
    return t


def solve(t, strategy="cuda"):
    return cp_als(t, RANK, n_iters=ITERS, seed=1, strategy=strategy,
                  policy=PhiPolicy(block_nnz=32, block_rows=4)
                  if strategy == "cuda" else None, device="cpu")


def events_of(run):
    """``(result, [(name, start, end)])`` of ``run()`` under the profiler,
    the events those of either solve's spans."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        res = run()
    names = set(SPANS) | set(ALS_SPANS)
    return res, [(e.name(), e.start_ns(), e.end_ns())
                 for e in prof.profiler.kineto_results.events()
                 if e.name() in names]


def test_spans_are_their_own_names():
    assert len(set(ALS_SPANS)) == len(ALS_SPANS)
    assert not set(ALS_SPANS) & set(SPANS)


def test_profiled_solve_records_exactly_the_als_spans(problem):
    _, events = events_of(lambda: solve(problem))
    assert {name for name, _, _ in events} == set(ALS_SPANS)


def test_als_spans_are_flat(problem):
    _, events = events_of(lambda: solve(problem))
    events.sort(key=lambda e: e[1])
    for (name0, s0, e0), (name1, s1, e1) in zip(events, events[1:]):
        assert s0 <= e0 <= s1 <= e1, (name0, name1)


@pytest.mark.parametrize("strategy", ["cuda", "segment"])
def test_span_counts_per_solve_and_iteration(problem, strategy):
    _, events = events_of(lambda: solve(problem, strategy))
    count = {name: sum(n == name for n, _, _ in events) for name in ALS_SPANS}
    n_modes = len(problem.shape)
    assert count == {
        ALS_PREP_VALIDATE: 1, ALS_PREP_SORT: 1, ALS_PREP_LAYOUT: 1,
        ALS_ITER_INPUTS: ITERS * n_modes, ALS_ITER_MTTKRP: ITERS * n_modes,
        ALS_ITER_SOLVE: ITERS * n_modes,
        # one per ridge solve (torch.linalg.solve reads its status on a
        # card) and one per fit
        ALS_ITER_SYNC: ITERS * (n_modes + 1),
        ALS_ITER_FIT: ITERS,
    }


def test_profiler_leaves_the_model_bitwise(problem):
    plain_kt, plain_fits = solve(problem)
    (traced_kt, traced_fits), _ = events_of(lambda: solve(problem))
    assert torch.equal(plain_kt.lam, traced_kt.lam)
    for a, b in zip(plain_kt.factors, traced_kt.factors):
        assert torch.equal(a, b)
    assert plain_fits == traced_fits


def test_cpapr_records_no_als_span_and_cp_als_no_cpapr_span(problem):
    cfg = CPAPRConfig(rank=RANK, max_outer=2, max_inner=3, strategy="cuda",
                      policy=PhiPolicy(block_nnz=32, block_rows=4))
    _, events = events_of(lambda: cpapr_mu(problem, RANK, seed=1, config=cfg,
                                           device="cpu"))
    names = {name for name, _, _ in events}
    assert names and not names & set(ALS_SPANS)
    _, events = events_of(lambda: solve(problem))
    assert not {name for name, _, _ in events} & set(SPANS)
