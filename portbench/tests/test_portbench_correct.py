"""The check that decides ``correct`` fails what it must: the control (the
reference computed as TF32 units would, in the program's place) and a
run whose timed path is broken underneath.

The program's own numbers here come from its plain CPU versions, which
round differently from its kernels on the card, so a sound CPU run is
held only to reading far below the faults; the limits were set from the
card (``calibrate.py``; PERF.md).  A cell on one chip has no exchange
between chips to leave out.
"""
import dataclasses

import pytest
import torch
from conftest import shrunk

from portbench import harness
from portbench.solvers import cpapr_mu as solver

CPU = torch.device("cpu")


@pytest.mark.parametrize("cell", ["uber.cpapr", "nell2.cpapr"])
def test_control_fails_a_limit(cell):
    c = shrunk(cell, 4 if cell == "uber.cpapr" else 64)
    problem = harness.make_problem(c, 2**31 + 3, CPU)
    ref = solver.reference(problem, c.traffic)
    ctl = solver.reference(problem, c.traffic, control=True)
    nums = solver.compare(ctl, ref)
    assert any(nums[k] > c.limits[k] for k in c.limits), nums


def _unchanged(real):
    """A solve that returns its state unchanged: the start, normalised."""
    def fake(t, rank, seed=None, init=None, config=None, **kw):
        res = real(t, rank, init=init,
                   config=dataclasses.replace(config, max_outer=1), **kw)
        return dataclasses.replace(res, ktensor=init.normalize(),
                                   n_outer=config.max_outer)
    return fake


def _half_batch(real):
    """Half of the nonzeros left out, the rest counted twice (the mean over
    the rest)."""
    def fake(t, rank, **kw):
        from repro_torch.core.sparse_tensor import SparseTensor
        half = t.nnz // 2
        return real(SparseTensor(t.shape, t.indices[:half],
                                 t.values[:half] * 2.0), rank, **kw)
    return fake


def _altered(real):
    """One answer altered where it is produced: a fitted factor entry."""
    def fake(*a, **kw):
        res = real(*a, **kw)
        f0 = res.ktensor.factors[0].clone()
        f0[0, 0] *= 1.1
        kt = dataclasses.replace(res.ktensor,
                                 factors=(f0,) + res.ktensor.factors[1:])
        return dataclasses.replace(res, ktensor=kt)
    return fake


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered])
def test_broken_timed_path_is_not_correct(monkeypatch, fault):
    import repro_torch.core.cpapr as cpapr

    cell = shrunk("uber.cpapr", 8, max_outer=4)
    sound = harness.execute(cell, 77, 0.0, False, CPU, 0.0)
    monkeypatch.setattr(cpapr, "cpapr_mu", fault(cpapr.cpapr_mu))
    broken = harness.execute(cell, 77, 0.0, False, CPU, 0.0)
    assert broken["correct"] is False
    assert broken["failed"] == broken["attempted"] >= 1
    worst = max(broken["checks"][k]["value"] / max(
        sound["checks"][k]["value"], 1e-12) for k in cell.limits)
    assert worst > 10
    assert any(c["value"] > c["limit"] for c in broken["checks"].values())


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["uber.cpapr", "nell2.cpapr"])
def test_program_passes_and_control_fails_at_the_cell_size(card, cell):
    """On the card, at the cell's own size: the program's solve within
    every limit, the control outside one (three seeds each)."""
    c = harness.load_cell(cell)
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
