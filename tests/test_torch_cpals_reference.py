"""The port's ``cp_als`` on the CPU against the benchmark's plain CP-ALS
(``portbench/reference/cp_als.py``: float64, plain PyTorch, nothing of the
port), and the check that decides a ``uber.cpals`` run's ``correct``.

Both fit from the same seeded start on tensors drawn by the benchmark's
generator: a 4-mode cut of FROSTT uber (each dim divided by 8, nonzeros
by 64) and a small 3-mode tensor.  The port's ``segment`` and ``blocked``
solves stay within ``TOL`` of the reference in each number that
``solvers/cp_als.py::compare`` returns; the TF32 control (the reference in
float32 with the operands of MTTKRP and of the Gram products rounded to
TF32) departs by more than ``TOL``.  The cut of uber is fitted at rank 4:
its hour mode keeps 3 of 24 rows, and at the benchmark's rank 16 the
normal equations of that mode would be singular but for the ridge.

On the cell cut the same way, the control fails a limit of
``cells/uber.cpals.json``, and so does each broken solve run through the
harness: one that returns its start (normalised), and one whose mode-1
update is skipped.
"""
import dataclasses
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402
from portbench.generators import planted_poisson  # noqa: E402
from portbench.solvers import cp_als as solver  # noqa: E402

CPU = torch.device("cpu")
ITERS = 20
#: float32 rounding of MTTKRP's sums, carried through 20 iterations of
#: the normal equations (whose Gram matrices amplify it by their
#: condition): the port reads at most ~7e-5 here, the TF32 control at
#: least ~7e-4
TOL = 3e-4


def shrunk_cell(k: int = 8, rank: int = 4):
    """``uber.cpals`` with each dim divided by ``k``, its nonzeros by
    ``k**2``, fitted at ``rank``."""
    cell = harness.load_cell("uber.cpals", ROOT)
    config = dict(cell.config,
                  dims=[max(int(d) // k, 2) for d in cell.config["dims"]],
                  nnz=int(cell.config["nnz"]) // (k * k))
    return dataclasses.replace(cell, config=config,
                               traffic=dict(cell.traffic, rank=rank))


TINY3 = {"name": "tiny3", "dims": [30, 20, 25], "nnz": 3000,
         "planted_rank": 4, "generator": "planted_poisson"}
CASES = {"uber-cut": lambda: (shrunk_cell().config, 4),
         "3mode": lambda: (TINY3, 16)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small solves: one intra-op thread, so that the test workers'
    threads do not contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _problem(case: str, seed: int) -> tuple:
    config, rank = CASES[case]()
    idx, vals, _ = planted_poisson.make(config, seed, CPU)
    lam0, f0 = planted_poisson.draw_start(config["dims"], rank, seed + 100,
                                          CPU)
    return {"dims": config["dims"], "indices": idx, "values": vals,
            "lam0": lam0, "factors0": f0}, rank


_REFS: dict = {}


def _reference(case: str, seed: int, control: bool = False):
    key = (case, seed, control)
    if key not in _REFS:
        problem, rank = _problem(case, seed)
        _REFS[key] = solver.reference(problem, {"n_iters": ITERS}, control)
    return _REFS[key]


@pytest.mark.parametrize("seed", [11, 12])
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("strategy", ["segment", "blocked"])
def test_port_matches_the_plain_reference(strategy, case, seed):
    problem, rank = _problem(case, seed)
    traffic = {"rank": rank, "n_iters": ITERS, "strategy": strategy}
    ans = solver.solve(solver.program_inputs(problem), traffic, CPU)
    nums = solver.compare(ans, _reference(case, seed))
    assert set(nums) == {"lam_rel", "factor_rel", "model_rel"}
    assert all(v <= TOL for v in nums.values()), nums
    assert len(ans["fits"]) == ITERS


@pytest.mark.parametrize("seed", [11, 12])
@pytest.mark.parametrize("case", sorted(CASES))
def test_control_departs_by_more(case, seed):
    ref = _reference(case, seed)
    ctl = _reference(case, seed, control=True)
    assert ctl["lam"].dtype == torch.float32
    assert ref["lam"].dtype == torch.float64
    nums = solver.compare(ctl, ref)
    assert max(nums.values()) > TOL, nums


@pytest.mark.parametrize("seed", [2**31 + 3, 7])
def test_control_fails_a_limit_of_the_shrunk_cell(seed):
    cell = shrunk_cell()
    problem = harness.make_problem(cell, seed, CPU)
    ref = solver.reference(problem, cell.traffic)
    nums = solver.compare(solver.reference(problem, cell.traffic,
                                           control=True), ref)
    assert any(nums[k] > cell.limits[k] for k in cell.limits), nums


def test_reference_is_ridge_als_in_float64():
    """One iteration by hand on a dense 3-mode tensor: MTTKRP as the
    unfolding times the Khatri-Rao product, the ridge normal equations,
    the fit as the norm of the dense residual, unit column sums at the
    end (``KTensor.normalize``'s convention)."""
    problem, rank = _problem("3mode", 11)
    ref = solver.reference(problem, {"n_iters": 1})
    x = torch.zeros(problem["dims"], dtype=torch.float64)
    x[tuple(problem["indices"].T)] = problem["values"].double()
    a = [f.double() for f in problem["factors0"]]
    a[0] = a[0] * problem["lam0"].double()[None, :]
    eye = torch.eye(rank, dtype=torch.float64)
    subs = "ijk"
    for n in range(3):
        others = [m for m in range(3) if m != n]
        m_n = torch.einsum(f"ijk,{subs[others[0]]}r,{subs[others[1]]}r->"
                           f"{subs[n]}r", x, a[others[0]], a[others[1]])
        gram = torch.ones((rank, rank), dtype=torch.float64)
        for m in others:
            gram = gram * (a[m].T @ a[m])
        a[n] = torch.linalg.solve(gram + 1e-10 * eye, m_n.T).T
    model = torch.einsum("ir,jr,kr->ijk", *a)
    fit = 1 - float(torch.linalg.vector_norm(x - model)
                    / torch.linalg.vector_norm(x))
    assert ref["fits"] == [pytest.approx(fit, rel=1e-9, abs=1e-12)]
    # unit column sums, the scale in lam; a column whose sum is not
    # positive (ALS factors may be negative) is kept and its weight zeroed
    lam = torch.ones(rank, dtype=torch.float64)
    for n in range(3):
        s = a[n].sum(0)
        lam = lam * torch.where(s > 0, s, 0.0)
        torch.testing.assert_close(ref["factors"][n],
                                   torch.where(s > 0, a[n] / s, a[n]),
                                   rtol=1e-9, atol=1e-12)
    torch.testing.assert_close(ref["lam"], lam, rtol=1e-9, atol=0)


def _returns_the_start(real):
    """A solve that returns its start, normalised (its weights folded into
    the first factor, as ``cp_als`` folds them), and fits of its length."""
    def fake(t, rank, n_iters=20, seed=None, init=None, **kw):
        kt = dataclasses.replace(init, factors=(init.factors[0] * init.lam,)
                                 + tuple(init.factors[1:]),
                                 lam=torch.ones_like(init.lam)).normalize()
        return kt, [0.0] * n_iters
    return fake


def _skips_mode_1(real):
    """Mode 1's update leaves its factor as it was."""
    def fake(mv, *a, **kw):
        update = real(mv, *a, **kw)
        return (lambda factors: factors[1]) if mv.mode == 1 else update
    return fake


@pytest.mark.parametrize("fault,target", [
    (_returns_the_start, "cp_als"), (_skips_mode_1, "_make_als_mode_update")])
def test_broken_solve_fails_a_limit(monkeypatch, fault, target):
    import repro_torch.core.cpals as cpals

    cell = shrunk_cell()
    sound = harness.execute(cell, 2**31 + 77, 0.0, False, CPU, 0.0)
    assert sound["correct"] is True, sound["checks"]
    monkeypatch.setattr(cpals, target, fault(getattr(cpals, target)))
    broken = harness.execute(cell, 2**31 + 77, 0.0, False, CPU, 0.0)
    assert broken["correct"] is False
    assert broken["failed"] == broken["attempted"] >= 1
    assert any(c["value"] > c["limit"] for c in broken["checks"].values())
    worst = max(broken["checks"][k]["value"] / max(
        sound["checks"][k]["value"], 1e-12) for k in cell.limits)
    assert worst > 10
