"""The tensor generator: published dims, the nonzeros it draws and keeps,
and the same tensor for the same seed."""
import pytest
import torch
from conftest import shrunk

from portbench import harness
from portbench.generators import planted_poisson

CPU = torch.device("cpu")

#: FROSTT's published dims and nonzero counts (frostt.io)
PUBLISHED = {"frostt-nell2": ([12092, 9184, 28818], 76879419),
             "frostt-uber": ([183, 24, 1140, 1717], 3309490)}


@pytest.mark.parametrize("cell", ["nell2.cpapr", "uber.cpapr"])
def test_configuration_keeps_published_sizes(cell):
    config = harness.load_cell(cell).config
    assert (config["dims"], config["nnz"]) == PUBLISHED[config["name"]]
    assert config["reduced"] == []


@pytest.mark.parametrize("cell,k", [("nell2.cpapr", 64), ("uber.cpapr", 8)])
def test_tensor_shape_and_counts(cell, k):
    c = shrunk(cell, k)
    idx, vals, info = planted_poisson.make(c.config, 2**31 + 5, CPU)
    dims = c.config["dims"]
    assert info["nnz_drawn"] == c.config["nnz"]
    assert 0.5 * info["nnz_drawn"] < info["nnz_stored"] <= info["nnz_drawn"]
    assert idx.shape == (info["nnz_stored"], len(dims))
    assert vals.shape == (info["nnz_stored"],) and vals.dtype == torch.float32
    for n, d in enumerate(dims):
        assert int(idx[:, n].min()) >= 0 and int(idx[:, n].max()) < d
    assert bool((vals >= 1).all()) and bool((vals == vals.round()).all())
    # duplicates merged: the coordinates are distinct, in row-major order
    lin = torch.zeros(idx.shape[0], dtype=torch.int64)
    for n, d in enumerate(dims):
        lin = lin * d + idx[:, n]
    assert bool((lin[1:] > lin[:-1]).all())
    # the merged values keep the drawn mass: each draw is Poisson(1) + 1
    assert abs(float(vals.sum()) / info["nnz_drawn"] - 2.0) < 0.05


def test_same_seed_same_tensor_and_start():
    c = shrunk("uber.cpapr", 8)
    a = harness.make_problem(c, 3_000_000_017, CPU)
    b = harness.make_problem(c, 3_000_000_017, CPU)
    other = harness.make_problem(c, 3_000_000_018, CPU)
    assert torch.equal(a["indices"], b["indices"])
    assert torch.equal(a["values"], b["values"])
    assert torch.equal(a["lam0"], b["lam0"])
    assert all(torch.equal(x, y) for x, y in zip(a["factors0"], b["factors0"]))
    assert a["indices"].shape != other["indices"].shape or \
        not torch.equal(a["indices"], other["indices"])
    assert not torch.equal(a["lam0"], other["lam0"])


def test_start_is_a_positive_model_of_the_solve_rank():
    lam, factors = planted_poisson.draw_start([5, 7, 3], 16, 9, CPU)
    assert lam.shape == (16,) and lam.dtype == torch.float32
    assert [f.shape for f in factors] == [(5, 16), (7, 16), (3, 16)]
    for f in factors:
        assert bool((f > 0).all())
        torch.testing.assert_close(f.sum(0), torch.ones(16))


def test_run_prints_the_stored_nnz(capsys):
    c = shrunk("uber.cpapr", 8, max_outer=2)
    harness.execute(c, 11, 0.0, False, CPU, 0.0)
    err = capsys.readouterr().err
    assert "nnz drawn 51710, stored" in err
