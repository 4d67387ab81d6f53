"""The N-D grid tier over a ``torch.distributed`` mesh of CPU ranks.

One spawn of ``gloo`` ranks per grid (a ``file://`` rendezvous under
``tmp_path``, a timeout that kills the ranks) runs every check of that
grid at once (:func:`repro_torch.testing.dist.grid_mesh_checks`) on the
conformance fixtures, handed over as numpy: 2 ranks as a 1 x 2 grid, 4 as
a 2 x 2 grid and 1 as a 1 x 1 grid.

  * ``phi_grid``, ``krao_grid`` and ``phi_mu_grid`` over the
    ``("row", "col")`` mesh are bitwise, on every rank, the port's
    one-device emulation at B <= 2 (a two-addend column sum is the same
    in either order); the 1 x 1 mesh also meets the dense f64 oracle;
  * one fused step (``phi_mu_grid_owner``), recorded by
    ``repro_torch.perf.comm.record_collectives`` (the port's counterpart
    of the JAX package's HLO collective count), issues exactly one
    all-gather and one reduce-scatter on the ``"col"`` group and one MAX
    all-reduce of a scalar, nothing on the ``"row"`` group; its column
    wire is ``grid_combine_wire_bound`` (= ``grid_scatter_wire_bytes``),
    at or above the Ballard/Knight/Rouse ``mttkrp_comm_lower_bound`` and,
    on grids of two or more rows, below the 1-D owner scatter's wire;
  * an S x 1 grid (1 x 1 here, and 2 x 1 and 4 x 1 meshes of the 2 and
    4 ranks) issues no column collective, and its Φ is bitwise the
    emulation's;
  * a grid ``cpapr_mu(mesh=...)`` is bitwise the emulated solve, and so
    is the same solve after the ladder's grid -> sharded rung, which
    runs the 1-D path on the mesh's ``"row"`` sub-mesh;
  * ``make_grid_mesh`` raises past the world size.
"""
import functools

import numpy as np
import pytest

from repro_torch.core import cpapr as P_cpapr
from repro_torch.core import distributed as P_dist
from repro_torch.core.convert import ktensor_from_numpy, sparse_tensor_from_numpy
from repro_torch.core.layout import (
    build_blocked_layout,
    build_grid_layout,
    owner_partition,
    shard_blocked_layout,
)
from repro_torch.core.phi import expand_to_grid
from repro_torch.core.pi import pi_rows
from repro_torch.core.policy import PhiPolicy
from repro_torch.core.sparse_tensor import sort_mode
from repro_torch.perf import comm as P_comm
from repro_torch.testing import dist as dist_harness
from repro_torch.testing import faults

from conftest import dense_phi_reference
from test_conformance import BN, BR, FIXTURES, RANK, TOL, make_fixture

GRIDS = {1: (1, 1), 2: (1, 2), 4: (2, 2)}  # world -> (A, B)
SPAWN_TIMEOUT = 300  # seconds for all checks of one grid


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this process's emulations (the ranks set
    their own), so they do not contend with the other test workers."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh_results(tmp_path_factory):
    """world -> rank results of one spawn, made on first use."""
    cache: dict = {}

    def get(world: int) -> list:
        if world not in cache:
            problems = {kind: dist_harness._as_numpy_problem(
                *make_fixture(kind)) for kind in FIXTURES}
            work = tmp_path_factory.mktemp(f"grid{world}")
            cache[world] = dist_harness.run_ranks(
                world, "grid_mesh_checks",
                (problems, BN, BR, RANK, GRIDS[world]), str(work),
                timeout=SPAWN_TIMEOUT)
        return cache[world]

    return get


@functools.lru_cache(maxsize=None)
def port_problem(kind: str):
    p = dist_harness._as_numpy_problem(*make_fixture(kind))
    t = sparse_tensor_from_numpy(p["shape"], p["indices"], p["values"],
                                 device="cpu")
    kt = ktensor_from_numpy(p["lam"], p["factors"], "cpu")
    return t, kt


@functools.lru_cache(maxsize=None)
def mode_inputs(kind: str, mode: int, shape: tuple):
    t, kt = port_problem(kind)
    mv = sort_mode(t, mode)
    pi = pi_rows(mv.sorted_idx, kt.factors, mode)
    b = kt.factors[mode] * kt.lam[None, :]
    g = build_grid_layout(
        build_blocked_layout(mv.rows.numpy(), mv.n_rows, BN, BR), shape)
    vals_cs, pi_cs = expand_to_grid(g, mv.sorted_vals, pi)
    return mv, pi, b, g, vals_cs, pi_cs


@functools.lru_cache(maxsize=None)
def emulated(kind: str, world: int) -> dict:
    """The same cases as the ranks run, through the one-device emulation."""
    out = {}
    for mode in range(3):
        _, _, b, g, vals_cs, pi_cs = mode_inputs(kind, mode, GRIDS[world])
        out[("phi", mode)] = P_dist.phi_grid(g, vals_cs, pi_cs, b).numpy()
        out[("krao", mode)] = P_dist.krao_grid(g, vals_cs, pi_cs).numpy()
        b_new, viol = P_dist.phi_mu_grid(g, vals_cs, pi_cs, b)
        out[("mu", mode)] = (b_new.numpy(), float(viol))
    return out


@pytest.mark.parametrize("op", ("phi", "krao", "mu"))
@pytest.mark.parametrize("kind", FIXTURES)
@pytest.mark.parametrize("world", sorted(GRIDS))
def test_grid_mesh_ops_are_bitwise_the_emulation(mesh_results, world, kind,
                                                 op):
    want = emulated(kind, world)
    for rank, got in enumerate(mesh_results(world)):
        for mode in range(3):
            g, w = got[(op, kind, mode)], want[(op, mode)]
            if op == "mu":
                assert g[1] == w[1], (rank, mode)
                g, w = g[0], w[0]
            np.testing.assert_array_equal(g, w, err_msg=f"rank {rank} "
                                                        f"mode {mode}")


@pytest.mark.parametrize("kind", FIXTURES)
def test_single_cell_grid_mesh_vs_oracle(mesh_results, kind):
    """A 1 x 1 grid on a one-rank mesh, which issues no column
    collective: the result meets the dense f64 oracle."""
    (got,) = mesh_results(1)
    for mode in range(3):
        mv, pi, b, *_ = mode_inputs(kind, mode, (1, 1))
        rows, vals = mv.rows.numpy(), mv.sorted_vals.numpy()
        phi_ref = dense_phi_reference(rows, vals, pi.numpy(), b.numpy(),
                                      mv.n_rows)
        np.testing.assert_allclose(got[("phi", kind, mode)], phi_ref, **TOL)
        mt_ref = np.zeros_like(phi_ref)
        np.add.at(mt_ref, rows, vals.astype(np.float64)[:, None]
                  * pi.numpy().astype(np.float64))
        np.testing.assert_allclose(got[("krao", kind, mode)], mt_ref, **TOL)
        b64 = b.numpy().astype(np.float64)
        viol = np.max(np.abs(np.minimum(b64, 1.0 - phi_ref)))
        np.testing.assert_allclose(got[("mu", kind, mode)][1], viol, **TOL)
        np.testing.assert_allclose(got[("mu", kind, mode)][0],
                                   b64 * phi_ref if viol > 1e-4 else b64,
                                   **TOL)


@pytest.mark.parametrize("world", (2, 4))
def test_fused_step_collectives_are_one_column_pair(mesh_results, world):
    """One all-gather and one reduce-scatter on the column group, one MAX
    all-reduce of a scalar over the mesh, none on the row group; the
    column wire is ``grid_combine_wire_bound`` exactly (there is no
    compiler's slack to allow), at or above ``mttkrp_comm_lower_bound``,
    and, on mode 0 as the JAX package asserts it, below the 1-D owner
    scatter's wire at the same world on an A >= 2 grid.  Elsewhere it is
    printed: a 1 x B grid's can be larger, and the 2 x 2 grid of hub's
    and empty_row's mode 2 splits its 4 row blocks 1 + 3, so its owner
    window pads to 12 rows and its wire ties the 1-D one."""
    a, b_ax = GRIDS[world]
    for got in mesh_results(world):
        for kind in FIXTURES:
            for mode in range(3):
                log = got[("collectives", kind, mode)]
                assert [(c.kind, c.tag, c.group_size) for c in log] == [
                    ("all-gather", "col", b_ax),
                    ("reduce-scatter", "col", b_ax),
                    ("all-reduce", "world", world)], log
                mv, _, _, g, _, _ = mode_inputs(kind, mode, GRIDS[world])
                cs = P_comm.collective_stats(log[:2])
                wire = cs.wire_bytes
                assert wire == P_comm.grid_combine_wire_bound(
                    g.sub_rows, RANK, b_ax) \
                    == P_dist.grid_scatter_wire_bytes(g, RANK) > 0
                assert wire >= P_comm.mttkrp_comm_lower_bound(
                    mv.n_rows, RANK, world)
                assert P_comm.collective_stats(log[2:]).wire_bytes <= 64
                wire_1d = P_dist.owner_scatter_wire_bytes(owner_partition(
                    shard_blocked_layout(build_blocked_layout(
                        mv.rows.numpy(), mv.n_rows, BN, BR), world)), RANK)
                print(f"{kind} mode {mode} grid {a}x{b_ax}: column wire "
                      f"{wire:.0f}, 1-D owner wire {wire_1d:.0f}")
                if a >= 2 and mode == 0:
                    assert wire < wire_1d, (kind, mode, wire, wire_1d)


@pytest.mark.parametrize("world", sorted(GRIDS))
def test_s_by_1_grid_issues_no_column_collective(mesh_results, world):
    """A grid of one column has nothing to gather or scatter over it: its
    fused step issues the scalar KKT max alone, and its Φ is bitwise the
    emulated S x 1 grid's."""
    for got in mesh_results(world):
        for kind in FIXTURES:
            for mode in range(3):
                if world == 1:
                    log, phi = got[("collectives", kind, mode)], None
                else:
                    log, phi = got[("sx1", kind, mode)]
                assert [(c.kind, c.tag) for c in log] == [
                    ("all-reduce", "world")], (kind, mode, log)
                if phi is not None:
                    _, _, b, g, vals_cs, pi_cs = mode_inputs(kind, mode,
                                                             (world, 1))
                    np.testing.assert_array_equal(
                        phi, P_dist.phi_grid(g, vals_cs, pi_cs, b).numpy())


@functools.lru_cache(maxsize=None)
def emulated_cpapr(kind: str, world: int, rung: bool):
    t, kt = port_problem(kind)
    cfg = P_cpapr.CPAPRConfig(
        rank=RANK, max_outer=3, strategy="grid", grid_shape=GRIDS[world],
        n_shards=world, max_demotions=4 if rung else 0,
        policy=PhiPolicy(strategy="blocked", block_nnz=BN, block_rows=BR))
    if not rung:
        return P_cpapr.cpapr_mu(t, RANK, init=kt, config=cfg, device="cpu")
    with faults.fail_strategy(strategy="grid", mode=0):
        return P_cpapr.cpapr_mu(t, RANK, init=kt, config=cfg, device="cpu")


@pytest.mark.parametrize("case", ("cpapr", "rung"))
@pytest.mark.parametrize("kind", FIXTURES)
@pytest.mark.parametrize("world", sorted(GRIDS))
def test_grid_mesh_cpapr_is_bitwise_the_emulation(mesh_results, world, kind,
                                                  case):
    want = emulated_cpapr(kind, world, case == "rung")
    a, b = GRIDS[world]
    rungs = [] if case == "cpapr" else [(
        "demote_kernel", 0,
        f"grid {a}x{b}->sharded@{a}" if a > 1
        else f"grid 1x{b}->single-device blocked")]
    assert [(e.kind, e.mode, e.detail["action"])
            for e in want.recoveries or []] == rungs
    for got in (r[(case, kind)] for r in mesh_results(world)):
        assert got["recoveries"] == rungs
        assert got["inner"] == want.inner_iters
        assert got["kkt"] == want.kkt_history
        assert got["loglik"] == want.loglik_history
        np.testing.assert_array_equal(got["lam"], want.ktensor.lam.numpy())
        for g, w in zip(got["factors"], want.ktensor.factors):
            np.testing.assert_array_equal(g, w.numpy())


@pytest.mark.parametrize("world", sorted(GRIDS))
def test_make_grid_mesh_raises_past_world_size(mesh_results, world):
    for got in mesh_results(world):
        assert "ranks, the process group has" in got["mesh_error"]


def test_make_grid_mesh_needs_a_process_group():
    import torch.distributed as dist

    if dist.is_initialized():  # pragma: no cover - a stray group
        pytest.skip("a process group is already initialized here")
    with pytest.raises(ValueError, match="process group"):
        P_dist.make_grid_mesh(2, 2, "cpu")
