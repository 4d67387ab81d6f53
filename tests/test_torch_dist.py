"""The row-sharded tier over a ``torch.distributed`` mesh of CPU ranks.

For world sizes 2 and 4, one spawn of ``gloo`` ranks (a ``file://``
rendezvous under ``tmp_path``, a timeout that kills the ranks) runs
every check of that world size at once
(:func:`repro_torch.testing.dist.sharded_mesh_checks`) on the
conformance fixtures, handed over as numpy:

  * ``phi_sharded``, ``krao_sharded`` (both combines, replicated and
    shard-local Π) and ``phi_mu_sharded_owner`` over a ``("data",)``
    mesh are bitwise equal, on every rank, to the port's one-device
    emulation: each combine adds exact zeros;
  * ``cpapr_mu(mesh=...)`` with both combines and ``rebalance_every=1``
    is bitwise the emulated solve;
  * ``dist_cpapr_mu`` is within ``TOL`` of the JAX package's
    ``dist_cpapr_mu`` on the same mesh shape, which runs in a subprocess
    with forced host devices, as ``tests/test_sharded_phi.py`` runs it
    (the JAX package's needs a ``"model"`` axis, so its mesh for the
    port's ``(2,)`` data mesh is ``(2, 1)``); a rank the model axis does
    not divide falls back to one device with a warning;
  * ``make_phi_mesh`` raises past the world size;
  * the collectives hold to the communication model
    (``repro_torch.perf.comm``, the port's ``repro/perf/hlo.py``), as
    ``tests/test_conformance.py``, ``test_sharded_phi.py``,
    ``test_sharded_pi.py`` and ``test_dense_tier.py`` hold the JAX
    package's compiled programs: the fused owner step issues one
    reduce-scatter whose recorded wire is ``owner_scatter_wire_bytes``,
    the psum Φ one all-reduce of ``allreduce_wire_bytes`` of the combine
    buffer at the recorded operand's itemsize, within
    ``phi_combine_wire_bound``; ``preferred_combine`` follows the two
    recorded wires; the shard-local Π inputs of the reference's clustered
    tensor stay within ``pi_gather_wire_bound``.  The port has no
    compiler between it and its collectives, so the recorded wire equals
    the model exactly where the reference allows XLA 10% slack.
"""
import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from repro_torch.core import cpapr as P_cpapr
from repro_torch.core import distributed as P_dist
from repro_torch.core.convert import ktensor_from_numpy, sparse_tensor_from_numpy
from repro_torch.core.layout import (
    build_blocked_layout,
    build_shard_pi_gather,
    owner_partition,
    shard_blocked_layout,
)
from repro_torch.core.phi import expand_to_shards
from repro_torch.core.pi import pi_rows
from repro_torch.core.policy import PhiPolicy
from repro_torch.core.sparse_tensor import sort_mode
from repro_torch.perf import comm as P_comm
from repro_torch.testing import dist as dist_harness

from test_conformance import BN, BR, FIXTURES, RANK, TOL, make_fixture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (2, 4)
DIST_CFG = dict(max_outer=3, max_inner=5)
SPAWN_TIMEOUT = 400  # seconds for all checks of one world size


def _numpy_problems() -> dict:
    return {kind: dist_harness._as_numpy_problem(*make_fixture(kind))
            for kind in FIXTURES}


PI_BN, PI_BR = 64, 8  # the reference's blocking of its clustered tensor


def _pi_problem() -> dict:
    """The reference's clustered tensor (``tests/test_sharded_pi.py``),
    built by the JAX package: each row-block shard touches only a slice
    of the other modes' rows."""
    import jax
    import jax.numpy as jnp

    from repro.core.sparse_tensor import SparseTensor, random_ktensor

    rng = np.random.default_rng(0)
    nnz, i0_n, i1_n, i2_n = 2400, 64, 120, 100
    i0 = np.sort(rng.integers(0, i0_n, nnz)).astype(np.int32)
    i1 = ((i0 * i1_n // i0_n) + rng.integers(0, 8, nnz)) % i1_n
    i2 = ((i0 * i2_n // i0_n) + rng.integers(0, 8, nnz)) % i2_n
    idx = np.stack([i0, i1.astype(np.int32), i2.astype(np.int32)], 1)
    t = SparseTensor(shape=(i0_n, i1_n, i2_n), indices=jnp.asarray(idx),
                     values=jnp.asarray((rng.poisson(1.0, nnz) + 1.0)
                                        .astype(np.float32)))
    kt = random_ktensor(jax.random.PRNGKey(0), t.shape, RANK)
    return dict(dist_harness._as_numpy_problem(t, kt), bn=PI_BN, br=PI_BR)


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
            work = tmp_path_factory.mktemp(f"ranks{world}")
            cache[world] = dist_harness.run_ranks(
                world, "sharded_mesh_checks",
                (_numpy_problems(), BN, BR, RANK, DIST_CFG, _pi_problem()),
                str(work), timeout=SPAWN_TIMEOUT)
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
def emulated(kind: str, world: int) -> dict:
    """The same cases as the ranks run, through the one-device emulation."""
    t, kt = port_problem(kind)
    out = {}
    for mode in range(t.ndim):
        mv = sort_mode(t, mode)
        pi = pi_rows(mv.sorted_idx, kt.factors, mode)
        b = kt.factors[mode] * kt.lam[None, :]
        sl = shard_blocked_layout(
            build_blocked_layout(mv.rows.numpy(), mv.n_rows, BN, BR), world)
        vals_es, pi_es = expand_to_shards(sl, mv.sorted_vals, pi)
        pig = build_shard_pi_gather(sl, mv.sorted_idx, mode)
        for combine in P_dist.PHI_COMBINES:
            for local_pi in (False, True):
                kw = dict(combine=combine)
                if local_pi:
                    kw.update(pi_gather=pig, factors=kt.factors)
                out[("phi", mode, combine, local_pi)] = P_dist.phi_sharded(
                    sl, vals_es, pi_es, b, **kw).numpy()
                out[("krao", mode, combine, local_pi)] = P_dist.krao_sharded(
                    sl, vals_es, pi_es, **kw).numpy()
        opart = owner_partition(sl)
        b_own, viol = P_dist.phi_mu_sharded_owner(
            sl, opart, vals_es, pi_es, P_dist.owner_stack(opart, b))
        out[("owner_mu", mode)] = (P_dist.owner_unstack(opart, b_own).numpy(),
                                   float(viol))
    return out


@pytest.mark.parametrize("op", ("phi", "krao", "owner_mu"))
@pytest.mark.parametrize("kind", FIXTURES)
@pytest.mark.parametrize("world", WORLDS)
def test_mesh_ops_are_bitwise_the_emulation(mesh_results, world, kind, op):
    want = emulated(kind, world)
    for rank, got in enumerate(mesh_results(world)):
        for mode in range(3):
            if op == "owner_mu":
                gb, gv = got[("owner_mu", kind, mode)]
                wb, wv = want[("owner_mu", mode)]
                np.testing.assert_array_equal(gb, wb)
                assert gv == wv, (rank, mode)
                continue
            for combine in P_dist.PHI_COMBINES:
                for local_pi in (False, True):
                    np.testing.assert_array_equal(
                        got[(op, kind, mode, combine, local_pi)],
                        want[(op, mode, combine, local_pi)],
                        err_msg=f"rank {rank} mode {mode} {combine} "
                                f"local_pi={local_pi}")


@functools.lru_cache(maxsize=None)
def emulated_cpapr(kind: str, world: int, combine: str):
    t, kt = port_problem(kind)
    cfg = P_cpapr.CPAPRConfig(
        rank=RANK, max_outer=3, strategy="sharded", n_shards=world,
        combine=combine, rebalance_every=1,
        policy=PhiPolicy(strategy="blocked", block_nnz=BN, block_rows=BR))
    return P_cpapr.cpapr_mu(t, RANK, init=kt, config=cfg, device="cpu")


@pytest.mark.parametrize("combine", P_dist.PHI_COMBINES)
@pytest.mark.parametrize("kind", FIXTURES)
@pytest.mark.parametrize("world", WORLDS)
def test_mesh_cpapr_is_bitwise_the_emulation(mesh_results, world, kind,
                                             combine):
    want = emulated_cpapr(kind, world, combine)
    for got in (r[("cpapr", kind, combine)] for r in mesh_results(world)):
        assert got["inner"] == want.inner_iters
        assert got["kkt"] == want.kkt_history
        assert got["loglik"] == want.loglik_history
        assert got["rebalances"] == want.rebalances
        np.testing.assert_array_equal(got["lam"], want.ktensor.lam.numpy())
        for g, w in zip(got["factors"], want.ktensor.factors):
            np.testing.assert_array_equal(g, w.numpy())


REFERENCE_DIST = """
import json, sys
import jax, numpy as np
sys.path.insert(0, {tests!r})
from test_conformance import FIXTURES, RANK, make_fixture
from repro.core.distributed import DistCPAPRConfig, dist_cpapr_mu
assert jax.device_count() == {world}
mesh = jax.make_mesh({shape}, ("data", "model"))
out = {{}}
for kind in FIXTURES:
    t, kt = make_fixture(kind)
    k, hist = dist_cpapr_mu(t, RANK, mesh, init=kt,
                            config=DistCPAPRConfig(rank=RANK, **{cfg!r}))
    out[kind] = dict(lam=np.asarray(k.lam).tolist(), kkt=hist,
                     factors=[np.asarray(f).tolist() for f in k.factors])
print("RESULT", json.dumps(out))
"""


@functools.lru_cache(maxsize=None)
def reference_dist(world: int) -> dict:
    shape = (2, 1) if world == 2 else (2, 2)
    script = REFERENCE_DIST.format(tests=os.path.join(REPO, "tests"),
                                   world=world, shape=shape, cfg=DIST_CFG)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={world}")
    out = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=560)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [x for x in out.stdout.splitlines() if x.startswith("RESULT ")]
    return json.loads(line[-1][len("RESULT "):])


@pytest.mark.parametrize("kind", FIXTURES)
@pytest.mark.parametrize("world", WORLDS)
def test_dist_cpapr_mu_matches_reference(mesh_results, world, kind):
    want = reference_dist(world)[kind]
    for got in (r[("dist", kind)] for r in mesh_results(world)):
        np.testing.assert_allclose(got["kkt"], want["kkt"], **TOL)
        np.testing.assert_allclose(got["lam"], want["lam"], **TOL)
        for g, w in zip(got["factors"], want["factors"]):
            assert g.shape == np.asarray(w).shape
            np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("kind", FIXTURES)
def test_dist_cpapr_invalid_mesh_falls_back_single_device(mesh_results,
                                                          kind):
    """A rank the model axis does not divide warns and runs on one device,
    as the single-device solve does (the reference's tolerance)."""
    t, kt = port_problem(kind)
    odd = RANK - 1
    init = type(kt)(lam=kt.lam[:odd],
                    factors=tuple(f[:, :odd] for f in kt.factors))
    want = P_cpapr.cpapr_mu(t, odd, init=init, device="cpu",
                            config=P_cpapr.CPAPRConfig(
                                rank=odd, track_loglik=False, **DIST_CFG))
    for got in (r[("dist_fallback", kind)] for r in mesh_results(4)):
        assert any("falling back" in w for w in got["warnings"]), got
        for g, w in zip(got["factors"], want.ktensor.factors):
            np.testing.assert_allclose(g, w.numpy(), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_make_phi_mesh_raises_past_world_size(mesh_results, world):
    for got in mesh_results(world):
        assert got["mesh_error"] is not None
        assert "world size" in got["mesh_error"]


def test_make_phi_mesh_needs_a_process_group():
    import torch.distributed as dist

    if dist.is_initialized():  # pragma: no cover - a stray group
        pytest.skip("a process group is already initialized here")
    with pytest.raises(ValueError, match="process group"):
        P_dist.make_phi_mesh(2, "cpu")


def test_rank_failure_and_timeout_are_reported(tmp_path):
    """The harness surfaces a rank's traceback, and kills ranks that
    outlive the timeout instead of waiting for them."""
    with pytest.raises(RuntimeError, match="rank 0 failed"):
        dist_harness.run_ranks(1, "sharded_mesh_checks",
                               ({"x": {}}, BN, BR, RANK, DIST_CFG),
                               str(tmp_path / "fail"), timeout=120)
    with pytest.raises(TimeoutError, match="still running"):
        dist_harness.run_ranks(2, "idle", (600.0,), str(tmp_path / "hang"),
                               timeout=20)


# ---------------------------------------------------------------------------
# The communication model against the recorded collectives
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def sharded_layout(kind: str, mode: int, world: int) -> tuple:
    """(n_rows, layout, owner partition) of one fixture mode at ``world``
    shards, as the ranks build them."""
    t, _ = port_problem(kind)
    mv = sort_mode(t, mode)
    sl = shard_blocked_layout(
        build_blocked_layout(mv.rows.numpy(), mv.n_rows, BN, BR), world)
    return mv.n_rows, sl, owner_partition(sl)


def _wires(got: dict, kind: str, mode: int, tier: str = "") -> tuple:
    """(owner step's stats, psum Φ's stats) of one rank's records."""
    rec = got[("wire", kind, mode)]
    return (P_comm.collective_stats(rec["owner" + tier]),
            P_comm.collective_stats(rec["psum" + tier]))


@pytest.mark.parametrize("kind", FIXTURES)
@pytest.mark.parametrize("world", WORLDS)
def test_owner_step_is_one_reduce_scatter_of_the_model_wire(mesh_results,
                                                            world, kind):
    """The fused owner step: exactly one reduce-scatter over the data
    group, no all-gather, one scalar KKT max; its recorded wire is
    ``owner_scatter_wire_bytes`` exactly."""
    for got in mesh_results(world):
        for mode in range(3):
            _, sl, opart = sharded_layout(kind, mode, world)
            log = got[("wire", kind, mode)]["owner"]
            assert [(c.kind, c.tag, c.group_size) for c in log] == [
                ("reduce-scatter", "data", world),
                ("all-reduce", "data", world)], log
            assert log[1].type == "f32[]"
            rs, _ = _wires(got, kind, mode)
            assert rs.by_kind_count.get("all-gather", 0) == 0
            assert rs.by_kind_wire["reduce-scatter"] == \
                P_dist.owner_scatter_wire_bytes(opart, RANK) > 0


@pytest.mark.parametrize("kind", FIXTURES)
@pytest.mark.parametrize("world", WORLDS)
def test_psum_wire_is_the_combine_buffer_within_bound(mesh_results, world,
                                                      kind):
    """``phi_sharded(combine="psum")``: one all-reduce of the combine
    buffer, ``allreduce_wire_bytes(sharded_combine_bytes(sl, R, itemsize),
    S)`` at the recorded operand's itemsize, within the O(I_n * R)
    ``phi_combine_wire_bound``."""
    for got in mesh_results(world):
        for mode in range(3):
            n_rows, sl, _ = sharded_layout(kind, mode, world)
            (c,) = got[("wire", kind, mode)]["psum"]
            assert (c.kind, c.tag, c.group_size) == ("all-reduce", "data",
                                                     world)
            _, ps = _wires(got, kind, mode)
            wire = ps.by_kind_wire["all-reduce"]
            assert wire == P_comm.allreduce_wire_bytes(
                P_dist.sharded_combine_bytes(sl, RANK, c.itemsize), world)
            assert 0 < wire <= P_comm.phi_combine_wire_bound(
                n_rows, RANK, world, block_rows=BR)


@pytest.mark.parametrize("kind", FIXTURES)
@pytest.mark.parametrize("world", WORLDS)
def test_preferred_combine_follows_the_recorded_wire(mesh_results, world,
                                                     kind):
    """``preferred_combine`` picks the reduce-scatter exactly where its
    recorded wire is at most the psum's; on the balanced ``uniform``
    split it is strictly below the psum's and within
    ``phi_reduce_scatter_wire_bound``; on every fixture the owned slice
    is smaller than the replicated combine window."""
    for got in mesh_results(world):
        for mode in range(3):
            n_rows, sl, opart = sharded_layout(kind, mode, world)
            rs, ps = (w.by_kind_wire[k] for w, k in zip(
                _wires(got, kind, mode), ("reduce-scatter", "all-reduce")))
            pref = P_dist.preferred_combine(sl, RANK)
            assert (pref == "reduce_scatter") == (rs <= ps), (mode, rs, ps)
            if kind == "uniform":
                assert 0 < rs < ps, (mode, rs, ps)
                assert rs <= P_comm.phi_reduce_scatter_wire_bound(
                    n_rows, RANK, world, block_rows=BR), mode
            assert opart.scatter_bytes(RANK) < \
                P_dist.sharded_combine_bytes(sl, RANK)


@pytest.mark.parametrize("world", WORLDS)
def test_combine_wire_tracks_the_operand_itemsize(mesh_results, world):
    """Under a bf16 tier the blocked shard windows are bf16, and so are
    both combine operands (XLA promotes a bf16 all-reduce to f32, the
    port does not): the model at the recorded itemsize is the wire, half
    the f32 wire."""
    _, sl, opart = sharded_layout("uniform", 0, world)
    for got in mesh_results(world):
        rec = got[("wire", "uniform", 0)]
        assert [c.type.split("[")[0] for c in rec["psum_bf16"]] == ["bf16"]
        assert rec["owner_bf16"][0].itemsize == 2
        rs, ps = _wires(got, "uniform", 0, "_bf16")
        rs32, ps32 = _wires(got, "uniform", 0)
        assert ps.wire_bytes == P_comm.allreduce_wire_bytes(
            P_dist.sharded_combine_bytes(sl, RANK, 2), world) \
            == ps32.wire_bytes / 2
        assert rs.by_kind_wire["reduce-scatter"] == \
            P_dist.owner_scatter_wire_bytes(opart, RANK, itemsize=2) \
            == rs32.by_kind_wire["reduce-scatter"] / 2


@functools.lru_cache(maxsize=None)
def pi_layout(world: int) -> tuple:
    p = _pi_problem()
    t = sparse_tensor_from_numpy(p["shape"], p["indices"], p["values"],
                                 device="cpu")
    mv = sort_mode(t, 0)
    sl = shard_blocked_layout(build_blocked_layout(
        mv.rows.numpy(), mv.n_rows, PI_BN, PI_BR), world)
    return t.shape, sl, build_shard_pi_gather(sl, mv.sorted_idx, 0)


@pytest.mark.parametrize("world", WORLDS)
def test_pi_gather_bytes_within_bound(mesh_results, world):
    """On every rank, what the shard-local Π reads of the clustered
    tensor (its values slice, validity, local index maps and touched
    factor rows; no combine operand is among them) stays within
    ``pi_gather_wire_bound`` at the port's int64 index maps; the touched
    rows stay below the replicated factors, each mode's below its whole
    (I_m, R); the psum path issues exactly one all-reduce."""
    shape, sl, pig = pi_layout(world)
    slot = sl.n_grid_shard * sl.block_nnz
    for got in mesh_results(world):
        pg = got["pi_gather"]
        assert pg["values"] == slot * 4 and pg["valid"] == slot
        assert pg["index"] == [slot * 8.0] * (len(shape) - 1)
        measured = pg["values"] + pg["valid"] + sum(pg["index"]) \
            + sum(pg["touched"])
        assert measured <= P_comm.pi_gather_wire_bound(
            slot, pig.touched_rows_pad, RANK, len(shape), idx_itemsize=8)
        assert sum(pg["touched"]) == pig.gather_bytes(RANK) < \
            P_comm.pi_replicated_gather_bytes(shape, 0, RANK)
        for fg, m in zip(pg["touched"], pig.modes):
            assert fg < shape[m] * RANK * 4, m
        assert [(c.kind, c.tag) for c in pg["collectives"]] == [
            ("all-reduce", "data")]
