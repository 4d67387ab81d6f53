"""The port's fault-injection recovery matrix, against the JAX package.

Mirrors the rows of ``tests/test_faults.py``: every injected fault (NaN
factors, kernel failures, simulated OOM, stale shard assignments,
corrupted checkpoints, poisoned autotune entries) must still end in a
converged CP-APR solve whose factors meet the dense f64 KKT oracle, with
the recovery recorded in ``CPAPRResult.recoveries``; the sharded rows
(emulated shards) walk the multi-device rungs: the local ``cuda ->
blocked``, ``sharded -> segment``, shard halving on OOM down to the
single-device path, and the combine ``reduce_scatter -> psum``.  On an
unsharded mode the OOM and fingerprint faults have no rung and
propagate.  Then the checkpoint contract: a killed and resumed solve is
bitwise the uninterrupted one (``segment``, ``blocked``, ``dense``,
``cuda``'s plain version and a rebalanced ``sharded`` solve), a grid
checkpoint resumes, and a checkpoint, sharded ones with their rebalanced
cuts too, resumes across the two packages in both directions (grid ones:
``tests/test_torch_grid.py``).

Both packages get the same inputs: the reference's fixture tensor and
its seeded starting model, handed over as numpy arrays.
"""
import dataclasses
import functools
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import CPAPRConfig as RConfig
from repro.core import cpapr_mu as r_cpapr_mu
from repro.core.pi import pi_rows as r_pi_rows
from repro.core.policy import PhiPolicy as RPolicy
from repro.core.sparse_tensor import random_ktensor as r_random_ktensor
from repro.core.sparse_tensor import sort_mode as r_sort_mode

from repro_torch.core import cpals as P_cpals
from repro_torch.core import resilience
from repro_torch.core.convert import ktensor_from_numpy, sparse_tensor_from_numpy
from repro_torch.core.cpapr import CPAPRConfig, cpapr_mu
from repro_torch.core.policy import PhiPolicy
from repro_torch.core.sparse_tensor import sort_mode
from repro_torch.perf.autotune import Autotuner
from repro_torch.testing import faults

from conftest import dense_phi_reference
from test_conformance import TOL as PARITY_TOL
from test_conformance import make_fixture

import jax

RANK = 4
TOL = 5e-2  # loose outer tolerance: every matrix row must *converge*
SWEEPS = 60  # the clean fixture solve converges in ~35 sweeps at TOL
PB = PhiPolicy(strategy="blocked", block_nnz=64, block_rows=4)
PC = PhiPolicy(strategy="cuda", block_nnz=64, block_rows=4)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The solves here are thousands of small CPU ops: one intra-op thread
    keeps them from contending with the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def reference_problem():
    """The reference's fault fixture and its default starting model."""
    t, _ = make_fixture("uniform")
    kt = r_random_ktensor(jax.random.PRNGKey(0), t.shape, RANK)
    return t, kt


def port_problem():
    t, kt = reference_problem()
    pt = sparse_tensor_from_numpy(t.shape, np.asarray(t.indices),
                                  np.asarray(t.values), device="cpu")
    pkt = ktensor_from_numpy(np.asarray(kt.lam),
                             [np.asarray(f) for f in kt.factors], "cpu")
    return pt, pkt


def solve(cfg, **kw):
    pt, pkt = port_problem()
    return cpapr_mu(pt, RANK, init=pkt, config=cfg, device="cpu", **kw)


def dense_kkt(kt) -> float:
    """Worst per-mode KKT violation of a port KTensor, dense f64 oracle
    over the reference's fixture."""
    t, _ = reference_problem()
    factors = tuple(jnp.asarray(f.numpy()) for f in kt.factors)
    lam = jnp.asarray(kt.lam.numpy())
    worst = 0.0
    for n in range(t.ndim):
        mv = r_sort_mode(t, n)
        pi = r_pi_rows(mv.sorted_idx, factors, n)
        b = np.asarray(factors[n] * lam[None, :], np.float64)
        phi = dense_phi_reference(mv.rows, mv.sorted_vals, pi, b, mv.n_rows)
        worst = max(worst, float(np.max(np.abs(np.minimum(b, 1.0 - phi)))))
    return worst


# ---------------------------------------------------------------------------
# The fault x strategy registry (single device).  Each row: solver config,
# a fault context-manager factory, and the RecoveryEvent kind it records.
# ---------------------------------------------------------------------------

MATRIX = {
    "nan-segment": dict(
        cfg=dict(strategy="segment"),
        fault=lambda: faults.inject_nan(mode=1, outer=2),
        kind="nan_guard"),
    "nan-cuda": dict(
        cfg=dict(strategy="cuda", policy=PB),
        fault=lambda: faults.inject_nan(mode=0, outer=1),
        kind="nan_guard"),
    "nan-repeated": dict(
        # three consecutive hits on one mode: the kappa ladder must climb
        # past the plain-retry rung and still converge
        cfg=dict(strategy="segment"),
        fault=lambda: faults.inject_nan(mode=0, outer=None, times=3),
        kind="nan_guard"),
    "kernel-cuda": dict(
        cfg=dict(strategy="cuda", policy=PB),
        fault=lambda: faults.fail_strategy(strategy="cuda"),
        kind="demote_kernel"),
    "kernel-cuda-twice": dict(
        # cuda fails, then blocked fails too: two rungs down to segment
        cfg=dict(strategy="cuda", policy=PB),
        fault=lambda: _chain(faults.fail_strategy(strategy="cuda", mode=2),
                             faults.fail_strategy(strategy="blocked", mode=2)),
        kind="demote_kernel"),
    "kernel-dense": dict(
        cfg=dict(strategy="dense"),
        fault=lambda: faults.fail_strategy(strategy="dense", mode=1),
        kind="demote_kernel"),
    "nan-sharded-rs": dict(
        cfg=dict(strategy="sharded", n_shards=2, combine="reduce_scatter",
                 policy=PB),
        fault=lambda: faults.inject_nan(mode=0, outer=1),
        kind="nan_guard"),
    "kernel-sharded-local-cuda": dict(
        cfg=dict(strategy="sharded", n_shards=2, policy=PC),
        fault=lambda: faults.fail_strategy(strategy="sharded"),
        kind="demote_kernel"),
    "kernel-sharded-to-segment": dict(
        cfg=dict(strategy="sharded", n_shards=2, policy=PB),
        fault=lambda: faults.fail_strategy(strategy="sharded", mode=1),
        kind="demote_kernel"),
    "oom-sharded": dict(
        cfg=dict(strategy="sharded", n_shards=4, policy=PB),
        fault=lambda: faults.fail_oom(min_shards=3),
        kind="demote_oom"),
    "oom-to-single-device": dict(
        # unbounded OOM: the ladder must walk 4 -> 2 -> single-device
        cfg=dict(strategy="sharded", n_shards=4, policy=PB),
        fault=lambda: faults.fail_oom(min_shards=2),
        kind="demote_oom"),
    "fingerprint-rs": dict(
        cfg=dict(strategy="sharded", n_shards=2, combine="reduce_scatter",
                 policy=PB),
        fault=lambda: faults.fail_fingerprint(),
        kind="demote_fingerprint"),
}


class _chain:
    """Enter several fault context managers as one."""

    def __init__(self, *cms):
        self.cms = cms

    def __enter__(self):
        return [cm.__enter__() for cm in self.cms]

    def __exit__(self, *exc):
        for cm in reversed(self.cms):
            cm.__exit__(*exc)
        return False


@pytest.mark.parametrize("name", sorted(MATRIX))
def test_fault_matrix_converges_to_oracle(name):
    row = MATRIX[name]
    cfg = CPAPRConfig(rank=RANK, max_outer=SWEEPS, tol=TOL, max_demotions=4,
                      **row["cfg"])
    with row["fault"]():
        res = solve(cfg)
    assert res.converged, (name, res.kkt_history[-5:])
    kinds = [e.kind for e in (res.recoveries or [])]
    assert row["kind"] in kinds, (name, kinds)
    # f32 strategies stop at the first sweep whose f32 KKT <= TOL; the f64
    # oracle on the same factors can sit slightly above it
    assert dense_kkt(res.ktensor) <= TOL * 1.5, name
    assert all(np.isfinite(res.loglik_history))


def test_demotion_walks_the_ladder_and_records_each_rung():
    cfg = CPAPRConfig(rank=RANK, max_outer=3, strategy="cuda", policy=PB,
                      max_demotions=4)
    with faults.fail_strategy(strategy="cuda", mode=2), \
            faults.fail_strategy(strategy="blocked", mode=2):
        res = solve(cfg)
    demotions = [(e.kind, e.mode, e.attempt, e.detail["action"])
                 for e in res.recoveries]
    assert demotions == [("demote_kernel", 2, 0, "cuda->blocked"),
                         ("demote_kernel", 2, 1, "blocked->segment")]
    assert "simulated kernel" in res.recoveries[0].detail["error"]


class _stale_assignment:
    """A shard-assignment fault on any mode (``fail_fingerprint`` fires on
    sharded modes only)."""

    def _hook(self, ctx):
        raise resilience.ShardAssignmentError(
            "owner partition was built from a different shard assignment "
            "(simulated)")

    def __enter__(self):
        resilience.register_mode_hook(self._hook)

    def __exit__(self, *exc):
        resilience.unregister_mode_hook(self._hook)
        return False


@pytest.mark.parametrize("fault,match", [
    (lambda: faults.fail_oom(min_shards=1), "RESOURCE_EXHAUSTED"),
    (lambda: _stale_assignment(), "shard assignment"),
])
def test_multi_device_faults_propagate_on_one_device(fault, match):
    """OOM and fingerprint faults classify as in the JAX package, but a
    single-device mode has no rung for them: they reach the caller
    instead of being demoted into something else."""
    with pytest.raises(Exception, match=match):
        with fault():
            solve(CPAPRConfig(rank=RANK, max_outer=2, strategy="cuda",
                              policy=PB, max_demotions=4))


def test_sharded_rungs_record_their_actions():
    """The multi-device rungs name what they did: the local kernel
    demotion, shard halving then the single-device path on repeated OOM,
    and the combine demotion on a stale assignment."""
    def actions(cfg, *cms):
        with _chain(*cms):
            res = solve(CPAPRConfig(rank=RANK, max_outer=2, max_demotions=4,
                                    **cfg))
        return [(e.kind, e.mode, e.detail["action"])
                for e in res.recoveries]

    assert actions(dict(strategy="sharded", n_shards=2, policy=PC),
                   faults.fail_strategy(strategy="cuda", mode=0),
                   faults.fail_strategy(strategy="blocked", mode=0)) == [
        ("demote_kernel", 0, "local cuda->blocked"),
        ("demote_kernel", 0, "sharded->segment")]
    assert actions(dict(strategy="sharded", n_shards=4, policy=PB),
                   faults.fail_oom(mode=2, min_shards=2)) == [
        ("demote_oom", 2, "shards 4->2"),
        ("demote_oom", 2, "sharded@2->single-device blocked")]
    assert actions(dict(strategy="sharded", n_shards=2, policy=PB,
                        combine="reduce_scatter"),
                   faults.fail_fingerprint(mode=1)) == [
        ("demote_fingerprint", 1, "combine reduce_scatter->psum")]


def test_max_demotions_bounds_the_ladder():
    cfg = CPAPRConfig(rank=RANK, max_outer=2, strategy="cuda", policy=PB,
                      max_demotions=1)
    with pytest.raises(RuntimeError, match="simulated kernel"):
        with faults.fail_strategy(strategy="cuda", mode=0), \
                faults.fail_strategy(strategy="blocked", mode=0):
            solve(cfg)


@pytest.mark.parametrize("solver", ("cpapr", "cp_als"))
@pytest.mark.parametrize("strategy", ("cuda", "dense"))
def test_ladder_is_off_by_default(solver, strategy):
    """Without ``max_demotions`` (``cpapr_mu``) or a ``recoveries`` list
    (``cp_als``) a kernel failure reaches the caller: a failing kernel is
    never replaced unseen by its plain version."""
    pt, pkt = port_problem()
    with pytest.raises(RuntimeError, match="simulated kernel"):
        with faults.fail_strategy(strategy=strategy):
            if solver == "cpapr":
                solve(CPAPRConfig(rank=RANK, max_outer=2, strategy=strategy))
            else:
                P_cpals.cp_als(pt, RANK, n_iters=2, init=pkt,
                               strategy=strategy, device="cpu")


def test_poisoned_autotune_raises_without_the_ladder(tmp_path):
    pt, _ = port_problem()
    tuner = Autotuner(cache_path=str(tmp_path / "cache.json"), measure=False)
    faults.poison_autotune(tuner, sort_mode(pt, 0), RANK,
                           strategy="warpspeed", shape=pt.shape)
    with pytest.raises(ValueError, match="unknown strategy"):
        solve(CPAPRConfig(rank=RANK, max_outer=2, policy="auto",
                          autotuner=tuner))


def test_unclassifiable_fault_propagates():
    with pytest.raises(faults.KilledError):
        with faults.kill_at_sweep(2):
            solve(CPAPRConfig(rank=RANK, max_outer=5, strategy="segment"))


def test_guard_exhaustion_raises():
    cfg = CPAPRConfig(rank=RANK, max_outer=5, strategy="segment",
                      guard_retries=2)
    with pytest.raises(FloatingPointError, match=r"mode\(s\) \[0\]"):
        with faults.inject_nan(mode=0, outer=None, times=None):
            solve(cfg)


def test_guard_off_lets_nan_through():
    cfg = CPAPRConfig(rank=RANK, max_outer=3, strategy="segment",
                      guard=False, track_loglik=False)
    with faults.inject_nan(mode=0, outer=1):
        res = solve(cfg)
    assert not bool(torch.isfinite(res.ktensor.factors[0]).all())
    assert res.recoveries is None


def test_inject_nan_leaves_the_solvers_tensor_untouched():
    a = torch.ones(3, 2)
    with faults.inject_nan(mode=0) as budget:
        out, _ = resilience.apply_post_update_hooks(
            {"mode": 0, "outer": 1}, a, torch.ones(2))
    assert budget == [0] and torch.isnan(out[0, 0]) and bool((a == 1).all())


# ---------------------------------------------------------------------------
# Checkpoint / resume
# ---------------------------------------------------------------------------


def _ck_cfg(ck, **kw):
    base = dict(rank=RANK, max_outer=6, tol=0.0, strategy="segment",
                checkpoint_every=2, checkpoint_path=ck)
    base.update(kw)
    return CPAPRConfig(**base)


def _bits(x: torch.Tensor) -> np.ndarray:
    return x.view(torch.int16 if x.element_size() == 2 else torch.int32).numpy()


def _assert_bitwise(ref, res):
    assert res.n_outer == ref.n_outer
    for a, b in zip(ref.ktensor.factors, res.ktensor.factors):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    np.testing.assert_array_equal(_bits(ref.ktensor.lam),
                                  _bits(res.ktensor.lam))
    assert ref.kkt_history == res.kkt_history
    assert ref.loglik_history == res.loglik_history
    assert ref.inner_iters == res.inner_iters


@pytest.mark.parametrize("tier", [
    dict(strategy="segment"),
    dict(strategy="blocked", policy=PB),
    dict(strategy="cuda", policy=PB),
    dict(strategy="dense"),
    dict(strategy="sharded", n_shards=2, combine="reduce_scatter",
         policy=PB, rebalance_every=2),
], ids=("segment", "blocked", "cuda", "dense", "sharded"))
def test_kill_and_resume_is_bitwise(tmp_path, tier):
    """Kill at sweep 5, resume from the sweep-4 checkpoint: factors,
    lambda and every history bitwise the uninterrupted run's."""
    ck = str(tmp_path / "ck.bin")
    ref = solve(_ck_cfg(None, checkpoint_every=0, **tier))
    with pytest.raises(faults.KilledError):
        with faults.kill_at_sweep(5):
            solve(_ck_cfg(ck, **tier))
    res = solve(_ck_cfg(ck, **tier), resume_from=ck)
    _assert_bitwise(ref, res)
    assert [e.kind for e in res.recoveries] == ["resume"]
    assert len(res.sweep_seconds) == ref.n_outer - 4


@pytest.mark.parametrize("tier", [
    dict(strategy="segment"),
    dict(strategy="blocked", policy=PB),
    dict(strategy="cuda", policy=PB),
    dict(strategy="dense"),
], ids=("segment", "blocked", "cuda", "dense"))
def test_bf16_kill_and_resume_is_bitwise(tmp_path, monkeypatch, tier):
    """The same contract with bf16 values and factors: the checkpoint
    keeps their bits without ``ml_dtypes``."""
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    pt, pkt = port_problem()
    pt = dataclasses.replace(pt, values=pt.values.to(torch.bfloat16))
    pkt = type(pkt)(lam=pkt.lam.to(torch.bfloat16),
                    factors=tuple(f.to(torch.bfloat16) for f in pkt.factors))
    ck = str(tmp_path / "ck.bin")

    def run(cfg, **kw):
        return cpapr_mu(pt, RANK, init=pkt, config=cfg, device="cpu", **kw)

    ref = run(_ck_cfg(None, checkpoint_every=0, **tier))
    with pytest.raises(faults.KilledError):
        with faults.kill_at_sweep(5):
            run(_ck_cfg(ck, **tier))
    res = run(_ck_cfg(ck, **tier), resume_from=ck)
    assert {f.dtype for f in res.ktensor.factors} == {torch.bfloat16}
    _assert_bitwise(ref, res)
    assert [e.kind for e in res.recoveries] == ["resume"]


@pytest.mark.parametrize("kind", ["flip", "truncate", "magic"])
def test_corrupt_checkpoint_quarantined_and_solve_restarts(tmp_path, kind):
    ck = str(tmp_path / "ck.bin")
    cfg = _ck_cfg(ck, max_outer=4)
    solve(cfg)
    faults.corrupt_checkpoint(ck, kind=kind)
    res = solve(cfg, resume_from=ck)
    kinds = [e.kind for e in res.recoveries]
    assert kinds[0] == "checkpoint_corrupt" and "resume" not in kinds
    assert os.path.exists(ck + ".corrupt")
    assert os.path.exists(ck)  # the fresh start wrote new checkpoints
    ref = solve(_ck_cfg(None, max_outer=4, checkpoint_every=0))
    assert ref.kkt_history == res.kkt_history


def test_fingerprint_mismatch_rejected(tmp_path):
    ck = str(tmp_path / "ck.bin")
    solve(_ck_cfg(ck, max_outer=4))
    other = CPAPRConfig(rank=RANK, max_outer=4, tol=1e-9,  # different tol
                        strategy="segment")
    res = solve(other, resume_from=ck)
    assert [e.kind for e in res.recoveries] == ["checkpoint_corrupt"]
    assert "fingerprint" in res.recoveries[0].detail["error"]


def test_sharded_checkpoint_raises_and_is_not_quarantined(tmp_path):
    """A sound checkpoint of grid-sharded modes resumes now that the N-D
    grid tier is ported: it is not quarantined, its ``mode_grids`` rebuild
    each mode's cell schedule, and the resumed solve ends where the
    uninterrupted one does.  (Row-sharded checkpoints:
    ``test_kill_and_resume_is_bitwise`` and the cross-package tests.)"""
    ck = str(tmp_path / "ck.bin")
    grid = dict(strategy="grid", n_shards=4, grid_shape=(2, 2), policy=PB)
    ref = solve(_ck_cfg(None, checkpoint_every=0, **grid))
    solve(_ck_cfg(ck, max_outer=2, **grid))
    state = resilience.load_checkpoint(ck)
    assert state["mode_grids"] == [[2, 2]] * 3
    assert state["mode_shards"] == [2] * 3
    res = solve(_ck_cfg(ck, **grid), resume_from=ck)
    assert [e.kind for e in res.recoveries] == ["resume"]
    assert os.path.exists(ck) and not os.path.exists(ck + ".corrupt")
    _assert_bitwise(ref, res)


def test_resume_after_fault_preserves_recovery_log(tmp_path):
    """Recoveries taken before the kill survive the checkpoint, and the
    demoted strategy is resumed, not the configured one."""
    ck = str(tmp_path / "ck.bin")
    cfg = _ck_cfg(ck, strategy="cuda", policy=PB, max_demotions=4)
    with pytest.raises(faults.KilledError):
        with faults.fail_strategy(strategy="cuda", mode=1), \
                faults.kill_at_sweep(5):
            solve(cfg)
    assert resilience.load_checkpoint(ck)["strategies"] == [
        "pallas", "blocked", "pallas"]
    res = solve(cfg, resume_from=ck)
    kinds = [e.kind for e in res.recoveries]
    assert kinds == ["demote_kernel", "resume"]


# ---------------------------------------------------------------------------
# Checkpoints across the two packages
# ---------------------------------------------------------------------------

# name -> (strategy, port policy, options both packages take)
SHARDED_KW = dict(n_shards=2, combine="reduce_scatter", rebalance_every=2)
CROSS = {"segment": ("segment", None, {}), "blocked": ("blocked", PB, {}),
         "sharded": ("sharded", PB, SHARDED_KW)}


def _rcfg(strategy, ck, **kw):
    pol = None if strategy == "segment" else RPolicy(
        strategy="blocked", block_nnz=PB.block_nnz, block_rows=PB.block_rows)
    base = dict(rank=RANK, max_outer=6, tol=0.0, strategy=strategy,
                policy=pol, checkpoint_every=2, checkpoint_path=ck)
    base.update(kw)
    return RConfig(**base)


def _close_to(res, want):
    np.testing.assert_allclose(res.loglik_history, want.loglik_history,
                               **PARITY_TOL)
    assert list(res.inner_iters) == list(want.inner_iters)
    for a, b in zip(res.ktensor.factors, want.ktensor.factors):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **PARITY_TOL)


@pytest.mark.parametrize("name", sorted(CROSS))
def test_reference_checkpoint_resumes_in_the_port(tmp_path, name):
    strategy, pol, kw = CROSS[name]
    t, kt = reference_problem()
    ck = str(tmp_path / "ck.bin")
    want = r_cpapr_mu(t, RANK, init=kt,
                      config=_rcfg(strategy, None, checkpoint_every=0, **kw))
    r_cpapr_mu(t, RANK, init=kt, config=_rcfg(strategy, ck, max_outer=4,
                                              **kw))
    res = solve(_ck_cfg(ck, strategy=strategy, policy=pol, **kw),
                resume_from=ck)
    assert [e.kind for e in res.recoveries] == ["resume"]
    assert res.n_outer == want.n_outer
    _close_to(res, want)


@pytest.mark.parametrize("name", sorted(CROSS))
def test_port_checkpoint_resumes_in_the_reference(tmp_path, name):
    strategy, pol, kw = CROSS[name]
    t, kt = reference_problem()
    ck = str(tmp_path / "ck.bin")
    want = solve(_ck_cfg(None, strategy=strategy, policy=pol,
                         checkpoint_every=0, **kw))
    solve(_ck_cfg(ck, strategy=strategy, policy=pol, max_outer=4, **kw))
    res = r_cpapr_mu(t, RANK, init=kt, config=_rcfg(strategy, ck, **kw),
                     resume_from=ck)
    assert [e.kind for e in res.recoveries] == ["resume"]
    assert res.n_outer == want.n_outer
    _close_to(res, want)


def test_cuda_checkpoint_resumes_in_the_reference_as_pallas(tmp_path):
    """``cuda`` is stored and fingerprinted as ``pallas``: the reference
    accepts the port's checkpoint, and the port reads ``pallas`` back as
    ``cuda``."""
    ck = str(tmp_path / "ck.bin")
    pc = PhiPolicy(strategy="cuda", block_nnz=64, block_rows=4)
    solve(_ck_cfg(ck, strategy="cuda", policy=pc, max_outer=2))
    state = resilience.load_checkpoint(ck)
    assert state["strategies"] == ["pallas"] * 3
    assert {p["strategy"] for p in state["policies"]} == {"pallas"}
    from repro.core.cpapr import _ckpt_fingerprint as r_fingerprint

    t, _ = reference_problem()
    rpol = RPolicy(strategy="pallas", block_nnz=PB.block_nnz,
                   block_rows=PB.block_rows)
    assert state["fingerprint"] == r_fingerprint(t, RConfig(
        rank=RANK, max_outer=6, tol=0.0, strategy="pallas", policy=rpol))
    res = solve(_ck_cfg(ck, strategy="cuda", policy=pc, max_outer=3),
                resume_from=ck)
    assert [e.kind for e in res.recoveries] == ["resume"]
    assert res.policies == [pc] * 3


# ---------------------------------------------------------------------------
# Poisoned autotune cache
# ---------------------------------------------------------------------------


def test_poisoned_autotune_demotes_and_converges(tmp_path):
    pt, _ = port_problem()
    tuner = Autotuner(cache_path=str(tmp_path / "cache.json"), measure=False)
    faults.poison_autotune(tuner, sort_mode(pt, 0), RANK,
                           strategy="warpspeed", shape=pt.shape)
    res = solve(CPAPRConfig(rank=RANK, max_outer=SWEEPS, tol=TOL,
                            policy="auto", autotuner=tuner,
                            max_demotions=4))
    assert res.converged
    demotes = [e for e in res.recoveries if e.kind == "demote_policy"]
    assert [(e.mode, e.detail["action"]) for e in demotes] == [
        (0, "warpspeed->segment")]
    assert dense_kkt(res.ktensor) <= TOL * 1.5


# ---------------------------------------------------------------------------
# CP-ALS rides the same ladder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("strategy", ("cuda", "dense"))
def test_cpals_kernel_fault_demotes_and_matches(strategy):
    pt, pkt = port_problem()
    _, clean = P_cpals.cp_als(pt, RANK, n_iters=5, init=pkt,
                              strategy="segment", device="cpu")
    recs = []
    with faults.fail_strategy(strategy=strategy) as budget:
        _, fits = P_cpals.cp_als(pt, RANK, n_iters=5, init=pkt,
                                 strategy=strategy, policy=None,
                                 recoveries=recs, device="cpu")
    assert budget == [0]
    assert [(e.kind, e.detail["action"]) for e in recs] == [
        ("demote_kernel", f"{strategy}->segment")]
    assert abs(fits[-1] - clean[-1]) < 1e-3


def test_cpals_unclassifiable_fault_propagates():
    pt, pkt = port_problem()
    with pytest.raises(faults.KilledError):
        with faults.kill_at_sweep(2):
            P_cpals.cp_als(pt, RANK, n_iters=3, init=pkt, strategy="cuda",
                           recoveries=[], device="cpu")



@pytest.mark.parametrize("solver", ("cpapr", "cp_als"))
def test_dense_demotion_drops_the_streams_workspaces(solver):
    """Demoting a dense mode forgets the dense workspaces of the current
    stream (their tickets may be dirty), and only those."""
    from repro_torch.kernels.dense import kernel as dense_kernel

    mine = (torch.device("cpu"), 0, 1, 1)
    other = (torch.device("cpu"), 99, 1, 1)  # another stream's
    for key in (mine, other):
        dense_kernel._WORK[key] = (torch.empty(1),
                                   torch.ones(1, dtype=torch.int32))
    try:
        with faults.fail_strategy(strategy="dense", mode=1) as budget:
            if solver == "cpapr":
                solve(CPAPRConfig(rank=RANK, max_outer=1, strategy="dense",
                                  max_demotions=4))
            else:
                pt, pkt = port_problem()
                P_cpals.cp_als(pt, RANK, n_iters=1, init=pkt,
                               strategy="dense", recoveries=[], device="cpu")
        assert budget == [0]
        assert mine not in dense_kernel._WORK and other in dense_kernel._WORK
    finally:
        for key in (mine, other):
            dense_kernel._WORK.pop(key, None)
