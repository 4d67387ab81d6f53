"""The port's CP-APR MU solve against the JAX package, and its contracts.

Both packages start from the same ``init`` (the conformance fixtures'
KTensor, handed over as numpy arrays) with the same blocking, and run
``max_outer`` = 4 sweeps.  The KKT and log-likelihood histories and the
final model must agree within ``TOL`` and the inner-iteration counts must
be equal, for the port's ``cuda`` (its plain version on the CPU),
``blocked`` and ``segment`` against the reference's ``pallas``,
``blocked`` and ``segment``.

Also: import hygiene (``repro_torch`` loads neither ``jax`` nor
``repro``), the device default (no CUDA and no ``device="cpu"`` raises),
the multi-device options (row-sharded and grid) running under an armed
degradation ladder with checkpoints, the checkpoint, resume and ``policy="auto"`` options running, input
validation and the guard; and C1, mixed bf16 factors with f32 values,
end to end against the reference.
"""
import dataclasses
import functools
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import cpapr as R_cpapr
from repro.core import resilience as R_res
from repro.core.policy import PhiPolicy as RPolicy

from repro_torch.core import cpapr as P_cpapr
from repro_torch.core import resilience as P_res
from repro_torch.core.convert import (
    ktensor_from_numpy,
    policy_from_dict,
    sparse_tensor_from_numpy,
)
from repro_torch.core.policy import PhiPolicy as PPolicy

from test_conformance import BN, BR, FIXTURES, RANK, TOL, make_fixture

REPO = pathlib.Path(__file__).resolve().parents[1]
PAIRS = {"cuda": "pallas", "blocked": "blocked", "segment": "segment"}
MAX_OUTER = 4


def port_problem(kind: str):
    t, kt = make_fixture(kind)
    pt = sparse_tensor_from_numpy(t.shape, np.asarray(t.indices),
                                  np.asarray(t.values), device="cpu")
    pkt = ktensor_from_numpy(np.asarray(kt.lam),
                             [np.asarray(f) for f in kt.factors], "cpu")
    return pt, pkt


@functools.lru_cache(maxsize=None)
def reference_solve(kind: str, strategy: str):
    t, kt = make_fixture(kind)
    cfg = R_cpapr.CPAPRConfig(rank=RANK, max_outer=MAX_OUTER,
                              strategy=strategy,
                              policy=RPolicy(block_nnz=BN, block_rows=BR))
    return R_cpapr.cpapr_mu(t, RANK, init=kt, config=cfg)


@pytest.mark.parametrize("strategy", tuple(PAIRS))
@pytest.mark.parametrize("kind", FIXTURES)
def test_cpapr_matches_reference(kind, strategy):
    want = reference_solve(kind, PAIRS[strategy])
    pt, pkt = port_problem(kind)
    cfg = P_cpapr.CPAPRConfig(rank=RANK, max_outer=MAX_OUTER,
                              strategy=strategy,
                              policy=PPolicy(block_nnz=BN, block_rows=BR))
    got = P_cpapr.cpapr_mu(pt, RANK, init=pkt, config=cfg, device="cpu")
    assert got.inner_iters == want.inner_iters
    assert got.n_outer == want.n_outer
    assert got.converged == want.converged
    np.testing.assert_allclose(got.kkt_history, want.kkt_history, **TOL)
    np.testing.assert_allclose(got.loglik_history, want.loglik_history,
                               **TOL)
    np.testing.assert_allclose(got.ktensor.lam.numpy(),
                               np.asarray(want.ktensor.lam), **TOL)
    for gf, wf in zip(got.ktensor.factors, want.ktensor.factors):
        np.testing.assert_allclose(gf.numpy(), np.asarray(wf), **TOL)
    assert got.recoveries is None
    assert len(got.sweep_seconds) == got.n_outer
    ll = got.loglik_history
    assert all(b >= a - 1e-6 * abs(a) for a, b in zip(ll, ll[1:]))


@pytest.mark.parametrize("kind", FIXTURES)
def test_dense_oracles_match_reference(kind):
    from repro.core import sparse_tensor as R_st
    from repro_torch.core import sparse_tensor as P_st

    t, kt = make_fixture(kind)
    pt, pkt = port_problem(kind)
    np.testing.assert_array_equal(P_st.dense_from_coo(pt).numpy(),
                                  np.asarray(R_st.dense_from_coo(t)))
    np.testing.assert_allclose(P_st.ktensor_full(pkt).numpy(),
                               np.asarray(R_st.ktensor_full(kt)), **TOL)
    np.testing.assert_allclose(
        P_st.model_values_at(pkt, pt.indices).numpy(),
        np.asarray(R_st.model_values_at(kt, t.indices)), **TOL)
    np.testing.assert_allclose(pkt.normalize().lam.numpy(),
                               np.asarray(kt.normalize().lam), **TOL)


@pytest.mark.parametrize("kind", FIXTURES)
def test_loglik_and_kkt_match_reference(kind):
    t, kt = make_fixture(kind)
    pt, pkt = port_problem(kind)
    want = float(R_cpapr.poisson_loglik(t, kt.normalize()))
    got = float(P_cpapr.poisson_loglik(pt, pkt.normalize()))
    np.testing.assert_allclose(got, want, **TOL)
    b = kt.factors[0] * kt.lam[None, :]
    phi = kt.factors[0] * 2.0
    np.testing.assert_allclose(
        float(P_cpapr.kkt_violation(torch.as_tensor(np.array(b)),
                                    torch.as_tensor(np.array(phi)))),
        float(R_cpapr.kkt_violation(b, phi)), **TOL)


def test_zero_inner_iterations_report_infinite_kkt():
    """As in the reference, no inner iteration leaves viol at inf: the
    guard counts that as a failed sweep, an unguarded solve reports it."""
    pt, pkt = port_problem("uniform")
    cfg = P_cpapr.CPAPRConfig(rank=RANK, max_outer=1, max_inner=0)
    with pytest.raises(FloatingPointError, match="guarded sweep"):
        P_cpapr.cpapr_mu(pt, RANK, init=pkt, config=cfg, device="cpu")
    cfg = P_cpapr.CPAPRConfig(rank=RANK, max_outer=1, max_inner=0,
                              guard=False)
    res = P_cpapr.cpapr_mu(pt, RANK, init=pkt, config=cfg, device="cpu")
    assert res.inner_iters == [0] and res.kkt_history == [float("inf")]


def test_seeded_init_is_deterministic():
    pt, _ = port_problem("hub")
    cfg = P_cpapr.CPAPRConfig(rank=RANK, max_outer=2)
    a = P_cpapr.cpapr_mu(pt, RANK, seed=5, config=cfg, device="cpu")
    b = P_cpapr.cpapr_mu(pt, RANK, seed=5, config=cfg, device="cpu")
    assert a.loglik_history == b.loglik_history


def test_cuda_strategy_raises_on_f64():
    pt, pkt = port_problem("uniform")
    pkt64 = ktensor_from_numpy(pkt.lam.double().numpy(),
                               [f.double().numpy() for f in pkt.factors],
                               "cpu")
    cfg = P_cpapr.CPAPRConfig(rank=RANK, max_outer=1, strategy="cuda")
    with pytest.raises(ValueError, match="float64"):
        P_cpapr.cpapr_mu(pt, RANK, init=pkt64, config=cfg, device="cpu")


@pytest.mark.parametrize("strategy", ("scatter", "segment", "blocked"))
@pytest.mark.parametrize("kind", FIXTURES)
def test_mixed_bf16_factors_solve_like_reference(kind, strategy):
    """C1 end to end: the fixture's starting factors in bf16 with f32 λ
    and values.  The reference runs 4 sweeps of 30 inner iterations and
    returns f32 factors; so must the port, within TOL_BF16."""
    import jax.numpy as jnp

    from repro.core.sparse_tensor import KTensor as RKTensor

    from test_conformance import TOL_BF16

    t, kt = make_fixture(kind)
    rkt = RKTensor(lam=kt.lam, factors=tuple(f.astype(jnp.bfloat16)
                                             for f in kt.factors))
    pol = dict(block_nnz=BN, block_rows=BR)
    want = R_cpapr.cpapr_mu(t, RANK, init=rkt, config=R_cpapr.CPAPRConfig(
        rank=RANK, max_outer=MAX_OUTER, strategy=strategy,
        policy=RPolicy(**pol)))
    pt, pkt = port_problem(kind)
    pkt = type(pkt)(lam=pkt.lam, factors=tuple(f.to(torch.bfloat16)
                                               for f in pkt.factors))
    got = P_cpapr.cpapr_mu(pt, RANK, init=pkt, device="cpu",
                           config=P_cpapr.CPAPRConfig(
                               rank=RANK, max_outer=MAX_OUTER,
                               strategy=strategy, policy=PPolicy(**pol)))
    assert got.inner_iters == want.inner_iters == [30] * MAX_OUTER
    assert got.recoveries is None
    for gf, wf in zip(got.ktensor.factors, want.ktensor.factors):
        assert gf.dtype == torch.float32 and str(wf.dtype) == "float32"
        np.testing.assert_allclose(gf.numpy(), np.asarray(wf), **TOL_BF16)
    np.testing.assert_allclose(got.loglik_history, want.loglik_history,
                               **TOL_BF16)


@pytest.mark.parametrize("field,value", [
    ("mesh", object()), ("n_shards", 2), ("grid_shape", (2, 2)),
    ("rebalance_every", 1),
])
def test_unported_options_raise(field, value):
    """The multi-device options are all ported now, the grid's too, and,
    as in the JAX package, act only with their strategy (``sharded`` or
    ``grid``): on the default strategy the solve is the plain one."""
    pt, pkt = port_problem("uniform")
    cfg = P_cpapr.CPAPRConfig(rank=RANK, max_outer=1, **{field: value})
    got = P_cpapr.cpapr_mu(pt, RANK, init=pkt, config=cfg, device="cpu")
    plain = P_cpapr.cpapr_mu(pt, RANK, init=pkt, device="cpu",
                             config=P_cpapr.CPAPRConfig(rank=RANK,
                                                        max_outer=1))
    assert got.kkt_history == plain.kkt_history
    assert got.rebalances is None


@pytest.mark.parametrize("field,value", [
    ("n_shards", 2), ("rebalance_every", 1), ("strategy", "sharded"),
    ("strategy", "grid"),
])
def test_multi_device_options_raise_before_the_ladder(tmp_path, field,
                                                     value):
    """The multi-device options, the grid's too, run under an armed ladder
    and write their checkpoints; a grid checkpoint records each mode's
    grid (a 1 x 1 grid at the CPU's one default shard).  An option that
    is still not ported (ROADMAP A11) is never demoted into a run: its
    error is unclassified."""
    from repro_torch.core import resilience

    pt, pkt = port_problem("uniform")
    ck = tmp_path / "never.ckpt"
    cfg = P_cpapr.CPAPRConfig(rank=RANK, max_outer=2, checkpoint_every=1,
                              checkpoint_path=str(ck), max_demotions=4,
                              **{field: value})
    res = P_cpapr.cpapr_mu(pt, RANK, init=pkt, config=cfg, device="cpu")
    assert res.n_outer == 2 and ck.exists() and res.recoveries is None
    state = resilience.load_checkpoint(str(ck))
    if value == "grid":
        assert state["strategies"] == ["grid"] * 3
        assert state["mode_grids"] == [[1, 1]] * 3
    else:
        assert state["mode_grids"] == [None] * 3
    assert resilience.classify_failure(
        resilience.NotPortedError("ROADMAP A11")) is None


@pytest.mark.parametrize("case", ("checkpoint", "resume", "auto"))
def test_checkpoint_resume_and_auto_run(tmp_path, case):
    """The options that raised "not ported" before the fault-tolerant
    runtime and the autotuner existed now run: a checkpointing solve
    writes a checkpoint the JAX package's loader accepts, ``resume_from``
    continues it, and ``policy="auto"`` tunes every mode."""
    from repro_torch.perf.autotune import Autotuner

    pt, pkt = port_problem("uniform")
    ck = str(tmp_path / "ck.bin")
    cfg = P_cpapr.CPAPRConfig(rank=RANK, max_outer=2, checkpoint_every=1,
                              checkpoint_path=ck)
    if case == "auto":
        tuner = Autotuner(cache_path=str(tmp_path / "c.json"), measure=False)
        res = P_cpapr.cpapr_mu(pt, RANK, init=pkt, device="cpu",
                               config=P_cpapr.CPAPRConfig(
                                   rank=RANK, max_outer=2, policy="auto",
                                   autotuner=tuner))
        assert len(res.policies) == 3 and tuner.n_searches == 3
        return
    res = P_cpapr.cpapr_mu(pt, RANK, init=pkt, config=cfg, device="cpu")
    assert R_res.load_checkpoint(ck)["outer"] == res.n_outer == 2
    if case == "resume":
        more = dataclasses.replace(cfg, max_outer=3)
        res2 = P_cpapr.cpapr_mu(pt, RANK, init=pkt, config=more,
                                resume_from=ck, device="cpu")
        assert res2.n_outer == 3 and len(res2.sweep_seconds) == 1
        assert [e.kind for e in res2.recoveries] == ["resume"]


@pytest.mark.parametrize("bad", ("index", "negative", "nan", "rank"))
def test_invalid_inputs_raise_like_reference(bad):
    t, _ = make_fixture("uniform")
    idx = np.array(t.indices)
    vals = np.array(t.values)
    rank = RANK
    if bad == "index":
        idx[3, 1] = t.shape[1]
    elif bad == "negative":
        vals[5] = -1.0
    elif bad == "nan":
        vals[2] = np.nan
    else:
        rank = 0
    pt = sparse_tensor_from_numpy(t.shape, idx, vals, "cpu")
    with pytest.raises(ValueError) as got:
        P_res.validate_decomposition_inputs(pt, rank)

    class _T:  # the reference's check reads shape/indices/values only
        shape, indices, values = t.shape, idx, vals
    with pytest.raises(ValueError) as want:
        R_res.validate_decomposition_inputs(_T, rank)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("case", ("ok", "nan", "negative", "inf_lam"))
def test_guard_matches_reference(case):
    a = np.abs(np.random.RandomState(0).randn(6, 3)).astype(np.float32)
    lam = np.ones(3, np.float32)
    if case == "nan":
        a[1, 1] = np.nan
    elif case == "negative":
        a[2, 0] = -1e-3
    elif case == "inf_lam":
        lam[0] = np.inf
    assert P_res.state_ok(a, lam) == R_res.state_ok(a, lam)
    assert bool(P_res.guard_ok(torch.as_tensor(a), torch.as_tensor(lam))) == \
        (case == "ok")


def test_policy_from_dict_reads_pallas_as_cuda():
    import dataclasses

    d = dataclasses.asdict(RPolicy(strategy="pallas", block_nnz=64,
                                   block_rows=4))
    pol = policy_from_dict(d)
    assert pol == PPolicy(strategy="cuda", block_nnz=64, block_rows=4)
    cfg = P_cpapr.CPAPRConfig(rank=RANK, max_outer=1, strategy="pallas",
                              policy=pol)
    pt, pkt = port_problem("uniform")
    res = P_cpapr.cpapr_mu(pt, RANK, init=pkt, config=cfg, device="cpu")
    assert res.policies == [pol] * 3


def test_import_hygiene():
    """Importing the whole port loads neither jax nor the JAX package."""
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.core, repro_torch.core.convert\n"
        "import repro_torch.kernels.phi.ops, repro_torch.kernels.phi.kernel\n"
        "import repro_torch.kernels._build, repro_torch.data.tensors\n"
        "import repro_torch.perf.timing, repro_torch.perf.trace\n"
        "import repro_torch.launch.decompose\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_no_jax_or_reference_imports_in_source():
    pat = re.compile(r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)\b"
                     r"(?!_torch))", re.M)
    srcs = list((REPO / "src" / "repro_torch").rglob("*.py"))
    srcs.append(REPO / "chip_smoke.py")
    offenders = [str(p) for p in srcs if pat.search(p.read_text())]
    assert not offenders


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")


@pytest.mark.parametrize("entry", ("cpapr_mu", "make_tensor", "phi_from_rows",
                                   "phi_mu_step", "decompose",
                                   "random_poisson_tensor"))
def test_entry_points_default_to_cuda_and_raise(no_card, entry):
    from repro_torch.core import phi as P_phi
    from repro_torch.core.sparse_tensor import random_poisson_tensor
    from repro_torch.data.tensors import make_tensor
    from repro_torch.launch.decompose import decompose

    pt, _ = port_problem("uniform")
    x = torch.zeros(3)
    calls = {
        "cpapr_mu": lambda: P_cpapr.cpapr_mu(pt, RANK),
        "make_tensor": lambda: make_tensor("uber", scale=0.0),
        "phi_from_rows": lambda: P_phi.phi_from_rows(
            x.long(), x, x[:, None], x[:, None], 3),
        "phi_mu_step": lambda: P_phi.phi_mu_step(
            x.long(), x, x[:, None], x[:, None], 3),
        "decompose": lambda: decompose("uber", scale=0.0),
        "random_poisson_tensor": lambda: random_poisson_tensor((3, 3), 5),
    }
    with pytest.raises(RuntimeError, match="cuda"):
        calls[entry]()


def test_timing_needs_a_card(no_card):
    from repro_torch.perf.timing import cuda_ms

    with pytest.raises(RuntimeError, match="CUDA"):
        cuda_ms(lambda: None)


def test_make_tensor_seed_is_stable_across_processes():
    code = ("from repro_torch.data.tensors import make_tensor\n"
            "t, _ = make_tensor('uber', scale=0.001, rank=4, device='cpu')\n"
            "print(t.nnz, int(t.indices.sum()), float(t.values.sum()))\n")
    outs = []
    for hashseed in ("1", "2"):
        env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
                   PYTHONHASHSEED=hashseed)
        r = subprocess.run([sys.executable, "-c", code], env=env,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stderr
        outs.append(r.stdout)
    assert outs[0] == outs[1]


def test_decompose_cli_on_cpu(capsys):
    from repro_torch.launch.decompose import main

    main(["--tensor", "uber", "--scale", "0.001", "--rank", "4",
          "--max-outer", "2", "--strategy", "cuda", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "loglik:" in out and "seconds per sweep:" in out
