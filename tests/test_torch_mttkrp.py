"""MTTKRP and CP-ALS of the port against the JAX package.

The same inputs (the conformance fixtures, converted from numpy) go
through the reference's ``krao_reduce_rows``/``mttkrp``/``fit_score``/
``cp_als`` and the port's, strategy against strategy: the port's ``cuda``
(here, on CPU tensors, the MTTKRP kernel wrapper's plain version) against
the reference's ``pallas`` (in interpret mode, as its own tests run it),
``blocked``, ``segment`` and ``scatter`` against theirs.  Tolerance tiers
are the conformance matrix's: ``TOL`` for f32, ``TOL_BF16`` for bf16.

The CUDA kernel itself is held against its plain version on the card by
``tests/test_torch_cuda.py``.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cpals as R_cpals
from repro.core import phi as R_phi
from repro.core import pi as R_pi
from repro.core.layout import build_blocked_layout as r_build_layout
from repro.core.policy import PhiPolicy as RPolicy
from repro.core.sparse_tensor import sort_mode as r_sort_mode

from repro_torch.core import cpals as P_cpals
from repro_torch.core import phi as P_phi
from repro_torch.core import pi as P_pi
from repro_torch.core.convert import ktensor_from_numpy, sparse_tensor_from_numpy
from repro_torch.core.layout import build_blocked_layout as p_build_layout
from repro_torch.core import policy as P_policy
from repro_torch.core.policy import PhiPolicy as PPolicy
from repro_torch.core.sparse_tensor import sort_mode as p_sort_mode
from repro_torch.kernels.mttkrp import ops as P_ops
from repro_torch.kernels.mttkrp import ref as P_ref
from repro_torch.kernels._checks import SMEM_LIMIT, check_card_limits
from repro_torch.kernels.phi import kernel as P_phi_kernel

from test_conformance import BN, BR, FIXTURES, RANK, TOL, TOL_BF16, make_fixture

MODES = (0, 1, 2)
# port strategy -> the reference strategy it is held against
PAIRS = {"cuda": "pallas", "blocked": "blocked", "segment": "segment",
         "scatter": "scatter"}
ALS_ITERS = 3


@functools.lru_cache(maxsize=None)
def port_problem(kind: str):
    """The fixture's tensor and starting model, handed to the port as
    numpy arrays."""
    t, kt = make_fixture(kind)
    pt = sparse_tensor_from_numpy(t.shape, np.asarray(t.indices),
                                  np.asarray(t.values), device="cpu")
    pkt = ktensor_from_numpy(np.asarray(kt.lam),
                             [np.asarray(f) for f in kt.factors], "cpu")
    return pt, pkt


@functools.lru_cache(maxsize=None)
def problem(kind: str, mode: int):
    """Reference and port inputs of one fixture mode: (ref dict, port
    dict), each with the sorted mode view, the Khatri-Rao rows and the
    conformance blocking."""
    t, kt = make_fixture(kind)
    rmv = r_sort_mode(t, mode)
    ref = dict(mv=rmv, kr=R_pi.pi_rows(rmv.sorted_idx, kt.factors, mode),
               layout=r_build_layout(np.asarray(rmv.rows), rmv.n_rows, BN, BR))
    pt, pkt = port_problem(kind)
    pmv = p_sort_mode(pt, mode)
    port = dict(mv=pmv, kr=P_pi.pi_rows(pmv.sorted_idx, pkt.factors, mode),
                layout=p_build_layout(pmv.rows.numpy(), pmv.n_rows, BN, BR))
    return ref, port


def _layout_for(strategy, d):
    return d["layout"] if strategy in ("blocked", "cuda", "pallas") else None


@pytest.mark.parametrize("strategy", tuple(PAIRS))
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", FIXTURES)
def test_krao_reduce_rows_matches_reference(kind, mode, strategy):
    ref, port = problem(kind, mode)
    rs = PAIRS[strategy]
    rmv, pmv = ref["mv"], port["mv"]
    want = R_phi.krao_reduce_rows(rmv.rows, rmv.sorted_vals, ref["kr"],
                                  rmv.n_rows, strategy=rs,
                                  layout=_layout_for(rs, ref))
    got = P_phi.krao_reduce_rows(pmv.rows, pmv.sorted_vals, port["kr"],
                                 pmv.n_rows, strategy=strategy,
                                 layout=_layout_for(strategy, port),
                                 device="cpu")
    assert got.shape == (pmv.n_rows, RANK) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                               err_msg=f"mttkrp {strategy} {kind} m{mode}")


@pytest.mark.parametrize("kind", FIXTURES)
def test_cuda_bf16_matches_reference_pallas(kind):
    """The bf16 element tier (f32 accumulation) against the reference's
    pallas bf16 tier, at TOL_BF16, on every mode."""
    for mode in MODES:
        ref, port = problem(kind, mode)
        rmv, pmv = ref["mv"], port["mv"]
        want = R_phi.krao_reduce_rows(
            rmv.rows, rmv.sorted_vals.astype(jnp.bfloat16),
            ref["kr"].astype(jnp.bfloat16), rmv.n_rows, strategy="pallas",
            layout=ref["layout"])
        got = P_phi.krao_reduce_rows(
            pmv.rows, pmv.sorted_vals.to(torch.bfloat16),
            port["kr"].to(torch.bfloat16), pmv.n_rows, strategy="cuda",
            layout=port["layout"], device="cpu")
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), **TOL_BF16,
                                   err_msg=f"bf16 {kind} mode {mode}")


@pytest.mark.parametrize("strategy", ("cuda", "blocked"))
def test_negative_values_count(strategy):
    """MTTKRP has no x > 0 condition: negative values contribute like any
    other, in the port's blocked schedules as in the reference's."""
    ref, port = problem("hub", 0)
    rmv, pmv = ref["mv"], port["mv"]
    sign = np.where(np.arange(pmv.nnz) % 3 == 0, -1.0, 1.0).astype(np.float32)
    want = R_phi.krao_reduce_rows(
        rmv.rows, rmv.sorted_vals * jnp.asarray(sign), ref["kr"], rmv.n_rows,
        strategy=PAIRS[strategy], layout=ref["layout"])
    got = P_phi.krao_reduce_rows(
        pmv.rows, pmv.sorted_vals * torch.as_tensor(sign), port["kr"],
        pmv.n_rows, strategy=strategy, layout=port["layout"], device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(got.min()) < 0


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", FIXTURES)
def test_mttkrp_on_unsorted_coo(kind, mode):
    """``mttkrp`` on the raw COO order with ``segment``: the reference
    drops its sorted promise (``sorted_rows=False``), the port's
    ``index_add_`` needs none."""
    t, kt = make_fixture(kind)
    pt, pkt = port_problem(kind)
    want = R_cpals.mttkrp(t.indices, t.values, kt.factors, mode,
                          t.shape[mode], strategy="segment")
    got = P_cpals.mttkrp(pt.indices, pt.values, pkt.factors, mode,
                         pt.shape[mode], strategy="segment", device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("strategy", tuple(PAIRS))
def test_mttkrp_mode_matches_reference(strategy):
    t, kt = make_fixture("empty_row")
    ref, port = problem("empty_row", 1)
    _, pkt = port_problem("empty_row")
    rs = PAIRS[strategy]
    want = R_cpals.mttkrp_mode(ref["mv"], kt.factors, strategy=rs,
                               layout=_layout_for(rs, ref))
    got = P_cpals.mttkrp_mode(port["mv"], pkt.factors, strategy=strategy,
                              layout=_layout_for(strategy, port),
                              device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("kind", FIXTURES)
def test_fit_score_matches_reference(kind):
    t, kt = make_fixture(kind)
    pt, pkt = port_problem(kind)
    r_norm = jnp.sqrt(jnp.sum(t.values ** 2))
    p_norm = torch.sqrt(torch.sum(pt.values ** 2))
    for scale in (1.0, 50.0):
        want = R_cpals.fit_score(t, [f * scale for f in kt.factors], r_norm)
        got = P_cpals.fit_score(pt, [f * scale for f in pkt.factors], p_norm)
        np.testing.assert_allclose(float(got), float(want), **TOL)


@functools.lru_cache(maxsize=None)
def reference_als(kind: str, strategy: str):
    t, kt = make_fixture(kind)
    pol = RPolicy(block_nnz=BN, block_rows=BR)
    return R_cpals.cp_als(t, RANK, n_iters=ALS_ITERS, init=kt,
                          strategy=strategy, policy=pol)


@pytest.mark.parametrize("strategy", tuple(PAIRS))
@pytest.mark.parametrize("kind", FIXTURES)
def test_cp_als_matches_reference(kind, strategy):
    want_kt, want_fits = reference_als(kind, PAIRS[strategy])
    pt, pkt = port_problem(kind)
    got_kt, got_fits = P_cpals.cp_als(
        pt, RANK, n_iters=ALS_ITERS, init=pkt, strategy=strategy,
        policy=PPolicy(block_nnz=BN, block_rows=BR), device="cpu")
    assert len(got_fits) == ALS_ITERS
    np.testing.assert_allclose(got_fits, want_fits, **TOL)
    np.testing.assert_allclose(got_kt.lam.numpy(), np.asarray(want_kt.lam),
                               **TOL)
    for gf, wf in zip(got_kt.factors, want_kt.factors):
        np.testing.assert_allclose(gf.numpy(), np.asarray(wf), **TOL)


def test_cp_als_seeded_init_is_deterministic():
    pt, _ = port_problem("uniform")
    a = P_cpals.cp_als(pt, RANK, n_iters=2, seed=3, device="cpu")[1]
    b = P_cpals.cp_als(pt, RANK, n_iters=2, seed=3, device="cpu")[1]
    assert a == b


@pytest.mark.parametrize("field,value,item", [
    ("mesh", object(), "A8"), ("n_shards", 2, "A8"),
])
def test_cp_als_unported_options_raise(field, value, item):
    """The multi-device options of ROADMAP {item} are ported: as in the JAX
    package they act only with ``strategy="sharded"``, so on the default
    strategy the fits are the plain ones; with it, ``n_shards`` shards
    the MTTKRP and the fits match the reference's."""
    pt, pkt = port_problem("uniform")
    got = P_cpals.cp_als(pt, RANK, n_iters=1, init=pkt, device="cpu",
                         **{field: value})[1]
    assert got == P_cpals.cp_als(pt, RANK, n_iters=1, init=pkt,
                                 device="cpu")[1]
    if field == "n_shards":
        t, kt = make_fixture("uniform")
        want = R_cpals.cp_als(t, RANK, n_iters=2, init=kt,
                              strategy="sharded", n_shards=value)[1]
        got = P_cpals.cp_als(pt, RANK, n_iters=2, init=pkt,
                             strategy="sharded", n_shards=value,
                             device="cpu")[1]
        np.testing.assert_allclose(got, want, **TOL)


def test_cp_als_policy_auto_matches_reference(tmp_path):
    """``policy="auto"`` (which raised "not ported" before the autotuner
    existed) with non-measuring tuners in both packages: each serves the
    heuristic's CPU pick, and the fits agree within TOL."""
    from repro.perf.autotune import Autotuner as RTuner

    from repro_torch.perf.autotune import Autotuner as PTuner

    t, kt = make_fixture("uniform")
    want = R_cpals.cp_als(t, RANK, n_iters=ALS_ITERS, init=kt, policy="auto",
                          autotuner=RTuner(cache_path=str(tmp_path / "r.json"),
                                           measure=False))[1]
    pt, pkt = port_problem("uniform")
    tuner = PTuner(cache_path=str(tmp_path / "p.json"), measure=False)
    got = P_cpals.cp_als(pt, RANK, n_iters=ALS_ITERS, init=pkt, policy="auto",
                         autotuner=tuner, device="cpu")[1]
    assert tuner.n_searches == 3
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("strategy", ("sharded", "grid"))
def test_unported_strategies_raise(strategy):
    """Both multi-device strategies are ported: with their default
    layouts their MTTKRP matches the reference's, and so does a grid
    ``cp_als``."""
    ref, port = problem("uniform", 0)
    pmv = port["mv"]
    args = (pmv.rows, pmv.sorted_vals, port["kr"], pmv.n_rows)
    rmv = ref["mv"]
    want = R_phi.krao_reduce_rows(rmv.rows, rmv.sorted_vals, ref["kr"],
                                  rmv.n_rows, strategy=strategy)
    got = P_phi.krao_reduce_rows(*args, strategy=strategy, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if strategy == "grid":
        t, kt = make_fixture("uniform")
        pt, pkt = port_problem("uniform")
        _, wf = R_cpals.cp_als(t, RANK, n_iters=1, init=kt, strategy="grid")
        _, gf = P_cpals.cp_als(pt, RANK, n_iters=1, init=pkt,
                               strategy="grid", device="cpu")
        np.testing.assert_allclose(gf, wf, **TOL)


def test_cp_als_validates_inputs():
    t, _ = make_fixture("uniform")
    idx = np.array(t.indices)
    idx[4, 2] = t.shape[2]
    pt = sparse_tensor_from_numpy(t.shape, idx, np.array(t.values), "cpu")
    with pytest.raises(ValueError, match="cp_als: mode 2 has out-of-range"):
        P_cpals.cp_als(pt, RANK, n_iters=1, device="cpu")


def _kernel_inputs(kind="hub", mode=0, dtype=torch.float32):
    _, port = problem(kind, mode)
    pmv, lay = port["mv"], port["layout"]
    vals_e, kr_e = P_phi.expand_to_layout(lay, pmv.sorted_vals, port["kr"])
    return lay, vals_e.to(dtype), kr_e.to(dtype)


def test_kernel_wrapper_checks():
    lay, vals_e, kr_e = _kernel_inputs()
    lt = lay.on("cpu")
    kw = dict(block_nnz=lay.block_nnz, block_rows=lay.block_rows,
              n_rows_pad=lay.n_rows_pad)
    with pytest.raises(ValueError, match="float64"):
        P_ops.mttkrp_blocked(lay, vals_e.double(), kr_e.double())
    with pytest.raises(ValueError, match="share one element dtype"):
        P_ops.mttkrp_blocked(lay, vals_e, kr_e.to(torch.bfloat16))
    with pytest.raises(ValueError, match="shapes"):
        P_ops.mttkrp_blocked_arrays(lt.grid_rb, vals_e[:-1], lt.local_rows,
                                    kr_e, **kw)
    with pytest.raises(ValueError, match="shapes"):
        P_ops.mttkrp_blocked_arrays(lt.grid_rb, vals_e, lt.local_rows, kr_e,
                                    **dict(kw, n_rows_pad=lay.n_rows_pad + 1))
    with pytest.raises(ValueError, match="int32"):
        P_ops.mttkrp_blocked_arrays(lt.grid_rb.long(), vals_e, lt.local_rows,
                                    kr_e, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        P_ops.mttkrp_blocked_arrays(lt.grid_rb, vals_e, lt.local_rows,
                                    kr_e.t().contiguous().t(), **kw)


def test_cpu_wrapper_counts_no_launches():
    P_ops.reset_launch_counts()
    lay, vals_e, kr_e = _kernel_inputs()
    P_ops.mttkrp_blocked(lay, vals_e, kr_e)
    assert P_ops.launch_counts == {"mttkrp_blocked": 0}


@pytest.mark.parametrize("kind", FIXTURES)
def test_blocked_plain_version_matches_unblocked(kind):
    """The kernel's plain version on the padded window equals the plain
    MTTKRP on the raw stream (padding slots and rows add exactly 0)."""
    _, port = problem(kind, 0)
    pmv, lay = port["mv"], port["layout"]
    _, vals_e, kr_e = _kernel_inputs(kind)
    lt = lay.on("cpu")
    pad = P_ref.mttkrp_blocked_ref(lt.grid_rb, vals_e, lt.local_rows, kr_e,
                                   block_nnz=lay.block_nnz,
                                   block_rows=lay.block_rows,
                                   n_rows_pad=lay.n_rows_pad)
    raw = P_ref.mttkrp_ref(pmv.rows, pmv.sorted_vals, port["kr"], pmv.n_rows)
    np.testing.assert_allclose(pad[:pmv.n_rows].numpy(), raw.numpy(), **TOL)
    assert not pad[pmv.n_rows:].any()


# --- the kernel's shared memory: the Φ accumulation's ------------------------

SMEM_RANKS = (1, 16, 64, 1024)
SMEM_DTYPES = (torch.float32, torch.bfloat16)


def _grid_blockings():
    return sorted({(p.block_nnz, p.block_rows)
                   for p in P_policy.policy_grid(strategies=("cuda",))})


@pytest.mark.parametrize("dtype", SMEM_DTYPES)
@pytest.mark.parametrize("rank", SMEM_RANKS)
def test_wrapper_footprint_is_the_phi_kernels(rank, dtype):
    """B3 runs the Φ kernels' accumulation, so the wrapper checks the Φ
    footprint, in the caller's dtype, at every policy_grid point."""
    for bn, br in _grid_blockings():
        assert P_ops.smem_bytes(bn, br, rank, dtype) == \
            P_phi_kernel.smem_bytes(bn, br, rank, dtype), (bn, br)


@pytest.mark.parametrize("dtype", SMEM_DTYPES)
@pytest.mark.parametrize("rank", SMEM_RANKS)
def test_wrapper_card_check_raises_exactly_above_the_limit(rank, dtype):
    """The card check with the wrapper's footprint passes at every
    policy_grid point (including the blockings the old row window of
    4 * block_rows * R bytes refused), and the same check raises exactly
    where a footprint exceeds SMEM_LIMIT."""
    refused_before = 0
    for bn, br in _grid_blockings():
        fn = functools.partial(P_ops.smem_bytes, bn, br, dtype=dtype)
        assert fn(rank) <= SMEM_LIMIT
        check_card_limits("mttkrp_blocked", rank, block_nnz=bn,
                          block_rows=br, smem_bytes=fn)
        refused_before += 4 * br * rank > SMEM_LIMIT
    assert refused_before == (20 if rank == 1024 else 0)
    kw = dict(block_nnz=256, block_rows=256)
    check_card_limits("mttkrp_blocked", rank, smem_bytes=lambda r: SMEM_LIMIT,
                      **kw)
    with pytest.raises(ValueError, match="shared memory"):
        check_card_limits("mttkrp_blocked", rank,
                          smem_bytes=lambda r: SMEM_LIMIT + 1, **kw)
