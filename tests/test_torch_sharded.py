"""The port's row-sharded tier against the JAX package, on the CPU.

The conformance fixtures (uniform, hub, empty-row) go to both packages
as numpy, at S = 2 and 4 shards, and every result is held to ``TOL``:

  * the sharding structures (``ShardedBlockedLayout``,
    ``rebalance_shards``, ``shard_row_ranges``/``shard_stream_cuts``,
    ``OwnerPartition``, ``ShardedPiGather``) are array-equal to the
    reference's, and ``pi_rows_local`` is bitwise the expanded Π;
  * the registry rows ``sharded-psum``, ``sharded-reduce-scatter``,
    ``sharded-psum-local-pi`` and ``sharded-rs-local-pi`` (as in
    ``tests/test_conformance.py``) for Φ, MTTKRP and the fused MU step,
    against the reference's one-device emulation; psum and reduce-scatter
    are bitwise equal within the port;
  * ``cpapr_mu``/``cp_als`` with ``strategy="sharded"`` (both combines,
    ``shard_pi`` on and off, rebalancing) match the reference's factors,
    KKT, log-likelihood and inner-count histories;
  * the warned fallbacks and ``resolve_combine``/``effective_mode_combine``.

The remaining cases mirror ``tests/test_sharded_phi.py`` and
``tests/test_sharded_pi.py`` one by one.  Their ``local_strategy="pallas"``
rows are the port's ``cuda`` (on CPU tensors, the kernel wrapper's plain
version; ``tests/test_torch_cuda.py`` runs the kernels per shard).  The
mesh path over several ranks is ``tests/test_torch_dist.py``.
"""
import functools

import numpy as np
import pytest
import torch

from repro.core import cpals as R_cpals
from repro.core import cpapr as R_cpapr
from repro.core import layout as R_layout
from repro.core import phi as R_phi
from repro.core import pi as R_pi
from repro.core.policy import PhiPolicy as RPolicy
from repro.core.sparse_tensor import sort_mode as r_sort_mode

from repro_torch.core import cpals as P_cpals
from repro_torch.core import cpapr as P_cpapr
from repro_torch.core import distributed as P_dist
from repro_torch.core import layout as P_layout
from repro_torch.core import phi as P_phi
from repro_torch.core import pi as P_pi
from repro_torch.core.convert import ktensor_from_numpy, sparse_tensor_from_numpy
from repro_torch.core.policy import PhiPolicy as PPolicy
from repro_torch.core.resilience import NotPortedError, ShardAssignmentError
from repro_torch.core.sparse_tensor import sort_mode as p_sort_mode

from conftest import dense_phi_reference
from test_conformance import BN, BR, FIXTURES, RANK, TOL, make_fixture

MODES = (0, 1, 2)
SHARDS = (2, 4)
MU_TOL = 1e-4
# the conformance registry's sharded rows: combine and shard-local Π
ROWS = {
    "sharded-psum": dict(combine="psum"),
    "sharded-reduce-scatter": dict(combine="reduce_scatter"),
    "sharded-psum-local-pi": dict(combine="psum", local_pi=True),
    "sharded-rs-local-pi": dict(combine="reduce_scatter", local_pi=True),
}
LAYOUT_FIELDS = ("n_shards", "n_grid_shard", "n_rb_shard", "buf_rows",
                 "rb_start", "rb_count", "shard_nnz", "gather", "valid",
                 "local_rows", "grid_rb", "pad_fraction")


@functools.lru_cache(maxsize=None)
def tensors(kind: str):
    """(reference t, kt), (port t, kt) of one fixture, from numpy."""
    t, kt = make_fixture(kind)
    pt = sparse_tensor_from_numpy(t.shape, np.asarray(t.indices),
                                  np.asarray(t.values), device="cpu")
    pkt = ktensor_from_numpy(np.asarray(kt.lam),
                             [np.asarray(f) for f in kt.factors], "cpu")
    return (t, kt), (pt, pkt)


@functools.lru_cache(maxsize=None)
def problem(kind: str, mode: int, n_shards: int):
    """Both packages' inputs of one fixture mode at ``n_shards`` shards:
    (ref dict, port dict)."""
    (t, kt), (pt, pkt) = tensors(kind)
    rmv, pmv = r_sort_mode(t, mode), p_sort_mode(pt, mode)
    ref = dict(mv=rmv, kt=kt, pi=R_pi.pi_rows(rmv.sorted_idx, kt.factors,
                                              mode),
               b=kt.factors[mode] * kt.lam[None, :])
    port = dict(mv=pmv, kt=pkt, pi=P_pi.pi_rows(pmv.sorted_idx, pkt.factors,
                                                mode),
                b=pkt.factors[mode] * pkt.lam[None, :])
    ref["base"] = R_layout.build_blocked_layout(np.asarray(rmv.rows),
                                                rmv.n_rows, BN, BR)
    port["base"] = P_layout.build_blocked_layout(pmv.rows.numpy(),
                                                 pmv.n_rows, BN, BR)
    ref["sl"] = R_layout.shard_blocked_layout(ref["base"], n_shards)
    port["sl"] = P_layout.shard_blocked_layout(port["base"], n_shards)
    ref["pig"] = R_layout.build_shard_pi_gather(
        ref["sl"], np.asarray(rmv.sorted_idx), mode)
    port["pig"] = P_layout.build_shard_pi_gather(port["sl"], pmv.sorted_idx,
                                                 mode)
    return ref, port


def _kw(d, row, port: bool):
    kw = dict(strategy="sharded", layout=d["sl"], combine=row["combine"])
    if row.get("local_pi"):
        kw.update(pi_gather=d["pig"], factors=d["kt"].factors)
    if port:
        kw["device"] = "cpu"
    return kw


def _run(d, row, op, port: bool, **extra):
    """One registry row's op through one package."""
    mod = P_phi if port else R_phi
    mv = d["mv"]
    kw = dict(_kw(d, row, port), **extra)
    pi = None if row.get("local_pi") else d["pi"]
    if op == "phi":
        return mod.phi_from_rows(mv.rows, mv.sorted_vals, pi, d["b"],
                                 mv.n_rows, **kw)
    if op == "mttkrp":
        return mod.krao_reduce_rows(mv.rows, mv.sorted_vals, pi, mv.n_rows,
                                    **kw)
    return mod.phi_mu_step(mv.rows, mv.sorted_vals, pi, d["b"], mv.n_rows,
                           tol=MU_TOL, **kw)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The solves here are thousands of small CPU ops: one intra-op thread
    keeps them from contending with the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# Sharding structures: array-equal to the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("kind", FIXTURES)
def test_sharding_structures_equal_reference(kind, n_shards):
    for mode in MODES:
        ref, port = problem(kind, mode, n_shards)
        rs, ps = ref["sl"], port["sl"]
        for f in LAYOUT_FIELDS:
            np.testing.assert_array_equal(getattr(ps, f), getattr(rs, f),
                                          err_msg=f"{kind} {mode} {f}")
        rb, pb = R_layout.rebalance_shards(rs), P_layout.rebalance_shards(ps)
        for f in LAYOUT_FIELDS:
            np.testing.assert_array_equal(getattr(pb, f), getattr(rb, f))
        secs = np.linspace(1.0, 3.0, n_shards)
        np.testing.assert_array_equal(
            P_layout.rebalance_shards(ps, shard_seconds=secs).rb_start,
            R_layout.rebalance_shards(rs, shard_seconds=secs).rb_start)
        assert P_layout.shard_row_ranges(ps) == R_layout.shard_row_ranges(rs)
        rows = np.asarray(ref["mv"].rows)
        assert P_layout.shard_stream_cuts(ps, rows) == \
            R_layout.shard_stream_cuts(rs, rows)
        ro, po = R_layout.owner_partition(rs), P_layout.owner_partition(ps)
        assert P_layout.owner_partition(ps) is po  # memoized per layout
        for f in ("n_shards", "own_rows", "buf_rows", "n_rows", "row_start",
                  "row_count", "rb_start", "fingerprint"):
            np.testing.assert_array_equal(getattr(po, f), getattr(ro, f))
        np.testing.assert_array_equal(po.masks(), ro.masks())
        np.testing.assert_array_equal(po.owner_of_rows(), ro.owner_of_rows())
        assert po.scatter_bytes(RANK) == ro.scatter_bytes(RANK)
        rp, pp = ref["pig"], port["pig"]
        assert (pp.mode, pp.n_modes, pp.n_shards, pp.modes, pp.rb_start) == \
            (rp.mode, rp.n_modes, rp.n_shards, rp.modes, rp.rb_start)
        np.testing.assert_array_equal(pp.touched_count, rp.touched_count)
        for a, b in zip(pp.touched + pp.local_idx, rp.touched + rp.local_idx):
            np.testing.assert_array_equal(a, b)
        assert pp.gather_bytes(RANK) == rp.gather_bytes(RANK)
        shape = tensors(kind)[0][0].shape
        assert pp.replicated_bytes(shape, RANK) == \
            rp.replicated_bytes(shape, RANK)


@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("kind", FIXTURES)
def test_combine_accounting_equals_reference(kind, n_shards):
    """The wire-byte accounting and the wire-aware combine choice."""
    from repro.core import distributed as R_dist

    for mode in MODES:
        ref, port = problem(kind, mode, n_shards)
        rs, ps = ref["sl"], port["sl"]
        assert P_dist.sharded_combine_bytes(ps, RANK) == \
            R_dist.sharded_combine_bytes(rs, RANK)
        assert P_dist.owner_scatter_wire_bytes(
            P_layout.owner_partition(ps), RANK) == \
            R_dist.owner_scatter_wire_bytes(R_layout.owner_partition(rs),
                                            RANK)
        for isz in (2, 4, 8):
            assert P_dist.preferred_combine(ps, RANK, isz) == \
                R_dist.preferred_combine(rs, RANK, isz)


@pytest.mark.parametrize("kind", FIXTURES)
def test_pi_rows_local_is_the_expanded_pi(kind):
    """pi_rows_local on gathered factor rows == expand_to_shards of the
    globally computed Π rows, bitwise, and equal to the reference's."""
    for n_shards in SHARDS:
        for mode in MODES:
            ref, port = problem(kind, mode, n_shards)
            sl, pig, kt = port["sl"], port["pig"], port["kt"]
            _, pi_es = P_phi.expand_to_shards(sl, port["mv"].sorted_vals,
                                              port["pi"])
            _, rpi_es = R_phi.expand_to_shards(ref["sl"],
                                               ref["mv"].sorted_vals,
                                               ref["pi"])
            for s in range(sl.n_shards):
                fgs = [kt.factors[m][torch.as_tensor(pig.touched[j][s],
                                                     dtype=torch.int64)]
                       for j, m in enumerate(pig.modes)]
                local = P_pi.pi_rows_local(
                    fgs, [torch.as_tensor(x[s], dtype=torch.int64)
                          for x in pig.local_idx],
                    torch.as_tensor(sl.valid[s]))
                np.testing.assert_array_equal(local.numpy(),
                                              pi_es[s].numpy())
                np.testing.assert_array_equal(local.numpy(),
                                              np.asarray(rpi_es[s]))


def test_shard_layout_rejects_too_many_shards():
    _, port = problem("uniform", 0, 2)
    base = P_layout.build_blocked_layout(port["mv"].rows.numpy(),
                                         port["mv"].n_rows, 64, 256)
    assert base.n_row_blocks == 1
    with pytest.raises(ValueError, match="n_row_blocks"):
        P_layout.shard_blocked_layout(base, 2)
    with pytest.raises(ValueError, match="bounds"):
        P_layout.shard_blocked_layout(port["base"], 2, bounds=[0, 0, 1])


# ---------------------------------------------------------------------------
# Φ, MTTKRP and the fused step: the registry's sharded rows
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", ("phi", "mttkrp", "mu"))
@pytest.mark.parametrize("row", tuple(ROWS))
@pytest.mark.parametrize("kind", FIXTURES)
def test_sharded_rows_match_reference(kind, row, op):
    for n_shards in SHARDS:
        for mode in MODES:
            ref, port = problem(kind, mode, n_shards)
            want = _run(ref, ROWS[row], op, port=False)
            got = _run(port, ROWS[row], op, port=True)
            msg = f"{op} {row} {kind} mode {mode} S={n_shards}"
            if op == "mu":
                np.testing.assert_allclose(float(got[1]), float(want[1]),
                                           **TOL, err_msg=msg)
                got, want = got[0], want[0]
            assert got.shape == (port["mv"].n_rows, RANK), msg
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                       err_msg=msg)


@pytest.mark.parametrize("op", ("phi", "mttkrp", "mu"))
@pytest.mark.parametrize("kind", FIXTURES)
def test_psum_and_reduce_scatter_are_bitwise_equal(kind, op):
    """Both combines add exact zeros: bitwise equal, with replicated and
    with shard-local Π (the latter bitwise the former too)."""
    for n_shards in SHARDS:
        for mode in MODES:
            _, port = problem(kind, mode, n_shards)
            outs = [_run(port, ROWS[r], op, port=True) for r in ROWS]
            outs = [o[0] if op == "mu" else o for o in outs]
            for o in outs[1:]:
                np.testing.assert_array_equal(o.numpy(), outs[0].numpy())


@pytest.mark.parametrize("local", ("blocked", "cuda", "pallas"))
@pytest.mark.parametrize("n_shards", (1, 2, 3, 4))
def test_sharded_phi_mu_step_matches_unfused(n_shards, local):
    """Fused sharded (B', viol) == the unfused scatter composition, for
    every local compute flavour."""
    _, port = problem("uniform", 0, 2)
    mv, pi, b = port["mv"], port["pi"], port["b"]
    sl = P_layout.shard_blocked_layout(port["base"], n_shards)
    phi = P_phi.phi_from_rows(mv.rows, mv.sorted_vals, pi, b, mv.n_rows,
                              strategy="scatter", device="cpu")
    viol_ref = float(torch.max(torch.abs(torch.minimum(b, 1.0 - phi))))
    b_ref = b * phi if viol_ref > MU_TOL else b
    out_b, out_v = P_phi.phi_mu_step(mv.rows, mv.sorted_vals, pi, b,
                                     mv.n_rows, tol=MU_TOL,
                                     strategy="sharded", layout=sl,
                                     local_strategy=local, device="cpu")
    np.testing.assert_allclose(float(out_v), viol_ref, **TOL)
    np.testing.assert_allclose(out_b.numpy(), b_ref.numpy(), **TOL)


def test_sharded_pre_expanded_inputs_match():
    """Hoisted expand_to_shards tensors give the same answer as
    re-expansion, and equal the reference's expansion."""
    ref, port = problem("uniform", 0, 2)
    mv, pi, b = port["mv"], port["pi"], port["b"]
    sl = P_layout.shard_blocked_layout(port["base"], 3)
    vals_es, pi_es = P_phi.expand_to_shards(sl, mv.sorted_vals, pi)
    rsl = R_layout.shard_blocked_layout(ref["base"], 3)
    rvals, rpi = R_phi.expand_to_shards(rsl, ref["mv"].sorted_vals,
                                        ref["pi"])
    np.testing.assert_array_equal(vals_es.numpy(), np.asarray(rvals))
    np.testing.assert_array_equal(pi_es.numpy(), np.asarray(rpi))
    np.testing.assert_array_equal(
        P_phi.expand_vals_to_shards(sl, mv.sorted_vals).numpy(),
        vals_es.numpy())
    kw = dict(strategy="sharded", layout=sl, device="cpu")
    a = P_phi.phi_from_rows(mv.rows, mv.sorted_vals, pi, b, mv.n_rows, **kw)
    h = P_phi.phi_from_rows(mv.rows, mv.sorted_vals, pi, b, mv.n_rows,
                            vals_e=vals_es, pi_e=pi_es, **kw)
    np.testing.assert_array_equal(a.numpy(), h.numpy())


def test_owner_stack_round_trips():
    """owner_stack/owner_unstack reassemble the block exactly, uniform
    and ragged owner slices alike."""
    for kind in FIXTURES:
        for n_shards in SHARDS:
            for mode in MODES:
                _, port = problem(kind, mode, n_shards)
                opart = P_layout.owner_partition(port["sl"])
                b = port["b"]
                st = P_dist.owner_stack(opart, b)
                assert st.shape == (opart.n_shards, opart.own_rows, RANK)
                np.testing.assert_array_equal(
                    P_dist.owner_unstack(opart, st).numpy(), b.numpy())


# ---------------------------------------------------------------------------
# Shard-local Π: validation and numerics
# ---------------------------------------------------------------------------


def test_pi_gather_rejects_mismatched_layout():
    _, port = problem("uniform", 0, 4)
    mv, b, pig, kt = port["mv"], port["b"], port["pig"], port["kt"]
    with pytest.raises(TypeError, match="ShardedBlockedLayout"):
        P_phi.phi_from_rows(mv.rows, mv.sorted_vals, None, b, mv.n_rows,
                            strategy="sharded", layout=None, pi_gather=pig,
                            factors=kt.factors, device="cpu")
    with pytest.raises(ValueError, match="factors"):
        P_phi.phi_from_rows(mv.rows, mv.sorted_vals, None, b, mv.n_rows,
                            strategy="sharded", layout=port["sl"],
                            pi_gather=pig, device="cpu")
    other = P_layout.shard_blocked_layout(port["base"], 2)
    with pytest.raises(ValueError, match="shards"):
        P_phi.phi_mu_step(mv.rows, mv.sorted_vals, None, b, mv.n_rows,
                          strategy="sharded", layout=other, pi_gather=pig,
                          factors=kt.factors, device="cpu")


SKEW_ROWS = 192  # 24 row blocks of 8 rows at block_rows=8


def _skewed_rows():
    """20 sparse row blocks (2 nnz each) and 4 dense ones (320 nnz each):
    the step-balanced split gives one shard almost no nonzeros."""
    sparse = np.repeat(np.arange(20) * 8, 2)
    dense = np.repeat(160 + np.arange(4) * 8, 320)
    return np.sort(np.concatenate([sparse, dense])).astype(np.int32)


def _skewed_tensor():
    rows = _skewed_rows()
    rng = np.random.default_rng(0)
    idx = np.stack([rows,
                    rng.integers(0, 30, rows.size).astype(np.int32),
                    rng.integers(0, 25, rows.size).astype(np.int32)], 1)
    return rows, idx


def test_pi_gather_rejects_stale_assignment():
    """A gather built from the pre-rebalance assignment must not silently
    run against the rebalanced layout (same shard count, moved cuts);
    neither may an owner partition."""
    rows, idx = _skewed_tensor()
    base = P_layout.build_blocked_layout(rows, SKEW_ROWS, 64, 8)
    static = P_layout.shard_blocked_layout(base, 2)
    rebal = P_layout.rebalance_shards(static)
    assert not np.array_equal(static.rb_start, rebal.rb_start)
    stale_pig = P_layout.build_shard_pi_gather(static, idx, 0)
    factors = tuple(torch.ones((s, 3)) for s in (SKEW_ROWS, 30, 25))
    vals = torch.ones(rows.size)
    with pytest.raises(ShardAssignmentError, match="assignment"):
        P_phi.phi_from_rows(torch.as_tensor(rows), vals, None, factors[0],
                            SKEW_ROWS, strategy="sharded", layout=rebal,
                            pi_gather=stale_pig, factors=factors,
                            device="cpu")
    vals_es = P_phi.expand_vals_to_shards(rebal, vals)
    with pytest.raises(ShardAssignmentError, match="assignment"):
        P_dist.phi_sharded(rebal, vals_es, None, factors[0],
                           combine="reduce_scatter",
                           owner=P_layout.owner_partition(static),
                           pi_gather=P_layout.build_shard_pi_gather(
                               rebal, idx, 0), factors=factors)


@pytest.mark.parametrize("mode", MODES)
def test_local_pi_phi_matches_replicated_and_dense(mode):
    _, port = problem("uniform", mode, 4)
    mv, pi, b, kt = port["mv"], port["pi"], port["b"], port["kt"]
    ref = dense_phi_reference(mv.rows.numpy(), mv.sorted_vals.numpy(),
                              pi.numpy(), b.numpy(), mv.n_rows)
    kw = dict(strategy="sharded", layout=port["sl"], device="cpu")
    rep = P_phi.phi_from_rows(mv.rows, mv.sorted_vals, pi, b, mv.n_rows, **kw)
    loc = P_phi.phi_from_rows(mv.rows, mv.sorted_vals, None, b, mv.n_rows,
                              pi_gather=port["pig"], factors=kt.factors, **kw)
    np.testing.assert_array_equal(loc.numpy(), rep.numpy())
    np.testing.assert_allclose(loc.numpy(), ref, **TOL)


@pytest.mark.parametrize("local", ("blocked", "cuda"))
def test_local_pi_fused_step_matches_scatter(local):
    _, port = problem("uniform", 0, 4)
    mv, pi, b, kt = port["mv"], port["pi"], port["b"], port["kt"]
    phi = P_phi.phi_from_rows(mv.rows, mv.sorted_vals, pi, b, mv.n_rows,
                              strategy="scatter", device="cpu")
    viol_ref = float(torch.max(torch.abs(torch.minimum(b, 1 - phi))))
    b_ref = b * phi if viol_ref > MU_TOL else b
    bs, vs = P_phi.phi_mu_step(mv.rows, mv.sorted_vals, None, b, mv.n_rows,
                               tol=MU_TOL, strategy="sharded",
                               layout=port["sl"], local_strategy=local,
                               pi_gather=port["pig"], factors=kt.factors,
                               device="cpu")
    np.testing.assert_allclose(float(vs), viol_ref, **TOL)
    np.testing.assert_allclose(bs.numpy(), b_ref.numpy(), **TOL)


# ---------------------------------------------------------------------------
# Rebalancing
# ---------------------------------------------------------------------------


def test_rebalance_moves_boundaries_on_skewed_layout():
    rows = _skewed_rows()
    base = P_layout.build_blocked_layout(rows, SKEW_ROWS, 64, 8)
    sl = P_layout.shard_blocked_layout(base, 2)
    rb = P_layout.rebalance_shards(sl)
    assert not np.array_equal(rb.rb_start, sl.rb_start)
    rref = R_layout.rebalance_shards(R_layout.shard_blocked_layout(
        R_layout.build_blocked_layout(rows, SKEW_ROWS, 64, 8), 2))
    for f in LAYOUT_FIELDS:
        np.testing.assert_array_equal(getattr(rb, f), getattr(rref, f))

    def imb(s):
        return float(s.shard_nnz.max() / max(s.shard_nnz.mean(), 1.0))

    assert imb(rb) < imb(sl)
    np.testing.assert_array_equal(np.sort(rb.gather[rb.valid]),
                                  np.arange(len(rows)))
    assert np.all(np.diff(rb.grid_rb, axis=1) >= 0)


def test_rebalance_measured_seconds_shed_slow_shard():
    rows = np.repeat(np.arange(64, dtype=np.int32), 20)
    base = P_layout.build_blocked_layout(rows, 64, 64, 8)
    sl = P_layout.shard_blocked_layout(base, 4)
    assert int(sl.rb_count[-1]) > 1
    secs = np.ones(4)
    secs[-1] = 10.0
    rb = P_layout.rebalance_shards(sl, shard_seconds=secs)
    assert int(rb.rb_count[-1]) < int(sl.rb_count[-1])
    assert int(rb.shard_nnz.sum()) == len(rows)
    with pytest.raises(ValueError, match="shape"):
        P_layout.rebalance_shards(sl, shard_seconds=np.ones(3))
    with pytest.raises(ValueError, match="non-negative"):
        P_layout.rebalance_shards(sl, shard_seconds=-secs)


def test_shard_row_ranges_and_stream_cuts_cover():
    _, port = problem("hub", 0, 4)
    sl, mv = port["sl"], port["mv"]
    ranges = P_layout.shard_row_ranges(sl)
    assert ranges[0][0] == 0 and ranges[-1][1] == mv.n_rows
    for (_, a1), (b0, _) in zip(ranges, ranges[1:]):
        assert a1 == b0
    rows = mv.rows.numpy()
    cuts = P_layout.shard_stream_cuts(sl, rows)
    assert cuts[0] == 0 and cuts[-1] == mv.nnz
    for s in range(sl.n_shards):
        seg = rows[cuts[s]:cuts[s + 1]]
        lo, hi = ranges[s]
        assert seg.size == 0 or (lo <= seg.min() and seg.max() < hi)
        assert seg.size == int(sl.shard_nnz[s])


# ---------------------------------------------------------------------------
# The solvers
# ---------------------------------------------------------------------------

SOLVES = {
    "psum": dict(combine="psum"),
    "reduce_scatter": dict(combine="reduce_scatter"),
    "auto": dict(combine="auto"),
    "rs-replicated-pi": dict(combine="reduce_scatter", shard_pi=False),
    "auto-rebalance": dict(combine="auto", rebalance_every=1),
}


@functools.lru_cache(maxsize=None)
def reference_cpapr(kind: str, n_shards: int, case: str, local: str):
    (t, kt), _ = tensors(kind)
    cfg = R_cpapr.CPAPRConfig(
        rank=RANK, max_outer=4, strategy="sharded", n_shards=n_shards,
        policy=RPolicy(strategy=local, block_nnz=BN, block_rows=BR),
        **SOLVES[case])
    return R_cpapr.cpapr_mu(t, RANK, init=kt, config=cfg)


def _assert_solve_matches(got, want):
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
    assert (got.rebalances or []) == (want.rebalances or [])


@pytest.mark.parametrize("case", tuple(SOLVES))
@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("kind", FIXTURES)
def test_cpapr_sharded_matches_reference(kind, n_shards, case):
    want = reference_cpapr(kind, n_shards, case, "blocked")
    _, (pt, pkt) = tensors(kind)
    cfg = P_cpapr.CPAPRConfig(
        rank=RANK, max_outer=4, strategy="sharded", n_shards=n_shards,
        policy=PPolicy(strategy="blocked", block_nnz=BN, block_rows=BR),
        **SOLVES[case])
    got = P_cpapr.cpapr_mu(pt, RANK, init=pkt, config=cfg, device="cpu")
    _assert_solve_matches(got, want)
    ll = got.loglik_history
    assert all(b >= a - 1e-6 * abs(a) for a, b in zip(ll, ll[1:]))


@pytest.mark.parametrize("kind", FIXTURES)
def test_cpapr_sharded_cuda_local_matches_reference_pallas(kind):
    """The ``cuda`` shard-local flavour (its plain version on the CPU)
    against the reference's ``pallas`` in interpret mode."""
    want = reference_cpapr(kind, 2, "auto", "pallas")
    _, (pt, pkt) = tensors(kind)
    cfg = P_cpapr.CPAPRConfig(
        rank=RANK, max_outer=4, strategy="sharded", n_shards=2,
        policy=PPolicy(strategy="cuda", block_nnz=BN, block_rows=BR))
    _assert_solve_matches(P_cpapr.cpapr_mu(pt, RANK, init=pkt, config=cfg,
                                           device="cpu"), want)


def test_cpapr_sharded_matches_segment():
    """Full solver equivalence: sharded == segment (the reference's own
    case, at its tolerance)."""
    _, (pt, pkt) = tensors("uniform")
    ref = P_cpapr.cpapr_mu(pt, RANK, init=pkt, device="cpu",
                           config=P_cpapr.CPAPRConfig(
                               rank=RANK, max_outer=3, strategy="segment",
                               track_loglik=False))
    res = P_cpapr.cpapr_mu(pt, RANK, init=pkt, device="cpu",
                           config=P_cpapr.CPAPRConfig(
                               rank=RANK, max_outer=3, strategy="sharded",
                               n_shards=3, track_loglik=False))
    for a, b in zip(ref.ktensor.factors, res.ktensor.factors):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4,
                                   atol=2e-5)
    np.testing.assert_allclose(ref.kkt_history, res.kkt_history, rtol=1e-4)


def test_cpapr_shard_pi_matches_replicated_pi():
    """shard_pi=True (default) == shard_pi=False, bitwise."""
    _, (pt, pkt) = tensors("uniform")
    base = dict(rank=RANK, max_outer=3, strategy="sharded", n_shards=3,
                track_loglik=False)
    on = P_cpapr.cpapr_mu(pt, RANK, init=pkt, device="cpu",
                          config=P_cpapr.CPAPRConfig(**base, shard_pi=True))
    off = P_cpapr.cpapr_mu(pt, RANK, init=pkt, device="cpu",
                           config=P_cpapr.CPAPRConfig(**base, shard_pi=False))
    assert on.kkt_history == off.kkt_history
    for a, b in zip(on.ktensor.factors, off.ktensor.factors):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_cpapr_rebalancing_convergence_unchanged():
    """rebalance_every=1 re-splits between sweeps without changing the
    numerics (same math, another partition), and records its events."""
    _, (pt, pkt) = tensors("hub")
    pol = PPolicy(strategy="blocked", block_nnz=64, block_rows=8)
    kw = dict(rank=RANK, max_outer=4, strategy="sharded", n_shards=3,
              policy=pol, track_loglik=False)
    static = P_cpapr.cpapr_mu(pt, RANK, init=pkt, device="cpu",
                              config=P_cpapr.CPAPRConfig(**kw))
    rebal = P_cpapr.cpapr_mu(pt, RANK, init=pkt, device="cpu",
                             config=P_cpapr.CPAPRConfig(**kw,
                                                        rebalance_every=1))
    np.testing.assert_allclose(rebal.kkt_history, static.kkt_history,
                               rtol=1e-5)
    for a, b in zip(static.ktensor.factors, rebal.ktensor.factors):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-6)
    for ev in rebal.rebalances or []:
        assert ev["imbalance_new"] <= ev["imbalance_old"] + 1e-9


@pytest.mark.parametrize("combine", ("psum", "reduce_scatter", "auto"))
@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("kind", FIXTURES)
def test_cp_als_sharded_matches_reference(kind, n_shards, combine):
    (t, kt), (pt, pkt) = tensors(kind)
    wk, wf = R_cpals.cp_als(t, RANK, n_iters=3, init=kt, strategy="sharded",
                            n_shards=n_shards, combine=combine,
                            policy=RPolicy(strategy="blocked", block_nnz=BN,
                                           block_rows=BR))
    gk, gf = P_cpals.cp_als(pt, RANK, n_iters=3, init=pkt,
                            strategy="sharded", n_shards=n_shards,
                            combine=combine,
                            policy=PPolicy(strategy="blocked", block_nnz=BN,
                                           block_rows=BR), device="cpu")
    np.testing.assert_allclose(gf, wf, **TOL)
    np.testing.assert_allclose(gk.lam.numpy(), np.asarray(wk.lam), **TOL)
    for a, b in zip(gk.factors, wk.factors):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


# ---------------------------------------------------------------------------
# Warned single-device fallbacks
# ---------------------------------------------------------------------------


def test_sharded_phi_falls_back_when_too_few_row_blocks(monkeypatch):
    """More shards than row blocks: a warning and the single-device
    blocked result, never a reshape error."""
    _, port = problem("uniform", 0, 2)
    mv, pi, b = port["mv"], port["pi"], port["b"]
    monkeypatch.setattr(P_phi, "_default_shard_count",
                        lambda mesh, device: 4096)
    ref = dense_phi_reference(mv.rows.numpy(), mv.sorted_vals.numpy(),
                              pi.numpy(), b.numpy(), mv.n_rows)
    with pytest.warns(UserWarning, match="falling back"):
        out = P_phi.phi_from_rows(mv.rows, mv.sorted_vals, pi, b, mv.n_rows,
                                  strategy="sharded", device="cpu")
    with pytest.warns(UserWarning, match="falling back"):
        bs, vs = P_phi.phi_mu_step(mv.rows, mv.sorted_vals, pi, b, mv.n_rows,
                                   strategy="sharded", device="cpu")
    with pytest.warns(UserWarning, match="falling back"):
        kr = P_phi.krao_reduce_rows(mv.rows, mv.sorted_vals, pi, mv.n_rows,
                                    strategy="sharded", device="cpu")
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    viol = np.max(np.abs(np.minimum(b.numpy().astype(np.float64), 1 - ref)))
    np.testing.assert_allclose(float(vs), viol, **TOL)
    assert bs.shape == b.shape and kr.shape == b.shape


def test_cpapr_sharded_falls_back_with_warning():
    (t, kt), (pt, pkt) = tensors("uniform")
    cfg = P_cpapr.CPAPRConfig(rank=RANK, max_outer=2, strategy="sharded",
                              n_shards=64, track_loglik=False,
                              policy=PPolicy(strategy="blocked", block_nnz=64,
                                             block_rows=256))
    with pytest.warns(UserWarning, match="falling back"):
        res = P_cpapr.cpapr_mu(pt, RANK, init=pkt, config=cfg, device="cpu")
    ref = P_cpapr.cpapr_mu(pt, RANK, init=pkt, device="cpu",
                           config=P_cpapr.CPAPRConfig(
                               rank=RANK, max_outer=2, strategy="segment",
                               track_loglik=False))
    np.testing.assert_allclose(res.kkt_history, ref.kkt_history, rtol=1e-4)


# ---------------------------------------------------------------------------
# Combine resolution
# ---------------------------------------------------------------------------

COMBINES = ("auto", "psum", "reduce_scatter", "allgather")
STRATEGIES = ("segment", "blocked", "sharded", "grid", "dense")


def _outcome(fn, *args, **kw):
    try:
        return fn(*args, **kw)
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_resolve_combine_agrees_with_reference(strategy):
    for combine in COMBINES:
        assert _outcome(P_cpapr.resolve_combine, combine, strategy) == \
            _outcome(R_cpapr.resolve_combine, combine, strategy)


@pytest.mark.parametrize("kind", FIXTURES)
def test_effective_mode_combine_agrees_with_reference(kind):
    for n_shards in SHARDS:
        for mode in MODES:
            ref, port = problem(kind, mode, n_shards)
            for combine in COMBINES:
                for strategy in ("segment", "blocked", "sharded"):
                    for which in ("sl", "base", None):
                        for isz in (2, 4, 8):
                            got = _outcome(
                                P_cpapr.effective_mode_combine, combine,
                                strategy, port.get(which), RANK,
                                itemsize=isz)
                            want = _outcome(
                                R_cpapr.effective_mode_combine, combine,
                                strategy, ref.get(which), RANK,
                                itemsize=isz)
                            assert got == want, (combine, strategy, which)


def test_grid_still_raises_before_running():
    """The N-D grid is the next slice: its strategy, its config field and
    its checkpoint raise NotPortedError naming ROADMAP A8b."""
    _, (pt, pkt) = tensors("uniform")
    with pytest.raises(NotPortedError, match="A8b"):
        P_phi.canonical_strategy("grid")
    for kw in (dict(strategy="grid"), dict(grid_shape=(2, 2))):
        with pytest.raises(NotPortedError, match="A8b"):
            P_cpapr.cpapr_mu(pt, RANK, init=pkt, device="cpu",
                             config=P_cpapr.CPAPRConfig(rank=RANK, **kw))
    with pytest.raises(NotPortedError, match="A8b"):
        P_cpals.cp_als(pt, RANK, n_iters=1, init=pkt, strategy="grid",
                       device="cpu")
