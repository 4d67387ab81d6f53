"""The port's N-D device-grid tier against the JAX package, on the CPU.

The conformance fixtures (uniform, hub, empty-row) go to both packages
as numpy, and every result is held to ``TOL``:

  * ``GridLayout`` (every field, ``masks()``, ``shard_masks()``) is
    array-equal to the reference's ``build_grid_layout`` on every fixture
    mode in the shapes (1, 1), (1, 2), (2, 1), (2, 2), (1, 4) and (4, 1);
    ``choose_grid_shape`` and ``grid_factor_pairs`` equal the reference's,
    and ``build_grid_layout`` refuses what the reference refuses;
  * the conformance registry's ``grid`` row: Φ, MTTKRP and the fused MU
    step with ``strategy="grid"`` against the reference's; an S x 1 grid
    is bitwise the port's own 1-D sharded path; an all-hub mode with
    empty cells meets the dense f64 oracle;
  * ``cpapr_mu`` and ``cp_als`` with ``strategy="grid"`` match the
    reference's factors, λ and histories with equal inner counts;
  * the runtime: the grid rungs of the reference's recovery matrix land
    on the dense f64 KKT oracle, killed and resumed grid solves are
    bitwise the uninterrupted ones, grid checkpoints resume across the
    two packages both ways, and the ``/grid=AxB`` autotune keys are the
    reference's strings.

The ``local_strategy="cuda"`` rows run the kernel wrappers' plain versions
here (``tests/test_torch_cuda.py`` runs B2/B3 per cell on the card).  The
mesh path over several ranks is ``tests/test_torch_grid_dist.py``.
"""
import functools

import numpy as np
import pytest
import torch

from repro.core import cpals as R_cpals
from repro.core import cpapr as R_cpapr
from repro.core import distributed as R_dist
from repro.core import layout as R_layout
from repro.core import phi as R_phi
from repro.core import pi as R_pi
from repro.core.policy import PhiPolicy as RPolicy
from repro.core.sparse_tensor import sort_mode as r_sort_mode
from repro.perf import autotune as R_at

from repro_torch.core import cpals as P_cpals
from repro_torch.core import cpapr as P_cpapr
from repro_torch.core import distributed as P_dist
from repro_torch.core import layout as P_layout
from repro_torch.core import phi as P_phi
from repro_torch.core import pi as P_pi
from repro_torch.core import resilience
from repro_torch.core.convert import ktensor_from_numpy, sparse_tensor_from_numpy
from repro_torch.core.policy import PhiPolicy as PPolicy
from repro_torch.core.sparse_tensor import sort_mode as p_sort_mode
from repro_torch.perf import autotune as P_at
from repro_torch.testing import faults

from conftest import dense_phi_reference
from test_conformance import BN, BR, FIXTURES, RANK, TOL, make_fixture

MODES = (0, 1, 2)
SHAPES = ((1, 1), (1, 2), (2, 1), (2, 2), (1, 4), (4, 1))
MU_TOL = 1e-4
GRID_FIELDS = ("grid_a", "grid_b", "n_grid_cell", "sub_rows",
               "own_rows_pad", "stack_rows", "cell_nnz", "gather", "valid",
               "local_rows", "grid_rb", "pad_fraction", "n_shards",
               "block_nnz", "block_rows", "n_rows", "n_rb_shard")
PB = PPolicy(strategy="blocked", block_nnz=BN, block_rows=BR)
RB = RPolicy(strategy="blocked", block_nnz=BN, block_rows=BR)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The solves here are thousands of small CPU ops: one intra-op thread
    keeps them from contending with the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
def problem(kind: str, mode: int):
    """Both packages' inputs of one fixture mode: (ref dict, port dict),
    each with its mode view, Π rows, B and base blocked layout."""
    (t, kt), (pt, pkt) = tensors(kind)
    rmv, pmv = r_sort_mode(t, mode), p_sort_mode(pt, mode)
    ref = dict(mv=rmv, pi=R_pi.pi_rows(rmv.sorted_idx, kt.factors, mode),
               b=kt.factors[mode] * kt.lam[None, :],
               base=R_layout.build_blocked_layout(np.asarray(rmv.rows),
                                                  rmv.n_rows, BN, BR))
    port = dict(mv=pmv, pi=P_pi.pi_rows(pmv.sorted_idx, pkt.factors, mode),
                b=pkt.factors[mode] * pkt.lam[None, :],
                base=P_layout.build_blocked_layout(pmv.rows.numpy(),
                                                   pmv.n_rows, BN, BR))
    return ref, port


@functools.lru_cache(maxsize=None)
def grids(kind: str, mode: int, shape: tuple):
    """(reference GridLayout, port GridLayout) of one fixture mode."""
    ref, port = problem(kind, mode)
    return (R_layout.build_grid_layout(ref["base"], shape),
            P_layout.build_grid_layout(port["base"], shape))


def _run(mod, d, g, op: str, **kw):
    """One grid op through one package's entry point."""
    mv = d["mv"]
    kw = dict(strategy="grid", layout=g, **kw)
    if op == "phi":
        return mod.phi_from_rows(mv.rows, mv.sorted_vals, d["pi"], d["b"],
                                 mv.n_rows, **kw)
    if op == "mttkrp":
        return mod.krao_reduce_rows(mv.rows, mv.sorted_vals, d["pi"],
                                    mv.n_rows, **kw)
    return mod.phi_mu_step(mv.rows, mv.sorted_vals, d["pi"], d["b"],
                           mv.n_rows, tol=MU_TOL, **kw)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# Grid structures: array-equal to the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", FIXTURES)
def test_grid_layout_equals_reference(kind, shape):
    for mode in MODES:
        rg, pg = grids(kind, mode, shape)
        for f in GRID_FIELDS:
            np.testing.assert_array_equal(getattr(pg, f), getattr(rg, f),
                                          err_msg=f"{kind} {mode} {f}")
        np.testing.assert_array_equal(pg.masks(), rg.masks())
        np.testing.assert_array_equal(pg.shard_masks(), rg.shard_masks())
        np.testing.assert_array_equal(pg.slayout.rb_start,
                                      rg.slayout.rb_start)
        assert P_dist.grid_scatter_wire_bytes(pg, RANK) == \
            R_dist.grid_scatter_wire_bytes(rg, RANK)
        # every cell visits each of its shard's row blocks in order
        assert np.all(np.diff(pg.grid_rb, axis=1) >= 0)
        for f in range(pg.n_shards):
            assert set(pg.grid_rb[f]) == set(range(pg.n_rb_shard))
        assert int(pg.cell_nnz.sum()) == problem(kind, mode)[1]["mv"].nnz


def _error(fn, *args):
    try:
        fn(*args)
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("kind", FIXTURES)
def test_build_grid_layout_refuses_what_the_reference_refuses(kind):
    ref, port = problem(kind, 0)
    for shape in ((0, 1), (1, 0), (64, 1), (1, 10_000), (3, 5)):
        want = _error(R_layout.build_grid_layout, ref["base"], shape)
        got = _error(P_layout.build_grid_layout, port["base"], shape)
        assert got == want, shape
    assert _error(P_layout.build_grid_layout, port["base"], (1, 10_000))


@pytest.mark.parametrize("n_shards", (1, 2, 4, 6))
def test_choose_grid_shape_equals_reference(n_shards):
    for s in range(1, 13):
        assert P_layout.grid_factor_pairs(s) == R_layout.grid_factor_pairs(s)
    for kind in FIXTURES:
        for mode in MODES:
            ref, port = problem(kind, mode)
            rows = np.asarray(ref["mv"].rows)
            n_rows = ref["mv"].n_rows
            stats = (None, None), (P_layout.mode_run_stats(rows, n_rows),
                                   R_layout.mode_run_stats(rows, n_rows))
            for ps, rs in stats:
                for br in (4, 8, 64, 256):
                    for itemsize in (2, 4, 8):
                        args = (n_rows, br, RANK, n_shards)
                        assert P_layout.choose_grid_shape(
                            *args, stats=ps, itemsize=itemsize) == \
                            R_layout.choose_grid_shape(
                                *args, stats=rs, itemsize=itemsize), \
                            (kind, mode, br, itemsize)
    # a hub mode takes the column split the uniform one declines
    hub = P_layout.mode_run_stats(np.zeros(1000, np.int32), 64)
    assert P_layout.choose_grid_shape(64, 4, RANK, 4, stats=hub) == (2, 2)
    assert P_layout.choose_grid_shape(64, 4, RANK, 4) == (4, 1)


# ---------------------------------------------------------------------------
# The grid ops against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", ("phi", "mttkrp", "mu"))
@pytest.mark.parametrize("kind", FIXTURES)
def test_grid_ops_match_reference(kind, op):
    """The conformance registry's ``grid`` row: every mode at (2, 2) and
    (1, 4), both local flavours of the port against the reference's
    blocked cells."""
    for mode in MODES:
        ref, port = problem(kind, mode)
        for shape in ((2, 2), (1, 4)):
            rg, pg = grids(kind, mode, shape)
            want = _run(R_phi, ref, rg, op)
            for local in ("blocked", "cuda"):
                got = _run(P_phi, port, pg, op, device="cpu",
                           local_strategy=local)
                if op == "mu":
                    np.testing.assert_allclose(float(got[1]),
                                               float(want[1]), **TOL)
                    got, want_b = got[0], want[0]
                else:
                    want_b = want
                np.testing.assert_allclose(
                    _np(got), _np(want_b), **TOL,
                    err_msg=f"{op} {kind} {mode} {shape} {local}")


def test_grid_sx1_bitwise_matches_1d_sharded():
    """An S x 1 grid's cells are the 1-D shards and both column
    collectives are the identity: Φ and the fused step are bitwise the
    port's 1-D sharded reduce-scatter path on every fixture."""
    for kind in FIXTURES:
        _, port = problem(kind, 0)
        mv, pi, b = port["mv"], port["pi"], port["b"]
        sl = P_layout.shard_blocked_layout(port["base"], 4)
        g = P_layout.build_grid_layout(port["base"], (4, 1))
        kw = dict(device="cpu")
        ref = P_phi.phi_from_rows(mv.rows, mv.sorted_vals, pi, b, mv.n_rows,
                                  strategy="sharded", layout=sl,
                                  combine="reduce_scatter", **kw)
        out = P_phi.phi_from_rows(mv.rows, mv.sorted_vals, pi, b, mv.n_rows,
                                  strategy="grid", layout=g, **kw)
        np.testing.assert_array_equal(ref.numpy(), out.numpy(),
                                      err_msg=f"phi {kind}")
        bs_r, vs_r = P_phi.phi_mu_step(mv.rows, mv.sorted_vals, pi, b,
                                       mv.n_rows, strategy="sharded",
                                       layout=sl, combine="reduce_scatter",
                                       **kw)
        bs_g, vs_g = P_phi.phi_mu_step(mv.rows, mv.sorted_vals, pi, b,
                                       mv.n_rows, strategy="grid", layout=g,
                                       **kw)
        assert float(vs_r) == float(vs_g), kind
        np.testing.assert_array_equal(bs_r.numpy(), bs_g.numpy(),
                                      err_msg=f"mu {kind}")


def _oracle_checks(mv, pi, b, g, **kw):
    """Φ, MTTKRP and the fused step of one grid layout against the dense
    f64 oracle."""
    rows, vals = mv.rows.numpy(), mv.sorted_vals.numpy()
    phi_ref = dense_phi_reference(rows, vals, pi.numpy(), b.numpy(),
                                  mv.n_rows)
    mt_ref = np.zeros((mv.n_rows, pi.shape[1]))
    np.add.at(mt_ref, rows, vals.astype(np.float64)[:, None]
              * pi.numpy().astype(np.float64))
    kw = dict(strategy="grid", layout=g, device="cpu", **kw)
    phi = P_phi.phi_from_rows(mv.rows, mv.sorted_vals, pi, b, mv.n_rows, **kw)
    np.testing.assert_allclose(phi.numpy(), phi_ref, **TOL)
    mt = P_phi.krao_reduce_rows(mv.rows, mv.sorted_vals, pi, mv.n_rows, **kw)
    np.testing.assert_allclose(mt.numpy(), mt_ref, **TOL)
    bs, vs = P_phi.phi_mu_step(mv.rows, mv.sorted_vals, pi, b, mv.n_rows,
                               tol=MU_TOL, **kw)
    b64 = b.numpy().astype(np.float64)
    viol_ref = np.max(np.abs(np.minimum(b64, 1.0 - phi_ref)))
    b_ref = b64 * phi_ref if viol_ref > MU_TOL else b64
    np.testing.assert_allclose(float(vs), viol_ref, **TOL)
    np.testing.assert_allclose(bs.numpy(), b_ref, **TOL)


@functools.lru_cache(maxsize=None)
def allhub_problem():
    """The reference's all-hub mode: every nonzero in row 0, so under a
    row split one shard owns every nonzero and the other shard's cells
    hold only padding."""
    shape = (32, 12, 10)
    rng = np.random.RandomState(5)
    idx = np.stack([rng.randint(0, s, size=600) for s in shape], axis=1)
    idx[:, 0] = 0
    vals = rng.poisson(2.0, size=600).astype(np.float32) + 1.0
    t = sparse_tensor_from_numpy(shape, idx, vals, device="cpu")
    factors = [np.random.RandomState(17 + m).rand(s, RANK)
               .astype(np.float32) for m, s in enumerate(shape)]
    kt = ktensor_from_numpy(np.ones(RANK, np.float32), factors, "cpu")
    mv = p_sort_mode(t, 0)
    pi = P_pi.pi_rows(mv.sorted_idx, kt.factors, 0)
    b = kt.factors[0] * kt.lam[None, :]
    base = P_layout.build_blocked_layout(mv.rows.numpy(), mv.n_rows, BN, BR)
    return mv, pi, b, base


@pytest.mark.parametrize("local", ("blocked", "cuda"))
def test_grid_allhub_mode_with_empty_cells_vs_oracle(local):
    mv, pi, b, base = allhub_problem()
    for shape in ((2, 2), (1, 2)):
        g = P_layout.build_grid_layout(base, shape)
        if shape[0] > 1:
            assert int(np.min(g.cell_nnz)) == 0, (shape, g.cell_nnz)
        _oracle_checks(mv, pi, b, g, local_strategy=local)


def test_grid_padding_rows_come_back_zero():
    """Every cell's window is exactly zero past its shard's real rows,
    and the stacked forms are zero on masked rows: the invariant the
    owner-local epilogue relies on."""
    from repro_torch.core.distributed import _shard_window

    _, port = problem("empty_row", 0)
    g = P_layout.build_grid_layout(port["base"], (2, 2))
    vals_cs, pi_cs = P_phi.expand_to_grid(g, port["mv"].sorted_vals,
                                          port["pi"])
    st = g.on("cpu")
    smask = g.shard_masks()
    b_own = P_dist.grid_stack(g, port["b"])
    assert bool((b_own[~torch.as_tensor(g.masks())] == 0).all())
    own = g.slayout.n_rb_shard * g.block_rows
    for f in range(g.n_shards):
        s = f // g.grid_b
        b_win = b_own[s * g.grid_b:(s + 1) * g.grid_b].reshape(
            g.own_rows_pad, -1)[:own]
        for b_arg in (b_win, None):
            w = _shard_window(g.slayout, 1e-10, "cuda", vals_cs[f], pi_cs[f],
                              st.local_rows[f], st.grid_rb[f], b_arg)
            real = int(g.slayout.rb_count[s]) * g.block_rows
            assert bool((w[real:] == 0).all()), f
            assert bool((w[~torch.as_tensor(smask[f])] == 0).all()), f
    full = P_dist.grid_unstack(g, P_dist.grid_stack(g, port["b"]))
    np.testing.assert_array_equal(full.numpy(), port["b"].numpy())


def test_resolve_grid_default_layout_and_fallback(monkeypatch):
    """Without a layout the grid is built at the default shard count (one
    on the CPU: a 1 x 1 grid, the reference's own answer); a grid the mode
    cannot honour warns and runs the local strategy unsharded."""
    ref, port = problem("uniform", 0)
    mv, pi, b = port["mv"], port["pi"], port["b"]
    got = P_phi.phi_from_rows(mv.rows, mv.sorted_vals, pi, b, mv.n_rows,
                              strategy="grid", device="cpu")
    rmv = ref["mv"]
    want = R_phi.phi_from_rows(rmv.rows, rmv.sorted_vals, ref["pi"],
                               ref["b"], rmv.n_rows, strategy="grid")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    monkeypatch.setattr(P_phi, "_default_shard_count",
                        lambda mesh, device: 4096)
    phi_ref = dense_phi_reference(mv.rows.numpy(), mv.sorted_vals.numpy(),
                                  pi.numpy(), b.numpy(), mv.n_rows)
    with pytest.warns(UserWarning, match="falling back"):
        out = P_phi.phi_from_rows(mv.rows, mv.sorted_vals, pi, b, mv.n_rows,
                                  strategy="grid", device="cpu")
    np.testing.assert_allclose(out.numpy(), phi_ref, **TOL)
    with pytest.raises(ValueError, match="pi_gather"):
        P_phi.phi_from_rows(mv.rows, mv.sorted_vals, pi, b, mv.n_rows,
                            strategy="grid", pi_gather=object(),
                            device="cpu")
    with pytest.raises(ValueError, match="perturb"):
        P_phi.phi_from_rows(mv.rows, mv.sorted_vals, pi, b, mv.n_rows,
                            strategy="grid", perturb="no_conflict",
                            device="cpu")
    with pytest.raises(TypeError, match="GridLayout"):
        P_phi.phi_from_rows(mv.rows, mv.sorted_vals, pi, b, mv.n_rows,
                            strategy="grid", layout=port["base"],
                            device="cpu")


# ---------------------------------------------------------------------------
# The solvers
# ---------------------------------------------------------------------------

GRID_SOLVES = {"2x2": (2, 2), "chosen": None}


@functools.lru_cache(maxsize=None)
def reference_cpapr(kind: str, case: str, local: str = "blocked"):
    (t, kt), _ = tensors(kind)
    cfg = R_cpapr.CPAPRConfig(
        rank=RANK, max_outer=4, strategy="grid", n_shards=4,
        grid_shape=GRID_SOLVES[case],
        policy=RPolicy(strategy=local, block_nnz=BN, block_rows=BR))
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


@pytest.mark.parametrize("case", tuple(GRID_SOLVES))
@pytest.mark.parametrize("kind", FIXTURES)
def test_cpapr_grid_matches_reference(kind, case):
    want = reference_cpapr(kind, case)
    _, (pt, pkt) = tensors(kind)
    cfg = P_cpapr.CPAPRConfig(rank=RANK, max_outer=4, strategy="grid",
                              n_shards=4, grid_shape=GRID_SOLVES[case],
                              policy=PB)
    got = P_cpapr.cpapr_mu(pt, RANK, init=pkt, config=cfg, device="cpu")
    _assert_solve_matches(got, want)
    ll = got.loglik_history
    assert all(b >= a - 1e-6 * abs(a) for a, b in zip(ll, ll[1:]))


def test_cpapr_grid_cuda_local_matches_reference_pallas():
    """The ``cuda`` cell-local flavour (its plain version on the CPU)
    against the reference's ``pallas`` cells in interpret mode."""
    want = reference_cpapr("hub", "2x2", "pallas")
    _, (pt, pkt) = tensors("hub")
    cfg = P_cpapr.CPAPRConfig(
        rank=RANK, max_outer=4, strategy="grid", n_shards=4,
        grid_shape=(2, 2),
        policy=PPolicy(strategy="cuda", block_nnz=BN, block_rows=BR))
    _assert_solve_matches(P_cpapr.cpapr_mu(pt, RANK, init=pkt, config=cfg,
                                           device="cpu"), want)


def test_resolve_mode_policies_picks_the_references_grids():
    """Per-mode shapes and strategies from ``grid_shape=None`` and the
    warned fallback of a grid the blocking cannot honour."""
    import warnings

    for kind in FIXTURES:
        (t, kt), (pt, pkt) = tensors(kind)
        rmvs = [r_sort_mode(t, n) for n in range(3)]
        pmvs = [p_sort_mode(pt, n) for n in range(3)]
        for n_shards, gs, pol in ((4, None, PB), (6, None, PB),
                                  (4, (8, 1), PB), (2, (1, 2), None)):
            rpol = None if pol is None else RB
            with warnings.catch_warnings(record=True) as rw:
                warnings.simplefilter("always")
                rs, rl, _, rloc = R_cpapr.resolve_mode_policies(
                    rmvs, kt.factors, kt.lam, rank=RANK, strategy="grid",
                    policy=rpol, n_shards=n_shards, grid_shape=gs)
            with warnings.catch_warnings(record=True) as pw:
                warnings.simplefilter("always")
                ps, pl, _, ploc = P_cpapr.resolve_mode_policies(
                    pmvs, rank=RANK, strategy="grid", policy=pol,
                    n_shards=n_shards, grid_shape=gs, shape=pt.shape,
                    factors=pkt.factors, lam=pkt.lam, device="cpu")
            assert ps == rs and ploc == rloc, (kind, n_shards, gs)
            assert len(pw) == len(rw)
            for a, b in zip(pl, rl):
                assert type(a).__name__ == type(b).__name__
                if isinstance(a, P_layout.GridLayout):
                    assert (a.grid_a, a.grid_b) == (b.grid_a, b.grid_b)
                    np.testing.assert_array_equal(a.gather, b.gather)


@pytest.mark.parametrize("kind", FIXTURES)
def test_cp_als_grid_matches_reference(kind):
    (t, kt), (pt, pkt) = tensors(kind)
    wk, wf = R_cpals.cp_als(t, RANK, n_iters=3, init=kt, strategy="grid",
                            n_shards=4, policy=RB)
    gk, gf = P_cpals.cp_als(pt, RANK, n_iters=3, init=pkt, strategy="grid",
                            n_shards=4, policy=PB, device="cpu")
    np.testing.assert_allclose(gf, wf, **TOL)
    np.testing.assert_allclose(gk.lam.numpy(), np.asarray(wk.lam), **TOL)
    for a, b in zip(gk.factors, wk.factors):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


# ---------------------------------------------------------------------------
# The runtime: rungs, checkpoints, autotune keys
# ---------------------------------------------------------------------------

# the reference's recovery rows for the grid (tests/test_conformance.py)
RECOVERY = {
    "oom-demote-grid": (lambda: faults.fail_oom(min_shards=3), "demote_oom"),
    "kernel-demote-grid": (lambda: faults.fail_strategy(strategy="grid"),
                           "demote_kernel"),
}


def _dense_kkt(kt) -> float:
    """Worst per-mode KKT violation of a port KTensor on the uniform
    fixture, dense f64 oracle."""
    _, (pt, _) = tensors("uniform")
    worst = 0.0
    for n in range(pt.ndim):
        mv = p_sort_mode(pt, n)
        pi = P_pi.pi_rows(mv.sorted_idx, kt.factors, n)
        b = (kt.factors[n] * kt.lam[None, :]).numpy().astype(np.float64)
        phi = dense_phi_reference(mv.rows.numpy(), mv.sorted_vals.numpy(),
                                  pi.numpy(), b, mv.n_rows)
        worst = max(worst, float(np.max(np.abs(np.minimum(b, 1.0 - phi)))))
    return worst


@pytest.mark.parametrize("name", sorted(RECOVERY))
def test_grid_recovery_paths_meet_dense_oracle(name):
    fault, kind = RECOVERY[name]
    _, (pt, pkt) = tensors("uniform")
    base = dict(rank=RANK, max_outer=5, track_loglik=False, strategy="grid",
                n_shards=4, grid_shape=(2, 2), policy=PB)
    clean = P_cpapr.cpapr_mu(pt, RANK, init=pkt, device="cpu",
                             config=P_cpapr.CPAPRConfig(**base))
    with fault():
        rec = P_cpapr.cpapr_mu(pt, RANK, init=pkt, device="cpu",
                               config=P_cpapr.CPAPRConfig(max_demotions=4,
                                                          **base))
    kinds = [e.kind for e in rec.recoveries or []]
    assert kind in kinds, (name, kinds)
    assert _dense_kkt(rec.ktensor) <= _dense_kkt(clean.ktensor) * 1.05 + 1e-4


def test_grid_rungs_record_their_actions():
    """A kernel failure demotes the cell-local cuda -> blocked, then the
    grid to its A-shard 1-D split; an OOM takes the grid rung at once and
    then halves the shards; a single-row-shard grid goes to the
    single-device local path.  The ladder is off by default."""
    _, (pt, pkt) = tensors("uniform")

    def actions(cfg, *cms):
        for cm in cms:
            cm.__enter__()
        try:
            res = P_cpapr.cpapr_mu(
                pt, RANK, init=pkt, device="cpu",
                config=P_cpapr.CPAPRConfig(rank=RANK, max_outer=2,
                                           max_demotions=4, strategy="grid",
                                           n_shards=4, **cfg))
        finally:
            for cm in reversed(cms):
                cm.__exit__(None, None, None)
        return [(e.kind, e.mode, e.detail["action"]) for e in res.recoveries]

    pc = PPolicy(strategy="cuda", block_nnz=BN, block_rows=BR)
    assert actions(dict(grid_shape=(2, 2), policy=pc),
                   faults.fail_strategy(strategy="grid", mode=0, times=2)) \
        == [("demote_kernel", 0, "local cuda->blocked"),
            ("demote_kernel", 0, "grid 2x2->sharded@2")]
    assert actions(dict(grid_shape=(2, 2), policy=PB),
                   faults.fail_oom(mode=1, min_shards=2)) == [
        ("demote_oom", 1, "grid 2x2->sharded@2"),
        ("demote_oom", 1, "sharded@2->single-device blocked")]
    assert actions(dict(grid_shape=(1, 4), policy=pc),
                   faults.fail_oom(mode=2, min_shards=2)) == [
        ("demote_oom", 2, "grid 1x4->single-device cuda")]
    with pytest.raises(RuntimeError, match="simulated kernel"):
        with faults.fail_strategy(strategy="grid"):
            P_cpapr.cpapr_mu(pt, RANK, init=pkt, device="cpu",
                             config=P_cpapr.CPAPRConfig(
                                 rank=RANK, max_outer=1, strategy="grid",
                                 n_shards=4, grid_shape=(2, 2), policy=PB))


def test_grid_mode_hooks_see_the_grid():
    """Fault hooks get the mode's grid and its cell count."""
    _, (pt, pkt) = tensors("hub")
    seen = []
    resilience.register_mode_hook(seen.append)
    try:
        P_cpapr.cpapr_mu(pt, RANK, init=pkt, device="cpu",
                         config=P_cpapr.CPAPRConfig(
                             rank=RANK, max_outer=1, strategy="grid",
                             n_shards=4, grid_shape=(2, 2), policy=PB))
    finally:
        resilience.unregister_mode_hook(seen.append)
    assert [(c["strategy"], c["grid"], c["n_shards"], c["local"])
            for c in seen] == [("grid", (2, 2), 4, "blocked")] * 3


def _ck_cfg(ck, **kw):
    base = dict(rank=RANK, max_outer=6, tol=0.0, strategy="grid", n_shards=4,
                policy=PB, checkpoint_every=2, checkpoint_path=ck)
    base.update(kw)
    return P_cpapr.CPAPRConfig(**base)


def _bits(x: torch.Tensor) -> np.ndarray:
    return x.view(torch.int32).numpy()


# the reference's kill-and-resume grid rows (tests/test_faults.py)
RESUME_TIERS = {
    "grid-2x2": dict(grid_shape=(2, 2), combine="reduce_scatter"),
    "grid-4x1": dict(grid_shape=(4, 1), combine="auto"),
}


@pytest.mark.parametrize("tier", sorted(RESUME_TIERS))
def test_grid_kill_and_resume_is_bitwise(tmp_path, tier):
    _, (pt, pkt) = tensors("uniform")
    kw = RESUME_TIERS[tier]
    ck = str(tmp_path / "ck.bin")

    def solve(cfg, **extra):
        return P_cpapr.cpapr_mu(pt, RANK, init=pkt, config=cfg, device="cpu",
                                **extra)

    ref = solve(_ck_cfg(None, checkpoint_every=0, **kw))
    with pytest.raises(faults.KilledError):
        with faults.kill_at_sweep(5):
            solve(_ck_cfg(ck, **kw))
    state = resilience.load_checkpoint(ck)
    assert state["mode_grids"] == [list(kw["grid_shape"])] * 3
    assert state["strategies"] == ["grid"] * 3
    res = solve(_ck_cfg(ck, **kw), resume_from=ck)
    assert res.n_outer == ref.n_outer
    for a, b in zip(ref.ktensor.factors, res.ktensor.factors):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    np.testing.assert_array_equal(_bits(ref.ktensor.lam),
                                  _bits(res.ktensor.lam))
    assert ref.kkt_history == res.kkt_history
    assert ref.loglik_history == res.loglik_history
    assert ref.inner_iters == res.inner_iters
    assert [e.kind for e in res.recoveries] == ["resume"]


def _rcfg(ck, **kw):
    base = dict(rank=RANK, max_outer=6, tol=0.0, strategy="grid", n_shards=4,
                grid_shape=(2, 2), policy=RB, checkpoint_every=2,
                checkpoint_path=ck)
    base.update(kw)
    return R_cpapr.CPAPRConfig(**base)


def _close_to(res, want):
    assert res.n_outer == want.n_outer
    assert list(res.inner_iters) == list(want.inner_iters)
    np.testing.assert_allclose(res.loglik_history, want.loglik_history,
                               **TOL)
    for a, b in zip(res.ktensor.factors, want.ktensor.factors):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **TOL)


def test_grid_checkpoint_resumes_across_the_packages(tmp_path):
    """A grid checkpoint written by the port resumes in the reference, and
    one written by the reference resumes in the port, both landing on the
    other package's uninterrupted solve."""
    (t, kt), (pt, pkt) = tensors("uniform")
    ck_p, ck_r = str(tmp_path / "port.bin"), str(tmp_path / "ref.bin")
    want = R_cpapr.cpapr_mu(t, RANK, init=kt,
                            config=_rcfg(None, checkpoint_every=0))
    P_cpapr.cpapr_mu(pt, RANK, init=pkt, device="cpu",
                     config=_ck_cfg(ck_p, max_outer=4, grid_shape=(2, 2)))
    res = R_cpapr.cpapr_mu(t, RANK, init=kt, config=_rcfg(ck_p),
                           resume_from=ck_p)
    assert [e.kind for e in res.recoveries] == ["resume"]
    _close_to(res, want)
    R_cpapr.cpapr_mu(t, RANK, init=kt, config=_rcfg(ck_r, max_outer=4))
    assert resilience.load_checkpoint(ck_r)["mode_grids"] == [[2, 2]] * 3
    got = P_cpapr.cpapr_mu(pt, RANK, init=pkt, device="cpu",
                           config=_ck_cfg(ck_r, grid_shape=(2, 2)),
                           resume_from=ck_r)
    assert [e.kind for e in got.recoveries] == ["resume"]
    _close_to(got, want)


def test_grid_checkpoint_without_its_shape_is_refused(tmp_path):
    """A checkpoint naming a grid mode without its ``mode_grids`` entry
    cannot rebuild the cell schedule: the port says so, as the reference
    does, and does not resume some other schedule."""
    _, (pt, pkt) = tensors("uniform")
    ck = str(tmp_path / "ck.bin")
    cfg = _ck_cfg(ck, max_outer=2, grid_shape=(2, 2))
    P_cpapr.cpapr_mu(pt, RANK, init=pkt, device="cpu", config=cfg)
    state = resilience.load_checkpoint(ck)
    state["mode_grids"] = [None, [2, 2], [2, 2]]
    resilience.save_checkpoint(ck, state)
    with pytest.raises(resilience.CheckpointError, match="mode_grids"):
        P_cpapr.cpapr_mu(pt, RANK, init=pkt, device="cpu", config=cfg,
                         resume_from=ck)


def test_heuristic_fallback_never_served_as_grid(tmp_path):
    """The reference's inf-probe case: a heuristic placeholder (nothing
    measured) is stored with seconds None and source 'heuristic' and does
    not satisfy a source='grid' lookup; and the /grid=AxB key dimension
    is the reference's string for every grid shape."""
    import json

    path = str(tmp_path / "cache.json")
    c = P_at.AutotuneCache(path)
    c.store("k0", PPolicy(strategy="segment"), float("inf"), "heuristic")
    assert c.lookup("k0", source="grid") is None
    assert c.lookup("k0") is not None
    assert json.load(open(path))["entries"]["k0"]["seconds"] is None
    rows = np.repeat(np.arange(50, dtype=np.int32), 20)
    stats = P_layout.mode_run_stats(rows, 50)
    rstats = R_layout.mode_run_stats(rows, 50)
    for n_shards in (None, 1, 2, 4):
        for grid in (None, (1, 4), (2, 2), (4, 1), (2, 3)):
            for st, rst in ((None, None), (stats, rstats)):
                for combine in (None, "reduce_scatter"):
                    kw = dict(n_shards=n_shards, grid=grid, combine=combine)
                    assert P_at.policy_key(1000, 50, 8, "cuda", stats=st,
                                           **kw) == \
                        R_at.policy_key(1000, 50, 8, "cuda", stats=rst, **kw)
    assert P_at.policy_key(1000, 50, 8, "cuda", n_shards=2,
                           grid=(2, 2)).endswith("/shards=2/grid=2x2")


def test_grid_tuning_keys_equal_reference(tmp_path):
    """``policy="auto"`` on grid modes: the non-measuring tuners of both
    packages store the same keys, ``/grid=AxB`` on the modes whose
    chosen grid has more than one column and more than one row shard."""
    (t, kt), (pt, pkt) = tensors("hub")
    rt = R_at.Autotuner(cache_path=str(tmp_path / "r.json"), measure=False,
                        platform="cpu")
    pt_ = P_at.Autotuner(cache_path=str(tmp_path / "p.json"), measure=False,
                         platform="cpu")
    R_cpapr.cpapr_mu(t, RANK, init=kt, config=R_cpapr.CPAPRConfig(
        rank=RANK, max_outer=1, strategy="grid", n_shards=4,
        grid_shape=(2, 2), policy="auto", autotuner=rt))
    P_cpapr.cpapr_mu(pt, RANK, init=pkt, device="cpu",
                     config=P_cpapr.CPAPRConfig(
                         rank=RANK, max_outer=1, strategy="grid", n_shards=4,
                         grid_shape=(2, 2), policy="auto", autotuner=pt_))
    keys = sorted(pt_.cache.entries)
    assert keys == sorted(rt.cache.entries)
    assert keys and all(k.endswith("/grid=2x2") for k in keys)


def test_grid_runs_without_a_card_only_on_request(monkeypatch):
    """The grid's entry points default to the card: without one they
    raise unless the caller asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, port = problem("uniform", 0)
    mv = port["mv"]
    g = grids("uniform", 0, (2, 2))[1]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P_phi.phi_from_rows(mv.rows, mv.sorted_vals, port["pi"], port["b"],
                            mv.n_rows, strategy="grid", layout=g)
    _, (pt, pkt) = tensors("uniform")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P_cpapr.cpapr_mu(pt, RANK, init=pkt, config=P_cpapr.CPAPRConfig(
            rank=RANK, strategy="grid", grid_shape=(2, 2)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P_cpals.cp_als(pt, RANK, n_iters=1, init=pkt, strategy="grid")
