"""The dense matrix-free tier of the port against the JAX package.

The same inputs (the conformance fixtures, converted from numpy) go
through the reference's dense tier, whose Pallas kernels run in interpret
mode here as in its own tests, and the port's (the dense kernel wrappers'
plain versions on CPU tensors): the densified (K, I, J) tensor, the three
dense operations in f32 at ``TOL`` and bf16 at ``TOL_BF16``, and the
``strategy="dense"`` CP-APR and CP-ALS solves from the same ``init``.

The CUDA kernels themselves are held against these plain versions on the
card by ``tests/test_torch_cuda.py``.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cpals as R_cpals
from repro.core import cpapr as R_cpapr
from repro.core import dense as R_dense
from repro.core import phi as R_phi
from repro.core.sparse_tensor import sort_mode as r_sort_mode

from repro_torch.core import cpals as P_cpals
from repro_torch.core import cpapr as P_cpapr
from repro_torch.core import dense as P_dense
from repro_torch.core import phi as P_phi
from repro_torch.core.convert import (
    dense_mode_from_numpy,
    ktensor_from_numpy,
    sparse_tensor_from_numpy,
)
from repro_torch.core.policy import PhiPolicy as PPolicy
from repro_torch.core.sparse_tensor import sort_mode as p_sort_mode
from repro_torch.data.tensors import make_near_dense
from repro_torch.kernels._checks import MAX_RANK, SMEM_LIMIT
from repro_torch.kernels.dense import kernel as P_kernel
from repro_torch.kernels.dense import ops as P_ops

from test_conformance import FIXTURES, RANK, TOL, TOL_BF16, make_fixture

MODES = (0, 1, 2)
OPS = ("phi", "mu", "mttkrp")
MU_TOL = 1e-4
MAX_OUTER = 3
ALS_ITERS = 3
DTYPES = {"float32": (jnp.float32, torch.float32, TOL),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, TOL_BF16)}


@functools.lru_cache(maxsize=None)
def port_problem(kind: str):
    t, kt = make_fixture(kind)
    pt = sparse_tensor_from_numpy(t.shape, np.asarray(t.indices),
                                  np.asarray(t.values), device="cpu")
    pkt = ktensor_from_numpy(np.asarray(kt.lam),
                             [np.asarray(f) for f in kt.factors], "cpu")
    return pt, pkt


@functools.lru_cache(maxsize=None)
def dense_problem(kind: str, mode: int):
    """(reference DenseModeData, port DenseModeData, reference mode view,
    port mode view) of one fixture mode, each built by its own package
    from the same sorted stream."""
    t, _ = make_fixture(kind)
    rmv = r_sort_mode(t, mode)
    rdn = R_dense.build_dense_mode(np.asarray(rmv.sorted_idx),
                                   np.asarray(rmv.sorted_vals), t.shape, mode)
    pt, _ = port_problem(kind)
    pmv = p_sort_mode(pt, mode)
    pdn = P_dense.build_dense_mode(pmv.sorted_idx, pmv.sorted_vals, pt.shape,
                                   mode, device="cpu")
    return rdn, pdn, rmv, pmv


def _assert_same_mode_data(pdn, rdn):
    np.testing.assert_array_equal(pdn.x.numpy(), np.asarray(rdn.x))
    assert pdn.x.dtype == torch.float32
    assert (pdn.mode, pdn.j_mode, pdn.k_modes, pdn.shape) == \
        (rdn.mode, rdn.j_mode, rdn.k_modes, rdn.shape)
    assert pdn.n_rows == rdn.n_rows


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", FIXTURES)
def test_build_dense_mode_matches_reference(kind, mode):
    rdn, pdn, _, _ = dense_problem(kind, mode)
    _assert_same_mode_data(pdn, rdn)


def _four_way(name: str, tensor4d):
    if name == "tensor4d":
        t, _ = tensor4d
        return t.shape, np.asarray(t.indices), np.asarray(t.values)
    # ties between the widest other modes, and duplicate coordinates
    shape = (6, 7, 7, 3)
    rng = np.random.RandomState(5)
    idx = np.stack([rng.randint(0, s, size=300) for s in shape], axis=1)
    idx[1::7] = idx[::7][:idx[1::7].shape[0]]
    vals = (rng.poisson(2.0, size=300) + 1).astype(np.float32)
    return shape, idx, vals


@pytest.mark.parametrize("mode", (0, 1, 2, 3))
@pytest.mark.parametrize("name", ("tensor4d", "ties"))
def test_build_dense_mode_four_way(name, mode, tensor4d):
    """A 4-way tensor from raw COO (K flattens two modes row-major), and a
    shape whose widest other modes tie (the first wins)."""
    shape, idx, vals = _four_way(name, tensor4d)
    rdn = R_dense.build_dense_mode(idx, vals, shape, mode)
    pdn = P_dense.build_dense_mode(idx, vals, shape, mode, device="cpu")
    _assert_same_mode_data(pdn, rdn)
    rng = np.random.RandomState(mode)
    facs = [rng.uniform(0.1, 1.0, (s, RANK)).astype(np.float32)
            for s in shape]
    rc, ra = R_dense.dense_kr_factors(rdn, [jnp.asarray(f) for f in facs])
    pc, pa = P_dense.dense_kr_factors(pdn, [torch.as_tensor(f) for f in facs])
    np.testing.assert_array_equal(pc.numpy(), np.asarray(rc))
    np.testing.assert_array_equal(pa.numpy(), np.asarray(ra))


def test_over_cap_refusal():
    shape = (2048, 1024, 3)  # 6.3M cells > DENSE_MAX_ELEMS = 2^22
    idx = np.zeros((1, 3), np.int64)
    vals = np.ones(1, np.float32)
    assert P_dense.DENSE_MAX_ELEMS == R_dense.DENSE_MAX_ELEMS == 1 << 22
    with pytest.raises(ValueError) as want:
        R_dense.build_dense_mode(idx, vals, shape, 0)
    with pytest.raises(ValueError) as got:
        P_dense.build_dense_mode(idx, vals, shape, 0, device="cpu")
    assert str(got.value) == str(want.value)
    assert "refusing to densify" in str(got.value)


@pytest.mark.parametrize("dtype", tuple(DTYPES))
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("kind", FIXTURES)
def test_dense_ops_match_reference(kind, op, dtype):
    """phi_dense, phi_mu_dense and mttkrp_dense, through the strategy
    routing of both packages, on every mode.  The dtype declares the
    tier: factors and B are cast, the routing casts the stored f32 x."""
    jdt, tdt, tol = DTYPES[dtype]
    t, kt = make_fixture(kind)
    _, pkt = port_problem(kind)
    rf = tuple(f.astype(jdt) for f in kt.factors)
    pf = tuple(f.to(tdt) for f in pkt.factors)
    for mode in MODES:
        rdn, pdn, rmv, pmv = dense_problem(kind, mode)
        rb = (kt.factors[mode] * kt.lam[None, :]).astype(jdt)
        pb = (pkt.factors[mode] * pkt.lam[None, :]).to(tdt)
        rk = dict(strategy="dense", dense=rdn, factors=rf)
        pk = dict(strategy="dense", dense=pdn, factors=pf, device="cpu")
        n = rmv.n_rows
        if op == "phi":
            pairs = [(P_phi.phi_from_rows(None, None, None, pb, n, **pk),
                      R_phi.phi_from_rows(None, None, None, rb, n, **rk))]
        elif op == "mu":
            gb, gv = P_phi.phi_mu_step(None, None, None, pb, n, tol=MU_TOL,
                                       **pk)
            wb, wv = R_phi.phi_mu_step(None, None, None, rb, n, tol=MU_TOL,
                                       **rk)
            assert gv.dim() == 0 and gv.dtype == torch.float32
            pairs = [(gb, wb), (gv, wv)]
        else:
            pairs = [(P_phi.krao_reduce_rows(None, None, None, n, **pk),
                      R_phi.krao_reduce_rows(None, None, None, n, **rk))]
        assert pairs[0][0].dtype == tdt
        for g, w in pairs:
            np.testing.assert_allclose(
                g.float().numpy(), np.asarray(w, np.float32), **tol,
                err_msg=f"dense {op} {dtype} {kind} mode {mode}")


@pytest.mark.parametrize("kind", FIXTURES)
def test_dense_phi_equals_sparse_phi(kind):
    """Zero entries weigh exactly 0, so dense Φ is the sparse Φ: the
    port's dense tier against its own ``segment`` strategy."""
    _, pkt = port_problem(kind)
    for mode in MODES:
        _, pdn, _, pmv = dense_problem(kind, mode)
        b = pkt.factors[mode] * pkt.lam[None, :]
        dense = P_phi.phi_from_rows(None, None, None, b, pmv.n_rows,
                                    strategy="dense", dense=pdn,
                                    factors=pkt.factors, device="cpu")
        sparse = P_phi.phi_mode(pmv, pkt.factors, b, strategy="segment",
                                device="cpu")
        np.testing.assert_allclose(dense.numpy(), sparse.numpy(), **TOL,
                                   err_msg=f"{kind} mode {mode}")


def test_phi_mode_dense_matches_reference():
    t, kt = make_fixture("hub")
    _, pkt = port_problem("hub")
    _, _, rmv, pmv = dense_problem("hub", 2)
    want = R_phi.phi_mode(rmv, kt.factors, kt.factors[2] * kt.lam[None, :],
                          strategy="dense")
    got = P_phi.phi_mode(pmv, pkt.factors, pkt.factors[2] * pkt.lam[None, :],
                         strategy="dense", device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="perturb"):
        P_phi.phi_mode(pmv, pkt.factors, pkt.factors[2], strategy="dense",
                       perturb="no_conflict", device="cpu")


@pytest.mark.parametrize("kind", FIXTURES)
def test_dense_mode_from_numpy(kind):
    """The reference's DenseModeData carried across: the port's operands
    and its dense MTTKRP come out the same as from its own build."""
    _, pkt = port_problem(kind)
    for mode in MODES:
        rdn, pdn, _, pmv = dense_problem(kind, mode)
        carried = dense_mode_from_numpy(np.asarray(rdn.x), rdn.mode,
                                        rdn.j_mode, rdn.k_modes, rdn.shape,
                                        device="cpu")
        _assert_same_mode_data(carried, rdn)
        got = P_phi.krao_reduce_rows(None, None, None, pmv.n_rows,
                                     strategy="dense", dense=carried,
                                     factors=pkt.factors, device="cpu")
        own = P_phi.krao_reduce_rows(None, None, None, pmv.n_rows,
                                     strategy="dense", dense=pdn,
                                     factors=pkt.factors, device="cpu")
        assert torch.equal(got, own)


@functools.lru_cache(maxsize=None)
def reference_dense_cpapr(kind: str):
    t, kt = make_fixture(kind)
    cfg = R_cpapr.CPAPRConfig(rank=RANK, max_outer=MAX_OUTER,
                              strategy="dense")
    return R_cpapr.cpapr_mu(t, RANK, init=kt, config=cfg)


@pytest.mark.parametrize("kind", FIXTURES)
def test_cpapr_dense_matches_reference(kind):
    want = reference_dense_cpapr(kind)
    pt, pkt = port_problem(kind)
    cfg = P_cpapr.CPAPRConfig(rank=RANK, max_outer=MAX_OUTER,
                              strategy="dense")
    got = P_cpapr.cpapr_mu(pt, RANK, init=pkt, config=cfg, device="cpu")
    assert got.inner_iters == want.inner_iters
    assert got.n_outer == want.n_outer
    np.testing.assert_allclose(got.kkt_history, want.kkt_history, **TOL)
    np.testing.assert_allclose(got.loglik_history, want.loglik_history,
                               **TOL)
    np.testing.assert_allclose(got.ktensor.lam.numpy(),
                               np.asarray(want.ktensor.lam), **TOL)
    for gf, wf in zip(got.ktensor.factors, want.ktensor.factors):
        np.testing.assert_allclose(gf.numpy(), np.asarray(wf), **TOL)
    assert got.policies == [PPolicy(strategy="dense", block_nnz=8)] * 3
    ll = got.loglik_history
    assert all(b >= a - 1e-6 * abs(a) for a, b in zip(ll, ll[1:]))


@pytest.mark.parametrize("kind", FIXTURES)
def test_cp_als_dense_matches_reference(kind):
    t, kt = make_fixture(kind)
    want_kt, want_fits = R_cpals.cp_als(t, RANK, n_iters=ALS_ITERS, init=kt,
                                        strategy="dense")
    pt, pkt = port_problem(kind)
    got_kt, got_fits = P_cpals.cp_als(pt, RANK, n_iters=ALS_ITERS, init=pkt,
                                      strategy="dense", device="cpu")
    np.testing.assert_allclose(got_fits, want_fits, **TOL)
    for gf, wf in zip(got_kt.factors, want_kt.factors):
        np.testing.assert_allclose(gf.numpy(), np.asarray(wf), **TOL)
    np.testing.assert_allclose(got_kt.lam.numpy(), np.asarray(want_kt.lam),
                               **TOL)


def _operands(dtype=torch.float32):
    _, pkt = port_problem("uniform")
    _, pdn, _, _ = dense_problem("uniform", 0)
    x, c, a = P_phi._dense_operands(pdn, pkt.factors)
    b = pkt.factors[0] * pkt.lam[None, :]
    return x.to(dtype), c.to(dtype), a.to(dtype), b.to(dtype)


def test_dense_wrapper_checks():
    x, c, a, b = _operands()
    with pytest.raises(ValueError, match="float64"):
        P_ops.phi_dense(x.double(), c.double(), a.double(), b.double())
    with pytest.raises(ValueError, match="share one element dtype"):
        P_ops.mttkrp_dense(x, c.to(torch.bfloat16), a)
    with pytest.raises(ValueError, match="shapes disagree"):
        P_ops.phi_mu_dense(x, c, a, b[:-1])
    with pytest.raises(ValueError, match="want x"):
        P_ops.mttkrp_dense(x[0], c, a)
    with pytest.raises(ValueError, match="contiguous"):
        P_ops.mttkrp_dense(x, c.t().contiguous().t(), a)
    with pytest.raises(ValueError, match="block_k"):
        P_ops.phi_dense(x, c, a, b, block_k=0)
    with pytest.raises(ValueError, match="empty"):
        P_ops.mttkrp_dense(x[:, :0], c, a)


def test_cpu_dense_wrappers_count_no_launches():
    P_ops.reset_launch_counts()
    x, c, a, b = _operands()
    P_ops.phi_dense(x, c, a, b)
    P_ops.phi_mu_dense(x, c, a, b)
    P_ops.mttkrp_dense(x, c, a)
    assert P_ops.launch_counts == {"dense_phi": 0, "dense_phi_mu": 0,
                                   "dense_mttkrp": 0}


def test_dense_strategy_needs_mode_data():
    _, pkt = port_problem("uniform")
    b = pkt.factors[0]
    with pytest.raises(ValueError, match="needs dense="):
        P_phi.phi_from_rows(None, None, None, b, b.shape[0],
                            strategy="dense", factors=pkt.factors,
                            device="cpu")
    with pytest.raises(ValueError, match="shape"):
        P_cpapr.resolve_mode_policies([], rank=RANK, strategy="dense")


def test_make_near_dense():
    """The dense tier's tensor: distinct cells at the stated fill, values
    Poisson(2) + 1, the same from the same seed, and densifiable."""
    shape = (16, 32, 8)
    t = make_near_dense(shape, fill=0.4, seed=3, device="cpu")
    assert t.shape == shape and t.values.dtype == torch.float32
    cells = np.ravel_multi_index(t.indices.numpy().T, shape)
    assert np.unique(cells).size == t.nnz
    assert abs(t.nnz / np.prod(shape) - 0.4) < 0.05
    assert float(t.values.min()) >= 1.0
    again = make_near_dense(shape, fill=0.4, seed=3, device="cpu")
    assert torch.equal(t.indices, again.indices)
    assert torch.equal(t.values, again.values)
    dn = P_dense.build_dense_mode(t.indices, t.values, shape, 1, device="cpu")
    assert float(dn.x.sum()) == pytest.approx(float(t.values.sum()))


# --- the dense kernel's launch shape (computed on the host) ------------------

# (K, I, J): the near-dense cap's three modes, other shapes at the cap
# (DENSE_MAX_ELEMS = 2^22 cells), and ragged, tiny and K = 1 shapes
LAUNCH_SHAPES = ((128, 128, 256), (128, 256, 128), (64, 256, 256),
                 (16, 1024, 256), (4096, 32, 32), (1, 2048, 2048),
                 (3, 37, 300), (7, 33, 9), (1, 1, 1), (2, 5, 2000))
LAUNCH_RANKS = (1, 3, 5, 16, 33, 64, 200, MAX_RANK)
LAUNCH_DTYPES = (torch.float32, torch.bfloat16)


@pytest.mark.parametrize("op", tuple(P_kernel.OPS))
@pytest.mark.parametrize("rank", LAUNCH_RANKS)
def test_launch_shape_covers_every_cell_once(rank, op):
    """The CTAs (row tile, k-range) cover every (k, i) of x exactly once;
    the tiles are what the kernel takes (ti a multiple of 4 with phase B's
    4 x 4 output tiles one per thread, jc a multiple of 8) and the
    footprint fits a block's shared memory."""
    for k, i, j in LAUNCH_SHAPES:
        for dtype in LAUNCH_DTYPES:
            sh = P_kernel.launch_shape(k, i, j, rank, dtype, op)
            what = (k, i, j, rank, dtype, op, sh)
            assert sh.ti % 4 == 0 and sh.ti >= 4 and sh.jc % 8 == 0, what
            assert (sh.ti // 4) * (-(-rank // 4)) <= 256, what
            assert 1 <= sh.n_ks <= k and sh.n_itiles == -(-i // sh.ti), what
            assert sh.jc <= max(8, -(-j // 8) * 8), what
            assert sh.smem == P_kernel.smem_bytes(rank, sh.ti, sh.jc, dtype,
                                                  op)
            assert 0 < sh.smem <= SMEM_LIMIT, what
            seen = np.zeros((k, sh.n_itiles * sh.ti), np.int64)
            for ks in range(sh.n_ks):
                for it in range(sh.n_itiles):
                    kr = sh.k_range(ks, k)
                    seen[kr.start:kr.stop, it * sh.ti:(it + 1) * sh.ti] += 1
            assert (seen == 1).all(), what
            assert sh.part_numel == sh.n_ks * sh.n_itiles * sh.ti * rank


@pytest.mark.parametrize("dtype", LAUNCH_DTYPES)
def test_launch_shape_fills_the_card_at_the_cap(dtype):
    """At rank 16 on the near-dense cell's modes: about one wave of two
    CTAs per SM over the H100's 132 SMs, equal k-ranges, and a footprint
    that lets two CTAs share an SM."""
    for op in P_kernel.OPS:
        for k, i, j in ((128, 128, 256), (128, 256, 128)):
            sh = P_kernel.launch_shape(k, i, j, 16, dtype, op)
            ctas = sh.n_itiles * sh.n_ks
            assert 132 <= ctas <= 2 * 132, (op, k, i, j, sh)
            assert k % sh.n_ks == 0, sh
            assert 2 * sh.smem <= 228 * 1024, sh


@pytest.mark.parametrize("op", tuple(P_kernel.OPS))
def test_dense_footprint_does_not_grow_with_j(op):
    for rank in (1, 16, 64, MAX_RANK):
        for dtype in LAUNCH_DTYPES:
            wide = {P_kernel.launch_shape(128, 64, j, rank, dtype, op).smem
                    for j in (1 << 12, 1 << 16, 1 << 20)}
            assert len(wide) == 1, (rank, dtype, wide)


def test_workspace_is_kept_per_stream_and_size():
    """One partials buffer and one zeroed ticket buffer per (device,
    stream, size), reused by later calls of the same size."""
    sh = P_kernel.launch_shape(128, 256, 128, 16, torch.float32, "dense_phi")
    part, tickets = P_kernel.workspace(sh, "cpu")
    assert part.shape == (sh.part_numel,) and part.dtype == torch.float32
    # per row tile one ticket for the last level and one per group of 8
    assert sh.n_tickets == sh.n_itiles * (-(-sh.n_ks // 8) + 1)
    assert tickets.shape == (sh.n_tickets,) and tickets.dtype == torch.int32
    assert not tickets.any()
    again = P_kernel.workspace(sh, "cpu")
    assert again[0] is part and again[1] is tickets
    other = P_kernel.launch_shape(128, 256, 128, 8, torch.float32,
                                  "dense_phi")
    assert other.part_numel != sh.part_numel
    assert P_kernel.workspace(other, "cpu")[0] is not part
