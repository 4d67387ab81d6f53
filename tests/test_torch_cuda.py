"""The port's CUDA kernels on the card, against their plain versions.

Φ and the fused Φ -> MU step (``phi.cu``), sparse MTTKRP (``mttkrp.cu``)
and the dense tier's Φ, fused step and MTTKRP (``dense.cu``), each in f32
and bf16, then the solves that run them (CP-APR ``cuda`` and ``dense``,
CP-ALS ``cuda`` and ``dense``) with their launch counts, against the
``segment`` solves on the CPU.

Everything here needs an NVIDIA GPU and skips with a reason without one.
The file imports neither jax nor the JAX package, so it also runs on a
machine that has only PyTorch; there, run it without the repository's
``tests/conftest.py`` (which imports jax):

  PYTHONPATH=src python -m pytest --noconftest -q -rs tests/test_torch_cuda.py

Inputs are the conformance fixtures' shapes (uniform, hub with ~60% of
mode-0 nonzeros in row 0, empty-row) made with numpy from fixed seeds.
The kernels sum with float atomics in an order that changes from run to
run, so they are held to the f32 tier ``TOL`` (bf16: ``TOL_BF16``), not
bitwise.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.core import cpals as P_cpals
from repro_torch.core import cpapr as P_cpapr
from repro_torch.core.convert import sparse_tensor_from_numpy
from repro_torch.core.dense import build_dense_mode
from repro_torch.core.layout import build_blocked_layout
from repro_torch.core.phi import _dense_operands, expand_to_layout
from repro_torch.core.pi import pi_rows
from repro_torch.core.policy import PhiPolicy
from repro_torch.core.sparse_tensor import (
    random_ktensor,
    random_poisson_tensor,
    sort_mode,
)
from repro_torch.kernels import _build
from repro_torch.kernels.dense import ops as dense_ops
from repro_torch.kernels.mttkrp import ops as mttkrp_ops
from repro_torch.kernels.phi import ops

RANK = 4
BN, BR = 64, 4
TOL = dict(rtol=3e-5, atol=1e-5)
TOL_BF16 = dict(rtol=3e-2, atol=3e-2)
FIXTURES = ("uniform", "hub", "empty_row")
MODES = (0, 1, 2)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only on "
                    "the card); see README")
    return torch.device("cuda")


@functools.lru_cache(maxsize=None)
def fixture(kind: str):
    """(SparseTensor, KTensor) on the CPU, shaped as the conformance
    fixtures are."""
    if kind == "uniform":
        return random_poisson_tensor((40, 30, 25), nnz=1500, rank=RANK,
                                     seed=0, device="cpu")
    shape = (48, 20, 16)
    rng = np.random.RandomState(3 if kind == "hub" else 7)
    nnz = 1200
    idx = np.stack([rng.randint(0, s, size=nnz) for s in shape], axis=1)
    if kind == "hub":
        idx[rng.rand(nnz) < 0.6, 0] = 0
    else:
        idx[:, 0] = idx[:, 0] % (shape[0] // 3)
    vals = rng.poisson(2.0, size=nnz).astype(np.float32) + 1.0
    t = sparse_tensor_from_numpy(shape, idx, vals, device="cpu")
    return t, random_ktensor(shape, RANK, seed=11, device="cpu")


def _inputs(kind, mode, dtype):
    t, kt = fixture(kind)
    mv = sort_mode(t, mode)
    lay = build_blocked_layout(mv.rows.numpy(), mv.n_rows, BN, BR)
    pi = pi_rows(mv.sorted_idx, kt.factors, mode)
    vals_e, pi_e = expand_to_layout(lay, mv.sorted_vals, pi)
    b = kt.factors[mode] * kt.lam[None, :]
    return lay, vals_e.to(dtype), pi_e.to(dtype), b.to(dtype)


def _close(got, want, tol, what):
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **tol,
                               err_msg=what)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("kind", FIXTURES)
def test_kernels_match_plain_versions(card, kind, dtype):
    tol = TOL if dtype == torch.float32 else TOL_BF16
    for mode in MODES:
        lay, vals_e, pi_e, b = _inputs(kind, mode, dtype)
        d = [x.to(card) for x in (vals_e, pi_e, b)]
        before = dict(ops.launch_counts)
        phi = ops.phi_blocked(lay, *d)
        mu, viol = ops.phi_mu_blocked(lay, *d)
        torch.cuda.synchronize()
        assert ops.launch_counts["phi_blocked"] == before["phi_blocked"] + 1
        assert ops.launch_counts["phi_mu_blocked"] == \
            before["phi_mu_blocked"] + 1
        assert phi.dtype == dtype and mu.dtype == dtype
        assert viol.dtype == torch.float32 and viol.dim() == 0
        phi_p = ops.phi_blocked(lay, vals_e, pi_e, b)
        mu_p, viol_p = ops.phi_mu_blocked(lay, vals_e, pi_e, b)
        what = f"{kind} mode {mode} {dtype}"
        _close(phi, phi_p, tol, f"phi {what}")
        _close(mu, mu_p, tol, f"mu {what}")
        _close(viol, viol_p, tol, f"viol {what}")


@pytest.mark.cuda
@pytest.mark.parametrize("bn,br", ((64, 4), (256, 256), (2048, 1024)))
def test_kernels_match_plain_versions_across_blockings(card, bn, br):
    t, kt = fixture("hub")
    for mode in MODES:
        mv = sort_mode(t, mode)
        lay = build_blocked_layout(mv.rows.numpy(), mv.n_rows, bn, br)
        pi = pi_rows(mv.sorted_idx, kt.factors, mode)
        vals_e, pi_e = expand_to_layout(lay, mv.sorted_vals, pi)
        b = kt.factors[mode] * kt.lam[None, :]
        phi = ops.phi_blocked(lay, vals_e.to(card), pi_e.to(card), b.to(card))
        _close(phi, ops.phi_blocked(lay, vals_e, pi_e, b), TOL,
               f"phi hub mode {mode} {bn}x{br}")


@pytest.mark.cuda
def test_kernels_on_an_empty_mode(card):
    rows = np.zeros(0, np.int64)
    lay = build_blocked_layout(rows, 9, BN, BR)
    vals_e = torch.zeros(lay.n_grid * BN, device=card)
    pi_e = torch.zeros(lay.n_grid * BN, RANK, device=card)
    b = torch.rand(9, RANK, generator=torch.Generator().manual_seed(0)).to(card)
    phi = ops.phi_blocked(lay, vals_e, pi_e, b)
    mu, viol = ops.phi_mu_blocked(lay, vals_e, pi_e, b)
    assert not phi.any() and not mu.any()
    assert float(viol) == pytest.approx(float(b.max()))


@pytest.mark.cuda
def test_kernels_propagate_nan(card):
    lay, vals_e, pi_e, b = _inputs("uniform", 0, torch.float32)
    b = b.clone()
    b[3, 1] = float("nan")
    _, viol = ops.phi_mu_blocked(lay, vals_e.to(card), pi_e.to(card),
                                 b.to(card))
    assert torch.isnan(viol)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", FIXTURES)
def test_cpapr_cuda_matches_segment(card, kind):
    t, kt = fixture(kind)
    cfg = dict(rank=RANK, max_outer=4,
               policy=PhiPolicy(block_nnz=BN, block_rows=BR))
    ops.reset_launch_counts()
    got = P_cpapr.cpapr_mu(t, RANK, init=kt, device=card,
                           config=P_cpapr.CPAPRConfig(strategy="cuda", **cfg))
    assert ops.launch_counts["phi_blocked"] == t.ndim * got.n_outer
    assert ops.launch_counts["phi_mu_blocked"] == sum(got.inner_iters)
    want = P_cpapr.cpapr_mu(t, RANK, init=kt, device="cpu",
                            config=P_cpapr.CPAPRConfig(strategy="segment",
                                                       **cfg))
    assert got.inner_iters == want.inner_iters
    np.testing.assert_allclose(got.loglik_history, want.loglik_history, **TOL)
    np.testing.assert_allclose(got.kkt_history, want.kkt_history, **TOL)


@pytest.mark.cuda
def test_build_is_cached_by_source_hash(card):
    first = _build.build_library("phi")
    assert first.exists() and first.with_suffix(".log").exists()
    assert _build.build_library("phi") == first


@pytest.mark.cuda
def test_every_source_builds(card):
    libs = _build.build_all()
    assert set(libs) == {"dense", "mttkrp", "phi"}
    assert all(p.exists() for p in libs.values())


# --- sparse MTTKRP (mttkrp.cu) ---------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("kind", FIXTURES)
def test_mttkrp_kernel_matches_plain_version(card, kind, dtype):
    tol = TOL if dtype == torch.float32 else TOL_BF16
    for mode in MODES:
        lay, vals_e, kr_e, _ = _inputs(kind, mode, dtype)
        before = mttkrp_ops.launch_counts["mttkrp_blocked"]
        got = mttkrp_ops.mttkrp_blocked(lay, vals_e.to(card), kr_e.to(card))
        torch.cuda.synchronize()
        assert mttkrp_ops.launch_counts["mttkrp_blocked"] == before + 1
        assert got.dtype == dtype and got.shape == (lay.n_rows_pad, RANK)
        _close(got, mttkrp_ops.mttkrp_blocked(lay, vals_e, kr_e), tol,
               f"mttkrp {kind} mode {mode} {dtype}")


@pytest.mark.cuda
@pytest.mark.parametrize("bn,br", ((64, 4), (256, 256), (2048, 1024)))
def test_mttkrp_kernel_counts_negative_values(card, bn, br):
    """No x > 0 condition: a negative value counts, only x == 0 (padding)
    is skipped; across blockings, hub mode included."""
    t, kt = fixture("hub")
    for mode in MODES:
        mv = sort_mode(t, mode)
        lay = build_blocked_layout(mv.rows.numpy(), mv.n_rows, bn, br)
        # two values in three negative, so that some rows sum below zero
        sign = torch.where(torch.arange(mv.nnz) % 3 == 0, 1.0, -1.0)
        kr = pi_rows(mv.sorted_idx, kt.factors, mode)
        vals_e, kr_e = expand_to_layout(lay, mv.sorted_vals * sign, kr)
        got = mttkrp_ops.mttkrp_blocked(lay, vals_e.to(card), kr_e.to(card))
        want = mttkrp_ops.mttkrp_blocked(lay, vals_e, kr_e)
        assert float(want.min()) < 0
        _close(got, want, TOL, f"mttkrp hub mode {mode} {bn}x{br}")


# --- the dense tier (dense.cu) ---------------------------------------------


def _dense_inputs(kind, mode, dtype):
    t, kt = fixture(kind)
    mv = sort_mode(t, mode)
    dn = build_dense_mode(mv.sorted_idx, mv.sorted_vals, t.shape, mode,
                          device="cpu")
    b = (kt.factors[mode] * kt.lam[None, :]).to(dtype)
    x, c, a = _dense_operands(dn, tuple(f.to(dtype) for f in kt.factors), b)
    return x, c, a, b


def _check_dense(card, x, c, a, b, tol, what, block_k=None):
    d = [v.to(card) for v in (x, c, a, b)]
    before = dict(dense_ops.launch_counts)
    phi = dense_ops.phi_dense(*d, block_k=block_k)
    mu, viol = dense_ops.phi_mu_dense(*d, block_k=block_k)
    m = dense_ops.mttkrp_dense(*d[:3], block_k=block_k)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in dense_ops.launch_counts.items()} == \
        {"dense_phi": 1, "dense_phi_mu": 1, "dense_mttkrp": 1}
    assert phi.dtype == mu.dtype == m.dtype == x.dtype
    assert viol.dtype == torch.float32 and viol.dim() == 0
    mu_p, viol_p = dense_ops.phi_mu_dense(x, c, a, b)
    _close(phi, dense_ops.phi_dense(x, c, a, b), tol, f"phi {what}")
    _close(mu, mu_p, tol, f"mu {what}")
    _close(viol, viol_p, tol, f"viol {what}")
    _close(m, dense_ops.mttkrp_dense(x, c, a), tol, f"mttkrp {what}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("kind", FIXTURES)
def test_dense_kernels_match_plain_versions(card, kind, dtype):
    tol = TOL if dtype == torch.float32 else TOL_BF16
    for mode in MODES:
        _check_dense(card, *_dense_inputs(kind, mode, dtype), tol,
                     f"{kind} mode {mode} {dtype}")


@pytest.mark.cuda
@pytest.mark.parametrize("block_k", (1, 3, 64))
def test_dense_kernels_across_block_k(card, block_k):
    _check_dense(card, *_dense_inputs("uniform", 0, torch.float32), TOL,
                 f"block_k {block_k}", block_k=block_k)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,rank", [((3, 5, 2000), 300), ((7, 33, 9), 64),
                                        ((2, 1, 1), 1)])
def test_dense_kernels_at_other_shapes(card, shape, rank):
    """Ranks above 256 (one row per block), column chunks narrower than J,
    a ragged row tile and degenerate sizes."""
    g = torch.Generator().manual_seed(rank)
    k, i, j = shape
    x = torch.poisson(torch.full(shape, 0.7), generator=g)
    c = torch.rand(j, rank, generator=g) + 0.1
    a = torch.rand(k, rank, generator=g) + 0.1
    b = torch.rand(i, rank, generator=g) + 0.1
    _check_dense(card, x, c, a, b, TOL, f"{shape} rank {rank}")


@pytest.mark.cuda
def test_dense_kernels_propagate_nan(card):
    x, c, a, b = _dense_inputs("uniform", 1, torch.float32)
    b = b.clone()
    b[2, 3] = float("nan")
    _, viol = dense_ops.phi_mu_dense(*(v.to(card) for v in (x, c, a, b)))
    assert torch.isnan(viol)


# --- the solves that run them ------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("kind", FIXTURES)
def test_cp_als_cuda_matches_segment(card, kind):
    t, kt = fixture(kind)
    pol = PhiPolicy(block_nnz=BN, block_rows=BR)
    mttkrp_ops.reset_launch_counts()
    got_kt, got = P_cpals.cp_als(t, RANK, n_iters=3, init=kt, strategy="cuda",
                                 policy=pol, device=card)
    assert mttkrp_ops.launch_counts["mttkrp_blocked"] == 3 * t.ndim
    want_kt, want = P_cpals.cp_als(t, RANK, n_iters=3, init=kt,
                                   strategy="segment", device="cpu")
    np.testing.assert_allclose(got, want, **TOL)
    for gf, wf in zip(got_kt.factors, want_kt.factors):
        _close(gf, wf, TOL, f"cp_als factor {kind}")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", FIXTURES)
def test_dense_solves_match_segment(card, kind):
    t, kt = fixture(kind)
    cfg = dict(rank=RANK, max_outer=3)
    dense_ops.reset_launch_counts()
    got = P_cpapr.cpapr_mu(t, RANK, init=kt, device=card,
                           config=P_cpapr.CPAPRConfig(strategy="dense", **cfg))
    assert dense_ops.launch_counts["dense_phi"] == t.ndim * got.n_outer
    assert dense_ops.launch_counts["dense_phi_mu"] == sum(got.inner_iters)
    want = P_cpapr.cpapr_mu(t, RANK, init=kt, device="cpu",
                            config=P_cpapr.CPAPRConfig(strategy="segment",
                                                       **cfg))
    assert got.inner_iters == want.inner_iters
    np.testing.assert_allclose(got.loglik_history, want.loglik_history, **TOL)
    _, fits = P_cpals.cp_als(t, RANK, n_iters=3, init=kt, strategy="dense",
                             device=card)
    assert dense_ops.launch_counts["dense_mttkrp"] == 3 * t.ndim
    _, want_fits = P_cpals.cp_als(t, RANK, n_iters=3, init=kt,
                                  strategy="segment", device="cpu")
    np.testing.assert_allclose(fits, want_fits, **TOL)
