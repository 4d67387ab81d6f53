"""The port's CUDA kernels on the card, against their plain versions.

Φ and the fused Φ -> MU step (``phi.cu``), sparse MTTKRP (``mttkrp.cu``)
and the dense tier's Φ, fused step and MTTKRP (``dense.cu``), each in f32
and bf16, then the solves that run them (CP-APR ``cuda`` and ``dense``,
CP-ALS ``cuda`` and ``dense``) with their launch counts, against the
``segment`` solves on the CPU.  The STREAM kernel (``stream.cu``) is held
bitwise to its plain version on the card.  The solvers' input check runs
on the card: each invalid input raises the text the same tensor raises
on the CPU, and a ``cuda`` solve copies none of its tensor to the host.  The row-sharded and N-D grid
tiers run B2/B3 once per shard and once per grid cell, counted, against
their plain blocked schedules; on a one-rank NCCL group their collectives
are recorded (``perf.comm.record_collectives``) and held to the
communication model, and the dense wrappers' operands to
``dense_input_bytes``.  The LM serving path (plain PyTorch, no
kernel of the port) runs its ten reduced configs on the card against
the CPU, crosses the ring cache's window and counts the engine's decode
steps.  LM training: ``matmul_f32``'s backward on bf16 operands (the
cuBLAS ``out_dtype`` product) against the f32 product's gradient, and
one train step of each reduced config on the card against the CPU.  LM
training on a mesh: each reduced config's step on a (1, 1) DeviceMesh of
a one-rank NCCL group against the plain step on the card, and
``matmul_f32`` of bf16 DTensors through the registered DTensor rules of
``aten.mm.dtype``/``aten.bmm.dtype``.

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
import dataclasses
import functools
import re
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import cpals as P_cpals
from repro_torch.core import cpapr as P_cpapr
from repro_torch.core import resilience
from repro_torch.core.convert import sparse_tensor_from_numpy
from repro_torch.core.dense import build_dense_mode
from repro_torch.core.layout import build_blocked_layout, host_copies, pad_rows
from repro_torch.core.phi import _dense_operands, expand_to_layout
from repro_torch.core.pi import pi_rows
from repro_torch.core.policy import PhiPolicy
from repro_torch.core.sparse_tensor import (
    SparseTensor,
    random_ktensor,
    random_poisson_tensor,
    sort_mode,
)
from repro_torch.kernels import _build
from repro_torch.kernels.dense import kernel as dense_kernel
from repro_torch.kernels.dense import ops as dense_ops
from repro_torch.kernels.mttkrp import kernel as mttkrp_kernel
from repro_torch.kernels.mttkrp import ops as mttkrp_ops
from repro_torch.kernels.mttkrp import ref as mttkrp_ref
from repro_torch.kernels.phi import kernel as phi_kernel
from repro_torch.kernels.phi import ops
from repro_torch.kernels.phi import ref as phi_ref
from repro_torch.kernels.stream import ops as stream_ops
from repro_torch.kernels.stream.ref import stream_ref
from repro_torch.perf import roofline

import invalid_inputs

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
        return random_poisson_tensor(0, (40, 30, 25), nnz=1500, rank=RANK,
                                     device="cpu")
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
    return t, random_ktensor(11, shape, RANK, device="cpu")


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
@pytest.mark.parametrize("kind", FIXTURES)
def test_layout_built_on_the_card(card, kind):
    """A layout built from the card's rows equals the CPU build of the same
    rows (which the CPU tests hold to the JAX package's), is cached under
    every name of the card, and a ``cuda`` solve never copies one down."""
    t, kt = fixture(kind)
    for mode in MODES:
        mv = sort_mode(t, mode)
        for bn, br in ((BN, BR), (256, 256), (7, 3)):
            want = build_blocked_layout(mv.rows, mv.n_rows, bn, br)
            before = host_copies()
            got = build_blocked_layout(mv.rows.to(card), mv.n_rows, bn, br)
            lt = got.on("cuda")
            assert got.on("cuda:0") is lt
            assert got.on(torch.device("cuda", 0)) is lt
            assert lt.gather.device.type == "cuda"
            assert host_copies() == before
            for f in ("n_rows_pad", "n_grid", "pad_fraction"):
                assert getattr(got, f) == getattr(want, f), f
            for f in ("gather", "valid", "local_rows", "grid_rb"):
                x, y = getattr(lt, f), getattr(want.on("cpu"), f)
                assert x.dtype == y.dtype, f
                assert torch.equal(x.cpu(), y), f"{kind} mode {mode} {f}"
    before = host_copies()
    res = P_cpapr.cpapr_mu(t, RANK, init=kt, device=card,
                           config=P_cpapr.CPAPRConfig(
                               rank=RANK, strategy="cuda", max_outer=2))
    assert res.n_outer == 2
    assert host_copies() == before


def _check_outcome(t, rank):
    """The input check's message on ``t``, or None when it passes."""
    try:
        resilience.validate_decomposition_inputs(t, rank)
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.cuda
@pytest.mark.parametrize("bad", invalid_inputs.CASES)
def test_invalid_inputs_raise_on_the_card_as_on_the_cpu(card, bad):
    """The input check of a card tensor raises the text the same tensor
    raises on the CPU (which the CPU tests hold to the JAX package's),
    without copying its arrays to host numpy."""
    t, _ = fixture("uniform")
    idx, vals, rank, bf16 = invalid_inputs.corrupt(
        bad, t.shape, t.indices.numpy(), t.values.numpy(), RANK)
    cpu = sparse_tensor_from_numpy(t.shape, idx, vals, device="cpu")
    if bf16:
        cpu = SparseTensor(cpu.shape, cpu.indices, cpu.values.bfloat16())
    want = _check_outcome(cpu, rank)
    assert want is not None
    before = resilience.host_copies()
    assert _check_outcome(cpu.to(card), rank) == want
    assert resilience.host_copies() == before


@pytest.mark.cuda
def test_empty_tensor_passes_on_the_card(card):
    t = SparseTensor((4, 3, 2), torch.zeros((0, 3), dtype=torch.int64,
                                            device=card),
                     torch.zeros(0, device=card))
    assert _check_outcome(t, RANK) is None


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ("cpapr_mu", "cp_als"))
def test_solves_check_their_inputs_on_the_card(card, solver):
    """A ``cuda`` solve of either solver validates its inputs on the card:
    no array of the tensor is copied to host numpy."""
    t, kt = fixture("uniform")
    before = resilience.host_copies()
    if solver == "cpapr_mu":
        res = P_cpapr.cpapr_mu(t, RANK, init=kt, device=card,
                               config=P_cpapr.CPAPRConfig(
                                   rank=RANK, strategy="cuda", max_outer=2))
        assert res.n_outer == 2
    else:
        P_cpals.cp_als(t, RANK, n_iters=2, init=kt, strategy="cuda",
                       device=card)
    assert resilience.host_copies() == before


@pytest.mark.cuda
def test_kernels_propagate_nan(card):
    lay, vals_e, pi_e, b = _inputs("uniform", 0, torch.float32)
    b = b.clone()
    b[3, 1] = float("nan")
    _, viol = ops.phi_mu_blocked(lay, vals_e.to(card), pi_e.to(card),
                                 b.to(card))
    assert torch.isnan(viol)


# --- the Φ accumulation kernel's ring, lane groups and row window ----------


def _random_layout(rows, n_rows, rank, bn, br, dtype, seed=0):
    """Layout-expanded random operands of the given rank for sorted rows:
    Π and B uniform in [0.1, 1.1), x Poisson(1.5) (some zeros, which the
    kernel must skip), padding slots zero."""
    rng = np.random.RandomState(seed)
    lay = build_blocked_layout(rows, n_rows, bn, br)
    n = len(rows)
    vals = np.zeros(lay.n_grid * bn, np.float32)
    vals[lay.valid] = rng.poisson(1.5, n)
    pi = np.zeros((lay.n_grid * bn, rank), np.float32)
    pi[lay.valid] = rng.rand(n, rank) + 0.1
    b = np.zeros((lay.n_rows_pad, rank), np.float32)
    b[:n_rows] = rng.rand(n_rows, rank) + 0.1
    lt = lay.on("cpu")
    return lay, (lt.grid_rb, torch.from_numpy(vals).to(dtype), lt.local_rows,
                 torch.from_numpy(pi).to(dtype), torch.from_numpy(b).to(dtype))


def _check_accum(card, lay, args, tol, what):
    """Both C entry points against the plain versions."""
    kw = dict(block_nnz=lay.block_nnz, block_rows=lay.block_rows, eps=1e-10)
    d = [a.to(card) for a in args]
    want = phi_ref.phi_blocked_arrays_ref(*args, **kw)
    mu_w, viol_w = phi_ref.phi_mu_blocked_arrays_ref(*args, **kw)
    phi = torch.zeros(d[4].shape, dtype=torch.float32, device=card)
    phi_kernel.launch_phi(*d, phi, **kw)
    phi2 = torch.zeros_like(phi)
    mu = torch.empty_like(d[4])
    viol = torch.zeros((), dtype=torch.float32, device=card)
    phi_kernel.launch_phi_mu(*d, phi2, mu, viol, **kw)
    torch.cuda.synchronize()
    _close(phi, want, tol, f"phi {what}")
    _close(phi2, want, tol, f"phi (fused) {what}")
    _close(mu, mu_w, tol, f"mu {what}")
    _close(viol, viol_w, tol, f"viol {what}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("rank", (1, 3, 5, 16, 33, 64))
def test_phi_kernel_across_ranks(card, rank, dtype):
    """Aligned 16-byte lane slices (rank a multiple of 4 in f32, 8 in bf16)
    and the one-element path, a lane group narrower than a warp and ranks
    above 32 (several slices per lane), hub and spread rows."""
    tol = TOL if dtype == torch.float32 else TOL_BF16
    rng = np.random.RandomState(rank)
    for kind in ("spread", "hub"):
        rows = np.sort(rng.randint(0, 300, 4000))
        if kind == "hub":
            rows[rng.rand(rows.size) < 0.6] = 7
            rows = np.sort(rows)
        lay, args = _random_layout(rows, 300, rank, 256, 64, dtype, seed=rank)
        _check_accum(card, lay, args, tol, f"rank {rank} {kind} {dtype}")


@pytest.mark.cuda
@pytest.mark.parametrize("bn", (1, 50, 100, 129, 300, 1000))
@pytest.mark.parametrize("rank", (16, 64))
def test_phi_kernel_block_nnz_off_the_chunk(card, bn, rank):
    """block_nnz smaller than a ring chunk, and not a multiple of it (the
    chunk is 128 nonzeros at rank 16 and 32 at rank 64 in f32)."""
    rows = np.sort(np.random.RandomState(bn).randint(0, 500, 3000))
    lay, args = _random_layout(rows, 500, rank, bn, 32, torch.float32)
    _check_accum(card, lay, args, TOL, f"bn {bn} rank {rank}")


@pytest.mark.cuda
@pytest.mark.parametrize("rank,br", ((16, 64), (4, 1024), (1024, 32)))
def test_phi_kernel_step_spans_its_row_block(card, rank, br):
    """Every row of a row block in one step: a run ends at every other
    slot, so every set of slots takes the segmented scan; at rank 1024 a
    stage holds a single row."""
    rows = np.repeat(np.arange(3 * br), 2)
    lay, args = _random_layout(rows, 3 * br, rank, 2 * br, br, torch.float32)
    assert int(lay.local_rows.max()) == br - 1
    _check_accum(card, lay, args, TOL, f"rank {rank} br {br}")


@pytest.mark.cuda
def test_phi_kernel_hub_and_nan(card):
    """The hub fixture, and a NaN in B reaching its row of Φ (and nothing
    else)."""
    lay, vals_e, pi_e, b = _inputs("hub", 0, torch.float32)
    b = b.clone()
    _check_accum(card, lay, (lay.on("cpu").grid_rb, vals_e,
                             lay.on("cpu").local_rows, pi_e,
                             pad_rows(b, lay.n_rows_pad)), TOL, "hub")
    b[3, 1] = float("nan")
    d = [x.to(card) for x in (vals_e, pi_e, pad_rows(b, lay.n_rows_pad))]
    lt = lay.on(card)
    phi = torch.zeros(d[2].shape, dtype=torch.float32, device=card)
    phi_kernel.launch_phi(lt.grid_rb, d[0], lt.local_rows, d[1], d[2], phi,
                          block_nnz=lay.block_nnz, block_rows=lay.block_rows,
                          eps=1e-10)
    nan_rows = torch.isnan(phi).any(dim=1).nonzero().flatten().tolist()
    assert nan_rows == [3]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_phi_smem_bytes_equals_the_kernels(card, dtype):
    for bn, br in ((64, 4), (256, 256), (2048, 1024), (1024, 512), (1, 1)):
        for rank in (1, 3, 16, 64, 200, 1024):
            assert phi_kernel.library_smem_bytes(bn, br, rank, dtype) == \
                phi_kernel.smem_bytes(bn, br, rank, dtype), (bn, br, rank)


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
    assert set(libs) == {"dense", "mttkrp", "phi", "stream"}
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


# --- the MTTKRP instance of the accumulation kernel (accum.cuh) ------------


def _check_mttkrp(card, lay, args, tol, what):
    """The C entry point and the wrapper against the plain version; args
    as _random_layout's (the Π rows serve as Khatri-Rao rows, B unused)."""
    grid_rb, vals, lrow, kr, _ = args
    kw = dict(block_nnz=lay.block_nnz, block_rows=lay.block_rows)
    want = mttkrp_ref.mttkrp_blocked_arrays_ref(grid_rb, vals, lrow, kr,
                                                n_rows_pad=lay.n_rows_pad,
                                                **kw)
    d = [t.to(card) for t in (grid_rb, vals, lrow, kr)]
    out = torch.zeros((lay.n_rows_pad, kr.shape[1]), dtype=torch.float32,
                      device=card)
    mttkrp_kernel.launch_mttkrp(*d, out, **kw)
    got = mttkrp_ops.mttkrp_blocked_arrays(*d, n_rows_pad=lay.n_rows_pad,
                                           **kw)
    torch.cuda.synchronize()
    _close(out, want, tol, f"mttkrp {what}")
    _close(got, want, tol, f"mttkrp wrapper {what}")
    return out


def _signed(args, seed):
    """The values with two in three negated, so that sums cancel."""
    grid_rb, vals, lrow, kr, b = args
    sign = torch.from_numpy(np.where(
        np.random.RandomState(seed).rand(vals.numel()) < 1 / 3, 1.0,
        -1.0).astype(np.float32)).to(vals.dtype)
    return grid_rb, vals * sign, lrow, kr, b


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("rank", (1, 3, 5, 16, 33, 64))
def test_mttkrp_kernel_across_ranks(card, rank, dtype):
    """Aligned 16-byte lane slices and the one-element path, lane groups
    narrower than a warp and several slices per lane; spread and hub
    rows; signed values."""
    tol = TOL if dtype == torch.float32 else TOL_BF16
    rng = np.random.RandomState(100 + rank)
    for kind in ("spread", "hub"):
        rows = np.sort(rng.randint(0, 300, 4000))
        if kind == "hub":
            rows[rng.rand(rows.size) < 0.6] = 7
            rows = np.sort(rows)
        lay, args = _random_layout(rows, 300, rank, 256, 64, dtype, seed=rank)
        _check_mttkrp(card, lay, _signed(args, rank), tol,
                      f"rank {rank} {kind} {dtype}")


@pytest.mark.cuda
@pytest.mark.parametrize("bn", (1, 50, 100, 129, 300, 1000))
@pytest.mark.parametrize("rank", (16, 64))
def test_mttkrp_kernel_block_nnz_off_the_chunk(card, bn, rank):
    rows = np.sort(np.random.RandomState(bn).randint(0, 500, 3000))
    lay, args = _random_layout(rows, 500, rank, bn, 32, torch.float32)
    _check_mttkrp(card, lay, _signed(args, bn), TOL, f"bn {bn} rank {rank}")


@pytest.mark.cuda
@pytest.mark.parametrize("rank,br", ((16, 64), (4, 1024), (1024, 32)))
def test_mttkrp_kernel_step_spans_its_row_block(card, rank, br):
    rows = np.repeat(np.arange(3 * br), 2)
    lay, args = _random_layout(rows, 3 * br, rank, 2 * br, br, torch.float32)
    assert int(lay.local_rows.max()) == br - 1
    _check_mttkrp(card, lay, args, TOL, f"rank {rank} br {br}")


@pytest.mark.cuda
def test_mttkrp_kernel_on_an_empty_mode_and_nan(card):
    """An empty mode gives zeros; a NaN value reaches its row (and nothing
    else), as x != 0 counts a slot."""
    lay = build_blocked_layout(np.zeros(0, np.int64), 9, BN, BR)
    vals_e = torch.zeros(lay.n_grid * BN, device=card)
    kr_e = torch.rand(lay.n_grid * BN, RANK, device=card)
    assert not mttkrp_ops.mttkrp_blocked(lay, vals_e, kr_e).any()
    lay, vals_e, kr_e, _ = _inputs("hub", 0, torch.float32)
    vals_e = vals_e.clone()
    j = int(lay.valid.nonzero()[0][5])
    vals_e[j] = float("nan")
    got = mttkrp_ops.mttkrp_blocked(lay, vals_e.to(card), kr_e.to(card))
    row = int(lay.grid_rb[j // BN]) * BR + int(lay.local_rows[j])
    nan_rows = torch.isnan(got).any(dim=1).nonzero().flatten().tolist()
    assert nan_rows == [row]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_mttkrp_smem_bytes_equals_the_kernels(card, dtype):
    for bn, br in ((64, 4), (256, 256), (2048, 1024), (1024, 512), (1, 1)):
        for rank in (1, 3, 16, 64, 200, 1024):
            assert mttkrp_kernel.library_smem_bytes(bn, br, rank, dtype) == \
                mttkrp_ops.smem_bytes(bn, br, rank, dtype), (bn, br, rank)


def _interpret_calls():
    """{wrapper: (launch-count dict, count key, call(device, interpret))}
    for the wrappers that take the reference's ``interpret=``."""
    lay, vals_e, pi_e, b = _inputs("hub", 0, torch.float32)
    dense = _dense_inputs("hub", 0, torch.float32)
    rng = np.random.RandomState(3)
    sb, sc = (torch.from_numpy(rng.standard_normal(128 * 256 * 2)
                               .astype(np.float32)) for _ in range(2))

    def on(dev, *ts):
        return [t.to(dev) for t in ts]

    return {
        "phi_blocked": (ops.launch_counts, "phi_blocked", lambda d, i:
                        ops.phi_blocked(lay, *on(d, vals_e, pi_e, b), 1e-10,
                                        i)),
        "phi_mu_blocked": (ops.launch_counts, "phi_mu_blocked", lambda d, i:
                           ops.phi_mu_blocked(lay, *on(d, vals_e, pi_e, b),
                                              1e-10, i)),
        "mttkrp_blocked": (mttkrp_ops.launch_counts, "mttkrp_blocked",
                           lambda d, i: mttkrp_ops.mttkrp_blocked(
                               lay, *on(d, vals_e, pi_e), i)),
        "mttkrp_dense": (dense_ops.launch_counts, "dense_mttkrp", lambda d, i:
                         dense_ops.mttkrp_dense(*on(d, *dense[:3]),
                                                interpret=i)),
        "phi_dense": (dense_ops.launch_counts, "dense_phi", lambda d, i:
                      dense_ops.phi_dense(*on(d, *dense), interpret=i)),
        "phi_mu_dense": (dense_ops.launch_counts, "dense_phi_mu", lambda d, i:
                         dense_ops.phi_mu_dense(*on(d, *dense), interpret=i)),
        "stream_op": (stream_ops.launch_counts, "stream_triad", lambda d, i:
                      stream_ops.stream_op("triad", *on(d, sb, sc), 256, 3.0,
                                           i)),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("wrapper", ("phi_blocked", "phi_mu_blocked",
                                     "mttkrp_blocked", "mttkrp_dense",
                                     "phi_dense", "phi_mu_dense",
                                     "stream_op"))
def test_interpret_on_the_card_launches_the_kernel(card, wrapper):
    """On CUDA tensors ``interpret=None`` and ``interpret=False`` launch the
    kernel once each, with the CPU's plain result; ``interpret=True``
    (the plain version) raises before any launch."""
    counts, key, call = _interpret_calls()[wrapper]
    want = call("cpu", None)
    want = want if isinstance(want, tuple) else (want,)
    before = counts[key]
    with pytest.raises(ValueError, match="interpret=True"):
        call(card, True)
    assert counts[key] == before, wrapper
    for interpret in (None, False):
        before = counts[key]
        got = call(card, interpret)
        torch.cuda.synchronize()
        assert counts[key] == before + 1, (wrapper, interpret)
        got = got if isinstance(got, tuple) else (got,)
        for g, w in zip(got, want):
            assert g.device.type == "cuda"
            _close(g, w, TOL, f"{wrapper} interpret={interpret}")


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


def _random_dense(shape, rank, dtype, seed):
    """x Poisson(0.7) (mostly zeros), c, a, B uniform in [0.1, 1.1)."""
    g = torch.Generator().manual_seed(seed)
    k, i, j = shape
    x = torch.poisson(torch.full(shape, 0.7), generator=g)
    c, a, b = (torch.rand(n, rank, generator=g) + 0.1 for n in (j, k, i))
    return tuple(t.to(dtype) for t in (x, c, a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("rank", (1, 3, 5, 16, 33, 64))
def test_dense_kernels_across_ranks(card, rank, dtype):
    """R not a multiple of 4 (zero-padded in shared memory), R = 64 (256
    output tiles of phase B, one split); I, J not multiples of the tile."""
    tol = TOL if dtype == torch.float32 else TOL_BF16
    _check_dense(card, *_random_dense((6, 45, 70), rank, dtype, rank), tol,
                 f"rank {rank} {dtype}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_dense_kernels_at_max_rank(card, dtype):
    """R = 1024 at a small I and J: 4-row tiles, 8-column chunks."""
    tol = TOL if dtype == torch.float32 else TOL_BF16
    _check_dense(card, *_random_dense((3, 9, 20), 1024, dtype, 1024), tol,
                 f"rank 1024 {dtype}")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ((1, 70, 13), (1, 1, 1), (5, 33, 301),
                                   (9, 4, 1000), (130, 3, 17), (2, 129, 129)))
def test_dense_kernels_on_ragged_shapes(card, shape):
    """K = 1; I, J, K not multiples of the tiles; J wider than one column
    chunk; J * 4 bytes not a multiple of 16 (the ring without cp.async)."""
    _check_dense(card, *_random_dense(shape, 16, torch.float32, sum(shape)),
                 TOL, f"{shape}")


@pytest.mark.cuda
def test_dense_kernels_are_bitwise_reproducible(card):
    """Partials summed in a fixed order: two calls give the same bits."""
    d = [t.to(card) for t in _random_dense((64, 96, 128), 16, torch.float32,
                                           3)]
    first = (dense_ops.phi_dense(*d), *dense_ops.phi_mu_dense(*d),
             dense_ops.mttkrp_dense(*d[:3]))
    second = (dense_ops.phi_dense(*d), *dense_ops.phi_mu_dense(*d),
              dense_ops.mttkrp_dense(*d[:3]))
    assert all(torch.equal(u, v) for u, v in zip(first, second))


@pytest.mark.cuda
def test_dense_kernels_leave_their_tickets_zero(card):
    """Each launch resets the tickets it took, so the next call on the
    stream finds them zero; three calls in a row agree bitwise."""
    d = [t.to(card) for t in _random_dense((40, 70, 50), 16, torch.float32,
                                           4)]
    first = dense_ops.phi_dense(*d)
    for name in dense_kernel.OPS:
        sh = dense_kernel.launch_shape(40, 70, 50, 16, torch.float32, name)
        dense_ops.phi_mu_dense(*d), dense_ops.mttkrp_dense(*d[:3])
        torch.cuda.synchronize()
        assert not dense_kernel.workspace(sh, card)[1].any(), name
    assert torch.equal(dense_ops.phi_dense(*d), first)


@pytest.mark.cuda
def test_dense_nan_reaches_its_row(card):
    """A NaN in B makes its row of Φ and mu NaN, and viol NaN; a NaN in x
    reaches its row of M (and, failing x > 0, adds nothing to Φ)."""
    x, c, a, b = (t.to(card) for t in _random_dense((4, 20, 24), 5,
                                                     torch.float32, 9))
    b2 = b.clone()
    b2[2, 3] = float("nan")
    phi = dense_ops.phi_dense(x, c, a, b2)
    mu, viol = dense_ops.phi_mu_dense(x, c, a, b2)
    assert torch.isnan(phi).any(dim=1).nonzero().flatten().tolist() == [2]
    assert torch.isnan(mu).any(dim=1).nonzero().flatten().tolist() == [2]
    assert torch.isnan(viol)
    x2 = x.clone()
    x2[1, 7, 5] = float("nan")
    m = dense_ops.mttkrp_dense(x2, c, a)
    assert torch.isnan(m).any(dim=1).nonzero().flatten().tolist() == [7]
    assert not torch.isnan(dense_ops.phi_dense(x2, c, a, b)).any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_dense_smem_bytes_equals_the_kernels(card, dtype):
    for op in dense_kernel.OPS:
        for rank in (1, 3, 16, 33, 64, 200, 1024):
            for ti, jc in ((4, 8), (32, 128), (16, 256), (8, 24)):
                assert dense_kernel.library_smem_bytes(
                    rank, ti, jc, dtype, op) == dense_kernel.smem_bytes(
                    rank, ti, jc, dtype, op), (op, rank, ti, jc)


@pytest.mark.cuda
def test_dense_launcher_rejects_bad_shapes(card):
    x, c, a, b = (t.to(card) for t in _random_dense((4, 8, 16), 4,
                                                     torch.float32, 1))
    good = dense_kernel.launch_shape(4, 8, 16, 4)
    for bad in (dict(ti=6), dict(jc=12), dict(n_ks=5), dict(n_ks=0)):
        sh = dataclasses.replace(good, **bad)
        phi = torch.empty(8, 4, device=card)
        part, tickets = dense_kernel.workspace(good, card)
        with pytest.raises(RuntimeError, match="cudaError"):
            dense_kernel.launch_phi(x, c, a, b, phi, part, tickets, sh,
                                    eps=1e-10)


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


# --- STREAM (stream.cu) ------------------------------------------------------

# 37 tiles of 128 x 256: a length that is not a power of two times the tile
STREAM_LEN = 128 * 256 * 37
_BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16}


def _stream_arrays(n, dtype, card):
    rng = np.random.RandomState(5)
    return tuple(torch.from_numpy(rng.standard_normal(n).astype(np.float32))
                 .to(dtype).to(card) for _ in range(2))


def _check_stream(op, b, c, block_rows=256, s=3.0):
    name = f"stream_{op}"
    before = stream_ops.launch_counts[name]
    got = stream_ops.stream_op(op, b, c, block_rows=block_rows, s=s)
    torch.cuda.synchronize()
    assert stream_ops.launch_counts[name] == before + 1
    assert got.dtype == b.dtype and got.shape == b.shape
    assert got.data_ptr() not in (b.data_ptr(), c.data_ptr())
    want = stream_ref(op, b, c if op in ("add", "triad") else None, s=s)
    bits = _BITS[b.dtype]
    assert torch.equal(got.view(bits), want.view(bits)), \
        f"{name} {b.dtype} block_rows={block_rows}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("op", stream_ops.STREAM_OPS)
def test_stream_kernel_bitwise_equals_plain_version(card, op, dtype):
    b, c = _stream_arrays(STREAM_LEN, dtype, card)
    _check_stream(op, b, c)


@pytest.mark.cuda
@pytest.mark.parametrize("block_rows", (1, 8, 37))
def test_stream_kernel_across_block_rows(card, block_rows):
    for dtype in (torch.float32, torch.bfloat16):
        b, c = _stream_arrays(128 * block_rows * 5, dtype, card)
        for op in stream_ops.STREAM_OPS:
            _check_stream(op, b, c, block_rows=block_rows, s=-1.7)


@pytest.mark.cuda
@pytest.mark.parametrize("block_rows", (1, 3, 5))
def test_stream_kernel_at_odd_tile_counts(card, block_rows):
    """n = 128*k for odd k (a ragged last CTA), bitwise, under
    several block_rows; the launch shape ignores block_rows."""
    for k_tiles in (1, 3, 7, 129, 1025):
        n = 128 * block_rows * k_tiles
        for dtype in (torch.float32, torch.bfloat16):
            b, c = _stream_arrays(n, dtype, card)
            for op in stream_ops.STREAM_OPS:
                _check_stream(op, b, c, block_rows=block_rows, s=0.7)


@pytest.mark.cuda
def test_stream_kernel_rejects_what_it_cannot_take(card):
    big = torch.zeros(128 * 257, device=card)
    with pytest.raises(ValueError, match="16-byte aligned"):
        stream_ops.stream_op("copy", big[1:1 + 128 * 256])
    with pytest.raises(ValueError, match="contiguous"):
        stream_ops.stream_op("copy", torch.zeros(128 * 512, device=card)[::2])
    with pytest.raises(ValueError, match="b on"):
        stream_ops.stream_op("add", big[:128 * 256],
                             torch.zeros(128 * 256))
    before = dict(stream_ops.launch_counts)
    empty = stream_ops.stream_op("triad", big[:0], big[:0])
    assert empty.shape == (0,) and stream_ops.launch_counts == before


@pytest.mark.cuda
def test_detect_hardware_spec_on_the_card(card):
    name = torch.cuda.get_device_name()
    if "H100" in name and "PCIe" not in name and "NVL" not in name:
        assert roofline.detect_hardware_spec() is \
            roofline.HARDWARE["h100_sxm"]
    else:
        with pytest.raises(ValueError, match=re.escape(name)):
            roofline.detect_hardware_spec()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", FIXTURES)
def test_heuristic_policy_without_platform_on_the_card(card, kind):
    """With a card and no ``platform`` the heuristic picks the Φ kernel,
    as the JAX package's picks its accelerator's schedule."""
    from repro_torch.core.layout import mode_run_stats
    from repro_torch.core.policy import heuristic_policy

    t, _ = fixture(kind)
    mv = sort_mode(t, 0)
    stats = mode_run_stats(mv.rows.numpy(), mv.n_rows)
    for st in (None, stats):
        pol = heuristic_policy(t.nnz, mv.n_rows, RANK, stats=st)
        assert pol == heuristic_policy(t.nnz, mv.n_rows, RANK,
                                       platform="cuda", stats=st)
        assert pol.strategy == "cuda"


# --- the degradation ladder and the autotuner on the card -------------------


@pytest.mark.cuda
def test_card_limit_refusal_demotes_cuda_to_blocked(card):
    """A real, unsimulated demotion: at rank 1025 the Φ kernel's wrapper
    refuses the launch before it starts (``check_card_limits``), the
    ladder demotes the mode ``cuda -> blocked`` with its record, and the
    solve finishes on the card."""
    from repro_torch.core.sparse_tensor import random_poisson_tensor as rpt

    t, _ = rpt(5, (12, 10, 8), nnz=200, rank=4, device="cpu")
    kt = random_ktensor(6, t.shape, 1025, device="cpu")
    ops.reset_launch_counts()
    res = P_cpapr.cpapr_mu(t, 1025, init=kt, device=card,
                           config=P_cpapr.CPAPRConfig(
                               rank=1025, max_outer=2, strategy="cuda",
                               max_demotions=4))
    assert ops.launch_counts == {"phi_blocked": 0, "phi_mu_blocked": 0}
    kinds = [(e.kind, e.mode, e.detail["action"]) for e in res.recoveries]
    assert kinds == [("demote_kernel", n, "cuda->blocked") for n in range(3)]
    assert "rank 1025 outside 1..1024" in res.recoveries[0].detail["error"]
    assert res.n_outer == 2 and np.isfinite(res.loglik_history).all()


@pytest.mark.cuda
def test_card_limit_refusal_raises_without_the_ladder(card):
    """The ladder is off by default: the refused launch reaches the
    caller instead of a run of the plain version on the card."""
    from repro_torch.core.sparse_tensor import random_poisson_tensor as rpt
    from repro_torch.kernels._checks import CardLimitError

    t, _ = rpt(5, (12, 10, 8), nnz=200, rank=4, device="cpu")
    kt = random_ktensor(6, t.shape, 1025, device="cpu")
    ops.reset_launch_counts()
    with pytest.raises(CardLimitError, match="rank 1025 outside 1..1024"):
        P_cpapr.cpapr_mu(t, 1025, init=kt, device=card,
                         config=P_cpapr.CPAPRConfig(rank=1025, max_outer=2,
                                                    strategy="cuda"))
    assert ops.launch_counts == {"phi_blocked": 0, "phi_mu_blocked": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("strategy", ("cuda", "dense"))
def test_bf16_checkpoint_resumes_on_the_card(card, tmp_path, monkeypatch,
                                              strategy):
    """bf16 values and factors through the kernels: the checkpoint keeps
    the factors' bits without ``ml_dtypes``, and the solve resumes from
    it on the card."""
    from repro_torch.core import resilience

    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    t, kt = fixture("uniform")
    t = dataclasses.replace(t, values=t.values.to(torch.bfloat16))
    kt = type(kt)(lam=kt.lam.to(torch.bfloat16),
                  factors=tuple(f.to(torch.bfloat16) for f in kt.factors))
    ck = str(tmp_path / "ck.bin")
    pol = PhiPolicy(strategy="cuda", block_nnz=BN, block_rows=BR) \
        if strategy == "cuda" else None

    def cfg(max_outer):
        return P_cpapr.CPAPRConfig(rank=RANK, max_outer=max_outer, tol=0.0,
                                   strategy=strategy, policy=pol,
                                   checkpoint_every=1, checkpoint_path=ck)

    first = P_cpapr.cpapr_mu(t, RANK, init=kt, device=card, config=cfg(3))
    saved = resilience.load_checkpoint(ck)
    assert saved["outer"] == 3
    for a, f in zip(saved["factors"], first.ktensor.factors):
        back = resilience.array_to_tensor(a, "cpu")
        assert back.dtype == torch.bfloat16
        assert torch.equal(back.view(torch.int16),
                           f.cpu().view(torch.int16))
    res = P_cpapr.cpapr_mu(t, RANK, init=kt, device=card, config=cfg(5),
                           resume_from=ck)
    assert [e.kind for e in res.recoveries] == ["resume"]
    assert res.n_outer == 5 and len(res.sweep_seconds) == 2
    assert res.loglik_history[:3] == first.loglik_history
    assert all(f.dtype == torch.bfloat16 and bool(torch.isfinite(f).all())
               for f in res.ktensor.factors)


@pytest.mark.cuda
def test_dense_demotion_drops_the_streams_dirty_tickets(card):
    """A dense launch that started and did not complete leaves its
    stream's tickets dirty.  Dirty them by hand, demote a dense mode
    through the ladder, and the next dense call on that stream gets fresh
    tickets and matches its plain version."""
    from repro_torch.testing import faults

    x, c, a, b = _dense_inputs("uniform", 0, torch.float32)
    d = [v.to(card) for v in (x, c, a, b)]
    dense_ops.phi_dense(*d)
    torch.cuda.synchronize()
    dirty = [tk for (dev, _s, *_), (_p, tk) in dense_kernel._WORK.items()
             if dev.type == "cuda"]
    assert dirty
    for tk in dirty:
        tk.fill_(5)
    t, kt = fixture("uniform")
    with faults.fail_strategy(strategy="dense", mode=0) as budget:
        res = P_cpapr.cpapr_mu(t, RANK, init=kt, device=card,
                               config=P_cpapr.CPAPRConfig(
                                   rank=RANK, max_outer=1, strategy="dense",
                                   max_demotions=4))
    assert budget == [0]
    assert [(e.kind, e.detail["action"]) for e in res.recoveries] == [
        ("demote_kernel", "dense->segment")]
    got = dense_ops.phi_dense(*d)
    _close(got, dense_ops.phi_dense(x, c, a, b), TOL, "phi after the drop")
    for (dev, _s, *_), (_p, tk) in dense_kernel._WORK.items():
        assert not tk.any()


@pytest.mark.cuda
@pytest.mark.parametrize("strategy", ("cuda", "blocked", "segment"))
def test_graph_burst_probe_matches_eager_steps(card, strategy):
    """The autotuner's probe: ``burst`` fused MU steps captured in one
    CUDA graph and replayed give what the same steps give eagerly."""
    from repro_torch.perf.autotune import Autotuner
    from repro_torch.perf.timing import graph_burst, step_burst_seconds

    t, kt = fixture("hub")
    mv = sort_mode(t.to(card), 0)
    factors = tuple(f.to(card) for f in kt.factors)
    pi = pi_rows(mv.sorted_idx, factors, 0)
    b = factors[0] * kt.lam.to(card)[None, :]
    pol = PhiPolicy(strategy=strategy, block_nnz=BN, block_rows=BR)
    step, _ = Autotuner(measure=False).probe_step(pol, mv.rows,
                                                  mv.sorted_vals, pi,
                                                  mv.n_rows)
    bb = b
    for _ in range(4):
        bb, viol = step(bb)
    replay, (gb, gviol) = graph_burst(step, b, 4)
    replay()
    torch.cuda.synchronize()
    _close(gb, bb, dict(rtol=1e-4, atol=1e-6), f"graph burst {strategy}")
    _close(gviol, viol, dict(rtol=1e-4, atol=1e-6), f"viol {strategy}")
    assert step_burst_seconds(step, b, 4) > 0.0


@pytest.mark.cuda
def test_policy_auto_on_the_card_is_served_from_the_cache(card, tmp_path):
    from repro_torch.perf.autotune import Autotuner

    t, kt = fixture("uniform")
    path = str(tmp_path / "autotune.json")
    first = Autotuner(cache_path=path, iters=1, warmup=1, burst=2)
    cfg = dict(rank=RANK, max_outer=2, policy="auto")
    res1 = P_cpapr.cpapr_mu(t, RANK, init=kt, device=card,
                            config=P_cpapr.CPAPRConfig(autotuner=first, **cfg))
    assert first.n_searches == 3 and first.n_probes > 0
    second = Autotuner(cache_path=path, iters=1, warmup=1, burst=2)
    res2 = P_cpapr.cpapr_mu(t, RANK, init=kt, device=card,
                            config=P_cpapr.CPAPRConfig(autotuner=second,
                                                       **cfg))
    assert second.n_hits == 3 and second.n_probes == 0
    assert res1.policies == res2.policies
    assert res1.recoveries is None and res2.recoveries is None
    keys = list(second.cache.entries)
    assert len(keys) == 3 and all(k.startswith("v2/cuda/") for k in keys)


# ---------------------------------------------------------------------------
# The decomposition service on the card
# ---------------------------------------------------------------------------


# The card's own run-to-run spread of the job below solved alone through
# its bucket: ``index_add_``'s float atomics reorder each Φ row's sum, and
# 12 sweeps carry the difference to the factors.  The largest relative
# difference between two of 150 alone runs of job 0 was 3.50e-4 (40 runs:
# 3.32e-4; jobs 1 and 2 under 1.6e-6), and a batched run's from any alone
# run 3.23e-4: ``python -m repro_torch.perf.cohort_probe --repeats 150
# --batched-repeats 10`` on an NVIDIA H100 80GB HBM3 at 700 W.
CARD_SPREAD = dict(rtol=3.5e-4, atol=1e-6)


@pytest.mark.cuda
def test_batched_tier_cohort_independent_on_the_card(card):
    """A job solved in a 3-job bucket agrees with the job solved alone
    through the same bucket: equal sweep and inner counts, and factors
    within the card's own run-to-run spread (``CARD_SPREAD``), which two
    alone runs of the job must meet as well."""
    from repro_torch.serve.batch import batched_cpapr_mu

    rank = 3
    ts = [random_poisson_tensor(20 + j, (17, 11, 9), nnz=500, rank=rank,
                                device="cpu")[0] for j in range(3)]
    cfg = P_cpapr.CPAPRConfig(rank=rank, max_outer=12, tol=1e-3,
                              track_loglik=False)
    res3, bucket = batched_cpapr_mu(ts, rank, seeds=[100, 101, 102],
                                    config=cfg, device=card)
    for j in range(3):
        alone = [batched_cpapr_mu([ts[j]], rank, seeds=[100 + j],
                                  config=cfg, bucket=bucket,
                                  device=card)[0][0] for _ in range(2)]
        for res1, other, what in ((alone[0], res3[j], "batched"),
                                  (alone[0], alone[1], "alone again")):
            assert res1.n_outer == other.n_outer
            assert res1.inner_iters == other.inner_iters
            _close(other.ktensor.lam, res1.ktensor.lam, CARD_SPREAD,
                   f"lam job {j}, {what}")
            for a, b in zip(other.ktensor.factors, res1.ktensor.factors):
                assert a.device.type == "cuda"
                _close(a, b, CARD_SPREAD, f"factor job {j}, {what}")


@pytest.mark.cuda
def test_service_warm_append_runs_the_phi_kernels_counted(card, tmp_path):
    """A tenant's cold submit and warm append resolve every mode to the Φ
    kernels on the card: ``phi_blocked`` once per mode update and
    ``phi_mu_blocked`` once per inner iteration, in both solves."""
    from repro_torch.serve.decomp import DecompService

    t, kt = fixture("uniform")
    svc = DecompService(autotune_path=str(tmp_path / "at.json"),
                        max_outer=3, device=card)
    extra, _ = random_poisson_tensor(9, t.shape, nnz=t.nnz // 10, rank=RANK,
                                     seed_ktensor=kt, device="cpu")
    for step in ("submit", "append"):
        ops.reset_launch_counts()
        got = (svc.submit("a", t, RANK, init=kt) if step == "submit"
               else svc.append("a", extra.indices, extra.values))
        torch.cuda.synchronize()
        res = got.result
        assert [p.strategy for p in res.policies] == ["cuda"] * 3, step
        assert res.recoveries is None, step
        assert ops.launch_counts["phi_blocked"] == res.n_outer * 3, step
        assert ops.launch_counts["phi_mu_blocked"] == sum(res.inner_iters)
        assert all(bool(torch.isfinite(f).all()) for f in res.ktensor.factors)
    assert got.warm and got.sweep_budget == 2 and 0 < got.frac_new < 0.2


@pytest.mark.cuda
def test_dense_workspaces_stay_bounded_on_the_card(card):
    """Many dense shapes on one stream keep WORK_MAX workspaces there,
    every call still matches its plain version, and a CUDA graph replays
    right after the workspaces it captured were dropped from the cache
    (the graph holds them)."""
    from repro_torch.perf.timing import graph_burst

    def operands(k, i):
        g = torch.Generator().manual_seed(k * 1000 + i)
        x = torch.rand((k, i, 16), generator=g)
        x[x < 0.5] = 0.0
        c, a = torch.rand((16, 4), generator=g), torch.rand((k, 4),
                                                            generator=g)
        return x, c, a, torch.rand((i, 4), generator=g)

    x, c, a, b = operands(3, 8)
    d = [v.to(card) for v in (x, c, a)]
    replay, (g_mu, _) = graph_burst(
        lambda bb: dense_ops.phi_mu_dense(*d, bb), b.to(card), 2)
    held = replay.__self__.held_workspaces
    assert held
    sizes = [(2 + n, 8 + 8 * n) for n in range(3 * dense_kernel.WORK_MAX)]
    keys = {(sh.part_numel, sh.n_tickets) for sh in
            (dense_kernel.launch_shape(k, i, 16, 4, op="dense_phi")
             for k, i in sizes)}
    assert len(keys) > dense_kernel.WORK_MAX  # the flood overflows the bound
    # flood the stream the graph was captured on, so its workspaces go
    capture = torch.cuda.graph.default_capture_stream
    with torch.cuda.stream(capture):
        for n, (k, i) in enumerate(sizes):
            xs = operands(k, i)
            got = dense_ops.phi_dense(*(v.to(card) for v in xs))
            _close(got, dense_ops.phi_dense(*xs), TOL, f"phi shape {n}")
    torch.cuda.synchronize()
    per_stream: dict = {}
    for key in dense_kernel._WORK:
        if key[0].type == "cuda":
            per_stream[key[1]] = per_stream.get(key[1], 0) + 1
    assert per_stream[capture.cuda_stream] == dense_kernel.WORK_MAX
    assert max(per_stream.values()) <= dense_kernel.WORK_MAX
    kept = [ws[0] for ws in dense_kernel._WORK.values()]
    assert not any(p is ws[0] for ws in held for p in kept)
    replay()
    torch.cuda.synchronize()
    want = b
    for _ in range(2):
        want, _ = dense_ops.phi_mu_dense(x, c, a, want)
    _close(g_mu, want, TOL, "graph replay after its workspaces were dropped")


# --- the row-sharded tier: B2 and B3 once per shard ------------------------


def _sharded_inputs(kind, mode, n_shards, card):
    from repro_torch.core.layout import build_shard_pi_gather, shard_blocked_layout
    from repro_torch.core.phi import expand_to_shards

    t, kt = fixture(kind)
    mv = sort_mode(t, mode)
    sl = shard_blocked_layout(
        build_blocked_layout(mv.rows.numpy(), mv.n_rows, BN, BR), n_shards)
    pi = pi_rows(mv.sorted_idx, kt.factors, mode)
    vals_es, pi_es = expand_to_shards(sl, mv.sorted_vals, pi)
    pig = build_shard_pi_gather(sl, mv.sorted_idx, mode)
    b = kt.factors[mode] * kt.lam[None, :]
    factors = tuple(f.to(card) for f in kt.factors)
    return sl, pig, vals_es.to(card), pi_es.to(card), b.to(card), factors


@pytest.mark.cuda
@pytest.mark.parametrize("n_shards", (2, 4))
@pytest.mark.parametrize("kind", FIXTURES)
def test_sharded_kernels_per_shard(card, kind, n_shards):
    """Each sharded Φ and MTTKRP call (both combines, replicated and
    shard-local Π) launches B2 and B3 exactly once per shard on slices of
    the shard stack, agrees with the plain blocked schedule, and each
    shard's kernel window is exactly zero on its padding rows."""
    from repro_torch.core import distributed as D

    for mode in MODES:
        sl, pig, vals_es, pi_es, b, factors = _sharded_inputs(
            kind, mode, n_shards, card)
        for combine in D.PHI_COMBINES:
            for local_pi in (False, True):
                kw = dict(combine=combine)
                if local_pi:
                    kw.update(pi_gather=pig, factors=factors)
                before = (ops.launch_counts["phi_blocked"],
                          mttkrp_ops.launch_counts["mttkrp_blocked"])
                phi = D.phi_sharded(sl, vals_es, pi_es, b,
                                    local_strategy="cuda", **kw)
                kr = D.krao_sharded(sl, vals_es, pi_es,
                                    local_strategy="cuda", **kw)
                torch.cuda.synchronize()
                assert (ops.launch_counts["phi_blocked"] - before[0],
                        mttkrp_ops.launch_counts["mttkrp_blocked"]
                        - before[1]) == (n_shards, n_shards)
                what = f"{kind} mode {mode} S={n_shards} {combine} {local_pi}"
                _close(phi, D.phi_sharded(sl, vals_es, pi_es, b, **kw), TOL,
                       f"phi {what}")
                _close(kr, D.krao_sharded(sl, vals_es, pi_es, **kw), TOL,
                       f"krao {what}")
        st = sl.on(card)
        b_buf = pad_rows(b, sl.buf_rows)
        for s in range(n_shards):
            r0 = int(sl.rb_start[s]) * sl.block_rows
            real = int(sl.rb_count[s]) * sl.block_rows
            args = (vals_es[s], pi_es[s], st.local_rows[s], st.grid_rb[s])
            for win in (D._shard_window(sl, 1e-10, "cuda", *args,
                                        b_buf[r0:r0 + sl.win_rows]),
                        D._shard_window(sl, 0.0, "cuda", *args, None)):
                assert not win[real:].any(), (kind, mode, s)


@pytest.mark.cuda
@pytest.mark.parametrize("combine", ("psum", "reduce_scatter"))
def test_sharded_solves_on_the_card(card, combine):
    """Sharded CP-APR and CP-ALS with the local cuda kernels: B2 per shard
    per inner step, B3 per shard per mode update, results within TOL of
    the blocked-local solves."""
    t, kt = fixture("uniform")
    pol = PhiPolicy(strategy="cuda", block_nnz=BN, block_rows=BR)
    cfg = P_cpapr.CPAPRConfig(rank=RANK, max_outer=3, strategy="sharded",
                              n_shards=2, combine=combine, policy=pol)
    before = dict(ops.launch_counts)
    got = P_cpapr.cpapr_mu(t, RANK, init=kt, config=cfg, device="cuda")
    b2 = ops.launch_counts["phi_blocked"] - before["phi_blocked"]
    assert b2 == 2 * (got.n_outer * t.ndim + sum(got.inner_iters))
    assert ops.launch_counts["phi_mu_blocked"] == before["phi_mu_blocked"]
    want = P_cpapr.cpapr_mu(t, RANK, init=kt, device="cpu",
                            config=dataclasses.replace(cfg, policy=PhiPolicy(
                                strategy="blocked", block_nnz=BN,
                                block_rows=BR)))
    assert got.inner_iters == want.inner_iters
    np.testing.assert_allclose(got.loglik_history, want.loglik_history,
                               **TOL)
    before = mttkrp_ops.launch_counts["mttkrp_blocked"]
    fits = P_cpals.cp_als(t, RANK, n_iters=2, init=kt, strategy="sharded",
                          n_shards=2, combine=combine, policy=pol,
                          device="cuda")[1]
    assert mttkrp_ops.launch_counts["mttkrp_blocked"] - before == 2 * 2 * 3
    want = P_cpals.cp_als(t, RANK, n_iters=2, init=kt, strategy="sharded",
                          n_shards=2, combine=combine, device="cpu",
                          policy=PhiPolicy(strategy="blocked", block_nnz=BN,
                                           block_rows=BR))[1]
    np.testing.assert_allclose(fits, want, rtol=1e-5, atol=1e-6)


# --- the N-D grid tier: B2 and B3 once per grid cell ------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ((1, 2), (2, 2), (1, 4), (4, 1)),
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", FIXTURES)
def test_grid_kernels_per_cell(card, kind, shape):
    """Each grid Φ, MTTKRP and fused-step call launches B2 or B3 exactly
    once per cell, agrees with the plain blocked cells, and every cell's
    kernel window is exactly zero past its shard's real rows."""
    from repro_torch.core import distributed as D
    from repro_torch.core.layout import build_grid_layout
    from repro_torch.core.phi import expand_to_grid

    t, kt = fixture(kind)
    cells = shape[0] * shape[1]
    for mode in MODES:
        mv = sort_mode(t, mode)
        g = build_grid_layout(
            build_blocked_layout(mv.rows.numpy(), mv.n_rows, BN, BR), shape)
        pi = pi_rows(mv.sorted_idx, kt.factors, mode)
        vals_cs, pi_cs = (x.to(card) for x in
                          expand_to_grid(g, mv.sorted_vals, pi))
        b = (kt.factors[mode] * kt.lam[None, :]).to(card)
        what = f"{kind} mode {mode} grid {shape}"
        before = dict(ops.launch_counts)
        phi = D.phi_grid(g, vals_cs, pi_cs, b, local_strategy="cuda")
        mu, viol = D.phi_mu_grid(g, vals_cs, pi_cs, b, local_strategy="cuda")
        b3 = mttkrp_ops.launch_counts["mttkrp_blocked"]
        kr = D.krao_grid(g, vals_cs, pi_cs, local_strategy="cuda")
        torch.cuda.synchronize()
        assert ops.launch_counts["phi_blocked"] - before["phi_blocked"] \
            == 2 * cells, what
        assert ops.launch_counts["phi_mu_blocked"] \
            == before["phi_mu_blocked"], what
        assert mttkrp_ops.launch_counts["mttkrp_blocked"] - b3 == cells
        _close(phi, D.phi_grid(g, vals_cs, pi_cs, b), TOL, f"phi {what}")
        _close(kr, D.krao_grid(g, vals_cs, pi_cs), TOL, f"krao {what}")
        want_mu, want_viol = D.phi_mu_grid(g, vals_cs, pi_cs, b)
        _close(mu, want_mu, TOL, f"mu {what}")
        _close(viol.reshape(1), want_viol.reshape(1), TOL, f"viol {what}")
        st = g.on(card)
        b_own = D.grid_stack(g, b)
        own = g.slayout.n_rb_shard * g.block_rows
        for f in range(cells):
            s = f // g.grid_b
            b_win = b_own[s * g.grid_b:(s + 1) * g.grid_b].reshape(
                g.own_rows_pad, -1)[:own]
            real = int(g.slayout.rb_count[s]) * g.block_rows
            args = (vals_cs[f], pi_cs[f], st.local_rows[f], st.grid_rb[f])
            for win in (D._shard_window(g.slayout, 1e-10, "cuda", *args,
                                        b_win),
                        D._shard_window(g.slayout, 0.0, "cuda", *args,
                                        None)):
                assert not win[real:].any(), (what, f)


@pytest.mark.cuda
def test_grid_solves_on_the_card(card):
    """Grid CP-APR and CP-ALS with the cell-local cuda kernels: B2 once
    per cell per scooch and inner step and B1 never, B3 once per cell per
    mode update, results within TOL of the blocked-local solves."""
    t, kt = fixture("hub")
    pol = PhiPolicy(strategy="cuda", block_nnz=BN, block_rows=BR)
    cfg = P_cpapr.CPAPRConfig(rank=RANK, max_outer=3, strategy="grid",
                              n_shards=4, grid_shape=(2, 2), policy=pol)
    before = dict(ops.launch_counts)
    got = P_cpapr.cpapr_mu(t, RANK, init=kt, config=cfg, device="cuda")
    b2 = ops.launch_counts["phi_blocked"] - before["phi_blocked"]
    assert b2 == 4 * (got.n_outer * t.ndim + sum(got.inner_iters))
    assert ops.launch_counts["phi_mu_blocked"] == before["phi_mu_blocked"]
    assert got.recoveries is None
    blocked = PhiPolicy(strategy="blocked", block_nnz=BN, block_rows=BR)
    want = P_cpapr.cpapr_mu(t, RANK, init=kt, device="cpu",
                            config=dataclasses.replace(cfg, policy=blocked))
    assert got.inner_iters == want.inner_iters
    np.testing.assert_allclose(got.loglik_history, want.loglik_history,
                               **TOL)
    from repro_torch.core import resilience

    cells: dict = {}

    def seen(ctx):
        cells[ctx["mode"]] = ctx["n_shards"]

    before = mttkrp_ops.launch_counts["mttkrp_blocked"]
    resilience.register_mode_hook(seen)
    try:
        fits = P_cpals.cp_als(t, RANK, n_iters=2, init=kt, strategy="grid",
                              n_shards=4, policy=pol, device="cuda")[1]
    finally:
        resilience.unregister_mode_hook(seen)
    assert mttkrp_ops.launch_counts["mttkrp_blocked"] - before \
        == 2 * sum(cells.values())
    want = P_cpals.cp_als(t, RANK, n_iters=2, init=kt, strategy="grid",
                          n_shards=4, policy=blocked, device="cpu")[1]
    np.testing.assert_allclose(fits, want, rtol=1e-5, atol=1e-6)


# --- the communication model: recorded collectives, dense operands ---------


@pytest.mark.cuda
def test_recorder_on_a_one_rank_nccl_group(card):
    """On a one-rank NCCL group with the local cuda kernels, under
    ``perf.comm.record_collectives``: the fused owner step issues one
    reduce-scatter of the owned slice and a scalar KKT max and no
    all-gather, the psum Φ one all-reduce of the combine buffer, the
    (1, 1) grid's fused step the KKT max alone (no column collective);
    each recorded result has the model's bytes at its own itemsize, and
    one rank moves no wire."""
    from repro_torch.core import distributed as D
    from repro_torch.core.layout import build_grid_layout, owner_partition
    from repro_torch.core.phi import expand_to_grid
    from repro_torch.launch.train import process_group
    from repro_torch.perf import comm

    sl, _, vals_es, pi_es, b, _ = _sharded_inputs("uniform", 0, 1, card)
    opart = owner_partition(sl)
    t, kt = fixture("uniform")
    mv = sort_mode(t, 0)
    g = build_grid_layout(
        build_blocked_layout(mv.rows.numpy(), mv.n_rows, BN, BR), (1, 1))
    vals_cs, pi_cs = (x.to(card) for x in expand_to_grid(
        g, mv.sorted_vals, pi_rows(mv.sorted_idx, kt.factors, 0)))
    with process_group(card):
        mesh = D.make_phi_mesh(1)
        with comm.record_collectives() as owner:
            D.phi_mu_sharded_owner(sl, opart, vals_es, pi_es,
                                   D.owner_stack(opart, b, mesh), mesh=mesh,
                                   local_strategy="cuda")
        with comm.record_collectives() as psum:
            D.phi_sharded(sl, vals_es, pi_es, b, mesh=mesh,
                          local_strategy="cuda")
        gmesh = D.make_grid_mesh(1, 1)
        with comm.record_collectives() as grid:
            D.phi_mu_grid_owner(g, vals_cs, pi_cs, D.grid_stack(g, b, gmesh),
                                mesh=gmesh, local_strategy="cuda")
        torch.cuda.synchronize()
    assert [(c.kind, c.tag, c.group_size) for c in owner] == [
        ("reduce-scatter", "data", 1), ("all-reduce", "data", 1)]
    assert [(c.kind, c.tag) for c in psum] == [("all-reduce", "data")]
    assert [(c.kind, c.tag) for c in grid] == [("all-reduce", "world")]
    isz = owner[0].itemsize
    assert owner[0].bytes == opart.scatter_bytes(RANK, isz)
    assert psum[0].bytes == D.sharded_combine_bytes(sl, RANK, isz)
    assert comm.collective_stats(owner + psum + grid).wire_bytes == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_dense_wrappers_hand_their_kernels_dense_input_bytes(card, dtype,
                                                             monkeypatch):
    """The operands B4-B6's wrappers hand their kernels' launchers are
    ``perf.comm.dense_input_bytes`` exactly (unpadded: the port pads
    nothing), on every mode of the uniform fixture."""
    from repro_torch.perf import comm

    seen: dict = {}
    for fn, n_in in (("launch_mttkrp", 3), ("launch_phi", 4),
                     ("launch_phi_mu", 4)):
        def spy(*args, _fn=getattr(dense_kernel, fn), _name=fn, _n=n_in,
                **kw):
            seen[_name] = sum(comm.entry_parameter_bytes(args[:_n]))
            return _fn(*args, **kw)

        monkeypatch.setattr(dense_kernel, fn, spy)
    for mode in MODES:
        x, c, a, b = (v.to(card) for v in _dense_inputs("uniform", mode,
                                                        dtype))
        dense_ops.mttkrp_dense(x, c, a)
        dense_ops.phi_dense(x, c, a, b)
        dense_ops.phi_mu_dense(x, c, a, b)
        torch.cuda.synchronize()
        k, i, j = x.shape
        isz = x.element_size()
        assert seen == {
            "launch_mttkrp": comm.dense_input_bytes(k, i, j, RANK, isz),
            "launch_phi": comm.dense_input_bytes(k, i, j, RANK, isz,
                                                 with_b=True),
            "launch_phi_mu": comm.dense_input_bytes(k, i, j, RANK, isz,
                                                    with_b=True)}, mode


# ---------------------------------------------------------------------------
# LM serving: the card against the CPU (plain PyTorch ops, no kernel here)
# ---------------------------------------------------------------------------

LM_RTOL, LM_ATOL = 1e-4, 1e-5  # reduced f32 configs, card vs CPU


def _lm(name):
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.models.api import build_model

    cfg = reduced(ARCHS[name])
    return cfg, build_model(cfg)


def _lm_on(dev, params, batch):
    from repro_torch.models.params import tree_map

    return (tree_map(lambda t: t.to(dev), params),
            {k: v.to(dev) for k, v in batch.items()})


@pytest.mark.cuda
@pytest.mark.parametrize("name", ("granite-8b", "h2o-danube-1.8b",
                                  "llama4-maverick-400b-a17b", "mamba2-1.3b",
                                  "olmo-1b", "pixtral-12b",
                                  "qwen3-moe-235b-a22b", "recurrentgemma-9b",
                                  "stablelm-3b", "whisper-medium"))
def test_lm_prefill_and_decode_card_against_cpu(card, name):
    """The same weights and prompt on both devices: prefill and three
    decode steps fed the CPU's greedy tokens, logits and caches within
    LM_RTOL/LM_ATOL (TF32 is off by default for matmuls)."""
    from repro_torch.config import ShapeConfig
    from repro_torch.models.params import tree_leaves

    cfg, model = _lm(name)
    params = model.init(0, device="cpu")
    batch = model.make_batch(1, ShapeConfig("p", 24, 2, "prefill"),
                             device="cpu")
    p_dev, b_dev = _lm_on(card, params, batch)
    cache_len = 24 + cfg.n_patches + 3
    lc, cc = model.prefill(params, batch, cache_len=cache_len)
    ld, cd = model.prefill(p_dev, b_dev, cache_len=cache_len)
    for step in range(4):
        np.testing.assert_allclose(ld.cpu().numpy(), lc.numpy(),
                                   rtol=LM_RTOL, atol=LM_ATOL,
                                   err_msg=f"step {step}")
        for a, b in zip(tree_leaves(cd), tree_leaves(cc)):
            np.testing.assert_allclose(a.cpu().float().numpy(),
                                       b.float().numpy(), rtol=LM_RTOL,
                                       atol=LM_ATOL)
        if step < 3:
            tok = torch.argmax(lc, dim=-1)[:, None]
            lc, cc = model.decode_step(params, cc, tok)
            ld, cd = model.decode_step(p_dev, cd, tok.to(card))


@pytest.mark.cuda
def test_lm_ring_cache_crosses_the_window_on_the_card(card):
    """Reduced h2o-danube (window 16), prompt 24: the card's ring keeps
    the last 16 positions at slot pos % 16, and each decode step writes
    the next slot."""
    from repro_torch.config import ShapeConfig

    _, model = _lm("h2o-danube-1.8b")
    params = model.init(0, device=card)
    batch = model.make_batch(1, ShapeConfig("p", 24, 2, "prefill"),
                             device=card)
    _, caches = model.prefill(params, batch, cache_len=30)
    want = np.arange(8, 24)
    want = want[np.argsort(want % 16)]
    for row in caches["kv_pos"].reshape(-1, 16).cpu().numpy():
        np.testing.assert_array_equal(row, want)
    tok = batch["tokens"][:, -1:]
    for pos in (24, 25):
        _, caches = model.decode_step(params, caches, tok)
        assert bool((caches["kv_pos"][..., pos % 16] == pos).all())
        assert bool((caches["pos"] == pos + 1).all())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ("olmo-1b", "mamba2-1.3b",
                                  "recurrentgemma-9b", "whisper-medium"))
def test_lm_engine_decode_steps_on_the_card(card, name):
    """n new tokens cost exactly n-1 decode steps on the card, and the
    greedy tokens equal the CPU engine's on the same weights."""
    from repro_torch.config import ShapeConfig
    from repro_torch.serve.engine import Engine, ServeConfig

    cfg, model = _lm(name)

    class Counting:
        calls = 0

        def prefill(self, *a, **k):
            return model.prefill(*a, **k)

        def decode_step(self, *a):
            Counting.calls += 1
            return model.decode_step(*a)

    params = model.init(0, device="cpu")
    batch = model.make_batch(1, ShapeConfig("p", 16, 2, "prefill"),
                             device="cpu")
    p_dev, b_dev = _lm_on(card, params, batch)
    got = Engine(Counting(), p_dev, ServeConfig(max_new_tokens=6),
                 device=card).generate(b_dev)
    assert Counting.calls == 5 and got.device.type == "cuda"
    want = Engine(model, params, ServeConfig(max_new_tokens=6),
                  device="cpu").generate(batch)
    assert torch.equal(got.cpu(), want)


# ---------------------------------------------------------------------------
# LM training: matmul_f32's backward and a train step, card against CPU
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("shapes", (((3, 5, 64), (64, 48)),
                                    ((2, 4, 16, 64), (2, 4, 64, 24)),
                                    ((2, 1, 16, 64), (1, 4, 64, 24))))
def test_matmul_f32_backward_on_the_card(card, shapes):
    """bf16 operands on the card (cuBLAS ``out_dtype`` product): the
    output is the f32 product of the upcast operands, and each gradient
    is that product's gradient cast to bf16 (JAX's transpose rule), to
    one bf16 rounding (rtol 2^-7)."""
    from repro_torch.models.layers import matmul_f32

    gen = torch.Generator(device=card).manual_seed(0)
    sa, sb = shapes
    a = torch.randn(sa, generator=gen, device=card).to(torch.bfloat16)
    b = torch.randn(sb, generator=gen, device=card).to(torch.bfloat16)
    out_shape = torch.broadcast_shapes(sa[:-2], sb[:-2]) + (sa[-2], sb[-1])
    w = torch.randn(out_shape, generator=gen, device=card)
    a1, b1 = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
    out = matmul_f32(a1, b1)
    assert out.dtype == torch.float32
    ga, gb = torch.autograd.grad((out * w).sum(), (a1, b1))
    a2 = a.float().requires_grad_(True)
    b2 = b.float().requires_grad_(True)
    want = torch.matmul(a2, b2)
    wa, wb = torch.autograd.grad((want * w).sum(), (a2, b2))
    np.testing.assert_allclose(out.detach().cpu().numpy(),
                               want.detach().cpu().numpy(), rtol=LM_RTOL,
                               atol=LM_ATOL)
    for got, ref in ((ga, wa), (gb, wb)):
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   ref.to(torch.bfloat16).float().cpu()
                                   .numpy(), rtol=2 ** -7, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ("granite-8b", "h2o-danube-1.8b",
                                  "llama4-maverick-400b-a17b", "mamba2-1.3b",
                                  "olmo-1b", "pixtral-12b",
                                  "qwen3-moe-235b-a22b", "recurrentgemma-9b",
                                  "stablelm-3b", "whisper-medium"))
def test_lm_train_step_card_against_cpu(card, name):
    """One train step with the arch's own optimizer, the same weights and
    batch on both devices: loss, grad norm, every optimizer-state leaf and
    every updated parameter within LM_RTOL/LM_ATOL, the rounding-sensitive
    AdamW/Adafactor entries at their update bound
    (``repro_torch.testing.train_parity``)."""
    from repro_torch.config import ShapeConfig
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.testing.train_parity import compare_states
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.step import make_train_step

    cfg, model = _lm(name)
    lr = 1e-3
    opt = make_optimizer(cfg.optimizer, lr=lr)
    step = make_train_step(model, opt)
    params = model.init(0, device="cpu")
    batch = TokenPipeline(cfg, ShapeConfig("t", 32, 2, "train"), seed=1,
                          device="cpu").make_batch(0)
    s_cpu, m_cpu = step({"params": params, "opt": opt.init(params)}, batch)
    p_dev, b_dev = _lm_on(card, params, batch)
    s_dev, m_dev = step({"params": p_dev, "opt": opt.init(p_dev)}, b_dev)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m_dev[k]), float(m_cpu[k]),
                                   rtol=LM_RTOL, atol=LM_ATOL, err_msg=k)
    assert int(m_dev["step"]) == 1
    cmp = compare_states(s_dev, s_cpu, lr, LM_RTOL, LM_ATOL)
    assert cmp["worst"] <= 1.0 and cmp["sensitive_worst"] <= 1.0, cmp
    assert cmp["n_sensitive_out"] <= 8, cmp
    assert cmp["noise_leaves"] == (["blocks/router"] if cfg.top_k == 1
                                   else []), cmp


@pytest.mark.cuda
@pytest.mark.parametrize("name", ("granite-8b", "h2o-danube-1.8b",
                                  "llama4-maverick-400b-a17b", "mamba2-1.3b",
                                  "olmo-1b", "pixtral-12b",
                                  "qwen3-moe-235b-a22b", "recurrentgemma-9b",
                                  "stablelm-3b", "whisper-medium"))
def test_lm_mesh_step_on_the_card(card, name):
    """The step on a (1, 1) ``("data", "model")`` mesh of a one-rank NCCL
    group, under the arch's own rules, against the unsharded step on the
    card from the same weights and batch: loss, grad norm and every state
    leaf within LM_RTOL/LM_ATOL (the rounding-sensitive entries at their
    update bound); every leaf keeps its placements."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.config import ShapeConfig
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch.mesh import batch_shardings, state_shardings
    from repro_torch.launch.train import process_group
    from repro_torch.models.params import (set_rules_profile, tree_leaves,
                                           tree_map)
    from repro_torch.testing.train_parity import compare_states
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.step import make_train_step, state_specs

    cfg, model = _lm(name)
    lr = 1e-3
    opt = make_optimizer(cfg.optimizer, lr=lr)
    step = make_train_step(model, opt)
    shape = ShapeConfig("t", 32, 2, "train")
    params = model.init(0, device=card)
    batch = TokenPipeline(cfg, shape, seed=1, device=card).make_batch(0)
    state = {"params": params, "opt": opt.init(params)}
    want, m_want = step(state, batch)
    set_rules_profile(cfg.sharding_profile)
    try:
        with process_group(card):
            mesh = init_device_mesh("cuda", (1, 1),
                                    mesh_dim_names=("data", "model"))
            sh = state_shardings(state_specs(model, opt), mesh)
            bsh = batch_shardings(model.input_specs(shape), mesh)
            dstate = tree_map(lambda x, s: s.place(x), state, sh)
            got, m_got = step(dstate, {k: bsh[k].place(v)
                                       for k, v in batch.items()})
            assert all(tuple(a.placements) == tuple(b.placements) for a, b
                       in zip(tree_leaves(got), tree_leaves(dstate)))
            got = tree_map(lambda t: t.to_local(), got)
    finally:
        set_rules_profile("tp_fsdp")
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m_got[k]), float(m_want[k]),
                                   rtol=LM_RTOL, atol=LM_ATOL, err_msg=k)
    cmp = compare_states(got, want, lr, LM_RTOL, LM_ATOL)
    assert cmp["worst"] <= 1.0 and cmp["sensitive_worst"] <= 1.0, cmp
    assert cmp["n_sensitive_out"] <= 8, cmp
    assert cmp["noise_leaves"] == (["blocks/router"] if cfg.top_k == 1
                                   else []), cmp


@pytest.mark.cuda
@pytest.mark.parametrize("shapes", (((3, 5, 64), (64, 48)),
                                    ((2, 4, 16, 64), (2, 4, 64, 24))))
def test_matmul_f32_on_a_card_mesh(card, shapes):
    """``matmul_f32`` of bf16 DTensors on a (1, 1) mesh of a one-rank NCCL
    group (``aten.mm.dtype``/``aten.bmm.dtype`` through their registered
    DTensor rules): product and gradients equal the plain tensors'."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.launch.train import process_group
    from repro_torch.models.layers import matmul_f32

    gen = torch.Generator(device=card).manual_seed(0)
    sa, sb = shapes
    a = torch.randn(sa, generator=gen, device=card).to(torch.bfloat16)
    b = torch.randn(sb, generator=gen, device=card).to(torch.bfloat16)
    a1, b1 = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
    want = matmul_f32(a1, b1)
    wa, wb = torch.autograd.grad(want.sum(), (a1, b1))
    with process_group(card):
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        a2 = distribute_tensor(a, mesh, [Shard(0), Shard(a.dim() - 1)],
                               src_data_rank=None).requires_grad_(True)
        b2 = distribute_tensor(b, mesh, [Shard(b.dim() - 2), Shard(0)],
                               src_data_rank=None).requires_grad_(True)
        got = matmul_f32(a2, b2)
        ga, gb = torch.autograd.grad(got.sum(), (a2, b2))
        got, ga, gb = (t.full_tensor() for t in (got, ga, gb))
    assert got.dtype == torch.float32 and ga.dtype == torch.bfloat16
    for g, w in ((got, want), (ga, wa), (gb, wb)):
        np.testing.assert_allclose(g.detach().float().cpu().numpy(),
                                   w.detach().float().cpu().numpy(),
                                   rtol=LM_RTOL, atol=LM_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("seq,with_h0", ((1, False), (7, True), (300, False),
                                         (4096, True)))
def test_rg_lru_scan_against_sequential_on_the_card(card, seq, with_h0):
    """The log-depth RG-LRU scan (``rg_lru``) against the sequential loop
    (``rg_lru_ref``) on the card: outputs and the gradients of x, h0 and
    every RG-LRU weight within rtol 1e-4 / atol 1e-5, the card's tier for
    reordered f32 sums."""
    from repro_torch.models import rglru

    rtol, atol = 1e-4, 1e-5
    gen = torch.Generator(device=card).manual_seed(seq)
    bsz, w = 2, 64

    def draw(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=card)
                * scale).requires_grad_(True)

    x = draw(bsz, seq, w)
    p = {"w_a": draw(w, w, scale=0.1 / w ** 0.5), "b_a": draw(w, scale=0.1),
         "w_x": draw(w, w, scale=0.1 / w ** 0.5), "b_x": draw(w, scale=0.1),
         "lam": draw(w)}
    h0 = draw(bsz, w) if with_h0 else None
    gy = torch.randn((bsz, seq, w), generator=gen, device=card)
    gh = torch.randn((bsz, w), generator=gen, device=card)
    leaves = [x, *p.values()] + ([h0] if with_h0 else [])
    res = []
    for fn in (rglru.rg_lru, rglru.rg_lru_ref):
        y, h = fn(x, p, h0)
        grads = torch.autograd.grad((y * gy).sum() + (h * gh).sum(), leaves)
        res.append((y, h, *grads))
    for got, want in zip(*res):
        torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
