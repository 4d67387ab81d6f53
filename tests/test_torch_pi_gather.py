"""Π rows in the blocked layout's slot order (``kernels/pi``, ``csrc/pi.cu``).

On the CPU: the wrapper's plain version is bitwise what the ``cuda``
family built before it, ``expand_to_layout`` of the values and
``pi_rows``, on tensors shaped as the conformance fixtures (uniform; hub,
with ~60% of mode-0 nonzeros in row 0) at N = 3, 4 and 5 modes, on padded
layouts, with no nonzero, at R = 16 and R = 6, in f32 and bf16; the
wrapper's checks; a ``cuda`` ``bind_mode`` builds no unexpanded Π and
expands the values once per mode update, in the same call as Π; a
``cuda`` solve of either solver forms Π once per mode update.

On the card (skipped with a reason without one): the kernel equals its
plain version bitwise, values and Π rows, on the same cases, on its
one-element path and on more modes than one launch takes; ``cpapr_mu``
and ``cp_als`` with ``strategy="cuda"`` launch it once per mode update,
call no ``pi_rows``, and launch B1/B2/B3 as often as before.

The file imports neither jax nor the JAX package, so the card tests also
run where only PyTorch is installed:

  PYTHONPATH=src python -m pytest --noconftest -q -rs tests/test_torch_pi_gather.py

Inputs are made with numpy from fixed seeds.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.core import cpals as P_cpals
from repro_torch.core import cpapr as P_cpapr
from repro_torch.core import phi as P_phi
from repro_torch.core.convert import ktensor_from_numpy, sparse_tensor_from_numpy
from repro_torch.core.layout import build_blocked_layout
from repro_torch.core.pi import pi_rows
from repro_torch.core.policy import PhiPolicy
from repro_torch.core.sparse_tensor import sort_mode
from repro_torch.kernels._checks import CardLimitError
from repro_torch.kernels.mttkrp import ops as mttkrp_ops
from repro_torch.kernels.phi import ops as phi_ops
from repro_torch.kernels.pi import ops as pi_ops
from repro_torch.kernels.pi import ref as pi_ref

KINDS = ("uniform", "hub")
SHAPES = {3: (48, 20, 16), 4: (20, 12, 10, 8), 5: (12, 10, 8, 6, 5)}
# R = 16: 16-byte slices in both dtypes; R = 6 (24 and 12 bytes): one
# element a lane
RANKS = (16, 6)
DTYPES = (torch.float32, torch.bfloat16)
# two blockings: 64 x 4 and 16 x 8, both leaving padding slots
BLOCKINGS = ((64, 4), (16, 8))
TOL = dict(rtol=3e-5, atol=1e-5)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only on "
                    "the card); see README")
    return torch.device("cuda")


@functools.lru_cache(maxsize=None)
def problem(kind: str, shape: tuple, rank: int, nnz: int = 1200):
    """(numpy idx, vals, factors) of a conformance-shaped tensor."""
    rng = np.random.RandomState((3 if kind == "hub" else 5) + len(shape))
    idx = np.stack([rng.randint(0, s, size=nnz) for s in shape], axis=1)
    if kind == "hub":
        idx[rng.rand(nnz) < 0.6, 0] = 0
    vals = rng.poisson(2.0, size=nnz).astype(np.float32) + 1.0
    factors = [(rng.rand(s, rank) + 0.1).astype(np.float32) for s in shape]
    return idx, vals, factors


def case(kind, n_modes, rank, dtype, mode, blocking, device="cpu"):
    """(layout, sorted idx, sorted values, factors) of one mode, on
    ``device``, the values and factors in ``dtype``."""
    shape = SHAPES[n_modes]
    idx, vals, factors = problem(kind, shape, rank)
    t = sparse_tensor_from_numpy(shape, idx, vals, device=device)
    mv = sort_mode(t, mode)
    lay = build_blocked_layout(mv.rows, mv.n_rows, *blocking)
    fs = tuple(torch.from_numpy(f).to(device=device, dtype=dtype)
               for f in factors)
    return lay, mv.sorted_idx, mv.sorted_vals.to(dtype), fs


def before(lay, idx, vals, factors, mode):
    """What the ``cuda`` family formed before the kernel: Π gathered per
    nonzero, then expanded with the values into slot order."""
    return P_phi.expand_to_layout(lay, vals, pi_rows(idx, factors, mode))


def assert_pair(got, want, what):
    """Both ``(vals_e, pi_e)`` bitwise."""
    assert_bitwise(got[0], want[0], f"{what}: values")
    assert_bitwise(got[1], want[1], f"{what}: Π rows")


def assert_bitwise(got, want, what):
    assert got.dtype == want.dtype and got.shape == want.shape, what
    assert torch.equal(got.view(torch.int16 if got.dtype == torch.bfloat16
                                else torch.int32),
                       want.view(torch.int16 if want.dtype == torch.bfloat16
                                 else torch.int32)), what


CASES = [(k, n, r, d) for k in KINDS for n in SHAPES for r in RANKS
         for d in DTYPES]


def _id(c):
    return f"{c[0]}-N{c[1]}-R{c[2]}-{str(c[3]).replace('torch.', '')}"


# --- the plain version, on the CPU -------------------------------------------


@pytest.mark.parametrize("c", CASES, ids=_id)
def test_plain_version_is_the_expanded_pi_rows(c):
    kind, n_modes, rank, dtype = c
    padded = 0
    for blocking in BLOCKINGS:
        for mode in range(n_modes):
            lay, idx, vals, fs = case(kind, n_modes, rank, dtype, mode,
                                      blocking)
            padded += int(lay.pad_fraction > 0)
            got = pi_ops.pi_gather(lay, idx, vals, fs, mode)
            assert got[1].shape == (lay.n_grid * lay.block_nnz, rank)
            assert got[0].shape == (lay.n_grid * lay.block_nnz,)
            assert_pair(got, before(lay, idx, vals, fs, mode),
                        f"{c} {blocking} mode {mode}")
            pad = ~lay.on("cpu").valid
            assert not got[0][pad].any() and not got[1][pad].any()
    assert padded >= n_modes


@pytest.mark.parametrize("dtype", DTYPES)
def test_no_nonzero_gives_zeroed_rows(dtype):
    lay = build_blocked_layout(torch.zeros(0, dtype=torch.int64), 10, 16, 4)
    idx = torch.zeros((0, 3), dtype=torch.int64)
    vals = torch.zeros(0, dtype=dtype)
    fs = tuple(torch.rand(s, 16).to(dtype) for s in (10, 7, 5))
    for mode in range(3):
        got = pi_ops.pi_gather(lay, idx, vals, fs, mode)
        assert got[1].shape == (lay.n_grid * lay.block_nnz, 16)
        assert all(x.dtype == dtype and not x.any() for x in got)
        assert_pair(got, before(lay, idx, vals, fs, mode), mode)


def test_wrapper_checks():
    lay, idx, vals, fs = case("uniform", 3, 16, torch.float32, 0,
                              BLOCKINGS[0])
    gather = functools.partial(pi_ops.pi_gather, lay)
    with pytest.raises(ValueError, match="float64"):
        gather(idx, vals.double(), tuple(f.double() for f in fs), 0)
    with pytest.raises(ValueError, match="share one element dtype"):
        gather(idx, vals, (fs[0], fs[1].to(torch.bfloat16), fs[2]), 0)
    with pytest.raises(ValueError, match="share one element dtype"):
        gather(idx, vals.to(torch.bfloat16), fs, 0)
    with pytest.raises(ValueError, match="mode 3 outside"):
        gather(idx, vals, fs, 3)
    with pytest.raises(ValueError, match="int64"):
        gather(idx.int(), vals, fs, 0)
    with pytest.raises(ValueError, match="not \\(nnz, N\\)"):
        gather(idx[:, :2], vals, fs, 0)
    with pytest.raises(ValueError, match="not \\(nnz, N\\)"):
        gather(idx, vals, (fs[0], fs[1][:, :8], fs[2]), 0)
    with pytest.raises(ValueError, match="not \\(nnz, N\\)"):
        gather(idx, vals[1:], fs, 0)
    with pytest.raises(ValueError, match="contiguous"):
        gather(idx, vals, (fs[0], fs[1].t().contiguous().t(), fs[2]), 0)
    with pytest.raises(ValueError, match="contiguous"):
        gather(idx, torch.stack([vals, vals], 1)[:, 0], fs, 0)


# --- the cuda family's inputs, on the CPU ------------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_cuda_bind_forms_no_unexpanded_pi_and_expands_values_once(
        kind, monkeypatch):
    """Binding forms nothing; each ``inputs`` is one ``pi_gather`` call,
    which gives the values and Π in slot order together, and nothing
    else expands the values, so no slot-ordered copy is kept between
    mode updates."""
    shape = SHAPES[3]
    idx, vals, factors = problem(kind, shape, 16)
    t = sparse_tensor_from_numpy(shape, idx, vals, device="cpu")
    fs = tuple(torch.from_numpy(f) for f in factors)
    gathers = _counting(monkeypatch, pi_ops, "pi_gather")
    expands = _counting(monkeypatch, P_phi, "expand_to_layout")
    for mode in range(3):
        mv = sort_mode(t, mode)
        lay = build_blocked_layout(mv.rows, mv.n_rows, *BLOCKINGS[0])
        ops = P_phi.bind_mode("cuda", lay, mv.rows, mv.sorted_vals,
                              mv.n_rows, idx=mv.sorted_idx, mode=mode,
                              device="cpu")
        assert not gathers
        first, second = ops.inputs(fs), ops.inputs(fs)
        assert len(gathers) == 2 and not expands
        del gathers[:]
        assert first[0] is None and first[3] is None
        assert first[1] is not second[1]  # the values, made per update
        want = before(lay, mv.sorted_idx, mv.sorted_vals, fs, mode)
        del expands[:]
        for got in (first, second):
            assert_pair(got[1:3], want, f"{kind} mode {mode}")


def _counting(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)

    def counted(*a, **k):
        calls.append(1)
        return fn(*a, **k)

    monkeypatch.setattr(module, name, counted)
    return calls


def _solver_problem():
    shape = SHAPES[3]
    idx, vals, factors = problem("hub", shape, 4)
    t = sparse_tensor_from_numpy(shape, idx, vals, device="cpu")
    kt = ktensor_from_numpy(np.ones(4, np.float32), factors, "cpu")
    return t, kt


def test_cuda_solves_form_pi_once_per_mode_update(monkeypatch):
    """On the CPU the wrapper runs its plain version, so the calls are
    counted at the wrapper: one a mode update, which expands the values
    too, and no other expansion."""
    t, kt = _solver_problem()
    pol = PhiPolicy(block_nnz=64, block_rows=4)
    gathers = _counting(monkeypatch, pi_ops, "pi_gather")
    expands = _counting(monkeypatch, P_phi, "expand_to_layout")
    res = P_cpapr.cpapr_mu(t, 4, init=kt, device="cpu", config=P_cpapr.
                           CPAPRConfig(rank=4, max_outer=3, strategy="cuda",
                                       policy=pol))
    assert len(gathers) == t.ndim * res.n_outer
    assert not expands
    del gathers[:]
    P_cpals.cp_als(t, 4, n_iters=3, init=kt, strategy="cuda", policy=pol,
                   device="cpu")
    assert len(gathers) == 3 * t.ndim
    assert not expands


# --- the kernel, on the card -------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("c", CASES, ids=_id)
def test_kernel_equals_plain_version(card, c):
    kind, n_modes, rank, dtype = c
    for blocking in BLOCKINGS:
        for mode in range(n_modes):
            lay, idx, vals, fs = case(kind, n_modes, rank, dtype, mode,
                                      blocking, device=card)
            before_count = pi_ops.launch_counts["pi_gather"]
            got = pi_ops.pi_gather(lay, idx, vals, fs, mode)
            assert pi_ops.launch_counts["pi_gather"] == before_count + 1
            torch.cuda.synchronize()
            what = f"{c} {blocking} mode {mode}"
            assert_pair(got, pi_ref.pi_gather_ref(lay, idx, vals, fs, mode),
                        what)
            host = case(kind, n_modes, rank, dtype, mode, blocking)
            assert_pair(tuple(x.cpu() for x in got), before(*host, mode),
                        what)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_no_nonzero_and_one_element_path(card, dtype):
    lay = build_blocked_layout(torch.zeros(0, dtype=torch.int64, device=card),
                               10, 16, 4)
    idx = torch.zeros((0, 3), dtype=torch.int64, device=card)
    vals = torch.zeros(0, dtype=dtype, device=card)
    fs = tuple(torch.rand(s, 16, device=card).to(dtype) for s in (10, 7, 5))
    got = pi_ops.pi_gather(lay, idx, vals, fs, 1)
    torch.cuda.synchronize()
    assert got[1].shape == (lay.n_grid * lay.block_nnz, 16)
    assert got[0].shape == (lay.n_grid * lay.block_nnz,)
    assert not got[0].any() and not got[1].any()
    # a factor that starts 4 bytes past a 16-byte boundary: R = 16 rows
    # then take the one-element path
    lay, idx, vals, fs = case("hub", 3, 16, dtype, 0, BLOCKINGS[0],
                              device=card)
    store = torch.empty(fs[1].numel() + 8, dtype=dtype, device=card)
    shifted = store[2:2 + fs[1].numel()].view_as(fs[1])
    shifted.copy_(fs[1])
    assert shifted.data_ptr() % 16
    got = pi_ops.pi_gather(lay, idx, vals, (fs[0], shifted, fs[2]), 0)
    assert_pair(got, pi_ref.pi_gather_ref(lay, idx, vals, fs, 0),
                "misaligned")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_chains_launches_over_many_modes(card, dtype):
    """Seven modes: six factors, more than one launch multiplies, so a
    second launch multiplies into the first one's rows."""
    shape = (9, 7, 6, 5, 4, 3, 3)
    idx, vals, factors = problem("hub", shape, 16, nnz=900)
    t = sparse_tensor_from_numpy(shape, idx, vals, device=card)
    fs = tuple(torch.from_numpy(f).to(device=card, dtype=dtype)
               for f in factors)
    for mode in (0, 3, 6):
        mv = sort_mode(t, mode)
        lay = build_blocked_layout(mv.rows, mv.n_rows, 64, 4)
        vals = mv.sorted_vals.to(dtype)
        got = pi_ops.pi_gather(lay, mv.sorted_idx, vals, fs, mode)
        assert_pair(got, pi_ref.pi_gather_ref(lay, mv.sorted_idx, vals, fs,
                                              mode), mode)


@pytest.mark.cuda
def test_card_rank_limit(card):
    lay, idx, vals, fs = case("uniform", 3, 16, torch.float32, 0,
                              BLOCKINGS[0], device=card)
    wide = tuple(torch.ones(f.shape[0], 1025, device=card) for f in fs)
    with pytest.raises(CardLimitError, match="rank 1025"):
        pi_ops.pi_gather(lay, idx, vals, wide, 0)


@pytest.mark.cuda
def test_cuda_solves_launch_pi_gather_once_per_mode_update(card, monkeypatch):
    t, kt = _solver_problem()
    pol = PhiPolicy(block_nnz=64, block_rows=4)
    unexpanded = (_counting(monkeypatch, P_phi, "pi_rows")
                  + _counting(monkeypatch, pi_ref, "pi_rows"))
    for ops in (pi_ops, phi_ops, mttkrp_ops):
        ops.reset_launch_counts()
    res = P_cpapr.cpapr_mu(t, 4, init=kt, device=card, config=P_cpapr.
                           CPAPRConfig(rank=4, max_outer=3, strategy="cuda",
                                       policy=pol))
    assert pi_ops.launch_counts["pi_gather"] == t.ndim * res.n_outer
    assert phi_ops.launch_counts["phi_blocked"] == t.ndim * res.n_outer
    assert phi_ops.launch_counts["phi_mu_blocked"] == sum(res.inner_iters)
    assert mttkrp_ops.launch_counts["mttkrp_blocked"] == 0
    want = P_cpapr.cpapr_mu(t, 4, init=kt, device="cpu", config=P_cpapr.
                            CPAPRConfig(rank=4, max_outer=3,
                                        strategy="segment"))
    assert res.inner_iters == want.inner_iters
    np.testing.assert_allclose(res.ktensor.lam.cpu().numpy(),
                               want.ktensor.lam.numpy(), **TOL)

    pi_ops.reset_launch_counts()
    phi_ops.reset_launch_counts()
    got_kt, got = P_cpals.cp_als(t, 4, n_iters=3, init=kt, strategy="cuda",
                                 policy=pol, device=card)
    assert pi_ops.launch_counts["pi_gather"] == 3 * t.ndim
    assert mttkrp_ops.launch_counts["mttkrp_blocked"] == 3 * t.ndim
    assert phi_ops.launch_counts == {"phi_blocked": 0, "phi_mu_blocked": 0}
    _, want = P_cpals.cp_als(t, 4, n_iters=3, init=kt,
                             strategy="segment", device="cpu")
    np.testing.assert_allclose(got, want, **TOL)
    assert not unexpanded  # the cuda family built no per-nonzero Π
