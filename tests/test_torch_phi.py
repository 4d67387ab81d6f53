"""Φ and the fused Φ -> MU step of the port against the JAX package.

The same inputs (the conformance fixtures, converted from numpy) go
through the reference's ``phi_from_rows``/``phi_mu_step`` and the port's,
strategy against strategy: the port's ``cuda`` (here, on CPU tensors, the
kernel wrapper's plain version) against the reference's ``pallas`` (in
interpret mode, as its own tests run it), ``blocked`` against
``blocked``, ``segment`` and ``scatter`` against theirs.  Tolerance tiers
are the conformance matrix's: ``TOL`` for f32, ``TOL_BF16`` for bf16.

The CUDA kernels themselves are held against these plain versions on
the card by ``tests/test_torch_cuda.py``.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import phi as R_phi
from repro.core import pi as R_pi
from repro.core.layout import build_blocked_layout as r_build_layout
from repro.core.sparse_tensor import sort_mode as r_sort_mode

from repro_torch.core import phi as P_phi
from repro_torch.core import pi as P_pi
from repro_torch.core.convert import ktensor_from_numpy, sparse_tensor_from_numpy
from repro_torch.core.layout import build_blocked_layout as p_build_layout
from repro_torch.core.sparse_tensor import sort_mode as p_sort_mode
from repro_torch.core import policy as P_policy
from repro_torch.kernels._checks import MAX_RANK, SMEM_LIMIT, check_card_limits
from repro_torch.kernels.phi import kernel as P_kernel
from repro_torch.kernels.phi import ops as P_ops
from repro_torch.kernels.phi import ref as P_ref

from test_conformance import BN, BR, FIXTURES, RANK, TOL, TOL_BF16, make_fixture

MODES = (0, 1, 2)
# port strategy -> the reference strategy it is held against
PAIRS = {"cuda": "pallas", "blocked": "blocked", "segment": "segment",
         "scatter": "scatter"}
MU_TOL = 1e-4


@functools.lru_cache(maxsize=None)
def problem(kind: str, mode: int):
    """Reference and port inputs of one fixture mode, from the same numpy
    arrays: (ref dict, port dict)."""
    t, kt = make_fixture(kind)
    rmv = r_sort_mode(t, mode)
    rpi = R_pi.pi_rows(rmv.sorted_idx, kt.factors, mode)
    ref = dict(mv=rmv, pi=rpi, b=kt.factors[mode] * kt.lam[None, :],
               layout=r_build_layout(np.asarray(rmv.rows), rmv.n_rows, BN, BR))
    pt = sparse_tensor_from_numpy(t.shape, np.asarray(t.indices),
                                  np.asarray(t.values), device="cpu")
    pkt = ktensor_from_numpy(np.asarray(kt.lam),
                             [np.asarray(f) for f in kt.factors],
                             device="cpu")
    pmv = p_sort_mode(pt, mode)
    port = dict(mv=pmv, pi=P_pi.pi_rows(pmv.sorted_idx, pkt.factors, mode),
                b=pkt.factors[mode] * pkt.lam[None, :],
                layout=p_build_layout(pmv.rows.numpy(), pmv.n_rows, BN, BR))
    return ref, port


def _layout_for(strategy, d):
    return d["layout"] if strategy in ("blocked", "cuda", "pallas") else None


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", FIXTURES)
def test_pi_rows_equal(kind, mode):
    ref, port = problem(kind, mode)
    np.testing.assert_array_equal(port["pi"].numpy(), np.asarray(ref["pi"]))
    np.testing.assert_array_equal(port["b"].numpy(), np.asarray(ref["b"]))


@pytest.mark.parametrize("strategy", tuple(PAIRS))
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", FIXTURES)
def test_phi_matches_reference(kind, mode, strategy):
    ref, port = problem(kind, mode)
    rs = PAIRS[strategy]
    rmv, pmv = ref["mv"], port["mv"]
    want = R_phi.phi_from_rows(rmv.rows, rmv.sorted_vals, ref["pi"], ref["b"],
                               rmv.n_rows, strategy=rs,
                               layout=_layout_for(rs, ref))
    got = P_phi.phi_from_rows(pmv.rows, pmv.sorted_vals, port["pi"],
                              port["b"], pmv.n_rows, strategy=strategy,
                              layout=_layout_for(strategy, port),
                              device="cpu")
    assert got.shape == (pmv.n_rows, RANK) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                               err_msg=f"phi {strategy} {kind} mode {mode}")


@pytest.mark.parametrize("strategy", tuple(PAIRS))
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", FIXTURES)
def test_phi_mu_step_matches_reference(kind, mode, strategy):
    ref, port = problem(kind, mode)
    rs = PAIRS[strategy]
    rmv, pmv = ref["mv"], port["mv"]
    wb, wv = R_phi.phi_mu_step(rmv.rows, rmv.sorted_vals, ref["pi"], ref["b"],
                               rmv.n_rows, tol=MU_TOL, strategy=rs,
                               layout=_layout_for(rs, ref))
    gb, gv = P_phi.phi_mu_step(pmv.rows, pmv.sorted_vals, port["pi"],
                               port["b"], pmv.n_rows, tol=MU_TOL,
                               strategy=strategy,
                               layout=_layout_for(strategy, port),
                               device="cpu")
    assert gv.dim() == 0
    np.testing.assert_allclose(float(gv), float(wv), **TOL,
                               err_msg=f"viol {strategy} {kind} mode {mode}")
    np.testing.assert_allclose(gb.numpy(), np.asarray(wb), **TOL,
                               err_msg=f"B' {strategy} {kind} mode {mode}")


@pytest.mark.parametrize("op", ("phi", "mu"))
@pytest.mark.parametrize("kind", FIXTURES)
def test_cuda_bf16_matches_reference_pallas(kind, op):
    """The bf16 element tier (f32 accumulation) against the reference's
    pallas bf16 tier, at TOL_BF16, on every mode."""
    for mode in MODES:
        ref, port = problem(kind, mode)
        rmv, pmv = ref["mv"], port["mv"]
        rargs = (rmv.rows, rmv.sorted_vals.astype(jnp.bfloat16),
                 ref["pi"].astype(jnp.bfloat16), ref["b"].astype(jnp.bfloat16),
                 rmv.n_rows)
        pargs = (pmv.rows, pmv.sorted_vals.to(torch.bfloat16),
                 port["pi"].to(torch.bfloat16), port["b"].to(torch.bfloat16),
                 pmv.n_rows)
        if op == "phi":
            want = R_phi.phi_from_rows(*rargs, strategy="pallas",
                                       layout=ref["layout"])
            got = P_phi.phi_from_rows(*pargs, strategy="cuda",
                                      layout=port["layout"], device="cpu")
            pairs = [(got, want)]
        else:
            wb, wv = R_phi.phi_mu_step(*rargs, tol=MU_TOL, strategy="pallas",
                                       layout=ref["layout"])
            gb, gv = P_phi.phi_mu_step(*pargs, tol=MU_TOL, strategy="cuda",
                                       layout=port["layout"], device="cpu")
            pairs = [(gb, wb), (gv, wv)]
        for g, w in pairs:
            assert g.dtype in (torch.bfloat16, torch.float32)
            np.testing.assert_allclose(
                g.float().numpy(), np.asarray(w, np.float32), **TOL_BF16,
                err_msg=f"bf16 {op} {kind} mode {mode}")


def _mixed(d, jax_side):
    """Π (and the Khatri-Rao rows) in bf16, values and B in f32: the C1
    input mix (bf16 factors, f32 λ and tensor values)."""
    if jax_side:
        return d["pi"].astype(jnp.bfloat16)
    return d["pi"].to(torch.bfloat16)


@pytest.mark.parametrize("op", ("phi", "mu", "krao"))
@pytest.mark.parametrize("strategy", ("scatter", "segment", "blocked"))
@pytest.mark.parametrize("kind", FIXTURES)
def test_mixed_bf16_f32_matches_reference(kind, strategy, op):
    """bf16 Π with f32 values and B: each plain strategy returns the
    reference's result dtype (``scatter`` the rows' bf16, ``segment`` and
    ``blocked`` the promoted f32) and values within TOL_BF16, on every
    mode.  The kernel tiers refuse mixed dtypes in both packages."""
    for mode in MODES:
        ref, port = problem(kind, mode)
        rmv, pmv = ref["mv"], port["mv"]
        rpi, ppi = _mixed(ref, True), _mixed(port, False)
        rl, pl = _layout_for(strategy, ref), _layout_for(strategy, port)
        if op == "phi":
            want = [R_phi.phi_from_rows(rmv.rows, rmv.sorted_vals, rpi,
                                        ref["b"], rmv.n_rows,
                                        strategy=strategy, layout=rl)]
            got = [P_phi.phi_from_rows(pmv.rows, pmv.sorted_vals, ppi,
                                       port["b"], pmv.n_rows,
                                       strategy=strategy, layout=pl,
                                       device="cpu")]
        elif op == "mu":
            want = R_phi.phi_mu_step(rmv.rows, rmv.sorted_vals, rpi, ref["b"],
                                     rmv.n_rows, tol=MU_TOL,
                                     strategy=strategy, layout=rl)
            got = P_phi.phi_mu_step(pmv.rows, pmv.sorted_vals, ppi,
                                    port["b"], pmv.n_rows, tol=MU_TOL,
                                    strategy=strategy, layout=pl,
                                    device="cpu")
        else:
            want = [R_phi.krao_reduce_rows(rmv.rows, rmv.sorted_vals, rpi,
                                           rmv.n_rows, strategy=strategy,
                                           layout=rl)]
            got = [P_phi.krao_reduce_rows(pmv.rows, pmv.sorted_vals, ppi,
                                          pmv.n_rows, strategy=strategy,
                                          layout=pl, device="cpu")]
        for g, w in zip(got, want):
            assert str(g.dtype).replace("torch.", "") == str(w.dtype), \
                (kind, strategy, op, mode)
            np.testing.assert_allclose(
                g.float().numpy(), np.asarray(w, np.float32), **TOL_BF16,
                err_msg=f"mixed {op} {strategy} {kind} mode {mode}")
    if strategy == "blocked":
        with pytest.raises(ValueError, match="one element dtype"):
            P_phi.phi_from_rows(pmv.rows, pmv.sorted_vals, ppi, port["b"],
                                pmv.n_rows, strategy="cuda", layout=pl,
                                device="cpu")


@pytest.mark.parametrize("perturb", ("no_conflict", "perfect_reuse"))
@pytest.mark.parametrize("strategy", ("scatter", "segment", "blocked"))
def test_perturb_matches_reference(strategy, perturb):
    for kind in FIXTURES:
        ref, port = problem(kind, 0)
        rmv, pmv = ref["mv"], port["mv"]
        want = R_phi.phi_from_rows(rmv.rows, rmv.sorted_vals, ref["pi"],
                                   ref["b"], rmv.n_rows, strategy=strategy,
                                   layout=_layout_for(strategy, ref),
                                   perturb=perturb)
        got = P_phi.phi_from_rows(pmv.rows, pmv.sorted_vals, port["pi"],
                                  port["b"], pmv.n_rows, strategy=strategy,
                                  layout=_layout_for(strategy, port),
                                  perturb=perturb, device="cpu")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=f"{strategy} {perturb} {kind}")


@pytest.mark.parametrize("strategy", tuple(PAIRS))
def test_default_layout_matches_reference(strategy):
    """Without a layout, blocked/cuda take the heuristic's CPU blocking on
    CPU tensors, as the reference does on its CPU backend."""
    ref, port = problem("hub", 0)
    rmv, pmv = ref["mv"], port["mv"]
    want = R_phi.phi_from_rows(rmv.rows, rmv.sorted_vals, ref["pi"], ref["b"],
                               rmv.n_rows, strategy=PAIRS[strategy])
    got = P_phi.phi_from_rows(pmv.rows, pmv.sorted_vals, port["pi"],
                              port["b"], pmv.n_rows, strategy=strategy,
                              device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("strategy", tuple(PAIRS))
def test_phi_mode_matches_reference(strategy):
    t, kt = make_fixture("empty_row")
    rmv = r_sort_mode(t, 0)
    b = kt.factors[0] * kt.lam[None, :]
    lay = r_build_layout(np.asarray(rmv.rows), rmv.n_rows, BN, BR)
    want = R_phi.phi_mode(rmv, kt.factors, b, strategy=PAIRS[strategy],
                          layout=_layout_for(PAIRS[strategy],
                                             {"layout": lay}))
    _, port = problem("empty_row", 0)
    pkt = ktensor_from_numpy(np.asarray(kt.lam),
                             [np.asarray(f) for f in kt.factors], "cpu")
    got = P_phi.phi_mode(port["mv"], pkt.factors, port["b"],
                         strategy=strategy,
                         layout=_layout_for(strategy, port), device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("strategy", tuple(PAIRS))
def test_empty_mode(strategy):
    """nnz = 0: Φ is exactly zero and the MU step reports
    viol = max |min(B, 1)| and leaves B unchanged when that is <= tol."""
    rows = torch.zeros(0, dtype=torch.int64)
    vals = torch.zeros(0)
    pi = torch.zeros(0, RANK)
    b = torch.rand(7, RANK, generator=torch.Generator().manual_seed(0))
    lay = p_build_layout(rows.numpy(), 7, BN, BR)
    layout = lay if strategy in ("blocked", "cuda") else None
    phi = P_phi.phi_from_rows(rows, vals, pi, b, 7, strategy=strategy,
                              layout=layout, device="cpu")
    assert torch.equal(phi, torch.zeros(7, RANK))
    b2, viol = P_phi.phi_mu_step(rows, vals, pi, b, 7, tol=1e-4,
                                 strategy=strategy, layout=layout,
                                 device="cpu")
    assert float(viol) == pytest.approx(float(b.max()))
    assert torch.equal(b2, torch.zeros_like(b))  # viol > tol: B*0


def _kernel_inputs(kind="hub", mode=0, dtype=torch.float32):
    _, port = problem(kind, mode)
    pmv, lay = port["mv"], port["layout"]
    vals_e, pi_e = P_phi.expand_to_layout(lay, pmv.sorted_vals, port["pi"])
    return lay, vals_e.to(dtype), pi_e.to(dtype), port["b"].to(dtype)


@pytest.mark.parametrize("entry", ("phi_blocked", "phi_mu_blocked",
                                   "phi_blocked_arrays"))
def test_kernel_entry_points_raise_on_f64(entry):
    lay, vals_e, pi_e, b = _kernel_inputs(dtype=torch.float64)
    with pytest.raises(ValueError, match="float64"):
        if entry == "phi_blocked_arrays":
            lt = lay.on("cpu")
            b_pad = torch.cat([b, b.new_zeros(lay.n_rows_pad - b.shape[0],
                                              RANK)])
            P_ops.phi_blocked_arrays(lt.grid_rb, vals_e, lt.local_rows, pi_e,
                                     b_pad, block_nnz=lay.block_nnz,
                                     block_rows=lay.block_rows, eps=1e-10)
        else:
            getattr(P_ops, entry)(lay, vals_e, pi_e, b, 1e-10)


def test_kernel_entry_points_raise_on_mixed_dtypes():
    lay, vals_e, pi_e, b = _kernel_inputs()
    with pytest.raises(ValueError, match="share one element dtype"):
        P_ops.phi_blocked(lay, vals_e, pi_e.to(torch.bfloat16), b)
    with pytest.raises(ValueError, match="share one element dtype"):
        P_ops.phi_mu_blocked(lay, vals_e, pi_e, b.to(torch.bfloat16))


def test_kernel_wrapper_checks_shapes_and_index_dtype():
    lay, vals_e, pi_e, b = _kernel_inputs()
    lt = lay.on("cpu")
    b_pad = torch.cat([b, b.new_zeros(lay.n_rows_pad - b.shape[0], RANK)])
    kw = dict(block_nnz=lay.block_nnz, block_rows=lay.block_rows, eps=1e-10)
    with pytest.raises(ValueError, match="shapes"):
        P_ops.phi_blocked_arrays(lt.grid_rb, vals_e[:-1], lt.local_rows,
                                 pi_e, b_pad, **kw)
    with pytest.raises(ValueError, match="int32"):
        P_ops.phi_blocked_arrays(lt.grid_rb.long(), vals_e, lt.local_rows,
                                 pi_e, b_pad, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        P_ops.phi_blocked_arrays(lt.grid_rb, vals_e, lt.local_rows,
                                 pi_e.t().contiguous().t(), b_pad, **kw)


def test_cpu_wrappers_count_no_launches():
    P_ops.reset_launch_counts()
    lay, vals_e, pi_e, b = _kernel_inputs()
    P_ops.phi_blocked(lay, vals_e, pi_e, b)
    P_ops.phi_mu_blocked(lay, vals_e, pi_e, b)
    assert P_ops.launch_counts == {"phi_blocked": 0, "phi_mu_blocked": 0}


@pytest.mark.parametrize("kind", FIXTURES)
def test_blocked_plain_versions_match_unblocked(kind):
    """The kernels' plain versions on the padded window equal the plain Φ
    on the raw stream (padding slots and rows add exactly 0)."""
    _, port = problem(kind, 0)
    pmv, lay = port["mv"], port["layout"]
    lay_, vals_e, pi_e, b = _kernel_inputs(kind)
    lt = lay.on("cpu")
    b_pad = torch.cat([b, b.new_zeros(lay.n_rows_pad - b.shape[0], RANK)])
    kw = dict(block_nnz=lay.block_nnz, block_rows=lay.block_rows, eps=1e-10)
    phi_pad = P_ref.phi_blocked_arrays_ref(lt.grid_rb, vals_e, lt.local_rows,
                                           pi_e, b_pad, **kw)
    phi = P_ref.phi_ref(pmv.rows, pmv.sorted_vals, port["pi"], port["b"],
                        pmv.n_rows, 1e-10)
    np.testing.assert_allclose(phi_pad[:pmv.n_rows].numpy(), phi.numpy(),
                               **TOL)
    assert torch.equal(phi_pad[pmv.n_rows:], torch.zeros_like(phi_pad[pmv.n_rows:]))
    mu, viol = P_ref.phi_mu_blocked_arrays_ref(lt.grid_rb, vals_e,
                                               lt.local_rows, pi_e, b_pad,
                                               **kw)
    mu_u, viol_u = P_ref.phi_mu_ref(pmv.rows, pmv.sorted_vals, port["pi"],
                                    port["b"], pmv.n_rows, 1e-10)
    np.testing.assert_allclose(mu[:pmv.n_rows].numpy(), mu_u.numpy(), **TOL)
    np.testing.assert_allclose(float(viol), float(viol_u), **TOL)


@pytest.mark.parametrize("nnz,rank", [(1000, 4), (3_309_490, 16), (7, 1)])
def test_flop_word_counts_equal(nnz, rank):
    for variant in ("gpu", "cpu"):
        assert P_phi.phi_flops_words(nnz, rank, variant) == \
            R_phi.phi_flops_words(nnz, rank, variant)
    for n_modes in (3, 4, 5):
        assert P_pi.pi_rows_flops_words(nnz, rank, n_modes) == \
            R_pi.pi_rows_flops_words(nnz, rank, n_modes)


@pytest.mark.parametrize("strategy", ("sharded", "grid"))
def test_later_strategies_raise(strategy):
    """The multi-device strategies of the later slices, ``sharded`` and
    ``grid``, are ported: with their default layouts they match the
    reference's."""
    ref, port = problem("uniform", 0)
    pmv = port["mv"]
    args = (pmv.rows, pmv.sorted_vals, port["pi"], port["b"], pmv.n_rows)
    rmv = ref["mv"]
    want = R_phi.phi_from_rows(rmv.rows, rmv.sorted_vals, ref["pi"],
                               ref["b"], rmv.n_rows, strategy=strategy)
    got = P_phi.phi_from_rows(*args, strategy=strategy, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_pallas_is_an_alias_of_cuda():
    _, port = problem("uniform", 1)
    pmv = port["mv"]
    args = (pmv.rows, pmv.sorted_vals, port["pi"], port["b"], pmv.n_rows)
    a = P_phi.phi_from_rows(*args, strategy="pallas", layout=port["layout"],
                            device="cpu")
    c = P_phi.phi_from_rows(*args, strategy="cuda", layout=port["layout"],
                            device="cpu")
    assert torch.equal(a, c)


def test_tensors_off_device_raise():
    _, port = problem("uniform", 0)
    pmv = port["mv"]
    with pytest.raises(ValueError, match="device"):
        P_phi.phi_from_rows(pmv.rows, pmv.sorted_vals, port["pi"], port["b"],
                            pmv.n_rows, device="meta")


# --- the Φ accumulation kernel's shared memory -------------------------------

# the blockings the on-card tests run (tests/test_torch_cuda.py)
ON_CARD_BLOCKINGS = ((64, 4), (256, 256), (2048, 1024))
SMEM_RANKS = (1, 16, 64, 1024)
SMEM_DTYPES = (torch.float32, torch.bfloat16)


def _blockings():
    grid = [(p.block_nnz, p.block_rows)
            for p in P_policy.policy_grid(strategies=("cuda",))]
    return grid + list(ON_CARD_BLOCKINGS)


@pytest.mark.parametrize("dtype", SMEM_DTYPES)
@pytest.mark.parametrize("rank", SMEM_RANKS)
def test_smem_bytes_fits_at_every_blocking(rank, dtype):
    """Every policy_grid point and the on-card blockings fit a block's
    shared memory, at ranks up to MAX_RANK, in both element dtypes."""
    for bn, br in _blockings():
        smem = P_kernel.smem_bytes(bn, br, rank, dtype)
        assert 0 < smem <= SMEM_LIMIT, (bn, br, rank, dtype, smem)


@pytest.mark.parametrize("dtype", SMEM_DTYPES)
@pytest.mark.parametrize("rank", SMEM_RANKS)
def test_smem_bytes_does_not_grow_with_block_nnz_times_rank(rank, dtype):
    """The ring holds fixed-size chunks: past one chunk, block_nnz adds
    nothing, and block_rows never counts."""
    isz = torch.finfo(dtype).bits // 8
    chunk = max(1, 2048 // (4 * rank))  # nonzeros per stage, either dtype
    at_chunk = P_kernel.smem_bytes(chunk, 64, rank, dtype)
    for bn in (chunk + 1, 2 * chunk + 3, 4096, 1 << 20):
        for br in (1, 64, 1 << 20):
            assert P_kernel.smem_bytes(bn, br, rank, dtype) == at_chunk
    # at most 8 warps of two stages, each at most 2 KB of f32 Π rows (or
    # one row) with its values, local rows and row blocks, each region
    # padded by at most 31 bytes
    stage = max(2048, 4 * rank) + chunk * (isz + 4) + 8 + 4 * 31
    assert at_chunk <= 8 * 2 * stage
    assert at_chunk <= 56 * 1024


def test_smem_bytes_defaults_to_f32():
    for bn, br in _blockings():
        for rank in SMEM_RANKS:
            f32 = P_kernel.smem_bytes(bn, br, rank, torch.float32)
            assert P_kernel.smem_bytes(bn, br, rank) == f32
            assert P_kernel.smem_bytes(bn, br, rank, torch.bfloat16) <= f32


@pytest.mark.parametrize("rank", SMEM_RANKS + (3, 200, MAX_RANK + 1, 0))
def test_card_check_raises_exactly_above_the_limit(rank):
    """The wrappers' card check (``check_card_limits``) raises where a
    footprint exceeds SMEM_LIMIT and nowhere else: never for the Φ
    kernel's footprint, at a window-only footprint exactly on the limit
    and one row past it; and for ranks outside 1..MAX_RANK."""
    def check(bn, br, fn):
        check_card_limits("phi_blocked", rank, block_nnz=bn, block_rows=br,
                          smem_bytes=fn)

    if not 1 <= rank <= MAX_RANK:
        with pytest.raises(ValueError, match="outside"):
            check(256, 256, lambda r: 0)
        return
    for bn, br in _blockings() + [(1 << 16, 1 << 16), (1, 1)]:
        for dtype in SMEM_DTYPES:
            fn = functools.partial(P_kernel.smem_bytes, bn, br, dtype=dtype)
            assert fn(rank) <= SMEM_LIMIT
            check(bn, br, fn)
    rows_at_limit = SMEM_LIMIT // (4 * rank)
    check(256, rows_at_limit, lambda r: 4 * rows_at_limit * r)
    with pytest.raises(ValueError, match="shared memory"):
        check(256, rows_at_limit + 1, lambda r: 4 * (rows_at_limit + 1) * r)


@pytest.mark.parametrize("rank", (1, 16, 200, 1024))
def test_cuda_heuristic_fits_the_new_footprint(rank):
    """The ``cuda`` heuristic sizes its blocking with ``smem_bytes`` and
    keeps it within a quarter of a block's shared memory."""
    for nnz, n_rows in ((3_309_490, 24), (3_309_490, 1717), (5000, 5000)):
        p = P_policy.heuristic_policy(nnz, n_rows, rank, platform="cuda")
        assert P_kernel.smem_bytes(p.block_nnz, p.block_rows, rank) <= \
            SMEM_LIMIT // 4
