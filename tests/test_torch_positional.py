"""Positional calls written against the JAX package, run in the port.

Each test builds the reference's own positional argument tuple from the
conformance fixtures (``make_fixture``), hands the same tuple to both
packages (arrays as the same numpy data, layouts built by each package
from the same rows) and compares the results at ``TOL`` (``TOL_BF16``
for bf16 rows).  Where the port used to order its parameters otherwise,
these calls bound a reference argument to another parameter or raised.

The kernel wrappers run with ``interpret=True``: the reference's Pallas
kernels in interpret mode, the port's plain versions.  ``interpret=False``
on CPU tensors asks for a kernel the CPU does not have, and raises.
"""
import functools
import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cpapr as R_cpapr
from repro.core import dense as R_dense
from repro.core import layout as R_layout
from repro.core import phi as R_phi
from repro.core import pi as R_pi
from repro.core.sparse_tensor import sort_mode as r_sort_mode
from repro.kernels.dense import ops as R_dense_ops
from repro.kernels.mttkrp import ops as R_mttkrp_ops
from repro.kernels.mttkrp import ref as R_mttkrp_ref
from repro.kernels.phi import ops as R_phi_ops
from repro.kernels.phi import ref as R_phi_ref
from repro.kernels.stream import ops as R_stream_ops

from repro_torch.core import cpapr as P_cpapr
from repro_torch.core import dense as P_dense
from repro_torch.core import layout as P_layout
from repro_torch.core import phi as P_phi
from repro_torch.core import pi as P_pi
from repro_torch.core import sparse_tensor as P_st
from repro_torch.core.convert import ktensor_from_numpy, sparse_tensor_from_numpy
from repro_torch.kernels.dense import ops as P_dense_ops
from repro_torch.kernels.mttkrp import ops as P_mttkrp_ops
from repro_torch.kernels.mttkrp import ref as P_mttkrp_ref
from repro_torch.kernels.phi import ops as P_phi_ops
from repro_torch.kernels.phi import ref as P_phi_ref
from repro_torch.kernels.stream import ops as P_stream_ops

from test_conformance import BN, BR, RANK, TOL, TOL_BF16, make_fixture

KIND, MODE, SHARDS, EPS, MU_TOL = "hub", 0, 2, 1e-10, 1e-4
DTYPES = {"float32": (jnp.float32, torch.float32, TOL),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, TOL_BF16)}


@functools.lru_cache(maxsize=None)
def side(pkg: str) -> dict:
    """One package's objects for the fixture's mode, from the same numpy
    data: mode view, Π rows, B, factors, blocked and sharded layouts, the
    shard-local Π gather and the dense mode data."""
    t, kt = make_fixture(KIND)
    if pkg == "ref":
        mv = r_sort_mode(t, MODE)
        factors, lam = kt.factors, kt.lam
        pi = R_pi.pi_rows(mv.sorted_idx, factors, MODE)
        base = R_layout.build_blocked_layout(np.asarray(mv.rows), mv.n_rows,
                                             BN, BR)
        sl = R_layout.shard_blocked_layout(base, SHARDS)
        pig = R_layout.build_shard_pi_gather(sl, np.asarray(mv.sorted_idx),
                                             MODE)
        dn = R_dense.build_dense_mode(np.asarray(mv.sorted_idx),
                                      np.asarray(mv.sorted_vals), t.shape,
                                      MODE)
        vals_e, pi_e = R_phi.expand_to_layout(base, mv.sorted_vals, pi)
    else:
        pt = sparse_tensor_from_numpy(t.shape, np.asarray(t.indices),
                                      np.asarray(t.values), device="cpu")
        pkt = ktensor_from_numpy(np.asarray(kt.lam),
                                 [np.asarray(f) for f in kt.factors], "cpu")
        mv = P_st.sort_mode(pt, MODE)
        factors, lam = pkt.factors, pkt.lam
        pi = P_pi.pi_rows(mv.sorted_idx, factors, MODE)
        base = P_layout.build_blocked_layout(mv.rows.numpy(), mv.n_rows,
                                             BN, BR)
        sl = P_layout.shard_blocked_layout(base, SHARDS)
        pig = P_layout.build_shard_pi_gather(sl, mv.sorted_idx, MODE)
        dn = P_dense.build_dense_mode(mv.sorted_idx, mv.sorted_vals,
                                      pt.shape, MODE, device="cpu")
        vals_e, pi_e = P_phi.expand_to_layout(base, mv.sorted_vals, pi)
    return dict(mv=mv, factors=tuple(factors), lam=lam, pi=pi,
                b=factors[MODE] * lam[None, :], base=base, sl=sl, pig=pig,
                dn=dn, vals_e=vals_e, pi_e=pi_e)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _cast(pkg: str, x, dtype: str):
    return x.astype(DTYPES[dtype][0]) if pkg == "ref" \
        else x.to(DTYPES[dtype][1])


def _assert_close(got, want, tol, what):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **tol, err_msg=what)


# ---------------------------------------------------------------------------
# phi_from_rows, phi_mu_step and krao_reduce_rows
# ---------------------------------------------------------------------------
# Each row fills the slots after ``pi_e``/``kr_e`` positionally:
# (mesh, local_strategy, pi_gather, factors[, sorted_rows], combine, dense)

ROWS = ("blocked", "pallas", "sharded-local-pi", "dense", "dense-bf16")


def _tail(d, row: str, krao: bool) -> tuple:
    """The positional slots from ``strategy`` on, after the op's own
    leading ones: (strategy, layout, [perturb,] vals_e, pi_e, mesh,
    local_strategy, pi_gather, factors, [sorted_rows,] combine, dense)."""
    sorted_rows = (True,) if krao else ()
    if row in ("blocked", "pallas"):
        return (row, d["base"], d["vals_e"], d["pi_e"], None, "blocked",
                None, None) + sorted_rows + ("psum", None)
    if row == "sharded-local-pi":
        return ("sharded", d["sl"], None, None, None, "pallas", d["pig"],
                d["factors"]) + sorted_rows + ("reduce_scatter", None)
    return ("dense", None, None, None, None, "blocked", None,
            d["factors"]) + sorted_rows + ("psum", d["dn"])


def _operands(pkg: str, row: str) -> tuple:
    """(side dict, leading rows/vals slots, Π slot) for one row: the
    dense rows pass no stream, the bf16 row casts B and the factors."""
    d = dict(side(pkg))
    if row == "dense-bf16":
        d["factors"] = tuple(_cast(pkg, f, "bfloat16") for f in d["factors"])
        d["b"] = _cast(pkg, d["b"], "bfloat16")
    dense = row.startswith("dense")
    mv = d["mv"]
    lead = (None, None) if dense else (mv.rows, mv.sorted_vals)
    pi = None if dense or row == "sharded-local-pi" else d["pi"]
    return d, lead, pi


def _args(pkg: str, op: str, row: str) -> tuple:
    d, lead, pi = _operands(pkg, row)
    n = d["mv"].n_rows
    tail = _tail(d, row, krao=op == "krao_reduce_rows")
    if op == "phi_from_rows":
        # perturb (slot 8) sits between layout and vals_e
        return lead + (pi, d["b"], n, EPS, tail[0], tail[1], None) + tail[2:]
    if op == "phi_mu_step":
        return lead + (pi, d["b"], n, EPS, MU_TOL) + tail
    return lead + (pi, n) + tail


@pytest.mark.parametrize("row", ROWS)
@pytest.mark.parametrize("op", ("phi_from_rows", "phi_mu_step",
                                "krao_reduce_rows"))
def test_positional_phi_entry_points(op, row):
    r_args, p_args = _args("ref", op, row), _args("port", op, row)
    assert len(r_args) == len(p_args) >= 15
    for a, b in zip(r_args, p_args):  # the same literals in every slot
        if a is None or isinstance(a, (str, bool, int, float)):
            assert a == b
    want = getattr(R_phi, op)(*r_args)
    got = getattr(P_phi, op)(*p_args, device="cpu")
    tol = TOL_BF16 if row.endswith("bf16") else TOL
    _assert_close(got, want, tol, f"{op} {row}")


@pytest.mark.parametrize("strategy", ("blocked", "sharded"))
def test_positional_resolve_mode_policies(strategy):
    """``resolve_mode_policies(mvs, factors, lam, *, ...)``: the
    reference's own call form (its ``cp_als``'s)."""
    t, kt = make_fixture(KIND)
    pt = sparse_tensor_from_numpy(t.shape, np.asarray(t.indices),
                                  np.asarray(t.values), device="cpu")
    pkt = ktensor_from_numpy(np.asarray(kt.lam),
                             [np.asarray(f) for f in kt.factors], "cpu")
    kw = dict(rank=RANK, strategy=strategy, n_shards=SHARDS)
    rs, rl, rp, rloc = R_cpapr.resolve_mode_policies(
        [r_sort_mode(t, n) for n in range(t.ndim)], kt.factors, kt.lam, **kw)
    ps, pl, pp, ploc = P_cpapr.resolve_mode_policies(
        [P_st.sort_mode(pt, n) for n in range(pt.ndim)], pkt.factors,
        pkt.lam, **kw, device="cpu")
    assert ps == rs and ploc == rloc
    assert [(p.block_nnz, p.block_rows) for p in pp] == \
        [(p.block_nnz, p.block_rows) for p in rp]
    for a, b in zip(pl, rl):
        np.testing.assert_array_equal(a.grid_rb, b.grid_rb)
        np.testing.assert_array_equal(a.local_rows, b.local_rows)
        if strategy == "sharded":
            np.testing.assert_array_equal(a.rb_start, b.rb_start)


# ---------------------------------------------------------------------------
# The nine kernel wrappers with interpret=True
# ---------------------------------------------------------------------------


def _pad_b(pkg: str, b, n_rows_pad: int):
    if pkg == "ref":
        return jnp.pad(b, ((0, n_rows_pad - b.shape[0]), (0, 0)))
    return torch.cat([b, b.new_zeros(n_rows_pad - b.shape[0], b.shape[1])])


def _index(pkg: str, a: np.ndarray):
    a = np.asarray(a, np.int32)
    return jnp.asarray(a) if pkg == "ref" else torch.from_numpy(a)


def _dense_args(pkg: str, dtype: str, with_b: bool) -> tuple:
    d = side(pkg)
    dn = d["dn"]
    dense_mod = R_dense if pkg == "ref" else P_dense
    c, a = dense_mod.dense_kr_factors(dn, d["factors"])
    args = (dn.x, c, a) + ((d["b"],) if with_b else ())
    if pkg == "port":
        args = tuple(x.contiguous() for x in args)
    return tuple(_cast(pkg, x, dtype) for x in args)


def _call(pkg: str, wrapper: str, dtype: str, interpret):
    """One wrapper through one package, on the reference's argument
    tuple with ``interpret`` in its slot."""
    d = side(pkg)
    ops = {"phi": (R_phi_ops, P_phi_ops), "mttkrp": (R_mttkrp_ops,
                                                     P_mttkrp_ops),
           "dense": (R_dense_ops, P_dense_ops)}
    lay = d["base"]
    vals_e = _cast(pkg, d["vals_e"], dtype)
    rows_e = _cast(pkg, d["pi_e"], dtype)
    b = _cast(pkg, d["b"], dtype)
    blk = dict(block_nnz=lay.block_nnz, block_rows=lay.block_rows)
    if wrapper in ("phi_blocked", "phi_mu_blocked"):
        mod = ops["phi"][pkg == "port"]
        return getattr(mod, wrapper)(lay, vals_e, rows_e, b, EPS, interpret)
    if wrapper == "phi_blocked_arrays":
        mod = ops["phi"][pkg == "port"]
        return mod.phi_blocked_arrays(
            _index(pkg, lay.grid_rb), vals_e, _index(pkg, lay.local_rows),
            rows_e, _pad_b(pkg, b, lay.n_rows_pad), **blk, eps=EPS,
            interpret=interpret)
    if wrapper == "mttkrp_blocked":
        mod = ops["mttkrp"][pkg == "port"]
        return mod.mttkrp_blocked(lay, vals_e, rows_e, interpret)
    if wrapper == "mttkrp_blocked_arrays":
        mod = ops["mttkrp"][pkg == "port"]
        return mod.mttkrp_blocked_arrays(
            _index(pkg, lay.grid_rb), vals_e, _index(pkg, lay.local_rows),
            rows_e, **blk, n_rows_pad=lay.n_rows_pad, interpret=interpret)
    mod = ops["dense"][pkg == "port"]
    if wrapper == "mttkrp_dense":
        return mod.mttkrp_dense(*_dense_args(pkg, dtype, False), block_k=None,
                                interpret=interpret)
    return getattr(mod, wrapper)(*_dense_args(pkg, dtype, True), eps=EPS,
                                 block_k=None, interpret=interpret)


WRAPPERS = ("phi_blocked", "phi_mu_blocked", "phi_blocked_arrays",
            "mttkrp_blocked", "mttkrp_blocked_arrays", "mttkrp_dense",
            "phi_dense", "phi_mu_dense")


@pytest.mark.parametrize("dtype", tuple(DTYPES))
@pytest.mark.parametrize("wrapper", WRAPPERS)
def test_wrapper_with_interpret_true(wrapper, dtype):
    want = _call("ref", wrapper, dtype, True)
    got = _call("port", wrapper, dtype, True)
    _assert_close(got, want, DTYPES[dtype][2], f"{wrapper} {dtype}")


def _stream_operands(pkg: str, dtype: str):
    rng = np.random.RandomState(2)
    b, c = (rng.standard_normal(128 * 8 * 4).astype(np.float32)
            for _ in range(2))
    conv = jnp.asarray if pkg == "ref" else torch.from_numpy
    return tuple(_cast(pkg, conv(x), dtype) for x in (b, c))


@pytest.mark.parametrize("dtype", tuple(DTYPES))
def test_stream_op_with_interpret_true(dtype):
    """``stream_op(op, b, c, block_rows, s, interpret)``, all positional
    (XLA's CPU may fuse the reference's triad into one multiply-add, so
    it is held at the tier's tolerance, not bitwise)."""
    rb, rc = _stream_operands("ref", dtype)
    pb, pc = _stream_operands("port", dtype)
    for op in P_stream_ops.STREAM_OPS:
        want = R_stream_ops.stream_op(op, rb, rc, 8, 2.5, True)
        got = P_stream_ops.stream_op(op, pb, pc, 8, 2.5, True)
        np.testing.assert_allclose(_np(got), _np(want), **DTYPES[dtype][2],
                                   err_msg=op)


@pytest.mark.parametrize("wrapper", WRAPPERS + ("stream_op",))
def test_interpret_false_on_cpu_tensors_raises(wrapper):
    """``interpret=False`` asks for the kernel; CPU tensors have none."""
    with pytest.raises(ValueError, match="interpret=False"):
        if wrapper == "stream_op":
            P_stream_ops.stream_op("triad", *_stream_operands("port",
                                                              "float32"),
                                   8, 2.5, False)
        else:
            _call("port", wrapper, "float32", False)


@pytest.mark.parametrize("fn", ("phi_blocked_ref", "mttkrp_blocked_ref"))
def test_blocked_plain_versions_take_the_reference_signature(fn):
    """``phi_blocked_ref(layout, vals_e, pi_e, b_pad, eps)`` and
    ``mttkrp_blocked_ref(layout, vals_e, kr_e)``, positional."""
    mods = {"phi_blocked_ref": (R_phi_ref, P_phi_ref),
            "mttkrp_blocked_ref": (R_mttkrp_ref, P_mttkrp_ref)}[fn]
    out = []
    for pkg, mod in zip(("ref", "port"), mods):
        d = side(pkg)
        lay = d["base"]
        args = (lay, d["vals_e"], d["pi_e"])
        if fn == "phi_blocked_ref":
            args += (_pad_b(pkg, d["b"], lay.n_rows_pad), EPS)
        out.append(getattr(mod, fn)(*args))
    _assert_close(out[1], out[0], TOL, fn)


# ---------------------------------------------------------------------------
# random_ktensor and random_poisson_tensor
# ---------------------------------------------------------------------------


def _digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def test_random_draws_unchanged_by_the_seed_slot():
    """The seed moved to the reference's key slot; for a given seed the
    draws stay bitwise those of the earlier keyword call
    (``random_ktensor(shape, rank, seed=...)``,
    ``random_poisson_tensor(shape, nnz=..., rank=..., seed=...)``),
    whose digests these are."""
    kt = P_st.random_ktensor(4, (9, 7, 5), 3, device="cpu")
    assert _digest(kt.lam, *kt.factors) == "a10eab7c93c9daa6"
    kt64 = P_st.random_ktensor(4, (9, 7, 5), 3, torch.float64, device="cpu")
    assert _digest(kt64.lam, *kt64.factors) == "f4f25a8c8d56f4f2"
    t, m = P_st.random_poisson_tensor(5, (12, 9, 7), 300, 3, device="cpu")
    assert _digest(t.indices, t.values) == "ee9d58526c461991"
    assert _digest(m.lam, *m.factors) == "0784e14dc2c3dbc1"
    t2, m2 = P_st.random_poisson_tensor(6, (12, 9, 7), 300, 3, m,
                                        device="cpu")
    assert _digest(t2.indices, t2.values) == "779e9178fc55b5e2"
    assert _digest(m2.lam, *m2.factors) == "0784e14dc2c3dbc1"
    t3, m3 = P_st.random_poisson_tensor(0, (12, 9, 7), 300, device="cpu")
    assert _digest(t3.indices, t3.values) == "1e05481f6ddd6a3f"
    assert _digest(m3.lam, *m3.factors) == "ee72b79aec7749d9"
