"""One mode's bound operators (``repro_torch.core.phi.bind_mode``) against
the public entries, on the CPU.

For every kernel family, every conformance fixture (uniform, hub,
empty_row) and every mode, the bound ``phi``, ``step`` and ``reduce`` on
the operands ``inputs`` hoists are ``torch.equal`` to ``phi_from_rows``,
``phi_mu_step`` and ``krao_reduce_rows`` on the same operands: the
solvers' one mode-update loop and the public entries run the same
kernels on the same tensors.  The multi-device families are held as well
to the full-block forms of ``core.distributed`` (``phi_sharded`` and
``phi_grid`` with their MU and MTTKRP siblings), which compose the
carry's stack, the stacked operator and the unstack the loop runs.
``bind_mode`` rejects a layout of the wrong type and a mismatched
shard-local Π gather with the public entries' messages.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.core import distributed as P_dist
from repro_torch.core import layout as P_layout
from repro_torch.core import phi as P_phi
from repro_torch.core.convert import ktensor_from_numpy, sparse_tensor_from_numpy
from repro_torch.core.dense import build_dense_mode
from repro_torch.core.pi import pi_rows
from repro_torch.core.sparse_tensor import sort_mode

from test_conformance import BN, BR, FIXTURES, make_fixture

MODES = (0, 1, 2)
# strategy, and for the sharded families the combine and shard-local Π;
# every sharded family runs 2 emulated shards, the grid 2 x 2 cells
FAMILIES = {
    "segment": dict(strategy="segment"),
    "blocked": dict(strategy="blocked"),
    "cuda": dict(strategy="cuda"),
    "dense": dict(strategy="dense"),
    "sharded-psum": dict(strategy="sharded", combine="psum"),
    "sharded-reduce-scatter": dict(strategy="sharded",
                                   combine="reduce_scatter"),
    "sharded-local-pi": dict(strategy="sharded", combine="reduce_scatter",
                             local_pi=True),
    "grid-2x2": dict(strategy="grid", combine="reduce_scatter"),
}
FULL_BLOCK = {"sharded": (P_dist.phi_sharded, P_dist.phi_mu_sharded,
                          P_dist.krao_sharded),
              "grid": (P_dist.phi_grid, P_dist.phi_mu_grid,
                       P_dist.krao_grid)}


@functools.lru_cache(maxsize=None)
def port_tensors(kind: str):
    t, kt = make_fixture(kind)
    pt = sparse_tensor_from_numpy(t.shape, np.asarray(t.indices),
                                  np.asarray(t.values), device="cpu")
    pkt = ktensor_from_numpy(np.asarray(kt.lam),
                             [np.asarray(f) for f in kt.factors], "cpu")
    return pt, pkt


def setup(family: str, kind: str, mode: int):
    """``(mode view, factors, B, layout, pi_gather)`` of one case."""
    row = FAMILIES[family]
    pt, pkt = port_tensors(kind)
    mv = sort_mode(pt, mode)
    base = P_layout.build_blocked_layout(mv.rows.numpy(), mv.n_rows, BN, BR)
    layout = pig = None
    if row["strategy"] in ("blocked", "cuda"):
        layout = base
    elif row["strategy"] == "dense":
        layout = build_dense_mode(mv.sorted_idx, mv.sorted_vals, pt.shape,
                                  mode, device="cpu")
    elif row["strategy"] == "sharded":
        layout = P_layout.shard_blocked_layout(base, 2)
        if row.get("local_pi"):
            pig = P_layout.build_shard_pi_gather(layout, mv.sorted_idx, mode)
    elif row["strategy"] == "grid":
        layout = P_layout.build_grid_layout(base, (2, 2))
    b = pkt.factors[mode] * pkt.lam[None, :]
    return mv, tuple(pkt.factors), b, layout, pig


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", FIXTURES)
@pytest.mark.parametrize("family", tuple(FAMILIES))
def test_bound_ops_equal_the_public_entries(family, kind, mode):
    row = FAMILIES[family]
    strategy, combine = row["strategy"], row.get("combine", "psum")
    mv, factors, b, layout, pig = setup(family, kind, mode)
    ops = P_phi.bind_mode(strategy, layout, mv.rows, mv.sorted_vals,
                          mv.n_rows, idx=mv.sorted_idx, mode=mode,
                          pi_gather=pig, combine=combine, device="cpu")
    operands = ops.inputs(factors)
    if strategy == "dense":
        stream = (None, None, None)
        kw = dict(dense=layout, factors=factors)
    else:
        pi, vals_e, pi_e, _ = operands
        stream = (mv.rows, mv.sorted_vals, pi)
        kw = dict(layout=layout, vals_e=vals_e, pi_gather=pig,
                  factors=factors if pig is not None else None,
                  combine=combine)
    ent = dict(strategy=strategy, device="cpu", **kw)
    pi_e = None if strategy == "dense" else operands[2]

    phi = ops.unstack(ops.phi(operands, ops.stack(b)))
    assert torch.equal(phi, P_phi.phi_from_rows(*stream, b, mv.n_rows,
                                                pi_e=pi_e, **ent))
    b_own, viol = ops.step(operands, ops.stack(b))
    b_new = ops.unstack(b_own)
    want_b, want_viol = P_phi.phi_mu_step(*stream, b, mv.n_rows, pi_e=pi_e,
                                          **ent)
    assert torch.equal(b_new, want_b) and torch.equal(viol, want_viol)
    m = ops.reduce(operands)
    assert torch.equal(m, P_phi.krao_reduce_rows(*stream, mv.n_rows,
                                                 kr_e=pi_e, **ent))

    if strategy in FULL_BLOCK:
        phi_fn, step_fn, krao_fn = FULL_BLOCK[strategy]
        extra = dict(pi_gather=pig, factors=kw["factors"],
                     combine=combine) if strategy == "sharded" else {}
        assert torch.equal(phi, phi_fn(layout, operands[1], pi_e, b,
                                       **extra))
        want_b, want_viol = step_fn(layout, operands[1], pi_e, b, **extra)
        assert torch.equal(b_new, want_b) and torch.equal(viol, want_viol)
        assert torch.equal(m, krao_fn(layout, operands[1], pi_e, **extra))


def _raised(fn):
    with pytest.raises((TypeError, ValueError)) as got:
        fn()
    return got.type, str(got.value)


@pytest.mark.parametrize("case", ["sharded-on-blocked", "grid-on-blocked",
                                  "grid-on-sharded", "pig-without-layout",
                                  "pig-of-other-shards"])
def test_bind_mode_rejects_like_the_public_entries(case):
    mv, factors, b, base, _ = setup("blocked", "hub", 0)
    sl2 = P_layout.shard_blocked_layout(base, 2)
    strategy, layout, pig = {
        "sharded-on-blocked": ("sharded", base, None),
        "grid-on-blocked": ("grid", base, None),
        "grid-on-sharded": ("grid", sl2, None),
        "pig-without-layout": (
            "sharded", None,
            P_layout.build_shard_pi_gather(sl2, mv.sorted_idx, 0)),
        "pig-of-other-shards": (
            "sharded", P_layout.shard_blocked_layout(base, 3),
            P_layout.build_shard_pi_gather(sl2, mv.sorted_idx, 0)),
    }[case]
    bound = _raised(lambda: P_phi.bind_mode(
        strategy, layout, mv.rows, mv.sorted_vals, mv.n_rows,
        idx=mv.sorted_idx, mode=0, pi_gather=pig, device="cpu"))
    pi = None if pig is not None else pi_rows(mv.sorted_idx, factors, 0)
    kw = dict(strategy=strategy, layout=layout, pi_gather=pig,
              factors=factors, device="cpu")
    if strategy == "grid":
        kw["combine"] = "reduce_scatter"
    for entry in (P_phi.phi_from_rows, P_phi.phi_mu_step):
        assert _raised(lambda: entry(mv.rows, mv.sorted_vals, pi, b,
                                     mv.n_rows, **kw)) == bound
    assert _raised(lambda: P_phi.krao_reduce_rows(
        mv.rows, mv.sorted_vals, pi, mv.n_rows, **kw)) == bound
