"""The port's host-side substrate against the JAX package, array for array.

Layouts, segment-run statistics, the policy heuristic and the stable
per-mode sort order of ``repro_torch`` must equal the reference's on the
conformance fixtures (uniform, hub, empty-row; built as
``tests/test_conformance.py`` builds them), since every later comparison
of the two packages runs on them.
"""
import functools

import numpy as np
import pytest
import torch

from repro.core import layout as R_layout
from repro.core import policy as R_policy
from repro.core.sparse_tensor import sort_mode as r_sort_mode

from repro_torch.core import layout as P_layout
from repro_torch.core import policy as P_policy
from repro_torch.core.convert import sparse_tensor_from_numpy
from repro_torch.core.sparse_tensor import sort_mode as p_sort_mode

from test_conformance import BN, BR, FIXTURES, RANK, make_fixture

MODES = (0, 1, 2)
BLOCKINGS = ((BN, BR), (256, 256), (32, 8), (1024, 64))


@functools.lru_cache(maxsize=None)
def views(kind: str, mode: int):
    """(reference ModeView, port ModeView, reference tensor) for a mode."""
    t, _ = make_fixture(kind)
    pt = sparse_tensor_from_numpy(t.shape, np.asarray(t.indices),
                                  np.asarray(t.values), device="cpu")
    return r_sort_mode(t, mode), p_sort_mode(pt, mode), t


def _assert_layout_equal(a, b):
    for f in ("block_nnz", "block_rows", "n_rows", "n_rows_pad", "n_grid",
              "pad_fraction", "n_row_blocks"):
        assert getattr(a, f) == getattr(b, f), f
    for f in ("gather", "valid", "local_rows", "grid_rb"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", FIXTURES)
def test_sort_mode_order_equal(kind, mode):
    rmv, pmv, _ = views(kind, mode)
    np.testing.assert_array_equal(pmv.perm.numpy(), np.asarray(rmv.perm))
    np.testing.assert_array_equal(pmv.rows.numpy(), np.asarray(rmv.rows))
    np.testing.assert_array_equal(pmv.sorted_idx.numpy(),
                                  np.asarray(rmv.sorted_idx))
    np.testing.assert_array_equal(pmv.sorted_vals.numpy(),
                                  np.asarray(rmv.sorted_vals))
    np.testing.assert_array_equal(pmv.row_starts.numpy(),
                                  np.asarray(rmv.row_starts))
    assert pmv.n_rows == rmv.n_rows and pmv.nnz == rmv.nnz


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", FIXTURES)
def test_blocked_layout_equal(kind, mode):
    rmv, pmv, _ = views(kind, mode)
    for bn, br in BLOCKINGS:
        ref = R_layout.build_blocked_layout(np.asarray(rmv.rows), rmv.n_rows,
                                            bn, br)
        port = P_layout.build_blocked_layout(pmv.rows.numpy(), pmv.n_rows,
                                             bn, br)
        _assert_layout_equal(ref, port)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", FIXTURES)
def test_mode_run_stats_equal(kind, mode):
    rmv, pmv, t = views(kind, mode)
    width = int(np.prod([s for m, s in enumerate(t.shape) if m != mode]))
    for rw in (None, width):
        ref = R_layout.mode_run_stats(np.asarray(rmv.rows), rmv.n_rows, rw)
        port = P_layout.mode_run_stats(pmv.rows.numpy(), pmv.n_rows, rw)
        assert port.__dict__ == ref.__dict__
        assert port.key_fragment() == ref.key_fragment()


@pytest.mark.parametrize("platform", ("cpu", "tpu"))
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", FIXTURES)
def test_heuristic_policy_equal(kind, mode, platform):
    rmv, pmv, t = views(kind, mode)
    width = int(np.prod([s for m, s in enumerate(t.shape) if m != mode]))
    for rw in (None, width):
        rstats = R_layout.mode_run_stats(np.asarray(rmv.rows), rmv.n_rows, rw)
        pstats = P_layout.mode_run_stats(pmv.rows.numpy(), pmv.n_rows, rw)
        for rank in (RANK, 16, 200):
            ref = R_policy.heuristic_policy(rmv.nnz, rmv.n_rows, rank,
                                            platform=platform, stats=rstats)
            port = P_policy.heuristic_policy(pmv.nnz, pmv.n_rows, rank,
                                             platform=platform, stats=pstats)
            assert port.__dict__ == ref.__dict__


@pytest.mark.parametrize("nnz,n_rows,rank", [
    (3_309_490, 24, 16), (3_309_490, 1717, 16), (100, 5000, 4),
    (76_879_419, 28_818, 16), (0, 10, 4),
])
def test_heuristic_policy_no_stats_equal(nnz, n_rows, rank):
    for platform in ("cpu", "tpu"):
        ref = R_policy.heuristic_policy(nnz, n_rows, rank, platform=platform)
        port = P_policy.heuristic_policy(nnz, n_rows, rank, platform=platform)
        assert port.__dict__ == ref.__dict__


@pytest.mark.parametrize("bn,br", BLOCKINGS)
def test_policy_helpers_equal(bn, br):
    for rank in (4, 16, 300):
        assert P_policy.default_policy(rank).__dict__ == \
            R_policy.default_policy(rank).__dict__
        rp = R_policy.PhiPolicy(strategy="blocked", block_nnz=bn,
                                block_rows=br)
        pp = P_policy.PhiPolicy(strategy="blocked", block_nnz=bn,
                                block_rows=br)
        assert pp.label() == rp.label()
        assert P_policy.vmem_footprint_bytes(pp, rank) == \
            R_policy.vmem_footprint_bytes(rp, rank)


@pytest.mark.parametrize("nnz,n_rows,width", [
    (0, 10, 10), (5, 10, 1), (1500, 40, 750), (10, 3, 2),
])
def test_fill_stats_equal(nnz, n_rows, width):
    assert P_layout.fill_stats(nnz, n_rows, width) == \
        R_layout.fill_stats(nnz, n_rows, width)


def test_empty_mode_layout_equal():
    rows = np.zeros(0, np.int32)
    for bn, br in BLOCKINGS:
        _assert_layout_equal(R_layout.build_blocked_layout(rows, 13, bn, br),
                             P_layout.build_blocked_layout(rows, 13, bn, br))
    assert P_layout.mode_run_stats(rows, 13).__dict__ == \
        R_layout.mode_run_stats(rows, 13).__dict__


def test_unsorted_rows_rejected():
    with pytest.raises(ValueError, match="ascending"):
        P_layout.build_blocked_layout(np.array([2, 1, 3]), 4, 64, 4)


def test_layout_device_copies_cached():
    _, pmv, _ = views("hub", 0)
    lay = P_layout.build_blocked_layout(pmv.rows.numpy(), pmv.n_rows, BN, BR)
    lt = lay.on("cpu")
    assert lay.on(torch.device("cpu")) is lt
    assert lt.grid_rb.dtype == torch.int32
    assert lt.local_rows.dtype == torch.int32
    np.testing.assert_array_equal(lt.gather.numpy(), lay.gather)
    np.testing.assert_array_equal(lt.valid.numpy(), lay.valid)
