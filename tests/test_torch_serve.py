"""The port's decomposition service against the JAX package's, on the CPU.

Every test hands identical numpy inputs to both packages: tensors and
starting models are drawn in the JAX package and carried across with
``repro_torch.core.convert``, so no test relies on matching random
streams.  Tolerance is ``TOL`` (rtol 3e-5, atol 1e-5) unless a test says
bitwise.  Covered: the append path (``append_nonzeros``,
``merge_mode_view``, ``random_poisson_tensor(seed_ktensor=)``), the
padded-bucket tier (``BucketRegistry``, ``batched_cpapr_mu``), the
repaired ``sweep_step`` on per-job ``(J,)`` arrays, the bounded dense
workspace cache, ``DecompService`` (submit, submit_many, append, the
warm and cold sweep counts, the dense-cut crossing, validation, the
shared autotune counters) and the ``decomp`` driver.
"""
import io
import math
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cpapr as R_cpapr
from repro.core import sparse_tensor as R_st
from repro.serve import batch as R_batch
from repro.serve import decomp as R_decomp

from repro_torch.core import cpapr as P_cpapr
from repro_torch.core import sparse_tensor as P_st
from repro_torch.core.convert import ktensor_from_numpy, sparse_tensor_from_numpy
from repro_torch.kernels.dense import kernel as dense_kernel
from repro_torch.launch import serve as P_launch
from repro_torch.serve import batch as P_batch
from repro_torch.serve import decomp as P_decomp

from test_serve import _service_fixture

TOL = dict(rtol=3e-5, atol=1e-5)
BCFG = dict(max_outer=12, tol=1e-3, track_loglik=False)


def port_tensor(t):
    return sparse_tensor_from_numpy(t.shape, np.asarray(t.indices),
                                    np.asarray(t.values), device="cpu")


def port_kt(kt):
    return ktensor_from_numpy(np.asarray(kt.lam),
                              [np.asarray(f) for f in kt.factors], "cpu")


def ref_init(seed: int, shape, rank: int):
    return R_st.random_ktensor(jax.random.PRNGKey(seed), tuple(shape), rank)


def ref_tensor(seed: int, shape, nnz: int, rank: int):
    return R_st.random_poisson_tensor(jax.random.PRNGKey(seed), shape,
                                      nnz=nnz, rank=rank)[0]


def assert_kt_close(got, want, tol=TOL):
    np.testing.assert_allclose(got.lam.numpy(), np.asarray(want.lam), **tol)
    for a, b in zip(got.factors, want.factors):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)


def assert_result_matches(got, want):
    """Port CPAPRResult against the reference's: equal sweep and inner
    counts, KKT history and model at TOL."""
    assert got.n_outer == want.n_outer
    assert got.converged == want.converged
    assert got.inner_iters == [int(x) for x in want.inner_iters]
    np.testing.assert_allclose(got.kkt_history, want.kkt_history, **TOL)
    assert_kt_close(got.ktensor, want.ktensor)


# ---------------------------------------------------------------------------
# The append path
# ---------------------------------------------------------------------------


def _tiny_batch():
    shape = (4, 3)
    idx = np.asarray([[0, 0], [1, 1], [2, 2]])
    vals = np.asarray([1.0, 2.0, 3.0], np.float32)
    new_idx = np.asarray([[1, 1], [3, 0], [3, 0]])
    new_vals = np.asarray([5.0, 7.0, 7.0], np.float32)
    return shape, idx, vals, new_idx, new_vals


def _random_batch():
    t = ref_tensor(2, (13, 9, 7), 300, 3)
    rng = np.random.RandomState(0)
    k = 80
    new_idx = np.stack([rng.randint(0, s, size=k) for s in t.shape], axis=1)
    new_vals = rng.poisson(2.0, size=k).astype(np.float32) + 1.0
    return (t.shape, np.asarray(t.indices), np.asarray(t.values), new_idx,
            new_vals)


BATCHES = {"tiny": _tiny_batch, "random": _random_batch}


def _both_appends(case):
    shape, idx, vals, new_idx, new_vals = BATCHES[case]()
    rt = R_st.SparseTensor(shape=shape, indices=jnp.asarray(idx, jnp.int32),
                           values=jnp.asarray(vals, jnp.float32))
    pt = sparse_tensor_from_numpy(shape, idx, vals, device="cpu")
    return (rt, pt, R_st.append_nonzeros(rt, new_idx, new_vals),
            P_st.append_nonzeros(pt, new_idx, new_vals))


@pytest.mark.parametrize("case", tuple(BATCHES))
def test_append_nonzeros_matches_reference_bitwise(case):
    _, _, (r_m, r_info), (p_m, p_info) = _both_appends(case)
    assert p_info == P_st.AppendInfo(**vars(r_info))
    assert p_info.frac_new == r_info.frac_new
    np.testing.assert_array_equal(p_m.indices.numpy(), np.asarray(r_m.indices))
    np.testing.assert_array_equal(p_m.values.numpy(), np.asarray(r_m.values))
    assert p_m.shape == r_m.shape and p_m.values.dtype == torch.float32
    if case == "tiny":  # the reference test's own numbers
        assert (p_info.n_appended, p_info.n_fresh, p_info.n_merged) == \
            (3, 1, 1)
        np.testing.assert_array_equal(p_m.values.numpy(),
                                      [1.0, 7.0, 3.0, 14.0])


BAD_APPENDS = {
    "ndim": (np.zeros((2, 3), int), np.ones(2, np.float32)),
    "length": (np.zeros((2, 2), int), np.ones(3, np.float32)),
    "range": (np.asarray([[4, 0]]), np.ones(1, np.float32)),
    "negative": (np.asarray([[0, 0]]), np.asarray([-1.0], np.float32)),
}


@pytest.mark.parametrize("case", tuple(BAD_APPENDS))
def test_append_nonzeros_rejects_like_reference(case):
    shape, idx, vals, _, _ = _tiny_batch()
    rt = R_st.SparseTensor(shape=shape, indices=jnp.asarray(idx, jnp.int32),
                           values=jnp.asarray(vals, jnp.float32))
    pt = sparse_tensor_from_numpy(shape, idx, vals, device="cpu")
    with pytest.raises(ValueError) as r_err:
        R_st.append_nonzeros(rt, *BAD_APPENDS[case])
    with pytest.raises(ValueError) as p_err:
        P_st.append_nonzeros(pt, *BAD_APPENDS[case])
    assert str(p_err.value) == str(r_err.value)


FIELDS = ("perm", "rows", "sorted_idx", "sorted_vals", "row_starts")


@pytest.mark.parametrize("mode", (0, 1, 2))
def test_merge_mode_view_bitwise_against_resort_and_reference(mode):
    rt, pt, (r_m, _), (p_m, _) = _both_appends("random")
    inc = P_st.merge_mode_view(P_st.sort_mode(pt, mode), p_m, pt.nnz)
    full = P_st.sort_mode(p_m, mode)
    ref = R_st.merge_mode_view(R_st.sort_mode(rt, mode), r_m, rt.nnz)
    assert inc.mode == full.mode == mode and inc.n_rows == full.n_rows
    for f in FIELDS:
        got = getattr(inc, f)
        assert got.dtype == getattr(full, f).dtype, f
        assert got.device == p_m.device, f
        np.testing.assert_array_equal(got.numpy(), getattr(full, f).numpy(),
                                      err_msg=f)
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)


def test_random_poisson_tensor_samples_from_the_given_model():
    """With ``seed_ktensor`` the given model is sampled and returned; the
    model ``seed`` would draw gives the tensor the seed alone gives."""
    shape = (12, 10, 8)
    t0, kt0 = P_st.random_poisson_tensor(5, shape, 400, rank=3,
                                         device="cpu")
    model = P_st.random_ktensor(5, shape, 3, device="cpu")
    t1, kt1 = P_st.random_poisson_tensor(5, shape, 400, rank=3,
                                         device="cpu", seed_ktensor=model)
    np.testing.assert_array_equal(t1.indices.numpy(), t0.indices.numpy())
    np.testing.assert_array_equal(t1.values.numpy(), t0.values.numpy())
    for a, b in zip(kt1.factors, model.factors):
        assert torch.equal(a, b)
    other = P_st.random_ktensor(6, shape, 3, device="cpu")
    t2, kt2 = P_st.random_poisson_tensor(5, shape, 400, rank=3,
                                         device="cpu", seed_ktensor=other)
    assert torch.equal(kt2.lam, other.lam)
    assert not torch.equal(t2.indices[: t0.nnz // 2],
                           t0.indices[: t0.nnz // 2])


# ---------------------------------------------------------------------------
# sweep_step on per-job arrays
# ---------------------------------------------------------------------------


VIOLS = ((0.5, 0.1, 0.3), (0.2, 0.7, 1e-5), (0.4, 0.4, 0.9))
INNERS = ((3, 1, 4), (10, 2, 1), (5, 5, 0))


@pytest.mark.parametrize("nan_mode", (None, 1))
def test_sweep_step_takes_per_job_arrays(nan_mode):
    """``(J,)`` KKT values and inner counts per mode: the port's
    ``worst`` is their elementwise max and ``inner_total`` their sum, as
    the reference's; a NaN in one job's KKT aborts a guarded sweep."""

    def fns(arr):
        out = []
        for n, (v, c) in enumerate(zip(VIOLS, INNERS)):
            v = list(v)
            if n == nan_mode:
                v[1] = math.nan

            def fn(fac, lam, v=v, c=c, n=n):
                return (fac[n] + 1, lam, arr(np.asarray(v, np.float32)),
                        arr(np.asarray(c)), None)
            out.append(fn)
        return out

    facs = [np.zeros((2, 2), np.float32)] * 3
    want = R_cpapr.sweep_step(([jnp.asarray(f) for f in facs], jnp.ones(2)),
                              fns(jnp.asarray), guard=True)
    got = P_cpapr.sweep_step(([torch.as_tensor(f) for f in facs],
                              torch.ones(2)), fns(torch.as_tensor),
                             guard=True)
    assert got.bad == want.bad
    if nan_mode is None:
        np.testing.assert_array_equal(got.worst.numpy(),
                                      np.asarray(want.worst))
        np.testing.assert_array_equal(got.inner_total.numpy(),
                                      np.asarray(want.inner_total))
        assert got.worst.shape == (3,)


def test_sweep_step_keeps_host_numbers_exact():
    """``cpapr_mu``'s updates hand host numbers: the outcome reads back
    as exactly the max and the sum."""
    v = (0.1 + 1e-12, 0.3, 0.2)
    fns = [lambda f, l, n=n, x=x: (f[n], l, x, 2, None)
           for n, x in enumerate(v)]
    out = P_cpapr.sweep_step(([torch.zeros(1)] * 3, torch.ones(1)), fns)
    assert float(out.worst) == max(v) and int(out.inner_total) == 6


# ---------------------------------------------------------------------------
# The padded-bucket tier
# ---------------------------------------------------------------------------

SPECS = {
    "reference-test": [((17, 11, 9), 500, 3), ((20, 14, 10), 490, 3),
                       ((17, 11, 9), 2000, 3)],
    "driver-sizes": [((25, 20, 15), 2900, 2), ((18, 14, 10), 2000, 2),
                     ((24, 16, 16), 2049, 2), ((25, 20, 15), 10, 2),
                     ((25, 20, 15), 2900, 3)],
}


@pytest.mark.parametrize("case", tuple(SPECS))
def test_bucket_registry_groups_like_reference(case):
    r_reg, p_reg = R_batch.BucketRegistry(), P_batch.BucketRegistry()
    r_groups = r_reg.group(SPECS[case])
    p_groups = p_reg.group(SPECS[case])
    as_tuple = lambda g: sorted((b.shape, b.nnz, b.rank, tuple(v))
                                for b, v in g.items())
    assert as_tuple(p_groups) == as_tuple(r_groups)
    assert {str(b) for b in p_reg.seen} == {str(b) for b in r_reg.seen}


def _bucket_jobs(n, rank=3, shape=(17, 11, 9), nnz=500):
    ts = [ref_tensor(20 + j, shape, nnz, rank) for j in range(n)]
    inits = [ref_init(100 + j, t.shape, rank) for j, t in enumerate(ts)]
    return ts, inits


@pytest.mark.parametrize("max_outer,tol", ((12, 1e-3), (30, 1e-2)))
def test_batched_matches_reference(max_outer, tol):
    rank = 3
    ts, inits = _bucket_jobs(3, rank)
    cfg = dict(max_outer=max_outer, tol=tol, track_loglik=False)
    want, r_bucket = R_batch.batched_cpapr_mu(
        ts, rank, inits=inits, config=R_cpapr.CPAPRConfig(rank=rank, **cfg))
    got, p_bucket = P_batch.batched_cpapr_mu(
        [port_tensor(t) for t in ts], rank, inits=[port_kt(k) for k in inits],
        config=P_cpapr.CPAPRConfig(rank=rank, **cfg), device="cpu")
    assert (p_bucket.shape, p_bucket.nnz) == (r_bucket.shape, r_bucket.nnz)
    for g, w in zip(got, want):
        assert_result_matches(g, w)
        assert [f.shape[0] for f in g.ktensor.factors] == \
            [f.shape[0] for f in w.ktensor.factors]


def test_batched_bitwise_independent_of_cohort():
    """A job solved in a 3-job bucket is bitwise the job solved alone
    through the same bucket, on the CPU: factors, lam, sweep and inner
    counts."""
    rank = 3
    ts, inits = _bucket_jobs(3, rank)
    pts, pinits = [port_tensor(t) for t in ts], [port_kt(k) for k in inits]
    cfg = P_cpapr.CPAPRConfig(rank=rank, **BCFG)
    res3, bucket = P_batch.batched_cpapr_mu(pts, rank, inits=pinits,
                                            config=cfg, device="cpu")
    for j in range(3):
        (res1,), _ = P_batch.batched_cpapr_mu([pts[j]], rank,
                                              inits=[pinits[j]], config=cfg,
                                              bucket=bucket, device="cpu")
        assert res1.n_outer == res3[j].n_outer
        assert res1.inner_iters == res3[j].inner_iters
        assert torch.equal(res1.ktensor.lam, res3[j].ktensor.lam)
        for a, b in zip(res1.ktensor.factors, res3[j].ktensor.factors):
            assert torch.equal(a, b)


def test_batched_matches_unpadded_solver():
    """Through the padded path a job matches the port's own unpadded
    ``segment`` solve from the same seed, at the reference test's
    tolerance for this comparison (padding changes the sums' order)."""
    rank = 3
    ts, _ = _bucket_jobs(2, rank)
    pts = [port_tensor(t) for t in ts]
    cfg = P_cpapr.CPAPRConfig(rank=rank, **BCFG)
    res, _ = P_batch.batched_cpapr_mu(pts, rank, seeds=[7, 8], config=cfg,
                                      device="cpu")
    for t, seed, r in zip(pts, (7, 8), res):
        ref = P_cpapr.cpapr_mu(t, rank, seed=seed, device="cpu",
                               config=P_cpapr.CPAPRConfig(
                                   rank=rank, strategy="segment", **BCFG))
        assert r.converged == ref.converged and r.n_outer == ref.n_outer
        np.testing.assert_allclose(r.ktensor.lam.numpy(),
                                   ref.ktensor.lam.numpy(),
                                   rtol=2e-3, atol=1e-5)
        for a, b in zip(r.ktensor.factors, ref.ktensor.factors):
            np.testing.assert_allclose(a.numpy(), b.numpy(),
                                       rtol=2e-3, atol=1e-5)


def test_padding_rejects_what_does_not_fit():
    t = port_tensor(ref_tensor(0, (10, 8, 6), 100, 2))
    with pytest.raises(ValueError, match="does not fit bucket"):
        P_batch.pad_tensor(t, P_batch.Bucket((8, 8, 8), 128, 2))
    with pytest.raises(ValueError, match="exceeds bucket nnz"):
        P_batch.pad_tensor(t, P_batch.Bucket((16, 8, 8), 64, 2))
    kt = P_st.random_ktensor(0, (10, 8, 6), 2, device="cpu")
    with pytest.raises(ValueError, match="does not fit bucket extent"):
        P_batch.padded_init_from(kt, P_batch.Bucket((8, 8, 8), 128, 2))
    with pytest.raises(ValueError, match="no tensors"):
        P_batch.batched_cpapr_mu([], 2, device="cpu")


# ---------------------------------------------------------------------------
# The bounded dense workspace cache
# ---------------------------------------------------------------------------


def test_dense_workspaces_stay_within_their_bound():
    """Many shapes on one stream keep at most WORK_MAX workspaces, the
    most recently used; a held workspace outlives its eviction."""
    saved = dict(dense_kernel._WORK)
    dense_kernel._WORK.clear()
    try:
        shapes = [dense_kernel.launch_shape(4 + k, 8 + k, 8, 4)
                  for k in range(3 * dense_kernel.WORK_MAX)]
        with dense_kernel.hold_workspaces() as held:
            first = dense_kernel.workspace(shapes[0], "cpu")
        for sh in shapes:
            dense_kernel.workspace(sh, "cpu")
        assert len(dense_kernel._WORK) == dense_kernel.WORK_MAX
        last = [(sh.part_numel, sh.n_tickets) for sh in shapes]
        kept = [k[2:] for k in dense_kernel._WORK]
        assert kept == list(dict.fromkeys(last))[-dense_kernel.WORK_MAX:]
        assert held == [first] and held[0][0].numel() == shapes[0].part_numel
        again = dense_kernel.workspace(shapes[-1], "cpu")
        assert again is dense_kernel._WORK[next(reversed(dense_kernel._WORK))]
    finally:
        dense_kernel._WORK.clear()
        dense_kernel._WORK.update(saved)


# ---------------------------------------------------------------------------
# DecompService against the reference's
# ---------------------------------------------------------------------------


def _services(tmp_path, **kw):
    r = R_decomp.DecompService(autotune_path=str(tmp_path / "r.json"), **kw)
    p = P_decomp.DecompService(autotune_path=str(tmp_path / "p.json"),
                               device="cpu", **kw)
    return r, p


def _extra(seed, shape, k):
    rng = np.random.RandomState(seed)
    idx = np.stack([rng.randint(0, s, size=k) for s in shape], axis=1)
    return idx, rng.poisson(2.0, size=k).astype(np.float32) + 1.0


def test_service_submit_and_append_match_reference(tmp_path):
    rank = 2
    r_svc, p_svc = _services(tmp_path, max_outer=12, tol=1e-3)
    t = ref_tensor(30, (17, 11, 9), 500, rank)
    init = ref_init(300, t.shape, rank)
    want = r_svc.submit("a", t, rank, init=init)
    got = p_svc.submit("a", port_tensor(t), rank, init=port_kt(init))
    assert_result_matches(got.result, want.result)
    assert [p.strategy for p in got.result.policies] == \
        [p.strategy for p in want.result.policies]
    idx, vals = _extra(1, t.shape, 60)
    want = r_svc.append("a", idx, vals)
    got = p_svc.append("a", idx, vals)
    assert (got.warm, got.frac_new, got.sweep_budget, got.stats_changed) == \
        (want.warm, want.frac_new, want.sweep_budget, want.stats_changed)
    assert_result_matches(got.result, want.result)
    np.testing.assert_array_equal(
        p_svc.tenant("a").tensor.values.numpy(),
        np.asarray(r_svc.tenant("a").tensor.values))
    assert p_svc.stats()["jobs"] == r_svc.stats()["jobs"] == 2
    assert p_svc.tenant("a").n_appends == 1


def test_service_submit_many_one_dispatch_per_bucket(tmp_path):
    """Same-bucket jobs share one dispatch; results align with the job
    list and match the reference's; a later append works on the state the
    batched path registered."""
    rank = 2
    r_svc, p_svc = _services(tmp_path, max_outer=12, tol=1e-3)
    ts = [ref_tensor(30 + j, (17, 11, 9), 500, rank) for j in range(3)]
    inits = [ref_init(300 + j, t.shape, rank) for j, t in enumerate(ts)]
    want = r_svc.submit_many([R_decomp.DecompJob(f"t{j}", t, rank, init=k)
                              for j, (t, k) in enumerate(zip(ts, inits))])
    got = p_svc.submit_many([P_decomp.DecompJob(f"t{j}", port_tensor(t), rank,
                                                init=port_kt(k))
                             for j, (t, k) in enumerate(zip(ts, inits))])
    assert [r.tenant for r in got] == ["t0", "t1", "t2"]
    assert all(r.batched for r in got)
    assert p_svc.n_batched_dispatches == r_svc.n_batched_dispatches == 1
    for g, w in zip(got, want):
        assert_result_matches(g.result, w.result)
    idx, vals = _extra(1, ts[0].shape, 60)
    g, w = p_svc.append("t0", idx, vals), r_svc.append("t0", idx, vals)
    assert_result_matches(g.result, w.result)
    assert p_svc.tenant("t0").tensor.nnz == r_svc.tenant("t0").tensor.nnz
    with pytest.raises(ValueError, match="unknown tenant"):
        p_svc.append("nope", idx, vals)


def test_service_warm_and_cold_sweeps_equal_reference(tmp_path):
    """On the reference test's streaming fixture, the warm append's sweep
    count, budget and freshness and a cold solve of the merged tensor are
    the reference's, read from it here."""
    rank, max_outer, tol = 2, 60, 1e-2
    t, extra = _service_fixture(rank=rank)
    r_svc, p_svc = _services(tmp_path, max_outer=max_outer, tol=tol)
    init = ref_init(0, t.shape, rank)
    r_svc.submit("a", t, rank, init=init)
    p_svc.submit("a", port_tensor(t), rank, init=port_kt(init))
    want = r_svc.append("a", np.asarray(extra.indices),
                        np.asarray(extra.values))
    got = p_svc.append("a", np.asarray(extra.indices),
                       np.asarray(extra.values))
    assert (got.frac_new, got.sweep_budget) == (want.frac_new,
                                                want.sweep_budget)
    assert_result_matches(got.result, want.result)
    cold_init = ref_init(5, t.shape, rank)
    cfg = dict(rank=rank, max_outer=max_outer, tol=tol, track_loglik=False)
    r_cold = R_cpapr.cpapr_mu(r_svc.tenant("a").tensor, rank, init=cold_init,
                              config=R_cpapr.CPAPRConfig(**cfg))
    p_cold = P_cpapr.cpapr_mu(p_svc.tenant("a").tensor, rank,
                              init=port_kt(cold_init), device="cpu",
                              config=P_cpapr.CPAPRConfig(**cfg))
    assert_result_matches(p_cold, r_cold)
    assert (got.result.n_outer, p_cold.n_outer) == \
        (want.result.n_outer, r_cold.n_outer)


def test_append_crossing_dense_cut_switches_strategy_like_reference(tmp_path):
    rank = 2
    shape = (30, 8, 8)
    t = ref_tensor(7, shape, 150, rank)
    init = ref_init(0, shape, rank)
    r_svc, p_svc = _services(tmp_path, max_outer=8, tol=1e-3)
    want = r_svc.submit("a", t, rank, init=init)
    got = p_svc.submit("a", port_tensor(t), rank, init=port_kt(init))
    cold = [p.strategy for p in got.result.policies]
    assert cold == [p.strategy for p in want.result.policies]
    assert "dense" not in cold
    idx, vals = _extra(1, shape, 900)
    want = r_svc.append("a", idx, vals, sweep_budget=4)
    got = p_svc.append("a", idx, vals, sweep_budget=4)
    warm = [p.strategy for p in got.result.policies]
    assert warm == [p.strategy for p in want.result.policies]
    assert "dense" in warm and got.stats_changed and want.stats_changed
    assert_result_matches(got.result, want.result)
    st = p_svc.tenant("a")
    fresh = P_decomp._tensor_mode_stats(st.tensor, st.mode_views)
    assert [s.key_fragment() for s in st.mode_stats] == \
        [s.key_fragment() for s in fresh] == \
        [s.key_fragment() for s in r_svc.tenant("a").mode_stats]


def _bad_tensor():
    idx = np.asarray([[10, 0, 0]])
    vals = np.asarray([1.0], np.float32)
    return (R_st.SparseTensor((10, 8, 6), jnp.asarray(idx, jnp.int32),
                              jnp.asarray(vals)),
            sparse_tensor_from_numpy((10, 8, 6), idx, vals, device="cpu"))


BAD_SUBMITS = ("rank", "rank-many", "index")


def _bad_submit(case, svc, t, job_cls):
    if case == "rank-many":
        return svc.submit_many([job_cls("a", t, 0)])
    return svc.submit("a", t, 0 if case == "rank" else 2)


@pytest.mark.parametrize("case", BAD_SUBMITS)
def test_submit_rejects_like_reference(tmp_path, case):
    """submit/submit_many validate at the service boundary with the
    reference's messages; nothing is registered on rejection."""
    r_svc, p_svc = _services(tmp_path, max_outer=3, tol=1e-3)
    t = ref_tensor(0, (10, 8, 6), 100, 2)
    r_t, p_t = (t, port_tensor(t)) if case != "index" else _bad_tensor()
    with pytest.raises(ValueError) as r_err:
        _bad_submit(case, r_svc, r_t, R_decomp.DecompJob)
    with pytest.raises(ValueError) as p_err:
        _bad_submit(case, p_svc, p_t, P_decomp.DecompJob)
    assert str(p_err.value) == str(r_err.value)
    assert not p_svc.tenants and p_svc.n_jobs == 0


BAD_BATCHES = {
    "ndim": (np.zeros((2, 2), np.int64), np.ones(2, np.float32)),
    "float-index": (np.zeros((2, 3), np.float32), np.ones(2, np.float32)),
    "range": (np.asarray([[10, 0, 0]]), np.ones(1, np.float32)),
    "length": (np.zeros((2, 3), np.int64), np.ones(3, np.float32)),
    "negative": (np.zeros((2, 3), np.int64),
                 np.asarray([1.0, -1.0], np.float32)),
    "nan": (np.zeros((1, 3), np.int64), np.asarray([np.nan], np.float32)),
}


@pytest.mark.parametrize("case", tuple(BAD_BATCHES))
def test_append_rejects_like_reference(tmp_path, case):
    r_svc, p_svc = _services(tmp_path, max_outer=3, tol=1e-3)
    t = ref_tensor(0, (10, 8, 6), 120, 2)
    init = ref_init(0, t.shape, 2)
    r_svc.submit("a", t, 2, init=init)
    p_svc.submit("a", port_tensor(t), 2, init=port_kt(init))
    with pytest.raises(ValueError) as r_err:
        r_svc.append("a", *BAD_BATCHES[case])
    with pytest.raises(ValueError) as p_err:
        p_svc.append("a", *BAD_BATCHES[case])
    assert str(p_err.value) == str(r_err.value)
    assert "DecompService.append" in str(p_err.value)
    st = p_svc.tenant("a")
    assert st.tensor.nnz == t.nnz and st.n_appends == 0


def test_service_shares_autotune_counters_like_reference(tmp_path):
    """Two tenants with the same problem hit one shared store: after each
    submit the port's counters and store size equal the reference's."""
    rank = 2
    r_svc, p_svc = _services(tmp_path, max_outer=3, tol=1e-3)
    t = ref_tensor(40, (25, 20, 15), 1500, rank)
    for name, seed in (("alice", 0), ("bob", 1)):
        init = ref_init(seed, t.shape, rank)
        r_svc.submit(name, t, rank, init=init)
        p_svc.submit(name, port_tensor(t), rank, init=port_kt(init))
        assert p_svc.stats()["autotune"] == r_svc.stats()["autotune"]
        assert p_svc.stats()["autotune_cache_entries"] == \
            r_svc.stats()["autotune_cache_entries"]
    s = p_svc.stats()
    assert s["autotune"]["hits"] == t.ndim and s["autotune"]["searches"] == \
        t.ndim and s["tenants"] == 2
    assert set(s) == set(r_svc.stats())


def test_warm_sweep_budget_is_the_reference_schedule():
    for frac, base, floor in ((0.0, 20, 2), (0.1, 20, 2), (0.5, 20, 2),
                              (1.0, 20, 2), (0.05, 40, 3), (-1.0, 20, 2),
                              (0.102, 40, 2)):
        assert P_decomp.warm_sweep_budget(frac, base, floor) == \
            R_decomp.warm_sweep_budget(frac, base, floor)


# ---------------------------------------------------------------------------
# The decomp driver
# ---------------------------------------------------------------------------


def test_decomp_driver_runs_on_the_cpu(tmp_path):
    out = io.StringIO()
    with redirect_stdout(out):
        rc = P_launch.main(["decomp", "--device", "cpu", "--jobs", "2",
                            "--shape", "14", "12", "10", "--nnz", "600",
                            "--max-outer", "20",
                            "--autotune-cache", str(tmp_path / "at.json")])
    text = out.getvalue()
    assert rc == 0, text
    assert "[decomp] device=cpu" in text
    assert "2 jobs in 1 batched dispatch(es)" in text
    assert "-> warm" in text and "vs cold" in text
    assert "[decomp] autotune:" in text and text.rstrip().endswith(
        "[decomp] OK")


def test_lm_serving_is_not_ported():
    """LM serving is ported now: ``--arch`` no longer raises
    NotPortedError but serves (here the reduced config on the CPU), and
    NotPortedError stays for options still to come."""
    from repro_torch.core.resilience import NotPortedError

    out = io.StringIO()
    with redirect_stdout(out):
        rc = P_launch.main(["--arch", "olmo-1b", "--device", "cpu",
                            "--new-tokens", "2", "--prompt-len", "8"])
    assert rc == 0 and "[serve] arch=olmo-1b-smoke" in out.getvalue()
    assert issubclass(NotPortedError, NotImplementedError)
