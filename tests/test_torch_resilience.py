"""The port's fault-tolerant runtime substrate against the JAX package's.

Mirrors ``tests/test_resilience.py`` for ``repro_torch.core.resilience``:
the checkpoint format (atomic, crc-checked, versioned; the same bytes
layout as the reference, readable by either package), the failure
classification of the degradation ladder with the port's CUDA cases
(OOM, nvcc build failures, the card-limit refusals, launch errors, and
the sticky errors that must propagate), append-batch validation, the
guard, and the autotune store's crc stamping.  Exceptions are built on
the CPU, through the code paths that raise them where the CPU can reach
them.
"""
import dataclasses
import json
import os
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import resilience as R_res
from repro.testing import faults as R_faults

from repro_torch.core import resilience
from repro_torch.core.convert import sparse_tensor_from_numpy
from repro_torch.core.policy import PhiPolicy, grid_search
from repro_torch.kernels import _build
from repro_torch.kernels._checks import SMEM_LIMIT, CardLimitError, check_card_limits
from repro_torch.perf.autotune import AutotuneCache
from repro_torch.testing import faults


# ---------------------------------------------------------------------------
# Checkpoint format
# ---------------------------------------------------------------------------


def _state(kind="torch"):
    lam = np.asarray([1.0, 2.0, 3.0], np.float32)
    factors = [np.ones((4, 3), np.float32), np.full((5, 3), 2.0, np.float32)]
    conv = {"torch": torch.from_numpy, "jax": jnp.asarray,
            "numpy": np.asarray}[kind]
    return {
        "fingerprint": "abc123",
        "outer": 7,
        "kkt_history": [0.5, 0.25],
        "strategies": ["segment", "blocked"],
        "lam": conv(lam),
        "factors": [conv(f) for f in factors],
    }


def test_checkpoint_roundtrip(tmp_path):
    path = str(tmp_path / "ck.bin")
    resilience.save_checkpoint(path, _state())
    out = resilience.load_checkpoint(path)
    assert out["fingerprint"] == "abc123"
    assert out["outer"] == 7
    assert out["kkt_history"] == [0.5, 0.25]
    assert out["strategies"] == ["segment", "blocked"]
    np.testing.assert_array_equal(out["lam"], [1.0, 2.0, 3.0])
    assert len(out["factors"]) == 2
    np.testing.assert_array_equal(out["factors"][1],
                                  np.full((5, 3), 2.0, np.float32))


@pytest.mark.parametrize("writer", ("port", "reference"))
def test_checkpoint_format_is_shared_with_the_reference(tmp_path, writer):
    """Same layout byte for byte (magic, 8-byte header length, the JSON
    header, the npz payload): what one package writes, the other reads,
    with equal headers and bitwise equal arrays."""
    p_path, r_path = str(tmp_path / "p.bin"), str(tmp_path / "r.bin")
    resilience.save_checkpoint(p_path, _state("torch"))
    R_res.save_checkpoint(r_path, _state("jax"))
    blobs = [open(p, "rb").read() for p in (p_path, r_path)]
    n = len(resilience._MAGIC)
    assert resilience._MAGIC == R_res._MAGIC
    assert resilience.CHECKPOINT_SCHEMA == R_res.CHECKPOINT_SCHEMA
    headers = []
    for blob in blobs:
        assert blob.startswith(resilience._MAGIC)
        hlen = int.from_bytes(blob[n:n + 8], "big")
        header = json.loads(blob[n + 8:n + 8 + hlen])
        header.pop("crc32")  # the npz's zip entries carry a timestamp
        headers.append(header)
    assert headers[0] == headers[1]
    path, load = ((p_path, R_res.load_checkpoint) if writer == "port"
                  else (r_path, resilience.load_checkpoint))
    out = load(path)
    want = _state("numpy")
    np.testing.assert_array_equal(out["lam"], want["lam"])
    for a, b in zip(out["factors"], want["factors"]):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    assert out["kkt_history"] == want["kkt_history"]


def test_checkpoint_write_is_atomic(tmp_path):
    path = str(tmp_path / "ck.bin")
    resilience.save_checkpoint(path, _state())
    first = open(path, "rb").read()
    st = _state()
    st["outer"] = 8
    resilience.save_checkpoint(path, st)
    assert resilience.load_checkpoint(path)["outer"] == 8
    assert [f for f in os.listdir(tmp_path) if f.endswith(".tmp")] == []
    assert open(path, "rb").read() != first


@pytest.mark.parametrize("kind", ["flip", "truncate", "magic"])
@pytest.mark.parametrize("harness", ("port", "reference"))
def test_checkpoint_corruption_detected(tmp_path, kind, harness):
    """The port's corruptions and the reference's corrupt the same bytes,
    and the port's loader refuses each."""
    path = str(tmp_path / "ck.bin")
    resilience.save_checkpoint(path, _state())
    (faults if harness == "port" else R_faults).corrupt_checkpoint(
        path, kind=kind)
    with pytest.raises(resilience.CheckpointError):
        resilience.load_checkpoint(path)


def test_checkpoint_quarantine(tmp_path):
    path = str(tmp_path / "ck.bin")
    resilience.save_checkpoint(path, _state())
    q = resilience.quarantine_checkpoint(path)
    assert q == path + ".corrupt"
    assert os.path.exists(q) and not os.path.exists(path)
    assert resilience.quarantine_checkpoint(path) == path  # nothing to move


def test_checkpoint_schema_gate(tmp_path):
    path = str(tmp_path / "ck.bin")
    resilience.save_checkpoint(path, _state())
    blob = open(path, "rb").read()
    n = len(resilience._MAGIC)
    hlen = int.from_bytes(blob[n:n + 8], "big")
    header = json.loads(blob[n + 8:n + 8 + hlen])
    header["schema"] = resilience.CHECKPOINT_SCHEMA + 1
    hb = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(resilience._MAGIC + len(hb).to_bytes(8, "big") + hb
                + blob[n + 8 + hlen:])
    with pytest.raises(resilience.CheckpointError, match="schema"):
        resilience.load_checkpoint(path)


def test_checkpoint_keeps_bf16_bits(tmp_path, monkeypatch):
    """bf16 factors are written and read back bit for bit without
    ``ml_dtypes``, which the port does not depend on."""
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    path = str(tmp_path / "ck.bin")
    st = _state()
    st["factors"] = [torch.tensor([[1.5, -2.25], [3e-3, 7.0]],
                                  dtype=torch.bfloat16)]
    resilience.save_checkpoint(path, st)
    back = resilience.array_to_tensor(
        resilience.load_checkpoint(path)["factors"][0], "cpu")
    assert back.dtype == torch.bfloat16
    assert torch.equal(back, st["factors"][0])


@pytest.mark.parametrize("writer", ("port", "reference"))
def test_bf16_checkpoint_arrays_cross_the_packages(tmp_path, writer):
    """A bf16 factor written by either package reads back with the same
    bits in the other."""
    import ml_dtypes

    bits = np.asarray([[0x3FC0, 0xC010], [0x3B45, 0x40E0]], np.uint16)
    want = bits.view(ml_dtypes.bfloat16)
    path = str(tmp_path / "ck.bin")
    st = _state("numpy" if writer == "port" else "jax")
    if writer == "port":
        st["factors"] = [torch.from_numpy(bits.view(np.int16).copy())
                         .view(torch.bfloat16)]
        resilience.save_checkpoint(path, st)
        got = R_res.load_checkpoint(path)["factors"][0]
        np.testing.assert_array_equal(
            np.ascontiguousarray(got).view(np.uint16), bits)
    else:
        st["factors"] = [jnp.asarray(want)]
        R_res.save_checkpoint(path, st)
        got = resilience.array_to_tensor(
            resilience.load_checkpoint(path)["factors"][0], "cpu")
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            got.view(torch.int16).numpy().view(np.uint16), bits)


def test_config_fingerprint_matches_the_reference():
    fields = {"rank": 4, "tol": 1e-4, "strategy": "pallas", "grid_shape": None}
    a = resilience.config_fingerprint(fields)
    assert a == R_res.config_fingerprint(fields)
    assert a == resilience.config_fingerprint(dict(reversed(fields.items())))
    assert a != resilience.config_fingerprint(dict(fields, rank=5))


@pytest.mark.parametrize("combine", ("auto", "psum", "reduce_scatter"))
@pytest.mark.parametrize("strategy", ("segment", "cuda", "sharded"))
def test_solver_fingerprint_hashes_combine_and_shard_pi(strategy, combine):
    """The solve's checkpoint fingerprint hashes the config's own
    ``combine`` and ``shard_pi`` (and ``cuda`` as ``pallas``) exactly as
    the reference's does, so a checkpoint of either package resumes in
    the other only under the same sharded configuration."""
    from repro.core import cpapr as R_cpapr
    from repro.core.sparse_tensor import SparseTensor as RTensor

    from repro_torch.core import cpapr as P_cpapr
    from repro_torch.core.sparse_tensor import SparseTensor as PTensor

    idx = np.array([[0, 1, 2], [3, 0, 1], [2, 2, 0]], np.int32)
    vals = np.array([1.0, 2.0, 3.0], np.float32)
    rt = RTensor(shape=(4, 3, 3), indices=jnp.asarray(idx),
                 values=jnp.asarray(vals))
    pt = PTensor(shape=(4, 3, 3), indices=torch.as_tensor(idx),
                 values=torch.as_tensor(vals))
    rname = {"cuda": "pallas"}.get(strategy, strategy)
    seen = set()
    for shard_pi in (True, False):
        got = P_cpapr._ckpt_fingerprint(pt, P_cpapr.CPAPRConfig(
            rank=2, strategy=strategy, combine=combine, shard_pi=shard_pi))
        want = R_cpapr._ckpt_fingerprint(rt, R_cpapr.CPAPRConfig(
            rank=2, strategy=rname, combine=combine, shard_pi=shard_pi))
        assert got == want
        seen.add(got)
    assert len(seen) == 2  # shard_pi is hashed
    other = "psum" if combine != "psum" else "auto"
    assert P_cpapr._ckpt_fingerprint(pt, P_cpapr.CPAPRConfig(
        rank=2, strategy=strategy, combine=other)) not in seen


def test_recovery_event_roundtrips_through_checkpoint(tmp_path):
    ev = resilience.RecoveryEvent("demote_kernel", outer=3, mode=1,
                                  attempt=0, detail={"action": "a->b"})
    path = str(tmp_path / "ck.bin")
    st = _state()
    st["recoveries"] = [dataclasses.asdict(ev)]
    resilience.save_checkpoint(path, st)
    back = resilience.load_checkpoint(path)["recoveries"]
    assert resilience.RecoveryEvent(**back[0]) == ev
    assert R_res.RecoveryEvent(**back[0]).kind == ev.kind


# ---------------------------------------------------------------------------
# Failure classification (the ladder's dispatch table)
# ---------------------------------------------------------------------------


class _FailedNvcc:
    returncode = 1

    def communicate(self):
        return "phi.cu(12): error: identifier undefined", None


def _nvcc_failure(tmp_path):
    out = tmp_path / "libphi_x.so"
    with pytest.raises(_build.BuildError) as e:
        _build._finish("phi", out, tmp_path / "t.so", _FailedNvcc())
    return e.value


def _nvcc_missing(monkeypatch):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    with pytest.raises(_build.BuildError, match="nvcc not found") as e:
        _build.find_nvcc()
    return e.value


def _card_limit(rank, smem):
    with pytest.raises(CardLimitError) as e:
        check_card_limits("phi_blocked", rank, block_nnz=64, block_rows=4,
                          smem_bytes=lambda r: smem)
    return e.value


def _launch(code):
    with pytest.raises(_build.LaunchError) as e:
        _build.check_launch("phi_mu_blocked", code)
    return e.value


CUDA_CASES = {
    "torch-oom": (lambda tp, mp: torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB"), "oom"),
    "memory-error": (lambda tp, mp: MemoryError("boom"), "oom"),
    "nvcc-failed": (lambda tp, mp: _nvcc_failure(tp), "kernel"),
    "nvcc-missing": (lambda tp, mp: _nvcc_missing(mp), "kernel"),
    "rank-over-1024": (lambda tp, mp: _card_limit(1025, 0), "kernel"),
    "rank-zero": (lambda tp, mp: _card_limit(0, 0), "kernel"),
    "smem-over-limit": (lambda tp, mp: _card_limit(16, SMEM_LIMIT + 1),
                        "kernel"),
    "launch-invalid-config": (lambda tp, mp: _launch(9), "kernel"),
    "launch-out-of-resources": (lambda tp, mp: _launch(701), "kernel"),
    **{f"sticky-{c}": (lambda tp, mp, c=c: _launch(c), None)
       for c in sorted(_build.STICKY_CUDA_ERRORS)},
    "torch-illegal-address": (lambda tp, mp: RuntimeError(
        "CUDA error: an illegal memory access was encountered"), None),
    "torch-device-assert": (lambda tp, mp: RuntimeError(
        "CUDA error: device-side assert triggered"), None),
    "not-ported": (lambda tp, mp: resilience.NotPortedError(
        "repro_torch.launch.serve: LM serving is not ported yet: "
        "ROADMAP A11"), None),
}


@pytest.mark.parametrize("case", sorted(CUDA_CASES))
def test_classify_failure_cuda_cases(tmp_path, monkeypatch, case):
    make, kind = CUDA_CASES[case]
    exc = make(tmp_path, monkeypatch)
    assert resilience.classify_failure(exc) == kind
    if isinstance(exc, _build.LaunchError):
        assert exc.sticky == (kind is None) and str(exc.code) in str(exc)
        assert "cudaError" in str(exc)  # the old message stays


REFERENCE_CASES = [
    MemoryError("boom"),
    RuntimeError("RESOURCE_EXHAUSTED: out of memory"),
    ValueError("unknown strategy 'warpspeed'"),
    ValueError("unknown combine 'ring'"),
    RuntimeError("Mosaic lowering failed"),
    RuntimeError("simulated kernel failure: CUDA kernel launch failed"),
    NotImplementedError("pallas path"),
    KeyError("nope"),
    AssertionError("bug"),
]


@pytest.mark.parametrize("i", range(len(REFERENCE_CASES)))
def test_classify_failure_matches_reference(i):
    exc = REFERENCE_CASES[i]
    assert resilience.classify_failure(exc) == R_res.classify_failure(exc)


def test_classify_failure_fault_harness_kinds():
    cf = resilience.classify_failure
    assert cf(resilience.ShardAssignmentError("rb_start moved")) \
        == "fingerprint"
    assert cf(faults.KilledError("kill")) is None  # must propagate
    assert cf(ValueError("block_rows too large")) is None


def test_strategy_demotion_chain():
    chain, s = [], "cuda"
    while s in resilience.STRATEGY_DEMOTION:
        s = resilience.STRATEGY_DEMOTION[s]
        chain.append(s)
    assert chain == ["blocked", "segment"]
    assert resilience.STRATEGY_DEMOTION["dense"] == "segment"
    assert R_res.STRATEGY_DEMOTION["pallas"] == \
        resilience.STRATEGY_DEMOTION["cuda"]


def test_backoff_schedule():
    assert resilience.backoff_sleep(3, 0.0) == 0.0
    assert resilience.backoff_sleep(0, 1e-4) == pytest.approx(1e-4)
    assert resilience.backoff_sleep(30, 1e-4, cap=2e-4) == pytest.approx(2e-4)


# ---------------------------------------------------------------------------
# Append-batch validation, against the reference's messages
# ---------------------------------------------------------------------------

SHAPE = (4, 3, 2)
GOOD_IDX = np.array([[0, 0, 0], [3, 2, 1], [1, 1, 1]])
GOOD_VALS = np.array([1.0, 2.0, 3.0])
BATCHES = {
    "ok": (GOOD_IDX, GOOD_VALS),
    "index": (np.array([[0, 0, 0], [3, 3, 1]]), np.array([1.0, 2.0])),
    "shape": (GOOD_IDX[:, :2], GOOD_VALS),
    "float-index": (GOOD_IDX.astype(np.float64), GOOD_VALS),
    "values-shape": (GOOD_IDX, GOOD_VALS[:2]),
    "values-dtype": (GOOD_IDX, np.array(["a", "b", "c"])),
    "nan": (GOOD_IDX, np.array([1.0, np.nan, 3.0])),
    "negative": (GOOD_IDX, np.array([1.0, -2.0, 3.0])),
}


@pytest.mark.parametrize("case", sorted(BATCHES))
def test_validate_append_batch_like_reference(case):
    idx, vals = BATCHES[case]

    def outcome(fn, *args):
        try:
            fn(SHAPE, *args)
        except ValueError as e:
            return str(e)
        return None

    got = outcome(resilience.validate_append_batch, torch.as_tensor(idx),
                  torch.as_tensor(vals)) if case not in (
        "values-dtype",) else outcome(resilience.validate_append_batch, idx,
                                       vals)
    want = outcome(R_res.validate_append_batch, idx, vals)
    assert got == want
    assert (got is None) == (case == "ok")


def test_input_checks_count_host_copies():
    """The solvers' check reads a torch tensor on its own device, with no
    copy of its arrays to host numpy; the append batch's, which checks
    dtypes too, copies both arrays."""
    t = sparse_tensor_from_numpy(SHAPE, GOOD_IDX, GOOD_VALS, "cpu")
    before = resilience.host_copies()
    resilience.validate_decomposition_inputs(t, 2)
    assert resilience.host_copies() == before
    resilience.validate_append_batch(SHAPE, torch.as_tensor(GOOD_IDX),
                                     torch.as_tensor(GOOD_VALS))
    assert resilience.host_copies() == before + 2


# ---------------------------------------------------------------------------
# grid_search probe retries (no permanent inf for transients)
# ---------------------------------------------------------------------------


def test_grid_search_retries_transient_probe():
    calls = {"n": 0}

    def flaky(p):
        calls["n"] += 1
        if calls["n"] == 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (transient)")
        return 0.5

    (pol, secs, err), = grid_search(flaky, [PhiPolicy()], retries=1,
                                    backoff=0.0)
    assert calls["n"] == 2 and secs == 0.5 and err is None


def test_grid_search_does_not_retry_card_limit_refusals():
    calls = {"n": 0}

    def refused(p):
        calls["n"] += 1
        raise CardLimitError("phi_blocked: rank 1025 outside 1..1024")

    (pol, secs, err), = grid_search(refused, [PhiPolicy()], retries=3,
                                    backoff=0.0)
    assert calls["n"] == 1
    assert secs == float("inf") and "retryable" not in err


# ---------------------------------------------------------------------------
# Autotune store: crc stamping, corruption, concurrent writers
# ---------------------------------------------------------------------------


def _store_one(cache, key="k0", strategy="segment"):
    cache.store(key, PhiPolicy(strategy=strategy), 0.01, "grid")


def test_cache_roundtrip_has_crc(tmp_path):
    path = str(tmp_path / "cache.json")
    _store_one(AutotuneCache(path))
    assert isinstance(json.load(open(path)).get("crc32"), str)
    c2 = AutotuneCache(path)
    assert c2.lookup("k0") is not None and c2.n_crc_failures == 0


def test_cache_corrupt_body_loads_empty(tmp_path):
    path = str(tmp_path / "cache.json")
    _store_one(AutotuneCache(path))
    data = json.load(open(path))
    data["entries"]["k0"]["seconds"] = 99.0  # tampered body, stale crc
    json.dump(data, open(path, "w"))
    c2 = AutotuneCache(path)
    assert c2.entries == {} and c2.n_crc_failures == 1
    _store_one(c2, "k1")
    assert AutotuneCache(path).lookup("k1") is not None


def test_cache_legacy_file_without_crc_accepted(tmp_path):
    path = str(tmp_path / "cache.json")
    _store_one(AutotuneCache(path))
    data = json.load(open(path))
    del data["crc32"]
    json.dump(data, open(path, "w"))
    c2 = AutotuneCache(path)
    assert c2.lookup("k0") is not None and c2.n_crc_failures == 0


def test_cache_concurrent_writers_leave_valid_file(tmp_path):
    path = str(tmp_path / "cache.json")
    errs = []

    def writer(i):
        try:
            c = AutotuneCache(path)
            for j in range(5):
                _store_one(c, key=f"w{i}-{j}")
        except Exception as e:  # pragma: no cover - the failure under test
            errs.append(e)

    threads = [threading.Thread(target=writer, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errs == []
    final = AutotuneCache(path)
    assert final.n_crc_failures == 0 and len(final.entries) >= 5


def test_heuristic_fallback_never_served_as_grid(tmp_path):
    path = str(tmp_path / "cache.json")
    c = AutotuneCache(path)
    c.store("k0", PhiPolicy(strategy="segment"), float("inf"), "heuristic")
    assert c.lookup("k0", source="grid") is None
    assert c.lookup("k0") is not None
    assert json.load(open(path))["entries"]["k0"]["seconds"] is None
