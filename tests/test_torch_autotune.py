"""The port's persistent autotuner against the JAX package's.

Mirrors ``tests/test_autotune_cache.py`` (its single-device cases and
its sharded ones: the ``/shards=``, ``/assign=`` and ``/combine=`` key
dimensions equal to the reference's strings, per-shard tuning, the
re-keying of a rebalanced assignment) and the autotune half of
``tests/test_fused_autotune.py`` for ``repro_torch.perf.autotune``: the
store's location (its own file and environment variable, never the JAX
package's), recovery from bad files, the v2 keys (the reference's with
the platform ``cpu``/``cuda``), v1 migration, quarantine, staleness on
the torch/CUDA versions and the card, the LRU and TTL bounds, the burst
probe, the model-guided pruning from analytic counts, and
``policy="auto"`` in both solvers (fills the cache, then serves it with
zero probes).  Inputs: the reference's ``small_tensor`` fixture as numpy.
"""
import json
import os
import time

import numpy as np
import pytest
import torch

from repro.core.layout import mode_run_stats as r_mode_run_stats
from repro.perf import autotune as R_at

from repro_torch.core import cpals as P_cpals
from repro_torch.core.convert import ktensor_from_numpy, sparse_tensor_from_numpy
from repro_torch.core.cpapr import CPAPRConfig, cpapr_mu, extract_mode_cutout
from repro_torch.core.layout import build_blocked_layout, mode_run_stats
from repro_torch.core.phi import phi_mu_step
from repro_torch.core.pi import pi_rows
from repro_torch.core.policy import PhiPolicy, model_top_k, vmem_footprint_bytes
from repro_torch.core.sparse_tensor import sort_mode
from repro_torch.perf import autotune as P_at
from repro_torch.perf.autotune import (
    Autotuner,
    AutotuneCache,
    candidate_policies,
    default_cache_path,
    policy_key,
)
from repro_torch.testing import faults

RANK = 4


@pytest.fixture
def port_tensor(small_tensor):
    t, kt = small_tensor
    pt = sparse_tensor_from_numpy(t.shape, np.asarray(t.indices),
                                  np.asarray(t.values), device="cpu")
    pkt = ktensor_from_numpy(np.asarray(kt.lam),
                             [np.asarray(f) for f in kt.factors], "cpu")
    return pt, pkt


def _mode_problem(port_tensor, mode=0):
    t, kt = port_tensor
    mv = sort_mode(t, mode)
    pi = pi_rows(mv.sorted_idx, kt.factors, mode)
    b = kt.factors[mode] * kt.lam[None, :]
    return mv, pi, b


def _tune(tuner, mv, pi, b):
    return tuner.policy_for_mode(mv.rows, mv.sorted_vals, pi, b,
                                 n_rows=mv.n_rows, rank=RANK)


def _v2_key(mv):
    return policy_key(mv.nnz, mv.n_rows, RANK, "cpu",
                      stats=mode_run_stats(mv.rows.numpy(), mv.n_rows))


# ---------------------------------------------------------------------------
# Store location: the port's own file and variable
# ---------------------------------------------------------------------------


def test_env_var_cache_path_roundtrip(port_tensor, tmp_path, monkeypatch):
    path = str(tmp_path / "env_cache.json")
    jax_path = str(tmp_path / "jax_cache.json")
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", path)
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", jax_path)
    assert default_cache_path() == path
    mv, pi, b = _mode_problem(port_tensor)
    pol = _tune(Autotuner(measure=False), mv, pi, b)
    assert os.path.exists(path) and not os.path.exists(jax_path)
    t2 = Autotuner(measure=False)
    assert _tune(t2, mv, pi, b) == pol
    assert t2.n_hits == 1 and t2.n_searches == 0
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE_CACHE")
    assert default_cache_path().endswith(
        os.path.join("repro_torch", "autotune.json"))
    assert default_cache_path() != R_at.default_cache_path()


# ---------------------------------------------------------------------------
# Corrupted / partial stores
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("content", [
    "{not json",
    "[]",
    '{"version": 99, "entries": {"k": {}}}',
    '{"entries": {"k": {}}}',
])
def test_cache_load_recovers_from_bad_files(tmp_path, content):
    path = str(tmp_path / "cache.json")
    with open(path, "w") as f:
        f.write(content)
    c = AutotuneCache(path)
    assert c.entries == {}
    key = policy_key(10, 5, 4, "cpu")
    c.store(key, PhiPolicy(strategy="segment"), 0.5, "grid")
    assert AutotuneCache(path).lookup(key) == PhiPolicy(strategy="segment")


def test_cache_lookup_tolerates_partial_entries(tmp_path):
    path = str(tmp_path / "cache.json")
    good = policy_key(100, 10, 8, "cpu")
    with open(path, "w") as f:
        json.dump({"version": AutotuneCache.VERSION, "entries": {
            "no-policy": {"seconds": 0.1, "source": "grid"},
            "bad-fields": {"policy": {"bogus_field": 1}, "source": "grid"},
            good: {"policy": {"strategy": "blocked", "block_nnz": 128,
                              "block_rows": 64, "gather_mode": "prefetch"},
                   "seconds": 0.01, "source": "grid", "tuned_at": 0},
        }}, f)
    c = AutotuneCache(path)
    assert c.lookup("no-policy") is None and c.lookup("bad-fields") is None
    assert c.lookup("missing-entirely") is None
    assert c.lookup(good) == PhiPolicy(strategy="blocked", block_nnz=128,
                                       block_rows=64)


def test_stored_pallas_policy_is_served_as_cuda(tmp_path):
    """An entry naming the reference's ``pallas`` is served as ``cuda``."""
    path = str(tmp_path / "cache.json")
    c = AutotuneCache(path)
    c.entries["k"] = {"policy": {"strategy": "pallas", "block_nnz": 512,
                                 "block_rows": 8, "gather_mode": "prefetch"},
                      "source": "grid", "tuned_at": time.time()}
    assert c.lookup("k") == PhiPolicy(strategy="cuda", block_nnz=512,
                                      block_rows=8)


def test_lookup_source_filter_gates_heuristic_placeholders(tmp_path):
    c = AutotuneCache(str(tmp_path / "cache.json"))
    key = policy_key(50, 9, 4, "cpu")
    c.store(key, PhiPolicy(strategy="segment"), float("inf"), "heuristic")
    assert c.lookup(key) is not None
    assert c.lookup(key, source="grid") is None
    c.store(key, PhiPolicy(strategy="blocked"), 0.002, "grid")
    assert c.lookup(key, source="grid") == PhiPolicy(strategy="blocked")


# ---------------------------------------------------------------------------
# v2 keys: the reference's, with the port's platforms
# ---------------------------------------------------------------------------


def _uniform_rows(n_rows, per_row):
    return np.repeat(np.arange(n_rows, dtype=np.int32), per_row)


def _hub_rows(n_rows, nnz):
    rows = np.zeros(nnz, np.int32)
    rows[-1] = n_rows - 1
    return np.sort(rows)


@pytest.mark.parametrize("rows", ("uniform", "hub", "none"))
@pytest.mark.parametrize("platform", ("cpu", "cuda"))
def test_policy_key_is_the_references(rows, platform):
    n_rows = 64
    r = (_uniform_rows(n_rows, 8) if rows == "uniform"
         else _hub_rows(n_rows, 512) if rows == "hub" else None)
    stats = None if r is None else mode_run_stats(r, n_rows)
    rstats = None if r is None else r_mode_run_stats(r, n_rows)
    assert policy_key(512, n_rows, 8, platform, stats=stats) == \
        R_at.policy_key(512, n_rows, 8, platform, stats=rstats)


def test_v2_keys_discriminate_and_share_like_the_reference():
    n_rows, rank = 64, 8
    uni, hub = _uniform_rows(n_rows, 8), _hub_rows(n_rows, n_rows * 8)
    k_uni = policy_key(len(uni), n_rows, rank, "cpu",
                       stats=mode_run_stats(uni, n_rows))
    k_hub = policy_key(len(hub), n_rows, rank, "cpu",
                       stats=mode_run_stats(hub, n_rows))
    assert k_uni != k_hub and k_uni.startswith("v2/")
    a = _uniform_rows(50, 10)
    b = a.copy()
    b[10:12] = 0
    b = np.sort(b)
    assert policy_key(len(a), 50, rank, "cpu",
                      stats=mode_run_stats(a, 50)) == \
        policy_key(len(b), 50, rank, "cpu", stats=mode_run_stats(b, 50))


def test_tuner_gives_equal_stats_modes_distinct_entries(port_tensor,
                                                        tmp_path):
    mv, pi, b = _mode_problem(port_tensor)
    n_rows, per_row = 50, 8
    uni, hub = _uniform_rows(n_rows, per_row), _hub_rows(n_rows,
                                                         n_rows * per_row)
    vals, pi_x = mv.sorted_vals[: len(uni)], pi[: len(uni)]
    b_x = torch.ones((n_rows, RANK))
    tuner = Autotuner(cache_path=str(tmp_path / "c.json"), measure=False)
    for rows in (uni, hub, uni, hub):
        tuner.policy_for_mode(rows, vals, pi_x, b_x, n_rows=n_rows, rank=RANK)
    assert tuner.n_searches == 2 and tuner.n_hits == 2
    assert len(tuner.cache.entries) == 2


# ---------------------------------------------------------------------------
# v1 -> v2 migration, quarantine, staleness
# ---------------------------------------------------------------------------


def _write_v1_store(path, key, policy_dict, seconds=0.01, source="grid"):
    with open(path, "w") as f:
        json.dump({"version": 1, "entries": {
            key: {"policy": policy_dict, "seconds": seconds,
                  "source": source, "tuned_at": 0},
        }}, f)


MARKER = {"strategy": "blocked", "block_nnz": 512, "block_rows": 16,
          "gather_mode": "prefetch"}


def test_v1_store_loads_quarantined_not_crashing(tmp_path):
    path = str(tmp_path / "cache.json")
    key = policy_key(100, 10, 8, "cpu")
    _write_v1_store(path, key, MARKER)
    c = AutotuneCache(path)
    assert c.entries == {} and c.quarantined[key]["reason"] == "v1-schema"
    assert c.quarantined_policy(key) == PhiPolicy(**MARKER)
    c.store(policy_key(1, 1, 1, "cpu"), PhiPolicy(), 0.1, "grid")
    assert AutotuneCache(path).quarantined[key]["reason"] == "v1-schema"


def test_non_measuring_tuner_migrates_v1_winner(port_tensor, tmp_path):
    mv, pi, b = _mode_problem(port_tensor)
    path = str(tmp_path / "cache.json")
    v1_key = policy_key(mv.nnz, mv.n_rows, RANK, "cpu")
    _write_v1_store(path, v1_key, MARKER)
    tuner = Autotuner(cache_path=path, measure=False)
    pol = _tune(tuner, mv, pi, b)
    assert pol == PhiPolicy(**MARKER) and tuner.n_migrated == 1
    entry = tuner.cache.entries[_v2_key(mv)]
    assert entry["source"] == "migrated-v1" and entry["schema"] == 1
    assert entry["migrated_from"] == v1_key
    t2 = Autotuner(cache_path=path, measure=False)
    assert _tune(t2, mv, pi, b) == pol
    assert t2.n_hits == 1 and t2.n_migrated == 0


def test_measuring_tuner_retunes_migrated_v1_entry(port_tensor, tmp_path):
    mv, pi, b = _mode_problem(port_tensor)
    path = str(tmp_path / "cache.json")
    _write_v1_store(path, policy_key(mv.nnz, mv.n_rows, RANK, "cpu"), MARKER)
    _tune(Autotuner(cache_path=path, measure=False), mv, pi, b)
    t2 = Autotuner(cache_path=path, iters=1, warmup=1, burst=2)
    _tune(t2, mv, pi, b)
    assert t2.n_hits == 0 and t2.n_grid_searches == 1
    entry = t2.cache.entries[_v2_key(mv)]
    assert entry["source"] == "grid" and entry["schema"] == 2


def test_corrupt_v2_entries_are_quarantined(tmp_path):
    path = str(tmp_path / "cache.json")
    good = policy_key(100, 10, 8, "cpu")
    with open(path, "w") as f:
        json.dump({"version": AutotuneCache.VERSION, "entries": {
            "not-a-dict": 42,
            "no-policy": {"seconds": 0.1, "source": "grid"},
            good: {"policy": {"strategy": "segment", "block_nnz": 256,
                              "block_rows": 256, "gather_mode": "prefetch"},
                   "seconds": 0.01, "source": "grid", "tuned_at": 0},
        }}, f)
    c = AutotuneCache(path)
    assert c.lookup(good) == PhiPolicy(strategy="segment")
    assert c.quarantined["not-a-dict"]["reason"] == "malformed-entry"
    assert c.quarantined["no-policy"]["reason"] == "malformed-entry"
    c.store("fresh", PhiPolicy(), 0.1, "grid")
    assert "not-a-dict" in AutotuneCache(path).quarantined


@pytest.mark.parametrize("field,stale", [
    ("torch", "0.0.0-ancient"), ("cuda", "7.5"), ("device_kind", "Tesla K80"),
])
def test_stale_entries_serve_but_are_retuned(port_tensor, tmp_path, field,
                                             stale):
    """An entry tuned under another torch or CUDA version or on another
    card serves non-measuring tuners and is re-tuned by measuring ones."""
    mv, pi, b = _mode_problem(port_tensor)
    path = str(tmp_path / "cache.json")
    t0 = Autotuner(cache_path=path, iters=1, warmup=1, burst=2)
    pol = _tune(t0, mv, pi, b)
    key = _v2_key(mv)
    entry = t0.cache.entries[key]
    assert (entry["torch"], entry["cuda"], entry["device_kind"]) == (
        torch.__version__, torch.version.cuda, P_at.current_device_kind())
    entry[field] = stale
    t0.cache.save()
    assert AutotuneCache.entry_is_stale(AutotuneCache(path).entries[key])
    stale_ok = Autotuner(cache_path=path, measure=False)
    assert _tune(stale_ok, mv, pi, b) == pol and stale_ok.n_hits == 1
    retuner = Autotuner(cache_path=path, iters=1, warmup=1, burst=2)
    _tune(retuner, mv, pi, b)
    assert retuner.n_hits == 0 and retuner.n_grid_searches == 1
    assert retuner.cache.entries[key][field] != stale


# ---------------------------------------------------------------------------
# TTL / LRU bounds
# ---------------------------------------------------------------------------


def _fill(cache, n, prefix="k"):
    for i in range(n):
        cache.store(f"{prefix}{i}", PhiPolicy(strategy="segment"), 0.1,
                    "grid")


def test_lru_eviction_order_is_least_recently_served(tmp_path):
    path = str(tmp_path / "cache.json")
    c = AutotuneCache(path, max_entries=3)
    _fill(c, 3)
    assert c.lookup("k0") is not None and c.lookup("k2") is not None
    c.store("k3", PhiPolicy(), 0.1, "grid")
    assert sorted(c.entries) == ["k0", "k2", "k3"] and c.n_evicted == 1
    c2 = AutotuneCache(path, max_entries=2)
    c2.store("k4", PhiPolicy(), 0.1, "grid")
    assert len(c2.entries) == 2 and "k4" in c2.entries


def test_lru_unbounded_by_default_and_never_touches_quarantine(tmp_path):
    c = AutotuneCache(str(tmp_path / "a.json"))
    _fill(c, 50)
    assert len(c.entries) == 50 and c.n_evicted == 0
    path = str(tmp_path / "b.json")
    v1_key = policy_key(100, 10, 8, "cpu")
    _write_v1_store(path, v1_key, MARKER)
    c = AutotuneCache(path, max_entries=2)
    _fill(c, 5)
    assert len(c.entries) == 2
    assert c.quarantined[v1_key]["reason"] == "v1-schema"
    assert c.migrate_quarantined(v1_key, "v2-target") is not None
    assert len(c.entries) == 2 and "v2-target" in c.entries


def test_ttl_expires_old_entries_at_load(tmp_path):
    path = str(tmp_path / "cache.json")
    c = AutotuneCache(path)
    _fill(c, 3)
    c.entries["k0"]["tuned_at"] = time.time() - 30 * 86400
    c.entries["k1"].pop("tuned_at")
    c.save()
    fresh = AutotuneCache(path, max_age_days=7.0)
    assert sorted(fresh.entries) == ["k2"] and fresh.n_expired == 2
    assert len(AutotuneCache(path).entries) == 3


def test_cache_bounds_env_overrides(tmp_path, monkeypatch):
    path = str(tmp_path / "cache.json")
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_MAX_ENTRIES", "2")
    c = AutotuneCache(path)
    assert c.max_entries == 2
    _fill(c, 4)
    assert len(c.entries) == 2
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_MAX_ENTRIES", "not-a-number")
    assert AutotuneCache(path).max_entries is None
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE_MAX_ENTRIES")
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_MAX_AGE_DAYS", "1.5")
    assert AutotuneCache(path).max_age_days == 1.5
    with pytest.raises(ValueError, match="max_entries"):
        AutotuneCache(path, max_entries=0)
    with pytest.raises(ValueError, match="max_age_days"):
        AutotuneCache(path, max_age_days=-1)


def test_tuner_passes_cache_bounds_through(port_tensor, tmp_path):
    t, kt = port_tensor
    tuner = Autotuner(cache_path=str(tmp_path / "c.json"), measure=False,
                      cache_max_entries=2)
    for mode in range(3):
        _tune(tuner, *_mode_problem(port_tensor, mode))
    assert len(tuner.cache.entries) == 2 and tuner.cache.n_evicted == 1


# ---------------------------------------------------------------------------
# Probes, candidates and the measured search
# ---------------------------------------------------------------------------


def test_probe_failures_recorded_in_cache_entry(port_tensor, tmp_path,
                                                monkeypatch):
    mv, pi, b = _mode_problem(port_tensor)
    monkeypatch.setattr(
        Autotuner, "_time_policy",
        lambda self, pol, *a, **k: (_ for _ in ()).throw(
            ValueError(f"probe boom: {pol.label()}")))
    tuner = Autotuner(cache_path=str(tmp_path / "c.json"), iters=1, warmup=1)
    assert isinstance(_tune(tuner, mv, pi, b), PhiPolicy)
    (entry,) = tuner.cache.entries.values()
    assert entry["source"] == "heuristic" and entry["seconds"] is None
    assert len(entry["probe_errors"]) >= 2
    assert all("probe boom" in e for e in entry["probe_errors"])


@pytest.mark.parametrize("strategy", ["segment", "blocked", "cuda"])
def test_burst_probe_matches_iterated_mu_steps(port_tensor, strategy):
    """The probe's step, chained ``burst`` times, is the solver's fused
    MU step with ``tol=-1`` (the update always applied)."""
    mv, pi, b = _mode_problem(port_tensor)
    pol = PhiPolicy(strategy=strategy, block_nnz=64, block_rows=32)
    step, slots = Autotuner(measure=False).probe_step(pol, mv.rows,
                                                      mv.sorted_vals, pi,
                                                      mv.n_rows)
    layout = build_blocked_layout(mv.rows.numpy(), mv.n_rows, 64, 32)
    assert slots == (mv.nnz if strategy == "segment"
                     else layout.n_grid * layout.block_nnz)
    bb, got = b, b
    for _ in range(3):
        bb, viol = phi_mu_step(mv.rows, mv.sorted_vals, pi, bb, mv.n_rows,
                               tol=-1.0, strategy=strategy,
                               layout=None if strategy == "segment"
                               else layout, device="cpu")
        got, gviol = step(got)
    torch.testing.assert_close(got, bb, rtol=0, atol=0)
    assert float(gviol) == float(viol)


def test_step_burst_seconds_divides_by_burst():
    from repro_torch.perf.timing import step_burst_seconds

    calls = []

    def step(b):
        calls.append(1)
        return b, b.sum()

    sec = step_burst_seconds(step, torch.ones(2), burst=4, warmup=1, iters=1)
    assert sec >= 0.0 and len(calls) == 8  # one warm-up and one timed burst
    with pytest.raises(ValueError):
        step_burst_seconds(step, torch.ones(2), burst=0)


@pytest.mark.parametrize("platform", ("cpu", "cuda"))
def test_candidate_policies_mirror_the_references(platform):
    """The reference's neighbourhood, with a ``cuda`` point beside each
    ``blocked`` one where the reference puts a ``pallas`` point on a TPU."""
    budget = 4 * 2**20
    got = candidate_policies(10**6, 10**4, 32, platform, vmem_budget=budget)
    want = R_at.candidate_policies(10**6, 10**4, 32,
                                   "tpu" if platform == "cuda" else "cpu",
                                   vmem_budget=budget)
    rename = {"pallas": "cuda"}
    assert [(rename.get(p.strategy, p.strategy), p.block_nnz, p.block_rows)
            for p in got] == [(rename.get(p.strategy, p.strategy),
                               p.block_nnz, p.block_rows) for p in want]
    assert any(p.strategy == "cuda" for p in got) == (platform == "cuda")
    for p in got:
        if p.strategy in ("blocked", "cuda"):
            assert vmem_footprint_bytes(p, 32) <= budget


def test_model_words_rank_the_kernel_below_the_plain_paths():
    args = dict(nnz=10**5, slots=10**5, rank=16, n_modes=3, burst=8)
    words = {s: P_at.model_words(PhiPolicy(strategy=s), **args)[1]
             for s in ("cuda", "segment", "blocked")}
    assert words["cuda"] < words["segment"] < words["blocked"]
    padded = P_at.model_words(PhiPolicy(strategy="cuda"),
                              **dict(args, slots=2 * 10**5))[1]
    assert padded > words["cuda"]  # padding slots cost their traffic


def test_autotuner_measured_search_caches_winner(port_tensor, tmp_path):
    mv, pi, b = _mode_problem(port_tensor)
    tuner = Autotuner(cache_path=str(tmp_path / "cache.json"), iters=1,
                      warmup=1)
    pol = _tune(tuner, mv, pi, b)
    assert isinstance(pol, PhiPolicy) and tuner.n_grid_searches == 1
    entry = tuner.cache.entries[_v2_key(mv)]
    assert entry["source"] == "grid" and entry["probe"] == "burst"
    assert entry["burst"] == tuner.burst > 1
    assert entry["torch"] == torch.__version__
    assert entry["schema"] == AutotuneCache.VERSION
    # model-guided: three candidates (one per family) measured, the rest
    # pruned, and the winner's model and measured seconds recorded
    assert entry["probes"] == tuner.n_probes == 3
    assert entry["model_pruned"] == entry["n_candidates"] - 3
    assert entry["model_s"] > 0 and entry["measured_s"] == entry["seconds"]
    assert len(entry["probe_seconds"]) == 3
    assert _tune(tuner, mv, pi, b) == pol
    assert tuner.n_grid_searches == 1 and tuner.n_hits == 1


@pytest.mark.parametrize("platform", ("cpu", "cuda"))
def test_model_top_k_keeps_family_winners_except_on_the_card(
        port_tensor, tmp_path, platform):
    """Off the card each strategy family's model-best point keeps one of
    the three probes, as in the JAX package; on the card (the platform
    forced here on CPU tensors) the probes go to the model's three best
    points whatever their family."""
    mv, pi, b = _mode_problem(port_tensor)
    tuner = Autotuner(cache_path=str(tmp_path / "cache.json"), iters=1,
                      warmup=1, platform=platform, include_cuda=True)
    _tune(tuner, mv, pi, b)
    cands = candidate_policies(mv.nnz, mv.n_rows, RANK, platform,
                               include_cuda=True,
                               stats=mode_run_stats(mv.rows.numpy(),
                                                    mv.n_rows))
    scored, _, _ = tuner._model_rank(cands, mv.rows, mv.sorted_vals, pi, b,
                                     mv.n_rows, 3)
    want = model_top_k(scored, k=3, per_family=platform == "cpu")
    entry = next(iter(tuner.cache.entries.values()))
    assert set(entry["probe_seconds"]) == {p.label() for p, _ in want}
    assert tuner.n_probes == 3
    if platform == "cuda":
        assert want == sorted(scored, key=lambda x: x[1])[:3]


def test_autotuner_retunes_heuristic_placeholder(port_tensor, tmp_path):
    mv, pi, b = _mode_problem(port_tensor)
    path = str(tmp_path / "cache.json")
    key = _v2_key(mv)
    t1 = Autotuner(cache_path=path, measure=False)
    _tune(t1, mv, pi, b)
    assert t1.cache.entries[key]["source"] == "heuristic"
    _tune(t1, mv, pi, b)
    assert t1.n_hits == 1
    t2 = Autotuner(cache_path=path, iters=1, warmup=1)
    _tune(t2, mv, pi, b)
    assert t2.n_grid_searches == 1 and t2.n_hits == 0
    assert t2.cache.entries[key]["source"] == "grid"


def test_calibrated_model_serves_without_probes(port_tensor, tmp_path):
    """With enough (model, measured) pairs whose ratios agree, a key whose
    predicted top-2 margin beats the error bound (floored at 25%) is
    served model-only, with zero probes."""
    mv, pi, b = _mode_problem(port_tensor)
    tuner = Autotuner(cache_path=str(tmp_path / "c.json"), iters=1,
                      warmup=1, include_cuda=True)
    for i in range(3):
        tuner.cache.store(f"calib{i}", PhiPolicy(), 1.0, "grid",
                          extra={"model_s": 1e-3, "measured_s": 2e-3})
    est = tuner.cache.model_error_stats()
    assert est["n"] == 3 and est["median_ratio"] == pytest.approx(2.0)
    pol = _tune(tuner, mv, pi, b)
    entry = tuner.cache.entries[_v2_key(mv)]
    assert tuner.n_probes == 0 and tuner.n_model_served == 1
    assert entry["source"] == "model" and entry["probes"] == 0
    assert entry["model_margin"] > np.exp(1.25 * tuner.MODEL_MIN_LOG_ERR)
    assert pol.strategy == "cuda"  # the one-pass kernel, by the model


def test_dense_cut_is_served_from_the_heuristic(tmp_path):
    """A fill-keyed near-dense mode goes to the dense tier without
    probes, and the entry is cached under its fill key."""
    n_rows, width = 8, 16
    rows = np.repeat(np.arange(n_rows), 12).astype(np.int64)
    stats = mode_run_stats(rows, n_rows, row_width=width)
    tuner = Autotuner(cache_path=str(tmp_path / "c.json"), iters=1)
    t_rows = torch.as_tensor(rows)
    args = (t_rows, torch.ones(len(rows)), torch.ones(len(rows), RANK),
            torch.ones(n_rows, RANK))
    assert tuner.policy_for_mode(*args, n_rows=n_rows, rank=RANK,
                                 stats=stats).strategy == "dense"
    assert tuner.policy_for_mode(*args, n_rows=n_rows, rank=RANK,
                                 stats=stats).strategy == "dense"
    assert (tuner.n_searches, tuner.n_hits, tuner.n_probes) == (1, 1, 0)


# ---------------------------------------------------------------------------
# policy="auto" in both solvers, cutouts, poisoned entries
# ---------------------------------------------------------------------------


def test_cpapr_policy_auto_populates_then_hits_cache(port_tensor, tmp_path):
    t, kt = port_tensor
    path = str(tmp_path / "cache.json")
    t1 = Autotuner(cache_path=path, iters=1, warmup=1, burst=2)
    res1 = cpapr_mu(t, RANK, init=kt, device="cpu", config=CPAPRConfig(
        rank=RANK, max_outer=2, policy="auto", autotuner=t1))
    assert t1.n_searches == 3 and t1.n_hits == 0 and t1.n_probes > 0
    assert res1.policies is not None and len(res1.policies) == 3
    t2 = Autotuner(cache_path=path, iters=1, warmup=1, burst=2)
    res2 = cpapr_mu(t, RANK, init=kt, device="cpu", config=CPAPRConfig(
        rank=RANK, max_outer=2, policy="auto", autotuner=t2))
    assert t2.counters() == {"hits": 3, "searches": 0, "grid_searches": 0,
                             "migrated": 0, "probes": 0, "model_served": 0}
    assert [p.label() for p in res2.policies] == \
        [p.label() for p in res1.policies]
    assert res1.kkt_history == res2.kkt_history
    assert res1.recoveries is None and res2.recoveries is None


def test_cpapr_policy_auto_matches_reference(small_tensor, port_tensor,
                                            tmp_path):
    """Non-measuring tuners serve the heuristic's CPU pick in both
    packages: the same policies and the same solve within TOL."""
    from repro.core import CPAPRConfig as RConfig
    from repro.core import cpapr_mu as r_cpapr_mu

    from test_conformance import TOL

    t, kt = small_tensor
    want = r_cpapr_mu(t, RANK, init=kt, config=RConfig(
        rank=RANK, max_outer=3, policy="auto",
        autotuner=R_at.Autotuner(cache_path=str(tmp_path / "r.json"),
                                 measure=False)))
    pt, pkt = port_tensor
    got = cpapr_mu(pt, RANK, init=pkt, device="cpu", config=CPAPRConfig(
        rank=RANK, max_outer=3, policy="auto",
        autotuner=Autotuner(cache_path=str(tmp_path / "p.json"),
                            measure=False)))
    assert [p.label() for p in got.policies] == \
        [p.label() for p in want.policies]
    assert got.inner_iters == want.inner_iters
    np.testing.assert_allclose(got.loglik_history, want.loglik_history, **TOL)


def test_cutout_tunes_the_solvers_problem(port_tensor, tmp_path):
    t, kt = port_tensor
    cut = extract_mode_cutout(t, kt, 1)
    mv, pi, b = _mode_problem(port_tensor, 1)
    assert cut.nnz == mv.nnz and cut.n_modes == 3
    torch.testing.assert_close(cut.pi, pi, rtol=0, atol=0)
    torch.testing.assert_close(cut.b, b, rtol=0, atol=0)
    tuner = Autotuner(cache_path=str(tmp_path / "c.json"), measure=False)
    pol = tuner.policy_for_cutout(cut)
    assert _tune(tuner, mv, pi, b) == pol and tuner.n_hits == 1


def test_cp_als_policy_auto_fills_then_serves(port_tensor, tmp_path):
    t, kt = port_tensor
    path = str(tmp_path / "cache.json")
    t1 = Autotuner(cache_path=path, iters=1, warmup=1, burst=2)
    recs: list = []
    fits1 = P_cpals.cp_als(t, RANK, n_iters=3, init=kt, policy="auto",
                           autotuner=t1, recoveries=recs, device="cpu")[1]
    t2 = Autotuner(cache_path=path, iters=1, warmup=1, burst=2)
    fits2 = P_cpals.cp_als(t, RANK, n_iters=3, init=kt, policy="auto",
                           autotuner=t2, device="cpu")[1]
    assert t1.n_searches == 3 and t2.n_hits == 3 and t2.n_probes == 0
    assert fits1 == fits2 and recs == []


def test_poisoned_entry_demotes_in_cp_als(port_tensor, tmp_path):
    t, kt = port_tensor
    tuner = Autotuner(cache_path=str(tmp_path / "c.json"), measure=False)
    faults.poison_autotune(tuner, sort_mode(t, 2), RANK, shape=t.shape)
    recs: list = []
    fits = P_cpals.cp_als(t, RANK, n_iters=3, init=kt, policy="auto",
                          autotuner=tuner, recoveries=recs, device="cpu")[1]
    assert [(e.kind, e.mode, e.detail["action"]) for e in recs] == [
        ("demote_policy", 2, "warpspeed->segment")]
    assert all(np.isfinite(fits))


# ---------------------------------------------------------------------------
# The sharded key dimensions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_shards", (None, 1, 2, 4))
def test_sharded_policy_keys_equal_reference(n_shards):
    """Every combination of /shards=, /assign= and /combine= (and the v2
    stats prefix) is the reference's string; /grid= waits for ROADMAP
    A8b and raises."""
    from repro_torch.core.resilience import NotPortedError

    rows = np.repeat(np.arange(50, dtype=np.int32), 20)
    stats, rstats = mode_run_stats(rows, 50), r_mode_run_stats(rows, 50)
    frag = P_at.shard_assignment_fragment([0, 250, 500, 750, 1000])
    assert frag == R_at.shard_assignment_fragment([0, 250, 500, 750, 1000])
    assert frag != P_at.shard_assignment_fragment([0, 300, 500, 750, 1000])
    for st, rst in ((None, None), (stats, rstats)):
        for assign in (None, frag):
            for combine in (None, "psum", "reduce_scatter"):
                for grid in (None, (n_shards or 1, 1)):
                    kw = dict(n_shards=n_shards, assign=assign,
                              combine=combine, grid=grid)
                    assert policy_key(1000, 50, 8, "cuda", stats=st, **kw) \
                        == R_at.policy_key(1000, 50, 8, "cuda", stats=rst,
                                           **kw)
    with pytest.raises(NotPortedError, match="A8b"):
        policy_key(1000, 50, 8, "cuda", n_shards=4, grid=(2, 2))


@pytest.mark.parametrize("combine", (None, "reduce_scatter"))
def test_sharded_tuning_keys_equal_reference(small_tensor, tmp_path,
                                             port_tensor, combine):
    """The same mode tuned per shard by both packages' non-measuring
    tuners: the same key strings (the platform aside) and the same
    per-shard policies; a single-device entry is never shadowed."""
    t, kt = small_tensor
    from repro.core.pi import pi_rows as r_pi_rows
    from repro.core.sparse_tensor import sort_mode as r_sort_mode

    mv, pi, b = _mode_problem(port_tensor)
    rmv = r_sort_mode(t, 0)
    rpi = r_pi_rows(rmv.sorted_idx, kt.factors, 0)
    rb = kt.factors[0] * kt.lam[None, :]
    tuner = Autotuner(cache_path=str(tmp_path / "p.json"), measure=False,
                      platform="cpu")
    rtuner = R_at.Autotuner(cache_path=str(tmp_path / "r.json"),
                            measure=False, platform="cpu")
    single = tuner.policy_for_mode(mv.rows, mv.sorted_vals, pi, b,
                                   n_rows=mv.n_rows, rank=RANK)
    for cuts in (None, [0, mv.nnz // 3, mv.nnz]):
        got = tuner.policy_for_sharded_mode(
            mv.rows, mv.sorted_vals, pi, b, n_rows=mv.n_rows, rank=RANK,
            n_shards=2, cuts=cuts, combine=combine)
        want = rtuner.policy_for_sharded_mode(
            rmv.rows, rmv.sorted_vals, rpi, rb, n_rows=rmv.n_rows, rank=RANK,
            n_shards=2, cuts=cuts, combine=combine)
        assert [None if p is None else p.label() for p in got[1]] == \
            [None if p is None else p.label() for p in want[1]]
    sharded_keys = sorted(k for k in tuner.cache.entries if "/shards=" in k)
    assert sharded_keys == sorted(k for k in rtuner.cache.entries
                                  if "/shards=" in k)
    assert len(sharded_keys) == 4
    assert sum("/assign=" in k for k in sharded_keys) == 2
    assert all(("/combine=" in k) == (combine is not None)
               for k in sharded_keys)
    t2 = Autotuner(cache_path=str(tmp_path / "p.json"), measure=False,
                   platform="cpu")
    assert t2.policy_for_mode(mv.rows, mv.sorted_vals, pi, b,
                              n_rows=mv.n_rows, rank=RANK) == single
    with pytest.raises(ValueError, match="cuts"):
        tuner.policy_for_sharded_mode(mv.rows, mv.sorted_vals, pi, b,
                                      n_rows=mv.n_rows, rank=RANK, n_shards=2,
                                      cuts=[0, mv.nnz])
    with pytest.raises(ValueError, match="Pi rows"):
        Autotuner(cache_path=str(tmp_path / "m.json")).policy_for_sharded_mode(
            mv.rows, mv.sorted_vals, None, b, n_rows=mv.n_rows, rank=RANK,
            n_shards=2)


def test_sharded_tuning_handles_degenerate_splits(port_tensor, tmp_path):
    """All nonzeros in one row: later shards are empty (None) and the
    uniform policy comes from the one populated shard."""
    mv, pi, b = _mode_problem(port_tensor)
    rows = torch.zeros(mv.nnz, dtype=mv.rows.dtype)
    tuner = Autotuner(cache_path=str(tmp_path / "c.json"), measure=False)
    uniform, per_shard = tuner.policy_for_sharded_mode(
        rows, mv.sorted_vals, pi, b, n_rows=mv.n_rows, rank=RANK, n_shards=3)
    assert per_shard[0] is not None
    assert per_shard[1] is None and per_shard[2] is None
    assert uniform == per_shard[0]


def test_rebalance_threads_assignment_through_autotune_keys(tmp_path):
    """With policy='auto' and a non-measuring tuner, a boundary move
    re-keys the shard sub-problems under /assign= cache keys, as in the
    reference (its tuner on platform "tpu", the port's on "cuda": both
    heuristics then pick a blocked policy, which has shards to move)."""
    from repro_torch.core.sparse_tensor import SparseTensor

    sparse = np.repeat(np.arange(20) * 8, 2)
    dense = np.repeat(160 + np.arange(4) * 8, 320)
    rows = np.sort(np.concatenate([sparse, dense])).astype(np.int64)
    rng = np.random.default_rng(0)
    idx = np.stack([rows, rng.integers(0, 30, rows.size),
                    rng.integers(0, 25, rows.size)], 1)
    t = SparseTensor(shape=(192, 30, 25), indices=torch.as_tensor(idx),
                     values=torch.ones(rows.size))
    tuner = Autotuner(cache_path=str(tmp_path / "c.json"), measure=False,
                      platform="cuda")
    res = cpapr_mu(t, 3, device="cpu", config=CPAPRConfig(
        rank=3, max_outer=2, max_inner=2, strategy="sharded", n_shards=2,
        policy="auto", autotuner=tuner, track_loglik=False,
        rebalance_every=1))
    moved = [ev for ev in res.rebalances or [] if ev["mode"] == 0]
    assert moved, "skewed mode 0 should rebalance"
    assert any("/assign=" in k for k in tuner.cache.entries)
