"""Online, persistent parallel-policy autotuner for the Φ kernels.

The single-device parts of the JAX package's ``repro.perf.autotune``:

  * :class:`Autotuner` keys each tuning problem on ``(platform, nnz,
    n_rows, rank)`` plus the mode's binned segment-run statistics
    (:func:`repro_torch.core.layout.mode_run_stats`), so a hub-dominated
    and a uniform mode of the same size get distinct cache entries.
  * On a cache miss it measures a pruned policy grid
    (:func:`candidate_policies`: the unblocked strategies and the
    heuristic's blocked neighbourhood, with ``cuda`` points on the card).
    The probe is a **burst** of ``burst`` fused MU steps with ``tol=-1``,
    the loop shape ``cpapr_mu`` runs.  On the card the burst is captured
    once in a CUDA graph and its replays are timed with CUDA events
    (:func:`repro_torch.perf.timing.step_burst_seconds`), so the host's
    time per wrapper call does not rank the blockings; on the CPU the
    plain loop is timed.
  * **Model-guided probe pruning** (``model_guided=True``): every
    candidate is scored with the 3-term roofline
    (:func:`repro_torch.perf.roofline.roofline_terms`) from analytic
    counts: :func:`repro_torch.core.phi.phi_flops_words` over the
    candidate layout's slot count (padding included), times the passes
    over the per-nonzero rows its implementation makes, plus the hoisted
    Π gather (:func:`repro_torch.core.pi.pi_rows_flops_words`).  The JAX
    package costs compiled XLA HLO instead; the port has no HLO.  Only
    the model's top-K (:func:`repro_torch.core.policy.model_top_k`;
    family winners keep a slot, except on the card, where the model's
    ranking across families is too far off to spend probes on) are
    measured; once the
    store holds enough (model, measured) pairs, a key whose predicted
    top-2 margin beats the calibrated error bound (never below
    :attr:`Autotuner.MODEL_MIN_LOG_ERR`) is served model-only with zero
    probes.
  * When measurement is disabled or every probe fails it falls back to a
    migrated v1 winner or :func:`repro_torch.core.policy.heuristic_policy`;
    probe failures (a :data:`repro_torch.core.policy.SEARCH_ERRORS`
    member) are recorded in the entry's ``probe_errors`` and never end
    the tune.
  * Winners persist in a JSON store (:class:`AutotuneCache`, schema v2:
    crc-stamped, quarantine, v1 migration, LRU and TTL bounds, atomic
    writes), so repeat decompositions, in future processes too, pay no
    search.

The store is the port's own file: ``$REPRO_TORCH_AUTOTUNE_CACHE`` if set,
else ``~/.cache/repro_torch/autotune.json``.  It never reads or writes
the JAX package's store.  Its staleness metadata is the torch and CUDA
versions and the card's name (:func:`current_device_kind`).  A sharded
mode is tuned per shard (:meth:`Autotuner.policy_for_sharded_mode`) under
keys with the JAX package's ``/shards=``, ``/assign=``
(:func:`shard_assignment_fragment`), ``/combine=`` and, for a grid
mode's row shards, ``/grid=AxB`` dimensions.

``CPAPRConfig(policy="auto")`` and ``cp_als(policy="auto")`` consult
this per mode (see :mod:`repro_torch.core.cpapr`).
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time
import zlib

import numpy as np
import torch

from ..core.convert import policy_from_dict
from ..core.layout import ModeStats, build_blocked_layout, mode_run_stats
from ..core.phi import expand_to_layout, phi_flops_words, phi_mu_step
from ..core.pi import pi_rows_flops_words
from ..core.policy import (
    SEARCH_ERRORS,
    PhiPolicy,
    grid_search,
    heuristic_policy,
    model_ambiguous_prefix,
    model_top_k,
    vmem_footprint_bytes,
)

__all__ = [
    "AutotuneCache",
    "Autotuner",
    "candidate_policies",
    "current_device_kind",
    "default_cache_path",
    "policy_key",
    "shard_assignment_fragment",
]

_ENV_PREFIX = "REPRO_TORCH_AUTOTUNE_"


def default_cache_path() -> str:
    env = os.environ.get(_ENV_PREFIX + "CACHE")
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                        "autotune.json")


def current_device_kind() -> str:
    """The card's name (``torch.cuda.get_device_name()``), or ``"cpu"``
    without one: staleness metadata."""
    try:
        if torch.cuda.is_available():
            return str(torch.cuda.get_device_name())
    except Exception:  # pragma: no cover - driver trouble
        return "unknown"
    return "cpu"


def _stamp() -> dict:
    """The staleness metadata every entry carries."""
    return {"torch": torch.__version__, "cuda": torch.version.cuda,
            "device_kind": current_device_kind()}


def _platform_of(t) -> str:
    return "cuda" if isinstance(t, torch.Tensor) and t.device.type == "cuda" \
        else "cpu"


def policy_key(nnz: int, n_rows: int, rank: int, platform: str,
               n_shards: int = 1, stats: ModeStats | None = None,
               assign: str | None = None, combine: str | None = None,
               grid: "tuple | None" = None) -> str:
    """Cache key for one tuning problem, equal to the JAX package's string.

    With ``stats`` the key is the v2 format: a ``v2/`` prefix plus the
    binned segment-run dimensions, so equal-size modes with different
    nonzero distributions resolve to distinct entries.  Without ``stats``
    the legacy v1 format comes back (migration bookkeeping).  ``platform``
    is ``"cuda"`` or ``"cpu"``.  ``n_shards`` > 1 appends ``/shards=N``,
    ``assign`` (a :func:`shard_assignment_fragment`) ``/assign=...`` (a
    rebalanced assignment is a different problem), and a non-default
    ``combine`` (``"reduce_scatter"``) ``/combine=...``.  A ``grid``
    (an ``(A, B)`` device-grid shape) with ``B > 1`` appends
    ``/grid=AxB``: a grid cell revisits rows that the 1-D shard of the
    same size never splits, so grid and 1-D winners stay apart (``B ==
    1`` *is* the 1-D split and keeps its keyspace).
    """
    base = f"{platform}/nnz={nnz}/rows={n_rows}/rank={rank}"
    if stats is not None:
        base = f"v2/{base}/{stats.key_fragment()}"
    if n_shards in (None, 1):
        return base
    key = f"{base}/shards={n_shards}"
    if assign is not None:
        key = f"{key}/assign={assign}"
    if combine not in (None, "psum"):
        key = f"{key}/combine={combine}"
    if grid is not None and int(grid[1]) > 1:
        key = f"{key}/grid={int(grid[0])}x{int(grid[1])}"
    return key


def shard_assignment_fragment(cuts) -> str:
    """Short stable signature of a shard assignment's stream cuts (crc32
    of the cut positions), so a rebalanced assignment re-keys the same
    way in every future run."""
    arr = np.asarray(list(cuts), np.int64)
    return format(zlib.crc32(arr.tobytes()) & 0xFFFFFFFF, "08x")


def _policy_to_json(p: PhiPolicy) -> dict:
    return dataclasses.asdict(p)


def _stats_to_json(stats: ModeStats | None) -> dict | None:
    if stats is None:
        return None
    out = {
        "p95_run": stats.p95_run,
        "max_run": stats.max_run,
        "dup_share": round(stats.dup_share, 6),
        "empty_frac": round(stats.empty_frac, 6),
    }
    if getattr(stats, "fill_bin", -1) >= 0:
        out["fill_frac"] = round(stats.fill_frac, 6)
        out["fill_bin"] = int(stats.fill_bin)
    return out


def _env_number(name: str, kind):
    raw = os.environ.get(_ENV_PREFIX + name)
    if not raw:
        return None
    try:
        return kind(raw)
    except ValueError:
        return None


class AutotuneCache:
    """Persistent JSON store of tuned policies (schema v2).

    ``entries`` maps :func:`policy_key` strings to tuned-policy records;
    ``quarantined`` holds entries that could not be served (v1-schema
    records awaiting migration, malformed v2 records) with the reason.
    Corrupt or missing *files* load as empty; every write is atomic (tmp
    + ``os.replace``) and crc-stamped (crc32 over the canonical body dump,
    verified at load), so concurrent writers at worst lose a race, never
    the file.

    Two optional bounds: ``max_entries`` (LRU on ``served_at``, falling
    back to ``tuned_at``; quarantined records neither count nor get
    evicted) and ``max_age_days`` (TTL on ``tuned_at``, applied at load).
    Defaults come from ``$REPRO_TORCH_AUTOTUNE_MAX_ENTRIES`` /
    ``$REPRO_TORCH_AUTOTUNE_MAX_AGE_DAYS``; unset means unbounded.
    """

    VERSION = 2

    @staticmethod
    def _body_crc(body: dict) -> str:
        blob = json.dumps(body, sort_keys=True, separators=(",", ":"))
        return format(zlib.crc32(blob.encode()) & 0xFFFFFFFF, "08x")

    def __init__(self, path: str | None = None,
                 max_entries: int | None = None,
                 max_age_days: float | None = None):
        self.path = path or default_cache_path()
        if max_entries is None:
            max_entries = _env_number("MAX_ENTRIES", int)
        if max_age_days is None:
            max_age_days = _env_number("MAX_AGE_DAYS", float)
        if max_entries is not None and max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        if max_age_days is not None and max_age_days <= 0:
            raise ValueError(f"max_age_days must be > 0, got {max_age_days}")
        self.max_entries = max_entries
        self.max_age_days = max_age_days
        self.n_expired = 0  # TTL drops at the last load
        self.n_evicted = 0  # LRU drops over this instance's lifetime
        self.n_crc_failures = 0  # stores rejected by the crc stamp
        self.entries: dict = {}
        self.quarantined: dict = {}
        self.load()

    # -- persistence ------------------------------------------------------
    def load(self) -> None:
        self.entries, self.quarantined = {}, {}
        self.n_expired = 0
        try:
            with open(self.path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            return
        if not isinstance(data, dict):
            return
        crc = data.get("crc32")
        if isinstance(crc, str):
            body = {k: data[k] for k in ("entries", "quarantined")
                    if k in data}
            if self._body_crc(body) != crc:
                self.n_crc_failures += 1
                return
        version = data.get("version")
        raw_q = data.get("quarantined")
        if isinstance(raw_q, dict):
            self.quarantined = dict(raw_q)
        raw = data.get("entries")
        if not isinstance(raw, dict):
            return
        if version == 1:
            # nothing of a v1 store is served directly: every entry waits
            # for its problem's migration (Autotuner._tune_key)
            for key, entry in raw.items():
                self.quarantined[key] = {"entry": entry, "reason": "v1-schema"}
            return
        if version != self.VERSION:
            return
        cutoff = (time.time() - self.max_age_days * 86400.0
                  if self.max_age_days is not None else None)
        for key, entry in raw.items():
            if isinstance(entry, dict) and isinstance(entry.get("policy"),
                                                      dict):
                if cutoff is not None and (
                    not isinstance(entry.get("tuned_at"), (int, float))
                    or entry["tuned_at"] < cutoff
                ):
                    self.n_expired += 1
                    continue
                self.entries[key] = entry
            else:
                self.quarantined[key] = {"entry": entry,
                                         "reason": "malformed-entry"}
        self._evict_lru()

    def _evict_lru(self) -> None:
        """Drop least-recently-served entries beyond ``max_entries``."""
        if self.max_entries is None:
            return

        def recency(item):
            key, e = item
            return (e.get("served_at") or e.get("tuned_at") or 0.0, key)

        while len(self.entries) > self.max_entries:
            victim = min(self.entries.items(), key=recency)[0]
            del self.entries[victim]
            self.n_evicted += 1

    def save(self) -> None:
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        body: dict = {"entries": self.entries}
        if self.quarantined:
            body["quarantined"] = self.quarantined
        payload = {"version": self.VERSION, "crc32": self._body_crc(body),
                   **body}
        fd, tmp = tempfile.mkstemp(dir=d or ".", suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    # -- staleness --------------------------------------------------------
    @staticmethod
    def entry_is_stale(entry: dict) -> bool:
        """True when the entry was tuned under another schema, torch or
        CUDA version, or card than the current process's."""
        if entry.get("schema") != AutotuneCache.VERSION:
            return True
        return any(entry.get(k) != v for k, v in _stamp().items())

    # -- lookup / store ---------------------------------------------------
    def lookup(self, key: str, source: "str | tuple | None" = None,
               fresh: bool = False) -> PhiPolicy | None:
        """Cached policy for ``key``.

        ``source`` (one name or a tuple) accepts only entries tuned that
        way (e.g. ``("grid", "model")``), so heuristic placeholders are
        re-tuned once measurement is available; ``fresh=True`` skips
        stale entries too (a measuring tuner re-tunes them).
        """
        e = self.entries.get(key)
        if e is None:
            return None
        if source is not None:
            accept = (source,) if isinstance(source, str) else tuple(source)
            if e.get("source") not in accept:
                return None
        if fresh and self.entry_is_stale(e):
            return None
        try:
            pol = policy_from_dict(e["policy"])
        except (KeyError, TypeError):
            return None
        e["served_at"] = time.time()  # LRU recency (persisted on next save)
        return pol

    def store(self, key: str, policy: PhiPolicy, seconds: float, source: str,
              stats: ModeStats | None = None, probe: str | None = None,
              burst: int | None = None, probe_errors: list | None = None,
              extra: dict | None = None) -> None:
        entry = {
            "policy": _policy_to_json(policy),
            # inf (heuristic fallback: nothing measured) is not valid JSON
            "seconds": seconds if np.isfinite(seconds) else None,
            "source": source,
            "tuned_at": time.time(),
            "schema": self.VERSION,
            **_stamp(),
        }
        if stats is not None:
            entry["stats"] = _stats_to_json(stats)
        if probe is not None:
            entry["probe"] = probe
            entry["burst"] = burst
        if probe_errors:
            entry["probe_errors"] = probe_errors
        if extra:
            entry.update(extra)
        self.entries[key] = entry
        self._evict_lru()
        self.save()

    # -- model calibration ------------------------------------------------
    def model_error_stats(self, device_kind: str | None = None) -> dict:
        """Trailing model-vs-measured error over this store's entries of
        one card (``n == 0``: no calibration data yet).

        With ``r = measured_s / model_s`` per probed model-guided entry,
        the median of ``r`` is the scale bias and ``|ln(r / median_r)|``
        the dispersion that limits the model's ranking; ``rel_err_*`` are
        the raw ``|r - 1|`` percentiles.
        """
        if device_kind is None:
            device_kind = current_device_kind()
        ratios = []
        for e in self.entries.values():
            if e.get("device_kind") != device_kind:
                continue
            m, s = e.get("model_s"), e.get("measured_s")
            if (isinstance(m, (int, float)) and isinstance(s, (int, float))
                    and np.isfinite(m) and np.isfinite(s) and m > 0
                    and s > 0):
                ratios.append(s / m)
        if not ratios:
            return {"n": 0, "median_ratio": None, "p50_log_err": None,
                    "p95_log_err": None, "rel_err_p50": None,
                    "rel_err_p95": None}
        r = np.asarray(ratios, np.float64)
        med = float(np.median(r))
        log_err = np.abs(np.log(r / med))
        rel = np.abs(r - 1.0)
        return {
            "n": int(r.size),
            "median_ratio": med,
            "p50_log_err": float(np.percentile(log_err, 50)),
            "p95_log_err": float(np.percentile(log_err, 95)),
            "rel_err_p50": float(np.percentile(rel, 50)),
            "rel_err_p95": float(np.percentile(rel, 95)),
        }

    # -- v1 migration -----------------------------------------------------
    def quarantined_policy(self, key: str) -> PhiPolicy | None:
        """Policy of a quarantined entry (v1 or corrupt), if parseable."""
        q = self.quarantined.get(key)
        if not isinstance(q, dict):
            return None
        entry = q.get("entry")
        if not isinstance(entry, dict):
            return None
        try:
            return policy_from_dict(entry["policy"])
        except (KeyError, TypeError):
            return None

    def migrate_quarantined(self, old_key: str,
                            new_key: str) -> PhiPolicy | None:
        """Adopt a quarantined v1 winner under its v2 key.

        Stored with ``source="migrated-v1"`` and its v1 provenance (no
        current staleness stamp is forged): a measuring tuner still
        re-tunes it, a non-measuring one serves it.  The quarantined
        record stays as an audit trail.
        """
        pol = self.quarantined_policy(old_key)
        if pol is None:
            return None
        old = self.quarantined[old_key]["entry"]
        self.entries[new_key] = {
            "policy": _policy_to_json(pol),
            "seconds": old.get("seconds") if isinstance(old, dict) else None,
            "source": "migrated-v1",
            "tuned_at": time.time(),
            "schema": 1,  # honest provenance: fresh lookups skip it
            "torch": old.get("torch") if isinstance(old, dict) else None,
            "device_kind": None,
            "migrated_from": old_key,
        }
        self._evict_lru()
        self.save()
        return pol


def candidate_policies(nnz: int, n_rows: int, rank: int, platform: str,
                       vmem_budget: int = 8 * 2**20,
                       include_cuda: bool | None = None,
                       stats: ModeStats | None = None) -> list:
    """Pruned search grid: the unblocked strategies plus the heuristic's
    blocked neighbourhood (block sizes at 0.5x/1x/2x), feasible points
    only.

    Centred as the JAX package centres it (its TPU sizing of
    :func:`heuristic_policy`, re-centred by ``stats``), with a ``cuda``
    point beside each ``blocked`` one where the JAX package offers a
    ``pallas`` point on a TPU: on ``platform="cuda"`` by default.
    """
    if include_cuda is None:
        include_cuda = platform == "cuda"
    cands = [PhiPolicy(strategy="segment"), PhiPolicy(strategy="scatter")]
    base = heuristic_policy(nnz, n_rows, rank, vmem_budget=vmem_budget,
                            platform="tpu", stats=stats)
    seen = set()
    for bn_mul in (0.5, 1.0, 2.0):
        for br_mul in (0.5, 1.0, 2.0):
            bn = int(np.clip(base.block_nnz * bn_mul, 64, 2048))
            br = int(np.clip(base.block_rows * br_mul, 8, 1024))
            if (bn, br) in seen:
                continue
            seen.add((bn, br))
            p = PhiPolicy(strategy="blocked", block_nnz=bn, block_rows=br)
            if vmem_footprint_bytes(p, rank) <= vmem_budget:
                cands.append(p)
                if include_cuda:
                    cands.append(dataclasses.replace(p, strategy="cuda"))
    return cands


# Passes over the (slots, R) per-nonzero rows one fused MU step makes, by
# implementation: the kernel reads its rows once (phi_flops_words' count);
# the plain index_add_ path materializes the B-row gather, the product,
# the weighted rows and the scatter's read (8 passes); the blocked
# emulation adds its per-step partial window and cross-step combine.
_ROW_PASSES = {"cuda": 1.0, "segment": 8.0 / 5.0, "scatter": 8.0 / 5.0,
               "blocked": 10.0 / 5.0}


def model_words(pol: PhiPolicy, nnz: int, slots: int, rank: int,
                n_modes: int, burst: int) -> tuple:
    """Analytic ``(flops, words)`` of one probe: ``burst`` fused MU steps
    over ``slots`` nonzero slots (the layout's, padding included; ``nnz``
    for the unblocked strategies) and the hoisted Π gather once."""
    w, q = phi_flops_words(slots, rank)
    pw, pq = pi_rows_flops_words(nnz, rank, n_modes)
    passes = _ROW_PASSES.get(pol.strategy, _ROW_PASSES["blocked"])
    return burst * w + pw, burst * q * passes + pq


class Autotuner:
    """Measure-once, cache-forever policy selection.

    Counters: ``n_hits`` (lookups served from the cache), ``n_searches``
    (misses that triggered a tune), ``n_grid_searches`` (misses that ran
    timed probes), ``n_migrated`` (misses resolved by a quarantined v1
    winner), ``n_probes`` (timed probes) and ``n_model_served`` (misses
    answered by the model alone).

    Model-guided knobs (measuring tuners only): ``model_guided``,
    ``model_top_k`` (family winners always keep a slot),
    ``model_min_samples`` ((model, measured) pairs needed before
    model-only serving) and ``model_margin_factor`` (calibrated p95
    log-errors the predicted top-2 margin must exceed).
    """

    #: never trust the model to separate candidates closer than 25%
    MODEL_MIN_LOG_ERR = float(np.log(1.25))

    def __init__(self, cache_path: str | None = None, measure: bool = True,
                 iters: int = 2, warmup: int = 1, burst: int = 8,
                 vmem_budget: int = 8 * 2**20, platform: str | None = None,
                 include_cuda: bool | None = None,
                 cache_max_entries: int | None = None,
                 cache_max_age_days: float | None = None,
                 model_guided: bool = True, model_top_k: int = 3,
                 model_min_samples: int = 3,
                 model_margin_factor: float = 1.25):
        self.cache = AutotuneCache(cache_path, max_entries=cache_max_entries,
                                   max_age_days=cache_max_age_days)
        self.measure = measure
        self.iters = iters
        self.warmup = warmup
        self.burst = int(burst)
        if self.burst < 1:
            raise ValueError(f"burst must be >= 1, got {burst}")
        self.vmem_budget = vmem_budget
        self.platform = platform
        self.include_cuda = include_cuda
        self.model_guided = model_guided
        self.model_top_k = int(model_top_k)
        if self.model_top_k < 1:
            raise ValueError(f"model_top_k must be >= 1, got {model_top_k}")
        self.model_min_samples = int(model_min_samples)
        self.model_margin_factor = float(model_margin_factor)
        self.n_hits = 0
        self.n_searches = 0
        self.n_grid_searches = 0
        self.n_migrated = 0
        self.n_probes = 0
        self.n_model_served = 0

    def counters(self) -> dict:
        """Lookup/search/probe counters as a plain dict."""
        return {
            "hits": self.n_hits,
            "searches": self.n_searches,
            "grid_searches": self.n_grid_searches,
            "migrated": self.n_migrated,
            "probes": self.n_probes,
            "model_served": self.n_model_served,
        }

    def hardware_spec(self, platform: str):
        """The roofline HardwareSpec the model scores against: the card's
        for ``"cuda"``; on the CPU the paper's CPU system stands in (the
        model's scale is calibrated away, only its ranking is read)."""
        from .roofline import HARDWARE, detect_hardware_spec

        if platform == "cpu":
            return HARDWARE["e5_2690v4_dual"]
        return detect_hardware_spec(platform)

    # -- measurement ------------------------------------------------------
    def probe_step(self, pol: PhiPolicy, rows, vals, pi, n_rows: int):
        """``(step, slots)``: one fused MU step ``b -> (b', viol)`` with
        ``tol=-1`` under ``pol`` (the update always applies, so B evolves
        across the burst), its layout built and Π expanded once, as the
        solver hoists them; ``slots`` the nonzero slots it walks."""
        layout = vals_e = pi_e = None
        slots = int(rows.shape[0])
        if pol.strategy in ("blocked", "cuda"):
            layout = build_blocked_layout(rows.detach().cpu().numpy(),
                                          n_rows, pol.block_nnz,
                                          pol.block_rows)
            vals_e, pi_e = expand_to_layout(layout, vals, pi)
            slots = layout.n_grid * layout.block_nnz

        def step(bb):
            return phi_mu_step(rows, vals, pi, bb, n_rows=n_rows, tol=-1.0,
                               strategy=pol.strategy, layout=layout,
                               vals_e=vals_e, pi_e=pi_e, device=bb.device)

        return step, slots

    def burst_seconds(self, step, b) -> float:
        """Median seconds per step of one probe burst (CUDA graph on the
        card, host clock on the CPU)."""
        from .timing import step_burst_seconds

        return step_burst_seconds(step, b, self.burst, warmup=self.warmup,
                                  iters=self.iters)

    def _model_score(self, pol: PhiPolicy, rows, vals, pi, b, n_rows: int,
                     n_modes: int):
        """``(model_s, runner)``: the roofline estimate of one probe under
        ``pol`` from analytic counts (:func:`model_words`), and a zero-arg
        callable that times it on the layout already built here."""
        from .roofline import roofline_terms

        step, slots = self.probe_step(pol, rows, vals, pi, n_rows)
        rank = int(pi.shape[1])
        flops, words = model_words(pol, int(rows.shape[0]), slots, rank,
                                   n_modes, self.burst)
        hw = self.hardware_spec(_platform_of(pi))
        terms = roofline_terms(flops, words * pi.element_size(), 0.0,
                               n_chips=1, hw=hw)
        model_s = terms.bound_s
        if not (np.isfinite(model_s) and model_s > 0):
            raise ValueError(f"empty cost model for {pol.label()}: "
                             f"flops={flops} words={words}")

        def runner():
            return self.burst_seconds(step, b)

        return model_s, runner

    def _time_policy(self, pol: PhiPolicy, rows, vals, pi, b, n_rows: int,
                     runner=None) -> float:
        """Median seconds per fused MU step under ``pol`` (one burst
        probe); ``runner`` reuses a layout the model score already
        built."""
        self.n_probes += 1
        if runner is not None:
            return runner()
        step, _ = self.probe_step(pol, rows, vals, pi, n_rows)
        return self.burst_seconds(step, b)

    def _model_rank(self, cands, rows, vals, pi, b, n_rows: int,
                    n_modes: int):
        """Score every candidate: ``(scored, runners, errors)`` with
        ``scored`` fastest-predicted-first; an empty ``scored`` sends the
        caller to the full measured grid."""
        scored, runners, errors = [], {}, []
        for p in cands:
            try:
                s, runner = self._model_score(p, rows, vals, pi, b, n_rows,
                                              n_modes)
            except SEARCH_ERRORS as e:
                errors.append(f"{p.label()}: model: {type(e).__name__}: {e}")
                continue
            scored.append((p, s))
            runners[p.label()] = runner
        scored.sort(key=lambda x: x[1])
        return scored, runners, errors

    def _model_serve_or_prune(self, key, scored, stats, n_cands: int,
                              platform: str):
        """A :class:`PhiPolicy` when the model alone may serve ``key`` (its
        top-2 margin beats the calibrated bound; stored with
        ``source="model"`` and zero probes), else the ambiguous prefix of
        its top-K: the only candidates worth timing.

        As in the JAX package, each strategy family's model-best point
        keeps a slot in the top-K, except on the card: there the model's
        ranking across families is its weakest part (it puts the plain
        strategies ~1.6-2x behind the kernel, where they measure 25-60x
        behind), so the probes go to the model's best points whatever
        their family, which in practice is the ``cuda`` neighbourhood."""
        top = model_top_k(scored, k=self.model_top_k,
                          per_family=platform != "cuda")
        est = self.cache.model_error_stats()
        if est["n"] < self.model_min_samples or len(top) < 2:
            return top
        log_err = max(est["p95_log_err"], self.MODEL_MIN_LOG_ERR)
        bound = float(np.exp(self.model_margin_factor * log_err))
        prefix = model_ambiguous_prefix(top, bound, cap=self.model_top_k)
        if len(prefix) > 1:
            return prefix
        pol, model_s = prefix[0]
        self.n_model_served += 1
        self.cache.store(key, pol, float("inf"), "model", stats=stats,
                         extra={"model_s": model_s, "probes": 0,
                                "n_candidates": n_cands,
                                "model_margin": top[1][1] / model_s,
                                "model_error_bound": bound,
                                "calibration_n": est["n"]})
        return pol

    def _tune_key(self, key: str, rows, vals, pi, b, n_rows: int, rank: int,
                  platform: str, stats: ModeStats | None = None,
                  v1_key: str | None = None, n_modes: int = 3) -> PhiPolicy:
        """Cache-or-tune one problem under an explicit cache key
        (``v1_key``: the legacy key whose quarantined winner is migrated
        when nothing is measured)."""
        nnz = int(rows.shape[0])
        # a heuristic placeholder, a stale entry or a migrated-v1 policy
        # does not satisfy a measuring tuner; a model-served entry does
        hit = (self.cache.lookup(key, source=("grid", "model"), fresh=True)
               if self.measure else self.cache.lookup(key))
        if hit is not None:
            self.n_hits += 1
            return hit

        migrated = (self.cache.quarantined_policy(v1_key)
                    if v1_key is not None else None)
        self.n_searches += 1
        best_p, best_s, source = None, float("inf"), "heuristic"
        probe = ("burst" if self.burst > 1 else "single") if self.measure \
            else None
        probe_errors: list = []
        extra: dict = {}
        if self.measure:
            cands = candidate_policies(nnz, n_rows, rank, platform,
                                       vmem_budget=self.vmem_budget,
                                       include_cuda=self.include_cuda,
                                       stats=stats)
            to_measure, runners, scored = cands, {}, None
            extra = {"probes": len(cands), "n_candidates": len(cands)}
            if self.model_guided:
                scored, runners, model_errors = self._model_rank(
                    cands, rows, vals, pi, b, n_rows, n_modes)
                probe_errors += model_errors
                if scored:
                    served = self._model_serve_or_prune(key, scored, stats,
                                                        len(cands), platform)
                    if isinstance(served, PhiPolicy):
                        return served
                    to_measure = [p for p, _ in served]
                    extra = {"probes": len(to_measure),
                             "n_candidates": len(cands),
                             "model_pruned": len(cands) - len(to_measure)}
            self.n_grid_searches += 1
            ranked = grid_search(
                lambda p: self._time_policy(p, rows, vals, pi, b, n_rows,
                                            runner=runners.get(p.label())),
                to_measure)
            probe_errors += [f"{p.label()}: {err}"
                             for p, _, err in ranked if err is not None]
            if ranked and np.isfinite(ranked[0][1]):
                best_p, best_s, _ = ranked[0]
                source = "grid"
                extra["probe_seconds"] = {p.label(): s for p, s, err in ranked
                                          if err is None}
                if scored:
                    ms = {p.label(): s for p, s in scored}.get(best_p.label())
                    if ms is not None:
                        extra["model_s"] = ms
                        extra["measured_s"] = best_s
        if best_p is None and migrated is not None:
            self.n_migrated += 1
            pol = self.cache.migrate_quarantined(v1_key, key)
            if pol is not None:
                if probe_errors:
                    self.cache.entries[key]["probe_errors"] = probe_errors
                    self.cache.save()
                return pol
        if best_p is None:
            best_p = heuristic_policy(nnz, n_rows, rank,
                                      vmem_budget=self.vmem_budget,
                                      platform=platform, stats=stats)
        self.cache.store(key, best_p, best_s, source, stats=stats,
                         probe=probe,
                         burst=self.burst if probe is not None else None,
                         probe_errors=probe_errors, extra=extra)
        return best_p

    # -- public API -------------------------------------------------------
    def mode_key(self, rows, n_rows: int, rank: int,
                 stats: ModeStats | None = None) -> tuple:
        """(v2 cache key, ModeStats) for one mode's problem: what
        :meth:`policy_for_mode` keys on."""
        platform = self.platform or _platform_of(rows)
        if stats is None:
            stats = mode_run_stats(_host(rows), n_rows)
        key = policy_key(int(rows.shape[0]), n_rows, rank, platform,
                         stats=stats)
        return key, stats

    def policy_for_mode(self, rows, vals, pi, b, n_rows: int, rank: int,
                        stats: ModeStats | None = None,
                        n_modes: int = 3) -> PhiPolicy:
        """Tuned policy for one mode's Φ problem (cached by problem key).

        ``stats`` (the mode's :class:`ModeStats`) folds the segment-run
        distribution into the key; ``n_modes`` (the tensor's order) sizes
        the model's Π-gather term.  A fill-keyed mode the heuristic sends
        to the dense tier is served from the heuristic (the probe has no
        densified tensor to time) and cached.
        """
        platform = self.platform or _platform_of(rows)
        if stats is None:
            stats = mode_run_stats(_host(rows), n_rows)
        nnz = int(rows.shape[0])
        key = policy_key(nnz, n_rows, rank, platform, stats=stats)
        v1_key = policy_key(nnz, n_rows, rank, platform)
        if getattr(stats, "fill_bin", -1) >= 0:
            hp = heuristic_policy(nnz, n_rows, rank,
                                  vmem_budget=self.vmem_budget,
                                  platform=platform, stats=stats)
            if hp.strategy == "dense":
                hit = self.cache.lookup(key)
                if hit is not None and hit.strategy == "dense":
                    self.n_hits += 1
                    return hit
                self.n_searches += 1
                self.cache.store(key, hp, float("inf"), "heuristic",
                                 stats=stats,
                                 extra={"probes": 0, "dense_cut": True})
                return hp
        return self._tune_key(key, rows, vals, pi, b, n_rows, rank, platform,
                              stats=stats, v1_key=v1_key, n_modes=n_modes)

    def policy_for_cutout(self, cutout) -> PhiPolicy:
        """Tuned policy for a :class:`repro_torch.core.cpapr.ModeCutout`:
        the arrays the solver's mode update consumes, tuned in isolation."""
        return self.policy_for_mode(cutout.rows, cutout.vals, cutout.pi,
                                    cutout.b, n_rows=cutout.n_rows,
                                    rank=cutout.rank, stats=cutout.stats,
                                    n_modes=cutout.n_modes)

    def policy_for_sharded_mode(self, rows, vals, pi, b, n_rows: int,
                                rank: int, n_shards: int,
                                stats: ModeStats | None = None,
                                cuts: "list | None" = None,
                                assign: str | None = None,
                                combine: str | None = None,
                                grid: "tuple | None" = None,
                                n_modes: int = 3) -> tuple:
        """Tuned policies for one mode split into ``n_shards`` row shards.

        Each shard's sub-problem (its contiguous slice of the sorted
        stream, rebased to its local row window) is tuned and cached under
        a ``/shards=`` key with the shard's own segment-run stats.  One
        launch shape serves every shard, so the winners are reconciled to
        the winner of the largest-nnz shard.  Returns ``(uniform_policy,
        per_shard_policies)``; shards that own no nonzeros get None.

        ``pi`` may be None for a non-measuring tuner (no probe reads it).
        ``cuts`` pins the assignment (``n_shards + 1`` sorted-stream cut
        positions, e.g. from
        :func:`repro_torch.core.layout.shard_stream_cuts` after a
        rebalance) and adds the ``/assign=`` dimension; without it the
        nnz-balanced split keeps the plain ``/shards=`` keyspace.
        ``combine`` adds ``/combine=`` (``"psum"``/None keep the plain
        keyspace); ``grid`` (an ``(A, B)`` shape, ``B > 1``) adds
        ``/grid=AxB`` for a grid mode's row shards, tuned as usual (a
        cell runs the same local kernels on a slice of its shard) but
        cached apart from the 1-D winners.
        """
        if pi is None and self.measure:
            raise ValueError("a measuring tuner needs the Pi rows to probe; "
                             "pass pi or use Autotuner(measure=False)")
        platform = self.platform or _platform_of(rows)
        rows_np = _host(rows)
        nnz = int(rows_np.shape[0])
        if n_shards <= 1 or nnz == 0:
            pol = self.policy_for_mode(rows, vals, pi, b, n_rows=n_rows,
                                       rank=rank, stats=stats,
                                       n_modes=n_modes)
            return pol, [pol] * max(1, n_shards)

        if cuts is not None:
            cuts = [int(c) for c in cuts]
            if (len(cuts) != n_shards + 1 or cuts[0] != 0 or cuts[-1] != nnz
                    or any(b_ < a_ for a_, b_ in zip(cuts, cuts[1:]))):
                raise ValueError(
                    f"cuts must be non-decreasing from 0 to nnz={nnz} with "
                    f"{n_shards + 1} entries, got {cuts}"
                )
            if assign is None:
                assign = shard_assignment_fragment(cuts)
        else:
            # contiguous nnz-balanced cuts, snapped forward to row
            # boundaries (a row never spans shards)
            cuts = [0]
            for s in range(1, n_shards):
                p = s * nnz // n_shards
                while 0 < p < nnz and rows_np[p] == rows_np[p - 1]:
                    p += 1
                cuts.append(max(p, cuts[-1]))
            cuts.append(nnz)

        per_shard: list = []
        best, best_nnz = None, -1
        for s in range(n_shards):
            c0, c1 = cuts[s], cuts[s + 1]
            if c1 <= c0:
                per_shard.append(None)
                continue
            row_lo = int(rows_np[c0])
            row_hi = int(rows_np[c1 - 1]) + 1
            local_rows = rows_np[c0:c1] - row_lo
            shard_stats = mode_run_stats(local_rows, row_hi - row_lo)
            key = policy_key(c1 - c0, row_hi - row_lo, rank, platform,
                             n_shards=n_shards, stats=shard_stats,
                             assign=assign, combine=combine, grid=grid)
            v1_key = policy_key(c1 - c0, row_hi - row_lo, rank, platform,
                                n_shards=n_shards)
            dev = vals.device
            pol = self._tune_key(
                key, torch.as_tensor(local_rows, device=dev), vals[c0:c1],
                pi[c0:c1] if pi is not None else None, b[row_lo:row_hi],
                row_hi - row_lo, rank, platform, stats=shard_stats,
                v1_key=v1_key, n_modes=n_modes)
            per_shard.append(pol)
            if c1 - c0 > best_nnz:
                best, best_nnz = pol, c1 - c0
        if best is None:  # every shard empty (cannot happen when nnz > 0)
            best = heuristic_policy(nnz, n_rows, rank,
                                    vmem_budget=self.vmem_budget,
                                    platform=platform)
        return best, per_shard


def _host(rows) -> np.ndarray:
    if isinstance(rows, torch.Tensor):
        return rows.detach().cpu().numpy()
    return np.asarray(rows)
