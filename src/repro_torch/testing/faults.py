"""Fault-injection harness for the resilient CP-APR runtime.

Context managers that register hooks into
:mod:`repro_torch.core.resilience`'s registries (the core never imports
this package) plus file/cache corruption helpers, as in the JAX
package's ``repro.testing.faults``.  Together they drive the fault x
strategy x shard-count recovery matrix of ``tests/test_torch_faults.py``
and phases 11, 12 and 14 of ``chip_smoke.py``:

* :func:`inject_nan` — poison a chosen mode's update output with a NaN,
  exercising the numerical guard + kappa ladder;
* :func:`fail_strategy` — raise a simulated kernel failure from a chosen
  strategy, exercising ``cuda -> blocked -> segment``;
* :func:`fail_oom` — raise a simulated ``RESOURCE_EXHAUSTED`` while a
  mode runs with at least ``min_shards`` shards, exercising shard-count
  halving + rebalance;
* :func:`fail_fingerprint` — raise a simulated owner-partition
  fingerprint mismatch from a sharded mode, exercising the combine
  ``reduce_scatter -> psum``;
* :func:`kill_at_sweep` — raise :class:`KilledError` (deliberately
  *unclassifiable*, so the ladder re-raises) at a chosen outer sweep,
  simulating a process kill for checkpoint/resume tests;
* :func:`corrupt_checkpoint` / :func:`poison_autotune` — corrupt a
  checkpoint file / plant a bogus autotune cache entry.

Every context manager yields its remaining-fire budget (a one-element
list) so tests can assert the fault actually fired.
"""
from __future__ import annotations

import contextlib
import math
import time

from ..core import resilience

__all__ = [
    "KilledError",
    "corrupt_checkpoint",
    "fail_fingerprint",
    "fail_oom",
    "fail_strategy",
    "inject_nan",
    "kill_at_sweep",
    "poison_autotune",
]


class KilledError(RuntimeError):
    """Simulated process kill.  ``classify_failure`` returns ``None`` for
    it, so the solver re-raises instead of recovering, as a real SIGKILL
    ends the process mid-solve."""


def _spent(budget, ctx_match: bool) -> bool:
    """Decrement the fire budget when the context matches; True if the
    fault should fire now."""
    if not ctx_match or (budget[0] is not None and budget[0] <= 0):
        return False
    if budget[0] is not None:
        budget[0] -= 1
    return True


@contextlib.contextmanager
def inject_nan(mode: int = 0, outer: "int | None" = None,
               times: "int | None" = 1):
    """Overwrite entry [0, 0] of mode ``mode``'s updated factor with NaN,
    ``times`` times (``None``: every time).  The NaN goes into a clone:
    the tensor the solver returned, and may still hold, is untouched."""
    budget = [times]

    def hook(ctx, a_new, lam):
        match = ctx["mode"] == mode and (outer is None or
                                         ctx["outer"] == outer)
        if _spent(budget, match):
            a_new = a_new.clone()
            a_new[0, 0] = math.nan
        return a_new, lam

    resilience.register_post_update_hook(hook)
    try:
        yield budget
    finally:
        resilience.unregister_post_update_hook(hook)


@contextlib.contextmanager
def fail_strategy(
    strategy: str = "cuda",
    mode: "int | None" = None,
    times: int = 1,
    message: str = "simulated kernel failure: CUDA kernel launch failed",
):
    """Raise a simulated kernel failure whenever a mode runs with
    ``strategy`` (matched against the mode's strategy and its local
    flavour)."""
    budget = [times]

    def hook(ctx):
        match = strategy in (ctx["strategy"], ctx["local"]) and (
            mode is None or ctx["mode"] == mode
        )
        if _spent(budget, match):
            raise RuntimeError(message)

    resilience.register_mode_hook(hook)
    try:
        yield budget
    finally:
        resilience.unregister_mode_hook(hook)


@contextlib.contextmanager
def fail_oom(mode: "int | None" = None, min_shards: int = 2,
             times: "int | None" = None):
    """Raise a simulated ``RESOURCE_EXHAUSTED`` while a mode runs with at
    least ``min_shards`` shards: after the ladder halves below that, the
    solve proceeds (``min_shards=1`` also hits single-device modes, which
    have no OOM rung).  ``times=None`` means every matching attempt."""
    budget = [times]

    def hook(ctx):
        match = ctx["n_shards"] >= min_shards and (
            mode is None or ctx["mode"] == mode
        )
        if _spent(budget, match):
            raise RuntimeError(
                "RESOURCE_EXHAUSTED: out of memory allocating Phi combine "
                f"buffer at {ctx['n_shards']} shards (simulated)"
            )

    resilience.register_mode_hook(hook)
    try:
        yield budget
    finally:
        resilience.unregister_mode_hook(hook)


@contextlib.contextmanager
def fail_fingerprint(mode: "int | None" = None, times: int = 1):
    """Raise a simulated owner-partition fingerprint mismatch from a
    sharded mode (the error the sharded tier raises on gather maps that
    are stale against a rebalanced layout)."""
    budget = [times]

    def hook(ctx):
        match = ctx["strategy"] == "sharded" and (
            mode is None or ctx["mode"] == mode
        )
        if _spent(budget, match):
            raise resilience.ShardAssignmentError(
                "owner partition was built from a different shard "
                "assignment (rb_start mismatch, simulated)"
            )

    resilience.register_mode_hook(hook)
    try:
        yield budget
    finally:
        resilience.unregister_mode_hook(hook)


@contextlib.contextmanager
def kill_at_sweep(outer: int):
    """Simulate a process kill at the start of 1-based sweep ``outer``."""

    def hook(ctx):
        if ctx["outer"] == outer and ctx["mode"] == 0:
            raise KilledError(f"simulated kill at sweep {outer}")

    resilience.register_mode_hook(hook)
    try:
        yield
    finally:
        resilience.unregister_mode_hook(hook)


def corrupt_checkpoint(path: str, kind: str = "flip") -> None:
    """Corrupt a checkpoint file in place: ``flip`` xors payload bytes
    (crc mismatch), ``truncate`` cuts the file in half, ``magic``
    clobbers the file signature."""
    with open(path, "rb") as f:
        blob = f.read()
    if kind == "truncate":
        blob = blob[: max(8, len(blob) // 2)]
    elif kind == "flip":
        pos = max(0, len(blob) - 8)
        blob = blob[:pos] + bytes(b ^ 0xFF for b in blob[pos:pos + 4]) \
            + blob[pos + 4:]
    elif kind == "magic":
        blob = b"XX" + blob[2:]
    else:
        raise ValueError(f"unknown corruption kind {kind!r}")
    with open(path, "wb") as f:
        f.write(blob)


def poison_autotune(tuner, mv, rank: int, strategy: str = "warpspeed",
                    shape=None) -> str:
    """Plant a structurally valid cache entry whose policy names a
    nonexistent strategy under the exact key the tuner will serve for
    ``mv``'s problem; returns the poisoned key.  The entry passes every
    freshness check, so a solve with ``policy="auto"`` adopts it and hits
    the unknown-strategy error inside its first mode update, which the
    degradation ladder must absorb.  Pass the tensor ``shape`` to key the
    mode with its fill dimension as the solver does."""
    from ..core.layout import mode_run_stats
    from ..perf.autotune import AutotuneCache, _stamp

    stats = None
    if shape is not None:
        row_width = math.prod(shape) // shape[mv.mode]
        stats = mode_run_stats(mv.rows.detach().cpu().numpy(), mv.n_rows,
                               row_width=row_width)
    key, _stats = tuner.mode_key(mv.rows, mv.n_rows, rank, stats=stats)
    tuner.cache.entries[key] = {
        "policy": {"strategy": strategy, "block_nnz": 64, "block_rows": 8,
                   "gather_mode": "prefetch"},
        "seconds": 1e-9,
        "source": "grid",
        "tuned_at": time.time(),
        "schema": AutotuneCache.VERSION,
        **_stamp(),
    }
    tuner.cache.save()
    return key
