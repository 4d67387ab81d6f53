"""Fault tolerance for the CP-APR/CP-ALS runtime.

Three layers, consumed by :mod:`repro_torch.core.cpapr` (and, lighter,
:mod:`repro_torch.core.cpals`), as in the JAX package's
``repro.core.resilience``:

* **Numerical guards** — :func:`guard_ok` is a finite/nonnegative
  reduction over each mode's ``(A_n', lam')`` that stays on the device
  until the solver reads it at sweep end.  On a violation the solver
  restores the sweep-start state and redoes the sweep, escalating the
  scooch ``kappa`` (the damping ladder) on repeated failures; every retry
  is recorded as a :class:`RecoveryEvent` in ``CPAPRResult.recoveries``.

* **Degradation ladder** — :func:`classify_failure` maps runtime
  exceptions to a failure kind and the solver demotes the failing mode
  one rung (:data:`STRATEGY_DEMOTION`: ``cuda -> blocked -> segment``,
  ``dense -> segment``) on kernel errors, retrying with bounded
  exponential backoff (:func:`backoff_sleep`) instead of crashing the
  solve.  A sticky CUDA error (one that leaves the context unusable) is
  never demoted: no rung in the same process can recover from it.  The
  row-sharded tier adds its rungs: on a sharded mode a kernel failure
  demotes the shard-local ``cuda -> blocked``, then ``sharded ->
  segment``; a stale shard assignment (``"fingerprint"``) the combine
  ``reduce_scatter -> psum``; an OOM halves the shard count and
  rebalances, down to the single-device local path.  A grid mode
  demotes its cell-local ``cuda -> blocked``, then ``grid -> sharded``
  (its ``A``-shard 1-D split; a single-row-shard grid goes to the
  single-device local path), at once on OOM.

* **Sweep checkpoint/resume** — :func:`save_checkpoint` /
  :func:`load_checkpoint` serialize the solver state in the JAX package's
  format, byte for byte: magic ``REPRO-CKPT\\0``, an 8-byte header
  length, a JSON header (schema version + crc32 of the payload), then an
  ``npz`` payload, written atomically (tmp + ``os.replace``).  A corrupt
  or truncated file raises :class:`CheckpointError`; the solver
  quarantines it and starts fresh rather than dying.  A checkpoint
  written by either package resumes in the other.

The fault-injection harness (:mod:`repro_torch.testing.faults`) plugs
into the hook registries at the bottom of this module; the core never
imports the testing package.
"""
from __future__ import annotations

import dataclasses
import io
import json
import os
import tempfile
import time
import zlib
from typing import Callable

import numpy as np
import torch

from ..kernels._build import BuildError, LaunchError
from ..kernels._checks import CardLimitError

__all__ = [
    "CHECKPOINT_SCHEMA",
    "CheckpointError",
    "NotPortedError",
    "RecoveryEvent",
    "ShardAssignmentError",
    "STRATEGY_DEMOTION",
    "array_to_tensor",
    "backoff_sleep",
    "classify_failure",
    "config_fingerprint",
    "guard_ok",
    "load_checkpoint",
    "quarantine_checkpoint",
    "save_checkpoint",
    "state_ok",
    "validate_append_batch",
    "validate_decomposition_inputs",
]


class ShardAssignmentError(ValueError):
    """An owner partition / Π gather was built from a *different* shard
    assignment than the layout it is used with (stale after a
    rebalance): its slices would cover the wrong rows."""


class CheckpointError(RuntimeError):
    """A checkpoint file could not be read, parsed, or verified."""


class NotPortedError(NotImplementedError):
    """An option of the JAX package that this port does not have yet.

    The message names the ROADMAP item.  :func:`classify_failure` returns
    ``None`` for it, so the degradation ladder never "demotes" such an
    option into a run: it reaches the caller unchanged.
    """


@dataclasses.dataclass
class RecoveryEvent:
    """One recovery action taken by the solver, surfaced in
    ``CPAPRResult.recoveries`` instead of a crash.

    ``kind`` is one of ``nan_guard`` (numerical guard tripped, last-good
    state restored), ``loglik_guard`` (non-finite sweep log-likelihood,
    sweep redone), ``demote_kernel`` / ``demote_policy`` (degradation-
    ladder rungs), ``checkpoint_corrupt`` (resume file failed
    verification and was quarantined) or ``resume`` (solve continued from
    a checkpoint).  ``outer`` is the 1-based sweep, ``mode`` the mode
    index (-1 for solve-level events), ``attempt`` the retry count at
    that point.
    """

    kind: str
    outer: int
    mode: int = -1
    attempt: int = 0
    detail: dict = dataclasses.field(default_factory=dict)


# ---------------------------------------------------------------------------
# Numerical guards
# ---------------------------------------------------------------------------


def guard_ok(a: torch.Tensor, lam: torch.Tensor, viol=None) -> torch.Tensor:
    """0-d bool tensor on the device: ``a`` and ``lam`` finite and
    nonnegative, and ``viol`` (when given) finite.  The solver computes
    one per mode update and reads them on the host at sweep end, one read
    (a host sync) per mode: N per sweep."""
    ok = (torch.isfinite(a).all() & (a >= 0).all()
          & torch.isfinite(lam).all() & (lam >= 0).all())
    if viol is not None:
        ok = ok & torch.isfinite(torch.as_tensor(viol)).all()
    return ok


def state_ok(a, lam, viol=None) -> bool:
    """Host-level guard over concrete tensors or arrays."""
    return bool(guard_ok(torch.as_tensor(a), torch.as_tensor(lam),
                         None if viol is None else torch.as_tensor(viol)))


# ---------------------------------------------------------------------------
# Failure classification + demotion ladder
# ---------------------------------------------------------------------------

# kernel demotion chain: each rung is strictly more portable.  "dense"
# demotes straight to the sorted segmented reduce: the blocked rungs need
# the sorted-stream layout the dense tier never built.  "grid" demotes to
# the 1-D row-sharded family: the column combine is all the rung sheds,
# the grid's own row-shard layout is reused (the solver rebuilds the mode).
STRATEGY_DEMOTION = {"cuda": "blocked", "blocked": "segment",
                     "dense": "segment", "grid": "sharded"}

_OOM_MARKERS = ("resource_exhausted", "out of memory", "allocation failure")
_KERNEL_MARKERS = ("mosaic", "pallas", "simulated kernel", "lowering",
                   "triton", "internal:", "nvcc")
# PyTorch's own texts of the sticky cudaErrors (see STICKY_CUDA_ERRORS)
_STICKY_MARKERS = ("illegal memory access", "device-side assert",
                   "misaligned address", "unspecified launch failure",
                   "illegal instruction", "hardware stack error")


def classify_failure(exc: BaseException) -> "str | None":
    """Map a runtime exception to a degradation-ladder kind.

    Returns ``"oom"`` (a device or host allocation failed: shard-count
    halving + rebalance on a sharded mode), ``"fingerprint"`` (a stale
    shard assignment: the combine ``reduce_scatter -> psum``),
    ``"kernel"`` (a kernel failed to build, was refused by the card's
    limits, or failed to launch: ``cuda -> blocked -> segment``; on a
    sharded mode the local ``cuda -> blocked``, then ``sharded ->
    segment``), ``"policy"`` (a served policy names an unknown strategy
    or combine: drop to ``segment``) or ``None`` for anything the ladder
    must not swallow: asserts, keyboard interrupts, genuine bugs, options
    this port does not have yet (:class:`NotPortedError`), and sticky CUDA
    errors, after which no demotion in the same process can run.  The
    solver re-raises those.
    """
    if isinstance(exc, NotPortedError):
        return None
    msg = str(exc)
    low = msg.lower()
    if (isinstance(exc, LaunchError) and exc.sticky) \
            or any(m in low for m in _STICKY_MARKERS):
        return None
    if isinstance(exc, (MemoryError, torch.cuda.OutOfMemoryError)) \
            or any(m in low for m in _OOM_MARKERS):
        return "oom"
    if isinstance(exc, ShardAssignmentError) or \
            "different shard assignment" in msg:
        return "fingerprint"
    if isinstance(exc, ValueError) and (
        "unknown strategy" in msg or "unknown combine" in msg
    ):
        return "policy"
    if isinstance(exc, (BuildError, LaunchError, CardLimitError,
                        NotImplementedError)) \
            or any(m in low for m in _KERNEL_MARKERS):
        return "kernel"
    return None


def backoff_sleep(attempt: int, base: float, cap: float = 2.0) -> float:
    """Bounded exponential backoff before a demoted retry; returns the
    seconds slept so tests can assert the schedule with ``base=0``."""
    secs = min(base * (2.0 ** attempt), cap) if base > 0 else 0.0
    if secs > 0:
        time.sleep(secs)
    return secs


# ---------------------------------------------------------------------------
# Checkpoint / resume
# ---------------------------------------------------------------------------

CHECKPOINT_SCHEMA = 1
_MAGIC = b"REPRO-CKPT\x00"


def _crc_hex(blob: bytes) -> str:
    return format(zlib.crc32(blob) & 0xFFFFFFFF, "08x")


def config_fingerprint(fields: dict) -> str:
    """crc32 over a canonical JSON dump of the problem/config fields that
    must match for a checkpoint to be resumable."""
    blob = json.dumps(fields, sort_keys=True, separators=(",", ":"))
    return _crc_hex(blob.encode())


def _to_numpy(x) -> np.ndarray:
    """A host numpy copy of a tensor or array.  A bf16 tensor becomes a
    2-byte void array of its raw bits: what the JAX package's bfloat16
    arrays load back as from the npz payload, and what
    :func:`array_to_tensor` reads back bit for bit."""
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view("V2")
    return x.numpy()


def array_to_tensor(a: np.ndarray, device) -> torch.Tensor:
    """A checkpointed array as a tensor on ``device``, bits kept (a
    2-byte ``bfloat16`` array becomes a bf16 tensor)."""
    a = np.asarray(a)
    if a.dtype.itemsize == 2 and a.dtype.kind not in "fiu":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def save_checkpoint(path: str, state: dict) -> None:
    """Atomically write solver state to ``path``.

    ``state`` must contain ``lam`` and ``factors`` (tensors or arrays,
    stored in an ``npz`` payload with their dtypes, so resume is bitwise)
    plus any JSON-serializable header fields (outer index, histories,
    policies...).  Layout: magic, 8-byte header length, JSON header
    (schema version + crc32 of the payload), payload bytes.  The write
    goes to a same-directory temp file and is published with
    ``os.replace``: a concurrent reader sees the old file or the new one,
    never a torn mix.
    """
    arrays = {"lam": _to_numpy(state["lam"])}
    for i, f in enumerate(state["factors"]):
        arrays[f"factor_{i}"] = _to_numpy(f)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    payload = buf.getvalue()
    header = {k: v for k, v in state.items() if k not in ("lam", "factors")}
    header["schema"] = CHECKPOINT_SCHEMA
    header["n_factors"] = len(state["factors"])
    header["crc32"] = _crc_hex(payload)
    hb = json.dumps(header, sort_keys=True).encode()
    blob = _MAGIC + len(hb).to_bytes(8, "big") + hb + payload

    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".ckpt.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(blob)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def load_checkpoint(path: str) -> dict:
    """Read + verify a checkpoint; raises :class:`CheckpointError` on any
    failure (missing file, bad magic, truncation, schema mismatch, crc
    mismatch, unparseable payload), never returns partial state.
    ``lam`` and ``factors`` come back as numpy arrays."""
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except OSError as e:
        raise CheckpointError(f"cannot read checkpoint {path}: {e}") from e
    if not blob.startswith(_MAGIC):
        raise CheckpointError(f"{path}: not a repro checkpoint (bad magic)")
    off = len(_MAGIC)
    if len(blob) < off + 8:
        raise CheckpointError(f"{path}: truncated header length")
    hlen = int.from_bytes(blob[off:off + 8], "big")
    hb = blob[off + 8:off + 8 + hlen]
    if len(hb) != hlen:
        raise CheckpointError(f"{path}: truncated header")
    try:
        header = json.loads(hb.decode())
    except (UnicodeDecodeError, ValueError) as e:
        raise CheckpointError(f"{path}: unparseable header: {e}") from e
    if header.get("schema") != CHECKPOINT_SCHEMA:
        raise CheckpointError(
            f"{path}: checkpoint schema {header.get('schema')!r} != "
            f"supported {CHECKPOINT_SCHEMA}"
        )
    payload = blob[off + 8 + hlen:]
    if _crc_hex(payload) != header.get("crc32"):
        raise CheckpointError(f"{path}: payload crc mismatch (corrupt file)")
    try:
        npz = np.load(io.BytesIO(payload))
        lam = npz["lam"]
        factors = [npz[f"factor_{i}"] for i in range(header["n_factors"])]
    except Exception as e:
        raise CheckpointError(f"{path}: unparseable payload: {e}") from e
    state = dict(header)
    state["lam"] = lam
    state["factors"] = factors
    return state


def quarantine_checkpoint(path: str) -> str:
    """Move a failed checkpoint aside (``<path>.corrupt``) so the solver
    can write fresh checkpoints at the original path; returns the new
    location (or ``path`` unchanged when the move itself fails)."""
    qpath = path + ".corrupt"
    try:
        os.replace(path, qpath)
        return qpath
    except OSError:
        return path


# ---------------------------------------------------------------------------
# Input validation (the cpapr_mu / cp_als boundary)
# ---------------------------------------------------------------------------


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        # numpy has no bf16: the checks read it exactly as f32
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def validate_decomposition_inputs(t, rank: int, where: str = "cpapr_mu",
                                  nonneg: bool = True) -> None:
    """Reject garbage inputs with a clear error *naming the offending
    mode/position* instead of producing silent NaN factors.

    Checks: ``rank`` positive; indices shaped (nnz, ndim) and in-range
    per mode; values finite; values nonnegative (Poisson count data) when
    ``nonneg``.  One host pass over the nonzeros, once per solve.
    """
    if not isinstance(rank, (int, np.integer)) or rank <= 0:
        raise ValueError(f"{where}: rank must be a positive integer, "
                         f"got {rank!r}")
    idx = _host(t.indices)
    vals = _host(t.values)
    ndim = len(t.shape)
    if idx.ndim != 2 or idx.shape[1] != ndim:
        raise ValueError(
            f"{where}: indices must have shape (nnz, {ndim}) for a "
            f"{ndim}-mode tensor, got {idx.shape}"
        )
    if vals.shape != (idx.shape[0],):
        raise ValueError(
            f"{where}: values must have shape ({idx.shape[0]},) to match "
            f"indices, got {vals.shape}"
        )
    _check_indices_values(where, t.shape, idx, vals, nonneg)


def _check_indices_values(where, shape, idx, vals, nonneg) -> None:
    for n, dim in enumerate(shape):
        col = idx[:, n]
        bad = (col < 0) | (col >= dim)
        if bad.any():
            j = int(np.argmax(bad))
            raise ValueError(
                f"{where}: mode {n} has out-of-range index {int(col[j])} at "
                f"nonzero {j} (valid range [0, {int(dim)}))"
            )
    finite = np.isfinite(vals.astype(np.float64, copy=False))
    if not finite.all():
        j = int(np.argmax(~finite))
        raise ValueError(
            f"{where}: non-finite nonzero value {vals[j]!r} at position {j}"
        )
    if nonneg:
        neg = vals < 0
        if neg.any():
            j = int(np.argmax(neg))
            raise ValueError(
                f"{where}: negative nonzero value {vals[j]!r} at position "
                f"{j}; the solvers assume nonnegative (Poisson count) data"
            )


def validate_append_batch(shape, new_indices, new_values,
                          where: str = "append_nonzeros",
                          nonneg: bool = True) -> None:
    """The :func:`validate_decomposition_inputs` checks for an append
    batch against an existing tensor ``shape``: same mode naming and
    message formats, applied *before* the merge so a malformed tenant
    batch fails at the service boundary instead of surfacing as a
    reshape error mid-solve."""
    idx = _host(new_indices)
    vals = _host(new_values)
    ndim = len(shape)
    if idx.ndim != 2 or idx.shape[1] != ndim:
        raise ValueError(
            f"{where}: indices must have shape (k, {ndim}) for a "
            f"{ndim}-mode tensor, got {idx.shape}"
        )
    if not np.issubdtype(idx.dtype, np.integer):
        raise ValueError(
            f"{where}: indices must be integers, got dtype {idx.dtype}"
        )
    if vals.shape != (idx.shape[0],):
        raise ValueError(
            f"{where}: values must have shape ({idx.shape[0]},) to match "
            f"indices, got {vals.shape}"
        )
    if not np.issubdtype(vals.dtype, np.floating) and \
            not np.issubdtype(vals.dtype, np.integer):
        raise ValueError(
            f"{where}: values must be numeric counts, got dtype "
            f"{vals.dtype}"
        )
    _check_indices_values(where, shape, idx, vals, nonneg)


# ---------------------------------------------------------------------------
# Fault-injection hook registries (populated only by repro_torch.testing)
# ---------------------------------------------------------------------------

_mode_hooks: list = []  # fn(ctx) -> None; may raise to simulate a fault
_post_update_hooks: list = []  # fn(ctx, a_new, lam) -> (a_new, lam)


def register_mode_hook(fn: Callable) -> None:
    _mode_hooks.append(fn)


def unregister_mode_hook(fn: Callable) -> None:
    if fn in _mode_hooks:
        _mode_hooks.remove(fn)


def register_post_update_hook(fn: Callable) -> None:
    _post_update_hooks.append(fn)


def unregister_post_update_hook(fn: Callable) -> None:
    if fn in _post_update_hooks:
        _post_update_hooks.remove(fn)


def have_hooks() -> bool:
    return bool(_mode_hooks or _post_update_hooks)


def have_post_update_hooks() -> bool:
    return bool(_post_update_hooks)


def fire_mode_hooks(ctx: dict) -> None:
    """Called by the solver right before invoking a mode update, inside
    the degradation-ladder try block: a hook that raises exercises the
    exact recovery path a real runtime failure would."""
    for fn in list(_mode_hooks):
        fn(ctx)


def apply_post_update_hooks(ctx: dict, a_new, lam):
    """Called on a mode update's outputs; hooks may corrupt them (e.g.
    inject NaNs) to exercise the numerical guard."""
    for fn in list(_post_update_hooks):
        a_new, lam = fn(ctx, a_new, lam)
    return a_new, lam
