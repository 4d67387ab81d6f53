"""CP-APR Multiplicative Update (Chi & Kolda 2012; paper Alg. 1).

    for k in 1..k_max:                      # outer
      for n in 1..N:                        # modes
        B <- (A^(n) + S) Lambda             # S removes inadmissible zeros
        for l in 1..l_max:                  # inner MU
          Φ <- (X_(n) (/) max(B Π, eps)) Π^T
          if KKT(B, Φ) < tol: break
          B <- B * Φ
        lam <- e^T B;  A^(n) <- B Lambda^-1

Each inner iteration is the fused :func:`repro_torch.core.phi.phi_mu_step`
(for ``cuda``, the fused Φ -> MU kernels).  The Π gather and its layout
expansion are hoisted out of the inner loop: once per mode update.  With
``strategy="dense"`` each mode carries its densified tensor instead, the
kernel operands ``(x, c, a)`` are hoisted once per mode update, the
scooch runs the dense Φ kernel and every inner iteration the fused dense
Φ -> MU kernels.  The inner loop reads the KKT violation on the host
after every iteration to decide whether to go on; the iteration that
finds viol <= tol is counted and leaves B unchanged, as in the JAX
package's ``lax.while_loop``.  While ``torch.profiler`` runs, flat host
spans (:mod:`repro_torch.spans`) mark the preparation's phases, each
step of the mode update, and every host read of a device value.

Strategy + blocking policy is the paper's "parallel policy": implicit
(``CPAPRConfig.strategy`` with default block sizes), explicit (a
:class:`PhiPolicy`) or ``policy="auto"``: the persistent autotuner
(:mod:`repro_torch.perf.autotune`) picks a policy per mode, cached across
processes in the port's own JSON store.

With ``CPAPRConfig.max_demotions > 0`` every mode update runs under the
degradation ladder (:mod:`repro_torch.core.resilience`): a classified
failure (a kernel that fails to build, is refused by the card's limits
or fails to launch; a served policy naming an unknown strategy) demotes
the mode one rung (``cuda -> blocked -> segment``, ``dense -> segment``)
and retries it, and every demotion is recorded in
``CPAPRResult.recoveries``.  The ladder is off by default, so every such
failure reaches the caller.  A sticky CUDA error always propagates.  ``checkpoint_every``/``checkpoint_path`` write
the solver state in the JAX package's checkpoint format and
``resume_from`` continues from it (a checkpoint resumes across the two
packages in both directions).

``strategy="sharded"`` splits each mode's blocked schedule into
contiguous row-block shards (:mod:`repro_torch.core.distributed`): one
shard per rank of a ``torch.distributed`` mesh (``CPAPRConfig.mesh``),
else ``n_shards`` shards emulated on one device.  Each inner iteration
reduces every shard (the Φ kernel B2 per shard for a ``cuda`` policy)
and meets in one combine: the all-reduce (``combine="psum"``) or the
owner-partitioned reduce-scatter, whose inner loop carries each owner's
rows and gathers the factor once per mode update.  A mode with fewer
row blocks than shards warns and runs unsharded.  ``shard_pi`` builds
each shard's Π rows from the factor rows it touches and
``rebalance_every`` re-splits the shards by nonzero count between
sweeps.  ``strategy="grid"`` refines each mode's row shards over an
``A x B`` device grid (``grid_shape``, else :func:`choose_grid_shape` per
mode from its skew): the inner loop carries each cell's owned
(sub_rows, R) tile and meets in the column all-gather + reduce-scatter
pair, B2 once per cell per call for a ``cuda`` policy; the factor is
gathered once per mode update.  A mode that cannot be gridded warns and
runs unsharded, and the ladder's grid rung drops a grid mode to its
``A``-shard 1-D split (a single-row-shard grid to the single-device
local path).
"""
from __future__ import annotations

import dataclasses
import math
import time
from functools import partial
from typing import Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..spans import (
    PREP_LAYOUT,
    PREP_SORT,
    PREP_VALIDATE,
    SWEEP_GUARD,
    SWEEP_INPUTS,
    SWEEP_LOGLIK,
    SWEEP_RENORM,
    SWEEP_SCOOCH,
    SWEEP_STEP,
    SWEEP_SYNC,
    span,
)
from . import resilience
from .convert import policy_from_dict
from .dense import DenseModeData, build_dense_mode
from .layout import (
    BlockedLayout,
    GridLayout,
    ModeStats,
    ShardedBlockedLayout,
    ShardedPiGather,
    build_blocked_layout,
    build_grid_layout,
    build_shard_pi_gather,
    choose_grid_shape,
    mode_run_stats,
    owner_partition,
    rebalance_shards,
    shard_blocked_layout,
    shard_stream_cuts,
)
from .phi import (
    _dense_operands,
    _sharded_block_rows,
    canonical_strategy,
    expand_to_grid,
    expand_to_layout,
    expand_to_shards,
    expand_vals_to_shards,
    phi_from_rows,
    phi_mu_step,
)
from .pi import pi_rows
from .policy import PhiPolicy, default_policy
from .resilience import STRATEGY_DEMOTION, RecoveryEvent
from .sparse_tensor import KTensor, ModeView, SparseTensor, random_ktensor, sort_mode

__all__ = [
    "CPAPRConfig",
    "CPAPRResult",
    "ModeCutout",
    "SweepOutcome",
    "cpapr_mu",
    "effective_mode_combine",
    "extract_mode_cutout",
    "hoisted_mode_inputs",
    "kkt_violation",
    "mode_pi_gather",
    "poisson_loglik",
    "resolve_combine",
    "resolve_mode_policies",
    "sweep_step",
]

# the JAX package's name of a port strategy, in checkpoints and their
# fingerprints (a checkpoint resumes in either package)
_REFERENCE_NAME = {"cuda": "pallas"}


@dataclasses.dataclass(frozen=True)
class CPAPRConfig:
    rank: int
    max_outer: int = 20
    max_inner: int = 10
    tol: float = 1e-4
    eps: float = 1e-10  # minimum divisor (paper Alg. 2)
    kappa: float = 1e-2  # "scooch" offset for inadmissible zeros
    kappa_tol: float = 1e-10
    strategy: str = "segment"
    # PhiPolicy (explicit blocking), "auto" (persistent autotuner), or None
    # (default 256 x 256 blocking)
    policy: "PhiPolicy | str | None" = None
    # Optional repro_torch.perf.autotune.Autotuner for policy="auto"; a
    # default one (persistent user-level cache) is created when absent.
    autotuner: "object | None" = None
    track_loglik: bool = True
    # strategy="sharded": row blocks split over this torch.distributed
    # DeviceMesh (a 1-D ("data",) mesh, make_phi_mesh) with one combine
    # per inner iteration; None emulates the shards on one device.
    mesh: "object | None" = None
    # Shard count for the emulated sharded path (ignored when mesh is set;
    # defaults to torch.cuda.device_count() on the card, 1 on the CPU).
    n_shards: "int | None" = None
    # strategy="grid": the (A, B) device grid of every mode; None picks it
    # per mode from the mode's row skew (choose_grid_shape), where a hub
    # mode takes any wire saving of the O(I_n * R / A) column combine.  A
    # grid run's mesh is a ("row", "col") mesh of that shape
    # (make_grid_mesh).
    grid_shape: "tuple | None" = None
    # strategy="sharded": compute Pi rows shard-locally from the factor
    # rows each shard touches (ShardedPiGather) instead of materializing
    # the replicated (nnz, R) Pi array — per-device factor bytes drop from
    # O(I * R) to O(touched_rows * R).  The Pi product is recomputed per
    # inner iteration inside the shard (O(nnz/S * R) per device), which
    # beats the one-time replicated O(nnz * R) compute once S >= max_inner
    # and removes the expanded-Pi footprint entirely.
    shard_pi: bool = True
    # Rebalance sharded row-block boundaries by measured nnz skew every
    # this many outer sweeps (0 = static sharding).  The base blocked
    # schedule (and the tuned block sizes) stay pinned; only the
    # block->shard assignment moves, so every shard remains a valid
    # blocked schedule.  Changed modes rebuild their update.
    rebalance_every: int = 0
    # strategy="sharded" combine flavour: "psum" (all-reduce of the full
    # (buf_rows, R) window), "reduce_scatter" (owner-partitioned
    # epilogue: each device keeps only its owned O(I_n*R/S) slice through
    # the inner MU loop and the updated factor rows are gathered once per
    # mode update), or "auto" (default: reduce_scatter whenever the mode
    # is actually sharded, unless its split pads the owner slots past the
    # all-reduce's wire).
    combine: str = "auto"
    # Reject NaN/negative values, out-of-range indices, and rank <= 0 at
    # the solve boundary (one host pass over the nonzeros).
    validate: bool = True
    # Numerical guard: a finite/nonnegative check of each mode's (A_n',
    # lam'), read at sweep end.  On violation the sweep-start state is
    # restored and the sweep redone — once as-is, then with the offending
    # modes' scooch kappa escalated 10x per further retry — before giving
    # up after guard_retries.
    guard: bool = True
    guard_retries: int = 3
    # Degradation ladder: runtime failures classified by
    # repro_torch.core.resilience.classify_failure demote the failing mode
    # (cuda -> blocked -> segment, dense -> segment; on a sharded mode the
    # local cuda -> blocked, then sharded -> segment, the combine
    # reduce_scatter -> psum on a stale shard assignment, and shard
    # halving + rebalance on OOM), at most max_demotions rungs per mode
    # invocation.  Off by default (the JAX package takes 4): a kernel that
    # fails to build or launch is then an error, never a run of its plain
    # version on the card.  An OOM rung retries after bounded exponential
    # backoff (demote_backoff * 2^attempt, capped), as in the JAX package:
    # memory another tenant holds may be freed meanwhile.  The other rungs
    # retry another strategy at once, since their failures recur.
    demote_backoff: float = 0.05
    max_demotions: int = 0
    # Sweep-level checkpointing: every checkpoint_every outer sweeps the
    # solver state (factors, lam, outer index, histories, per-mode
    # strategies, policies and kappas) is written atomically to
    # checkpoint_path; cpapr_mu(resume_from=...) continues from it.
    # 0 / None disables.
    checkpoint_every: int = 0
    checkpoint_path: "str | None" = None


@dataclasses.dataclass
class CPAPRResult:
    ktensor: KTensor
    n_outer: int
    kkt_history: list  # per outer iter: max violation over modes
    loglik_history: list
    inner_iters: list  # per outer iter: total inner iterations
    converged: bool
    seconds: float
    policies: list | None = None  # per-mode PhiPolicy, blocked/cuda/dense
    # per rebalance event: {"outer", "mode", "rb_start_old", "rb_start_new",
    # "imbalance_old", "imbalance_new"} (nnz max/mean over shards)
    rebalances: list | None = None
    # RecoveryEvents (numerical-guard restores, degradation-ladder
    # demotions, checkpoint quarantine/resume), in order
    recoveries: list | None = None
    # per outer iter run in this process: host seconds of the sweep
    sweep_seconds: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class SweepOutcome:
    """One outer sweep's worth of state, produced by :func:`sweep_step`.

    ``worst``/``inner_total`` are tensors: 0-d for the driver's per-tensor
    updates, ``(J,)`` for the service's batched bucket updates; callers
    read them once at sweep end.  ``bad`` lists the modes the numerical
    guard blamed for a non-finite sweep (empty when the sweep is clean or
    unguarded).
    """

    factors: list
    lam: torch.Tensor
    worst: "torch.Tensor | None"
    inner_total: "torch.Tensor | int"
    bad: list


def _as_tensor(x) -> torch.Tensor:
    """A mode update's KKT value or inner count as a tensor: a host number
    becomes a 0-d f64/int64 CPU tensor, exact for any f32 or f64 value."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.tensor(x, dtype=torch.int64 if isinstance(x, int)
                        else torch.float64)


def _tripped(ok) -> bool:
    """Whether a mode's guard flag is set and false: one host read of the
    device flag (a host sync) where there is a flag."""
    if ok is None:
        return False
    with span(SWEEP_SYNC):
        return not bool(ok)


def sweep_step(carry, batch, guard: bool = False) -> SweepOutcome:
    """One CP-APR outer sweep as a pure ``(carry, batch) -> outcome`` step.

    ``carry`` is ``(factors, lam)``; ``batch`` holds one callable per mode,
    ``(factors, lam) -> (A_n', lam', viol, n_inner, ok)`` with ``ok`` the
    mode's on-device guard boolean (or None when unguarded).  ``viol`` and
    ``n_inner`` are host numbers (:func:`cpapr_mu`'s updates) or tensors,
    ``(J,)`` per job for the service's bucket updates
    (:mod:`repro_torch.serve.batch`); ``worst`` is their elementwise max
    and ``inner_total`` their sum over the modes.  A non-finite KKT value
    aborts the sweep early and blames the earliest mode whose guard flag
    tripped; a sweep that finishes collects every tripped mode into
    ``bad``.  The input ``factors`` list is never mutated.
    """
    factors, lam = list(carry[0]), carry[1]
    n_modes = len(batch)
    worst = None
    inner_total: "torch.Tensor | int" = 0
    ok_flags: list = [None] * n_modes
    bad: list = []
    for n, mode_fn in enumerate(batch):
        a_new, lam_new, viol, n_inner, ok = mode_fn(factors, lam)
        viol = _as_tensor(viol)
        if guard and not math.isfinite(float(viol.max())):
            bad = [m for m in range(n) if _tripped(ok_flags[m])] or [n]
            break
        factors[n] = a_new
        lam = lam_new
        ok_flags[n] = ok
        worst = viol if worst is None else torch.maximum(worst, viol)
        inner_total = inner_total + _as_tensor(n_inner)
    if guard and not bad:
        bad = [n for n in range(n_modes) if _tripped(ok_flags[n])]
    return SweepOutcome(factors=factors, lam=lam, worst=worst,
                        inner_total=inner_total, bad=bad)


def mode_pi_gather(mv: ModeView, layout,
                   shard_pi: bool = True) -> "ShardedPiGather | None":
    """The shard-local Π gather maps for one mode, or None when the mode
    is not sharded (or ``shard_pi`` is off).  Shared by CP-APR and CP-ALS
    so both solver families build identical maps."""
    if shard_pi and isinstance(layout, ShardedBlockedLayout):
        return build_shard_pi_gather(layout, mv.sorted_idx, mv.mode)
    return None


def hoisted_mode_inputs(mv: ModeView, factors, strategy: str, layout,
                        pig: "ShardedPiGather | None" = None) -> tuple:
    """Per-mode-update hoisted inputs ``(pi, vals_e, pi_e)``: one Π gather
    and, for the blocked schedules, one layout expansion per mode update.
    With ``pig`` (shard-local Π) only the values are expanded: each shard
    gathers its own factor rows per call, and no (nnz, R) Π is built."""
    if pig is not None:
        return None, expand_vals_to_shards(layout, mv.sorted_vals), None
    pi = pi_rows(mv.sorted_idx, factors, mv.mode)
    if strategy == "grid" and isinstance(layout, GridLayout):
        vals_e, pi_e = expand_to_grid(layout, mv.sorted_vals, pi)
    elif strategy == "sharded" and layout is not None:
        vals_e, pi_e = expand_to_shards(layout, mv.sorted_vals, pi)
    elif strategy in ("blocked", "cuda") and layout is not None:
        vals_e, pi_e = expand_to_layout(layout, mv.sorted_vals, pi)
    else:
        vals_e = pi_e = None
    return pi, vals_e, pi_e


@dataclasses.dataclass(frozen=True)
class ModeCutout:
    """One mode's fused-MU burst problem, cut out of the solver.

    The (rows, vals, Π, B) quadruple the solver's inner loop consumes,
    as a standalone problem: a tuner or benchmark can measure the MU
    burst on exactly the tensors the solver would feed it, without a
    whole decomposition per probe.  Policy-dependent layout expansion is
    not part of the cutout: it differs per candidate, and the autotuner
    hoists it per probe as the solver hoists it per mode update.
    """

    mode: int
    rows: torch.Tensor  # (nnz,) sorted row ids
    vals: torch.Tensor  # (nnz,) values in sorted order
    pi: torch.Tensor  # (nnz, R) Khatri-Rao rows (hoisted gather)
    b: torch.Tensor  # (I_n, R) scaled factor  B = A_n * lam
    n_rows: int
    rank: int
    stats: ModeStats  # segment-run statistics of the sorted rows
    n_modes: int = 3  # the tensor's order

    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])


def extract_mode_cutout(t: SparseTensor, kt: KTensor, mode: int) -> ModeCutout:
    """Extract :class:`ModeCutout` for ``mode`` of ``(t, kt)`` through the
    solver's own plumbing (:func:`sort_mode`, :func:`hoisted_mode_inputs`
    with ``segment``, :func:`mode_run_stats`), so the cutout cannot drift
    from what :func:`cpapr_mu` runs.  ``t`` and ``kt`` on one device."""
    mv = sort_mode(t, mode)
    pi, _, _ = hoisted_mode_inputs(mv, kt.factors, "segment", None)
    b = kt.factors[mode] * kt.lam[None, :]
    stats = mode_run_stats(mv.rows.detach().cpu().numpy(), mv.n_rows)
    return ModeCutout(mode=mode, rows=mv.rows, vals=mv.sorted_vals, pi=pi,
                      b=b, n_rows=mv.n_rows, rank=int(kt.rank), stats=stats,
                      n_modes=t.ndim)


def kkt_violation(b: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """max |min(B, 1 - Φ)| — zero iff the KKT conditions hold (C&K Sec. 4)."""
    return torch.max(torch.abs(torch.minimum(b, 1.0 - phi)))


def poisson_loglik(t: SparseTensor, kt: KTensor, eps: float = 1e-10) -> torch.Tensor:
    """sum_z x_z log m_z - sum(model);  model mass = sum(lam) for normalized kt."""
    prod = torch.ones((t.values.shape[0], kt.rank), dtype=kt.lam.dtype,
                      device=kt.lam.device)
    for n, f in enumerate(kt.factors):
        prod = prod * f[t.indices[:, n]]
    m = prod @ kt.lam
    return (torch.sum(t.values * torch.log(torch.clamp_min(m, eps)))
            - torch.sum(kt.lam))


def resolve_combine(combine: str, strategy: str) -> str:
    """Resolve a (possibly ``"auto"``) combine flavour for one mode.

    ``"auto"`` means reduce-scatter whenever the mode runs sharded;
    non-sharded modes always resolve to ``"psum"`` (nothing to combine).
    The grid family has exactly one combine, the reduce-scatter, so
    ``"grid"`` resolves to ``"reduce_scatter"`` and rejects ``"psum"``.
    """
    from .distributed import PHI_COMBINES  # deferred: avoids cycle

    if strategy == "grid":
        if combine not in ("auto", "reduce_scatter"):
            raise ValueError(
                f"combine {combine!r} is not supported for strategy='grid'"
                " (the grid combine is always the column reduce-scatter)"
            )
        return "reduce_scatter"
    if strategy != "sharded":
        return "psum"
    if combine == "auto":
        return "reduce_scatter"
    if combine not in PHI_COMBINES:
        raise ValueError(
            f"unknown combine {combine!r}; expected 'auto' or one of "
            f"{PHI_COMBINES}"
        )
    return combine


def effective_mode_combine(combine: str, strategy: str, layout, rank: int,
                           *, itemsize: int = 4) -> str:
    """Per-mode combine after the wire-aware ``"auto"`` demotion.

    ``"auto"`` prefers the reduce-scatter epilogue but consults
    :func:`repro_torch.core.distributed.preferred_combine` on the mode's
    sharded layout: a heavily block-skewed split pads the owner slots past
    the all-reduce's wire, and ``"auto"`` then keeps the all-reduce.  An
    explicit ``"reduce_scatter"`` is never demoted.  ``itemsize`` is the
    factor element width in bytes.
    """
    eff = resolve_combine(combine, strategy)
    if isinstance(layout, GridLayout):
        # the 1-D or N-D pick happened when the layout was resolved
        # (choose_grid_shape); a grid has exactly one combine
        return "reduce_scatter"
    if (combine == "auto" and eff == "reduce_scatter"
            and isinstance(layout, ShardedBlockedLayout)):
        from .distributed import preferred_combine  # deferred: avoids cycle

        eff = preferred_combine(layout, rank, itemsize=itemsize)
    return eff


def _effective_shard_count(mesh, n_shards, device: torch.device) -> int:
    if mesh is not None:
        from .distributed import mesh_device_count  # deferred: avoids cycle

        return mesh_device_count(mesh)
    if n_shards is not None:
        return int(n_shards)
    if device.type == "cuda":
        return max(1, torch.cuda.device_count())
    return 1


def _local_of(pol: PhiPolicy) -> str:
    """The shard-local (or fallback) flavour a policy runs: its own
    blocked/cuda strategy (``"pallas"`` read as ``cuda``), else the plain
    blocked schedule."""
    s = "cuda" if pol.strategy == "pallas" else pol.strategy
    return s if s in ("blocked", "cuda") else "blocked"


def _shard_mode_layout(mv: ModeView, pol: PhiPolicy, n_shards: int) -> tuple:
    """(strategy, layout) for one sharded mode: warn and fall back to the
    unsharded path (keeping the policy's blocked/cuda flavour) when the
    blocking leaves fewer row blocks than shards."""
    base = _blocked_layout(mv, pol)
    if n_shards > base.n_row_blocks:
        import warnings

        local = _local_of(pol)
        warnings.warn(
            f"sharded CP-APR mode {mv.mode}: {n_shards} shards requested but "
            f"the layout has only {base.n_row_blocks} row blocks; falling "
            f"back to the single-device {local} path for this mode",
            stacklevel=4,
        )
        return local, base
    return "sharded", shard_blocked_layout(base, n_shards)


def _grid_mode_layout(mv: ModeView, pol: PhiPolicy, n_shards: int,
                      grid_shape, rank: int, stats=None) -> tuple:
    """(strategy, layout, grid_shape) for one grid mode.

    ``grid_shape=None`` picks the (A, B) split from the mode's skew
    (:func:`choose_grid_shape`: hub modes take any wire saving, uniform
    modes need a decisive one, else the degenerate (S, 1) keeps the 1-D
    combine bitwise).  Warns and falls back to the single-device
    blocked/cuda path when the blocking cannot honour the grid.
    """
    import warnings

    base = _blocked_layout(mv, pol)
    shape = grid_shape
    if shape is None:
        shape = choose_grid_shape(mv.n_rows, pol.block_rows, rank, n_shards,
                                  stats=stats,
                                  itemsize=mv.sorted_vals.element_size())
    a, b = int(shape[0]), int(shape[1])
    local = _local_of(pol)
    if a > base.n_row_blocks:
        warnings.warn(
            f"grid CP-APR mode {mv.mode}: row axis {a} requested but the "
            f"layout has only {base.n_row_blocks} row blocks; falling back "
            f"to the single-device {local} path for this mode",
            stacklevel=4,
        )
        return local, base, None
    try:
        return "grid", build_grid_layout(base, (a, b)), (a, b)
    except ValueError as e:
        warnings.warn(
            f"grid CP-APR mode {mv.mode}: cannot honour grid {a}x{b} ({e}); "
            f"falling back to the single-device {local} path for this mode",
            stacklevel=4,
        )
        return local, base, None


def _dense_mode_data(mv: ModeView, shape) -> DenseModeData:
    """Densify one mode into its :class:`DenseModeData` (the dense tier's
    counterpart of a blocked layout), on the mode view's device."""
    return build_dense_mode(mv.sorted_idx, mv.sorted_vals, shape, mv.mode,
                            device=mv.sorted_vals.device)


def _mode_row_width(shape, n: int) -> int:
    """Cells per mode-``n`` row: the product of the other mode sizes (the
    denominator of the fill fraction that keys the dense-tier cut)."""
    return math.prod(int(d) for m, d in enumerate(shape) if m != n)


def _blocked_layout(mv: ModeView, pol: PhiPolicy) -> BlockedLayout:
    return build_blocked_layout(mv.rows.detach().cpu().numpy(), mv.n_rows,
                                pol.block_nnz, pol.block_rows)


def resolve_mode_policies(
    mvs: Sequence[ModeView],
    factors: Sequence[torch.Tensor],
    lam: torch.Tensor,
    *,
    rank: int,
    strategy: str,
    policy: "PhiPolicy | str | None" = None,
    autotuner: "object | None" = None,
    mesh: "object | None" = None,
    n_shards: "int | None" = None,
    combine: str = "auto",
    grid_shape: "tuple | None" = None,
    shape: "tuple | None" = None,
    device="cuda",
) -> tuple:
    """Per-mode ``(strategies, layouts, policies, locals)`` lists.

    The strategy resolver of both solvers (:func:`cpapr_mu` and
    :func:`repro_torch.core.cpals.cp_als`).  ``blocked``/``cuda`` modes
    get a :class:`BlockedLayout` with the explicit policy's block sizes,
    else :func:`default_policy`'s.  ``dense`` modes get their
    :class:`DenseModeData` in the layouts slot; they need the tensor's
    ``shape``.  ``sharded`` modes get a :class:`ShardedBlockedLayout` of
    ``mesh``'s size (else ``n_shards``, else every card of the process on
    the card and 1 on the CPU) from the policy's blocking (default 256 x
    :func:`repro_torch.core.phi._sharded_block_rows`), or warn and run
    unsharded with fewer row blocks than shards; ``locals`` holds each
    mode's shard-local flavour (``blocked`` or ``cuda``).  ``grid`` modes
    get a :class:`GridLayout` of ``grid_shape`` (else
    :func:`choose_grid_shape`'s per mode, from the mode's skew and the
    shard count), or warn and run unsharded when the mode cannot be
    gridded.

    ``policy="auto"`` asks the autotuner (``autotuner``, else a default
    :class:`repro_torch.perf.autotune.Autotuner`) per mode, from the
    mode's Π rows under ``factors`` and its ``B = A_n * lam``; a mode the
    tuner sends to the dense tier runs it while the others keep their
    sparse winners.  A sharded mode is tuned per shard
    (``Autotuner.policy_for_sharded_mode``, keyed on ``/shards=`` and the
    requested combine); a grid mode's row shards are tuned the same way
    and cached under ``/grid=AxB`` when ``B > 1``.  As in the JAX
    package, a served policy's
    strategy is adopted unchecked: an unknown one fails inside the mode's
    first update, where the degradation ladder's ``policy`` rung catches
    it when the caller has turned the ladder on.
    """
    dev = resolve_device(device)
    n_modes = len(mvs)
    layouts: list = [None] * n_modes
    policies: list = [None] * n_modes
    locals_: list = ["blocked"] * n_modes
    if policy != "auto":
        strategy = canonical_strategy(strategy)
    sharded = strategy == "sharded"
    grid = strategy == "grid"
    eff_combine = resolve_combine(combine, strategy)
    eff_shards = (_effective_shard_count(mesh, n_shards, dev)
                  if sharded or grid else 1)
    strategies = [strategy] * n_modes
    # per-mode (A, B): grid_shape pins it; None asks choose_grid_shape
    grid_shapes: list = [None] * n_modes

    def _pick_grid_shape(mv, stats_n):
        if grid_shape is not None:
            return tuple(int(x) for x in grid_shape)
        return choose_grid_shape(
            mv.n_rows, _sharded_block_rows(mv.n_rows, eff_shards), rank,
            eff_shards, stats=stats_n,
            itemsize=mv.sorted_vals.element_size())

    if policy == "auto":
        from ..perf.autotune import Autotuner  # deferred: avoids a cycle

        if shape is None or factors is None or lam is None:
            raise ValueError("policy='auto' needs the tensor's shape, the "
                             "factors and lam")
        tuner = autotuner if autotuner is not None else Autotuner()
        for n, mv in enumerate(mvs):
            pi_n = pi_rows(mv.sorted_idx, factors, n)
            b_n = factors[n] * lam[None, :]
            if grid:
                # the whole mode's skew picks the (A, B) split, which then
                # keys the row-shard tuning (/grid=AxB)
                stats_n = mode_run_stats(mv.rows.detach().cpu().numpy(),
                                         mv.n_rows,
                                         row_width=_mode_row_width(shape, n))
                grid_shapes[n] = _pick_grid_shape(mv, stats_n)
                pol, _ = tuner.policy_for_sharded_mode(
                    mv.rows, mv.sorted_vals, pi_n, b_n, n_rows=mv.n_rows,
                    rank=rank, n_shards=int(grid_shapes[n][0]),
                    combine=eff_combine, grid=grid_shapes[n],
                    n_modes=n_modes)
            elif sharded:
                # per-shard stats are computed on the shard slices inside
                # policy_for_sharded_mode
                pol, _ = tuner.policy_for_sharded_mode(
                    mv.rows, mv.sorted_vals, pi_n, b_n, n_rows=mv.n_rows,
                    rank=rank, n_shards=eff_shards, combine=eff_combine,
                    n_modes=n_modes)
            else:
                stats = mode_run_stats(mv.rows.detach().cpu().numpy(),
                                       mv.n_rows,
                                       row_width=_mode_row_width(shape, n))
                pol = tuner.policy_for_mode(
                    mv.rows, mv.sorted_vals, pi_n, b_n, n_rows=mv.n_rows,
                    rank=rank, stats=stats, n_modes=n_modes)
            policies[n] = pol
            strategies[n] = pol.strategy
            if pol.strategy == "dense":
                # the dense tier always runs unsharded: its densified mode
                # fits one device by construction
                layouts[n] = _dense_mode_data(mv, shape)
            elif pol.strategy in ("blocked", "cuda", "pallas"):
                locals_[n] = _local_of(pol)
                if grid:
                    strategies[n], layouts[n], grid_shapes[n] = \
                        _grid_mode_layout(mv, pol, eff_shards,
                                          grid_shapes[n], rank)
                elif sharded:
                    strategies[n], layouts[n] = _shard_mode_layout(
                        mv, pol, eff_shards)
                else:
                    layouts[n] = _blocked_layout(mv, pol)
        return strategies, layouts, policies, locals_
    if sharded or grid:
        for n, mv in enumerate(mvs):
            if isinstance(policy, PhiPolicy):
                pol = policy
            else:
                pol = PhiPolicy(
                    strategy="blocked", block_nnz=256,
                    block_rows=_sharded_block_rows(mv.n_rows, eff_shards))
            policies[n] = pol
            if canonical_strategy(pol.strategy) in ("blocked", "cuda"):
                locals_[n] = _local_of(pol)
                if grid:
                    stats_n = mode_run_stats(mv.rows.detach().cpu().numpy(),
                                             mv.n_rows)
                    strategies[n], layouts[n], grid_shapes[n] = \
                        _grid_mode_layout(mv, pol, eff_shards,
                                          _pick_grid_shape(mv, stats_n),
                                          rank)
                else:
                    strategies[n], layouts[n] = _shard_mode_layout(
                        mv, pol, eff_shards)
            else:  # an unblocked user policy has nothing to shard
                strategies[n] = canonical_strategy(pol.strategy)
        return strategies, layouts, policies, locals_
    if strategy == "dense":
        if shape is None:
            raise ValueError("strategy='dense' needs the tensor's shape")
        pol = policy if isinstance(policy, PhiPolicy) \
            else PhiPolicy(strategy="dense", block_nnz=8)
        for n, mv in enumerate(mvs):
            policies[n] = pol
            layouts[n] = _dense_mode_data(mv, shape)
    elif strategy in ("blocked", "cuda"):
        pol = policy if isinstance(policy, PhiPolicy) else default_policy(rank)
        for n, mv in enumerate(mvs):
            policies[n] = pol
            layouts[n] = _blocked_layout(mv, pol)
    return strategies, layouts, policies, locals_


def _restore_mode_layouts(mvs, strategies, policies, shape,
                          mode_shards=None, rb_bounds=None,
                          mode_grids=None) -> list:
    """Rebuild per-mode layouts exactly as checkpointed: tuned block sizes
    from the saved policies, densified dense-tier modes, sharded modes on
    their saved (possibly rebalanced) row-block cuts and grid modes on
    their saved ``[A, B]`` (``mode_grids``), so the resumed schedule is
    the killed run's."""
    layouts: list = [None] * len(mvs)
    rb_bounds = rb_bounds or {}
    for n, mv in enumerate(mvs):
        if strategies[n] == "grid":
            g = (mode_grids or [None] * len(mvs))[n]
            if g is None:
                raise resilience.CheckpointError(
                    f"checkpoint names strategy 'grid' for mode {n} but "
                    f"records no grid shape (mode_grids missing)")
            layouts[n] = build_grid_layout(
                _blocked_layout(mv, policies[n]), (int(g[0]), int(g[1])),
                bounds=rb_bounds.get(n))
        elif strategies[n] == "dense":
            layouts[n] = _dense_mode_data(mv, shape)
        elif strategies[n] == "sharded":
            layouts[n] = shard_blocked_layout(
                _blocked_layout(mv, policies[n]), int(mode_shards[n]),
                bounds=rb_bounds.get(n))
        elif strategies[n] in ("blocked", "cuda") and policies[n] is not None:
            layouts[n] = _blocked_layout(mv, policies[n])
    return layouts


def _hoisted_steps(mv: ModeView, cfg: CPAPRConfig, strategy: str, layout,
                   device: torch.device, factors, local_strategy: str,
                   pig: "ShardedPiGather | None") -> tuple:
    """The mode update's ``(phi, step)`` callables of B, over inputs
    hoisted once per mode update and shared by the scooch Φ and every
    fused inner iteration: the Π gather and its layout expansion, or for
    ``dense`` the kernel operands ``(x, c, a)`` with ``x`` cast to the
    tier's dtype (``layout`` is then the mode's DenseModeData)."""
    if strategy == "dense":
        from ..kernels.dense import ops as dense_ops

        x, c, a = _dense_operands(layout, factors, factors[mv.mode])

        def phi(b):
            return dense_ops.phi_dense(x, c, a, b, eps=cfg.eps)

        def step(b):
            mu, viol = dense_ops.phi_mu_dense(x, c, a, b, eps=cfg.eps)
            return torch.where(viol > cfg.tol, mu, b), viol

        return phi, step
    kw = dict(n_rows=mv.n_rows, eps=cfg.eps, strategy=strategy, layout=layout,
              device=device)
    if strategy == "sharded":
        kw.update(mesh=cfg.mesh, local_strategy=local_strategy,
                  pi_gather=pig, factors=factors if pig is not None else None)
    pi, vals_e, pi_e = hoisted_mode_inputs(mv, factors, strategy, layout, pig)

    def phi(b):
        return phi_from_rows(mv.rows, mv.sorted_vals, pi, b, vals_e=vals_e,
                             pi_e=pi_e, **kw)

    def step(b):
        return phi_mu_step(mv.rows, mv.sorted_vals, pi, b, tol=cfg.tol,
                           vals_e=vals_e, pi_e=pi_e, **kw)

    return phi, step


def _stacked_mode_update(mv: ModeView, cfg: CPAPRConfig, strategy: str,
                         layout, pig, stack, unstack, phi_own, step_own):
    """Per-mode solve on a stacked carry: the scooch and the fused inner
    MU loop run on ``stack``'s per-device slices of the factor, whose
    only per-iteration combine is the one inside ``step_own``; the factor
    is reassembled by ``unstack`` (gathered, under a mesh) and
    renormalized once, after the inner loop.  ``phi_own`` and
    ``step_own``, both ``(vals_e, pi_e, b_own, factors)``, are the
    stacked Φ and fused step."""
    n = mv.mode

    def update(factors, lam):
        with span(SWEEP_INPUTS):
            _, vals_e, pi_e = hoisted_mode_inputs(mv, factors, strategy,
                                                  layout, pig)

        # --- scooch: lift inadmissible zeros (Alg. 1 line 3), local
        with span(SWEEP_SCOOCH):
            a_own = stack(factors[n])
            lam_b = lam[None, None, :]
            phi0_own = phi_own(vals_e, pi_e, a_own * lam_b, factors)
            s = torch.where((a_own < cfg.kappa_tol) & (phi0_own > 1.0),
                            torch.full_like(a_own, cfg.kappa),
                            torch.zeros_like(a_own))
            b_own = (a_own + s) * lam_b

        # --- fused inner MU loop (Alg. 1 lines 5-8), stacked carry
        i, viol = 0, math.inf
        while i < cfg.max_inner and viol > cfg.tol:
            with span(SWEEP_STEP):
                b_own, viol_t = step_own(vals_e, pi_e, b_own, factors)
            with span(SWEEP_SYNC):  # decides the next iteration
                viol = float(viol_t)
            i += 1

        # --- renormalize (Alg. 1 lines 9-10) on the reassembled factor
        with span(SWEEP_RENORM):
            b = unstack(b_own)
            lam_new = torch.sum(b, dim=0)
            a_new = b / torch.clamp_min(lam_new, cfg.eps)
        return a_new, lam_new, viol, i

    return update


def _make_owner_mode_update(mv: ModeView, cfg: CPAPRConfig,
                            layout: ShardedBlockedLayout, local_strategy: str,
                            pig: "ShardedPiGather | None"):
    """Owner-partitioned per-mode solve (the reduce-scatter epilogue): the
    owner-stacked (S, own_rows, R) carry (under a mesh, this rank's
    (1, own_rows, R) slot), each inner iteration's only combine a
    reduce-scatter whose per-device output is the owned O(I_n * R / S)
    slice."""
    from .distributed import (  # deferred: avoids import cycle
        owner_stack,
        owner_unstack,
        phi_mu_sharded_owner,
        phi_sharded_owner,
    )

    mesh = cfg.mesh
    opart = owner_partition(layout)

    def kw(factors):
        return dict(eps=cfg.eps, mesh=mesh, local_strategy=local_strategy,
                    pi_gather=pig,
                    factors=factors if pig is not None else None)

    return _stacked_mode_update(
        mv, cfg, "sharded", layout, pig,
        stack=lambda a: owner_stack(opart, a, mesh),
        unstack=lambda b: owner_unstack(opart, b, mesh),
        phi_own=lambda v, p, b, f: phi_sharded_owner(layout, opart, v, p, b,
                                                     **kw(f)),
        step_own=lambda v, p, b, f: phi_mu_sharded_owner(
            layout, opart, v, p, b, tol=cfg.tol, **kw(f)))


def _make_grid_mode_update(mv: ModeView, cfg: CPAPRConfig,
                           glayout: GridLayout, local_strategy: str):
    """Grid-partitioned per-mode solve (the N-D combine epilogue): the
    grid-stacked (A*B, sub_rows, R) carry (under a mesh, this rank's
    (1, sub_rows, R) cell), each inner iteration's only combine the
    column all-gather + reduce-scatter pair: ``2 (B-1) * sub_rows * R``
    wire per device, O(I_n * R / A)."""
    from .distributed import (  # deferred: avoids import cycle
        grid_stack,
        grid_unstack,
        phi_grid_owner,
        phi_mu_grid_owner,
    )

    mesh = cfg.mesh
    kw = dict(eps=cfg.eps, mesh=mesh, local_strategy=local_strategy)
    return _stacked_mode_update(
        mv, cfg, "grid", glayout, None,
        stack=lambda a: grid_stack(glayout, a, mesh),
        unstack=lambda b: grid_unstack(glayout, b, mesh),
        phi_own=lambda v, p, b, f: phi_grid_owner(glayout, v, p, b, **kw),
        step_own=lambda v, p, b, f: phi_mu_grid_owner(
            glayout, v, p, b, tol=cfg.tol, **kw))


def _make_mode_update(mv: ModeView, cfg: CPAPRConfig, strategy: str,
                      layout: "BlockedLayout | ShardedBlockedLayout | DenseModeData | None",
                      device: torch.device, local_strategy: str = "blocked",
                      pig: "ShardedPiGather | None" = None):
    """Per-mode solve: ``update(factors, lam) -> (A_n', lam', viol,
    n_inner)`` with ``viol`` a host float and ``n_inner`` an int.  A
    sharded mode whose effective combine is the reduce-scatter runs
    :func:`_make_owner_mode_update`'s owner-stacked loop; with ``pig``
    (``shard_pi``) no (nnz, R) Π is built: each shard gathers the factor
    rows its nonzeros touch and rebuilds its Π rows per inner iteration.
    A grid mode runs :func:`_make_grid_mode_update`'s grid-stacked loop."""
    n = mv.mode
    if strategy == "grid" and isinstance(layout, GridLayout):
        return _make_grid_mode_update(mv, cfg, layout, local_strategy)
    if (strategy == "sharded" and isinstance(layout, ShardedBlockedLayout)
            and effective_mode_combine(
                cfg.combine, strategy, layout, cfg.rank,
                itemsize=mv.sorted_vals.element_size()) == "reduce_scatter"):
        return _make_owner_mode_update(mv, cfg, layout, local_strategy, pig)

    def update(factors, lam):
        a_n = factors[n]
        with span(SWEEP_INPUTS):
            phi, step = _hoisted_steps(mv, cfg, strategy, layout, device,
                                       factors, local_strategy, pig)

        # --- scooch: lift inadmissible zeros (Alg. 1 line 3) --------------
        with span(SWEEP_SCOOCH):
            phi0 = phi(a_n * lam[None, :])
            s = torch.where((a_n < cfg.kappa_tol) & (phi0 > 1.0),
                            torch.full_like(a_n, cfg.kappa),
                            torch.zeros_like(a_n))
            b = (a_n + s) * lam[None, :]

        # --- fused inner MU loop (Alg. 1 lines 5-8) ------------------------
        i, viol = 0, math.inf
        while i < cfg.max_inner and viol > cfg.tol:
            with span(SWEEP_STEP):
                b, viol_t = step(b)
            with span(SWEEP_SYNC):  # decides the next iteration
                viol = float(viol_t)
            i += 1

        # --- renormalize (Alg. 1 lines 9-10) -------------------------------
        with span(SWEEP_RENORM):
            lam_new = torch.sum(b, dim=0)
            a_new = b / torch.clamp_min(lam_new, cfg.eps)
        return a_new, lam_new, viol, i

    return update


def _reference_name(strategy: str) -> str:
    return _REFERENCE_NAME.get(strategy, strategy)


def _ckpt_fingerprint(t: SparseTensor, cfg: CPAPRConfig) -> str:
    """Problem/config fingerprint a checkpoint must match to be resumed.

    Exactly the JAX package's fields and values, so a checkpoint resumes
    across the packages (``cuda`` hashes as its JAX name ``pallas``).
    """
    return resilience.config_fingerprint({
        "shape": [int(s) for s in t.shape],
        "nnz": int(t.nnz),
        "rank": int(cfg.rank),
        "max_inner": int(cfg.max_inner),
        "tol": float(cfg.tol),
        "eps": float(cfg.eps),
        "kappa": float(cfg.kappa),
        "kappa_tol": float(cfg.kappa_tol),
        "strategy": _reference_name(cfg.strategy),
        "combine": cfg.combine,
        "shard_pi": bool(cfg.shard_pi),
        "grid_shape": [int(x) for x in cfg.grid_shape]
        if cfg.grid_shape is not None else None,
    })


def _load_resume_state(path: str, fp: str, recoveries: list) -> "dict | None":
    """The verified state of checkpoint ``path``, or None after
    quarantining a corrupt or mismatched file (recorded in
    ``recoveries``)."""
    try:
        state = resilience.load_checkpoint(path)
        if state.get("fingerprint") != fp:
            raise resilience.CheckpointError(
                f"{path}: checkpoint fingerprint "
                f"{state.get('fingerprint')!r} does not match this "
                f"problem/config ({fp!r})")
    except resilience.CheckpointError as e:
        qpath = resilience.quarantine_checkpoint(path)
        recoveries.append(RecoveryEvent(
            "checkpoint_corrupt", outer=0,
            detail={"error": str(e), "quarantined": qpath}))
        return None
    state["strategies"] = [canonical_strategy(s)
                           for s in state["strategies"]]
    state["locals"] = [canonical_strategy(s)
                       for s in state.get("locals")
                       or ["blocked"] * len(state["strategies"])]
    return state


def cpapr_mu(
    t: SparseTensor,
    rank: int,
    seed: int | None = None,
    init: KTensor | None = None,
    config: CPAPRConfig | None = None,
    mode_views: Sequence[ModeView] | None = None,
    resume_from: str | None = None,
    device="cuda",
) -> CPAPRResult:
    """Run CP-APR MU on ``device``.  Returns the fitted KTensor + stats.

    ``init`` (a KTensor, e.g. from :mod:`repro_torch.core.convert`) is the
    starting model; without it one is drawn from ``seed`` (default 0).
    ``t`` and ``init`` are moved to ``device`` if they lie elsewhere.
    ``resume_from`` continues a checkpointed solve (see
    ``CPAPRConfig.checkpoint_every``); a corrupt or mismatched checkpoint
    is quarantined (recorded in ``result.recoveries``) and the solve
    starts fresh instead of dying.
    """
    dev = resolve_device(device)
    cfg = config or CPAPRConfig(rank=rank)
    if cfg.rank != rank:
        raise ValueError(f"cpapr_mu: rank={rank} but config.rank={cfg.rank}")
    canonical_strategy(cfg.strategy)  # an unknown one raises before any work
    t = t.to(dev)
    if cfg.validate:
        with span(PREP_VALIDATE):
            resilience.validate_decomposition_inputs(t, rank,
                                                     where="cpapr_mu")
    n_modes = t.ndim
    if init is None:
        init = random_ktensor(0 if seed is None else seed, t.shape, rank,
                              device=dev)
    kt = init.to(dev).normalize()
    factors = list(kt.factors)
    lam = kt.lam

    with span(PREP_SORT):
        mvs = list(mode_views) if mode_views is not None else [
            sort_mode(t, n) for n in range(n_modes)
        ]
    recoveries: list = []
    fp = _ckpt_fingerprint(t, cfg)
    resume_state = None
    if resume_from is not None:
        resume_state = _load_resume_state(resume_from, fp, recoveries)

    start_outer = 0
    kkt_hist: list = []
    ll_hist: list = []
    inner_hist: list = []
    rebalances: list = []
    if resume_state is None:
        with span(PREP_LAYOUT):
            strategies, layouts, policies, locals_ = resolve_mode_policies(
                mvs, factors, lam, rank=rank, strategy=cfg.strategy,
                policy=cfg.policy, shape=t.shape,
                autotuner=cfg.autotuner, mesh=cfg.mesh,
                n_shards=cfg.n_shards, combine=cfg.combine,
                grid_shape=cfg.grid_shape, device=dev)
        # per-mode effective config: the kappa ladder and the combine
        # demotion mutate these without touching the caller's cfg
        mode_cfgs = [cfg] * n_modes
    else:
        start_outer = int(resume_state["outer"])
        factors = [resilience.array_to_tensor(f, dev)
                   for f in resume_state["factors"]]
        lam = resilience.array_to_tensor(resume_state["lam"], dev)
        strategies = list(resume_state["strategies"])
        locals_ = list(resume_state["locals"])
        policies = [policy_from_dict(p) if p else None
                    for p in resume_state["policies"]]
        rb_bounds = {int(k): v
                     for k, v in resume_state.get("rb_bounds", {}).items()}
        layouts = _restore_mode_layouts(
            mvs, strategies, policies, t.shape,
            list(resume_state["mode_shards"]), rb_bounds,
            resume_state.get("mode_grids"))
        # the per-mode kappa ladder and combine demotions, so the resumed
        # trajectory matches the killed run even mid-recovery
        mode_cfgs = [dataclasses.replace(cfg, kappa=float(k), combine=c)
                     for k, c in zip(resume_state["kappas"],
                                     resume_state["combines"])]
        kkt_hist = list(resume_state["kkt_history"])
        ll_hist = list(resume_state["loglik_history"])
        inner_hist = list(resume_state["inner_iters"])
        rebalances = list(resume_state.get("rebalances") or [])
        recoveries.extend(RecoveryEvent(**r)
                          for r in resume_state.get("recoveries", []))
        recoveries.append(RecoveryEvent(
            "resume", outer=start_outer, detail={"path": resume_from}))

    with span(PREP_LAYOUT):
        pigs = [mode_pi_gather(mvs[n], layouts[n], cfg.shard_pi)
                for n in range(n_modes)]
        updates = [_make_mode_update(mvs[n], mode_cfgs[n], strategies[n],
                                     layouts[n], dev, locals_[n], pigs[n])
                   for n in range(n_modes)]

    def _rebuild(n: int) -> None:
        """Re-derive mode ``n``'s gather maps and update from its current
        layout, strategy and per-mode config."""
        pigs[n] = mode_pi_gather(mvs[n], layouts[n], cfg.shard_pi)
        updates[n] = _make_mode_update(mvs[n], mode_cfgs[n], strategies[n],
                                       layouts[n], dev, locals_[n], pigs[n])

    def _ctx(outer: int, n: int) -> dict:
        sl = layouts[n]
        multi = isinstance(sl, (ShardedBlockedLayout, GridLayout))
        ctx = {"outer": outer, "mode": n, "strategy": strategies[n],
               "local": locals_[n] if multi else strategies[n],
               "combine": mode_cfgs[n].combine,
               "n_shards": int(sl.n_shards) if multi else 1}
        if isinstance(sl, GridLayout):
            ctx["grid"] = (int(sl.grid_a), int(sl.grid_b))
        return ctx

    def _invoke(outer: int, n: int, factors, lam):
        """One raw mode-update attempt: fault hooks, the update, the
        post-update hooks, then the guard."""
        ctx = _ctx(outer, n)
        if resilience.have_hooks():
            resilience.fire_mode_hooks(ctx)
        a_new, lam_new, viol, n_inner = updates[n](factors, lam)
        if resilience.have_post_update_hooks():
            a_new, lam_new = resilience.apply_post_update_hooks(
                ctx, a_new, lam_new)
        ok = None
        if cfg.guard:
            with span(SWEEP_GUARD):
                ok = resilience.guard_ok(a_new, lam_new)
        return a_new, lam_new, viol, n_inner, ok

    def _demote_sharded(n: int, kind: str) -> "str | None":
        """The multi-device rungs of a sharded mode: the action label, or
        None when no rung applies."""
        sl = layouts[n]
        if kind in ("kernel", "policy"):
            if locals_[n] == "cuda":
                locals_[n] = "blocked"
                return "local cuda->blocked"
            # the shard-local blocked schedule failed too: leave the
            # sharded family for the streaming segment path
            strategies[n], layouts[n], locals_[n] = "segment", None, "blocked"
            return "sharded->segment"
        if kind == "fingerprint":
            if mode_cfgs[n].combine == "psum":
                return None
            old = mode_cfgs[n].combine
            mode_cfgs[n] = dataclasses.replace(mode_cfgs[n], combine="psum")
            return f"combine {old}->psum"
        if kind == "oom":
            new_s = sl.n_shards // 2
            # on a process-group mesh every rank holds one shard, and no
            # smaller mesh can be formed inside the group: the ladder goes
            # straight to the single-device local path there
            if new_s <= 1 or mode_cfgs[n].mesh is not None:
                strategies[n], layouts[n] = locals_[n], sl.base
                return f"sharded@{sl.n_shards}->single-device {locals_[n]}"
            layouts[n] = rebalance_shards(shard_blocked_layout(sl.base,
                                                               new_s))
            return f"shards {sl.n_shards}->{new_s}"
        return None

    def _grid_to_1d(n: int) -> str:
        """The grid -> 1-D rung (STRATEGY_DEMOTION["grid"]): keep the row
        shard split, drop the column axis.  Under a grid mesh the 1-D
        path runs on its ``"row"`` sub-mesh (every column then computes
        the same sharded result).  A single-row-shard grid leaves the
        multi-device family for the single-device local path."""
        sl = layouts[n]
        if sl.grid_a > 1:
            strategies[n], layouts[n] = "sharded", sl.slayout
            if mode_cfgs[n].mesh is not None:
                mode_cfgs[n] = dataclasses.replace(
                    mode_cfgs[n], mesh=mode_cfgs[n].mesh["row"])
            return (f"grid {sl.grid_a}x{sl.grid_b}->"
                    f"{STRATEGY_DEMOTION['grid']}@{sl.grid_a}")
        strategies[n], layouts[n] = locals_[n], sl.slayout.base
        return f"grid 1x{sl.grid_b}->single-device {locals_[n]}"

    def _demote_grid(n: int, kind: str) -> "str | None":
        """The grid mode's rungs: a kernel or policy failure first demotes
        the cell-local cuda -> blocked, then the grid -> 1-D rung; an OOM
        takes the grid -> 1-D rung at once (the replicated B window
        shrinks to the owned slice), further OOMs then halve the shards."""
        if kind in ("kernel", "policy") and locals_[n] == "cuda":
            locals_[n] = "blocked"
            return "local cuda->blocked"
        if kind in ("kernel", "policy", "oom"):
            return _grid_to_1d(n)
        return None

    def _demote(n: int, kind: str, exc: BaseException) -> "dict | None":
        """Take one degradation-ladder rung for mode ``n``; returns the
        recovery detail, or None when no rung applies (the error then
        propagates)."""
        detail = {"error": f"{type(exc).__name__}: {exc}"[:200]}
        if strategies[n] == "grid" and isinstance(layouts[n], GridLayout):
            action = _demote_grid(n, kind)
            if action is None:
                return None
            detail["action"] = action
            return detail
        if strategies[n] == "sharded" \
                and isinstance(layouts[n], ShardedBlockedLayout):
            action = _demote_sharded(n, kind)
            if action is None:
                return None
            detail["action"] = action
            return detail
        if kind not in ("kernel", "policy"):
            return None
        old = strategies[n]
        if old in STRATEGY_DEMOTION:
            new = STRATEGY_DEMOTION[old]
        elif kind == "policy" and old != "segment":
            # e.g. a poisoned autotune entry naming a strategy that does
            # not exist: fall to the always-available baseline
            new = "segment"
        else:
            return None
        if old == "dense":
            # a dense launch that started and did not complete leaves its
            # stream's tickets dirty: no later dense call may reuse them
            from ..kernels.dense.kernel import drop_workspace

            drop_workspace(dev)
        strategies[n] = new
        if new not in ("blocked", "cuda"):
            layouts[n] = None
        detail["action"] = f"{old}->{new}"
        return detail

    def _nnz_imbalance(sl: ShardedBlockedLayout) -> float:
        mean = float(sl.shard_nnz.mean())
        return float(sl.shard_nnz.max()) / max(mean, 1.0)

    def _rebalance_modes(outer: int, events: list) -> None:
        """nnz-weighted boundary re-split of every sharded mode.

        Only the block->shard assignment moves; the base schedule (and the
        tuned block sizes) stay pinned.  Modes whose boundaries changed
        rebuild their Π gather maps and update.  With a *non-measuring*
        autotuner the new shard sub-problems are re-keyed under
        assignment-aware keys (``/assign=``), so future cold starts of this
        assignment hit; a measuring tuner is skipped, since timed probes
        inside the solve would stall it.
        """
        tuner = cfg.autotuner if cfg.policy == "auto" else None
        rekey = tuner is not None and not getattr(tuner, "measure", True)
        for n in range(n_modes):
            sl = layouts[n]
            if not isinstance(sl, ShardedBlockedLayout):
                continue
            new_sl = rebalance_shards(sl)
            if np.array_equal(new_sl.rb_start, sl.rb_start):
                continue
            if rekey:
                # a non-measuring tuner never probes, so pi=None: no
                # (nnz, R) array is built
                mv = mvs[n]
                cuts = shard_stream_cuts(new_sl,
                                         mv.rows.detach().cpu().numpy())
                tuner.policy_for_sharded_mode(
                    mv.rows, mv.sorted_vals, None, factors[n] * lam[None, :],
                    n_rows=mv.n_rows, rank=cfg.rank,
                    n_shards=new_sl.n_shards, cuts=cuts,
                    combine=resolve_combine(cfg.combine, strategies[n]))
            events.append({
                "outer": outer,
                "mode": n,
                "rb_start_old": [int(x) for x in sl.rb_start],
                "rb_start_new": [int(x) for x in new_sl.rb_start],
                "imbalance_old": round(_nnz_imbalance(sl), 4),
                "imbalance_new": round(_nnz_imbalance(new_sl), 4),
            })
            layouts[n] = new_sl
            _rebuild(n)

    def _run_mode(outer: int, n: int, factors, lam):
        """Mode update under the degradation ladder: classified runtime
        failures demote one rung and retry with bounded backoff."""
        for attempt in range(cfg.max_demotions + 1):
            try:
                return _invoke(outer, n, factors, lam)
            except Exception as e:
                kind = resilience.classify_failure(e)
                if kind is None or attempt >= cfg.max_demotions:
                    raise
                detail = _demote(n, kind, e)
                if detail is None:
                    raise
                recoveries.append(RecoveryEvent(
                    f"demote_{kind}", outer=outer, mode=n, attempt=attempt,
                    detail=detail))
                resilience.backoff_sleep(
                    attempt, cfg.demote_backoff if kind == "oom" else 0.0)
                _rebuild(n)
        raise AssertionError("unreachable")  # pragma: no cover

    def _write_checkpoint(n_outer: int) -> None:
        if cfg.mesh is not None and torch.distributed.get_rank() != 0:
            return  # every rank holds the same state: rank 0 writes it
        rb_bounds: dict = {}
        shards: list = []
        grids: list = []
        locals_out: list = []
        for n in range(n_modes):
            sl = layouts[n]
            grids.append([int(sl.grid_a), int(sl.grid_b)]
                         if isinstance(sl, GridLayout) else None)
            if isinstance(sl, GridLayout):
                # the 1-D row cuts the grid refines and its (A, B): resume
                # rebuilds the same cell schedule
                rb_bounds[str(n)] = ([int(x) for x in sl.slayout.rb_start]
                                     + [int(sl.slayout.base.n_row_blocks)])
                shards.append(int(sl.grid_a))
                locals_out.append(_reference_name(locals_[n]))
            elif isinstance(sl, ShardedBlockedLayout):
                rb_bounds[str(n)] = ([int(x) for x in sl.rb_start]
                                     + [int(sl.base.n_row_blocks)])
                shards.append(int(sl.n_shards))
                locals_out.append(_reference_name(locals_[n]))
            else:
                shards.append(1)
                s = strategies[n]
                locals_out.append(_reference_name(s)
                                  if s in ("blocked", "cuda") else "blocked")
        resilience.save_checkpoint(cfg.checkpoint_path, {
            "fingerprint": fp,
            "outer": int(n_outer),
            "kkt_history": kkt_hist,
            "loglik_history": ll_hist,
            "inner_iters": inner_hist,
            "rebalances": rebalances,
            "recoveries": [dataclasses.asdict(r) for r in recoveries],
            "policies": [
                None if p is None else dict(
                    dataclasses.asdict(p),
                    strategy=_reference_name(p.strategy))
                for p in policies],
            "strategies": [_reference_name(s) for s in strategies],
            "locals": locals_out,
            "combines": [mc.combine for mc in mode_cfgs],
            "kappas": [float(mc.kappa) for mc in mode_cfgs],
            "mode_shards": shards,
            "mode_grids": grids,
            "rb_bounds": rb_bounds,
            "lam": lam,
            "factors": factors,
        })

    sweep_secs: list = []
    converged = False
    t0 = time.perf_counter()
    n_outer = start_outer
    k = start_outer
    while k < cfg.max_outer:
        n_outer = k + 1
        ts = time.perf_counter()
        # sweep-start snapshot: the guards restore it (and redo the whole
        # sweep) when any mode's state went numerically bad
        snap_factors, snap_lam = list(factors), lam
        ll = None
        for sweep_attempt in range(cfg.guard_retries + 1):
            out = sweep_step((factors, lam),
                             [partial(_run_mode, n_outer, n)
                              for n in range(n_modes)],
                             guard=cfg.guard)
            factors, lam, bad = out.factors, out.lam, out.bad
            worst = float(out.worst) if out.worst is not None else 0.0
            inner_total = int(out.inner_total)
            if not bad:
                if cfg.track_loglik:
                    with span(SWEEP_LOGLIK):
                        ll_t = poisson_loglik(t, KTensor(lam, tuple(factors)),
                                              cfg.eps)
                    with span(SWEEP_SYNC):
                        ll = float(ll_t)
                if not cfg.guard or ll is None or math.isfinite(ll):
                    break
                # whole-sweep guard: per-mode states passed but the joint
                # model mass went non-finite — escalate every mode
                recoveries.append(RecoveryEvent(
                    "loglik_guard", outer=n_outer, attempt=sweep_attempt,
                    detail={"loglik": ll}))
                bad = list(range(n_modes))
            else:
                for n in bad:
                    recoveries.append(RecoveryEvent(
                        "nan_guard", outer=n_outer, mode=n,
                        attempt=sweep_attempt,
                        detail={"kappa": float(mode_cfgs[n].kappa)}))
            # restore last-good state and redo the sweep.  The first retry
            # reruns as-is (transient fault); later retries climb the kappa
            # ladder on the offending modes.
            factors, lam = list(snap_factors), snap_lam
            if sweep_attempt >= 1:
                for n in bad:
                    mode_cfgs[n] = dataclasses.replace(
                        mode_cfgs[n], kappa=min(mode_cfgs[n].kappa * 10.0, 1.0))
                    _rebuild(n)
        else:
            raise FloatingPointError(
                f"CP-APR sweep {n_outer}: non-finite or negative state "
                f"persisted through {cfg.guard_retries} guarded sweep "
                f"retries (mode(s) {bad})"
            )
        if cfg.guard and sweep_attempt > 0:
            # recovery done: drop any escalated scooch back to the
            # configured kappa
            for n in range(n_modes):
                if mode_cfgs[n].kappa != cfg.kappa:
                    mode_cfgs[n] = dataclasses.replace(mode_cfgs[n],
                                                       kappa=cfg.kappa)
                    _rebuild(n)
        kkt_hist.append(worst)
        inner_hist.append(inner_total)
        sweep_secs.append(time.perf_counter() - ts)
        if ll is not None:
            ll_hist.append(ll)
        if worst <= cfg.tol:
            converged = True
            break
        if (cfg.rebalance_every > 0 and n_outer % cfg.rebalance_every == 0
                and n_outer < cfg.max_outer):
            _rebalance_modes(n_outer, rebalances)
        if (cfg.checkpoint_every > 0 and cfg.checkpoint_path
                and n_outer % cfg.checkpoint_every == 0):
            _write_checkpoint(n_outer)
        k += 1
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    return CPAPRResult(
        ktensor=KTensor(lam=lam, factors=tuple(factors)),
        n_outer=n_outer,
        kkt_history=kkt_hist,
        loglik_history=ll_hist,
        inner_iters=inner_hist,
        converged=converged,
        seconds=seconds,
        sweep_seconds=sweep_secs,
        policies=policies if any(p is not None for p in policies) else None,
        rebalances=rebalances or None,
        recoveries=recoveries or None,
    )
