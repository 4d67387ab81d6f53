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
package's ``lax.while_loop``.

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

This slice of the port runs on one device: ``mesh``, ``n_shards``,
``grid_shape``, ``rebalance_every`` and the ``sharded``/``grid``
strategies raise ``NotImplementedError`` (ROADMAP A8) before anything
runs, so the ladder never sees them.
"""
from __future__ import annotations

import dataclasses
import math
import time
from functools import partial
from typing import Sequence

import torch

from ..device import resolve_device
from . import resilience
from .convert import policy_from_dict
from .dense import DenseModeData, build_dense_mode
from .layout import BlockedLayout, ModeStats, build_blocked_layout, mode_run_stats
from .phi import (
    _dense_operands,
    canonical_strategy,
    expand_to_layout,
    phi_from_rows,
    phi_mu_step,
)
from .pi import pi_rows
from .policy import PhiPolicy, default_policy
from .resilience import STRATEGY_DEMOTION, NotPortedError, RecoveryEvent
from .sparse_tensor import KTensor, ModeView, SparseTensor, random_ktensor, sort_mode

__all__ = [
    "CPAPRConfig",
    "CPAPRResult",
    "ModeCutout",
    "SweepOutcome",
    "cpapr_mu",
    "extract_mode_cutout",
    "hoisted_mode_inputs",
    "kkt_violation",
    "poisson_loglik",
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
    # multi-device fields of the JAX package: not ported yet, must stay unset
    mesh: "object | None" = None
    n_shards: "int | None" = None
    grid_shape: "tuple | None" = None
    rebalance_every: int = 0
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
    # (cuda -> blocked -> segment, dense -> segment), each retried after
    # bounded exponential backoff (demote_backoff * 2^attempt, capped), at
    # most max_demotions rungs per mode invocation.  Off by default (the
    # JAX package takes 4 rungs after 0.05 s): a kernel that fails to
    # build or launch is then an error, never a run of its plain version
    # on the card.  Every failure the ladder demotes on one device is
    # deterministic and the retry runs another strategy, so waiting
    # changes nothing here.
    demote_backoff: float = 0.0
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
    # per outer iter run in this process: host seconds of the sweep
    sweep_seconds: list
    policies: list | None = None  # per-mode PhiPolicy, blocked/cuda/dense
    # RecoveryEvents (numerical-guard restores, degradation-ladder
    # demotions, checkpoint quarantine/resume), in order
    recoveries: list | None = None


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
            bad = [m for m in range(n)
                   if ok_flags[m] is not None and not bool(ok_flags[m])] \
                or [n]
            break
        factors[n] = a_new
        lam = lam_new
        ok_flags[n] = ok
        worst = viol if worst is None else torch.maximum(worst, viol)
        inner_total = inner_total + _as_tensor(n_inner)
    if guard and not bad:
        bad = [n for n in range(n_modes)
               if ok_flags[n] is not None and not bool(ok_flags[n])]
    return SweepOutcome(factors=factors, lam=lam, worst=worst,
                        inner_total=inner_total, bad=bad)


def hoisted_mode_inputs(mv: ModeView, factors, strategy: str, layout) -> tuple:
    """Per-mode-update hoisted inputs ``(pi, vals_e, pi_e)``: one Π gather
    and, for the blocked schedules, one layout expansion per mode update."""
    pi = pi_rows(mv.sorted_idx, factors, mv.mode)
    if strategy in ("blocked", "cuda") and layout is not None:
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
    *,
    rank: int,
    strategy: str,
    policy: "PhiPolicy | str | None" = None,
    shape: "tuple | None" = None,
    factors: "Sequence[torch.Tensor] | None" = None,
    lam: "torch.Tensor | None" = None,
    autotuner: "object | None" = None,
) -> tuple:
    """Per-mode ``(strategies, layouts, policies)`` lists.

    The strategy resolver of both solvers (:func:`cpapr_mu` and
    :func:`repro_torch.core.cpals.cp_als`).  ``blocked``/``cuda`` modes
    get a :class:`BlockedLayout` with the explicit policy's block sizes,
    else :func:`default_policy`'s.  ``dense`` modes get their
    :class:`DenseModeData` in the layouts slot; they need the tensor's
    ``shape``.

    ``policy="auto"`` asks the autotuner (``autotuner``, else a default
    :class:`repro_torch.perf.autotune.Autotuner`) per mode, from the
    mode's Π rows under ``factors`` and its ``B = A_n * lam``; a mode the
    tuner sends to the dense tier runs it while the others keep their
    sparse winners.  As in the JAX package, a served policy's strategy is
    adopted unchecked: an unknown one fails inside the mode's first
    update, where the degradation ladder's ``policy`` rung catches it
    when the caller has turned the ladder on.
    """
    n_modes = len(mvs)
    layouts: list = [None] * n_modes
    policies: list = [None] * n_modes
    if policy == "auto":
        from ..perf.autotune import Autotuner  # deferred: avoids a cycle

        if shape is None or factors is None or lam is None:
            raise ValueError("policy='auto' needs the tensor's shape, the "
                             "factors and lam")
        tuner = autotuner if autotuner is not None else Autotuner()
        strategies = [strategy] * n_modes
        for n, mv in enumerate(mvs):
            stats = mode_run_stats(mv.rows.detach().cpu().numpy(), mv.n_rows,
                                   row_width=_mode_row_width(shape, n))
            pol = tuner.policy_for_mode(
                mv.rows, mv.sorted_vals, pi_rows(mv.sorted_idx, factors, n),
                factors[n] * lam[None, :], n_rows=mv.n_rows, rank=rank,
                stats=stats, n_modes=n_modes)
            policies[n] = pol
            strategies[n] = pol.strategy
            if pol.strategy == "dense":
                layouts[n] = _dense_mode_data(mv, shape)
            elif pol.strategy in ("blocked", "cuda"):
                layouts[n] = _blocked_layout(mv, pol)
        return strategies, layouts, policies
    strategy = canonical_strategy(strategy)
    strategies = [strategy] * n_modes
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
    return strategies, layouts, policies


def _restore_mode_layouts(mvs, strategies, policies, shape) -> list:
    """Rebuild per-mode layouts exactly as checkpointed (tuned block
    sizes from the saved policies, densified dense-tier modes), so the
    resumed schedule is the killed run's."""
    layouts: list = [None] * len(mvs)
    for n, mv in enumerate(mvs):
        if strategies[n] == "dense":
            layouts[n] = _dense_mode_data(mv, shape)
        elif strategies[n] in ("blocked", "cuda") and policies[n] is not None:
            layouts[n] = _blocked_layout(mv, policies[n])
    return layouts


def _hoisted_steps(mv: ModeView, cfg: CPAPRConfig, strategy: str, layout,
                   device: torch.device, factors) -> tuple:
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
    pi, vals_e, pi_e = hoisted_mode_inputs(mv, factors, strategy, layout)

    def phi(b):
        return phi_from_rows(mv.rows, mv.sorted_vals, pi, b, vals_e=vals_e,
                             pi_e=pi_e, **kw)

    def step(b):
        return phi_mu_step(mv.rows, mv.sorted_vals, pi, b, tol=cfg.tol,
                           vals_e=vals_e, pi_e=pi_e, **kw)

    return phi, step


def _make_mode_update(mv: ModeView, cfg: CPAPRConfig, strategy: str,
                      layout: "BlockedLayout | DenseModeData | None",
                      device: torch.device):
    """Per-mode solve: ``update(factors, lam) -> (A_n', lam', viol,
    n_inner)`` with ``viol`` a host float and ``n_inner`` an int."""
    n = mv.mode

    def update(factors, lam):
        a_n = factors[n]
        phi, step = _hoisted_steps(mv, cfg, strategy, layout, device, factors)

        # --- scooch: lift inadmissible zeros (Alg. 1 line 3) --------------
        phi0 = phi(a_n * lam[None, :])
        s = torch.where((a_n < cfg.kappa_tol) & (phi0 > 1.0),
                        torch.full_like(a_n, cfg.kappa),
                        torch.zeros_like(a_n))
        b = (a_n + s) * lam[None, :]

        # --- fused inner MU loop (Alg. 1 lines 5-8) ------------------------
        i, viol = 0, math.inf
        while i < cfg.max_inner and viol > cfg.tol:
            b, viol_t = step(b)
            viol = float(viol_t)  # host sync: decides the next iteration
            i += 1

        # --- renormalize (Alg. 1 lines 9-10) -------------------------------
        lam_new = torch.sum(b, dim=0)
        a_new = b / torch.clamp_min(lam_new, cfg.eps)
        return a_new, lam_new, viol, i

    return update


def _check_supported(cfg: CPAPRConfig) -> None:
    """Raise :class:`NotPortedError` for every multi-device option, before
    anything runs: the ladder must never "demote" one into a run."""
    unported = {
        "mesh": cfg.mesh is not None,
        "n_shards": cfg.n_shards is not None,
        "grid_shape": cfg.grid_shape is not None,
        "rebalance_every": cfg.rebalance_every != 0,
    }
    for name, is_set in unported.items():
        if is_set:
            raise NotPortedError(f"cpapr_mu: {name} is not ported yet: "
                                 f"ROADMAP A8 (multi-device)")
    canonical_strategy(cfg.strategy)  # sharded/grid raise here


def _reference_name(strategy: str) -> str:
    return _REFERENCE_NAME.get(strategy, strategy)


def _ckpt_fingerprint(t: SparseTensor, cfg: CPAPRConfig) -> str:
    """Problem/config fingerprint a checkpoint must match to be resumed.

    Exactly the JAX package's fields and values, so a checkpoint resumes
    across the packages: the port has no ``combine``, ``shard_pi`` or
    ``grid_shape`` field and hashes the JAX package's defaults, and
    ``cuda`` hashes as its JAX name ``pallas``.
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
        "combine": "auto",
        "shard_pi": True,
        "grid_shape": None,
    })


def _load_resume_state(path: str, fp: str, recoveries: list) -> "dict | None":
    """The verified state of checkpoint ``path``, or None after
    quarantining a corrupt or mismatched file (recorded in
    ``recoveries``).  A sound checkpoint of sharded or grid modes raises
    :class:`NotPortedError` and stays where it is."""
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
    if any(int(s) > 1 for s in state.get("mode_shards", [])):
        raise NotPortedError(f"{path}: the checkpoint's modes are sharded, "
                             f"which is not ported yet: ROADMAP A8")
    state["strategies"] = [canonical_strategy(s)
                           for s in state["strategies"]]
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
    _check_supported(cfg)
    t = t.to(dev)
    if cfg.validate:
        resilience.validate_decomposition_inputs(t, rank, where="cpapr_mu")
    n_modes = t.ndim
    if init is None:
        init = random_ktensor(t.shape, rank, seed=0 if seed is None else seed,
                              device=dev)
    kt = init.to(dev).normalize()
    factors = list(kt.factors)
    lam = kt.lam

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
    if resume_state is None:
        strategies, layouts, policies = resolve_mode_policies(
            mvs, rank=rank, strategy=cfg.strategy, policy=cfg.policy,
            shape=t.shape, factors=factors, lam=lam,
            autotuner=cfg.autotuner)
        # per-mode effective config: the kappa ladder mutates these
        # without touching the caller's cfg
        mode_cfgs = [cfg] * n_modes
    else:
        start_outer = int(resume_state["outer"])
        factors = [resilience.array_to_tensor(f, dev)
                   for f in resume_state["factors"]]
        lam = resilience.array_to_tensor(resume_state["lam"], dev)
        strategies = list(resume_state["strategies"])
        policies = [policy_from_dict(p) if p else None
                    for p in resume_state["policies"]]
        layouts = _restore_mode_layouts(mvs, strategies, policies, t.shape)
        # the per-mode kappa ladder, so the resumed trajectory matches the
        # killed run even mid-recovery
        mode_cfgs = [dataclasses.replace(cfg, kappa=float(k))
                     for k in resume_state["kappas"]]
        kkt_hist = list(resume_state["kkt_history"])
        ll_hist = list(resume_state["loglik_history"])
        inner_hist = list(resume_state["inner_iters"])
        recoveries.extend(RecoveryEvent(**r)
                          for r in resume_state.get("recoveries", []))
        recoveries.append(RecoveryEvent(
            "resume", outer=start_outer, detail={"path": resume_from}))

    updates = [_make_mode_update(mvs[n], mode_cfgs[n], strategies[n],
                                 layouts[n], dev)
               for n in range(n_modes)]

    def _rebuild(n: int) -> None:
        updates[n] = _make_mode_update(mvs[n], mode_cfgs[n], strategies[n],
                                       layouts[n], dev)

    def _ctx(outer: int, n: int) -> dict:
        return {"outer": outer, "mode": n, "strategy": strategies[n],
                "local": strategies[n], "combine": "auto", "n_shards": 1}

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
        ok = resilience.guard_ok(a_new, lam_new) if cfg.guard else None
        return a_new, lam_new, viol, n_inner, ok

    def _demote(n: int, kind: str, exc: BaseException) -> "dict | None":
        """Take one degradation-ladder rung for mode ``n``; returns the
        recovery detail, or None when no rung applies (the error then
        propagates).  The OOM, fingerprint and grid rungs are multi-device
        (ROADMAP A8)."""
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
        return {"error": f"{type(exc).__name__}: {exc}"[:200],
                "action": f"{old}->{new}"}

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
                resilience.backoff_sleep(attempt, cfg.demote_backoff)
                _rebuild(n)
        raise AssertionError("unreachable")  # pragma: no cover

    def _write_checkpoint(n_outer: int) -> None:
        resilience.save_checkpoint(cfg.checkpoint_path, {
            "fingerprint": fp,
            "outer": int(n_outer),
            "kkt_history": kkt_hist,
            "loglik_history": ll_hist,
            "inner_iters": inner_hist,
            "rebalances": [],
            "recoveries": [dataclasses.asdict(r) for r in recoveries],
            "policies": [
                None if p is None else dict(
                    dataclasses.asdict(p),
                    strategy=_reference_name(p.strategy))
                for p in policies],
            "strategies": [_reference_name(s) for s in strategies],
            "locals": [_reference_name(s) if s in ("blocked", "cuda")
                       else "blocked" for s in strategies],
            "combines": ["auto"] * n_modes,
            "kappas": [float(mc.kappa) for mc in mode_cfgs],
            "mode_shards": [1] * n_modes,
            "mode_grids": [None] * n_modes,
            "rb_bounds": {},
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
                    ll = float(poisson_loglik(
                        t, KTensor(lam, tuple(factors)), cfg.eps))
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
        recoveries=recoveries or None,
    )
