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

This slice of the port runs on one device.  ``mesh``, ``n_shards``,
``grid_shape``, ``policy="auto"``, ``rebalance_every``, checkpoints and
``resume_from`` raise ``NotImplementedError`` (ROADMAP A4, A7, A8).  A
kernel that fails to build or launch raises: there is no degradation
ladder yet, and ``cuda`` is never demoted.
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
from .dense import DenseModeData, build_dense_mode
from .layout import BlockedLayout, build_blocked_layout
from .phi import (
    _dense_operands,
    canonical_strategy,
    expand_to_layout,
    phi_from_rows,
    phi_mu_step,
)
from .pi import pi_rows
from .policy import PhiPolicy, default_policy
from .resilience import RecoveryEvent
from .sparse_tensor import KTensor, ModeView, SparseTensor, random_ktensor, sort_mode

__all__ = [
    "CPAPRConfig",
    "CPAPRResult",
    "SweepOutcome",
    "cpapr_mu",
    "hoisted_mode_inputs",
    "kkt_violation",
    "poisson_loglik",
    "resolve_mode_policies",
    "sweep_step",
]


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
    # PhiPolicy (explicit blocking) or None (default 256 x 256 blocking);
    # "auto" (the autotuner) is not ported yet
    policy: "PhiPolicy | str | None" = None
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
    # checkpointing is not ported yet: must stay off
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
    sweep_seconds: list  # per outer iter: host seconds of the sweep
    policies: list | None = None  # per-mode PhiPolicy, blocked/cuda/dense
    # RecoveryEvents (numerical-guard restores), in order
    recoveries: list | None = None


@dataclasses.dataclass
class SweepOutcome:
    """One outer sweep's worth of state, produced by :func:`sweep_step`.

    ``bad`` lists the modes the numerical guard blamed for a non-finite
    sweep (empty when the sweep is clean or unguarded).
    """

    factors: list
    lam: torch.Tensor
    worst: "float | None"
    inner_total: int
    bad: list


def sweep_step(carry, batch, guard: bool = False) -> SweepOutcome:
    """One CP-APR outer sweep as a pure ``(carry, batch) -> outcome`` step.

    ``carry`` is ``(factors, lam)``; ``batch`` holds one callable per mode,
    ``(factors, lam) -> (A_n', lam', viol, n_inner, ok)`` with ``ok`` the
    mode's on-device guard boolean (or None when unguarded).  A non-finite
    KKT value aborts the sweep early and blames the earliest mode whose
    guard flag tripped; a sweep that finishes collects every tripped mode
    into ``bad``.  The input ``factors`` list is never mutated.
    """
    factors, lam = list(carry[0]), carry[1]
    n_modes = len(batch)
    worst = None
    inner_total = 0
    ok_flags: list = [None] * n_modes
    bad: list = []
    for n, mode_fn in enumerate(batch):
        a_new, lam_new, viol, n_inner, ok = mode_fn(factors, lam)
        if guard and not math.isfinite(float(viol)):
            bad = [m for m in range(n)
                   if ok_flags[m] is not None and not bool(ok_flags[m])] \
                or [n]
            break
        factors[n] = a_new
        lam = lam_new
        ok_flags[n] = ok
        worst = float(viol) if worst is None else max(worst, float(viol))
        inner_total += int(n_inner)
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


def resolve_mode_policies(
    mvs: Sequence[ModeView],
    *,
    rank: int,
    strategy: str,
    policy: "PhiPolicy | str | None" = None,
    shape: "tuple | None" = None,
) -> tuple:
    """Per-mode ``(strategies, layouts, policies)`` lists.

    The strategy resolver of both solvers (:func:`cpapr_mu` and
    :func:`repro_torch.core.cpals.cp_als`).  ``blocked``/``cuda`` modes
    get a :class:`BlockedLayout` with the explicit policy's block sizes,
    else :func:`default_policy`'s.  ``dense`` modes get their
    :class:`DenseModeData` in the layouts slot; they need the tensor's
    ``shape``.
    """
    if policy == "auto":
        raise NotImplementedError(
            "policy='auto' (the autotuner) is not ported yet: ROADMAP A7")
    strategy = canonical_strategy(strategy)
    n_modes = len(mvs)
    strategies = [strategy] * n_modes
    layouts: list = [None] * n_modes
    policies: list = [None] * n_modes
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
            layouts[n] = build_blocked_layout(
                mv.rows.detach().cpu().numpy(), mv.n_rows,
                pol.block_nnz, pol.block_rows,
            )
    return strategies, layouts, policies


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


def _check_supported(cfg: CPAPRConfig, resume_from) -> None:
    unported = {
        "mesh": (cfg.mesh is not None, "ROADMAP A8 (multi-device)"),
        "n_shards": (cfg.n_shards is not None, "ROADMAP A8 (multi-device)"),
        "grid_shape": (cfg.grid_shape is not None,
                       "ROADMAP A8 (multi-device)"),
        "rebalance_every": (cfg.rebalance_every != 0,
                            "ROADMAP A8 (multi-device)"),
        "checkpoint_every": (cfg.checkpoint_every != 0,
                             "ROADMAP A4 (checkpoints)"),
        "checkpoint_path": (cfg.checkpoint_path is not None,
                            "ROADMAP A4 (checkpoints)"),
        "resume_from": (resume_from is not None, "ROADMAP A4 (checkpoints)"),
        "policy": (cfg.policy == "auto", "ROADMAP A7 (autotune)"),
    }
    for name, (is_set, item) in unported.items():
        if is_set:
            raise NotImplementedError(
                f"cpapr_mu: {name} is not ported yet: {item}")


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
    """
    dev = resolve_device(device)
    cfg = config or CPAPRConfig(rank=rank)
    if cfg.rank != rank:
        raise ValueError(f"cpapr_mu: rank={rank} but config.rank={cfg.rank}")
    _check_supported(cfg, resume_from)
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
    strategies, layouts, policies = resolve_mode_policies(
        mvs, rank=rank, strategy=cfg.strategy, policy=cfg.policy,
        shape=t.shape)
    # per-mode effective config: the kappa ladder mutates these without
    # touching the caller's cfg
    mode_cfgs = [cfg] * n_modes
    updates = [_make_mode_update(mvs[n], cfg, strategies[n], layouts[n], dev)
               for n in range(n_modes)]
    recoveries: list = []

    def _rebuild(n: int) -> None:
        updates[n] = _make_mode_update(mvs[n], mode_cfgs[n], strategies[n],
                                       layouts[n], dev)

    def _run_mode(n: int, factors, lam):
        a_new, lam_new, viol, n_inner = updates[n](factors, lam)
        ok = resilience.guard_ok(a_new, lam_new) if cfg.guard else None
        return a_new, lam_new, viol, n_inner, ok

    kkt_hist: list = []
    ll_hist: list = []
    inner_hist: list = []
    sweep_secs: list = []
    converged = False
    t0 = time.perf_counter()
    n_outer = 0
    for k in range(cfg.max_outer):
        n_outer = k + 1
        ts = time.perf_counter()
        # sweep-start snapshot: the guards restore it (and redo the whole
        # sweep) when any mode's state went numerically bad
        snap_factors, snap_lam = list(factors), lam
        ll = None
        for sweep_attempt in range(cfg.guard_retries + 1):
            out = sweep_step((factors, lam),
                             [partial(_run_mode, n) for n in range(n_modes)],
                             guard=cfg.guard)
            factors, lam, bad = out.factors, out.lam, out.bad
            worst = out.worst if out.worst is not None else 0.0
            inner_total = out.inner_total
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
