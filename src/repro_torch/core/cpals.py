"""CP-ALS with sparse MTTKRP (paper Exp. 8 / the PASTA kernel family).

MTTKRP for mode n:  M[i, :] = sum_{j: idx[j,n]=i} x_j * KRrow_j
where KRrow_j = prod_{m != n} A^(m)[idx[j, m], :] — the same gathered
Khatri-Rao rows as Π^(n), so the Φ reduction machinery is reused through
:func:`repro_torch.core.phi.krao_reduce_rows`: ``scatter``, ``segment``,
``blocked``, ``cuda`` (the MTTKRP kernel; ``"pallas"`` is an alias) and
``dense`` (the dense MTTKRP kernel) apply to MTTKRP and CP-ALS unchanged.

Each per-mode ALS update (Khatri-Rao gather, MTTKRP, Gram product, ridge
solve) is built once per mode before the iteration loop; the Khatri-Rao
gather and its layout expansion run once per mode update, as in
``cpapr_mu``.  ``policy="auto"`` asks the autotuner per mode, as in
``cpapr_mu``.  When the caller passes a ``recoveries=`` list, a
classified runtime failure of a mode (a kernel that fails to build, is
refused by the card's limits or fails to launch; an unknown served
strategy) drops that mode straight to ``segment`` and retries it,
recorded in that list; without one every failure propagates.
``strategy="sharded"`` runs each mode's MTTKRP over row-block shards with
one combine per mode update (:mod:`repro_torch.core.distributed`; the
MTTKRP kernel B3 once per shard for a ``cuda`` policy), over a
``torch.distributed`` mesh (``mesh=``) or emulated (``n_shards``).
``strategy="grid"`` runs each mode's MTTKRP over an ``A x B`` device grid
chosen per mode by :func:`repro_torch.core.layout.choose_grid_shape` (B3
once per cell), emulated on one device as in the JAX package.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..device import resolve_device
from . import resilience
from .cpapr import (
    effective_mode_combine,
    hoisted_mode_inputs,
    mode_pi_gather,
    resolve_mode_policies,
)
from .layout import GridLayout, ShardedBlockedLayout
from .phi import canonical_strategy, krao_reduce_rows
from .pi import pi_rows
from .sparse_tensor import KTensor, ModeView, SparseTensor, random_ktensor, sort_mode

__all__ = ["cp_als", "fit_score", "mttkrp", "mttkrp_mode"]

_RIDGE = 1e-10  # Gram regularizer of the ALS normal equations


def mttkrp(
    indices: torch.Tensor,
    values: torch.Tensor,
    factors: Sequence[torch.Tensor],
    n: int,
    n_rows: int,
    strategy: str = "scatter",
    layout=None,
    sorted_rows: bool = False,
    device="cuda",
) -> torch.Tensor:
    """Sparse MTTKRP (Eqs. 9-11 of the paper) through any strategy of
    :func:`krao_reduce_rows` but ``dense``.

    ``indices`` may be unsorted for ``scatter`` and ``segment``;
    ``blocked``/``cuda`` need the mode-``n``-sorted stream (use a
    :class:`ModeView` and :func:`mttkrp_mode`).
    """
    kr = pi_rows(indices, factors, n)
    return krao_reduce_rows(indices[:, n], values, kr, n_rows,
                            strategy=strategy, layout=layout,
                            sorted_rows=sorted_rows, device=device)


def mttkrp_mode(
    mv: ModeView,
    factors: Sequence[torch.Tensor],
    strategy: str = "segment",
    layout=None,
    device="cuda",
) -> torch.Tensor:
    """MTTKRP on a sorted mode view (the layout-friendly entry point)."""
    return mttkrp(mv.sorted_idx, mv.sorted_vals, factors, mv.mode, mv.n_rows,
                  strategy=strategy, layout=layout, sorted_rows=True,
                  device=device)


def _make_als_mode_update(mv: ModeView, rank: int, strategy: str, layout,
                          device: torch.device, local_strategy: str = "blocked",
                          mesh=None, pig=None, combine: str = "psum"):
    """Per-mode ALS update ``factors -> A_n'``: one Khatri-Rao gather and
    layout expansion (or, for ``dense``, one set of dense operands), the
    MTTKRP, then the ridge-regularized Gram solve.  A sharded mode reduces
    every shard (``local_strategy``) and meets in one ``combine``; with
    ``pig`` the shards build their own Khatri-Rao rows."""
    shard_kw = dict(mesh=mesh, local_strategy=local_strategy, pi_gather=pig,
                    combine=combine) \
        if strategy in ("sharded", "grid") else {}
    n = mv.mode

    def gram_solve(factors, m_n):
        gram = torch.ones((rank, rank), dtype=m_n.dtype, device=m_n.device)
        for m, f in enumerate(factors):
            if m != n:
                gram = gram * (f.T @ f)
        eye = torch.eye(rank, dtype=gram.dtype, device=gram.device)
        return torch.linalg.solve(gram + _RIDGE * eye, m_n.T).T

    def update(factors):
        if strategy == "dense":  # the DenseModeData rides the layouts slot
            m_n = krao_reduce_rows(None, None, None, mv.n_rows,
                                   strategy="dense", device=device,
                                   dense=layout, factors=factors)
        else:
            kr, vals_e, kr_e = hoisted_mode_inputs(mv, factors, strategy,
                                                   layout, pig)
            m_n = krao_reduce_rows(mv.rows, mv.sorted_vals, kr, mv.n_rows,
                                   strategy=strategy, layout=layout,
                                   vals_e=vals_e, kr_e=kr_e, device=device,
                                   factors=factors if pig is not None
                                   else None, **shard_kw)
        return gram_solve(factors, m_n)

    return update


def cp_als(
    t: SparseTensor,
    rank: int,
    n_iters: int = 20,
    seed: int | None = None,
    init: KTensor | None = None,
    strategy: str = "scatter",
    policy=None,
    autotuner=None,
    mesh=None,
    n_shards: int | None = None,
    shard_pi: bool = True,
    mode_views: Sequence[ModeView] | None = None,
    combine: str = "auto",
    validate: bool = True,
    recoveries: "list | None" = None,
    device="cuda",
) -> tuple:
    """Plain CP-ALS on a sparse tensor (least squares, not Poisson).

    Returns ``(KTensor, fit_history)``: the paper's comparison algorithm
    family, whose bottleneck is MTTKRP (Exp. 8).  ``init`` (a KTensor, e.g.
    from :mod:`repro_torch.core.convert`) is the starting model, its λ
    folded into the first factor; without it one is drawn from ``seed``
    (default 0).  ``t`` and ``init`` are moved to ``device``.
    ``strategy``/``policy`` route the MTTKRP through the same resolver as
    CP-APR's Φ (an explicit :class:`PhiPolicy` sets the blocking,
    ``policy="auto"`` engages the autotuner, ``autotuner`` as in
    ``CPAPRConfig``).  ``strategy="sharded"`` runs row-block shards over
    ``mesh`` (a ``torch.distributed`` DeviceMesh) or ``n_shards`` emulated
    ones, ``shard_pi`` (default) builds each shard's Khatri-Rao rows from
    the factor rows it touches, and ``combine`` picks the combine
    (``"auto"``: the reduce-scatter on sharded modes, as in ``cpapr_mu``;
    bitwise equal).

    Passing a list as ``recoveries`` turns on the one-rung degradation
    ladder: a classified runtime failure drops the failing mode to
    ``segment`` and retries it, and the list collects one
    :class:`repro_torch.core.resilience.RecoveryEvent` per demotion.
    Without a list (the default) every failure propagates, so a kernel
    that fails on the card is never replaced unseen by its plain version.
    """
    dev = resolve_device(device)
    canonical_strategy(strategy)  # an unknown one raises before any work
    t = t.to(dev)
    if validate:
        resilience.validate_decomposition_inputs(t, rank, where="cp_als")
    if init is None:
        init = random_ktensor(t.shape, rank, seed=0 if seed is None else seed,
                              device=dev)
    init = init.to(dev)
    factors = [init.factors[0] * init.lam[None, :]] + list(init.factors[1:])

    mvs = list(mode_views) if mode_views is not None else [
        sort_mode(t, n) for n in range(t.ndim)
    ]
    ones = torch.ones((rank,), dtype=factors[0].dtype, device=dev)
    strategies, layouts, _, locals_ = resolve_mode_policies(
        mvs, rank=rank, strategy=strategy, policy=policy, shape=t.shape,
        factors=factors, lam=ones, autotuner=autotuner, mesh=mesh,
        n_shards=n_shards, combine=combine, device=dev)
    pigs = [mode_pi_gather(mvs[n], layouts[n], shard_pi)
            for n in range(t.ndim)]
    updates = [
        _make_als_mode_update(
            mvs[n], rank, strategies[n], layouts[n], dev, locals_[n],
            mesh if strategies[n] == "sharded" else None, pigs[n],
            combine=effective_mode_combine(
                combine, strategies[n], layouts[n], rank,
                itemsize=factors[n].element_size()))
        for n in range(t.ndim)
    ]

    def _demote_mode(n: int, it: int, exc: BaseException) -> None:
        """One-rung degradation ladder: a classified runtime failure
        drops the mode straight to the always-available ``segment``."""
        kind = resilience.classify_failure(exc)
        if recoveries is None or kind is None or strategies[n] == "segment":
            raise exc
        detail = {"error": f"{type(exc).__name__}: {exc}"[:200],
                  "action": f"{strategies[n]}->segment"}
        if strategies[n] == "dense":
            # a dense launch that did not complete may leave its stream's
            # tickets dirty: no later dense call may reuse them
            from ..kernels.dense.kernel import drop_workspace

            drop_workspace(dev)
        strategies[n], layouts[n], locals_[n] = "segment", None, "blocked"
        pigs[n] = None
        updates[n] = _make_als_mode_update(mvs[n], rank, "segment", None, dev)
        recoveries.append(resilience.RecoveryEvent(
            f"demote_{kind}", outer=it + 1, mode=n, detail=detail))

    norm_x = torch.sqrt(torch.sum(t.values ** 2))
    fits = []
    for it in range(n_iters):
        for n in range(t.ndim):
            try:
                if resilience.have_hooks():
                    sl = layouts[n]
                    multi = isinstance(sl, (ShardedBlockedLayout,
                                            GridLayout))
                    resilience.fire_mode_hooks({
                        "outer": it + 1, "mode": n,
                        "strategy": strategies[n],
                        "local": locals_[n] if multi else strategies[n],
                        "combine": combine,
                        "n_shards": int(sl.n_shards) if multi else 1})
                factors[n] = updates[n](factors)
            except Exception as e:
                _demote_mode(n, it, e)
                factors[n] = updates[n](factors)
        fits.append(float(fit_score(t, factors, norm_x)))
    lam = torch.ones((rank,), dtype=factors[0].dtype, device=dev)
    return KTensor(lam=lam, factors=tuple(factors)).normalize(), fits


def fit_score(t: SparseTensor, factors: Sequence[torch.Tensor],
              norm_x) -> torch.Tensor:
    """1 - ||X - M|| / ||X||, evaluated exactly through the Gram trick."""
    rank = factors[0].shape[1]
    # <M, M> = sum over r, r' of prod_n (A^n^T A^n)[r, r']
    gram = torch.ones((rank, rank), dtype=factors[0].dtype,
                      device=factors[0].device)
    for f in factors:
        gram = gram * (f.T @ f)
    norm_m_sq = torch.sum(gram)
    # <X, M> = sum_z x_z m_z
    prod = torch.ones((t.values.shape[0], rank), dtype=factors[0].dtype,
                      device=factors[0].device)
    for n, f in enumerate(factors):
        prod = prod * f[t.indices[:, n]]
    inner = torch.sum(t.values * torch.sum(prod, dim=1))
    resid_sq = torch.clamp_min(norm_x ** 2 - 2 * inner + norm_m_sq, 0.0)
    return 1.0 - torch.sqrt(resid_sq) / norm_x
