"""Streaming multi-tenant decomposition service.

Many tenants, each owning a growing sparse count tensor, ask for fresh
CP-APR factors as data streams in.  Three mechanisms keep that
affordable:

* **Incremental appends**: :meth:`DecompService.append` merges a batch of
  new nonzeros into the tenant's tensor through the ``_unique_coo`` dedup
  (:func:`repro_torch.core.sparse_tensor.append_nonzeros`), extends every
  per-mode sorted view by merging sorted runs instead of re-sorting
  (:func:`repro_torch.core.sparse_tensor.merge_mode_view`) and
  warm-starts the solve from the tenant's previous factors
  (``cpapr_mu(init=prev)``) under a freshness-aware sweep budget
  (:func:`warm_sweep_budget`).

* **Padded-bucket batching**: :meth:`DecompService.submit_many` groups
  small cold jobs into shared padded buckets and solves each bucket in
  one batched pass per step (:mod:`repro_torch.serve.batch`); singleton
  buckets run the same padded path, so a job's factors do not depend on
  its cohort.

* **One shared autotune store**: every tenant's ``policy="auto"`` solve
  consults the same :class:`~repro_torch.perf.autotune.Autotuner`, so a
  problem any tenant has seen is never tuned again
  (:meth:`DecompService.stats` reports its counters).

On the card a tenant's solve resolves each mode through the tuner to the
Φ kernels (``cuda``) or, past the dense cut, to the dense kernels; the
bucket tier runs the plain ``segment`` path, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import math

from ..core import resilience
from ..core.cpapr import CPAPRConfig, CPAPRResult, cpapr_mu
from ..core.layout import mode_run_stats
from ..core.sparse_tensor import (
    KTensor,
    SparseTensor,
    append_nonzeros,
    merge_mode_view,
    sort_mode,
)
from ..device import resolve_device
from ..perf.autotune import Autotuner
from .batch import BucketRegistry, batched_cpapr_mu

__all__ = [
    "DecompJob",
    "DecompService",
    "ServiceResult",
    "TenantState",
    "warm_sweep_budget",
]


def warm_sweep_budget(
    frac_new: float, base_outer: int, floor: int = 2
) -> int:
    """Freshness-aware outer-sweep budget for a warm-started append.

    An append that refreshed a fraction ``frac_new`` of the nonzeros
    starts near the old optimum, so it gets roughly ``2 * frac_new`` of a
    cold solve's sweep budget (a 10% append pays ~20% of the sweeps),
    clamped to ``[floor, base_outer]``.
    """
    frac = min(max(float(frac_new), 0.0), 1.0)
    return int(min(max(math.ceil(base_outer * 2.0 * frac), floor),
                   base_outer))


@dataclasses.dataclass
class TenantState:
    """Everything the service retains per tenant between requests."""

    tensor: SparseTensor
    mode_views: list
    rank: int
    ktensor: KTensor | None = None
    n_solves: int = 0
    n_appends: int = 0
    # per-mode ModeStats of the *current* tensor, refreshed on every
    # submit/append, so the next solve never keys on stale bins
    mode_stats: "list | None" = None


def _tensor_mode_stats(tensor: SparseTensor, mvs) -> list:
    """Per-mode run/fill stats of ``tensor`` (a host pass per request).
    ``row_width``, the cells per mode-n row, arms the dense-tier fill cut,
    as the solver's own stat pass does."""
    total = math.prod(int(s) for s in tensor.shape)
    return [
        mode_run_stats(
            mv.rows.cpu().numpy(), mv.n_rows,
            row_width=total // max(int(tensor.shape[n]), 1),
        )
        for n, mv in enumerate(mvs)
    ]


@dataclasses.dataclass(frozen=True)
class DecompJob:
    """One cold decomposition request (the ``submit_many`` unit)."""

    tenant: str
    tensor: SparseTensor
    rank: int
    seed: "int | None" = None
    init: "KTensor | None" = None


@dataclasses.dataclass
class ServiceResult:
    """A solve receipt: the solver result plus serving metadata."""

    tenant: str
    result: CPAPRResult
    warm: bool = False
    batched: bool = False
    frac_new: float = 0.0
    sweep_budget: int = 0
    bucket: "object | None" = None
    # append only: True when the merged tensor's per-mode distribution
    # bins (the autotune key fragments) moved against the pre-append
    # stats, so the solve's per-mode strategies may differ from before
    stats_changed: bool = False


class DecompService:
    """Multi-tenant CP-APR decomposition service on one device.

    Args:
      autotune_path: path of the shared autotune store (one file for
        every tenant); None uses the library default.
      measure: whether the shared tuner runs timed probes on cold keys
        (False serves persisted winners or the heuristic).
      registry: bucket registry for :meth:`submit_many`.
      device: where every tenant's tensor lives and is solved.
      solver_kwargs: overrides applied to every solve's
        :class:`CPAPRConfig` (e.g. ``max_outer``, ``tol``, ``strategy``).
        ``policy="auto"`` with the shared tuner is the default.
    """

    def __init__(
        self,
        autotune_path: str | None = None,
        measure: bool = False,
        registry: BucketRegistry | None = None,
        device="cuda",
        **solver_kwargs,
    ):
        self.device = resolve_device(device)
        self.tuner = Autotuner(cache_path=autotune_path, measure=measure)
        self.registry = registry or BucketRegistry()
        self.defaults = dict(
            max_outer=20,
            tol=1e-4,
            policy="auto",
            track_loglik=False,
        )
        self.defaults.update(solver_kwargs)
        self.tenants: dict = {}
        self.n_jobs = 0
        self.n_batched_dispatches = 0

    # -- config plumbing --------------------------------------------------
    def _config(self, rank: int, **overrides) -> CPAPRConfig:
        kw = dict(self.defaults)
        kw.update(overrides)
        if kw.get("policy") == "auto" and kw.get("autotuner") is None:
            kw["autotuner"] = self.tuner
        return CPAPRConfig(rank=rank, **kw)

    def tenant(self, name: str) -> TenantState:
        if name not in self.tenants:
            raise ValueError(
                f"unknown tenant {name!r}; submit a tensor first "
                f"(known: {sorted(self.tenants)})"
            )
        return self.tenants[name]

    def _register(self, name: str, tensor: SparseTensor, rank: int,
                  ktensor: KTensor, mvs=None) -> None:
        mvs = mvs or [sort_mode(tensor, n) for n in range(tensor.ndim)]
        self.tenants[name] = TenantState(
            tensor=tensor, mode_views=mvs, rank=rank, ktensor=ktensor,
            n_solves=1, mode_stats=_tensor_mode_stats(tensor, mvs),
        )

    # -- cold submissions -------------------------------------------------
    def submit(
        self,
        tenant: str,
        tensor: SparseTensor,
        rank: int,
        seed: "int | None" = None,
        init: "KTensor | None" = None,
        **overrides,
    ) -> ServiceResult:
        """Cold-solve one tensor and register/replace the tenant state."""
        resilience.validate_decomposition_inputs(
            tensor, rank, where="DecompService.submit"
        )
        cfg = self._config(rank, **overrides)
        tensor = tensor.to(self.device)
        mvs = [sort_mode(tensor, n) for n in range(tensor.ndim)]
        if seed is None and init is None:
            seed = self.n_jobs
        res = cpapr_mu(tensor, rank, seed=seed, init=init, config=cfg,
                       mode_views=mvs, device=self.device)
        self._register(tenant, tensor, rank, res.ktensor, mvs)
        self.n_jobs += 1
        return ServiceResult(tenant=tenant, result=res,
                             sweep_budget=cfg.max_outer)

    def submit_many(self, jobs) -> list:
        """Solve many cold jobs, batching same-bucket jobs per dispatch.

        Jobs are grouped by the padded-bucket registry; every bucket,
        singletons included, runs the padded ``segment`` path of
        :func:`repro_torch.serve.batch.batched_cpapr_mu`, so a job's
        factors do not depend on its cohort.  Results come back aligned
        with ``jobs``; each job's tenant state is registered for later
        appends.
        """
        jobs = list(jobs)
        for j in jobs:
            resilience.validate_decomposition_inputs(
                j.tensor, j.rank, where="DecompService.submit_many"
            )
        groups = self.registry.group(
            [(j.tensor.shape, j.tensor.nnz, j.rank) for j in jobs]
        )
        results: list = [None] * len(jobs)
        for bucket, idxs in groups.items():
            members = [jobs[i] for i in idxs]
            seeds = [j.seed if j.seed is not None else self.n_jobs + i
                     for i, j in zip(idxs, members)]
            cfg = self._config(bucket.rank)
            res, _ = batched_cpapr_mu(
                [j.tensor for j in members], bucket.rank, seeds=seeds,
                inits=[j.init for j in members], config=cfg, bucket=bucket,
                device=self.device,
            )
            self.n_batched_dispatches += 1
            for i, job, r in zip(idxs, members, res):
                self._register(job.tenant, job.tensor.to(self.device),
                               job.rank, r.ktensor)
                results[i] = ServiceResult(
                    tenant=job.tenant, result=r, batched=len(members) > 1,
                    sweep_budget=cfg.max_outer, bucket=bucket,
                )
        self.n_jobs += len(jobs)
        return results

    # -- incremental appends ----------------------------------------------
    def append(
        self,
        tenant: str,
        new_indices,
        new_values,
        sweep_budget: int | None = None,
        **overrides,
    ) -> ServiceResult:
        """Merge new nonzeros into a tenant's tensor and warm-start.

        The merged tensor's mode views are extended incrementally (no
        re-sort), its per-mode stats are recomputed, so an append that
        crossed a bin (the dense cut among them) re-resolves the modes'
        strategies, and the solve starts from the tenant's previous
        factors under the freshness-aware sweep budget.
        """
        st = self.tenant(tenant)
        resilience.validate_append_batch(
            st.tensor.shape, new_indices, new_values,
            where="DecompService.append",
        )
        merged, info = append_nonzeros(st.tensor, new_indices, new_values)
        mvs = [merge_mode_view(mv, merged, st.tensor.nnz)
               for mv in st.mode_views]
        fresh_stats = _tensor_mode_stats(merged, mvs)
        prev = st.mode_stats or [None] * len(fresh_stats)
        stats_changed = any(
            p is None or p.key_fragment() != f.key_fragment()
            for p, f in zip(prev, fresh_stats)
        )
        base_outer = int(
            overrides.get("max_outer", self.defaults["max_outer"])
        )
        budget = (int(sweep_budget) if sweep_budget is not None
                  else warm_sweep_budget(info.frac_new, base_outer))
        overrides["max_outer"] = budget
        cfg = self._config(st.rank, **overrides)
        res = cpapr_mu(merged, st.rank, init=st.ktensor, config=cfg,
                       mode_views=mvs, device=self.device)
        st.tensor = merged
        st.mode_views = mvs
        st.ktensor = res.ktensor
        st.mode_stats = fresh_stats
        st.n_solves += 1
        st.n_appends += 1
        self.n_jobs += 1
        return ServiceResult(
            tenant=tenant, result=res, warm=True,
            frac_new=info.frac_new, sweep_budget=budget,
            stats_changed=stats_changed,
        )

    # -- metrics ----------------------------------------------------------
    def stats(self) -> dict:
        """Serving counters incl. the shared autotune store's hit rates."""
        return {
            "tenants": len(self.tenants),
            "jobs": self.n_jobs,
            "batched_dispatches": self.n_batched_dispatches,
            "buckets": {
                str(b): n for b, n in self.registry.seen.items()
            },
            "autotune": self.tuner.counters(),
            "autotune_cache_entries": len(self.tuner.cache.entries),
        }
