"""Parallel policy for the Φ kernels (paper Secs. 4.3-4.6).

    strategy    in {scatter, segment, blocked, cuda}
    block_nnz   ~ vector length: nonzeros per grid step
    block_rows  ~ team share: rows of B/Φ per row block
    (grid size  ~ league: derived, = padded_nnz / block_nnz)

The paper shows grid search over the policy gives 2.25x (CPU) / 1.70x (GPU)
over defaults, and calls a selection *heuristic* "an obvious next step"
(Sec. 5).  :func:`policy_grid` and :func:`grid_search` are the search;
:func:`model_top_k` and :func:`model_ambiguous_prefix` prune model-scored
candidates to the ones worth measuring.

``heuristic_policy`` gives the same outputs as the JAX package's for
``platform="cpu"`` and ``"tpu"``; ``platform="cuda"`` sizes the blocking to
the Φ kernel's shared memory on the H100, and no platform means the one
this process computes on.  The solver on the card
blocks at :func:`default_policy` (256 x 256) unless given a
:class:`PhiPolicy` or ``policy="auto"`` (the autotuner,
:mod:`repro_torch.perf.autotune`).
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Callable, Iterable, Sequence

import numpy as np
import torch

from ..kernels._checks import SMEM_LIMIT
from ..kernels.phi.kernel import smem_bytes as phi_smem_bytes

__all__ = [
    "DENSE_FILL_BIN_MAX",
    "DENSE_MAX_ELEMS",
    "PhiPolicy",
    "SEARCH_ERRORS",
    "default_policy",
    "grid_search",
    "heuristic_policy",
    "model_ambiguous_prefix",
    "model_top_k",
    "policy_grid",
    "probe_error_is_retryable",
    "vmem_footprint_bytes",
]

# Near-dense cut for the matrix-free tier: fill bins 0 and 1 (> 2^-2 fill).
DENSE_FILL_BIN_MAX = 1
# Largest densified mode (cells) the dense tier accepts.
DENSE_MAX_ELEMS = 1 << 22


@dataclasses.dataclass(frozen=True)
class PhiPolicy:
    strategy: str = "segment"
    block_nnz: int = 256
    block_rows: int = 256
    gather_mode: str = "prefetch"  # 'prefetch' (stream rows) | 'vmem' (resident)

    def label(self) -> str:
        return f"{self.strategy}:{self.block_nnz}:{self.block_rows}:{self.gather_mode}"


def default_policy(rank: int) -> PhiPolicy:
    """The 'SparTen default' analog used as the baseline policy."""
    return PhiPolicy(strategy="segment", block_nnz=256, block_rows=256)


def vmem_footprint_bytes(p: PhiPolicy, rank: int, itemsize: int = 4) -> int:
    """Working set of one grid step of the TPU blocked kernel.

    B window + Φ accumulator + Π block + values + one-hot block, with the
    rank padded to 128 lanes (the TPU sizing the heuristic reproduces).
    """
    r = max(rank, 128)  # lane padding
    return itemsize * (
        2 * p.block_rows * r  # B window + Phi accumulator
        + p.block_nnz * r  # Pi block
        + p.block_nnz  # values
        + p.block_nnz * p.block_rows  # one-hot
    )


# Sizing of the heuristic's cuda branch: block_nnz is held to 4 waves of
# one-step blocks, 8 per SM on an H100's 132 SMs, and the Φ kernel's shared
# memory to a quarter of a block's.  Neither premise holds for the
# persistent per-warp kernel: its CTAs walk contiguous slot ranges, and its
# footprint (at most 56 KB, independent of block_rows) never reaches the
# budget.  The autotuner (policy="auto") measures in its place; its
# CUDA-graph probes find uber's blockings within a few percent of one
# another (PERF.md, section 6).
_H100_SMS = 132
_BLOCKS_PER_SM = 8
_WAVES = 4
_CUDA_SMEM_BUDGET = SMEM_LIMIT // 4


def policy_grid(
    strategies: Sequence[str] = ("segment", "blocked"),
    block_nnz: Sequence[int] = (64, 128, 256, 512, 1024),
    block_rows: Sequence[int] = (64, 128, 256, 512),
) -> list:
    """Cartesian policy grid (paper's league x team x vector sweep)."""
    out = []
    for s in strategies:
        if s in ("scatter", "segment"):
            out.append(PhiPolicy(strategy=s))
        else:
            for bn, br in itertools.product(block_nnz, block_rows):
                out.append(PhiPolicy(strategy=s, block_nnz=bn, block_rows=br))
    return out


#: Errors a policy probe may legitimately raise: bad shapes or configs
#: (``ValueError``, which includes a blocking whose shared memory exceeds
#: the card's, ``NotImplementedError``) and running out of device memory.
#: Anything else (a failed launch, a bug, KeyboardInterrupt) propagates
#: out of the search.
SEARCH_ERRORS = (ValueError, NotImplementedError, torch.cuda.OutOfMemoryError)


def probe_error_is_retryable(e: BaseException) -> bool:
    """Transient probe failures (device memory pressure) are worth one
    retry; deterministic config rejections (``ValueError`` /
    ``NotImplementedError``) are not: retrying them only slows the search
    down."""
    return not isinstance(e, (ValueError, NotImplementedError))


def grid_search(
    time_fn: Callable[[PhiPolicy], float],
    policies: Iterable[PhiPolicy],
    retries: int = 1,
    backoff: float = 0.05,
) -> list:
    """Time every policy; returns [(policy, seconds, error)] fastest-first.

    ``error`` is ``None`` for successful probes; for policies that fail
    with an expected error (invalid configs are part of the search space,
    see :data:`SEARCH_ERRORS`) the entry records ``float('inf')`` seconds
    plus the failure reason so callers can report *why* a point was pruned.

    Probes whose failure class is *retryable* (see
    :func:`probe_error_is_retryable`) get up to ``retries`` extra
    attempts with exponential backoff before ``inf`` is recorded, and
    their error string is tagged ``(retryable)``; a probe that recovers on
    retry records its measured time like any other.
    """
    results = []
    for p in policies:
        secs, err = float("inf"), None
        for attempt in range(retries + 1):
            try:
                secs, err = time_fn(p), None
                break
            except SEARCH_ERRORS as e:
                retryable = probe_error_is_retryable(e)
                secs = float("inf")
                err = f"{type(e).__name__}: {e}" + (
                    " (retryable)" if retryable else ""
                )
                if not retryable or attempt >= retries:
                    break
                if backoff > 0:
                    time.sleep(min(backoff * (2.0 ** attempt), 2.0))
        results.append((p, secs, err))
    results.sort(key=lambda x: x[1])
    return results


def model_top_k(
    scored: Sequence[tuple],
    k: int = 3,
    per_family: bool = True,
) -> list:
    """Prune model-scored candidates to the K worth measuring.

    ``scored`` is ``[(policy, model_seconds)]``; non-finite scores (model
    failures) are dropped.  With ``per_family`` (default) the model-best
    candidate of every strategy family keeps a slot before global ranking
    fills the rest: a cost model ranks *across* families far more
    reliably than *within* one family's block-size neighborhood.
    Returns ``[(policy, model_seconds)]`` sorted fastest-predicted-first.
    """
    finite = sorted((x for x in scored if np.isfinite(x[1])),
                    key=lambda x: x[1])
    if k <= 0 or not finite:
        return []
    if not per_family:
        return finite[:k]
    picked, seen_fam = [], set()
    for pol, s in finite:  # one slot per family first, in model order
        if pol.strategy not in seen_fam:
            seen_fam.add(pol.strategy)
            picked.append((pol, s))
        if len(picked) >= k:
            break
    if len(picked) < k:
        chosen = {id(p) for p, _ in picked}
        for pol, s in finite:
            if id(pol) not in chosen:
                picked.append((pol, s))
                chosen.add(id(pol))
            if len(picked) >= k:
                break
    picked.sort(key=lambda x: x[1])
    return picked


def model_ambiguous_prefix(
    ranked: Sequence[tuple],
    bound_factor: float,
    cap: int = 3,
) -> list:
    """The prefix of model-ranked candidates the model cannot separate.

    ``ranked`` is ``[(policy, model_seconds)]`` fastest-predicted-first
    (e.g. the output of :func:`model_top_k`); ``bound_factor`` is a
    multiplicative error bound (>= 1): candidates whose predicted time is
    within ``bound_factor`` of the predicted best are *ambiguous* and must
    be measured.  A prefix of length 1 means the predicted margin to the
    runner-up exceeds the error bound.
    """
    if not ranked:
        return []
    best = ranked[0][1]
    out = [ranked[0]]
    for pol, s in ranked[1:cap]:
        if s <= best * max(bound_factor, 1.0):
            out.append((pol, s))
    return out


def heuristic_policy(
    nnz: int,
    n_rows: int,
    rank: int,
    vmem_budget: int = 8 * 2**20,
    row_hist: np.ndarray | None = None,
    platform: str | None = None,
    stats: "object | None" = None,
) -> PhiPolicy:
    """Pick (strategy, block_nnz, block_rows) from tensor stats + platform.

    * duplication d = nnz / n_rows (mean segment run length); block_nnz
      covers a few average rows per step;
    * block_rows covers the p95 segment run (``stats.p95_run`` when a
      :class:`repro_torch.core.layout.ModeStats` is given, else
      ``row_hist``, else d) so one grid step rarely spans row blocks;
    * a near-dense mode (fill bin <= 1, cells <= 2^22) goes to the dense
      tier.

    ``platform=None`` is the platform this process computes on: ``"cuda"``
    when a card is available, else ``"cpu"`` (the JAX package resolves it
    to ``jax.default_backend()``).  ``platform="cpu"`` keeps the sorted
    segmented reduce with cache-model block sizes.  ``platform="cuda"``
    picks the Φ kernel (``cuda``): block_nnz covers ~4 average rows but
    no more than would keep 4 waves of one-step blocks on the card's 132
    SMs (the first kernel design's launch, 8 resident per SM; the
    persistent kernel no longer launches so), block_rows covers the p95
    run as above, and the kernel's shared memory
    (``kernels.phi.kernel.smem_bytes``) is held to a quarter of a block's
    limit, which its per-warp ring never reaches;
    ``vmem_budget`` is not read.
    Every other platform takes the TPU's blocked sizing.
    """
    if platform is None:
        platform = "cuda" if torch.cuda.is_available() else "cpu"
    if stats is not None and getattr(stats, "fill_bin", -1) >= 0:
        fill = float(getattr(stats, "fill_frac", 0.0))
        if stats.fill_bin <= DENSE_FILL_BIN_MAX and fill > 0.0:
            cells = nnz / fill
            if cells <= DENSE_MAX_ELEMS:
                return PhiPolicy(strategy="dense", block_nnz=8)
    d = max(1.0, nnz / max(1, n_rows))
    if stats is not None and getattr(stats, "nnz", 0) > 0:
        p95 = max(float(stats.p95_run), 1.0)
    elif row_hist is not None and row_hist.size:
        p95 = float(np.percentile(row_hist, 95))
    else:
        p95 = d
    if platform == "cpu":
        bn = int(2 ** np.clip(np.round(np.log2(2 * d)), 6, 10))
        br = int(2 ** np.clip(np.round(np.log2(max(bn / max(p95, 1.0), 8))), 3, 8))
        p = PhiPolicy(strategy="segment", block_nnz=bn, block_rows=br)
        l2_budget = 1 << 20
        while vmem_footprint_bytes(p, rank) > l2_budget and p.block_nnz > 64:
            p = dataclasses.replace(p, block_nnz=p.block_nnz // 2)
        while vmem_footprint_bytes(p, rank) > l2_budget and p.block_rows > 8:
            p = dataclasses.replace(p, block_rows=p.block_rows // 2)
        return p
    if platform == "cuda":
        fill = nnz / (_WAVES * _H100_SMS * _BLOCKS_PER_SM)
        bn = int(2 ** np.clip(np.floor(np.log2(max(min(4 * d, fill), 1.0))),
                              6, 11))
        br = int(2 ** np.clip(np.round(np.log2(max(bn / max(p95, 1.0), 8))),
                              3, 10))
        p = PhiPolicy(strategy="cuda", block_nnz=bn, block_rows=br)
        def smem(q):
            return phi_smem_bytes(q.block_nnz, q.block_rows, rank)

        while smem(p) > _CUDA_SMEM_BUDGET and p.block_rows > 8:
            p = dataclasses.replace(p, block_rows=p.block_rows // 2)
        while smem(p) > _CUDA_SMEM_BUDGET and p.block_nnz > 64:
            p = dataclasses.replace(p, block_nnz=p.block_nnz // 2)
        return p
    bn = int(2 ** np.clip(np.round(np.log2(4 * d)), 6, 11))
    br = int(2 ** np.clip(np.round(np.log2(max(bn / max(p95, 1.0), 8))), 3, 10))
    p = PhiPolicy(strategy="blocked", block_nnz=bn, block_rows=br)
    while vmem_footprint_bytes(p, rank) > vmem_budget and p.block_nnz > 64:
        p = dataclasses.replace(p, block_nnz=p.block_nnz // 2)
    while vmem_footprint_bytes(p, rank) > vmem_budget and p.block_rows > 8:
        p = dataclasses.replace(p, block_rows=p.block_rows // 2)
    return p
