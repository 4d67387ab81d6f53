"""Padded-bucket batching for the decomposition service.

Many-tenant traffic is dominated by small tensors, and one solve per job
spends the device on launch overhead.  This module rounds job shapes up
into shared padded **buckets** (zero-value nonzeros appended at
coordinate 0, zero factor rows past the true extent) and solves every
same-bucket job in one batched pass per step: the jobs' rows are offset
by ``j * I_pad`` so one ``index_add_`` into ``(J * I_pad, R)`` reduces Φ
for the whole bucket, and the KKT violation is a max per job over
``(J, I_pad, R)``.

Padding is exact: a zero-valued nonzero contributes ``0 / max(s, eps) =
0`` to its Φ row, a zero factor row gets Φ = 0 and stays zero through the
multiplicative update, and the scooch never lifts it (Φ = 0 is not > 1).
Each job's inner loop stops counting once its own violation is <= tol
(or it reaches ``max_inner``), as a lane of the JAX package's vmapped
``lax.while_loop`` does, and jobs that converged are frozen across
sweeps, so a job's trajectory does not depend on its cohort.  On the
CPU, where ``index_add_`` adds in order, solving ``[A, B, C]`` batched
gives bitwise the factors of ``[A]`` solved alone through the same
bucket; on the card its float atomics may change the last bits.

The outer sweep runs through :func:`repro_torch.core.cpapr.sweep_step`
with batched per-mode updates whose KKT value is a per-job ``(J,)``
tensor.  Only the ``segment`` strategy is offered, as in the JAX package:
bucket-tier tensors are too small for the blocked schedule, so this tier
runs plain PyTorch on the card by design and bypasses no kernel.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..core.cpapr import CPAPRConfig, CPAPRResult, sweep_step
from ..core.phi import phi_from_rows
from ..core.pi import pi_rows
from ..core.sparse_tensor import KTensor, SparseTensor, random_ktensor
from ..device import resolve_device

__all__ = [
    "Bucket",
    "BucketRegistry",
    "batched_cpapr_mu",
    "pad_tensor",
    "padded_init",
    "padded_init_from",
]


def _round_up(x: int, m: int) -> int:
    return ((int(x) + m - 1) // m) * m


def _next_pow2(x: int, floor: int) -> int:
    p = floor
    while p < x:
        p *= 2
    return p


@dataclasses.dataclass(frozen=True)
class Bucket:
    """One padded problem class: every job padded to these extents."""

    shape: tuple  # padded (I_1, ..., I_N)
    nnz: int  # padded nonzero count
    rank: int

    @property
    def ndim(self) -> int:
        return len(self.shape)


class BucketRegistry:
    """Rounds job shapes up to shared padded buckets.

    Mode extents round up to a multiple of ``row_multiple`` and the
    nonzero count to the next power of two (floored at ``nnz_floor``):
    coarse enough that similar jobs share a bucket, fine enough that the
    padding stays bounded (< 2x nnz, < ``row_multiple`` rows per mode).
    """

    def __init__(self, row_multiple: int = 8, nnz_floor: int = 64):
        self.row_multiple = int(row_multiple)
        self.nnz_floor = int(nnz_floor)
        self.seen: dict = {}  # Bucket -> jobs routed through it

    def bucket_of(self, shape, nnz: int, rank: int) -> Bucket:
        b = Bucket(
            shape=tuple(_round_up(s, self.row_multiple) for s in shape),
            nnz=_next_pow2(int(nnz), self.nnz_floor),
            rank=int(rank),
        )
        self.seen[b] = self.seen.get(b, 0) + 1
        return b

    def group(self, specs) -> dict:
        """Group job indices by bucket; ``specs`` is (shape, nnz, rank)."""
        groups: dict = {}
        for j, (shape, nnz, rank) in enumerate(specs):
            groups.setdefault(self.bucket_of(shape, nnz, rank), []).append(j)
        return groups


def pad_tensor(t: SparseTensor, bucket: Bucket) -> SparseTensor:
    """Pad ``t`` into its bucket: zero-valued tail nonzeros at coordinate 0.

    The padded tensor decomposes to the same factors as ``t`` (over the
    true rows) when the initial factors are zero past the true extents
    (see :func:`padded_init`).  It lies on ``t``'s device.
    """
    if t.ndim != bucket.ndim or any(
        s > bs for s, bs in zip(t.shape, bucket.shape)
    ):
        raise ValueError(
            f"tensor shape {t.shape} does not fit bucket {bucket.shape}"
        )
    if t.nnz > bucket.nnz:
        raise ValueError(
            f"tensor nnz {t.nnz} exceeds bucket nnz {bucket.nnz}"
        )
    pad = bucket.nnz - t.nnz
    idx = torch.cat([t.indices.to(torch.int64),
                     t.indices.new_zeros((pad, t.ndim), dtype=torch.int64)])
    vals = torch.cat([t.values.to(torch.float32),
                      t.values.new_zeros((pad,), dtype=torch.float32)])
    return SparseTensor(shape=bucket.shape, indices=idx, values=vals)


def padded_init_from(init: KTensor, bucket: Bucket) -> KTensor:
    """Zero-pad an explicit init KTensor up to the bucket extents."""
    factors = []
    for f, i_pad in zip(init.factors, bucket.shape):
        if f.shape[0] > i_pad:
            raise ValueError(
                f"init factor with {f.shape[0]} rows does not fit bucket "
                f"extent {i_pad}"
            )
        factors.append(torch.cat([f, f.new_zeros((i_pad - f.shape[0],
                                                  f.shape[1]))]))
    return KTensor(lam=init.lam, factors=tuple(factors))


def padded_init(seed: int, true_shape, bucket: Bucket,
                device="cuda") -> KTensor:
    """Random init drawn from ``seed`` on the *true* shape (the model
    ``cpapr_mu(seed=seed)`` starts from), zero-padded to the bucket."""
    return padded_init_from(
        random_ktensor(seed, tuple(true_shape), bucket.rank,
                       device=device), bucket)


def _mode_arrays(idx_pad: np.ndarray, vals_pad: np.ndarray, n: int):
    """Stable mode-n sort of padded COO arrays (mirrors ``sort_mode``)."""
    perm = np.argsort(idx_pad[:, n], kind="stable")
    return (
        idx_pad[perm, n].astype(np.int64),
        idx_pad[perm].astype(np.int64),
        vals_pad[perm].astype(np.float32),
    )


def _make_mode_update(n: int, bucket: Bucket, cfg: CPAPRConfig, grows,
                      gidx, device):
    """The bucket's batched mode-``n`` update: Alg. 1's mode update of
    ``cpapr._make_mode_update`` for the ``segment`` family, over all J
    jobs at once, with per-job masks.

    ``grows`` are the sorted mode-``n`` rows offset by ``j * I_pad`` and
    flattened (J * nnz_pad,); ``gidx`` the (J * nnz_pad, N) coordinates in
    mode ``n``'s sort order, each mode's offset the same way, so Π and Φ
    are :func:`pi_rows` and :func:`phi_from_rows` over the ``(J * I_pad,
    R)`` row space.  ``update(svals, factors, lam, keep)`` takes (J,
    nnz_pad) values, (J, I_m, R) factors, (J, R) lam and the (J,) bool of
    the jobs still solving, and returns ``(A_n', lam', viol, n_inner)``
    with per-job ``(J,)`` ``viol`` and ``n_inner``.
    A job's inner loop stops counting when its own ``viol <= tol`` or at
    ``max_inner``; the iterations the cohort runs past that leave its B,
    viol and count as they were.  Frozen jobs (``keep`` false) never
    start the loop: their results are discarded by the caller.
    """
    i_pad = bucket.shape[n]

    def phi(b, vals, pi):
        n_jobs, _, rank = b.shape
        return phi_from_rows(grows, vals, pi, b.reshape(-1, rank),
                             n_rows=n_jobs * i_pad, eps=cfg.eps,
                             strategy="segment", device=device
                             ).reshape(b.shape)

    def update(svals, factors, lam, keep):
        n_jobs, _, rank = factors[n].shape
        vals = svals.reshape(-1)
        pi = pi_rows(gidx, [f.reshape(-1, rank) for f in factors], n)
        a_n = factors[n]
        phi0 = phi(a_n * lam[:, None, :], vals, pi)
        s = torch.where((a_n < cfg.kappa_tol) & (phi0 > 1.0),
                        torch.full_like(a_n, cfg.kappa),
                        torch.zeros_like(a_n))
        b = (a_n + s) * lam[:, None, :]

        i = torch.zeros(n_jobs, dtype=torch.int64, device=b.device)
        viol = torch.full((n_jobs,), float("inf"), dtype=b.dtype,
                          device=b.device)
        running = keep & (cfg.max_inner > 0)
        while bool(running.any()):  # host sync: decides the next iteration
            ph = phi(b, vals, pi)
            v = torch.amax(torch.abs(torch.minimum(b, 1.0 - ph)), dim=(1, 2))
            b_new = torch.where((v > cfg.tol)[:, None, None], b * ph, b)
            b = torch.where(running[:, None, None], b_new, b)
            viol = torch.where(running, v, viol)
            i = i + running.to(torch.int64)
            running = running & (i < cfg.max_inner) & (viol > cfg.tol)

        lam_new = torch.sum(b, dim=1)
        a_new = b / torch.clamp_min(lam_new, cfg.eps)[:, None, :]
        return a_new, lam_new, viol, i

    return update


def batched_cpapr_mu(
    tensors,
    rank: int,
    seeds=None,
    inits=None,
    config: CPAPRConfig | None = None,
    bucket: Bucket | None = None,
    registry: BucketRegistry | None = None,
    device="cuda",
):
    """Solve many small tensors together, one batched pass per step.

    Args:
      tensors: list of :class:`SparseTensor`, all fitting one bucket.
      rank: decomposition rank (shared across the bucket).
      seeds: per-job seeds of the random init (ignored where ``inits``
        gives one); default ``range(len(tensors))``.
      inits: optional per-job :class:`KTensor` inits on the *true* job
        shapes (padded here).
      config: solver config; ``strategy`` is forced to ``segment``.
        Guards, checkpoints and the degradation ladder do not apply to
        the bucket tier.
      bucket: explicit bucket; default the registry's rounding of the
        largest job.
      registry: :class:`BucketRegistry` used when ``bucket`` is None.
      device: where the bucket is solved.

    Returns ``(results, bucket)``: :class:`CPAPRResult` per job, aligned
    with ``tensors``, factors sliced back to the true shapes.
    ``inner_iters`` are each job's own counts (a job stops counting when
    it converges, as a lane of the JAX package's vmapped loop does);
    ``seconds`` and ``sweep_seconds`` are the batch's over the job count.
    """
    dev = resolve_device(device)
    cfg = config or CPAPRConfig(rank=rank)
    cfg = dataclasses.replace(cfg, rank=rank, strategy="segment",
                              policy=None, track_loglik=False)
    n_jobs = len(tensors)
    if n_jobs == 0:
        raise ValueError("batched_cpapr_mu: no tensors given")
    ndim = tensors[0].ndim
    if any(t.ndim != ndim for t in tensors):
        raise ValueError("batched_cpapr_mu: all tensors must share ndim")
    if bucket is None:
        registry = registry or BucketRegistry()
        shape_max = tuple(
            max(t.shape[n] for t in tensors) for n in range(ndim)
        )
        bucket = registry.bucket_of(
            shape_max, max(t.nnz for t in tensors), rank
        )

    t0 = time.perf_counter()
    if seeds is None:
        seeds = list(range(n_jobs))

    # --- pad + per-mode stable sorts, stacked over the job axis ----------
    rows_b = [[] for _ in range(ndim)]
    sidx_b = [[] for _ in range(ndim)]
    svals_b = [[] for _ in range(ndim)]
    factors_j = []
    lam_j = []
    for j, t in enumerate(tensors):
        tp = pad_tensor(t, bucket)
        idx_np = tp.indices.cpu().numpy()
        vals_np = tp.values.cpu().numpy()
        for n in range(ndim):
            r, si, sv = _mode_arrays(idx_np, vals_np, n)
            rows_b[n].append(r)
            sidx_b[n].append(si)
            svals_b[n].append(sv)
        if inits is not None and inits[j] is not None:
            kt0 = padded_init_from(inits[j].to(dev), bucket)
        else:
            kt0 = padded_init(seeds[j], t.shape, bucket, device=dev)
        kt0 = kt0.normalize()  # what cpapr_mu does to its init
        factors_j.append(kt0.factors)
        lam_j.append(kt0.lam)
    # the jobs' rows, offset into one (J * I_pad) row space per mode
    job = np.arange(n_jobs, dtype=np.int64)[:, None]
    updates = []
    svals = []
    for n in range(ndim):
        sidx = np.stack(sidx_b[n])  # (J, nnz_pad, N)
        grows = torch.as_tensor(
            (np.stack(rows_b[n]) + job * bucket.shape[n]).reshape(-1),
            device=dev)
        offsets = job[:, :, None] * np.asarray(bucket.shape, np.int64)
        gidx = torch.as_tensor((sidx + offsets).reshape(-1, ndim),
                               device=dev)
        updates.append(_make_mode_update(n, bucket, cfg, grows, gidx, dev))
        svals.append(torch.as_tensor(np.stack(svals_b[n]), device=dev))
    factors = [
        torch.stack([fj[n] for fj in factors_j]) for n in range(ndim)
    ]  # per mode: (J, I_pad, R)
    lam = torch.stack(lam_j)  # (J, R)

    def sweep_batch(keep):
        """Per-mode callables for sweep_step, frozen at this sweep's mask."""

        def mode_fn(n):
            def fn(fac, lm):
                a, l, viol, ninner = updates[n](svals[n], fac, lm, keep)
                # freeze converged jobs: their state (and reported KKT)
                # must not depend on how long the cohort keeps sweeping
                a = torch.where(keep[:, None, None], a, fac[n])
                l = torch.where(keep[:, None], l, lm)
                viol = torch.where(keep, viol, torch.zeros_like(viol))
                return a, l, viol, ninner, None

            return fn

        return [mode_fn(n) for n in range(ndim)]

    # --- outer sweeps through the shared pure sweep body ------------------
    done = np.zeros(n_jobs, bool)
    kkt_hist = [[] for _ in range(n_jobs)]
    inner_hist = [[] for _ in range(n_jobs)]
    sweep_hist = [[] for _ in range(n_jobs)]
    n_outer = np.zeros(n_jobs, np.int64)
    k = 0
    while k < cfg.max_outer and not done.all():
        ts = time.perf_counter()
        out = sweep_step((factors, lam),
                         sweep_batch(torch.as_tensor(~done, device=dev)))
        factors, lam = out.factors, out.lam
        worst = out.worst.double().cpu().numpy()  # (J,)
        inner = out.inner_total.cpu().numpy()  # (J,) per-job counts
        dt = (time.perf_counter() - ts) / n_jobs
        for j in range(n_jobs):
            if not done[j]:
                kkt_hist[j].append(float(worst[j]))
                inner_hist[j].append(int(inner[j]))
                sweep_hist[j].append(dt)
                n_outer[j] = k + 1
        done |= worst <= cfg.tol
        k += 1
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0

    results = []
    for j, t in enumerate(tensors):
        facs = tuple(
            factors[n][j, : t.shape[n], :] for n in range(ndim)
        )
        results.append(CPAPRResult(
            ktensor=KTensor(lam=lam[j], factors=facs),
            n_outer=int(n_outer[j]),
            kkt_history=kkt_hist[j],
            loglik_history=[],
            inner_iters=inner_hist[j],
            converged=bool(done[j]),
            seconds=seconds / n_jobs,
            sweep_seconds=sweep_hist[j],
        ))
    return results, bucket
