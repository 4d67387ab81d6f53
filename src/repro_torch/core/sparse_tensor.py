"""Sparse count-tensor substrate for CP-APR.

A :class:`SparseTensor` is a COO tensor of non-negative counts, the input
format of the CP-APR MU algorithm (Chi & Kolda 2012).  The per-mode
sorted views (:class:`ModeView`, the paper's permutation arrays, Alg. 4
line 6) make same-row updates of Φ contiguous, which is what the blocked
schedule and the CUDA kernels are built on.

A :class:`KTensor` is a Kruskal tensor: weights ``lam`` (R,) plus one
factor matrix per mode.  Tensors carry their device; random data is made
on the host from a numpy seed and then moved, so the same seed gives the
same data on every device.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..device import resolve_device

__all__ = [
    "AppendInfo",
    "KTensor",
    "ModeView",
    "SparseTensor",
    "append_nonzeros",
    "dense_from_coo",
    "ktensor_full",
    "merge_mode_view",
    "model_values_at",
    "random_ktensor",
    "random_poisson_tensor",
    "sort_mode",
]


@dataclasses.dataclass(frozen=True)
class SparseTensor:
    """COO sparse tensor of counts.

    Attributes:
      shape:   python tuple (I_1, ..., I_N).
      indices: (nnz, N) int64 coordinates.
      values:  (nnz,) float counts.
    """

    shape: tuple
    indices: torch.Tensor
    values: torch.Tensor

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def nnz(self) -> int:
        return int(self.values.shape[0])

    @property
    def device(self) -> torch.device:
        return self.values.device

    def density(self) -> float:
        full = float(np.prod([float(s) for s in self.shape]))
        return self.nnz / full

    def mode_view(self, n: int) -> "ModeView":
        return sort_mode(self, n)

    def to(self, device) -> "SparseTensor":
        return SparseTensor(self.shape, self.indices.to(device),
                            self.values.to(device))


@dataclasses.dataclass(frozen=True)
class ModeView:
    """Nonzeros of a tensor sorted by their mode-``n`` coordinate.

    Attributes:
      mode:        mode index n.
      perm:        (nnz,) int64, stable sort order into the COO arrays.
      rows:        (nnz,) int64, sorted mode-n coordinates (ascending).
      sorted_idx:  (nnz, N) int64, all coordinates in sorted order.
      sorted_vals: (nnz,) values in sorted order.
      row_starts:  (I_n + 1,) int64 CSR-style pointers into the sorted run.
    """

    mode: int
    perm: torch.Tensor
    rows: torch.Tensor
    sorted_idx: torch.Tensor
    sorted_vals: torch.Tensor
    row_starts: torch.Tensor

    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])

    @property
    def n_rows(self) -> int:
        return int(self.row_starts.shape[0]) - 1


def sort_mode(t: SparseTensor, n: int) -> ModeView:
    """Build the sorted mode view (permutation array) for mode ``n``.

    A stable sort, so ties keep COO order exactly as the JAX package's
    ``jnp.argsort(stable=True)`` does.
    """
    rows_unsorted = t.indices[:, n]
    rows, perm = torch.sort(rows_unsorted, stable=True)
    counts = torch.bincount(rows, minlength=t.shape[n])
    row_starts = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    return ModeView(
        mode=n,
        perm=perm,
        rows=rows,
        sorted_idx=t.indices[perm],
        sorted_vals=t.values[perm],
        row_starts=row_starts,
    )


@dataclasses.dataclass(frozen=True)
class KTensor:
    """Kruskal tensor: ``sum_r lam[r] * outer(factors[0][:, r], ...)``."""

    lam: torch.Tensor  # (R,)
    factors: tuple  # tuple of (I_n, R) tensors

    @property
    def rank(self) -> int:
        return int(self.lam.shape[0])

    @property
    def shape(self) -> tuple:
        return tuple(int(f.shape[0]) for f in self.factors)

    def to(self, device) -> "KTensor":
        return KTensor(self.lam.to(device),
                       tuple(f.to(device) for f in self.factors))

    def normalize(self) -> "KTensor":
        """Column-1-normalize all factors, folding mass into ``lam``."""
        lam = self.lam
        factors = []
        for f in self.factors:
            colsum = torch.sum(f, dim=0)
            safe = torch.where(colsum > 0, colsum, torch.ones_like(colsum))
            factors.append(f / safe)
            lam = lam * torch.where(colsum > 0, colsum,
                                    torch.zeros_like(colsum))
        return KTensor(lam=lam, factors=tuple(factors))


# ---------------------------------------------------------------------------
# Constructors / oracles
# ---------------------------------------------------------------------------


def random_ktensor(
    seed: int, shape: Sequence[int], rank: int, dtype=torch.float32,
    device="cuda",
) -> KTensor:
    """Random non-negative Kruskal tensor with unit-sum columns.

    Drawn on the host from ``numpy.random.default_rng(seed)``.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    factors = []
    for i_n in shape:
        f = rng.uniform(0.1, 1.0, size=(int(i_n), rank))
        f = f / f.sum(axis=0)
        factors.append(torch.as_tensor(f, dtype=dtype, device=dev))
    lam = rng.uniform(0.5, 2.0, size=rank)
    return KTensor(lam=torch.as_tensor(lam, dtype=dtype, device=dev),
                   factors=tuple(factors))


def _linear_index(idx: np.ndarray, shape) -> np.ndarray:
    """Row-major linearization of (nnz, N) coordinates into int64 codes."""
    lin = np.zeros(idx.shape[0], dtype=np.int64)
    mult = 1
    for n in range(len(shape) - 1, -1, -1):
        lin += idx[:, n].astype(np.int64) * mult
        mult *= int(shape[n])
    return lin


def _unique_coo(idx: np.ndarray, vals: np.ndarray, shape) -> tuple:
    """Deduplicate COO coordinates (summing values)."""
    lin = _linear_index(idx, shape)
    uniq, inv = np.unique(lin, return_inverse=True)
    out_vals = np.zeros(uniq.shape[0], dtype=vals.dtype)
    np.add.at(out_vals, inv, vals)
    out_idx = np.zeros((uniq.shape[0], len(shape)), dtype=np.int64)
    rem = uniq.copy()
    for n in range(len(shape) - 1, -1, -1):
        out_idx[:, n] = rem % int(shape[n])
        rem //= int(shape[n])
    return out_idx, out_vals


def random_poisson_tensor(
    seed: int,
    shape: Sequence[int],
    nnz: int,
    rank: int = 4,
    seed_ktensor: KTensor | None = None,
    device="cuda",
) -> tuple:
    """Sample a sparse Poisson count tensor from a low-rank model.

    Draws ``nnz`` candidate multi-indices from the factor-defined
    categorical distribution (the generative model CP-APR assumes),
    assigns count values >= 1, and deduplicates.  The model is
    ``seed_ktensor`` when given (a streaming append drawn from a tenant's
    own model), else one drawn from ``seed``.  Returns
    ``(SparseTensor, model)`` on ``device``.  Runs on host numpy from
    ``seed`` (data generation, not a hot path).
    """
    dev = resolve_device(device)
    shape = tuple(int(s) for s in shape)
    kt = (seed_ktensor if seed_ktensor is not None
          else random_ktensor(seed, shape, rank, device="cpu"))
    rng = np.random.default_rng([int(seed), 1])
    lam = kt.lam.detach().cpu().double().numpy()
    comp = rng.choice(len(lam), size=nnz, p=lam / lam.sum())
    members = [np.flatnonzero(comp == r) for r in range(len(lam))]
    idx = np.zeros((nnz, len(shape)), dtype=np.int64)
    for n, f in enumerate(kt.factors):
        fn = f.detach().cpu().double().numpy()
        fn = fn / np.clip(fn.sum(axis=0, keepdims=True), 1e-12, None)
        cdf = np.cumsum(fn, axis=0)  # (I_n, R)
        u = rng.random(nnz)
        # per-component inverse-CDF sampling (O(nnz log I_n) memory-safe)
        col = np.zeros(nnz, dtype=np.int64)
        for r, sel in enumerate(members):
            if sel.size:
                col[sel] = np.searchsorted(cdf[:, r], u[sel])
        idx[:, n] = col.clip(0, shape[n] - 1)
    vals = rng.poisson(1.0, size=nnz).astype(np.float32) + 1.0
    idx, vals = _unique_coo(idx, vals, shape)
    st = SparseTensor(
        shape=shape,
        indices=torch.as_tensor(idx, dtype=torch.int64, device=dev),
        values=torch.as_tensor(vals, dtype=torch.float32, device=dev),
    )
    return st, kt.to(dev)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclasses.dataclass(frozen=True)
class AppendInfo:
    """Bookkeeping for one :func:`append_nonzeros` merge.

    ``n_fresh`` entries landed on previously-empty coordinates (they sit
    at the tail of the merged COO arrays, in the coordinate order of the
    deduplicated batch); ``n_merged`` collided with existing coordinates
    and had their counts summed in place.  ``frac_new`` is the fresh
    share of the merged nonzero count: the freshness signal the service's
    warm-start sweep budget consumes.
    """

    n_appended: int
    n_fresh: int
    n_merged: int
    nnz_before: int
    nnz_after: int

    @property
    def frac_new(self) -> float:
        return self.n_fresh / max(self.nnz_after, 1)


def append_nonzeros(t: SparseTensor, new_indices,
                    new_values) -> "tuple[SparseTensor, AppendInfo]":
    """Merge a batch of new nonzeros into ``t`` (streaming append).

    The batch is deduplicated against itself through :func:`_unique_coo`
    (duplicate coordinates sum), then matched against the existing
    coordinates by linearized index: collisions add their counts to the
    existing entries in place, new coordinates append at the tail.
    Positions ``[0, t.nnz)`` of the merged arrays are ``t``'s nonzeros in
    their original order: the invariant that lets :func:`merge_mode_view`
    extend the sorted views without re-sorting.  Runs on host numpy
    (ingest, not a hot path); the merged tensor lies on ``t``'s device.
    """
    new_idx = _host(new_indices)
    new_vals = _host(new_values).astype(np.float32)
    if new_idx.ndim != 2 or new_idx.shape[1] != t.ndim:
        raise ValueError(
            f"append_nonzeros: new_indices must be (k, {t.ndim}) for a "
            f"{t.ndim}-mode tensor; got shape {new_idx.shape}"
        )
    if new_vals.shape != (new_idx.shape[0],):
        raise ValueError(
            f"append_nonzeros: new_values must be ({new_idx.shape[0]},) to "
            f"match new_indices; got shape {new_vals.shape}"
        )
    if not np.all(np.isfinite(new_vals)) or np.any(new_vals < 0):
        raise ValueError(
            "append_nonzeros: values must be finite non-negative counts"
        )
    for n, i_n in enumerate(t.shape):
        if new_idx.shape[0] and (
            new_idx[:, n].min() < 0 or new_idx[:, n].max() >= i_n
        ):
            raise ValueError(
                f"append_nonzeros: mode-{n} coordinates out of range for "
                f"shape {t.shape}"
            )
    n_appended = int(new_idx.shape[0])
    new_idx, new_vals = _unique_coo(new_idx.astype(np.int64), new_vals,
                                    t.shape)

    old_idx = _host(t.indices).astype(np.int64)
    old_vals = _host(t.values).astype(np.float32)  # a copy: updated in place
    lin_old = _linear_index(old_idx, t.shape)
    order_old = np.argsort(lin_old, kind="stable")
    lin_sorted = lin_old[order_old]
    lin_new = _linear_index(new_idx, t.shape)
    pos = np.searchsorted(lin_sorted, lin_new)
    pos_c = np.minimum(pos, max(len(lin_sorted) - 1, 0))
    matched = (
        (lin_new <= lin_sorted[-1]) & (lin_sorted[pos_c] == lin_new)
        if len(lin_sorted)
        else np.zeros(lin_new.shape, dtype=bool)
    )
    np.add.at(old_vals, order_old[pos_c[matched]], new_vals[matched])

    fresh_idx = new_idx[~matched]
    fresh_vals = new_vals[~matched]
    dev = t.device
    merged = SparseTensor(
        shape=t.shape,
        indices=torch.as_tensor(np.concatenate([old_idx, fresh_idx]),
                                dtype=torch.int64, device=dev),
        values=torch.as_tensor(np.concatenate([old_vals, fresh_vals]),
                               dtype=torch.float32, device=dev),
    )
    info = AppendInfo(
        n_appended=n_appended,
        n_fresh=int(fresh_idx.shape[0]),
        n_merged=int(matched.sum()),
        nnz_before=t.nnz,
        nnz_after=merged.nnz,
    )
    return merged, info


def merge_mode_view(mv: ModeView, merged: SparseTensor,
                    nnz_before: int) -> ModeView:
    """Extend a mode view over an appended tensor by merging sorted runs.

    ``merged`` must come from :func:`append_nonzeros` on the tensor ``mv``
    was built from (``nnz_before`` = that tensor's nnz): positions
    ``[0, nnz_before)`` are the old nonzeros in their original order
    (values possibly bumped by collisions) and the tail is the fresh
    batch.  The old sorted run is reused as is; only the stable sort of
    the tail, an O(nnz) merge (``searchsorted`` + ``insert``) and a value
    re-gather are paid, on the host.  The result equals
    ``sort_mode(merged, mv.mode)`` on every field, stable tie order
    included, and lies on ``mv``'s device.
    """
    n = mv.mode
    i_n = mv.n_rows
    idx_np = _host(merged.indices)
    if idx_np.shape[0] < nnz_before:
        raise ValueError(
            f"merge_mode_view: merged tensor has {idx_np.shape[0]} nonzeros "
            f"< nnz_before={nnz_before}"
        )
    tail_idx = idx_np[nnz_before:]
    tail_rows = tail_idx[:, n]
    order_tail = np.argsort(tail_rows, kind="stable")
    rows_tail = tail_rows[order_tail]
    perm_tail = nnz_before + order_tail

    rows_old = _host(mv.rows)
    # stable merge: new entries land after old entries of an equal row
    # (they sit at higher COO positions), as sort_mode's stable sort puts them
    ins = np.searchsorted(rows_old, rows_tail, side="right")
    perm = np.insert(_host(mv.perm), ins, perm_tail)
    rows = np.insert(rows_old, ins, rows_tail)
    sorted_idx = np.insert(_host(mv.sorted_idx), ins, tail_idx[order_tail],
                           axis=0)
    # collisions changed old values in place: re-gather, don't re-sort
    sorted_vals = merged.values[torch.as_tensor(perm,
                                                device=merged.device)]
    counts_tail = np.bincount(rows_tail, minlength=i_n)
    row_starts = _host(mv.row_starts) + np.concatenate(
        [[0], np.cumsum(counts_tail)])
    dev = mv.rows.device

    def _on(x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.int64, device=dev)

    return ModeView(
        mode=n,
        perm=_on(perm),
        rows=_on(rows),
        sorted_idx=_on(sorted_idx),
        sorted_vals=sorted_vals.to(dev),
        row_starts=_on(row_starts),
    )


def dense_from_coo(t: SparseTensor) -> torch.Tensor:
    """Materialize a small COO tensor densely (test oracle only)."""
    dense = torch.zeros(t.shape, dtype=t.values.dtype, device=t.device)
    dense.index_put_(tuple(t.indices[:, n] for n in range(t.ndim)),
                     t.values, accumulate=True)
    return dense


def ktensor_full(kt: KTensor) -> torch.Tensor:
    """Materialize a small Kruskal tensor densely (test oracle only)."""
    out = torch.zeros(kt.shape, dtype=kt.lam.dtype, device=kt.lam.device)
    for rr in range(kt.rank):
        acc = kt.factors[0][:, rr]
        for f in kt.factors[1:]:
            acc = torch.tensordot(acc, f[:, rr], dims=0)
        out = out + kt.lam[rr] * acc
    return out


def model_values_at(kt: KTensor, indices: torch.Tensor) -> torch.Tensor:
    """Model value m_z = sum_r lam_r prod_n A^(n)[i_n, r] at each nonzero."""
    prod = torch.ones((indices.shape[0], kt.rank), dtype=kt.lam.dtype,
                      device=kt.lam.device)
    for n, f in enumerate(kt.factors):
        prod = prod * f[indices[:, n]]
    return prod @ kt.lam
