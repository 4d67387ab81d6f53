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
    "KTensor",
    "ModeView",
    "SparseTensor",
    "dense_from_coo",
    "ktensor_full",
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
    shape: Sequence[int], rank: int, seed: int = 0,
    dtype=torch.float32, device="cuda",
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
    shape: Sequence[int],
    nnz: int,
    rank: int = 4,
    seed: int = 0,
    device="cuda",
) -> tuple:
    """Sample a sparse Poisson count tensor from a low-rank model.

    Draws ``nnz`` candidate multi-indices from the factor-defined
    categorical distribution (the generative model CP-APR assumes),
    assigns count values >= 1, and deduplicates.  Returns
    ``(SparseTensor, ground_truth_KTensor)`` on ``device``.  Runs on host
    numpy from ``seed`` (data generation, not a hot path).
    """
    dev = resolve_device(device)
    shape = tuple(int(s) for s in shape)
    kt = random_ktensor(shape, rank, seed=seed, device="cpu")
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
