"""Dense mode data for the matrix-free MTTKRP/Φ tier.

``strategy="dense"`` skips the (nnz, R) Π materialization entirely:
instead of sorted nonzero streams and a layout expansion, a mode carries
its *mode-permuted densified tensor* ``x (K, I, J)`` (built once per mode,
like a blocked layout) and the kernels (:mod:`repro_torch.kernels.dense`)
contract factor tiles against it.  Conventions, as in the JAX package:

* ``I`` — the target mode's dimension (output rows).
* ``J`` — the *widest* non-target mode (the first of them on a tie): the
  inner width of the contractions.
* ``K`` — the remaining modes flattened row-major (in ascending mode
  order); ``K == 1`` for matrices.

The factor-side operands are derived per call (they change every MU
iteration, unlike ``x``): ``c = factors[j_mode]`` and ``a`` = the
row-major Khatri-Rao product of the ``k_modes`` factors, aligned with the
``K`` linearization.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..device import resolve_device
from .policy import DENSE_MAX_ELEMS

__all__ = [
    "DENSE_MAX_ELEMS",
    "DenseModeData",
    "build_dense_mode",
    "dense_kr_factors",
]


@dataclasses.dataclass(frozen=True, eq=False)
class DenseModeData:
    """One mode's densified tensor and its permutation metadata.

    ``x`` is stored f32 (the data's natural dtype); the bf16 tier casts
    it once per mode update, at the call site.
    """

    x: torch.Tensor  # (K, I, J) mode-permuted dense tensor
    mode: int
    j_mode: int
    k_modes: tuple  # ascending mode indices flattened into K
    shape: tuple  # full tensor shape

    @property
    def n_rows(self) -> int:
        return self.x.shape[1]

    def with_x(self, x) -> "DenseModeData":
        """Same metadata around another ``x`` (e.g. the bf16 tier's cast)."""
        return dataclasses.replace(self, x=x)


def build_dense_mode(idx, vals, shape, mode: int,
                     max_elems: int = DENSE_MAX_ELEMS,
                     device="cuda") -> DenseModeData:
    """Densify one mode's COO data into the (K, I, J) kernel layout.

    ``idx (nnz, N)`` full coordinates (any sort order), ``vals (nnz,)``,
    as numpy arrays or tensors.  Duplicate coordinates sum, matching
    ``dense_from_coo``.  The build runs on the host (``np.add.at``); ``x``
    is then moved to ``device``.  Raises when the dense cell count exceeds
    ``max_elems``.
    """
    dev = resolve_device(device)
    shape = tuple(int(s) for s in shape)
    total = math.prod(shape)
    if total > max_elems:
        raise ValueError(
            f"refusing to densify mode {mode} of shape {shape}: "
            f"{total} cells > max_elems={max_elems}"
        )
    if not (0 <= mode < len(shape)):
        raise ValueError(f"mode {mode} out of range for shape {shape}")
    others = [m for m in range(len(shape)) if m != mode]
    if not others:
        raise ValueError("dense tier needs at least a 2-way tensor")
    j_mode = max(others, key=lambda m: shape[m])
    k_modes = tuple(m for m in others if m != j_mode)
    if isinstance(idx, torch.Tensor):
        idx = idx.detach().cpu().numpy()
    if isinstance(vals, torch.Tensor):  # x is f32 whatever the values' dtype
        vals = vals.detach().cpu().float().numpy()
    idx = np.asarray(idx)
    vals = np.asarray(vals, np.float32)
    n_k = math.prod(shape[m] for m in k_modes) if k_modes else 1
    k_lin = np.zeros(idx.shape[0], np.int64)
    for m in k_modes:
        k_lin = k_lin * shape[m] + idx[:, m]
    x = np.zeros((n_k, shape[mode], shape[j_mode]), np.float32)
    np.add.at(x, (k_lin, idx[:, mode], idx[:, j_mode]), vals)
    return DenseModeData(x=torch.as_tensor(x, device=dev), mode=mode,
                         j_mode=j_mode, k_modes=k_modes, shape=shape)


def dense_kr_factors(dense: DenseModeData, factors) -> tuple:
    """(c, a) factor-side kernel operands for the current factors.

    ``c = factors[j_mode]`` and ``a (K, R)`` is the Khatri-Rao product of
    the ``k_modes`` factors with the *same* row-major linearization as
    :func:`build_dense_mode`'s ``K`` axis (earlier modes vary slowest).
    Dtypes follow the factors: the precision tier is declared there.
    """
    c = factors[dense.j_mode]
    a = torch.ones((1, c.shape[1]), dtype=c.dtype, device=c.device)
    for m in dense.k_modes:
        f = factors[m]
        a = (a[:, None, :] * f[None, :, :]).reshape(-1, f.shape[1])
    return c, a
