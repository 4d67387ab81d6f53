"""Carry a problem's state across from numpy arrays to the port.

A CP-APR or CP-ALS solve has no weights: its parameters are the tensor,
the starting model, the parallel policy and, for the dense tier, each
mode's densified tensor.  These converters take them as numpy arrays or
plain dicts (as the JAX package's objects give them up through
``numpy.asarray`` and ``dataclasses.asdict``) and build the port's objects
on a device, so both packages solve the same problem from the same start.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..device import resolve_device
from .dense import DenseModeData
from .policy import PhiPolicy
from .sparse_tensor import KTensor, SparseTensor

__all__ = ["dense_mode_from_numpy", "ktensor_from_numpy", "policy_from_dict",
           "sparse_tensor_from_numpy"]


def sparse_tensor_from_numpy(shape: Sequence[int], indices, values,
                             device="cuda") -> SparseTensor:
    """A :class:`SparseTensor` from (nnz, N) indices and (nnz,) values.

    Indices become int64; values keep their floating dtype.  The arrays
    are copied, never shared with the caller's buffers.
    """
    dev = resolve_device(device)
    return SparseTensor(
        shape=tuple(int(s) for s in shape),
        indices=torch.as_tensor(np.array(indices), dtype=torch.int64,
                                device=dev),
        values=torch.as_tensor(np.array(values), device=dev),
    )


def ktensor_from_numpy(lam, factors: Sequence, device="cuda") -> KTensor:
    """A :class:`KTensor` from ``lam`` (R,) and per-mode (I_n, R) factors,
    dtypes kept."""
    dev = resolve_device(device)
    return KTensor(
        lam=torch.as_tensor(np.array(lam), device=dev),
        factors=tuple(torch.as_tensor(np.array(f), device=dev)
                      for f in factors),
    )


def policy_from_dict(d: dict) -> PhiPolicy:
    """A :class:`PhiPolicy` from its field dict; strategy ``"pallas"``
    becomes ``"cuda"``, so stored policies carry over."""
    fields = dict(d)
    if fields.get("strategy") == "pallas":
        fields["strategy"] = "cuda"
    return PhiPolicy(**fields)


def dense_mode_from_numpy(x, mode: int, j_mode: int, k_modes: Sequence[int],
                          shape: Sequence[int], device="cuda") -> DenseModeData:
    """A :class:`DenseModeData` from a densified (K, I, J) tensor and its
    permutation metadata (the JAX package's ``DenseModeData`` fields).
    ``x`` keeps its dtype and is copied."""
    dev = resolve_device(device)
    return DenseModeData(
        x=torch.as_tensor(np.array(x), device=dev), mode=int(mode),
        j_mode=int(j_mode), k_modes=tuple(int(m) for m in k_modes),
        shape=tuple(int(s) for s in shape),
    )
