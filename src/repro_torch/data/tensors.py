"""Synthetic FROSTT-shaped sparse count tensors (paper Table 2).

The six evaluation tensors, with true FROSTT dimensions and an ``nnz``
scale knob (scale=1.0 samples the paper's counts; duplicates then merge,
so the tensor holds somewhat fewer).  Values are Poisson counts from a
planted low-rank model — the generative assumption of CP-APR.  No
download: the data is made from the seed.
"""
from __future__ import annotations

import zlib

from ..device import resolve_device
from ..core.sparse_tensor import random_poisson_tensor

__all__ = ["FROSTT", "TENSOR_NAMES", "make_tensor", "tensor_seed"]

# name -> (dims, paper nnz)
FROSTT = {
    "chicago": ((6_186, 24, 77, 32), 5_330_673),
    "enron": ((6_066, 5_699, 244_268, 1_176), 54_202_099),
    "lbnl": ((1_605, 4_198, 1_631, 4_209, 868_131), 1_698_825),
    "nell2": ((12_092, 9_184, 28_818), 76_879_419),
    "nips": ((2_482, 2_862, 14_036, 17), 3_101_609),
    "uber": ((183, 24, 1_140, 1_717), 3_309_490),
}

TENSOR_NAMES = tuple(FROSTT)


def tensor_seed(name: str, seed: int) -> int:
    """The numpy seed of tensor ``name``: stable across processes (a crc32,
    not Python's salted ``hash``)."""
    return zlib.crc32(name.encode()) ^ int(seed)


def make_tensor(name: str, scale: float = 0.01, rank: int = 8,
                seed: int = 0, device="cuda") -> tuple:
    """Synthesize one FROSTT-shaped tensor on ``device``.

    Returns (SparseTensor, ground-truth KTensor).  ``scale`` multiplies the
    paper's nnz (at least 1000 samples are drawn).
    """
    dev = resolve_device(device)
    dims, nnz = FROSTT[name]
    n = max(int(nnz * scale), 1_000)
    return random_poisson_tensor(dims, nnz=n, rank=rank,
                                 seed=tensor_seed(name, seed), device=dev)
