"""Synthetic FROSTT-shaped sparse count tensors (paper Table 2).

The six evaluation tensors, with true FROSTT dimensions and an ``nnz``
scale knob (scale=1.0 samples the paper's counts; duplicates then merge,
so the tensor holds somewhat fewer).  Values are Poisson counts from a
planted low-rank model — the generative assumption of CP-APR.  No
download: the data is made from the seed.

:func:`make_near_dense` makes the dense tier's kind of tensor instead: a
small, near-dense one, as ``benchmarks/bench_dense.py`` does.
"""
from __future__ import annotations

import zlib

import numpy as np

from ..device import resolve_device
from ..core.convert import sparse_tensor_from_numpy
from ..core.sparse_tensor import SparseTensor, random_poisson_tensor

__all__ = ["FROSTT", "NEAR_DENSE_FILL", "NEAR_DENSE_SHAPE", "TENSOR_NAMES",
           "make_near_dense", "make_tensor", "tensor_seed"]

#: the dense tier's tensor at its cap: exactly DENSE_MAX_ELEMS = 2^22 cells
NEAR_DENSE_SHAPE, NEAR_DENSE_FILL = (128, 256, 128), 0.40

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
    return random_poisson_tensor(tensor_seed(name, seed), dims, nnz=n,
                                 rank=rank, device=dev)


def make_near_dense(shape=NEAR_DENSE_SHAPE, fill: float = NEAR_DENSE_FILL,
                    seed: int = 0, device="cuda") -> SparseTensor:
    """A near-dense count tensor: each cell of ``shape`` is a nonzero with
    probability ``fill``, its value Poisson(2) + 1, from ``seed``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    idx = np.argwhere(rng.random(shape) < fill)
    vals = rng.poisson(2.0, idx.shape[0]).astype(np.float32) + 1.0
    return sparse_tensor_from_numpy(shape, idx, vals, device=dev)
