"""Carry parameter and cache trees across from numpy to the port.

The JAX package's trees give themselves up as nested dicts of numpy
arrays (``jax.tree.map(np.asarray, params)``).  :func:`params_from_numpy`
builds the port's tree from one, key for key, on a device, so both
packages run the same weights from the same caches.  A bf16 array (numpy
dtype name ``bfloat16``, an extension type) crosses through a 16-bit
integer view, bit for bit, without importing the package that defines
the type.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .params import tree_map

__all__ = ["params_from_numpy", "tensor_from_numpy"]


def tensor_from_numpy(a, device="cuda") -> torch.Tensor:
    """One array (or numpy scalar) as a tensor on ``device``, copied; bf16
    bit for bit."""
    dev = resolve_device(device)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.array(a.view(np.int16)))
        return bits.view(torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(a)).to(dev)


def params_from_numpy(tree, device="cuda"):
    """A nested dict of numpy arrays -> the same tree of tensors on
    ``device`` (parameters or caches)."""
    dev = resolve_device(device)
    return tree_map(lambda a: tensor_from_numpy(a, dev), tree)
