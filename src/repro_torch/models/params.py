"""Parameter trees: :class:`ParamSpec` leaves in nested dicts.

Models declare their parameters as nested dicts of :class:`ParamSpec`
(shape, logical axes, dtype, init rule) under the JAX package's tree
names and shapes.  The same tree drives :func:`init_params` (real
tensors on a device), :func:`abstract_params` (meta-device tensors, no
memory) and :func:`count_params`.  The logical axes are kept for the
mesh rules of the training slice; on one device nothing reads them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..device import resolve_device

__all__ = [
    "ParamSpec",
    "abstract_params",
    "cast_specs",
    "count_params",
    "empty_caches",
    "init_params",
    "tree_leaves",
    "tree_map",
]

# f32 elements drawn at a time by init_params: a large leaf is filled a
# slice of rows at a time, so no whole tree (or leaf) exists in f32
_INIT_SLICE_ELEMS = 1 << 26


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    axes: tuple  # logical axis name per dim (None = replicated dim)
    dtype: Any = torch.bfloat16
    init: str = "normal"  # normal | zeros | ones
    scale: float = 1.0  # stddev multiplier for 'normal'


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts (``rest``: trees of the same
    structure, their leaves passed alongside)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of nested dicts, in key order."""
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in tree_leaves(tree[k])]
    return [tree]


def abstract_params(tree):
    """ParamSpec tree -> tree of meta-device tensors (shapes and dtypes,
    no storage)."""
    return tree_map(
        lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"), tree)


def _init_leaf(spec: ParamSpec, gen: torch.Generator,
               dev: torch.device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=dev)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=dev)
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
    std = spec.scale / (fan_in ** 0.5)
    out = torch.empty(spec.shape, dtype=spec.dtype, device=dev)
    rows = out.view(-1, spec.shape[-1]) if out.dim() else out.view(1, 1)
    step = max(1, _INIT_SLICE_ELEMS // rows.shape[1])
    for i in range(0, rows.shape[0], step):
        j = min(i + step, rows.shape[0])
        draw = torch.randn((j - i, rows.shape[1]), generator=gen,
                           dtype=torch.float32, device=dev)
        rows[i:j] = (draw * std).to(spec.dtype)
    return out


@torch.no_grad()
def init_params(tree, seed: int = 0, device="cuda"):
    """ParamSpec tree -> tensor tree on ``device``.

    The JAX package's rule, leaf by leaf: zeros, ones, or an f32 normal
    times ``scale / sqrt(fan_in)`` (fan_in: the second-to-last dim) cast
    to the spec's dtype.  The draws come from one ``torch.Generator`` on
    the device seeded with ``seed``; they do not reproduce JAX's PRNG.
    """
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return tree_map(lambda s: _init_leaf(s, gen, dev), tree)


def empty_caches(tree, device) -> dict:
    """Cache spec tree -> zero tensors on ``device``, every ``kv_pos``
    leaf at -1 (all ring slots empty)."""
    return {k: empty_caches(v, device) if isinstance(v, dict) else
            torch.full(v.shape, -1 if k == "kv_pos" else 0, dtype=v.dtype,
                       device=device)
            for k, v in tree.items()}


def cast_specs(tree, dtype):
    """Replace the default bf16 weight dtype (f32 norms and int specs are
    untouched): the reduced configs run in f32."""
    def f(s):
        if s.dtype == torch.bfloat16:
            return dataclasses.replace(s, dtype=dtype)
        return s

    return tree_map(f, tree)


def count_params(tree) -> int:
    """Total elements of a ParamSpec (or tensor) tree."""
    total = 0
    for s in tree_leaves(tree):
        n = 1
        for d in s.shape:
            n *= d
        total += n
    return total
