"""A log-depth associative scan in plain PyTorch.

``associative_scan(fn, elems, dim)`` follows ``jax.lax.associative_scan``'s
odd/even recursion step for step: combine adjacent pairs, scan those by
recursion (the odd results), combine each odd result with the next even
element, prepend element 0, interleave.  Its association order, and so its
rounding, is the reference's: for elementwise ``fn`` it is bitwise equal to
the eager JAX scan.  The depth is ``2 * log2(S)`` levels of whole-tensor
ops, and autograd differentiates through the slices, so the backward is
log-depth too.
"""
from __future__ import annotations

import torch

__all__ = ["associative_scan"]


def _every(x, start: int, stop, step: int, dim: int):
    """``x[start:stop:step]`` along ``dim`` (a view)."""
    idx = [slice(None)] * x.dim()
    idx[dim] = slice(start, stop, step)
    return x[tuple(idx)]


def _interleave(even, odd, dim: int):
    """even[0], odd[0], even[1], odd[1], ... along ``dim``; ``even`` has as
    many entries as ``odd`` or one more.  A fresh tensor from ``stack``, not
    an in-place write into one that autograd saved."""
    n = odd.shape[dim]
    pairs = torch.stack((_every(even, 0, n, 1, dim), odd), dim + 1)
    out = pairs.flatten(dim, dim + 1)
    if even.shape[dim] > n:
        out = torch.cat((out, _every(even, n, None, 1, dim)), dim)
    return out


def associative_scan(fn, elems: tuple, dim: int = 0) -> tuple:
    """Inclusive scan of the tuple of tensors ``elems`` along ``dim`` under
    the associative ``fn(left, right) -> combined`` (tuples in and out)."""
    elems = tuple(elems)
    dim = dim % elems[0].dim()

    def scan(xs):
        n = xs[0].shape[dim]
        if n < 2:
            return xs
        odd = scan(fn(tuple(_every(x, 0, n - 1, 2, dim) for x in xs),
                      tuple(_every(x, 1, None, 2, dim) for x in xs)))
        nxt = tuple(_every(x, 2, None, 2, dim) for x in xs)
        if n % 2 == 0:
            even = fn(tuple(_every(o, 0, -1, 1, dim) for o in odd), nxt)
        else:
            even = fn(odd, nxt)
        even = tuple(torch.cat((_every(x, 0, 1, 1, dim), e), dim)
                     for x, e in zip(xs, even))
        return tuple(_interleave(e, o, dim) for e, o in zip(even, odd))

    return scan(elems)
